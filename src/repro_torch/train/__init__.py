"""Training of the port: the step builders (``step``) and the futurized
training loop (``trainer``)."""
