"""The plain reference: fp32 PyTorch (TF32 off) of the configurations'
published layer equations, with the departures each configuration file
lists.  It imports nothing of the program and takes only what the
benchmark made: the weights (by their names in the stacked layout) and
the token ids."""
