"""The optimizer of the port: AdamW (``adamw``)."""
