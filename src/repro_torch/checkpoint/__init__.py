"""Checkpoints of the port: local save, async save and restore (``ckpt``)."""
