"""Kernels of the port: hand-written CUDA for Hopper under
``csrc/``, each with its plain PyTorch version beside it, and the
device-dispatching wrappers in :mod:`repro_torch.kernels.ops`."""
