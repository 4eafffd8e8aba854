"""repro_torch — the PyTorch/CUDA port of ``repro``, the HPX-style AMT
runtime and serving stack.

The layout mirrors the JAX package module for module
(``repro/x/y.py`` ↔ ``repro_torch/x/y.py``).  It imports ``torch`` and
never JAX nor ``repro``; the parity tests are the only place both meet.

Entry points (``Model``, ``Engine``, ``Router.replicate`` and
``python -m repro_torch.launch.serve``) run on ``cuda`` unless the caller
passes ``device="cpu"``.  The attention kernels are CUDA C++ for Hopper
(``kernels/csrc``); on CPU tensors the wrappers run their plain PyTorch
versions.
"""

__version__ = "0.1.0"
