"""Traffic generators, one module a ``kind`` of mix file: each reads its
parameters from the mix and the cell, and draws from ``--seed``."""
