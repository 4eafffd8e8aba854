"""Drivers, one module a kind of cell: each ``run(ctx) -> Outcome``."""
