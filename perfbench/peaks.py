"""The table of peaks: published dense rates of each card, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part, at
its full power limit of 700 W)."""

from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of ``device_name``; a card that is not in the table
    raises, so that no share is read against another card's peak."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no peaks for {device_name!r}; known: {sorted(PEAKS)}") from None
