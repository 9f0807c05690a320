"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
dense rates, at the full 700 W power limit)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12},
}


def peak(kind: str, what: str):
    """The card's peak ``what`` (``bf16_flop_s`` or ``hbm_byte_s``), or None
    for a card the table does not hold."""
    return PEAKS.get(kind, {}).get(what)
