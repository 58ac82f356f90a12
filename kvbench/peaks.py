"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet for the H100 SXM part: dense rates, no sparsity, at the full 700 W
power limit), keyed by ``torch.cuda.get_device_name()``."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    """A card's peak, or None for a card not in the table."""
    return PEAKS.get(kind, {}).get(what)
