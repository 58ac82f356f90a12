"""PyTorch/CUDA port of the KVComm serving path.

Imports torch and numpy only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no explicit CPU request
they raise (``resolve_device``) instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain PyTorch path on the CPU")
    return dev


def as_tokens(arr, device) -> torch.Tensor:
    """Host token ids -> a long tensor on ``device``. A copy to the card
    goes through pinned memory without blocking, so enqueueing a request's
    tokens never waits for the work already queued on the stream."""
    t = torch.as_tensor(arr, dtype=torch.long)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
