"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` argument.  The default is
the CUDA card; the CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do).  With the default device and no
card present the call raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); anything
    else -> ``torch.device(device)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "zklisp_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the host")
    return dev


def sync(device) -> None:
    """Wait for the card's queued work (no-op for the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
