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


def cuda_devices(device) -> list:
    """The distinct CUDA devices among `device`: one device, or a list or
    tuple of them (a mesh's)."""
    devs = device if isinstance(device, (list, tuple)) else [device]
    out = []
    for d in devs:
        d = torch.device(d)
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


def sync(device) -> None:
    """Wait for the queued work of `device`, or of every device of a list
    (no-op for the CPU).  Each card is synchronized by name:
    `torch.cuda.synchronize()` alone waits for the current card only."""
    for d in cuda_devices(device):
        torch.cuda.synchronize(d)


def peak_bytes(device) -> int:
    """The largest `torch.cuda.max_memory_allocated` among the CUDA
    devices of `device` (one device or a list); 0 without one."""
    return max((torch.cuda.max_memory_allocated(d)
                for d in cuda_devices(device)), default=0)
