"""Lightweight phase timers.

`phase(name, device=...)` times a block on the host clock; when the
device is a CUDA card it calls `torch.cuda.synchronize()` at the phase's
end, so the time covers the device work the phase queued.  Totals
accumulate per name (`summary()`, `reset()`), which is how a caller
prints a per-phase split of a proving run.

Logging: ZKL_LOG=debug|info or configure(); phases log their wall-clock
on exit at debug level.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import torch

logger = logging.getLogger("zklisp_tpu_torch")

_TOTALS: dict = {}


def configure(level: str | None = None) -> None:
    level = level or os.environ.get("ZKL_LOG", "")
    if not level:
        return
    lvl = {"debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}.get(
               level.lower(), logging.INFO)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(lvl)


configure()


def reset() -> None:
    """Forget the accumulated per-phase totals."""
    _TOTALS.clear()


def summary() -> dict:
    """{phase name: accumulated seconds} since the last reset()."""
    return dict(_TOTALS)


@contextmanager
def phase(name: str, device=None, **fields):
    """Timed phase context; synchronizes a CUDA `device` at its end."""
    t0 = time.time()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        _TOTALS[name] = _TOTALS.get(name, 0.0) + dt
        if logger.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("%s done elapsed_ms=%d %s", name, int(dt * 1000),
                         extra)
