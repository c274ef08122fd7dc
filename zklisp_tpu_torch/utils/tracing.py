"""Lightweight phase timers.

`phase(name, device=...)` times a block on the host clock; when the
device is a CUDA card, or a list of devices (a mesh's) with cards among
them, it synchronizes each of those cards at the phase's end, so the time
covers the device work the phase queued, and records the largest peak
allocated bytes among them so far.  Totals accumulate per name
(`summary()`, `reset()`), and every phase is also logged in order with
its fields (`events()`), which is how a caller prints a per-phase split
of a proving run, per wave or per segment.  Phases may end in several
threads (the wave prover's host assembly runs in a worker).  Each phase
is also a `torch.profiler.record_function` range named "phase:<name>",
so a profiler trace can be cut by phase.

Logging: ZKL_LOG=debug|info or configure(); phases log their wall-clock
on exit at debug level.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager

import torch

from ..device import cuda_devices, peak_bytes, sync

logger = logging.getLogger("zklisp_tpu_torch")

_LOCK = threading.Lock()
_TOTALS: dict = {}
_EVENTS: list = []


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
    """Forget the accumulated per-phase totals and the phase log."""
    with _LOCK:
        _TOTALS.clear()
        _EVENTS.clear()


def summary() -> dict:
    """{phase name: accumulated seconds} since the last reset()."""
    with _LOCK:
        return dict(_TOTALS)


def events() -> list:
    """[(phase name, seconds, fields)] in the order the phases ended,
    since the last reset(); a CUDA phase's fields hold `peak_bytes`."""
    with _LOCK:
        return list(_EVENTS)


@contextmanager
def phase(name: str, device=None, **fields):
    """Timed phase context; synchronizes the CUDA cards of `device` (one
    device or a list) at its end."""
    t0 = time.time()
    with torch.profiler.record_function("phase:" + name):
        try:
            yield
        finally:
            if device is not None and cuda_devices(device):
                sync(device)
                fields = dict(fields, peak_bytes=peak_bytes(device))
            dt = time.time() - t0
            with _LOCK:
                _TOTALS[name] = _TOTALS.get(name, 0.0) + dt
                _EVENTS.append((name, dt, fields))
            if logger.isEnabledFor(logging.DEBUG):
                extra = " ".join(f"{k}={v}" for k, v in fields.items())
                logger.debug("%s done elapsed_ms=%d %s", name,
                             int(dt * 1000), extra)
