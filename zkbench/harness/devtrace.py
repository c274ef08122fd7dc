"""The device's side of a traced window, read from torch.profiler.

`DeviceTrace.from_profile(prof)` keeps, from the profiler's raw events:

- the window: the host range "zkbench:window" that the harness opens
  around its closed loop;
- every operation on the card inside it (kernels, copies, sets), with
  its name, start and end;
- the host ranges "phase:<name>" (utils/tracing.py) and "job:<name>"
  (the harness's own), to say what the host was doing in a gap;
- the host's kernel launch calls (cudaLaunchKernel*, cuLaunchKernel*).

`busy_s` is the length of the union of the device intervals, so work
that overlaps on several streams counts once; the idle share is one less
busy over the window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
WINDOW = "zkbench:window"
HOST_PREFIXES = ("phase:", "job:")


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals, overlaps once."""
    total, end = 0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if end is not None:
        total += end - start
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def name_gaps(gap_list, ranges) -> dict:
    """{host range name: idle time}: every part of a gap goes to the
    innermost host range open at that time (the open one that started
    last), or to "host:(outside any phase)"."""
    if not gap_list:
        return {}
    lo, hi = gap_list[0][0], gap_list[-1][1]
    cuts = sorted({lo, hi} | {t for _, s, e in ranges for t in (s, e)
                              if lo < t < hi})
    by_start = sorted(ranges, key=lambda r: r[1])
    pieces, active, nxt = [], [], 0          # (start, end, label)
    for a, b in zip(cuts, cuts[1:]):
        while nxt < len(by_start) and by_start[nxt][1] <= a:
            active.append(by_start[nxt])
            nxt += 1
        active = [r for r in active if r[2] > a]
        label = max(active, key=lambda r: r[1])[0] if active else None
        pieces.append((a, b, label))
    out: dict = {}
    j = 0
    for gs, ge in gap_list:
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            a, b, label = pieces[k]
            part = min(b, ge) - max(a, gs)
            if part > 0:
                key = label or "host:(outside any phase)"
                out[key] = out.get(key, 0) + part
            k += 1
    return out


@dataclass
class DeviceTrace:
    window: tuple                         # (start, end), nanoseconds
    ops: list = field(default_factory=list)       # (name, start, end)
    ranges: list = field(default_factory=list)    # (name, start, end)
    launches: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e in self.ops) * 1e-9

    def kernel_seconds(self, pattern: str) -> tuple:
        """(seconds, count) of the device operations whose name holds
        `pattern`."""
        hits = [e - s for n, s, e in self.ops if pattern in n]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        return [[k[:160], v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        g = gaps([(s, e) for _, s, e in self.ops], *self.window)
        named = name_gaps(g, self.ranges)
        return [[k[:160], v * 1e-9] for k, v in
                sorted(named.items(), key=lambda kv: -kv[1])[:n]]

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        """events: (name, kind, start_ns, end_ns) in one clock; kind is
        "device" (a kernel, copy or set on the card), "range" (a host
        range), "launch" (a host launch call) or anything else."""
        events = list(events)
        wins = [(s, e) for n, k, s, e in events
                if k == "range" and n == WINDOW]
        if len(wins) != 1:
            raise ValueError(f"{len(wins)} '{WINDOW}' ranges in the trace")
        lo, hi = wins[0]
        inside = [ev for ev in events if lo <= ev[2] < hi]
        return cls(
            window=(lo, hi),
            ops=[(n, s, min(e, hi)) for n, k, s, e in inside
                 if k == "device"],
            ranges=[(n, s, e) for n, k, s, e in inside
                    if k == "range" and n.startswith(HOST_PREFIXES)],
            launches=sum(1 for n, k, _, _ in inside
                         if k == "launch" and n in LAUNCH_CALLS))

    @classmethod
    def from_profile(cls, prof) -> "DeviceTrace":
        """From a stopped torch.profiler.profile's raw events.  A device
        event is one on the card that is not the shadow of a host range
        (kineto mirrors record_function ranges onto the card's
        timeline); a range is a host user annotation; a launch is a host
        event named as a launch call."""
        own = HOST_PREFIXES + (WINDOW,)

        def kind(ev, name):
            on_card = ev.device_type().name in ("CUDA", "PrivateUse1")
            note = (ev.is_user_annotation()
                    if hasattr(ev, "is_user_annotation") else False)
            if on_card:
                return "other" if note or name.startswith(own) else "device"
            if name.startswith(own):
                return "range"
            return "launch" if name in LAUNCH_CALLS else "other"

        def rows():
            for ev in prof.profiler.kineto_results.events():
                name = ev.name()
                yield name, kind(ev, name), ev.start_ns(), ev.end_ns()
        return cls.from_events(rows())
