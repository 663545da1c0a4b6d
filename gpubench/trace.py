"""Spans on the host clock, and a device trace read from torch.profiler.

The harness wraps each call it makes into the program in a span of its own
(:class:`Spans`): unprofiled, a span is two reads of the host clock; inside
a profiled stretch it is also a ``record_function`` range, so that every
idle gap of the device can be labelled by the span the host was in.
Nothing is written to disk: the trace is read from the profiler in memory.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "gpubench."
WINDOW = SPAN_PREFIX + "window"


class Spans:
    """Host-clock durations by name; ``profiling`` adds profiler ranges.
    :meth:`mark` notes a stage of the set-up on standard error, with the
    seconds since ``t_start``."""

    def __init__(self, t_start: float = 0.0):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.profiling = False
        self.t_start = t_start

    def mark(self, stage: str) -> None:
        print(f"setup: {stage} done at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = (torch.profiler.record_function(SPAN_PREFIX + name) if self.profiling
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rng:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def means_ms(self) -> Dict[str, float]:
        """Each span's mean milliseconds so far."""
        return {k: 1e3 * sum(v) / len(v) for k, v in self.seconds.items() if v}


@dataclass
class Trace:
    """One profiled stretch: device operations ``(name, start_us, end_us)``,
    the harness's host spans, the stretch's bounds, and how many steps or
    requests it held."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    units: int
    busy: List[Tuple[float, float]] = field(init=False)

    def __post_init__(self):
        merged: List[Tuple[float, float]] = []
        for a, b in sorted((max(a, self.start_us), min(b, self.end_us)) for _, a, b in self.ops):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self.busy = merged

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def idle_share(self, units: int, seconds: float) -> float:
        """The device's idle share of a stretch of ``units`` steps or
        requests in ``seconds``, at this trace's busy time a unit. Read
        against an unprofiled stretch, it leaves out the profiler's own host
        cost, which slows the profiled one while the device's busy time does
        not move."""
        return 1.0 - self.busy_s / self.units * units / seconds

    def op_seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for name, a, b in self.ops if rx.search(name)) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.start_us] + [x for ab in self.busy for x in ab] + [self.end_us]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_span_at(self, t_us: float) -> str:
        """The innermost harness span (other than the window) open at ``t_us``."""
        best = None
        for name, a, b in self.spans:
            if name != WINDOW and a <= t_us < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0][len(SPAN_PREFIX):] if best else "outside any span"

    def breakdown(self, rows: int = 10) -> dict:
        by_op: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            by_op[name[:200]] += (b - a) / 1e6
        by_span: Dict[str, List[float]] = defaultdict(list)
        for a, b in self.gaps():
            by_span[self.host_span_at((a + b) / 2)].append((b - a) / 1e6)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:rows]
        gaps = sorted(((f"idle while the host was in {span} ({len(v)} gaps)", sum(v))
                       for span, v in by_span.items()), key=lambda kv: -kv[1])[:rows]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def profile(run, units: int, spans: Spans, attempts: int = 3) -> Trace:
    """Profile ``run()`` (``units`` steps or requests, ending in a
    synchronise) with torch.profiler, CPU and CUDA. A stretch in which the
    profiler recorded no device operation is profiled again."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for attempt in range(attempts):
        spans.profiling = True
        try:
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(WINDOW):
                    run()
                    torch.cuda.synchronize()
        finally:
            spans.profiling = False
        ops, host = [], []
        window = None
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CPU:
                if e.name == WINDOW:
                    window = rng
                elif e.name.startswith(SPAN_PREFIX):
                    host.append((e.name,) + rng)
            elif not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPAN_PREFIX):
                ops.append((e.name,) + rng)
        if ops and window is not None:
            return Trace(ops=ops, spans=host, start_us=window[0], end_us=window[1], units=units)
        time.sleep(0.2 * (attempt + 1))
    raise RuntimeError("torch.profiler recorded no device operation in the profiled stretch")
