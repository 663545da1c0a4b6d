"""Profiling hooks: torch.profiler traces and blocking phase timers.

The counterpart of the JAX package's ``utils/profiling.py``:
:func:`device_trace` records a Chrome trace (Perfetto opens it) with
``torch.profiler``, and :class:`PhaseTimer` waits for the device at the end
of a phase, so the device work of the phase is counted in it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(logdir: str, device=None) -> Iterator[profile]:
    """Trace the block with torch.profiler and write ``logdir/trace.json``.

    The CPU is always traced; the CUDA device too when ``device`` is a CUDA
    device, or when it is None and a card is present.
    """
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(target) -> None:
    """Wait for the devices of the CUDA tensors in ``target`` (a tensor, or
    a list, tuple or dict of them, nested)."""
    if isinstance(target, torch.Tensor):
        if target.is_cuda:
            torch.cuda.synchronize(target.device)
    elif isinstance(target, dict):
        for v in target.values():
            _synchronize(v)
    elif isinstance(target, (list, tuple)):
        for v in target:
            _synchronize(v)


class PhaseTimer:
    """Accumulates blocking wall-time per named phase.

    Usage::

        timer = PhaseTimer()
        with timer.phase("forward") as res:
            res["out"] = step(...)   # the timer waits for `out` at exit
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[dict]:
        t0 = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            block_target = result.get("out", block_on)
            if block_target is not None:
                _synchronize(block_target)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total * 1e3:10.2f} ms total  {n:5d} calls")
        return "\n".join(lines)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in traces (shows up in Perfetto)."""
    with record_function(name):
        yield
