"""Profiling hooks: spans and work counters, torch.profiler traces and
blocking phase timers.

The counterpart of the JAX package's ``utils/profiling.py``, with the
port's own spans and counters beside it.

**Spans and counters.** The port wraps each stage of its work in
:func:`span` (``encode.tokenize``, ``forward``, ``train_step``,
``collective.all_reduce``, ...) and adds the work a stage does to a counter
with :func:`count` (``to_device_bytes``, ``gather_bytes``,
``collective_bytes``, ...). Both feed one registry in this module: per
span, its entries and their total host seconds; per counter, its total.
:func:`snapshot` reads it and :func:`reset` empties it.

Recording is on only while ``torch.profiler`` records, or between
:func:`record` and :func:`stop` for an operator who wants the totals
without a profiler. Off, :func:`span` returns one shared no-op context
(no profiler range, no clock read) and :func:`count` adds nothing; a call
site whose counter argument costs work (a sum of ``nbytes``, a product of
shapes) computes it only behind :func:`enabled`. While the profiler
records, each span also opens a ``record_function`` range named
``ghf.<name>``, so a span sits on the profiler's timeline beside the
kernels it launched and the device's idle gaps; its host seconds are read
with ``time.perf_counter_ns`` at the same entry and exit.

The port's spans: ``encode`` and its stages ``encode.dedup``,
``encode.tokenize``, ``encode.layout``, ``encode.sort_plan``
(``data/encoding.py``); ``forward.to_device`` (``HyperGNN.forward_encoded``);
``forward`` with ``text_encoder``, then ``generator`` and
``message_passing`` once a layer (``apply_hypergnn``); ``train_step`` with
``loss`` (the forward and the loss), ``backward``, ``optimizer``
(a step replayed from its CUDA graph enters ``train_step`` alone);
``score`` (``score_all_tails``); ``collective.<op>`` (``parallel/``). Its
counters: ``to_device_bytes`` (host arrays copied to the model's device),
``gather_bytes`` (the least bytes of every row gather and its backward,
``ops/segment.py``), ``loss_sorted_uniform`` and ``loss_plain`` (calls
of the link-prediction losses by how their backward sums,
``training/objectives.py``), ``train_step_graph_captures``,
``train_step_graph_replays`` and ``train_step_graph_fallbacks``
(``training/train.py``), ``collective_calls``, ``collective_bytes`` and
``halo_rows`` (``parallel/``). A span's seconds are the host's: the device
work it enqueued may run later, which a trace's ``ghf.*`` ranges show.

The kernel wrappers' launch counters (``ops/cuda/_common.count_launch``)
are another thing: they count every launch of each kernel, always, so
tests can check which kernels a path routes to. The counters here count
work (bytes, calls, rows) and only while recording.

**Traces and timers.** :func:`device_trace` records a Chrome trace
(Perfetto opens it) with ``torch.profiler``, and :class:`PhaseTimer` waits
for the device at the end of a phase, so the device work of the phase is
counted in it: sound for scripts, not for a hot path.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# The prefix of every span's profiler range.
RANGE_PREFIX = "ghf."

_recording = False
# name -> [entries, total host nanoseconds]
_spans: Dict[str, list] = {}
_counters: Dict[str, int] = {}
# The counts of the block under tally(), or None outside one.
_tally = None


def enabled() -> bool:
    """Whether counters count: under :func:`record` or :func:`tally`, or
    while ``torch.profiler`` records (a module attribute it sets)."""
    return _recording or _tally is not None or _autograd_profiler._is_profiler_enabled


# What span() returns while recording is off.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        entry = _spans.get(self.name)
        if entry is None:
            _spans[self.name] = [1, dt]
        else:
            entry[0] += 1
            entry[1] += dt
        return False


def span(name: str):
    """A context that records one entry of span ``name`` and its host
    seconds while recording is on; off, and under :func:`tally`, the shared
    no-op context. Off, the inlined check is the whole cost."""
    if not (_recording or _autograd_profiler._is_profiler_enabled) or _tally is not None:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while recording is on; under
    :func:`tally`, to the tally's counts instead."""
    if _tally is not None:
        _tally[name] = _tally.get(name, 0) + n
    elif _recording or _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """Take every count made inside the block into the dict it yields,
    whether recording is on or not, and keep them, and the block's spans,
    out of the registry. For work that is recorded once and run later
    without its Python, as a CUDA graph's capture: each replay then adds
    the tally with :func:`count`, so it counts what the work counts."""
    global _tally
    outer, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = outer


def record() -> None:
    """Turn recording on without a profiler, until :func:`stop`."""
    global _recording
    _recording = True


def stop() -> None:
    """Turn :func:`record`'s recording off (a profiler's goes on)."""
    global _recording
    _recording = False


def snapshot() -> dict:
    """A copy of the registry: ``{"spans": {name: {"entries": n,
    "seconds": s}}, "counters": {name: total}}``."""
    return {
        "spans": {k: {"entries": n, "seconds": ns / 1e9} for k, (n, ns) in _spans.items()},
        "counters": dict(_counters),
    }


def reset() -> None:
    """Empty the registry."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def device_trace(logdir: str, device=None) -> Iterator[profile]:
    """Trace the block with torch.profiler and write ``logdir/trace.json``.

    The CPU is always traced; the CUDA device too when ``device`` is a CUDA
    device, or when it is None and a card is present. The port's spans
    show in it as ``ghf.*`` ranges.
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
