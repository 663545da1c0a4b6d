"""Structured per-step metrics with pluggable writers.

A copy of the JAX package's ``utils/metrics.py`` (pure Python): a
:class:`MetricsLogger` records step-keyed scalar dicts (loss, edges/s, ...)
and forwards them to writers: in-memory history, stdout and a JSONL file
are built in, and anything with a ``write(step, metrics)`` method plugs in.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Protocol


class MetricsWriter(Protocol):
    def write(self, step: int, metrics: Dict[str, float]) -> None: ...


class HistoryWriter:
    """Keeps all metrics in memory (for tests and notebooks)."""

    def __init__(self) -> None:
        self.history: List[Dict] = []

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        self.history.append({"step": step, **metrics})


class StdoutWriter:
    def __init__(self, every: int = 1) -> None:
        self.every = every

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if step % self.every == 0:
            parts = " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}")


class JsonlWriter:
    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        self._fh.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class MetricsLogger:
    def __init__(self, writers: Optional[List[MetricsWriter]] = None) -> None:
        self.history = HistoryWriter()
        self.writers: List[MetricsWriter] = [self.history] + (writers or [])

    def log(self, step: int, **metrics: float) -> None:
        for w in self.writers:
            w.write(step, metrics)


class Throughput:
    """Edges/s (or any unit/s) counter over a sliding window."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._units = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._units = 0.0

    def add(self, units: float) -> None:
        self._units += units

    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._units / dt if dt > 0 else 0.0
