"""Structured per-step metrics with pluggable writers.

A copy of the JAX package's ``utils/metrics.py`` (pure Python): a
:class:`MetricsLogger` records step-keyed scalar dicts (loss, edges/s, ...)
and forwards them to writers: in-memory history, stdout and a JSONL file
are built in, and anything with a ``write(step, metrics)`` method plugs in.
The JAX module's ``Throughput`` has no copy here: it counted the rate at
which work was enqueued, not completed; the port's work counters are in
``utils/profiling.py``.
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

