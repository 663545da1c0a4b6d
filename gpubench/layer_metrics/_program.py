"""The port's own spans and counters, shared by the ``program_span`` and
``program_counter`` readers.

Beside ``port.py``, this is the one module of the benchmark that reaches
into the port, and it reads only ``utils.profiling.snapshot()``: per span
of the port, its entries and their host seconds; per counter, its total.
The port records only while torch.profiler records, so in a ``--trace 1``
run the registry holds exactly the profiled stretch, every attempt of it
included. A reader therefore divides by the entries of a span, never by
``trace.units``. Where the program has no such registry, or the span or
counter was never entered, every reader returns None.
"""

from __future__ import annotations

import importlib


def snapshot():
    """The port's registry, or None where the program has none."""
    profiling = importlib.import_module("graph_hypernetwork_forge_tpu_torch.utils.profiling")
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def span_ms(name: str):
    """Mean host milliseconds of an entry of span ``name``."""
    snap = snapshot()
    entry = None if snap is None else snap["spans"].get(name)
    if not entry or not entry["entries"]:
        return None
    return 1e3 * entry["seconds"] / entry["entries"]


def per_entry(counter: str, name: str):
    """Counter ``counter``'s total over the entries of span ``name``."""
    snap = snapshot()
    if snap is None or counter not in snap["counters"]:
        return None
    entry = snap["spans"].get(name)
    if not entry or not entry["entries"]:
        return None
    return snap["counters"][counter] / entry["entries"]
