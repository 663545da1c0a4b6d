#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. Everything is found by name from ``BENCHMARK.json``:
the cell's configuration in ``gpubench/configs/<config>.json``, its
traffic mix in ``gpubench/traffic/<traffic>.json`` (whose ``driver`` names
the module of ``gpubench/drivers/`` that runs it), the limits of its
correctness check in ``gpubench/limits/<cell>.json``, and each per-layer
metric's reader in ``gpubench/layer_metrics/<metric>.py``.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` the window is followed by a short profiled stretch, and the
metrics are the cell's per-layer metrics. Every run checks what the timed
path produced against the plain reference once the window has closed, and
prints each number compared beside its limit, on standard error and under
``checks`` in the result's line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "graph_hypernetwork_forge_tpu")


def fail(msg: str, code: int = 2):
    print(f"gpubench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        fail(f"{path.relative_to(ROOT)} is missing")


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(bench: dict, name: str) -> SimpleNamespace:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    return SimpleNamespace(
        name=name, chips=w["chips"], traffic=w["traffic"],
        config=load_json(BENCH / "configs" / f"{w['config']}.json"),
        mix=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"))


def reported(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that ``cell`` reports: those that list it,
    and those that list no cells (every cell that reports what they move)."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    return [m for m in bench[section] if cell in m.get("workloads", [cell])
            and (section == "end_to_end" or m["moves"] in e2e)]


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    """``gpubench/layer_metrics/<name>.py`` (a metric's name may hold dots)."""
    path = BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.layer_metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layer_metrics(bench: dict, cell, out) -> dict:
    ctx = SimpleNamespace(trace=out.trace, cell=cell, **out.layer)
    metrics = {}
    for m in reported(bench, "per_layer", cell.name):
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Caches of compilers the port may reach, fixed inside the checkout (the
    # port's own nvcc and g++ builds go to build/ under the checkout).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")

    bench = manifest()
    cell = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        driver = importlib.import_module(f"gpubench.drivers.{cell.mix['driver']}")
    except ImportError as err:
        fail(f"cannot import the benchmark or the program: {err}")
    print(f"setup: imports done at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)

    found = loaded_forbidden()
    if found:
        fail(f"the run loaded {', '.join(found)}; the benchmark measures the port alone")
    if args.trace:
        metrics = layer_metrics(bench, cell, out)
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in reported(bench, "end_to_end", cell.name)}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace:
        device_info.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out.checks}
    for name, value, limit in out.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result = {"correct": bool(out.correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
