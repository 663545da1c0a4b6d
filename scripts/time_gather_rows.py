#!/usr/bin/env python3
"""Time the row-gather kernel against ``index_select`` at the train cells' shapes.

    python3 scripts/time_gather_rows.py [--variants] [--out FILE]

Run from the root of a checkout on a machine with one CUDA card and nvcc.
At xl's shapes (1,031,168 layout rows, 50,000 nodes) and fb15k237's
(303,360 rows, 14,541 nodes), d = 64 f32, it times each gather a training
step makes: the node-table pair ``h[src]``, ``h[dst]`` (one launch), an
``[E, 64]`` permute by a SortPlan permutation, the rolled loss's int64 roll
gather, the ``[E]`` int32 index composition of the segment sum's backward,
the uniform loss's three node-table gathers (one launch, int32 and int64
indices) and its ``[3E, 64]`` int64 permute. Each line gives the wrapper's
milliseconds (CUDA events, the best of three means of 20 calls), the
kernel's own by torch.profiler, ``index_select``'s (the same two ways),
the least bytes (``ops.segment.gather_bytes``) over 3.35 TB/s, and the
kernel's share of that bound; every output is checked bit for bit against
``index_select``. ``--variants`` also builds copies of
``csrc/gather_rows.cu`` under ``build/variants/`` with its constants
changed (rows in flight a lane, the store hint) and times the source and
each variant in turn, twice over; the chosen values are the source's own. The card's name and power
limit come first; ``--out`` writes the results as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.segment import gather_bytes  # noqa: E402

# The package re-exports the function gather_rows under the module's name.
gr = importlib.import_module("graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows")

HBM_BYTES_PER_S = 3.35e12
SHAPES = {"xl": (1_031_168, 50_000), "fb15k237": (303_360, 14_541)}
D = 64
SOURCE = build.SOURCE_DIR / "gather_rows.cu"
OUT = ROOT / "build" / "variants"
DEPTH = "constexpr int kDepth = 4;"
STORES = "constexpr bool kStreamingStores = true;"
VARIANTS = {
    "2 rows in flight": [(DEPTH, DEPTH.replace("4", "2"))],
    "8 rows in flight": [(DEPTH, DEPTH.replace("4", "8"))],
    "default stores": [(STORES, STORES.replace("true", "false"))],
}


def cases(e: int, n: int, dev) -> dict:
    """``{name: (table, indices)}``: each gather of a training step at
    ``e`` layout rows over ``n`` nodes, indices drawn from a fixed seed."""
    g = torch.Generator(device=dev).manual_seed(0)
    node = torch.randn(n, D, device=dev, generator=g)
    rows = torch.randn(e, D, device=dev, generator=g)
    src, dst = (torch.randint(0, n, (e,), device=dev, generator=g, dtype=torch.int32)
                for _ in range(2))
    perm = torch.randperm(e, device=dev, generator=g).int()
    roll = (torch.arange(e, device=dev) + 12_345) % e
    neg = torch.randint(0, n, (e,), device=dev, generator=g)
    perm3 = torch.randperm(3 * e, device=dev, generator=g)
    return {
        "node pair h[src], h[dst]": (node, (src, dst)),
        "[E, 64] permute (int32)": (rows, (perm,)),
        "int64 roll gather": (rows, (roll,)),
        "[E] int32 index composition": (perm, (perm,)),
        "uniform loss, three node gathers": (node, (src, dst, neg)),
        "[3E, 64] int64 permute": (torch.randn(3 * e, D, device=dev, generator=g), (perm3,)),
    }


def events_ms(fn, iters: int = 20, repeats: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(repeats):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / iters)
    return best


def kernel_ms(fn, calls: int = 10) -> float:
    """Device milliseconds a call of ``fn``, all its kernels, by
    torch.profiler; a window the profiler hands back empty (it happens now
    and then) is profiled again, six times at most."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU)
        if us > 0:
            return us / 1e3 / calls
    raise SystemExit("time_gather_rows.py: torch.profiler recorded no kernel time")


def time_cases(label: str) -> list[dict]:
    dev = torch.device("cuda")
    out = []
    for cell, (e, n) in SHAPES.items():
        for name, (table, idx) in cases(e, n, dev).items():
            got, want = gr.gather_rows(table, *idx), gr.gather_rows_plain(table, *idx)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            nbytes = sum(gather_bytes(table, i) for i in idx)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            r = dict(build=label, cell=cell, case=name, bitwise_equal=same, bytes=nbytes,
                     bound_ms=bound,
                     ms=events_ms(lambda: gr.gather_rows(table, *idx)),
                     kernel_ms=kernel_ms(lambda: gr.gather_rows(table, *idx)),
                     index_select_ms=events_ms(lambda: gr.gather_rows_plain(table, *idx)),
                     index_select_kernel_ms=kernel_ms(lambda: gr.gather_rows_plain(table, *idx)))
            r["share_of_bound"] = bound / r["kernel_ms"]
            out.append(r)
            print(f"{label} | {cell} | {name}: {'bitwise equal' if same else 'DIFFERS'}; "
                  f"kernel {r['kernel_ms']:.4f} ms (wrapper {r['ms']:.4f}), bound "
                  f"{bound:.4f} ms ({nbytes / 1e9:.4f} GB), {100 * r['share_of_bound']:.1f}% "
                  f"of it; index_select {r['index_select_kernel_ms']:.4f} ms (wrapper "
                  f"{r['index_select_ms']:.4f})", flush=True)
        torch.cuda.empty_cache()
    return out


def variant_library(name: str, edits) -> ctypes.CDLL:
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new, 1)
    folder = OUT / "gather_rows" / name.replace(" ", "_").replace(",", "")
    folder.mkdir(parents=True, exist_ok=True)
    src, lib = folder / "gather_rows.cu", folder / "libgather_rows.so"
    src.write_text(text)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    ref = gr._lib().ghf_gather_rows
    cdll.ghf_gather_rows.argtypes, cdll.ghf_gather_rows.restype = ref.argtypes, ref.restype
    return cdll


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_gather_rows.py: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__}", flush=True)
    builds = {"source": gr._lib}
    if args.variants:
        for name, edits in VARIANTS.items():
            lib = variant_library(name, edits)
            builds[name] = lambda lib=lib: lib
    # Two rounds in turn, so that the card's clocks and neighbours weigh on
    # every build alike; the first round also warms the card.
    results = []
    built = gr._lib
    for _ in range(2 if args.variants else 1):
        for name, lib in builds.items():
            gr._lib = lib
            results += time_cases(name)
    gr._lib = built
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, results=results), indent=1))
    if not all(r["bitwise_equal"] for r in results):
        raise SystemExit("time_gather_rows.py: a gather differs from index_select")


if __name__ == "__main__":
    main()
