#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port (``graph_hypernetwork_forge_tpu_torch``) and nothing of
JAX, and fails (non-zero exit, no result line) on any failed phase:

1. device: require CUDA, print the card's name and power limit, TF32 off;
2. build: compile both CUDA kernels from ``csrc/`` with nvcc, in parallel;
3. kernels: each kernel against its plain PyTorch version at the xl
   shapes (N=50,000 nodes, E_pad≈1.03M group-padded edge rows, U_pad=240)
   at d=64 and d=128, on a layout with an empty relation and a node with no
   in-edges: max abs error against the stated tolerance, CUDA-event times
   of kernel, plain version and one PyTorch library call, and the bound
   (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s); the CSR
   kernel must be bitwise deterministic;
4. serving: the xl model at full width (text=64, F=H=64, 2 layers, random
   weights from seed 0) answers 3 zero-shot requests, each wiring two edges
   of a never-seen relation text into the xl graph, then encoding, running
   the forward and ranking all 50,000 tails for 256 query heads; every
   kernel must have launched 2 × 3 times, the outputs must be finite, and
   the first request must agree with the ``gather`` oracle on the card and
   a toy graph with the CPU run of the same model; one more warm request's
   device time is broken down by kernel with torch.profiler;
5. the kernels line, the card line and the result line, which is last:
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if not (ROOT / "graph_hypernetwork_forge_tpu_torch" / "csrc").is_dir():
    raise SystemExit(
        f"chip_smoke.py: the port's package is not beside this script in {ROOT}; "
        "run it from the root of a checkout of the repository"
    )
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import (  # noqa: E402
    ToyKnowledgeGraph,
)
from graph_hypernetwork_forge_tpu_torch.device import resolve_device  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNN  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.scoring import score_all_tails  # noqa: E402

# The xl config (benchmarks/scaling.py): N, E, U, text_dim, width, layers.
XL_N, XL_E, XL_U, TEXT_DIM, WIDTH, LAYERS = 50_000, 1_000_000, 237, 64, 64, 2
REQUESTS, QUERY_HEADS, TOP_K = 3, 256, 10

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor
# cores (the kernels run f32 FMAs on the CUDA cores), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Kernel vs plain: f32 sums of a few dozen order-1 terms (segments of ~20
# rows; kernel 2's dot products of d terms), taken in another order. Serving vs the gather oracle and the CPU: the repo's
# per-layer f32 parity gate.
KERNEL_ATOL = 1e-4
SERVING_ATOL = 3e-5

KERNELS = {
    "csr_segment_sum": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_sum.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:415 "
            "sorted_segment_sum_packed64 (d=64); same file :198 "
            "sorted_segment_sum_pallas (d%128==0)"
        ),
    ),
    "edge_transform_sorted_combined": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239 "
            "edge_transform_sorted_combined"
        ),
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xl_edges(seed: int = 0):
    """The xl graph as benchmarks/scaling.py draws it: features, edges, texts."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((XL_N, WIDTH)).astype(np.float32)
    ei = np.stack(
        [rng.integers(0, XL_N, size=XL_E), rng.integers(0, XL_N, size=XL_E)]
    ).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(XL_U)]
    etexts = [texts[i] for i in rng.integers(0, XL_U, size=XL_E)]
    return feats, ei, etexts, texts


def encode(ei, etexts):
    return encode_graph(
        ei, etexts, XL_N, sort_by_relation=True, with_sort_plan=True, group_pad=256
    )


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false")
    dev = resolve_device(None)
    log(f"device: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build(kernels.KERNEL_SOURCES)
    for name, info in built.items():
        log(f"build: {name}.cu in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")
    log(f"build: both sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)")


def _kernel_graph():
    """The xl layout, with node 7's in-edges moved to node 8 so that one
    node has none. The bank's padding relations (237-239) have no edges."""
    _, ei, etexts, _ = xl_edges()
    ei[1, ei[1] == 7] = 8
    return encode(ei, etexts)


def phase_kernels(dev) -> dict:
    g = _kernel_graph()
    plan = g.sort_plan.to(dev)
    rel = torch.as_tensor(g.rel_ids, device=dev)
    e_rows, n, u_pad = g.rel_ids.shape[0], XL_N, g.char_ids.shape[0]
    log(f"kernels: E_pad={e_rows} N={n} U_pad={u_pad} "
        f"longest dst segment={int(np.diff(g.sort_plan.dst_splits).max())} rows")
    pad_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.dst_perm] == 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for d in (64, 128):
        # Kernel 1 over the dst-sorted rows, bounded by the plan's dst_splits;
        # the masked pad rows (all in node 0's segment) are zero, as on the
        # main path.
        x = torch.randn(e_rows, d, device=dev, generator=gen)
        x[pad_sorted] = 0.0
        splits = plan.dst_splits
        fn = kernels.csr_segment_sum
        out = fn(x, splits, n)
        again = fn(x, splits, n)
        plain = kernels.csr_segment_sum_plain(x, splits, n)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"csr_segment_sum d={d}: two runs differ")
        if out[7].any():
            raise AssertionError(f"csr_segment_sum d={d}: empty segment 7 is not 0")
        err = (out - plain).abs().max().item()
        rows = int(g.sort_plan.dst_splits[n] - g.sort_plan.dst_splits[0])
        b_ms, b_by = bound((rows * d + (n + 1) + n * d) * 4, rows * d)
        offsets = splits[: n + 1].long()
        results[("csr_segment_sum", d)] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(x, splits, n)),
            plain_ms=cuda_ms(lambda: kernels.csr_segment_sum_plain(x, splits, n)),
            library_ms=cuda_ms(
                lambda: torch.segment_reduce(x, "sum", offsets=offsets, unsafe=True)
            ),
            bound_ms=b_ms, bound_by=b_by,
        )
        del x, out, again, plain

        # Kernel 2 over the relation-sorted rows with random banks.
        xs = torch.randn(e_rows, d, device=dev, generator=gen)
        xd = torch.randn(e_rows, d, device=dev, generator=gen)
        wm = torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
        ws = torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
        bias = torch.randn(u_pad, d, device=dev, generator=gen)
        args = (xs, xd, rel, wm, ws, bias)
        fn = kernels.edge_transform_sorted_combined
        out = fn(*args)
        plain = kernels.edge_transform_sorted_combined_plain(*args)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        tiles = e_rows // 256
        tile_rel = rel[::256].long()
        x_cat = torch.cat([xs, xd], dim=1).view(tiles, 256, 2 * d)
        w_cat = torch.cat([wm, ws], dim=1)[tile_rel]
        b_tile = bias[tile_rel][:, None, :]
        nbytes = (2 * e_rows * d + e_rows + 2 * u_pad * d * d + u_pad * d
                  + e_rows * d) * 4
        b_ms, b_by = bound(nbytes, 2 * 2 * e_rows * d * d + e_rows * d)
        results[("edge_transform_sorted_combined", d)] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_sorted_combined_plain(*args)
            ),
            library_ms=cuda_ms(lambda: torch.baddbmm(b_tile, x_cat, w_cat)),
            bound_ms=b_ms, bound_by=b_by,
        )
        del xs, xd, wm, ws, bias, args, out, plain, x_cat, w_cat, b_tile
        torch.cuda.empty_cache()

    for (name, d), r in results.items():
        log(f"kernel {name} d={d}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol {KERNEL_ATOL}) | ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f}")
    bad = [f"{k} d={d}" for (k, d), r in results.items()
           if not r["max_abs_err"] <= KERNEL_ATOL]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return results


def phase_serving(dev) -> dict:
    feats_np, ei, etexts, _ = xl_edges()
    feats = torch.as_tensor(feats_np, device=dev)
    model = HyperGNN(TEXT_DIM, WIDTH, WIDTH, LAYERS, seed=0, device=dev).eval()
    heads = torch.as_tensor(
        np.random.default_rng(1).choice(XL_N, QUERY_HEADS, replace=False), device=dev
    )
    requests = []
    for k in range(REQUESTS):
        # Two edges of a relation text the graph has never held (demo.py).
        new = np.asarray([[1 + k, 2 + k], [2 + k, k]], dtype=np.int64)
        requests.append((
            np.concatenate([ei, new], axis=1),
            etexts + [f"is colleague of, variant {k}"] * 2,
        ))

    kernels.reset_launch_counts()
    latencies, first = [], None
    for ei_k, texts_k in requests:
        t0 = time.perf_counter()
        graph = model.preprocess(ei_k, texts_k, XL_N)
        t1 = time.perf_counter()
        embs = model.forward_encoded(feats, graph)
        with torch.inference_mode():
            scores, top = torch.topk(score_all_tails(embs, heads), TOP_K, dim=1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if embs.shape != (XL_N, WIDTH) or not torch.isfinite(embs).all():
            raise AssertionError("serving: embeddings not finite or of wrong shape")
        if not torch.isfinite(scores).all() or top.shape != (QUERY_HEADS, TOP_K):
            raise AssertionError("serving: scores not finite or of wrong shape")
        latencies.append(dict(host_encode_ms=(t1 - t0) * 1e3,
                              device_ms=(t2 - t1) * 1e3,
                              total_ms=(t2 - t0) * 1e3))
        if first is None:
            first = (graph, embs)
    launches = {
        "csr_segment_sum": kernels.csr_segment_sum.launches,
        "edge_transform_sorted_combined":
            kernels.edge_transform_sorted_combined.launches,
    }
    for i, lat in enumerate(latencies):
        log(f"serving request {i}: host encode {lat['host_encode_ms']:.1f} ms, "
            f"device {lat['device_ms']:.1f} ms, total {lat['total_ms']:.1f} ms")
    log(f"serving launches: {launches}")
    wrong = {k: v for k, v in launches.items() if v != LAYERS * REQUESTS}
    if wrong:
        raise AssertionError(f"launch counts {wrong} != {LAYERS * REQUESTS}")

    profile = profile_request(model, feats, first[0], heads)

    # The first request against the gather oracle, on the card.
    oracle = HyperGNN(TEXT_DIM, WIDTH, WIDTH, LAYERS, seed=0, device=dev,
                      backend="gather").eval()
    graph, embs = first
    err_oracle = (oracle.forward_encoded(feats, graph) - embs).abs().max().item()
    del oracle
    # A toy graph: the card against the CPU (plain versions), same weights.
    kg = ToyKnowledgeGraph()
    on_card = HyperGNN(64, 16, 32, seed=0, device=dev).eval()(
        kg.node_features, kg.edge_index, kg.edge_texts)
    on_cpu = HyperGNN(64, 16, 32, seed=0, device="cpu").eval()(
        kg.node_features, kg.edge_index, kg.edge_texts)
    err_cpu = (on_card.cpu() - on_cpu).abs().max().item()
    log(f"serving: first request vs gather oracle max_abs_err {err_oracle:.3e}, "
        f"toy graph card vs cpu {err_cpu:.3e} (tol {SERVING_ATOL})")
    if not (err_oracle <= SERVING_ATOL and err_cpu <= SERVING_ATOL):
        raise AssertionError("serving disagrees with its references")
    return dict(launches=launches, latencies=latencies, profile=profile)


def profile_request(model, feats, graph, heads, rows: int = 12) -> dict:
    """Device time by kernel and copy for one more (warm) request's device
    part, by torch.profiler: the largest ``rows`` entries and the total."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        embs = model.forward_encoded(feats, graph)
        with torch.inference_mode():
            torch.topk(score_all_tails(embs, heads), TOP_K, dim=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3)
         for e in prof.key_averages()
         if e.self_device_time_total > 0 and not e.key.startswith("aten::")),
        key=lambda r: -r[2],
    )
    total = sum(ms for _, _, ms in device)
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    log(f"profile of one warm request: wall {wall_ms:.2f} ms, device {total:.3f} ms")
    for name, calls, ms in device[:rows]:
        log(f"  {ms:8.3f} ms {100 * ms / total:5.1f}%  x{calls:<3d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=total,
                top=[dict(name=n[:90], calls=c, ms=ms) for n, c, ms in device[:rows]])


def main() -> int:
    dev = phase_device()
    phase_build()
    measured = phase_kernels(dev)
    served = phase_serving(dev)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=served["launches"][name],
            **{key: measured[(name, 64)][key] for key in keys},
            d128={key: measured[(name, 128)][key] for key in keys},
        )
        for name, k in KERNELS.items()
    ]}
    print(json.dumps({"serving": served["latencies"], "profile": served["profile"]}))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
