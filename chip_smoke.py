#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port (``graph_hypernetwork_forge_tpu_torch``) and nothing of
JAX, and fails (non-zero exit, no result line) on any failed phase:

1. device: require CUDA, print the card's name and power limit, TF32 off;
2. build: compile the four CUDA sources of ``csrc/`` with nvcc, in
   parallel;
3. kernels: each of the six kernels against its plain PyTorch version at
   the xl shapes (N=50,000 nodes, E_pad≈1.03M group-padded edge rows,
   U_pad=240) at d=64 and d=128, on a layout with an empty relation and a
   node with no in-edges: max abs error against the stated tolerance,
   CUDA-event times of kernel, plain version and one PyTorch library call
   (for kernels 3 and 6, the nearest composition of ``bmm`` calls), and
   the bound (bytes over 3.35 TB/s, or operations: for the matrix kernels
   2, 3, 5 and 6 three TF32 passes of their f32-class operations over 495
   TFLOP/s, with the CUDA-core bound of f32 operations over 67 TFLOP/s
   beside it; for the sums f32 operations over 67 TFLOP/s); kernels 2, 3,
   5 and 6 (3xTF32 on the tensor cores) must come within twice the plain
   f32 version's error of a float64 reference, output by output (dW
   scaled); kernels 1, 3, 6 and 7 must be bitwise deterministic, and
   kernels 3 and 6's dW of relations no tile visits exactly 0;
4. serving: the xl model at full width (text=64, F=H=64, 2 layers, random
   weights from seed 0) answers 3 zero-shot requests, each wiring two edges
   of a never-seen relation text into the xl graph, then encoding, running
   the forward and ranking all 50,000 tails for 256 query heads; kernels 1
   and 2 must each have launched 2 × 3 times, the outputs must be finite,
   and the first request must agree with the ``gather`` oracle on the card
   and a toy graph with the CPU run of the same model; one more warm
   request's device time is broken down by kernel with torch.profiler;
5. training: the same xl model (seed 0) takes 1 warm-up and 5 timed
   full-graph steps (``make_train_step(neg_mode="roll")``, Adam lr 1e-3,
   dropout 0, all positives): finite losses, the per-step launches of the
   three kernels equal to the count derived from the code, ms/step and
   edges/s (1,000,000 real edges per step), and one more step broken down
   by torch.profiler; then the same at xl-d128 (node_feat = hidden = 128,
   benchmarks/scaling.py's other xl config). At the bench size (N=1k,
   E=10k, U=50, d=64,
   group-padded) 3 steps with the same roll shifts on the card's ``cuda``
   backend must agree with the card's ``gather`` oracle and with the CPU;
   kernels 5, 6 and 7 must launch 0 times in the serving and training runs;
6. two-stream layer: one xl message-passing layer at d=64 and d=128
   through ``edge_contributions_cuda_sorted`` (kernel 5) and the
   two-stream tail, forward and backward (kernels 5, 6 and 1), against the
   same layer through the ``cuda`` backend (kernels 2, 3 and 1): output and
   the gradients of ``Σ out · R`` within the f32 gate (both sum in 3xTF32
   on the tensor cores, in other orders, so they agree to rounding and not
   bit for bit), the launches equal to the count derived from the code,
   CUDA-event ms of both;
7. grouped: the xl model (weights at scale 1) on the relation-sorted
   layout with a sort plan and no group padding, where ``auto`` picks the
   ``grouped`` backend as the JAX package does, against the ``cuda``
   backend on the group-padded layout of the same graph: per-layer
   embeddings and parameter gradients of ``Σ out · R``, launches, and ms
   per forward + backward (1 warm-up, 3 timed) of both;
8. dense and chunked: the bench config in the stored edge order, per-layer
   embeddings and parameter gradients against the card's ``gather`` oracle
   and against the CPU;
9. the training line, the kernels line, the card line and the result line,
   which is last: ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": 1}}``.
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
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (  # noqa: E402
    HyperGNN,
    HyperGNNConfig,
    apply_hypergnn,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (  # noqa: E402
    relational_message_passing,
    resolve_backend,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.ops.scoring import score_all_tails  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.training import (  # noqa: E402
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (  # noqa: E402
    named_leaves,
    tree_map,
)

# The xl config (benchmarks/scaling.py): N, E, U, text_dim, width, layers.
XL_N, XL_E, XL_U, TEXT_DIM, WIDTH, LAYERS = 50_000, 1_000_000, 237, 64, 64, 2
REQUESTS, QUERY_HEADS, TOP_K = 3, 256, 10
# Training: steps timed at xl after one warm-up, Adam's learning rate
# (benchmarks/scaling.py), and the bench config (bench.py) of the parity run.
TRAIN_STEPS, LEARNING_RATE = 5, 1e-3
BENCH_N, BENCH_E, BENCH_U, PARITY_STEPS = 1_000, 10_000, 50, 3

# NVIDIA H100 SXM data sheet, at the 700 W limit: HBM3 bandwidth, the f32
# rate outside the tensor cores, and the dense TF32 rate of the tensor cores.
# A matrix kernel's f32-class product takes three TF32 passes (3xTF32,
# csrc/tf32x3.cuh), so its operations bound is 3 x its operations at the
# TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TF32X3_PASSES = 3

# Kernel vs plain: f32 sums of a few dozen order-1 terms (segments of ~20
# rows; kernels 2 and 3's dot products of d terms), taken in another order.
# Kernel 3's dW sums ~4,300 products per relation, so it is compared after
# dividing by max(1, max|plain|). Serving vs the gather oracle and the CPU:
# the repo's per-layer f32 parity gate.
KERNEL_ATOL = 1e-4
SERVING_ATOL = 3e-5
# Training parity at the bench size. First-step gradients (same parameters
# on every side): the f32 gate after dividing by max(1, max|ref|). Losses:
# Adam's first steps move each parameter by about lr·sign(g), and where |g|
# sits at rounding noise the sign can differ between two summation orders,
# so later losses differ by more than rounding: 1e-4 relative (a wrong
# gradient moves them by percents). Parameters after the steps: each within
# that 2·lr-per-step sign flip, and 99.9% of them within 1e-5.
GRAD_ATOL, LOSS_RTOL, PARAM_Q999_ATOL = 3e-5, 1e-4, 1e-5

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
    "edge_transform_combined_bwd": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform_bwd.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368 "
            "_combined_bwd_fused_impl (kernel body :334-365)"
        ),
    ),
    "edge_transform_sorted": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:108 "
            "_edge_transform_fwd_impl (pallas_call :140), the kernel of "
            "edge_transform_sorted (:530)"
        ),
    ),
    "segment_outer": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_outer.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473 "
            "_segment_outer_impl (pallas_call :504)"
        ),
    ),
    "dual_sorted_segment_sum": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_sum.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:463 "
            "dual_sorted_segment_sum_pallas (pallas_call in _dual_impl :396)"
        ),
    ),
}

# Launches of each kernel per training step, counted from the code: kernel
# 2 once per layer; kernel 3 once per layer (edge transform backward);
# kernel 1 per layer once in the forward's aggregation tail and four times
# in the backward (the h[src] and h[dst] cotangents, dbias, kernel 3's dW
# partials), plus twice in the loss backward (src- and dst-sorted streams).
STEP_LAUNCHES = {
    "csr_segment_sum": LAYERS * 5 + 2,
    "edge_transform_sorted_combined": LAYERS,
    "edge_transform_combined_bwd": LAYERS,
    "edge_transform_sorted": 0,
    "segment_outer": 0,
    "dual_sorted_segment_sum": 0,
}
# A forward (serving) runs kernels 1 and 2 once per layer.
FORWARD_LAUNCHES = {
    name: LAYERS if name in ("csr_segment_sum", "edge_transform_sorted_combined") else 0
    for name in STEP_LAUNCHES
}
# One two-stream layer, forward and backward: kernel 5 in the forward and
# once more for dx; kernel 6 for dW_msg and dW_self; kernel 1 in the tail,
# in each kernel 6 call, for dbias and for the h[src] and h[dst] cotangents.
TWO_STREAM_LAUNCHES = dict(
    {name: 0 for name in STEP_LAUNCHES},
    csr_segment_sum=6, edge_transform_sorted=2, segment_outer=2,
)
# One forward and backward of the model on the grouped backend with a sort
# plan: per layer kernel 1 in the tail and for the h[src], h[dst] and bias
# cotangents; the per-relation products are PyTorch matmuls.
GROUPED_LAUNCHES = dict({name: 0 for name in STEP_LAUNCHES}, csr_segment_sum=4 * LAYERS)
GROUPED_TIMED = 3

FAILURES: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check and go on, so one run reports every phase;
    main() exits non-zero without a result line if any check failed."""
    if not ok:
        FAILURES.append(msg)
        log(f"FAIL: {msg}")


def launch_counts() -> dict:
    return {name: getattr(kernels, name).launches for name in KERNELS}


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


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference after dividing both by max(1, max|want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def bound(nbytes: float, flops: float, matrix: bool = False) -> tuple[float, str]:
    """The least ms for ``nbytes`` of traffic and ``flops`` operations, and
    which of the two bounds it. ``matrix``: the operations are f32-class
    products, at the tensor cores' 3xTF32 rate; else f32 on the CUDA cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = TF32_FLOP_PER_S / TF32X3_PASSES if matrix else F32_FLOP_PER_S
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matrix_bounds(nbytes: float, flops: float) -> dict:
    """A matrix kernel's bound on the tensor-core route, and the bound on
    the CUDA cores (f32 operations over 67 TFLOP/s) beside it."""
    b_ms, b_by = bound(nbytes, flops, matrix=True)
    return dict(bound_ms=b_ms, bound_by=b_by,
                cuda_core_bound_ms=bound(nbytes, flops)[0])


def float64_errors(fn, plain, args, scaled=()) -> list[tuple[float, float]]:
    """``(kernel, plain)`` max errors against ``plain`` in float64 on the
    same inputs, one pair per output; outputs in ``scaled`` after dividing
    by max(1, max|reference|)."""
    got, want = fn(*args), plain(*args)
    ref = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args))
    if isinstance(got, torch.Tensor):
        got, want, ref = (got,), (want,), (ref,)
    errs = []
    for i, (a, w, r) in enumerate(zip(got, want, ref)):
        scale = max(1.0, r.abs().max().item()) if i in scaled else 1.0
        errs.append(((a.double() - r).abs().max().item() / scale,
                     (w.double() - r).abs().max().item() / scale))
    del got, want, ref
    torch.cuda.empty_cache()
    return errs


def xl_edges(seed: int = 0, width: int = WIDTH):
    """The xl graph as benchmarks/scaling.py draws it: features, edges, texts
    (the features first, so the edges depend on the width, as there)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((XL_N, width)).astype(np.float32)
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
    log(f"build: all sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)")


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
    pad_src_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.src_perm] == 0, device=dev)
    visited = set(g.rel_ids[::256].tolist())
    unvisited = [r for r in range(u_pad) if r not in visited]
    # The bounds count what the kernels need of this data: one relation id
    # per 256-row tile and the banks of the visited relations only.
    u_vis = len(visited)
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
        check(torch.equal(out, again), f"csr_segment_sum d={d}: two runs differ")
        check(not out[7].any(), f"csr_segment_sum d={d}: empty segment 7 is not 0")
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
        nbytes = (2 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d
                  + e_rows * d) * 4
        [f64] = float64_errors(fn, kernels.edge_transform_sorted_combined_plain, args)
        results[("edge_transform_sorted_combined", d)] = dict(
            max_abs_err=err, f64_err=f64[0], plain_f64_err=f64[1],
            checked_f64=[f64],
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_sorted_combined_plain(*args)
            ),
            library_ms=cuda_ms(lambda: torch.baddbmm(b_tile, x_cat, w_cat)),
            **matrix_bounds(nbytes, 2 * 2 * e_rows * d * d + e_rows * d),
        )
        del args, out, plain, w_cat, b_tile

        # Kernel 3, the backward of kernel 2, on the same rows and banks with
        # a random cotangent. Its wrapper launches kernel 3 and then kernel
        # 1 over the run dW partials; its time is the whole wrapper's.
        g_out = torch.randn(e_rows, d, device=dev, generator=gen)
        args = (g_out, xs, xd, rel, wm, ws)
        fn = kernels.edge_transform_combined_bwd
        out = fn(*args)
        again = fn(*args)
        plain = kernels.edge_transform_combined_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"edge_transform_combined_bwd d={d}: two runs differ")
        check(bool(unvisited) and not any(dw[unvisited].any() for dw in out[2:]),
              f"edge_transform_combined_bwd d={d}: dW of the unvisited "
              f"relations {unvisited} is not exactly 0")
        err = max((a - b).abs().max().item() for a, b in zip(out[:2], plain[:2]))
        dw_err = max(scaled_err(a, b) for a, b in zip(out[2:], plain[2:]))
        # The nearest library composition: one bmm of the g tiles against
        # tile-gathered [W_msgᵀ | W_selfᵀ] for both dx, one bmm of the
        # [x_src | x_dst]ᵀ tiles against g for the per-tile dW; neither the
        # gathers nor the per-relation reduction is timed.
        g_tiles = g_out.view(tiles, 256, d)
        w_t = torch.cat([wm, ws], dim=1)[tile_rel].transpose(1, 2).contiguous()
        x_t = x_cat.transpose(1, 2)
        nbytes = (5 * e_rows * d + tiles + 2 * u_vis * d * d + 2 * u_pad * d * d) * 4
        f64 = float64_errors(fn, kernels.edge_transform_combined_bwd_plain, args,
                             scaled=(2, 3))
        results[("edge_transform_combined_bwd", d)] = dict(
            max_abs_err=err, dw_scaled_err=dw_err,
            f64_err=max(k for k, _ in f64), plain_f64_err=max(p for _, p in f64),
            checked_f64=f64,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_combined_bwd_plain(*args)
            ),
            library_ms=cuda_ms(
                lambda: (torch.bmm(g_tiles, w_t), torch.bmm(x_t, g_tiles))
            ),
            **matrix_bounds(nbytes, 8 * e_rows * d * d),
        )
        del args, out, again, plain, x_cat, w_t, x_t

        # Kernel 5, the two-output transform, on kernel 2's rows and banks.
        # Library: two batched products over the tile-gathered banks.
        args = (xs, xd, rel, wm, ws, bias)
        fn = kernels.edge_transform_sorted
        out = fn(*args)
        plain = kernels.edge_transform_sorted_plain(*args)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(out, plain))
        xs_t, xd_t = xs.view(tiles, 256, d), xd.view(tiles, 256, d)
        wm_t, ws_t = wm[tile_rel], ws[tile_rel]
        b_tile = bias[tile_rel][:, None, :]
        nbytes = (2 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d
                  + 2 * e_rows * d) * 4
        f64 = float64_errors(fn, kernels.edge_transform_sorted_plain, args)
        results[("edge_transform_sorted", d)] = dict(
            max_abs_err=err,
            f64_err=max(k for k, _ in f64), plain_f64_err=max(p for _, p in f64),
            checked_f64=f64,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: kernels.edge_transform_sorted_plain(*args)),
            library_ms=cuda_ms(
                lambda: (torch.baddbmm(b_tile, xs_t, wm_t), torch.bmm(xd_t, ws_t))
            ),
            **matrix_bounds(nbytes, 2 * 2 * e_rows * d * d + e_rows * d),
        )
        del args, out, plain, wm_t, ws_t, b_tile

        # Kernel 6, the segment outer product, of x_src against kernel 3's
        # cotangent. Its wrapper launches kernel 6 and then kernel 1 over
        # the run partials; its time is the whole wrapper's. Library: one
        # bmm of the xᵀ tiles against the g tiles, without the reduction.
        args = (xs, g_out, rel, u_pad)
        fn = kernels.segment_outer
        out = fn(*args)
        again = fn(*args)
        plain = kernels.segment_outer_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"segment_outer d={d}: two runs differ")
        check(not out[unvisited].any(),
              f"segment_outer d={d}: dW of the unvisited relations is not exactly 0")
        err = scaled_err(out, plain)
        xs_tt = xs_t.transpose(1, 2)
        [f64] = float64_errors(fn, kernels.segment_outer_plain, args, scaled=(0,))
        results[("segment_outer", d)] = dict(
            max_abs_err=(out - plain).abs().max().item(), dw_scaled_err=err,
            checked=[err], f64_err=f64[0], plain_f64_err=f64[1], checked_f64=[f64],
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: kernels.segment_outer_plain(*args)),
            library_ms=cuda_ms(lambda: torch.bmm(xs_tt, g_tiles)),
            **matrix_bounds((2 * e_rows * d + tiles + u_pad * d * d) * 4,
                            2 * e_rows * d * d),
        )
        del xs, xd, wm, ws, bias, g_out, args, out, again, plain, xs_t, xd_t, xs_tt
        del g_tiles
        torch.cuda.empty_cache()

        # Kernel 7, the dual CSR segment-sum, over the src-sorted and
        # dst-sorted rows with their own bounds: the cotangent pair of a
        # layer's h[src], h[dst] gathers (pad rows zero, as there). Library:
        # two torch.segment_reduce calls.
        xa = torch.randn(e_rows, d, device=dev, generator=gen)
        xa[pad_src_sorted] = 0.0
        xb = torch.randn(e_rows, d, device=dev, generator=gen)
        xb[pad_sorted] = 0.0
        args = (xa, xb, n, plan.src_splits, plan.dst_splits)
        fn = kernels.dual_sorted_segment_sum
        out = fn(*args)
        again = fn(*args)
        plain = kernels.dual_sorted_segment_sum_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"dual_sorted_segment_sum d={d}: two runs differ")
        err = max((a - b).abs().max().item() for a, b in zip(out, plain))
        off_a = plan.src_splits[: n + 1].long()
        rows_a = int(g.sort_plan.src_splits[n] - g.sort_plan.src_splits[0])
        b_ms, b_by = bound(((rows_a + rows) * d + 2 * (n + 1) + 2 * n * d) * 4,
                           (rows_a + rows) * d)
        results[("dual_sorted_segment_sum", d)] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: kernels.dual_sorted_segment_sum_plain(*args)),
            library_ms=cuda_ms(lambda: (
                torch.segment_reduce(xa, "sum", offsets=off_a, unsafe=True),
                torch.segment_reduce(xb, "sum", offsets=offsets, unsafe=True),
            )),
            bound_ms=b_ms, bound_by=b_by,
        )
        del xa, xb, args, out, again, plain
        torch.cuda.empty_cache()

    for (name, d), r in results.items():
        dw = (f" dW scaled err {r['dw_scaled_err']:.3e}"
              if "dw_scaled_err" in r else "")
        f64 = (f" | vs float64 {r['f64_err']:.3e}, plain {r['plain_f64_err']:.3e}"
               if "f64_err" in r else "")
        core = (f" [CUDA-core bound {r['cuda_core_bound_ms']:.4f}]"
                if "cuda_core_bound_ms" in r else "")
        log(f"kernel {name} d={d}: max_abs_err {r['max_abs_err']:.3e}{dw} "
            f"(tol {KERNEL_ATOL}){f64} | ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}){core} plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f}")
        # A dW sums thousands of products: it is held after scaling.
        checked = r.get("checked", [r["max_abs_err"], r.get("dw_scaled_err", 0.0)])
        check(max(checked) <= KERNEL_ATOL, f"{name} d={d} disagrees with its plain version")
        # 3xTF32 is held to f32's own error against float64, output by output.
        check(all(k <= 2 * p for k, p in r.get("checked_f64", [])),
              f"{name} d={d}: float64 error over twice the plain version's "
              f"{r.get('checked_f64')}")
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
        check(embs.shape == (XL_N, WIDTH) and bool(torch.isfinite(embs).all()),
              "serving: embeddings not finite or of wrong shape")
        check(bool(torch.isfinite(scores).all()) and top.shape == (QUERY_HEADS, TOP_K),
              "serving: scores not finite or of wrong shape")
        latencies.append(dict(host_encode_ms=(t1 - t0) * 1e3,
                              device_ms=(t2 - t1) * 1e3,
                              total_ms=(t2 - t0) * 1e3))
        if first is None:
            first = (graph, embs)
    launches = launch_counts()
    for i, lat in enumerate(latencies):
        log(f"serving request {i}: host encode {lat['host_encode_ms']:.1f} ms, "
            f"device {lat['device_ms']:.1f} ms, total {lat['total_ms']:.1f} ms")
    log(f"serving launches: {launches}")
    want = {name: n * REQUESTS for name, n in FORWARD_LAUNCHES.items()}
    check(launches == want, f"serving launch counts {launches} != {want}")

    def request():
        embs = model.forward_encoded(feats, first[0])
        with torch.inference_mode():
            torch.topk(score_all_tails(embs, heads), TOP_K, dim=1)

    profile = profile_device("one warm request", request)

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
    check(err_oracle <= SERVING_ATOL and err_cpu <= SERVING_ATOL,
          "serving disagrees with its references")
    return dict(launches=launches, latencies=latencies, profile=profile)


def profile_device(label: str, fn, rows: int = 14) -> dict:
    """Device time by kernel and copy of one more (warm) ``fn()``, by
    torch.profiler: the largest ``rows`` entries and the total."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device events (kernels and copies) only: host ops (aten ops, the
    # autograd Functions) and annotated ranges (Optimizer.step) would count
    # the kernels they launch again.
    device = sorted(
        ((e.key, e.count, e.self_device_time_total / 1e3)
         for e in prof.key_averages()
         if e.self_device_time_total > 0
         and e.device_type != torch.autograd.DeviceType.CPU
         and not getattr(e, "is_user_annotation", False)),
        key=lambda r: -r[2],
    )
    total = sum(ms for _, _, ms in device)
    check(total > 0, f"torch.profiler recorded no device time for {label}")
    log(f"profile of {label}: wall {wall_ms:.2f} ms, device {total:.3f} ms")
    for name, calls, ms in device[:rows]:
        log(f"  {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{calls:<4d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=total,
                top=[dict(name=n[:90], calls=c, ms=ms) for n, c, ms in device[:rows]])


def train_config(backend: str = "cuda", width: int = WIDTH) -> HyperGNNConfig:
    """The xl training config of benchmarks/scaling.py: 2 layers, width 64
    (128 for xl-d128), the relation-sorted group-padded layout, dropout 0."""
    return HyperGNNConfig(
        text_dim=TEXT_DIM, node_feat_dim=width, hidden_dim=width,
        num_layers=LAYERS, backend=backend, rel_sorted=True, group_padded=True,
    )


def _trainer(graph, feats_np, init, backend, device, width=WIDTH):
    """``step(shift=None) -> loss`` over fresh Adam state on ``device``, and
    the parameter tree it updates in place."""
    state = create_train_state(
        tree_map(lambda t: t.to(device), init), adam(LEARNING_RATE)
    )
    step = make_train_step(train_config(backend, width), neg_mode="roll")
    feats = torch.as_tensor(feats_np, device=device)
    arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
    plan = graph.sort_plan.to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def run(shift=None):
        _, _, loss = step(state.params, state.opt_state, feats, *arrays, gen,
                          neg_dst=shift, sort_plan=plan)
        return loss

    return run, state.params


def phase_training(dev, width: int = WIDTH) -> dict:
    """1 warm-up and TRAIN_STEPS timed xl steps at ``width`` (64: xl,
    128: xl-d128), then one more step under the profiler."""
    name = "xl" if width == WIDTH else f"xl-d{width}"
    feats_np, ei, etexts, _ = xl_edges(width=width)
    graph = encode(ei, etexts)
    init = init_hypergnn(train_config(width=width), torch.Generator().manual_seed(0))
    run, _ = _trainer(graph, feats_np, init, "cuda", dev, width)
    torch.cuda.reset_peak_memory_stats(dev)
    warm = run()
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [run() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    losses = [warm.item()] + [loss.item() for loss in losses]
    ms_step = seconds / TRAIN_STEPS * 1e3
    edges_s = XL_E * TRAIN_STEPS / seconds
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"training {name}: losses {['%.6f' % v for v in losses]} (warm-up first)")
    log(f"training {name}: {ms_step:.3f} ms/step, {edges_s:,.0f} edges/s "
        f"({TRAIN_STEPS} steps, {XL_E:,} real edges of {graph.src.shape[0]:,} rows), "
        f"peak memory {peak_gb:.2f} GB")
    log(f"training {name} launches over {TRAIN_STEPS} steps: {launches}")
    check(all(np.isfinite(losses)), f"training {name}: a loss is not finite")
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    check(launches == want, f"training {name} launch counts {launches} != {want}")
    profile = profile_device(f"one more {name} training step", run)
    # The profiler slows the host, not the kernels: the profiled step's
    # device time over the unprofiled step time is the card's busy share.
    busy = profile["device_ms"] / ms_step
    log(f"training {name}: device busy {100 * busy:.1f}% of a step "
        f"(profiled device time over unprofiled ms/step)")
    return dict(ms_per_step=ms_step, edges_per_s=edges_s, losses=losses,
                peak_memory_gb=peak_gb, device_busy_share=busy,
                launches=launches, profile=profile)


def _leaves(params, grads: bool) -> dict:
    return {path: (t.grad if grads else t).detach().cpu().clone()
            for path, t in named_leaves(params)}


def phase_training_parity(dev) -> dict:
    """The bench config (bench.py): PARITY_STEPS steps with the same roll
    shifts through the card's ``cuda`` backend, the card's ``gather``
    oracle and the CPU (the kernels' plain versions), from one init."""
    rng = np.random.default_rng(0)
    feats_np = rng.standard_normal((BENCH_N, WIDTH)).astype(np.float32)
    ei = np.stack([rng.integers(0, BENCH_N, BENCH_E),
                   rng.integers(0, BENCH_N, BENCH_E)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(BENCH_U)]
    etexts = [texts[i] for i in rng.integers(0, BENCH_U, BENCH_E)]
    graph = encode_graph(ei, etexts, BENCH_N, sort_by_relation=True,
                         with_sort_plan=True, group_pad=256)
    init = init_hypergnn(train_config(), torch.Generator().manual_seed(0))
    shifts = np.random.default_rng(2).integers(1, graph.src.shape[0], PARITY_STEPS)
    runs = {}
    for label, device, backend in (("cuda", dev, "cuda"), ("gather", dev, "gather"),
                                   ("cpu", torch.device("cpu"), "cuda")):
        run, params = _trainer(graph, feats_np, init, backend, device)
        losses, grads = [], None
        for shift in shifts:
            losses.append(run(int(shift)).item())
            grads = grads or _leaves(params, grads=True)
        runs[label] = (losses, grads, _leaves(params, grads=False))
    losses, grads, params = runs["cuda"]
    report = {"losses": losses}
    for ref in ("gather", "cpu"):
        r_losses, r_grads, r_params = runs[ref]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        grad_err = max(scaled_err(grads[p], g) for p, g in r_grads.items())
        diffs = torch.cat([(params[p] - t).abs().flatten() for p, t in r_params.items()])
        param_max = diffs.max().item()
        param_q999 = torch.quantile(diffs.double()[:: max(1, diffs.numel() // 2**24)],
                                    0.999).item()
        log(f"training parity vs {ref}: loss rel err {loss_err:.3e} (tol {LOSS_RTOL}), "
            f"first-step grad scaled err {grad_err:.3e} (tol {GRAD_ATOL}), params "
            f"max {param_max:.3e} (tol {2 * LEARNING_RATE * PARITY_STEPS}) "
            f"q99.9 {param_q999:.3e} (tol {PARAM_Q999_ATOL})")
        check(loss_err <= LOSS_RTOL and grad_err <= GRAD_ATOL
              and param_max <= 2 * LEARNING_RATE * PARITY_STEPS
              and param_q999 <= PARAM_Q999_ATOL,
              f"training on the card disagrees with the {ref} run")
        report[ref] = dict(loss_rel_err=loss_err, grad_scaled_err=grad_err,
                           param_max_abs_diff=param_max, param_q999_abs_diff=param_q999)
    return report


def phase_two_stream(dev, d: int) -> dict:
    """One xl layer at width ``d`` through the two-stream path (kernels 5,
    6 and 1) against the ``cuda`` backend (kernels 2, 3 and 1), forward and
    backward of ``Σ out · R``."""
    g = _kernel_graph()
    plan = g.sort_plan.to(dev)
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
    u_pad = g.char_ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d)
    init = [
        torch.randn(XL_N, d, device=dev, generator=gen),
        torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5,
        torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5,
        torch.randn(u_pad, d, device=dev, generator=gen),
    ]
    r = torch.randn(XL_N, d, device=dev, generator=gen)

    def two_stream(h, wm, ws, b):
        msg, selfc = kernels.edge_contributions_cuda_sorted(
            h, src, dst, rel, wm, ws, b, sort_plan=plan)
        return two_stream_tail(msg, selfc, dst, XL_N, edge_mask=mask, sort_plan=plan)

    def combined(h, wm, ws, b):
        return relational_message_passing(
            h, src, dst, rel, wm, ws, b, edge_mask=mask, backend="cuda",
            rel_sorted=True, group_padded=True, sort_plan=plan)

    def fwd_bwd(layer):
        leaves = [t.clone().requires_grad_(True) for t in init]
        out = layer(*leaves)
        (out * r).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    kernels.reset_launch_counts()
    out, grads = fwd_bwd(two_stream)
    torch.cuda.synchronize()
    launches = launch_counts()
    ref, ref_grads = fwd_bwd(combined)
    err = (out - ref).abs().max().item()
    grad_err = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
    ms = cuda_ms(lambda: fwd_bwd(two_stream), iters=5, warmup=1)
    ref_ms = cuda_ms(lambda: fwd_bwd(combined), iters=5, warmup=1)
    # Both paths sum in 3xTF32 on the tensor cores, kernels 2 and 3 over
    # K = 2 d_in and runs, kernels 5 and 6 per bank: they agree within the
    # f32 gate, not bit for bit.
    log(f"two-stream layer d={d}: vs the cuda backend max_abs_err {err:.3e}, "
        f"scaled grad err {grad_err:.3e} (tol {SERVING_ATOL} / {GRAD_ATOL}, "
        f"to rounding: both 3xTF32, summed in other orders) | fwd+bwd "
        f"{ms:.3f} ms, cuda backend {ref_ms:.3f} ms | launches {launches}")
    check(err <= SERVING_ATOL and grad_err <= GRAD_ATOL,
          f"two-stream layer d={d} disagrees with the cuda backend")
    check(launches == TWO_STREAM_LAUNCHES,
          f"two-stream layer d={d} launch counts {launches} != {TWO_STREAM_LAUNCHES}")
    return dict(max_abs_err=err, grad_scaled_err=grad_err, ms=ms,
                cuda_backend_ms=ref_ms, launches=launches)


def _scale_one(params) -> dict:
    """The parameter tree with the generated weights at scale 1 instead of
    the 0.01 init, so message passing moves the output well beyond the
    residual (as the parity tests set them)."""
    for wg in params["weight_generators"]:
        wg["log_scales"] = {k: torch.zeros_like(v) for k, v in wg["log_scales"].items()}
    return params


def _model_run(config, init, feats, graph, device):
    """``run() -> (per-layer outputs, {path: grad})`` of ``Σ out · R`` for
    the model on ``device``, R drawn from a seeded generator."""
    feats = torch.as_tensor(feats, device=device)
    arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
    plan = None if graph.sort_plan is None else graph.sort_plan.to(device)
    r = torch.randn(feats.shape[0], config.hidden_dim,
                    generator=torch.Generator().manual_seed(7)).to(device)

    def run():
        params = tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), init)
        layers = apply_hypergnn(config, params, feats, *arrays,
                                return_all_layers=True, sort_plan=plan)
        (layers[-1] * r).sum().backward()
        return ([h.detach() for h in layers],
                {path: t.grad for path, t in named_leaves(params)})

    return run


def _compare_runs(label, got, want) -> tuple[float, float]:
    (layers, grads), (ref_layers, ref_grads) = got, want
    err = max((a.cpu() - b.cpu()).abs().max().item() for a, b in zip(layers, ref_layers))
    grad_err = max(scaled_err(grads[p].cpu(), g.cpu()) for p, g in ref_grads.items())
    log(f"{label}: per-layer max_abs_err {err:.3e} (tol {SERVING_ATOL}), "
        f"parameter grad scaled err {grad_err:.3e} (tol {GRAD_ATOL})")
    check(err <= SERVING_ATOL and grad_err <= GRAD_ATOL, f"{label}: disagree")
    return err, grad_err


def _host_ms(fn, timed: int) -> float:
    """Host milliseconds per ``fn()`` over ``timed`` runs after one warm-up,
    each ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed * 1e3


def phase_grouped(dev) -> dict:
    """The xl model on the relation-sorted layout with a sort plan and no
    group padding, where ``auto`` picks ``grouped``, against the ``cuda``
    backend on the group-padded layout of the same graph."""
    feats, ei, etexts, _ = xl_edges()
    sorted_graph = encode_graph(ei, etexts, XL_N, sort_by_relation=True,
                                with_sort_plan=True)
    padded_graph = encode(ei, etexts)
    cfg = HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=WIDTH, hidden_dim=WIDTH,
                         num_layers=LAYERS, backend="auto", rel_sorted=True)
    picked = resolve_backend(
        "auto", XL_N, sorted_graph.char_ids.shape[0], sorted_graph.src.shape[0],
        WIDTH, rel_sorted=True, group_padded=False, has_sort_plan=True)
    check(picked == "grouped", f"grouped: auto picked {picked!r}, not 'grouped'")
    init = _scale_one(init_hypergnn(cfg, torch.Generator().manual_seed(0)))
    grouped = _model_run(cfg, init, feats, sorted_graph, dev)
    padded = _model_run(train_config(), init, feats, padded_graph, dev)

    kernels.reset_launch_counts()
    got = grouped()
    torch.cuda.synchronize()
    launches = launch_counts()
    err, grad_err = _compare_runs("grouped xl vs the cuda backend", got, padded())
    check(launches == GROUPED_LAUNCHES,
          f"grouped launch counts {launches} != {GROUPED_LAUNCHES}")
    ms = _host_ms(grouped, GROUPED_TIMED)
    cuda_backend_ms = _host_ms(padded, GROUPED_TIMED)
    log(f"grouped xl: {ms:.3f} ms per forward + backward ({sorted_graph.src.shape[0]:,} "
        f"rows), cuda backend on the padded layout {cuda_backend_ms:.3f} ms "
        f"({padded_graph.src.shape[0]:,} rows) | launches {launches}")
    profile = profile_device("one more grouped xl forward + backward", grouped)
    busy = profile["device_ms"] / ms
    log(f"grouped xl: device busy {100 * busy:.1f}% of a forward + backward")
    return dict(ms=ms, cuda_backend_ms=cuda_backend_ms, max_abs_err=err,
                grad_scaled_err=grad_err, launches=launches,
                device_busy_share=busy, profile=profile)


def phase_dense_chunked(dev) -> dict:
    """The bench config in the stored edge order (no sort, no plan) through
    ``dense`` and ``chunked``, against the card's ``gather`` oracle and the
    same backend on the CPU."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((BENCH_N, WIDTH)).astype(np.float32)
    ei = np.stack([rng.integers(0, BENCH_N, BENCH_E),
                   rng.integers(0, BENCH_N, BENCH_E)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(BENCH_U)]
    etexts = [texts[i] for i in rng.integers(0, BENCH_U, BENCH_E)]
    graph = encode_graph(ei, etexts, BENCH_N)

    def config(backend):
        return HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=WIDTH,
                              hidden_dim=WIDTH, num_layers=LAYERS, backend=backend)

    init = _scale_one(init_hypergnn(config("gather"), torch.Generator().manual_seed(0)))
    oracle = _model_run(config("gather"), init, feats, graph, dev)()
    report = {}
    for backend in ("dense", "chunked"):
        got = _model_run(config(backend), init, feats, graph, dev)()
        on_cpu = _model_run(config(backend), init, feats, graph, torch.device("cpu"))()
        report[backend] = dict(
            vs_gather=_compare_runs(f"{backend} bench vs the gather oracle", got, oracle),
            vs_cpu=_compare_runs(f"{backend} bench card vs cpu", got, on_cpu),
        )
    return report


def main() -> int:
    dev = phase_device()
    phase_build()
    measured = phase_kernels(dev)
    served = phase_serving(dev)
    trained = phase_training(dev)
    # xl-d128 after xl: the kernels line keeps xl's launches.
    xl_d128 = phase_training(dev, 128)
    trained["parity"] = phase_training_parity(dev)
    two_stream = {d: phase_two_stream(dev, d) for d in (64, 128)}
    grouped = phase_grouped(dev)
    dense_chunked = phase_dense_chunked(dev)
    if FAILURES:
        log(f"chip_smoke.py: {len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    keys = ("max_abs_err", "dw_scaled_err", "f64_err", "plain_f64_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "cuda_core_bound_ms", "library_ms")

    def numbers(name, d):
        return {key: measured[(name, d)][key] for key in keys
                if key in measured[(name, d)]}

    # launches: kernels 1-3 over the timed training steps, kernels 5 and 6
    # in the d=64 two-stream layer (their path); kernel 7 is on no path, as
    # in the JAX package.
    path_launches = dict(trained["launches"], edge_transform_sorted=two_stream[64][
        "launches"]["edge_transform_sorted"], segment_outer=two_stream[64][
        "launches"]["segment_outer"])
    line = {"kernels": [
        dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=path_launches[name],
            launches_per_training_step=trained["launches"][name] // TRAIN_STEPS,
            launches_per_forward=served["launches"][name] // REQUESTS,
            launches_per_two_stream_layer=two_stream[64]["launches"][name],
            launches_per_grouped_step=grouped["launches"][name],
            **numbers(name, 64), d128=numbers(name, 128),
        )
        for name, k in KERNELS.items()
    ]}
    print(json.dumps({"serving": served["latencies"], "profile": served["profile"]}))
    print(json.dumps({"training": trained, "training_xl_d128": xl_d128}))
    print(json.dumps({"two_stream": two_stream, "grouped": grouped,
                      "dense_chunked": dense_chunked}))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
