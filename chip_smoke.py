#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port (``graph_hypernetwork_forge_tpu_torch``) and nothing of
JAX, and fails (non-zero exit, no result line) on any failed phase:

1. device: require CUDA, print the card's name and power limit, TF32 off;
2. build: compile the three CUDA kernels from ``csrc/`` with nvcc, in
   parallel;
3. kernels: each kernel against its plain PyTorch version at the xl
   shapes (N=50,000 nodes, E_pad≈1.03M group-padded edge rows, U_pad=240)
   at d=64 and d=128, on a layout with an empty relation and a node with no
   in-edges: max abs error against the stated tolerance, CUDA-event times
   of kernel, plain version and one PyTorch library call (for kernel 3, the
   nearest composition of two ``bmm``), and the bound (bytes over 3.35 TB/s
   or f32 operations over 67 TFLOP/s); kernels 1 and 3 must be bitwise
   deterministic, and kernel 3's dW of relations no tile visits exactly 0;
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
6. the training line, the kernels line, the card line and the result line,
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
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
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

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor
# cores (the kernels run f32 FMAs on the CUDA cores), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

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
}

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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        del args, out, plain, w_cat, b_tile

        # Kernel 3, the backward of kernel 2, on the same rows and banks with
        # a random cotangent. Its wrapper launches kernel 3 and then kernel
        # 1 over the per-tile dW partials; its time is the whole wrapper's.
        g_out = torch.randn(e_rows, d, device=dev, generator=gen)
        args = (g_out, xs, xd, rel, wm, ws)
        fn = kernels.edge_transform_combined_bwd
        out = fn(*args)
        again = fn(*args)
        plain = kernels.edge_transform_combined_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"edge_transform_combined_bwd d={d}: two runs differ")
        visited = set(g.rel_ids[::256].tolist())
        unvisited = [r for r in range(u_pad) if r not in visited]
        check(bool(unvisited) and not any(dw[unvisited].any() for dw in out[2:]),
              f"edge_transform_combined_bwd d={d}: dW of the unvisited "
              f"relations {unvisited} is not exactly 0")
        err = max((a - b).abs().max().item() for a, b in zip(out[:2], plain[:2]))
        dw_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                     for a, b in zip(out[2:], plain[2:]))
        # The nearest library composition: one bmm of the g tiles against
        # tile-gathered [W_msgᵀ | W_selfᵀ] for both dx, one bmm of the
        # [x_src | x_dst]ᵀ tiles against g for the per-tile dW; neither the
        # gathers nor the per-relation reduction is timed.
        g_tiles = g_out.view(tiles, 256, d)
        w_t = torch.cat([wm, ws], dim=1)[tile_rel].transpose(1, 2).contiguous()
        x_t = x_cat.transpose(1, 2)
        nbytes = (5 * e_rows * d + e_rows + 4 * u_pad * d * d) * 4
        b_ms, b_by = bound(nbytes, 8 * e_rows * d * d)
        results[("edge_transform_combined_bwd", d)] = dict(
            max_abs_err=err, dw_scaled_err=dw_err,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_combined_bwd_plain(*args)
            ),
            library_ms=cuda_ms(
                lambda: (torch.bmm(g_tiles, w_t), torch.bmm(x_t, g_tiles))
            ),
            bound_ms=b_ms, bound_by=b_by,
        )
        del xs, xd, wm, ws, bias, g_out, args, out, again, plain, x_cat, w_t, x_t
        torch.cuda.empty_cache()

    for (name, d), r in results.items():
        dw = (f" dW scaled err {r['dw_scaled_err']:.3e}"
              if "dw_scaled_err" in r else "")
        log(f"kernel {name} d={d}: max_abs_err {r['max_abs_err']:.3e}{dw} "
            f"(tol {KERNEL_ATOL}) | ms {r['ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}) plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f}")
        check(r["max_abs_err"] <= KERNEL_ATOL
              and r.get("dw_scaled_err", 0.0) <= KERNEL_ATOL,
              f"{name} d={d} disagrees with its plain version")
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
    # A forward runs kernels 1 and 2 once per layer, and no backward.
    want = {name: LAYERS * REQUESTS if name != "edge_transform_combined_bwd" else 0
            for name in KERNELS}
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
        grad_err = max((grads[p] - g).abs().max().item()
                       / max(1.0, g.abs().max().item()) for p, g in r_grads.items())
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


def main() -> int:
    dev = phase_device()
    phase_build()
    measured = phase_kernels(dev)
    served = phase_serving(dev)
    trained = phase_training(dev)
    # xl-d128 after xl: the kernels line keeps xl's launches.
    xl_d128 = phase_training(dev, 128)
    trained["parity"] = phase_training_parity(dev)
    if FAILURES:
        log(f"chip_smoke.py: {len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    keys = ("max_abs_err", "dw_scaled_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")

    def numbers(name, d):
        return {key: measured[(name, d)][key] for key in keys
                if key in measured[(name, d)]}

    # launches: over the timed training steps, the main path of this slice.
    line = {"kernels": [
        dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=trained["launches"][name],
            launches_per_training_step=STEP_LAUNCHES[name],
            launches_per_forward=served["launches"][name] // REQUESTS,
            **numbers(name, 64), d128=numbers(name, 128),
        )
        for name, k in KERNELS.items()
    ]}
    print(json.dumps({"serving": served["latencies"], "profile": served["profile"]}))
    print(json.dumps({"training": trained, "training_xl_d128": xl_d128}))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
