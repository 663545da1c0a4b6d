"""Kernels 3 and 6's run tables and their in-kernel dW reduction, on the CPU.

Kernels 3 (``_combined_bwd_fused_impl``'s port) and 6 (``_segment_outer_impl``'s)
walk a relation's 256-row tiles in runs and add the runs' f32 dW partials
inside the kernel: the block that draws a relation's last ticket sums its
partials in run order (``csrc/run_reduce.cuh``). Here, without a card:

- the run tables a SortPlan carries, built on the host once per layout,
  equal ``run_bounds`` (the PyTorch reference) on every layout;
- a torch emulation of the ordered last-arriver reduction, with the runs
  arriving in random orders, is bitwise the sum in run order, passes
  single-run relations through, leaves unvisited relations at exactly 0,
  and equals the JAX package's kernels run in interpret mode;
- kernel 3's plain bf16 path at d_out = 192 (a width the bf16 kernel walks
  in two 128-column slabs) against JAX's bf16 branch.

The kernels themselves are held against these on the card by
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    _combined_bwd_fused_impl,
    _segment_outer_impl,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import (
    GROUP_PAD,
    RUN_TILES,
    build_sort_plan,
    encode_graph,
    split_runs,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    plan_runs,
    run_bounds,
)
from torch_cases import assert_scaled_close, run_case

BF16_ULP = 2.0**-7


def _layout(name):
    """``(rel_ids [E] int32, U)`` of a named relation-sorted tile layout."""
    if name in ("tiles_5_4_9_1", "ragged_last_tile"):
        # Relations of 5, 4, 9, 1, 0 and 3 tiles in a bank of 8; the second
        # cuts 100 rows off the last tile.
        rel = run_case(0, 4, 4, 100 if name == "ragged_last_tile" else 0)[2]
        return rel, 8
    if name == "empty_relations":
        # Relation 0, two in the middle and the last two have no rows.
        counts = [0, 700, 0, 0, 2600, 256, 0, 0]
        rel = np.concatenate(
            [np.full(-(-n // GROUP_PAD) * GROUP_PAD, u, dtype=np.int32)
             for u, n in enumerate(counts)])
        return rel, len(counts)
    rng = np.random.default_rng(3)
    n, e, u = 500, 9000, 23
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    graph = encode_graph(ei, etexts, n, sort_by_relation=True, with_sort_plan=True,
                         group_pad=GROUP_PAD)
    return graph.rel_ids, graph.char_ids.shape[0]


_LAYOUTS = ["tiles_5_4_9_1", "empty_relations", "ragged_last_tile", "encode_graph"]


@pytest.mark.parametrize("run_tiles", [1, 2, RUN_TILES, 8])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_plan_run_tables_equal_run_bounds(layout, run_tiles):
    # The plan's tile bounds, split into runs on the host, at the plan's run
    # length (the table it carries) and at others.
    rel, u = _layout(layout)
    e = rel.shape[0]
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 50, e).astype(np.int32), rng.integers(0, 50, e).astype(np.int32)
    plan = build_sort_plan(src, dst, rel, np.ones(e, np.float32), 50, u)
    want_t, want_r, max_runs = run_bounds(torch.from_numpy(rel), u, run_tiles)
    got_r = split_runs(plan.tile_splits, run_tiles)
    assert got_r.dtype == plan.tile_splits.dtype == np.int32
    np.testing.assert_array_equal(plan.tile_splits, want_t.numpy())
    np.testing.assert_array_equal(got_r, want_r.numpy())
    assert int(want_r[-1]) <= max_runs
    if run_tiles != RUN_TILES:
        return
    table = plan_runs(plan.to("cpu"))
    assert table.run_tiles == run_tiles
    for got, want in ((table.tile_splits, want_t), (table.run_splits, want_r)):
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (got, want)


def test_encode_graph_plan_carries_the_run_table():
    # encode_graph's own plan, on the layout it stored.
    rng = np.random.default_rng(4)
    n, e, u = 300, 7000, 19
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    graph = encode_graph(ei, etexts, n, sort_by_relation=True, with_sort_plan=True,
                         group_pad=GROUP_PAD)
    rel, u_pad = torch.from_numpy(graph.rel_ids), graph.char_ids.shape[0]
    plan = graph.sort_plan
    want_t, want_r, _ = run_bounds(rel, u_pad, RUN_TILES)
    np.testing.assert_array_equal(plan.tile_splits, want_t.numpy())
    np.testing.assert_array_equal(plan.run_splits, want_r.numpy())


def _run_partials(xs, g, rel, u, run_tiles):
    """``(partials [runs, banks, d_in, d_out], run_splits)``: each run's f32
    ``xᵀ g`` over its tiles, one bank per x in ``xs``, as the kernels'
    blocks write them."""
    t_splits, r_splits, _ = run_bounds(rel, u, run_tiles)
    runs = int(r_splits[-1])
    parts = torch.zeros((runs, len(xs), xs[0].shape[1], g.shape[1]))
    for q in range(runs):
        v = int(torch.searchsorted(r_splits, q, right=True)) - 1
        t0 = int(t_splits[v]) + (q - int(r_splits[v])) * run_tiles
        t1 = min(t0 + run_tiles, int(t_splits[v + 1]))
        rows = slice(t0 * GROUP_PAD, t1 * GROUP_PAD)
        for b, x in enumerate(xs):
            parts[q, b] = x[rows].T @ g[rows]
    return parts, r_splits


def _last_arriver(parts, r_splits, u, order):
    """The ordered last-arriver reduction, emulated: runs finish in
    ``order``; a relation's only run writes its dW; otherwise each finished
    run takes a ticket of its relation, and the run that takes the last one
    resets the count and sums the relation's partials in run order.
    Relations without runs are written as zeros."""
    dw = torch.full((u,) + tuple(parts.shape[1:]), float("nan"))
    tickets = [0] * u
    for v in range(u):
        if r_splits[v + 1] == r_splits[v]:
            dw[v] = 0.0
    for q in order:
        v = int(torch.searchsorted(r_splits, int(q), right=True)) - 1
        q0, runs = int(r_splits[v]), int(r_splits[v + 1] - r_splits[v])
        if runs == 1:
            dw[v] = parts[q]
            continue
        tickets[v] += 1
        if tickets[v] == runs:
            tickets[v] = 0
            acc = torch.zeros_like(parts[0])
            for p in range(q0, q0 + runs):
                acc = acc + parts[p]
            dw[v] = acc
    assert tickets == [0] * u, "every counter is back at 0"
    return dw


def _in_run_order(parts, r_splits, u):
    """Each relation's partials summed from its first run to its last."""
    dw = torch.zeros((u,) + tuple(parts.shape[1:]))
    for v in range(u):
        for p in range(int(r_splits[v]), int(r_splits[v + 1])):
            dw[v] = dw[v] + parts[p]
    return dw


def _check_reduction(parts, r_splits, u):
    """Two random arrival orders: bitwise the sum in run order; single-run
    relations pass their partial through; relations without runs are 0."""
    runs = parts.shape[0]
    rng = np.random.default_rng(runs)
    got = [_last_arriver(parts, r_splits, u, rng.permutation(runs)) for _ in range(2)]
    want = _in_run_order(parts, r_splits, u)
    for dw in got:
        assert torch.equal(dw, want)
    counts = (r_splits[1:] - r_splits[:-1]).tolist()
    for v, n in enumerate(counts):
        if n == 1:
            assert torch.equal(got[0][v], parts[int(r_splits[v])])
        if n == 0:
            assert not got[0][v].any()
    assert 1 in counts and 0 in counts and max(counts) > 1
    return got[0]


@pytest.mark.parametrize("run_tiles", [2, 4])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_last_arriver_reduction_of_kernel_3_matches_pallas(run_tiles, tail_cut):
    xs, xd, rel, wm, ws, _ = run_case(40, 16, 24, tail_cut)
    g = np.random.default_rng(41).standard_normal((rel.shape[0], 24)).astype(np.float32)
    want = _combined_bwd_fused_impl(
        *(jnp.asarray(a) for a in (g, xs, xd, rel, wm, ws)),
        interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    parts, r_splits = _run_partials(
        (torch.from_numpy(xs), torch.from_numpy(xd)), torch.from_numpy(g),
        torch.from_numpy(rel), 8, run_tiles)
    dw = _check_reduction(parts, r_splits, 8)
    for b, name in enumerate(("dW_msg", "dW_self")):
        assert_scaled_close(dw[:, b].numpy(), want[2 + b], err_msg=name)
        assert not dw[[4, 6, 7], b].any()


@pytest.mark.parametrize("run_tiles", [2, 4])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_last_arriver_reduction_of_kernel_6_matches_pallas(run_tiles, tail_cut):
    xs, _, rel, *_ = run_case(42, 40, 72, tail_cut)
    g = np.random.default_rng(43).standard_normal((rel.shape[0], 72)).astype(np.float32)
    want = _segment_outer_impl(
        jnp.asarray(xs), jnp.asarray(g), jnp.asarray(rel), 8,
        interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    parts, r_splits = _run_partials(
        (torch.from_numpy(xs),), torch.from_numpy(g), torch.from_numpy(rel), 8, run_tiles)
    dw = _check_reduction(parts, r_splits, 8)[:, 0]
    assert_scaled_close(dw.numpy(), want)


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_plain_bf16_at_d_out_192_matches_pallas(tail_cut):
    # d_out = 192: the bf16 kernel walks it in two 128-column slabs and
    # rounds dx once from its f32 sum over both, as JAX's f32 dot_general
    # over the whole d_out is cast once.
    xs, xd, rel, wm, ws, _ = run_case(44, 16, 192, tail_cut)
    g = np.random.default_rng(45).standard_normal((rel.shape[0], 192)).astype(np.float32)
    (jg, tg), (jxs, txs), (jxd, txd), (jwm, twm), (jws, tws) = (
        _bf16(a) for a in (g, xs, xd, wm, ws))
    want = _combined_bwd_fused_impl(jg, jxs, jxd, jnp.asarray(rel), jwm, jws,
                                    interpret=True, precision=None)
    got = kernels.edge_transform_combined_bwd(tg, txs, txd, torch.from_numpy(rel), twm, tws)
    for name, a, w in zip(("dx_src", "dx_dst"), got[:2], want[:2]):
        assert a.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = np.asarray(jnp.asarray(w, jnp.float32))
        err = np.abs(a.float().numpy() - w).max()
        assert err <= BF16_ULP * np.abs(w).max(), (name, err)
    for name, a, w in zip(("dW_msg", "dW_self"), got[2:], want[2:]):
        # f32 sums of exact bf16 products: 1e-5 after scaling.
        assert a.dtype == torch.float32
        w = np.asarray(w)
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a.numpy() / scale, w / scale, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not a[[4, 6, 7]].any(), "relations without rows must be exactly zero"
