"""The port's CUDA kernels, through their plain PyTorch versions, and the
autograd Functions around them.

On the CPU each wrapper runs its plain version; these tests hold those
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs, at f32 atol 3e-5 (the parity gate), and each Function's
backward against ``torch.autograd.gradcheck`` in float64 and against the
JAX VJP of its counterpart. The kernels themselves are held against these
plain versions on the card by test_torch_cuda.py.
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
from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    edge_transform_sorted_combined as jax_edge_transform,
)
from graph_hypernetwork_forge_tpu.ops.pallas.segment_sum import (
    sorted_segment_sum_packed64,
    sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
    edge_transform_sorted_combined_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    edge_transform_combined_bwd,
    edge_transform_combined_bwd_plain,
    run_bounds,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows import (
    gather_rows,
    vector_bytes,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    csr_segment_sum_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops import segment as pseg
from graph_hypernetwork_forge_tpu_torch.ops.segment import sorted_segment_sum
from graph_hypernetwork_forge_tpu_torch.utils import profiling
from torch_cases import (
    ATOL,
    GATHER_CASES,
    assert_scaled_close,
    edge_case,
    gather_case,
    kernel_counts,
    run_case,
    segment_case,
)


@pytest.mark.parametrize("skew", [False, True])
def test_csr_plain_matches_pallas_d128(skew):
    x, ids, splits = segment_case(0, 900, 70, 128, skew)
    want = sorted_segment_sum_pallas(
        jnp.asarray(x), jnp.asarray(ids), 70, interpret=True,
        splits=jnp.asarray(splits),
    )
    got = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 70)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not got[-3:].any()


@pytest.mark.parametrize("skew", [False, True])
def test_csr_plain_matches_packed64_d64(skew):
    x, ids, splits = segment_case(1, 1024, 64, 64, skew)
    want = sorted_segment_sum_packed64(
        jnp.asarray(x), jnp.asarray(ids), 64, True, "exact", jnp.asarray(splits)
    )
    got = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_csr_reads_only_the_first_n_plus_one_bounds():
    x, ids, splits = segment_case(2, 300, 20, 8, False)
    longer = np.concatenate([splits, [splits[-1]] * 5]).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=20)
    got = sorted_segment_sum(
        torch.from_numpy(x), torch.from_numpy(ids), 20, torch.from_numpy(longer)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_plain_matches_pallas(d, tail_cut):
    xs, xd, rel, wm, ws, b = edge_case(3, d, tail_cut)
    want = jax_edge_transform(
        jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(rel), jnp.asarray(wm),
        jnp.asarray(ws), jnp.asarray(b), None, 256, True,
    )
    got = edge_transform_sorted_combined_plain(
        *(torch.from_numpy(a) for a in (xs, xd, rel, wm, ws, b))
    )
    assert got.shape == (rel.shape[0], d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_edge_transform_tile_takes_its_first_rows_relation():
    # Mixed relations inside one tile: the tile's first row decides, as on
    # the TPU (the contract the group-padded layout exists for).
    rng = np.random.default_rng(4)
    e, d, u = 300, 8, 3
    rel = np.sort(rng.integers(0, u, e)).astype(np.int32)
    xs, xd = (rng.standard_normal((e, d)).astype(np.float32) for _ in range(2))
    wm, ws = (rng.standard_normal((u, d, d)).astype(np.float32) for _ in range(2))
    b = rng.standard_normal((u, d)).astype(np.float32)
    got = edge_transform_sorted_combined_plain(
        *(torch.from_numpy(a) for a in (xs, xd, rel, wm, ws, b))
    ).numpy()
    tile_rel = rel[(np.arange(e) // 256) * 256]
    want = (
        np.einsum("ed,edo->eo", xs, wm[tile_rel])
        + np.einsum("ed,edo->eo", xd, ws[tile_rel]) + b[tile_rel]
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    with profiling.tally() as counts:
        x, _, splits = segment_case(5, 200, 16, 64, False)
        out = csr_segment_sum(torch.from_numpy(x), torch.from_numpy(splits), 16)
        torch.testing.assert_close(
            out, csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 16),
            rtol=0, atol=0,
        )
        args = [torch.from_numpy(a) for a in edge_case(6, 64, 0)]
        torch.testing.assert_close(
            edge_transform_sorted_combined(*args),
            edge_transform_sorted_combined_plain(*args), rtol=0, atol=0,
        )
        g = torch.ones(args[0].shape)
        for got, want in zip(
            edge_transform_combined_bwd(g, *args[:5]),
            edge_transform_combined_bwd_plain(g, *args[:5]),
        ):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not kernel_counts(counts), counts


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_gather_rows_on_the_cpu_is_index_select_in_every_stream_form(name, index_dtype):
    table, indices = gather_case(name, index_dtype)
    with profiling.tally() as counts:
        got = gather_rows(table, *indices)
    assert len(got) == len(indices)
    for out, idx in zip(got, indices):
        assert out.dtype == table.dtype and torch.equal(out, table.index_select(0, idx))
    assert kernel_counts(counts) == {}


def test_gather_rows_takes_one_to_three_indices():
    table, (idx,) = gather_case("f32_d64", torch.int32)
    for indices in ((), (idx,) * 4):
        with pytest.raises(ValueError, match="1 to 3 indices"):
            gather_rows(table, *indices)


def test_the_gather_kernels_form_is_the_widest_vector_row_and_addresses_allow():
    # The form each card launch would take: 16 bytes for f32 rows at d=64
    # or bf16 at d=64, 4 for a 252-byte row, a 4-byte row or a table 4
    # bytes off its allocation, 2 for bf16 rows of three values.
    rows = torch.zeros(10, 64)
    assert vector_bytes(256, rows) == vector_bytes(128, rows.bfloat16()) == 16
    assert vector_bytes(252, rows) == vector_bytes(4, rows) == 4
    assert vector_bytes(256, rows.view(-1)[1:]) == 4
    assert vector_bytes(256, rows.view(-1)[2:]) == 8
    assert vector_bytes(6, rows.bfloat16()) == 2
    assert vector_bytes(3, rows.to(torch.uint8)) == 1


def test_inputs_that_want_a_gradient_are_refused():
    # The raw launches record nothing for autograd, so they refuse inputs
    # that want a gradient and name the differentiable entry points.
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="differentiable entry points"):
        _common.require_inference("k", t)
    with torch.no_grad():
        _common.require_inference("k", t)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_plain_matches_pallas(d, tail_cut):
    xs, xd, rel, wm, ws, _ = edge_case(10, d, tail_cut)
    g = np.random.default_rng(11).standard_normal((rel.shape[0], d)).astype(np.float32)
    want = _combined_bwd_fused_impl(
        *(jnp.asarray(a) for a in (g, xs, xd, rel, wm, ws)),
        interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    got = edge_transform_combined_bwd_plain(
        *(torch.from_numpy(a) for a in (g, xs, xd, rel, wm, ws))
    )
    for name, a, b in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), got, want):
        assert tuple(a.shape) == b.shape, name
        assert_scaled_close(a.numpy(), b, err_msg=name)
    # Relations 6 and 7 of the bank have no rows: exactly zero.
    for dw in got[2:]:
        assert not dw[6:].any()


def _partials_by_runs(x, g, rel, u, run_tiles):
    """Kernels 3 and 6's dW partials as their blocks walk them: block q finds its
    relation in ``run_splits`` and takes tiles ``tile_splits[u] + (q -
    run_splits[u]) * run_tiles`` onward, at most ``run_tiles`` of them."""
    t_splits, r_splits, max_runs = run_bounds(rel, u, run_tiles)
    runs = int(r_splits[u])
    assert runs <= max_runs
    parts = torch.zeros((max(runs, 1), x.shape[1], g.shape[1]))
    for q in range(runs):
        rel_q = int(torch.searchsorted(r_splits, q, right=True)) - 1
        t0 = int(t_splits[rel_q]) + (q - int(r_splits[rel_q])) * run_tiles
        t1 = min(t0 + run_tiles, int(t_splits[rel_q + 1]))
        rows = slice(t0 * 256, t1 * 256)
        assert (rel[rows] == rel_q).all(), "a run holds one relation"
        parts[q] = x[rows].T @ g[rows]
    return csr_segment_sum_plain(parts.view(parts.shape[0], -1), r_splits, u).view(
        u, x.shape[1], g.shape[1])


@pytest.mark.parametrize("run_tiles", [1, 2, 4, 16])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_run_partials_sum_to_the_pallas_dw(run_tiles, tail_cut):
    # Relations of 5, 4, 9, 1, 0 and 3 tiles walked in runs of run_tiles:
    # the run sums, added per relation over run_splits, give the TPU
    # kernel's dW; relations without tiles get no run and stay exactly 0.
    xs, xd, rel, wm, ws, _ = run_case(19, 16, 24, tail_cut)
    g = np.random.default_rng(20).standard_normal((rel.shape[0], 24)).astype(np.float32)
    want = _combined_bwd_fused_impl(
        *(jnp.asarray(a) for a in (g, xs, xd, rel, wm, ws)),
        interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    t = {k: torch.from_numpy(a) for k, a in dict(g=g, xs=xs, xd=xd, rel=rel).items()}
    for x, dw_want in ((t["xs"], want[2]), (t["xd"], want[3])):
        got = _partials_by_runs(x, t["g"], t["rel"], wm.shape[0], run_tiles)
        assert_scaled_close(got.numpy(), dw_want)
        assert not got[[4, 6, 7]].any()


@pytest.mark.parametrize("run_tiles", [1, 2, 4])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_segment_outer_run_partials_sum_to_the_pallas_dw(run_tiles, tail_cut):
    # Kernel 6 walks the runs of kernel 3 with one bank: x_srcᵀ g per run,
    # added per relation over run_splits, is the TPU kernel's dW at any
    # d_in and d_out; relations 4, 6 and 7 own no tile and stay exactly 0.
    xs, _, rel, *_ = run_case(26, 40, 72, tail_cut)
    g = np.random.default_rng(27).standard_normal((rel.shape[0], 72)).astype(np.float32)
    want = _segment_outer_impl(
        jnp.asarray(xs), jnp.asarray(g), jnp.asarray(rel), 8,
        interpret=True, precision=jax.lax.Precision.HIGHEST,
    )
    got = _partials_by_runs(
        torch.from_numpy(xs), torch.from_numpy(g), torch.from_numpy(rel), 8, run_tiles)
    assert tuple(got.shape) == want.shape
    assert_scaled_close(got.numpy(), want)
    assert not got[[4, 6, 7]].any()


def _f64(*arrays):
    return [torch.from_numpy(np.asarray(a, dtype=np.float64)).requires_grad_(True)
            for a in arrays]


def _sorted_case(seed, e=60, n=12, d=3):
    """Unsorted ids with empty segments, their sort plan and CSR bounds."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - 3, e).astype(np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(e, dtype=np.int32)
    ids_sorted = ids[perm]
    splits = np.searchsorted(ids_sorted, np.arange(n + 1)).astype(np.int32)
    x = rng.standard_normal((e, d))
    table = rng.standard_normal((n, d))
    return dict(ids=ids, perm=perm, inv=inv, ids_sorted=ids_sorted,
                splits=splits, x=x, table=table, n=n)


@pytest.mark.parametrize("with_splits", [False, True])
def test_segment_functions_pass_gradcheck(with_splits):
    c = _sorted_case(12)
    t = {k: torch.from_numpy(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    splits = t["splits"] if with_splits else None
    n = c["n"]
    x, table = _f64(c["x"], c["table"])
    checks = [
        (lambda v: pseg.sorted_segment_sum(v, t["ids_sorted"], n, splits),
         x[t["perm"].long()].detach().requires_grad_(True)),
        (lambda v: pseg.sorted_segment_sum_by_plan(
            v, t["perm"], t["inv"], t["ids_sorted"], n, splits), x),
        (lambda v: pseg.permute_rows(v, t["perm"], t["inv"]), x),
        (lambda tb: pseg.take_rows_sorted(
            tb, t["ids"], t["perm"], t["ids_sorted"], splits), table),
        (lambda tb: pseg.take_rows_sorted(
            tb, t["ids_sorted"], None, t["ids_sorted"], splits), table),
        (lambda tb: pseg.take_rows_pair(
            tb, t["ids"], t["ids_sorted"], t["perm"], t["ids_sorted"], splits,
            None, t["ids_sorted"], splits), table),
    ]
    for fn, inp in checks:
        assert torch.autograd.gradcheck(fn, (inp,), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reduce_unsorted_sums_like_index_add(dtype):
    # A long run at row 0 (a group-padded layout's pad rows), repeats, and
    # the last 5 rows never named (empty segments).
    rng = np.random.default_rng(14)
    e, n, d = 300, 30, 5
    idx = np.concatenate([np.zeros(120), rng.integers(0, n - 5, e - 120)]).astype(np.int32)
    rng.shuffle(idx)
    g = torch.from_numpy(rng.standard_normal((e, d))).to(dtype)
    got = pseg.reduce_unsorted(g, torch.from_numpy(idx), n)
    want = torch.zeros(n, d, dtype=torch.float64).index_add_(0, torch.from_numpy(idx).long(),
                                                             g.double())
    assert got.dtype == dtype and not got[n - 5:].any()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("with_splits", [False, True])
def test_edge_transform_function_passes_gradcheck(with_splits):
    rng = np.random.default_rng(13)
    e, d, u = 300, 3, 4  # tiles: [0,256) relation 0, [256,300) relation 2
    rel = np.repeat(np.array([0, 2], dtype=np.int32), [256, 44])
    rel_splits = torch.from_numpy(
        np.searchsorted(rel, np.arange(u + 1)).astype(np.int32)
    )
    xs, xd = _f64(*rng.standard_normal((2, e, d)))
    wm, ws = _f64(*rng.standard_normal((2, u, d, d)))
    (b,) = _f64(rng.standard_normal((u, d)))
    fn = lambda *a: edge_transform_sorted_combined(
        a[0], a[1], torch.from_numpy(rel), *a[2:],
        rel_splits if with_splits else None,
    )
    assert torch.autograd.gradcheck(fn, (xs, xd, wm, ws, b), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("d", [64, 128])
def test_edge_transform_vjp_matches_jax(d):
    xs, xd, rel, wm, ws, b = edge_case(14, d, 0)
    g = np.random.default_rng(15).standard_normal((rel.shape[0], d)).astype(np.float32)
    rel_splits = np.searchsorted(rel, np.arange(wm.shape[0] + 1)).astype(np.int32)
    jx = [jnp.asarray(a) for a in (xs, xd, wm, ws, b)]

    def jfn(xs_, xd_, wm_, ws_, b_):
        return jax_edge_transform(
            xs_, xd_, jnp.asarray(rel), wm_, ws_, b_, jnp.asarray(rel_splits),
            256, True,
        )

    _, vjp = jax.vjp(jfn, *jx)
    want = vjp(jnp.asarray(g))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in (xs, xd, wm, ws, b)]
    out = edge_transform_sorted_combined(
        tx[0], tx[1], torch.from_numpy(rel), *tx[2:], torch.from_numpy(rel_splits)
    )
    out.backward(torch.from_numpy(g))
    for name, t, w in zip(("x_src", "x_dst", "w_msg", "w_self", "bias"), tx, want):
        assert_scaled_close(t.grad.numpy(), w, err_msg=name)


def test_segment_function_vjps_match_jax():
    from graph_hypernetwork_forge_tpu.ops import segment as jseg

    c = _sorted_case(16, e=400, n=50, d=16)
    n = c["n"]
    x32, tb32 = c["x"].astype(np.float32), c["table"].astype(np.float32)
    rng = np.random.default_rng(17)
    g_rows = rng.standard_normal((400, 16)).astype(np.float32)
    g_nodes = rng.standard_normal((n, 16)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    cases = [
        ("sorted_segment_sum", x32, g_nodes,
         lambda v: pseg.sorted_segment_sum(v, t["ids_sorted"], n, t["splits"]),
         lambda v: jseg.sorted_segment_sum(v, j["ids_sorted"], n, j["splits"])),
        ("sorted_segment_sum_by_plan", x32, g_nodes,
         lambda v: pseg.sorted_segment_sum_by_plan(
             v, t["perm"], t["inv"], t["ids_sorted"], n, t["splits"]),
         lambda v: jseg.sorted_segment_sum_by_plan(
             v, j["perm"], j["inv"], j["ids_sorted"], n, j["splits"])),
        ("permute_rows", x32, g_rows,
         lambda v: pseg.permute_rows(v, t["perm"], t["inv"]),
         lambda v: jseg.permute_rows(v, j["perm"], j["inv"])),
        ("take_rows_sorted", tb32, g_rows,
         lambda v: pseg.take_rows_sorted(
             v, t["ids"], t["perm"], t["ids_sorted"], t["splits"]),
         lambda v: jseg.take_rows_sorted(
             n, v, j["ids"], j["perm"], j["ids_sorted"], j["splits"])),
        ("take_rows_pair", tb32, (g_rows, g_rows[::-1].copy()),
         lambda v: pseg.take_rows_pair(
             v, t["ids"], t["ids_sorted"], t["perm"], t["ids_sorted"],
             t["splits"], None, t["ids_sorted"], t["splits"]),
         lambda v: jseg.take_rows_pair(
             n, v, j["ids"], j["ids_sorted"], j["perm"], j["ids_sorted"],
             j["splits"], None, j["ids_sorted"], j["splits"])),
    ]
    for name, inp, g, pfn, jfn in cases:
        gs = g if isinstance(g, tuple) else (g,)
        v = torch.from_numpy(inp).requires_grad_(True)
        out = pfn(v)
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(outs, [torch.from_numpy(a) for a in gs])
        _, vjp = jax.vjp(jfn, jnp.asarray(inp))
        jg = tuple(jnp.asarray(a) for a in gs)
        (want,) = vjp(jg if isinstance(g, tuple) else jg[0])
        assert_scaled_close(v.grad.numpy(), want, err_msg=name)


def test_segment_ops_match_jax():
    from graph_hypernetwork_forge_tpu.ops import segment as jseg

    rng = np.random.default_rng(9)
    e, n, d = 400, 50, 16
    ids = rng.integers(0, n - 5, e).astype(np.int32)  # the last 5 stay empty
    x = rng.standard_normal((e, d)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    table = rng.standard_normal((n, d)).astype(np.float32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(e, dtype=np.int32)
    ids_sorted = ids[perm]
    splits = np.searchsorted(ids_sorted, np.arange(n + 1)).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x=x, ids=ids, w=w, table=table, perm=perm, inv=inv,
        ids_sorted=ids_sorted, splits=splits).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    pairs = [
        (pseg.segment_sum(t["x"], t["ids"], n), jseg.segment_sum(j["x"], j["ids"], n)),
        (pseg.segment_count(t["ids"], n, t["w"]),
         jseg.segment_count(j["ids"], n, j["w"])),
        *zip(pseg.segment_mean_clamped(t["x"], t["ids"], n, t["w"]),
             jseg.segment_mean_clamped(j["x"], j["ids"], n, j["w"])),
        (pseg.permute_rows(t["x"], t["perm"], t["inv"]),
         jseg.permute_rows(j["x"], j["perm"], j["inv"])),
        *zip(pseg.take_rows_pair(t["table"], t["ids"], t["ids_sorted"], t["perm"],
                                 t["ids_sorted"], None, None, t["ids_sorted"], None),
             (j["table"][j["ids"]], j["table"][j["ids_sorted"]])),
        *[(pseg.sorted_segment_sum_by_plan(
              t["x"], t["perm"], t["inv"], t["ids_sorted"], n, s),
           jseg.sorted_segment_sum_by_plan(
               j["x"], j["perm"], j["inv"], j["ids_sorted"], n))
          for s in (None, t["splits"])],
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
