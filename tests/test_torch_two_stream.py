"""Kernels 5, 6 and 7 through their plain versions, the two-output edge
transform's autograd Function and its entry point, against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

Values at f32 atol 3e-5 (the parity gate); gradients and the summed
outputs of kernels 6 and 7 at atol 3e-5 after dividing both by
``max(1, max|ref|)``, since each sums many per-edge terms. The kernels
themselves are held against these plain versions on the card by
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    _segment_outer_impl,
    edge_contributions_pallas_sorted,
)
from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    edge_transform_sorted as jax_edge_transform_sorted,
)
from graph_hypernetwork_forge_tpu.ops.pallas.segment_sum import (
    dual_sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_contributions_cuda_sorted,
    edge_transform_sorted,
    edge_transform_sorted_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer import (
    segment_outer,
    segment_outer_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    dual_sorted_segment_sum,
    dual_sorted_segment_sum_plain,
)
from torch_cases import ATOL, assert_scaled_close, edge_case

HIGHEST = jax.lax.Precision.HIGHEST


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (d_in, d_out): square at both model widths' small stand-ins, and layer 0's
# node_feat_dim -> hidden_dim both ways (the backward's transposed call).
_WIDTHS = [(16, 16), (16, 40), (40, 16)]


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_sorted_plain_matches_pallas(d_in, d_out, tail_cut):
    xs, xd, rel, wm, ws, b = edge_case(20, d_in, tail_cut, d_out)
    want = jax_edge_transform_sorted(
        *(jnp.asarray(a) for a in (xs, xd, rel, wm, ws, b)), 256, True
    )
    got = edge_transform_sorted_plain(*_torch(xs, xd, rel, wm, ws, b))
    for name, g, w in zip(("msg", "selfc"), got, want):
        assert tuple(g.shape) == (rel.shape[0], d_out), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
def test_edge_transform_sorted_vjp_matches_jax(d_in, d_out):
    xs, xd, rel, wm, ws, b = edge_case(21, d_in, 0, d_out)
    rng = np.random.default_rng(22)
    g_msg, g_self = rng.standard_normal((2, rel.shape[0], d_out)).astype(np.float32)

    def jfn(*a):
        return jax_edge_transform_sorted(
            a[0], a[1], jnp.asarray(rel), *a[2:], 256, True
        )

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (xs, xd, wm, ws, b)))
    want = vjp((jnp.asarray(g_msg), jnp.asarray(g_self)))
    leaves = [t.requires_grad_(True) for t in _torch(xs, xd, wm, ws, b)]
    msg, selfc = edge_transform_sorted(leaves[0], leaves[1], torch.from_numpy(rel),
                                       *leaves[2:])
    torch.autograd.backward((msg, selfc), _torch(g_msg, g_self))
    for name, t, w in zip(("x_src", "x_dst", "w_msg", "w_self", "bias"), leaves, want):
        assert tuple(t.grad.shape) == w.shape, name
        assert_scaled_close(t.grad.numpy(), w, err_msg=name)


def test_edge_transform_sorted_function_passes_gradcheck():
    rng = np.random.default_rng(23)
    e, d_in, d_out, u = 300, 3, 2, 4  # tiles: [0,256) relation 1, [256,300) 3
    rel = torch.from_numpy(np.repeat(np.array([1, 3], dtype=np.int32), [256, 44]))
    leaves = [
        torch.from_numpy(a).requires_grad_(True)
        for a in (rng.standard_normal((e, d_in)), rng.standard_normal((e, d_in)),
                  rng.standard_normal((u, d_in, d_out)),
                  rng.standard_normal((u, d_in, d_out)),
                  rng.standard_normal((u, d_out)))
    ]

    def fn(*a):
        return edge_transform_sorted(a[0], a[1], rel, *a[2:])

    assert torch.autograd.gradcheck(fn, tuple(leaves), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("gap", [False, True], ids=["tail-empty", "middle-empty"])
@pytest.mark.parametrize("d_in,d_out", [(16, 16), (16, 40)])
def test_segment_outer_plain_matches_pallas(gap, d_in, d_out):
    rng = np.random.default_rng(24)
    if gap:
        # Relation 2 owns no rows; the ragged last tile belongs to 3.
        rel = np.repeat(np.array([0, 1, 3], dtype=np.int32), [256, 512, 200])
        u = 5
    else:
        _, _, rel, *_ = edge_case(25, d_in, 100)
        u = 8  # relations 6 and 7 own no rows
    x = rng.standard_normal((rel.shape[0], d_in)).astype(np.float32)
    g = rng.standard_normal((rel.shape[0], d_out)).astype(np.float32)
    want = _segment_outer_impl(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(rel), u, interpret=True,
        precision=HIGHEST,
    )
    got = segment_outer_plain(*_torch(x, g, rel), u)
    assert tuple(got.shape) == (u, d_in, d_out)
    assert_scaled_close(got.numpy(), want)
    empty = [r for r in range(u) if r not in set(rel.tolist())]
    assert empty and not got[empty].any(), "unvisited relations must be exactly 0"


def _plan_case(seed, plan):
    """tests/test_pallas_kernels.py's make_case: a group-padded sorted graph
    with and without its SortPlan, node table and banks (d = 16)."""
    rng = np.random.default_rng(seed)
    n, e, u, d = 64, 500, 7, 16
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    layout = dict(sort_by_relation=True, with_sort_plan=plan, group_pad=256)
    jg, pg = jax_encode(ei, etexts, n, **layout), encode_graph(ei, etexts, n, **layout)
    u_pad = pg.char_ids.shape[0]
    h = rng.standard_normal((n, d)).astype(np.float32)
    wm, ws = (0.3 * rng.standard_normal((2, u_pad, d, d))).astype(np.float32)
    b = (0.3 * rng.standard_normal((u_pad, d))).astype(np.float32)
    return jg, pg, h, wm, ws, b


@pytest.mark.parametrize("plan", [True, False], ids=["plan", "no-plan"])
def test_edge_contributions_cuda_sorted_matches_pallas(plan):
    jg, pg, h, wm, ws, b = _plan_case(26, plan)
    rng = np.random.default_rng(27)
    g_msg, g_self = rng.standard_normal((2, pg.src.shape[0], h.shape[1])).astype(np.float32)
    jplan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan) if plan else None

    def jfn(h_, wm_, ws_, b_):
        return edge_contributions_pallas_sorted(
            h_, *(jnp.asarray(a) for a in jg.arrays[:3]), wm_, ws_, b_,
            sort_plan=jplan, interpret=True,
        )

    jouts, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (h, wm, ws, b)))
    jgrads = vjp((jnp.asarray(g_msg), jnp.asarray(g_self)))
    leaves = [t.requires_grad_(True) for t in _torch(h, wm, ws, b)]
    outs = edge_contributions_cuda_sorted(
        leaves[0], *_torch(*pg.arrays[:3]), *leaves[1:],
        sort_plan=pg.sort_plan.to("cpu") if plan else None,
    )
    for name, o, w in zip(("msg", "selfc"), outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    torch.autograd.backward(outs, _torch(g_msg, g_self))
    for name, t, w in zip(("h", "w_msg", "w_self", "bias"), leaves, jgrads):
        assert_scaled_close(t.grad.numpy(), w, err_msg=name)


@pytest.mark.parametrize("dh", [64, 128])
def test_dual_plain_matches_pallas(dh):
    # Stream A's ids spread evenly; stream B's segment 3 holds ~30% of the
    # rows (the hot node of the group-padded layout's pad rows).
    rng = np.random.default_rng(28 + dh)
    e, n = 1024, 200
    ids_a = np.sort(rng.integers(0, n - 4, e)).astype(np.int32)
    ids_b = np.sort(np.where(rng.random(e) < 0.3, 3, rng.integers(0, n, e))).astype(np.int32)
    xa, xb = rng.standard_normal((2, e, dh)).astype(np.float32)
    sa, sb = (np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
              for ids in (ids_a, ids_b))
    want = dual_sorted_segment_sum_pallas(
        *(jnp.asarray(a) for a in (xa, xb)), n, jnp.asarray(sa), jnp.asarray(sb),
        interpret=True,
    )
    got = dual_sorted_segment_sum_plain(*_torch(xa, xb), n, *_torch(sa, sb))
    for name, g, w in zip(("sum_a", "sum_b"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (n, dh), name
        assert_scaled_close(g.numpy(), w, err_msg=name)
    assert not got[0][n - 4:].any(), "empty segments must be exactly 0"


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launch_counts()
    xs, xd, rel, wm, ws, b = _torch(*edge_case(29, 16, 100, 24))
    for got, want in zip(edge_transform_sorted(xs, xd, rel, wm, ws, b),
                         edge_transform_sorted_plain(xs, xd, rel, wm, ws, b)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = torch.ones(xs.shape[0], 24)
    torch.testing.assert_close(segment_outer(xs, g, rel, 8),
                               segment_outer_plain(xs, g, rel, 8), rtol=0, atol=0)
    splits = torch.searchsorted(rel, torch.arange(9, dtype=torch.int32), out_int32=True)
    for got, want in zip(dual_sorted_segment_sum(xs, xd, 8, splits, splits),
                         dual_sorted_segment_sum_plain(xs, xd, 8, splits, splits)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.edge_transform_sorted.launches == 0
    assert kernels.segment_outer.launches == 0
    assert kernels.dual_sorted_segment_sum.launches == 0


def test_dual_segment_sum_is_forward_only():
    # No VJP, as in the JAX package: inputs that want a gradient are refused.
    x = torch.zeros(4, 8, requires_grad=True)
    splits = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="differentiable entry points"):
        dual_sorted_segment_sum(x, x.detach(), 2, splits, splits)
    with pytest.raises(ValueError, match="differ in shape"):
        dual_sorted_segment_sum(x.detach(), torch.zeros(4, 4), 2, splits, splits)
    with torch.no_grad():
        a, b = dual_sorted_segment_sum(x, x, 2, splits, splits)
    assert a.shape == b.shape == (2, 8)
