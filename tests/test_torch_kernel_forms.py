"""The last forms of the TPU kernels in the port, through their plain
versions, against the JAX package's Pallas kernels run in interpret mode on
the same numpy inputs: kernels 5 and 6 (``edge_transform_sorted`` and its
VJP, ``_segment_outer_impl``) on bf16 data and at ``precision="default"``,
the two-stream entry point in bf16, kernel 7 on bf16 rows, and
``mode="fast"`` of kernels 1, 4 and 7.

Tolerances. A bf16 output (``msg``, ``selfc``, ``dx``) is compared at one
bf16 ulp of its largest value, ``2^-7 · max|want|``: both sides sum the
same exact f32 products in another order, so an element may round to either
neighbour. A weight or bias gradient is summed in f32 on both sides and
rounded once to the parameter's bf16: element by element within one bf16
ulp of JAX's, at least 99% of the elements equal, and no further from a
float64 reference than 1.1 times JAX's. f32 sums (the segment sums, kernel
6's dW before the cast) keep the f32 gate, atol 3e-5 after dividing by
``max(1, max|want|)``. The kernels are held against these plain versions on
the card by test_torch_cuda.py.
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
    sorted_segment_sum_packed64,
    sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer import segment_outer_plain
from torch_cases import assert_scaled_close, edge_case, segment_case

BF16_ULP = 2.0**-7


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _np(a) -> np.ndarray:
    """A torch tensor or a jax array as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32)).astype(np.float64)


def _assert_within_ulp(got, want, name=""):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= BF16_ULP * np.abs(want).max(), (name, err, np.abs(want).max())


def _as_bf16(a) -> np.ndarray:
    """f32 or bf16 values rounded to bf16 (to nearest even), as float64."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.bfloat16).double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)).astype(
        np.float64)


def _assert_rounds_like_jax(got, want, ref: np.ndarray, name=""):
    """``got`` and JAX's ``want``, each rounded to bf16 (the parameters'
    dtype): every element within one bf16 ulp of JAX's, at least 99% of
    them equal, and the error against the float64 ``ref`` at most 1.1 times
    JAX's."""
    got, want = _as_bf16(got), _as_bf16(want)
    _, exp = np.frexp(np.abs(want))  # |want| = m 2^exp, m in [0.5, 1)
    ulp = np.ldexp(1.0, exp - 8)
    assert (np.abs(got - want) <= ulp).all(), (name, np.abs(got - want).max())
    equal = (got == want).mean()
    assert equal >= 0.99, (name, equal)
    err, jax_err = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert err <= 1.1 * jax_err, (name, err, jax_err)


def _dw64(x, g, rel, u) -> np.ndarray:
    """``Σ_{r(e)=u} x[e]ᵀ g[e]`` in float64 from the same (bf16) values."""
    return segment_outer_plain(x.double(), g.double(), torch.from_numpy(rel), u).numpy()


def _dbias64(g, rel, u) -> np.ndarray:
    out = np.zeros((u, g.shape[1]))
    np.add.at(out, rel, g.double().numpy())
    return out


# ---------------------------------------------------------------------------
# Repairs: kernel 6's plain version sums in f32; precision on the two-stream
# entry points
# ---------------------------------------------------------------------------


def test_segment_outer_plain_sums_bf16_in_f32_like_pallas():
    # 3 relations of 16 tiles each, then relations 3 and 4 without rows:
    # the dW of a relation sums 16 tile partials, which the TPU kernel adds
    # in f32 and rounds to the bank's bf16 once.
    rng = np.random.default_rng(70)
    rel = np.repeat(np.array([0, 1, 2], dtype=np.int32), 16 * 256)
    x, g = rng.standard_normal((2, rel.shape[0], 64)).astype(np.float32)
    (jx, tx), (jg, tg) = _bf16(x), _bf16(g)
    want = _segment_outer_impl(jx, jg, jnp.asarray(rel), 5, interpret=True)
    got = segment_outer_plain(tx, tg, torch.from_numpy(rel), 5)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_scaled_close(got.numpy(), np.asarray(want))
    _assert_rounds_like_jax(got, want, _dw64(tx, tg, rel, 5))
    assert not got[3:].any(), "relations without rows must be exactly zero"


def _two_stream_entry(name, precision):
    """``name``'s outputs and gradients on a small f32 case at ``precision``."""
    xs, xd, rel, wm, ws, b = (torch.from_numpy(a) for a in edge_case(71, 16, 100, 24))
    if name == "segment_outer":
        g = torch.from_numpy(
            np.random.default_rng(72).standard_normal((xs.shape[0], 24)).astype(np.float32))
        return [kernels.segment_outer(xs, g, rel, 8, precision=precision)]
    leaves = [t.requires_grad_(True) for t in (xs, xd, wm, ws, b)]
    if name == "edge_transform_sorted":
        outs = kernels.edge_transform_sorted(
            xs, xd, rel, wm, ws, b, precision=precision)
    else:  # the entry point over a node table: rows 0-39 of x_src as h
        h = leaves[0][:40]
        src = torch.arange(rel.shape[0]) % 40
        outs = kernels.edge_contributions_cuda_sorted(
            h, src, src.flip(0), rel, wm, ws, b, precision=precision)
    torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    return [o.detach() for o in outs] + [t.grad for t in leaves if t.grad is not None]


@pytest.mark.parametrize(
    "name", ["edge_transform_sorted", "edge_contributions_cuda_sorted", "segment_outer"])
def test_two_stream_path_takes_precision_exact_on_the_cpu(name):
    # The JAX signatures' precision. On CPU tensors the plain versions stay
    # exact f32 at any precision; an unknown one is refused.
    highest = _two_stream_entry(name, "highest")
    for precision in ("default", None):
        for a, b in zip(_two_stream_entry(name, precision), highest, strict=True):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown precision"):
        _two_stream_entry(name, "medium")


# ---------------------------------------------------------------------------
# Kernel 5 in bf16: forward and VJP
# ---------------------------------------------------------------------------

_WIDTHS = [(16, 16), (16, 40), (40, 16)]


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_sorted_bf16_and_its_vjp_match_pallas(d_in, d_out, tail_cut):
    xs, xd, rel, wm, ws, b = edge_case(73, d_in, tail_cut, d_out)
    g_msg, g_self = np.random.default_rng(74).standard_normal(
        (2, rel.shape[0], d_out)).astype(np.float32)
    j, t = zip(*(_bf16(a) for a in (xs, xd, wm, ws, b, g_msg, g_self)))

    def jfn(*a):
        return jax_edge_transform_sorted(a[0], a[1], jnp.asarray(rel), *a[2:], 256, True)

    want, vjp = jax.vjp(jfn, *j[:5])
    jgrads = vjp(tuple(j[5:]))
    leaves = [a.clone().requires_grad_(True) for a in t[:5]]
    outs = kernels.edge_transform_sorted(
        leaves[0], leaves[1], torch.from_numpy(rel), *leaves[2:])
    for name, o, w in zip(("msg", "selfc"), outs, want):
        assert o.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _assert_within_ulp(o, w, name)
    torch.autograd.backward(outs, list(t[5:]))
    grads = [a.grad for a in leaves]
    assert all(gr.dtype == torch.bfloat16 for gr in grads)
    for name, gr, w in zip(("x_src", "x_dst"), grads[:2], jgrads[:2]):
        _assert_within_ulp(gr, w, name)
    for name, x, gr, w in (("w_msg", t[0], grads[2], jgrads[2]),
                           ("w_self", t[1], grads[3], jgrads[3])):
        cot = t[5] if name == "w_msg" else t[6]
        _assert_rounds_like_jax(gr, w, _dw64(x, cot, rel, 8), name)
    _assert_rounds_like_jax(grads[4], jgrads[4], _dbias64(t[5], rel, 8), "bias")


# ---------------------------------------------------------------------------
# The two-stream entry point in speed mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [True, False], ids=["plan", "no-plan"])
def test_edge_contributions_cuda_sorted_bf16_matches_pallas(plan):
    # Speed mode as the JAX package's: the caller hands in bf16 h, banks
    # and bias. tests/test_torch_two_stream.py's f32 case, in bf16.
    rng = np.random.default_rng(75)
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
    g_msg, g_self = rng.standard_normal((2, pg.src.shape[0], d)).astype(np.float32)
    j, t = zip(*(_bf16(a) for a in (h, wm, ws, b, g_msg, g_self)))
    jplan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan) if plan else None

    def jfn(h_, wm_, ws_, b_):
        return edge_contributions_pallas_sorted(
            h_, *(jnp.asarray(a) for a in jg.arrays[:3]), wm_, ws_, b_,
            sort_plan=jplan, interpret=True,
        )

    jouts, vjp = jax.vjp(jfn, *j[:4])
    jgrads = vjp(tuple(j[4:]))
    leaves = [a.clone().requires_grad_(True) for a in t[:4]]
    src, dst, rel = (torch.from_numpy(a) for a in pg.arrays[:3])
    outs = kernels.edge_contributions_cuda_sorted(
        leaves[0], src, dst, rel, *leaves[1:],
        sort_plan=pg.sort_plan.to("cpu") if plan else None,
    )
    for name, o, w in zip(("msg", "selfc"), outs, jouts):
        assert o.dtype == torch.bfloat16, name
        _assert_within_ulp(o, w, name)
    torch.autograd.backward(outs, list(t[4:]))
    grads = [a.grad for a in leaves]
    # dh sums a node's bf16 dx rows, each within one ulp of JAX's, and
    # rounds once more: the f32 gate after scaling, at bf16's resolution.
    np.testing.assert_allclose(
        _np(grads[0]) / max(1.0, np.abs(_np(jgrads[0])).max()),
        _np(jgrads[0]) / max(1.0, np.abs(_np(jgrads[0])).max()), rtol=0, atol=2 * BF16_ULP)
    x_src, x_dst = t[0][src], t[0][dst]
    rel_np = pg.arrays[2]
    for name, x, cot, gr, w in (("w_msg", x_src, t[4], grads[1], jgrads[1]),
                                ("w_self", x_dst, t[5], grads[2], jgrads[2])):
        _assert_rounds_like_jax(gr, w, _dw64(x, cot, rel_np, u_pad), name)
    _assert_rounds_like_jax(grads[3], jgrads[3], _dbias64(t[4], rel_np, u_pad), "bias")


# ---------------------------------------------------------------------------
# Kernels 1, 4 and 7: mode="fast", and kernel 7 on bf16 rows
# ---------------------------------------------------------------------------


def _two_streams(seed, dh):
    """tests/test_torch_two_stream.py's dual case: stream B's segment 3
    holds ~30% of the rows."""
    rng = np.random.default_rng(seed + dh)
    e, n = 1024, 200
    ids_a = np.sort(rng.integers(0, n - 4, e)).astype(np.int32)
    ids_b = np.sort(np.where(rng.random(e) < 0.3, 3, rng.integers(0, n, e))).astype(np.int32)
    xa, xb = rng.standard_normal((2, e, dh)).astype(np.float32)
    sa, sb = (np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
              for ids in (ids_a, ids_b))
    return n, (xa, ids_a, sa), (xb, ids_b, sb)


@pytest.mark.parametrize("kernel,form,dh", [
    ("K1", "fast", 64), ("K1", "fast", 128), ("K4", "fast", 64),
    ("K7", "fast", 64), ("K7", "fast", 128), ("K7", "bf16", 64), ("K7", "bf16", 128),
])
def test_segment_sum_forms_match_pallas(kernel, form, dh):
    n, (xa, ids_a, sa), (xb, _, sb) = _two_streams(76, dh)
    mode = "fast" if form == "fast" else "exact"
    if form == "bf16":
        (jxa, txa), (jxb, txb) = _bf16(xa), _bf16(xb)
    else:
        jxa, jxb = jnp.asarray(xa), jnp.asarray(xb)
        txa, txb = torch.from_numpy(xa), torch.from_numpy(xb)
    jsa, jsb, tsa, tsb = jnp.asarray(sa), jnp.asarray(sb), torch.from_numpy(sa), torch.from_numpy(sb)
    if kernel == "K7":
        want = dual_sorted_segment_sum_pallas(jxa, jxb, n, jsa, jsb, interpret=True, mode=mode)
        got = kernels.dual_sorted_segment_sum(txa, txb, n, tsa, tsb, mode=mode)
    else:
        if kernel == "K1":
            want = sorted_segment_sum_pallas(
                jxa, jnp.asarray(ids_a), n, interpret=True, mode=mode, splits=jsa)
        else:
            want = sorted_segment_sum_packed64(jxa, jnp.asarray(ids_a), n, True, mode, jsa)
        want, got = [want], [kernels.csr_segment_sum(txa, tsa, n, mode=mode)]
    exact = kernels.dual_sorted_segment_sum(
        torch.from_numpy(xa), torch.from_numpy(xb), n, tsa, tsb)
    for name, a, w, e in zip(("sum_a", "sum_b"), got, want, exact):
        assert a.dtype == torch.float32 and tuple(a.shape) == (n, dh), name
        assert_scaled_close(a.numpy(), np.asarray(w), err_msg=name)
        # The rounding to bf16 shows: these are not the exact f32 sums.
        assert np.abs(a.numpy() - e.numpy()).max() > 1e-3, name
    assert not got[0][n - 4:].any(), "empty segments must be exactly 0"


def test_fast_mode_changes_nothing_on_bf16_rows_and_unknown_modes_are_refused():
    x, _, splits = segment_case(77, 600, 40, 64, True)
    xb, s = torch.from_numpy(x).bfloat16(), torch.from_numpy(splits)
    exact = kernels.csr_segment_sum(xb, s, 40)
    assert torch.equal(kernels.csr_segment_sum(xb, s, 40, mode="fast"), exact)
    for a, b in zip(kernels.dual_sorted_segment_sum(xb, xb, 40, s, s, mode="fast"),
                    (exact, exact)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.csr_segment_sum(xb, s, 40, mode="approx")
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.dual_sorted_segment_sum(xb, xb, 40, s, s, mode="approx")
