"""The ``dense``, ``grouped`` and ``chunked`` message-passing backends and
the two-stream tail, against the JAX package's ``relational_message_passing``
with the same backend, on the same numpy inputs.

Layouts: the stored edge order (bucket-padded, masked pad edges), the
relation-sorted order, and the sorted order with its SortPlan; every case
also masks some real edges. Values at f32 atol 3e-5; gradients of
``Σ out · R`` (R fixed) at atol 3e-5 after dividing by ``max(1, max|ref|)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.ops import message_passing as jmp
from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops import message_passing as pmp
from torch_cases import ATOL, assert_scaled_close

N, U, E, D_IN, D_OUT = 48, 5, 300, 12, 16

LAYOUTS = {
    "stored-order": dict(sort_by_relation=False),
    "sorted": dict(sort_by_relation=True),
    "sorted+plan": dict(sort_by_relation=True, with_sort_plan=True),
}


def _case(layout, seed=0):
    """A graph whose nodes N-4.. have no in-edges, encoded by both packages,
    a mask that also drops ~10% of the real edges, and d_in != d_out banks."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, E), rng.integers(1, N - 4, E)])
    texts = [f"relation type {i} of the graph" for i in range(U)]
    etexts = [texts[i] for i in rng.integers(0, U, E)]
    jg, pg = (enc(ei, etexts, N, **layout) for enc in (jax_encode, encode_graph))
    u_pad = pg.char_ids.shape[0]
    mask = pg.edge_mask * (rng.random(pg.edge_mask.shape[0]) >= 0.1)
    arrays = dict(
        h=rng.standard_normal((N, D_IN)).astype(np.float32),
        w_msg=(rng.standard_normal((u_pad, D_IN, D_OUT)) / 3).astype(np.float32),
        w_self=(rng.standard_normal((u_pad, D_IN, D_OUT)) / 3).astype(np.float32),
        bias=rng.standard_normal((u_pad, D_OUT)).astype(np.float32),
    )
    r = rng.standard_normal((N, D_OUT)).astype(np.float32)
    return jg, pg, arrays, mask.astype(np.float32), r


def _run_jax(jg, arrays, mask, r, backend, rel_sorted):
    plan = (None if jg.sort_plan is None
            else jax.tree_util.tree_map(jnp.asarray, jg.sort_plan))

    def f(h, w_msg, w_self, bias):
        out = jmp.relational_message_passing(
            h, *(jnp.asarray(a) for a in jg.arrays[:3]), w_msg, w_self, bias,
            num_nodes=N, edge_mask=jnp.asarray(mask), backend=backend,
            rel_sorted=rel_sorted, sort_plan=plan,
        )
        return jnp.sum(out * jnp.asarray(r)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(arrays[k]) for k in ("h", "w_msg", "w_self", "bias"))
    )
    return out, grads


def _run_port(pg, arrays, mask, r, backend, rel_sorted):
    leaves = [torch.from_numpy(arrays[k]).requires_grad_(True)
              for k in ("h", "w_msg", "w_self", "bias")]
    out = pmp.relational_message_passing(
        leaves[0], *(torch.from_numpy(a) for a in pg.arrays[:3]), *leaves[1:],
        num_nodes=N, edge_mask=torch.from_numpy(mask), backend=backend,
        rel_sorted=rel_sorted,
        sort_plan=None if pg.sort_plan is None else pg.sort_plan.to("cpu"),
    )
    (out * torch.from_numpy(r)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


_CASES = [
    (backend, layout, tail)
    for backend in ("dense", "grouped", "chunked")
    for layout in LAYOUTS
    # chunked has its own accumulators and no two-stream tail
    for tail in (("fused",) if backend == "chunked" else ("fused", "two-scatter"))
]


@pytest.mark.parametrize("backend,layout,tail", _CASES)
def test_backend_matches_jax_values_and_gradients(backend, layout, tail, monkeypatch):
    if tail == "two-scatter":
        # Every [E, d] stream is over the budget: two [E, d] reductions.
        monkeypatch.setattr(jmp, "_FUSED_TAIL_BUDGET_ELEMENTS", 0)
        monkeypatch.setattr(pmp, "_FUSED_TAIL_BUDGET_ELEMENTS", 0)
    jg, pg, arrays, mask, r = _case(LAYOUTS[layout])
    rel_sorted = LAYOUTS[layout]["sort_by_relation"]
    want, jgrads = _run_jax(jg, arrays, mask, r, backend, rel_sorted)
    got, pgrads = _run_port(pg, arrays, mask, r, backend, rel_sorted)
    assert got.shape == (N, D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # Isolated nodes get exactly 0 before the residual.
    assert not got[N - 4:].any()
    for name, g, w in zip(("h", "w_msg", "w_self", "bias"), pgrads, jgrads):
        assert tuple(g.shape) == w.shape, name
        assert_scaled_close(g.numpy(), w, err_msg=name)


def test_backends_run_no_kernel_off_the_plan_and_agree_with_gather():
    kernels.reset_launch_counts()
    _, pg, arrays, mask, r = _case(LAYOUTS["stored-order"], seed=3)
    ref, ref_grads = _run_port(pg, arrays, mask, r, "gather", False)
    for backend in ("dense", "grouped", "chunked"):
        got, grads = _run_port(pg, arrays, mask, r, backend, False)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL,
                                   err_msg=backend)
        for g, w in zip(grads, ref_grads):
            assert_scaled_close(g.numpy(), w.numpy(), err_msg=backend)
    assert kernels.csr_segment_sum.launches == 0


def test_ragged_and_chunked_functions_pass_gradcheck(monkeypatch):
    rng = np.random.default_rng(4)
    n, e, u, d_in, d_out = 9, 40, 4, 3, 2
    src, dst = (torch.from_numpy(rng.integers(0, n, e).astype(np.int32)) for _ in range(2))
    rel = torch.from_numpy(np.sort(rng.integers(0, u - 1, e)).astype(np.int32))
    mask = torch.from_numpy((rng.random(e) < 0.8).astype(np.float64))
    leaves = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
              for s in ((n, d_in), (u, d_in, d_out), (u, d_in, d_out), (u, d_out))]
    sizes = torch.bincount(rel, minlength=u).tolist()  # relation 3 is empty
    assert torch.autograd.gradcheck(
        lambda x, w: pmp._RaggedTransform.apply(x, w, sizes),
        (leaves[0][src.long()].detach().requires_grad_(True), leaves[1]),
        eps=1e-6, atol=1e-8,
    )
    # Three chunks of 16 edges, the last one ragged.
    assert torch.autograd.gradcheck(
        lambda h, wm, ws, b: pmp._MpChunked.apply(h, wm, ws, b, src, dst, rel, mask, n, 16),
        tuple(leaves), eps=1e-6, atol=1e-8,
    )


def _configs(layout_name, backend):
    common = dict(text_dim=32, node_feat_dim=16, hidden_dim=16, num_layers=2,
                  backend=backend, rel_sorted=LAYOUTS[layout_name]["sort_by_relation"])
    return jhg.HyperGNNConfig(**common), phg.HyperGNNConfig(**common)


@pytest.mark.parametrize("layout,picked", [
    ("stored-order", "dense"), ("sorted", "grouped"), ("sorted+plan", "grouped"),
])
def test_hypergnn_auto_matches_jax_per_layer(layout, picked):
    # The JAX HyperGNN wrapper encodes in the stored order, where auto picks
    # dense at this size; on the sorted layouts it picks grouped.
    jcfg, pcfg = _configs(layout, "auto")
    jg, pg, _, _, _ = _case(LAYOUTS[layout], seed=5)
    feats = np.random.default_rng(6).standard_normal((N, 16)).astype(np.float32)
    params = jhg.init_hypergnn(jcfg, jax.random.PRNGKey(0))
    for g in params["weight_generators"]:  # weights at scale 1, not 0.01
        g["log_scales"] = {k: jnp.zeros((1,)) for k in g["log_scales"]}
    params = jax.tree_util.tree_map(np.asarray, params)
    assert pmp.resolve_backend(
        "auto", N, pg.char_ids.shape[0], pg.src.shape[0], 16,
        rel_sorted=pcfg.rel_sorted, group_padded=False,
        has_sort_plan=pg.sort_plan is not None,
    ) == picked
    want = jhg.apply_hypergnn(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(feats),
        *(jnp.asarray(a) for a in jg.arrays), return_all_layers=True,
        sort_plan=(None if jg.sort_plan is None
                   else jax.tree_util.tree_map(jnp.asarray, jg.sort_plan)),
    )
    got = phg.apply_hypergnn(
        pcfg, params_from_jax(params), torch.from_numpy(feats),
        *(torch.from_numpy(a) for a in pg.arrays), return_all_layers=True,
        sort_plan=None if pg.sort_plan is None else pg.sort_plan.to("cpu"),
    )
    for layer, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=f"layer {layer}")


# (N, U, E, d_out, rel_sorted): every branch of the JAX pick.
_SIZES = [
    (1_000, 50, 10_000, 64, False),     # bench config: dense
    (1_000, 50, 10_000, 64, True),      # sorted: grouped
    (50_000, 237, 1_000_000, 64, False),  # xl: U·N > 8E, grouped
    (50_000, 240, 1_031_680, 128, True),  # xl-d128, sorted: grouped
    (40_000, 64, 4_200_000, 64, False),  # E·d over the grouped budget: dense
    (2_000_000, 500, 5_000_000, 64, True),  # and over the dense one: chunked
    (200_000, 100, 1_000_000, 64, False),  # U·N·d over the dense budget
]


@pytest.mark.parametrize("n,u,e,d,rel_sorted", _SIZES)
def test_auto_off_the_kernel_layout_picks_as_jax(n, u, e, d, rel_sorted):
    for plan in (False, True):
        got = pmp.resolve_backend(
            "auto", n, u, e, d, rel_sorted=rel_sorted, group_padded=False,
            has_sort_plan=plan,
        )
        assert got == jmp._pick_backend("auto", n, u, e, d, rel_sorted=rel_sorted)
    for backend in ("dense", "grouped", "chunked", "gather"):
        assert pmp.resolve_backend(
            backend, n, u, e, d, rel_sorted=rel_sorted, group_padded=True,
            has_sort_plan=True,
        ) == backend
