"""The port's bf16 speed mode (``HyperGNNConfig(compute_dtype="bfloat16")``)
and ``precision="default"``, against the JAX package's speed mode.

Inputs come from a numpy seed; the JAX side runs its Pallas kernels in
interpret mode, as its own tests do off the TPU, and the port's ``cuda``
backend runs the kernels' plain versions.

Tolerances. A bf16 output is compared at one bf16 ulp of its largest value,
``2^-7 · max|want|``: both sides sum the same exact f32 products in another
order, so an element may round to either neighbour. f32 results of bf16
data (kernel 1's sums, kernel 3's dW) keep the f32 gate after scaling. The
model's per-layer embeddings: 1e-2 after dividing by ``max(1, max|want|)``,
since every contribution row is rounded to bf16 in both packages and a row
whose f32 sums differ in order may round one ulp (2^-8 relative) apart,
which the mean, the residual and LayerNorm carry on to the next layer.
Gradients: cosine > 0.999 against JAX speed mode and > 0.99 against f32
(the gate of the JAX package's ``tests/test_speed_mode.py:136``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    _combined_bwd_fused_impl,
)
from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    edge_transform_sorted_combined as jax_edge_transform,
)
from graph_hypernetwork_forge_tpu.ops.pallas.segment_sum import (
    sorted_segment_sum_packed64,
    sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves, tree_map
from torch_cases import assert_scaled_close, edge_case, segment_case

BF16_ULP = 2.0**-7
MODEL_ATOL = 1e-2
D = 16


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _assert_within_ulp(got: torch.Tensor, want, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_ULP * np.abs(want).max(), (name, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# The kernels' plain bf16 forms against the TPU kernels' bf16 branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("skew", [False, True])
def test_csr_plain_bf16_matches_pallas(d, skew):
    x, ids, splits = segment_case(30 + d, 1024, 64, d, skew)
    jx, tx = _bf16(x)
    if d == 64:
        want = sorted_segment_sum_packed64(
            jx, jnp.asarray(ids), 64, True, "exact", jnp.asarray(splits))
    else:
        want = sorted_segment_sum_pallas(
            jx, jnp.asarray(ids), 64, interpret=True, splits=jnp.asarray(splits))
    got = kernels.csr_segment_sum(tx, torch.from_numpy(splits), 64)
    # f32 sums of the same bf16 rows: the f32 gate.
    assert got.dtype == torch.float32
    assert_scaled_close(got.numpy(), np.asarray(want))
    assert not got[-3:].any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_plain_bf16_matches_pallas(d, tail_cut):
    arrays = edge_case(40 + d, d, tail_cut)
    j, t = zip(*(_bf16(a) if a.dtype == np.float32 else (jnp.asarray(a), torch.from_numpy(a))
                 for a in arrays))
    want = jax_edge_transform(*j, None, 256, True, None)
    got = kernels.edge_transform_sorted_combined(*t, precision="default")
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _assert_within_ulp(got, want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_plain_bf16_matches_pallas(d, tail_cut):
    xs, xd, rel, wm, ws, _ = edge_case(50 + d, d, tail_cut)
    g = np.random.default_rng(d).standard_normal(xs.shape).astype(np.float32)
    (jg, tg), (jxs, txs), (jxd, txd), (jwm, twm), (jws, tws) = (
        _bf16(a) for a in (g, xs, xd, wm, ws))
    want = _combined_bwd_fused_impl(jg, jxs, jxd, jnp.asarray(rel), jwm, jws,
                                    interpret=True, precision=None)
    got = kernels.edge_transform_combined_bwd(
        tg, txs, txd, torch.from_numpy(rel), twm, tws)
    for name, a, w in zip(("dx_src", "dx_dst"), got[:2], want[:2]):
        assert a.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _assert_within_ulp(a, w, name)
    for name, a, w in zip(("dW_msg", "dW_self"), got[2:], want[2:]):
        # f32 sums of exact bf16 products: 1e-5 after scaling.
        assert a.dtype == torch.float32
        w = np.asarray(w)
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a.numpy() / scale, w / scale, rtol=0, atol=1e-5,
                                   err_msg=name)
        assert not a[6:].any(), "relations without rows must be exactly zero"


def test_bf16_autograd_casts_dw_and_dbias_to_their_parameters_dtype():
    # The transform's VJP: dx in g's dtype, dW and dbias summed in f32 and
    # cast to the bank and bias dtypes (JAX _combined_bwd :293-294, :308).
    xs, xd, rel, wm, ws, b = edge_case(60, 16, 0)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (xs, xd, wm, ws, b)]
    out = kernels.edge_transform_sorted_combined(
        leaves[0], leaves[1], torch.from_numpy(rel), *leaves[2:])
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    for t in leaves:
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape


# ---------------------------------------------------------------------------
# The model in speed mode against JAX speed mode
# ---------------------------------------------------------------------------


def _case(seed=0, n=60, e=400, u=6, group_pad=0):
    """The JAX package's tests/test_speed_mode.py case, encoded by both."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, D)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation flavour {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    layout = dict(sort_by_relation=True, with_sort_plan=True, group_pad=group_pad)
    return feats, jax_encode(ei, etexts, n, **layout), encode_graph(ei, etexts, n, **layout)


BACKENDS = [("pallas", 256), ("grouped", 0), ("dense", 0), ("chunked", 0)]


def _configs(backend, group_pad, **kw):
    common = dict(text_dim=32, node_feat_dim=D, hidden_dim=D, num_layers=2,
                  backend=backend, rel_sorted=True, group_padded=group_pad > 0, **kw)
    return jhg.HyperGNNConfig(**common), phg.HyperGNNConfig(**common)


def _jax_params(cfg):
    params = jhg.init_hypergnn(cfg, jax.random.PRNGKey(0))
    # Generated weights at scale 1, so message passing moves every layer.
    for g in params["weight_generators"]:
        g["log_scales"] = {k: jnp.zeros((1,)) for k in g["log_scales"]}
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_run(cfg, np_params, feats, jg, r):
    """Per-layer embeddings and the gradient of Σ out · R, JAX side."""
    arrays = tuple(jnp.asarray(a) for a in jg.arrays)
    plan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan)

    def f(params):
        layers = jhg.apply_hypergnn(cfg, params, jnp.asarray(feats), *arrays,
                                    return_all_layers=True, sort_plan=plan)
        return jnp.sum(layers[-1] * jnp.asarray(r)), layers

    (_, layers), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return [np.asarray(h) for h in layers], {p: t.numpy() for p, t in named_leaves(flat)}


def _port_run(cfg, np_params, feats, pg, r):
    params = tree_map(lambda t: t.requires_grad_(True), params_from_jax(np_params))
    layers = phg.apply_hypergnn(
        cfg, params, torch.from_numpy(feats), *(torch.from_numpy(a) for a in pg.arrays),
        return_all_layers=True, sort_plan=pg.sort_plan.to("cpu"))
    (layers[-1] * torch.from_numpy(r)).sum().backward()
    return ([h.detach().numpy() for h in layers],
            {p: t.grad.numpy() for p, t in named_leaves(params)})


def _cosine(a: dict, b: dict) -> float:
    x = np.concatenate([a[k].ravel() for k in sorted(a)]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in sorted(a)]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-30))


@pytest.fixture(scope="module")
def runs():
    """Per backend: the JAX speed-mode run, the port's speed-mode run and
    the port's f32 run of one model, on one graph."""
    out = {}
    for backend, group_pad in BACKENDS:
        feats, jg, pg = _case(group_pad=group_pad)
        jcfg, pcfg = _configs(backend, group_pad)
        np_params = _jax_params(jcfg)
        r = np.random.default_rng(9).standard_normal((feats.shape[0], D)).astype(np.float32)
        bf16 = dict(compute_dtype="bfloat16")
        out[backend] = dict(
            jax=_jax_run(dataclasses.replace(jcfg, **bf16), np_params, feats, jg, r),
            port=_port_run(dataclasses.replace(pcfg, **bf16), np_params, feats, pg, r),
            port_f32=_port_run(pcfg, np_params, feats, pg, r),
        )
    return out


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_speed_mode_matches_jax_per_layer(runs, backend):
    got, want = runs[backend]["port"][0], runs[backend]["jax"][0]
    f32 = runs[backend]["port_f32"][0]
    for layer, (g, w, f) in enumerate(zip(got, want, f32)):
        assert g.dtype == np.float32, "embeddings come back f32"
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=MODEL_ATOL,
                                   err_msg=f"{backend} layer {layer}")
        # Genuinely bf16 somewhere, as the JAX test asks of every backend
        # but chunked, and within its 5e-2 of the f32 run.
        err = np.abs(g - f).max() / (np.abs(f).max() + 1e-6)
        assert err < 5e-2
        assert err > 1e-7 or backend == "chunked"


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_speed_mode_gradients_match_jax_and_f32(runs, backend):
    got, want, f32 = (runs[backend][k][1] for k in ("port", "jax", "port_f32"))
    assert set(got) == set(want)
    for path, g in got.items():
        assert g.dtype == np.float32 and g.shape == want[path].shape, path
    assert _cosine(got, want) > 0.999, _cosine(got, want)
    assert _cosine(got, f32) > 0.99, _cosine(got, f32)


@pytest.mark.parametrize("backend", ["pallas", "cuda", "grouped", "dense", "chunked"])
def test_precision_default_equals_highest_on_the_cpu(backend):
    # On the CPU the kernels' plain versions are exact f32 at any precision
    # and PyTorch's products stay f32, as JAX's do on its CPU.
    group_pad = 256 if backend in ("pallas", "cuda") else 0
    feats, _, pg = _case(seed=2, group_pad=group_pad)
    jcfg, pcfg = _configs(backend, group_pad)
    params = params_from_jax(_jax_params(jcfg))
    inputs = (torch.from_numpy(feats), *(torch.from_numpy(a) for a in pg.arrays))
    plan = pg.sort_plan.to("cpu")
    outs = [phg.apply_hypergnn(dataclasses.replace(pcfg, precision=p), params, *inputs,
                               sort_plan=plan)
            for p in ("highest", "default", None)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    # And one training step through make_train_step, loss and update.
    steps = []
    for p in ("highest", "default"):
        state = create_train_state(tree_map(torch.clone, params), adam(1e-2))
        _, _, loss = make_train_step(dataclasses.replace(pcfg, precision=p), neg_mode="roll")(
            state.params, state.opt_state, *inputs, torch.Generator(), neg_dst=5,
            sort_plan=plan)
        steps.append((loss, [t.detach() for _, t in named_leaves(state.params)]))
    assert torch.equal(steps[0][0], steps[1][0])
    assert all(torch.equal(a, b) for a, b in zip(steps[0][1], steps[1][1]))
    with pytest.raises(ValueError, match="precision"):
        phg.apply_hypergnn(dataclasses.replace(pcfg, precision="fast"), params, *inputs,
                           sort_plan=plan)


# ---------------------------------------------------------------------------
# Training in speed mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,group_pad", [
    ("grouped", 0), ("cuda", 256), ("dense", 0), ("chunked", 0), ("gather", 0),
])
def test_bf16_training_reduces_loss_and_keeps_f32_params(backend, group_pad):
    # The twin of the JAX package's test of the same name: 12 Adam steps at
    # lr 1e-2 with rolled negatives in speed mode.
    feats, _, pg = _case(seed=3, group_pad=group_pad)
    _, cfg = _configs(backend, group_pad, compute_dtype="bfloat16")
    init = phg.init_hypergnn(cfg, torch.Generator().manual_seed(0))
    state = create_train_state(init, adam(1e-2))
    step = make_train_step(cfg, neg_mode="roll")
    inputs = (torch.from_numpy(feats), *(torch.from_numpy(a) for a in pg.arrays))
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(12):
        _, _, loss = step(state.params, state.opt_state, *inputs, gen,
                          sort_plan=pg.sort_plan.to("cpu"))
        assert loss.dtype == torch.float32, "no bf16 reaches the loss"
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # Master parameters, their gradients and Adam's moments stay f32.
    for path, t in named_leaves(state.params):
        assert t.dtype == torch.float32 and t.grad.dtype == torch.float32, path
    for moments in state.opt_state.state.values():
        assert all(v.dtype == torch.float32 for v in moments.values()
                   if torch.is_tensor(v) and v.is_floating_point())
