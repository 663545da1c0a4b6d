"""The training slice: the port's losses, gradients, Adam and train steps
against the JAX package's, on the same numpy inputs and weights.

The port's ``cuda`` backend runs the kernels' plain versions here on the
CPU; the JAX side runs its Pallas backends in interpret mode, as its own
tests do off the TPU. Gradients are compared per parameter leaf at f32
atol 3e-5 after dividing by ``max(1, max|ref|)`` (a gradient sums many
per-edge terms; tests/test_pallas_kernels.py:447-451 gates the same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.training import objectives as jobj
from graph_hypernetwork_forge_tpu.training.train import make_train_step as jax_train_step
from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.models import weight_generator as pwg
from graph_hypernetwork_forge_tpu_torch.training import objectives as pobj
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_multi_step,
    make_train_step,
    train,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    named_leaves,
    tree_leaves,
    tree_map,
)
from torch_cases import ATOL, assert_scaled_close

N, F, U, E = 48, 16, 5, 300
LAYOUT = dict(sort_by_relation=True, with_sort_plan=True, group_pad=256)


def _graph(seed=0):
    """Random graph whose last 4 nodes have no in-edges; group-padded, the
    bank's relations 5-7 have no rows."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, E), rng.integers(1, N - 4, E)])
    texts = [f"relation type {i} of the graph" for i in range(U)]
    etexts = [texts[i] for i in rng.integers(0, U, E)]
    feats = rng.standard_normal((N, F)).astype(np.float32)
    return feats, jax_encode(ei, etexts, N, **LAYOUT), encode_graph(ei, etexts, N, **LAYOUT)


def _configs(d, backend, **kw):
    common = dict(text_dim=32, node_feat_dim=F, hidden_dim=d, num_layers=2,
                  rel_sorted=True, group_padded=True, **kw)
    return (jhg.HyperGNNConfig(**common, backend=backend),
            phg.HyperGNNConfig(**common, backend="cuda"))


def _jax_params(cfg, seed=0):
    params = jhg.init_hypergnn(cfg, jax.random.PRNGKey(seed))
    # Generated weights at scale 1 instead of the 0.01 init, so message
    # passing carries real gradient to every generator leaf.
    for g in params["weight_generators"]:
        g["log_scales"] = {k: jnp.zeros((1,)) for k in g["log_scales"]}
    return jax.tree_util.tree_map(np.asarray, params)


def _port_inputs(feats, pg):
    return (torch.from_numpy(feats), *(torch.from_numpy(a) for a in pg.arrays))


def _jax_inputs(feats, jg):
    return (jnp.asarray(feats), *(jnp.asarray(a) for a in jg.arrays))


def _leaf_params(np_params):
    return tree_map(lambda t: t.requires_grad_(True), params_from_jax(np_params))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_losses_and_their_gradients_match_jax():
    rng = np.random.default_rng(1)
    n, b, k, d = 14, 9, 6, 8
    embs = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = rng.integers(0, n, b), rng.integers(0, n, b)
    neg, negk = rng.integers(0, n, b), rng.integers(0, n, (b, k))
    mask = (rng.random(b) < 0.7).astype(np.float32)
    cases = [
        ("link_prediction_loss", pobj.link_prediction_loss, jobj.link_prediction_loss,
         (src, dst, neg), dict(edge_mask=mask)),
        ("margin 0.5, no mask", pobj.link_prediction_loss, jobj.link_prediction_loss,
         (src, dst, neg), dict(margin=0.5)),
        ("multi_negative_loss", pobj.multi_negative_loss, jobj.multi_negative_loss,
         (src, dst, negk), dict(edge_mask=mask)),
        ("adversarial T=2", pobj.multi_negative_loss, jobj.multi_negative_loss,
         (src, dst, negk), dict(adversarial_temperature=2.0)),
    ]
    for name, pfn, jfn, idx, kw in cases:
        te = torch.from_numpy(embs).requires_grad_(True)
        pkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = pfn(te, *(torch.from_numpy(i) for i in idx), **pkw)
        got.backward()
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want, jgrad = jax.value_and_grad(
            lambda x: jfn(x, *(jnp.asarray(i) for i in idx), **jkw)
        )(jnp.asarray(embs))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=name)
        assert_scaled_close(te.grad.numpy(), jgrad, err_msg=name)
    ranks = [
        (pobj.margin_ranking_loss(torch.tensor([1.0, 0.2]), torch.tensor([0.5, 0.9])),
         jobj.margin_ranking_loss(jnp.array([1.0, 0.2]), jnp.array([0.5, 0.9])))
    ]
    for got, want in ranks:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _sorted_loss_case(seed=0, n=60, e=500, d=16):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"rel {i}" for i in range(7)]
    etexts = [texts[i] for i in rng.integers(0, 7, e)]
    jg = jax_encode(ei, etexts, n, sort_by_relation=True, with_sort_plan=True)
    pg = encode_graph(ei, etexts, n, sort_by_relation=True, with_sort_plan=True)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    return jg, pg, embs


def _plain_sorted_loss(x, src, dst, shift, mask, margin=1.0):
    """The same loss by PyTorch's own autograd: gathers and torch.roll."""
    pos_h, pos_t = x[src.long()], x[dst.long()]
    neg_t = torch.roll(pos_t, -shift, 0)
    per_edge = (margin - (pos_h * pos_t).sum(-1) + (pos_h * neg_t).sum(-1)).clamp(min=0)
    m = torch.ones_like(per_edge) if mask is None else mask
    return (per_edge * m).sum() / m.sum().clamp(min=1.0)


@pytest.mark.parametrize("with_mask", [True, False])
def test_sorted_loss_analytic_backward_matches_jax_and_plain_autograd(with_mask):
    jg, pg, embs = _sorted_loss_case()
    e = pg.src.shape[0]
    plan = pg.sort_plan.to("cpu")
    jplan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan)
    src, dst = torch.from_numpy(pg.src), torch.from_numpy(pg.dst)
    mask = torch.from_numpy(pg.edge_mask) if with_mask else None
    jmask = jnp.asarray(jg.edge_mask) if with_mask else None
    # Shift 0 and shifts past E wrap around, as in tests/test_train.py.
    for shift in (137, 0, 1, e - 1, e + 5):
        x = torch.from_numpy(embs).requires_grad_(True)
        got = pobj.link_prediction_loss_sorted(x, src, dst, plan, shift, edge_mask=mask)
        got.backward()
        y = torch.from_numpy(embs).requires_grad_(True)
        plain = _plain_sorted_loss(y, src, dst, shift, mask)
        plain.backward()
        want, jgrad = jax.value_and_grad(
            lambda v: jobj.link_prediction_loss_sorted(
                v, jnp.asarray(jg.src), jnp.asarray(jg.dst), jplan,
                jnp.int32(shift), edge_mask=jmask,
            )
        )(jnp.asarray(embs))
        msg = f"shift={shift}"
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, err_msg=msg)
        np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-6, err_msg=msg)
        assert_scaled_close(x.grad.numpy(), jgrad, err_msg=msg)
        assert_scaled_close(x.grad.numpy(), y.grad.numpy(), err_msg=msg)


def test_sorted_loss_passes_gradcheck_and_gives_the_mask_a_zero_cotangent():
    _, pg, embs = _sorted_loss_case(seed=2, n=12, e=40, d=3)
    plan = pg.sort_plan.to("cpu")
    src, dst = torch.from_numpy(pg.src), torch.from_numpy(pg.dst)
    mask = torch.from_numpy(pg.edge_mask).double()
    x = torch.from_numpy(embs.astype(np.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: pobj.link_prediction_loss_sorted(v, src, dst, plan, 7, edge_mask=mask),
        (x,), eps=1e-6, atol=1e-8,
    )
    m = mask.clone().requires_grad_(True)
    pobj.link_prediction_loss_sorted(x, src, dst, plan, 7, edge_mask=m).backward()
    # Reference behaviour (JAX objectives.py:183), kept and flagged.
    assert m.grad is not None and not m.grad.any()


# ---------------------------------------------------------------------------
# Whole-model gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "d,jax_backend,negatives",
    [(128, "pallas", "roll"), (64, "pallas", "roll"), (64, "pallas_packed", "roll"),
     (64, "pallas_packed", "uniform")],
)
def test_model_gradients_per_leaf_match_jax(d, jax_backend, negatives):
    feats, jg, pg = _graph()
    jcfg, pcfg = _configs(d, jax_backend)
    np_params = _jax_params(jcfg)
    jplan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan)
    plan = pg.sort_plan.to("cpu")
    neg = np.random.default_rng(3).integers(0, N, pg.src.shape[0]).astype(np.int32)
    shift = 211

    def jloss(params):
        embs = jhg.apply_hypergnn(jcfg, params, *_jax_inputs(feats, jg), sort_plan=jplan)
        src, dst, mask = (jnp.asarray(a) for a in (jg.src, jg.dst, jg.edge_mask))
        if negatives == "roll":
            return jobj.link_prediction_loss_sorted(
                embs, src, dst, jplan, jnp.int32(shift), edge_mask=mask)
        return jobj.link_prediction_loss(embs, src, dst, jnp.asarray(neg), edge_mask=mask)

    # Jitted: the interpreted Pallas kernels run an order of magnitude
    # faster compiled than op by op.
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, np_params)
    )
    params = _leaf_params(np_params)
    inputs = _port_inputs(feats, pg)
    embs = phg.apply_hypergnn(pcfg, params, *inputs, sort_plan=plan)
    src, dst, mask = inputs[1], inputs[2], inputs[4]
    if negatives == "roll":
        got = pobj.link_prediction_loss_sorted(embs, src, dst, plan, shift, edge_mask=mask)
    else:
        got = pobj.link_prediction_loss(embs, src, dst, torch.from_numpy(neg),
                                        edge_mask=mask)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_leaves = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    got_leaves = dict(named_leaves(params))
    assert set(got_leaves) == set(want_leaves)
    for path, leaf in got_leaves.items():
        assert_scaled_close(leaf.grad.numpy(), want_leaves[path], err_msg=path)


# ---------------------------------------------------------------------------
# The optimizer and the train steps
# ---------------------------------------------------------------------------


def test_adam_on_identical_gradients_matches_optax():
    # Same parameters, same gradient sequence: only the update rule differs
    # between the packages, so they agree to f32 rounding (~1e-7 relative).
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** i, params)
        for i in range(-3, 2)]
    opt = optax.adam(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    state = create_train_state(
        tree_map(torch.from_numpy, params), adam(1e-3)
    )
    for g in grads:
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for leaf, gl in zip(tree_leaves(state.params), tree_leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        state.opt_state.step()
    for got, want in zip(tree_leaves(state.params), tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)


def test_train_steps_match_jax_with_the_same_roll_shifts():
    feats, jg, pg = _graph(1)
    jcfg, pcfg = _configs(64, "pallas")
    np_params = _jax_params(jcfg)
    jplan = jax.tree_util.tree_map(jnp.asarray, jg.sort_plan)
    lr, steps = 1e-3, 3
    opt = optax.adam(lr)
    jstep = jax_train_step(jcfg, opt, neg_mode="roll")
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = opt.init(jp)
    state = create_train_state(params_from_jax(np_params), adam(lr))
    pstep = make_train_step(pcfg, neg_mode="roll")
    params, opt_state = state.params, state.opt_state
    gen = torch.Generator().manual_seed(0)
    e = pg.src.shape[0]
    for i in range(steps):
        rng = jax.random.PRNGKey(10 + i)
        # The shift JAX's step draws from its key (train.py:152,163).
        shift = int(jax.random.randint(jax.random.split(rng, 3)[0], (), 1, e))
        jp, jstate, jl = jstep(jp, jstate, *_jax_inputs(feats, jg), rng, sort_plan=jplan)
        params, opt_state, pl = pstep(
            params, opt_state, *_port_inputs(feats, pg), gen, neg_dst=shift,
            sort_plan=pg.sort_plan.to("cpu"),
        )
        # The parameters agree to ~1e-7 after each update, but at scale-1
        # generated weights the loss falls from ~8.7 to ~2 over these steps
        # and scales that difference by its large gradient: 1e-5 relative
        # was measured at the third step, so the gate is 1e-4 (a wrong
        # gradient or update moves the loss by percents).
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4, err_msg=f"step {i}")
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for path, leaf in named_leaves(params):
        diff = np.abs(leaf.detach().numpy() - want[path])
        # Adam's first steps move a parameter by about lr·sign(g): where
        # |g| sits at rounding noise the sign can differ between the two
        # packages, a difference of up to 2·lr per step. Every other
        # element agrees to 1e-5 (lr times the ~1e-2 relative agreement
        # of Adam's m/sqrt(v) for gradients known to 3e-5).
        assert diff.max() <= 2 * lr * steps, path
        assert np.quantile(diff, 0.999) <= 1e-5, path


def test_multi_step_equals_single_steps():
    feats, _, pg = _graph(2)
    _, pcfg = _configs(16, "pallas")
    init = phg.init_hypergnn(pcfg, torch.Generator().manual_seed(5))
    inputs = _port_inputs(feats, pg)
    plan = pg.sort_plan.to("cpu")
    runs = []
    for multi in (False, True):
        state = create_train_state(tree_map(torch.clone, init), adam(1e-2))
        gen = torch.Generator().manual_seed(7)
        if multi:
            fn = make_multi_step(pcfg, 3, neg_mode="roll")
            params, _, losses = fn(state.params, state.opt_state, *inputs, gen,
                                   sort_plan=plan)
        else:
            step = make_train_step(pcfg, neg_mode="roll")
            params, opt_state, losses = state.params, state.opt_state, []
            for _ in range(3):
                params, opt_state, loss = step(params, opt_state, *inputs, gen,
                                               sort_plan=plan)
                losses.append(loss)
            losses = torch.stack(losses)
        runs.append((losses, params))
    (l1, p1), (l2, p2) = runs
    assert l2.shape == (3,) and torch.isfinite(l2).all()
    torch.testing.assert_close(l1, l2, rtol=0, atol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_train_loop_lowers_the_loss_on_the_cpu():
    feats, _, pg = _graph(3)
    _, pcfg = _configs(16, "pallas")
    init = phg.init_hypergnn(pcfg, torch.Generator().manual_seed(0))
    params, losses = train(pcfg, init, feats, pg, num_steps=12,
                                  learning_rate=1e-2, device="cpu")
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(params))


# ---------------------------------------------------------------------------
# Dropout and remat
# ---------------------------------------------------------------------------


def test_remat_gradients_equal_plain_gradients_with_dropout_on():
    feats, _, pg = _graph(4)
    grads = []
    for remat in (False, True):
        _, pcfg = _configs(16, "pallas", dropout=0.3, remat=remat)
        params = tree_map(lambda t: t.requires_grad_(True),
                          phg.init_hypergnn(pcfg, torch.Generator().manual_seed(1)))
        gen = torch.Generator().manual_seed(2)
        embs = phg.apply_hypergnn(pcfg, params, *_port_inputs(feats, pg), train=True,
                                  gen=gen, sort_plan=pg.sort_plan.to("cpu"))
        (embs * torch.arange(16.0)).square().mean().backward()
        grads.append({p: leaf.grad for p, leaf in named_leaves(params)})
    for path, g in grads[0].items():
        torch.testing.assert_close(grads[1][path], g, rtol=0, atol=1e-6, msg=path)


def test_dropout_keep_rate_scaling_and_eval_identity():
    p = 0.25
    cfg = pwg.WeightGeneratorConfig(text_dim=8, d_in=4, d_out=4, hidden_dim=64,
                                    dropout=p)
    params = pwg.init_weight_generator(cfg, torch.Generator().manual_seed(0))
    masks = pwg.draw_dropout_masks(cfg, 4000, torch.Generator().manual_seed(1))
    rate = torch.cat([m.flatten() for ms in masks.values() for m in ms]).float().mean()
    assert abs(float(rate) - (1 - p)) < 0.005
    emb = torch.randn(4000, 8, generator=torch.Generator().manual_seed(2))
    got = pwg.apply_weight_generator(cfg, params, emb, train=True, keep=masks)
    for name, shape in cfg.weight_specs:
        x = emb
        for layer, keep in zip(params["heads"][name][:-1], masks[name]):
            x = torch.relu(x @ layer["w"] + layer["b"])
            x = x * keep / (1 - p)  # kept entries scaled by 1/(1-p)
        last = params["heads"][name][-1]
        want = (x @ last["w"] + last["b"]).reshape((4000,) + shape) * 0.01
        torch.testing.assert_close(got[name], want, rtol=1e-5, atol=1e-7)
    evals = [pwg.apply_weight_generator(cfg, params, emb, train=t, gen=g)
             for t, g in ((False, None), (False, torch.Generator()))]
    plain = pwg.apply_weight_generator(
        pwg.WeightGeneratorConfig(text_dim=8, d_in=4, d_out=4, hidden_dim=64),
        params, emb)
    for out in evals:
        for name in plain:
            torch.testing.assert_close(out[name], plain[name], rtol=0, atol=0)


def test_hypergnn_train_and_eval_modes():
    kg_feats, _, pg = _graph(5)
    ei = np.stack([pg.src[pg.edge_mask > 0], pg.dst[pg.edge_mask > 0]])
    texts = [pg.unique_texts[r] for r in pg.rel_ids[pg.edge_mask > 0]]
    model = phg.HyperGNN(32, F, 16, dropout=0.5, seed=0, device="cpu")
    assert model.training
    a, b = (model(kg_feats, ei, texts) for _ in range(2))
    assert a.requires_grad and not torch.equal(a, b)  # fresh masks per call
    a.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    model.eval()
    c, d = (model(kg_feats, ei, texts) for _ in range(2))
    assert not c.requires_grad and torch.equal(c, d)
    nodrop = phg.HyperGNN(32, F, 16, dropout=0.0, seed=0, device="cpu").eval()
    torch.testing.assert_close(c, nodrop(kg_feats, ei, texts), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_value_error_guards():
    _, pcfg = _configs(16, "pallas")
    bad = [
        dict(neg_mode="random"),
        dict(neg_mode="roll", num_pos_samples=8),
        dict(num_negatives=0),
        dict(num_negatives=4, neg_mode="roll"),
        dict(adversarial_temperature=1.0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            make_train_step(pcfg, **kw)
        with pytest.raises(ValueError):
            jax_train_step(jhg.HyperGNNConfig(32, F, 16), optax.adam(1e-3), **kw)
    for kw in bad[:2]:
        with pytest.raises(ValueError):
            make_multi_step(pcfg, 2, **kw)
    feats, _, pg = _graph()
    state = create_train_state(
        phg.init_hypergnn(pcfg, torch.Generator().manual_seed(0)), adam(1e-3))
    with pytest.raises(ValueError, match="sort_plan"):
        make_train_step(pcfg, neg_mode="roll")(
            state.params, state.opt_state, *_port_inputs(feats, pg), torch.Generator())
    _, dcfg = _configs(16, "pallas", dropout=0.1)
    with pytest.raises(ValueError, match="Generator"):
        phg.apply_hypergnn(dcfg, state.params, *_port_inputs(feats, pg), train=True,
                           sort_plan=pg.sort_plan.to("cpu"))
