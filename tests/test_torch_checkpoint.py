"""The port's checkpointing: interrupted training resumes bitwise where the
uninterrupted run goes (the port's form of tests/test_reliability.py's
restart test), saves are asynchronous yet copy before they return, and only
committed checkpoints are ever seen; a JAX run's parameters and Adam state
resume in the port (``convert.train_state_from_jax``)."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.training.train import make_train_step as jax_step
from graph_hypernetwork_forge_tpu_torch.convert import train_state_from_jax
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu_torch.training import checkpoint as ck
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import ATOL

CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16)


def _setup(seed=9, n=30, e=120):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation {i}" for i in rng.integers(0, 4, e)]
    arrays = tuple(torch.from_numpy(a) for a in encode_graph(ei, texts, n).arrays)
    return feats, arrays


def _fresh():
    return create_train_state(
        init_hypergnn(CONFIG, torch.Generator().manual_seed(1)), adam(1e-3))


def _run(state, feats, arrays, steps):
    step_fn = make_train_step(CONFIG)
    loss = None
    for i in steps:
        # Each step has its own seeded generator, as JAX keys each step.
        _, _, loss = step_fn(state.params, state.opt_state, feats, *arrays,
                             torch.Generator().manual_seed(100 + i))
        state.step = i + 1
    return loss


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _moments(opt):
    return {f"{i}.{k}": v for i, s in enumerate(opt.state.values()) for k, v in s.items()}


def test_interrupted_training_equals_uninterrupted_bitwise(tmp_path):
    feats, arrays = _setup()
    full = _fresh()
    want_loss = _run(full, feats, arrays, range(6))

    part = _fresh()
    _run(part, feats, arrays, range(3))
    path = ck.save_checkpoint(str(tmp_path), part.params, part.opt_state, step=3)
    del part  # the crash

    resumed = _fresh()
    restored = ck.restore_checkpoint(path, resumed.params, resumed.opt_state)
    assert restored["step"] == 3 and restored["params"] is resumed.params
    got_loss = _run(resumed, feats, arrays, range(3, 6))
    assert torch.equal(got_loss, want_loss)
    _assert_bitwise(dict(named_leaves(resumed.params)), dict(named_leaves(full.params)))
    _assert_bitwise(_moments(resumed.opt_state), _moments(full.opt_state))


def test_a_save_copies_before_it_returns(tmp_path, monkeypatch):
    # Hold the writer until an in-place Adam step has changed every
    # parameter: the checkpoint must still hold the values at the save.
    feats, arrays = _setup()
    state = _fresh()
    _run(state, feats, arrays, range(2))
    saved = {k: v.detach().clone() for k, v in named_leaves(state.params)}
    saved_m = {k: v.clone() for k, v in _moments(state.opt_state).items()}
    go = threading.Event()
    commit = ck._commit

    def held_commit(*args):
        assert go.wait(timeout=60)
        commit(*args)

    monkeypatch.setattr(ck, "_commit", held_commit)
    path = ck.save_checkpoint(str(tmp_path), state.params, state.opt_state, step=2)
    _run(state, feats, arrays, range(2, 3))
    assert not any(torch.equal(v, saved[k]) for k, v in named_leaves(state.params)
                   if v.grad is not None and v.grad.abs().max() > 0)
    go.set()
    fresh = _fresh()
    ck.restore_checkpoint(path, fresh.params, fresh.opt_state)
    _assert_bitwise(dict(named_leaves(fresh.params)), saved)
    _assert_bitwise(_moments(fresh.opt_state), saved_m)


def test_latest_checkpoint_ignores_a_leftover_temporary_directory(tmp_path):
    state = _fresh()
    p3 = ck.save_checkpoint(str(tmp_path), state.params, step=3)
    # What a process that died mid-save leaves: a temporary directory of a
    # later step, its file half written.
    tmp = tmp_path / ".step_9.tmp-0123"
    tmp.mkdir()
    (tmp / "checkpoint.pt").write_bytes(b"\x80\x02partial")
    (tmp_path / "step_x").mkdir()
    assert ck.latest_checkpoint(str(tmp_path)) == p3
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None


def test_latest_of_many_and_an_overwrite(tmp_path):
    state = _fresh()
    ck.save_checkpoint(str(tmp_path), state.params, step=1)
    p10 = ck.save_checkpoint(str(tmp_path), state.params, step=10)
    ck.save_checkpoint(str(tmp_path), state.params, step=2)
    assert ck.latest_checkpoint(str(tmp_path)) == p10
    with torch.no_grad():
        for leaf in state.params["input_proj"].values():
            leaf.add_(1.0)
    ck.save_checkpoint(str(tmp_path), state.params, step=10, wait=True)
    fresh = _fresh()
    ck.restore_checkpoint(p10, fresh.params)
    _assert_bitwise(dict(named_leaves(fresh.params)),
                    {k: v.detach() for k, v in named_leaves(state.params)})
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_10", "step_2"]


def test_async_saves_overlap_then_commit(tmp_path):
    w = torch.arange(512 * 512, dtype=torch.float32).reshape(512, 512)
    paths = [ck.save_checkpoint(str(tmp_path), {"w": w * s}, step=s) for s in (1, 2, 3)]
    ck.wait_for_checkpoints()
    assert ck.latest_checkpoint(str(tmp_path)) == paths[-1]
    target = {"w": torch.zeros(512, 512)}
    restored = ck.restore_checkpoint(paths[-1], target)
    assert torch.equal(restored["params"]["w"], w * 3)


def test_restore_refuses_another_tree(tmp_path):
    path = ck.save_checkpoint(str(tmp_path), {"w": torch.ones(3)}, step=0)
    with pytest.raises(ValueError):
        ck.restore_checkpoint(path, {"v": torch.zeros(3)})
    with pytest.raises(ValueError):
        ck.restore_checkpoint(path, {"w": torch.zeros(4)})


def test_a_jax_run_resumes_in_the_port_through_its_adam_state():
    # JAX 3 steps → its parameters and optax.adam state carried across
    # (convert.train_state_from_jax) → 3 port steps equal JAX's steps 4-6,
    # with the same negatives, within the f32 gate.
    rng = np.random.default_rng(3)
    n, e = 30, 160
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation {i}" for i in rng.integers(0, 4, e)]
    jg, pg = jax_encode(ei, texts, n), encode_graph(ei, texts, n)
    negs = [rng.integers(0, n, jg.src.shape[0]).astype(np.int32) for _ in range(6)]
    jcfg = jhg.HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16)
    params = jax.tree_util.tree_map(np.asarray, jhg.init_hypergnn(jcfg, jax.random.PRNGKey(2)))
    for g in params["weight_generators"]:
        g["log_scales"] = {k: np.zeros((1,), np.float32) for k in g["log_scales"]}
    opt = optax.adam(1e-3)
    step = jax_step(jcfg, opt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jo = opt.init(jp)
    inputs = (jnp.asarray(feats), *(jnp.asarray(a) for a in jg.arrays))
    losses, mid = [], None
    for i in range(6):
        if i == 3:
            mid = jax.tree_util.tree_map(np.asarray, (jp, jo))
        jp, jo, loss = step(jp, jo, *inputs, jax.random.PRNGKey(i),
                            neg_dst=jnp.asarray(negs[i]))
        losses.append(float(loss))

    state = train_state_from_jax(*mid, adam(1e-3), device="cpu")
    assert state.step == 3
    pstep = make_train_step(CONFIG)
    pin = (torch.from_numpy(feats), *(torch.from_numpy(a) for a in pg.arrays))
    for i in range(3, 6):
        _, _, loss = pstep(state.params, state.opt_state, *pin, torch.Generator(),
                           neg_dst=torch.from_numpy(negs[i]))
        np.testing.assert_allclose(float(loss), losses[i], rtol=0, atol=ATOL)
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for path, leaf in named_leaves(state.params):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=0, atol=ATOL,
                                   err_msg=path)
    with pytest.raises(ValueError):
        train_state_from_jax(params, (), adam(1e-3), device="cpu")
