"""The port's composed training across real processes, with a host drop
recovered from a checkpoint: the twin of ``tests/test_multiprocess.py``'s
composed and host-drop tests (``multiprocess_composed_worker.py``), on 4
gloo ranks, one process each (``torch_multiprocess_worker.py``).

The case is ``tests_shared_composed_case.build_case``'s (32 nodes, 128
edges, 5 relations, the JAX weights of PRNGKey(3)); step s of every run
takes the per-shard rotations JAX's step s draws from ``fold_in(PRNGKey(7),
s)``. Three gangs: an uninterrupted run of 6 steps; a run whose rank 1
exits with code 7 at the start of step 3, after rank 0 checkpointed step 2
through the port's ``training/checkpoint.py``; and a gang that restores
that checkpoint and runs steps 3-5. The resumed losses and parameters are
bitwise the uninterrupted run's, and both are within JAX's gates (loss
1e-5, parameters 1e-4; test_multiprocess.py:163-164) of JAX's
single-process run of the same trajectory on 4 virtual devices, the
parameters wherever no step's JAX gradient lies in Adam's rounding band
(0 < |g| < 1e-6, ``torch_composed_cases.NOISE_GRAD``). An element that
takes a step there moves by lr·g/(|g| + eps), which follows the rounding
of g and carries into the later steps (one element of 4,096 in
``weight_generators.0.heads.W_msg.1.w``, whose step-4 gradient is
-5.1e-10, ends 1.01e-4 from JAX's); such elements are held within 2·lr a
step.

The ranks meet through a ``file://`` path in the test's directory (no
port, so parallel test workers cannot clash); the collectives time out
after 20 s, and the parent kills the processes it started, and only
those, at its deadline.
"""

import functools
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from graph_hypernetwork_forge_tpu.parallel.composed import (
    make_composed_train_step,
    prepare_composed_inputs,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.training.checkpoint import latest_checkpoint
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from tests_shared_composed_case import build_case
from torch_composed_cases import NOISE_GRAD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")
WORLD = 4
STEPS = 6
LR = 1e-2
DEADLINE_S = 90


def _raw_case():
    """``build_case``'s raw draws: edges, relation indices, features."""
    rng = np.random.default_rng(17)
    n, e, u, f = 32, 128, 5, 8
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ridx = rng.integers(0, u, e)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    return n, ei, ridx, feats


BASE_KEY = 7


@functools.lru_cache(maxsize=None)
def _case():
    """``build_case``'s config, graph, features and weights, the composed
    layout, and the per-shard rotations JAX's step s draws from
    ``fold_in(PRNGKey(7), s)`` (``make_composed_train_step``'s draw)."""
    graph, feats, config, params = build_case()
    inputs = prepare_composed_inputs(graph, feats, WORLD, halo=True)
    cap = inputs.src.shape[0] // WORLD
    shifts = []
    for s in range(STEPS):
        neg_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), s))[0]
        shifts.append([int(jax.random.randint(jax.random.fold_in(neg_rng, j), (), 1,
                                              max(cap, 2))) for j in range(WORLD)])
    return config, params, inputs, np.array(shifts)


@functools.lru_cache(maxsize=None)
def _oracle():
    """JAX's single-process run on 4 virtual devices (test_multiprocess.py's
    ``_composed_oracle``): the losses, the parameters, and which elements
    took a step in Adam's rounding band."""
    config, params, inputs, _ = _case()
    mesh = make_mesh((WORLD,), ("edge",), devices=jax.devices()[:WORLD])
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = make_composed_train_step(mesh, config, optimizer, inputs.nodes_per_shard,
                                    num_nodes=inputs.num_nodes, halo_width=inputs.halo_width)
    arrays = tuple(jnp.asarray(a) for a in (
        inputs.feats, inputs.src, inputs.dst, inputs.rel_ids, inputs.edge_mask,
        inputs.char_ids, inputs.lengths))
    losses = []
    # Whether any step's gradient lies in Adam's rounding band, from the
    # first moments: g_t = (mu_t - b1 · mu_{t-1}) / (1 - b1).
    mu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, opt_state[0].mu)))
    noisy = {path: np.zeros(m.shape, bool) for path, m in mu.items()}
    for s in range(STEPS):
        sr = jax.random.fold_in(jax.random.PRNGKey(BASE_KEY), s)
        params, opt_state, loss = step(params, opt_state, *arrays, sr,
                                       src_halo=jnp.asarray(inputs.src_halo),
                                       send_idx=jnp.asarray(inputs.send_idx))
        losses.append(float(loss))
        new_mu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, opt_state[0].mu)))
        for path, m in new_mu.items():
            g = np.abs((m - 0.9 * mu[path]) / 0.1)
            noisy[path] |= (g > 0) & (g < NOISE_GRAD)
        mu = new_mu
    return (np.array(losses), dict(named_leaves(jax.tree_util.tree_map(np.asarray, params))),
            noisy)


def _assert_params_within_jax_gate(out, want_params, noisy):
    for path, want in want_params.items():
        got = out[f"param/{path}"]
        np.testing.assert_allclose(np.where(noisy[path], want, got), want, rtol=0, atol=1e-4,
                                   err_msg=path)
        assert np.abs(got - want).max() <= 2 * LR * STEPS, path


def _start(workdir, mode):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(workdir), str(WORLD), str(r), mode],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(WORLD)]


def _wait(procs):
    """Wait for the gang up to the deadline, kill what is left of it; the
    exit codes and outputs by rank."""
    deadline = time.monotonic() + DEADLINE_S
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()  # a process this test started
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    config, params, _, shifts = _case()
    init = jax.tree_util.tree_map(np.asarray, params)
    n, ei, ridx, feats = _raw_case()
    workdir = tmp_path_factory.mktemp("host_drop")
    np.savez(workdir / "inputs.npz", ei=ei, ridx=ridx, feats=feats, n=np.int64(n),
             dims=np.array([config.text_dim, config.node_feat_dim, config.hidden_dim,
                            config.num_layers]),
             lr=np.float32(LR), shifts=shifts,
             **{f"params/{p}": a for p, a in named_leaves(init)})
    res = {}
    for mode in ("train", "crash", "resume"):
        procs = _start(workdir, mode)
        if mode == "train":
            _oracle()  # while the gang runs
        codes, outs = _wait(procs)
        if mode != "crash":
            for r, code in enumerate(codes):
                assert code == 0, f"rank {r} ({mode}) failed:\n{outs[r][-3000:]}"
        res[mode] = (codes, outs)
    return workdir, res


def _out(workdir, rank, mode):
    with np.load(workdir / f"out_{rank}_{mode}.npz") as f:
        return dict(f)


def test_uninterrupted_run_matches_jax(runs):
    workdir, _ = runs
    want_losses, want_params, noisy = _oracle()
    first = _out(workdir, 0, "train")
    for r in range(WORLD):
        o = _out(workdir, r, "train")
        np.testing.assert_array_equal(o["losses"], first["losses"])
    np.testing.assert_allclose(first["losses"], want_losses, rtol=0, atol=1e-5)
    _assert_params_within_jax_gate(first, want_params, noisy)


def test_host_drop_leaves_a_checkpoint(runs):
    workdir, res = runs
    codes, outs = res["crash"]
    assert codes[1] == 7, f"injected crash missing:\n{outs[1][-1000:]}"
    assert all(code != 0 for code in codes), codes  # no rank finished the run
    assert not any((workdir / f"out_{r}_crash.npz").exists() for r in range(WORLD))
    assert latest_checkpoint(str(workdir / "ckpt")) == str(workdir / "ckpt" / "step_3")


def test_resume_is_bitwise_the_uninterrupted_run(runs):
    workdir, _ = runs
    whole = _out(workdir, 0, "train")
    for r in range(WORLD):
        o = _out(workdir, r, "resume")
        np.testing.assert_array_equal(o["losses"], whole["losses"][3:])
        for key in whole:
            if key.startswith("param/"):
                np.testing.assert_array_equal(o[key], whole[key], err_msg=key)


def test_resumed_run_within_jax_gates(runs):
    workdir, _ = runs
    want_losses, want_params, noisy = _oracle()
    o = _out(workdir, 0, "resume")
    np.testing.assert_allclose(o["losses"], want_losses[3:], rtol=0, atol=1e-5)
    _assert_params_within_jax_gate(o, want_params, noisy)
