"""The port's composed step (``parallel/composed.py``) against the JAX
package's: the twin of the non-slow tests of ``tests/test_composed.py``.

On the host, ``prepare_composed_inputs``'s arrays equal JAX's exactly for
k = 2 and 4 in the four modes (the dense v1, halo, scheduled halo, and the
shard-local relation sort with and without group padding; the port's run
table of kernel 3 equals the one built from JAX's ``rel_splits``).

On k gloo ranks against JAX on k virtual CPU devices: ``composed_forward``
within 3e-5 (test_composed.py:67); one step of the dense v1
(``uniform_global``, JAX's negatives), of the halo step (``local_roll``,
JAX's per-shard rotations) and of the scheduled halo step, each with the
loss within 1e-5, the gradients at 3e-5 scaled and the parameters after
Adam there too wherever the gradient is above its rounding floor
(``torch_composed_cases.NOISE_GRAD``; within 2·lr below it, where Adam's
first step follows the rounding of g); dropout
drawn per rank (losses that depend on the generator, every rank left with
the same parameters); 12 steps that lower the loss (JAX runs them at k=8);
and the refusals of the step's option checks.

One spawn of k ranks per world size (``torch_parallel_ranks_cd.composed``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_hypernetwork_forge_tpu.parallel.composed import (
    composed_forward,
    prepare_composed_inputs,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.data.encoding import RUN_TILES, split_runs
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph as port_encode
from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
    prepare_composed_inputs as port_prepare,
)
from torch_composed_cases import (
    assert_adam_step_close,
    encoded,
    jax_step,
    rank_inputs,
    raw_case,
)
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
N = 26
MODES = {
    "dense_v1": dict(halo=False),
    "halo": dict(halo=True),
    "scheduled": dict(halo=True, scheduled=True),
    "rel_sort_local": dict(halo=True, rel_sort_local=True),
    "dense_rel_sort": dict(halo=False, rel_sort_local=True),
    "group_pad": dict(halo=True, rel_sort_local=True, group_pad=256),
    "group_pad_scheduled": dict(halo=True, scheduled=True, rel_sort_local=True,
                                group_pad=256),
    "group_pad_dense_v1": dict(halo=False, rel_sort_local=True, group_pad=256),
}
# Name: (graph seed, JAX rng seed, mode) of test_composed.py's cases.
STEPS = {"dense": (4, 11, dict(halo=False)), "halo": (9, 31, dict(halo=True)),
         "scheduled": (17, 33, dict(halo=True, scheduled=True))}


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("mode", list(MODES))
def test_prepare_composed_inputs_equals_jax(mode, k):
    # The group-padded modes on test_composed.py's kernel case.
    n, case = (40, raw_case(21, n=40, e=400, u=5)) if "group" in mode else (N, raw_case(0))
    ei, ridx, feats, *_ = case
    want = prepare_composed_inputs(encoded(case, n), feats, k, **MODES[mode])
    got = port_prepare(port_encode(ei, [f"relation kind {i}" for i in ridx], n), feats, k,
                       **MODES[mode])
    for field in ("feats", "src", "dst", "rel_ids", "edge_mask", "char_ids", "lengths",
                  "src_halo", "send_idx", "rel_group_sizes", "agg_dst_perm", "agg_inv_perm",
                  "agg_dst_sorted", "agg_dst_splits", "agg_in_degree", "kernel_src_perm",
                  "kernel_inv_src_perm", "kernel_src_sorted", "kernel_src_splits",
                  "kernel_dst_splits", "kernel_rel_splits", "kernel_rel_counts"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field
    for field in ("nodes_per_shard", "num_nodes", "halo_width", "sched_round_perms"):
        assert getattr(got, field) == getattr(want, field), field
    if want.sched_send_tables is not None:
        for a, b in zip(got.sched_send_tables, want.sched_send_tables):
            np.testing.assert_array_equal(a, b)
    if want.kernel_plan is not None:
        tiles = -(-want.kernel_rel_splits // 256)
        np.testing.assert_array_equal(got.kernel_tile_splits, tiles)
        np.testing.assert_array_equal(
            got.kernel_run_splits, np.stack([split_runs(t, RUN_TILES) for t in tiles]))
    else:
        assert got.kernel_tile_splits is None


def test_prepare_refuses_what_jax_refuses():
    ei, ridx, feats, *_ = raw_case(0)
    graph = port_encode(ei, [f"relation kind {i}" for i in ridx], N)
    with pytest.raises(ValueError, match="scheduled=True requires halo=True"):
        port_prepare(graph, feats, 2, halo=False, scheduled=True)
    with pytest.raises(ValueError, match="group_pad requires rel_sort_local"):
        port_prepare(graph, feats, 2, group_pad=256)


@functools.lru_cache(maxsize=None)
def _jax(k):
    mesh = make_mesh((k,), ("edge",), devices=jax.devices()[:k])
    case = raw_case(0)
    fwd_inputs = prepare_composed_inputs(encoded(case, N), case[2], k, halo=False)
    params = jax.tree_util.tree_map(jnp.asarray, case[4])
    res = {"fwd": np.asarray(jax.jit(
        lambda p: composed_forward(mesh, case[3], p, fwd_inputs))(params))}
    for name, (seed, rng_seed, mode) in STEPS.items():
        res[name] = jax_step(raw_case(seed), N, k, rng_seed=rng_seed, **mode)
    return res


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    want = _jax(k)
    inputs = {f"fwd/{key}": v for key, v in rank_inputs(raw_case(0), N).items()}
    for name, (seed, _, _) in STEPS.items():
        case = rank_inputs(raw_case(seed), N, **want[name][2])
        inputs.update({f"{name}/{key}": v for key, v in case.items()})
    for name, case in (("dropout", raw_case(6, dropout=0.3)), ("train", raw_case(5))):
        inputs.update({f"{name}/{key}": v for key, v in rank_inputs(case, N).items()})
    outs = spawn("torch_parallel_ranks_cd:composed", k,
                 tmp_path_factory.mktemp(f"composed_k{k}"), inputs)
    return k, want, outs


def test_composed_forward_matches_jax(ranks):
    k, want, outs = ranks
    rows = np.split(want["fwd"], k)
    for o, r in zip(outs, rows):
        np.testing.assert_allclose(o["fwd/rows"], r, atol=3e-5)


@pytest.mark.parametrize("name", list(STEPS))
def test_composed_step_matches_jax(ranks, name):
    _, want, outs = ranks
    loss, params, _, grads = want[name]
    for o in outs:
        np.testing.assert_allclose(float(o[f"{name}/loss"][0]), loss, atol=1e-5)
        assert_adam_step_close(o, name, params, grads)


def test_composed_dropout_is_drawn_and_ranks_agree(ranks):
    _, _, outs = ranks
    la, lb = (float(outs[0][f"dropout/loss{s}"][0]) for s in (1, 2))
    assert np.isfinite(la) and np.isfinite(lb) and la != lb
    paths = [key for key in outs[0] if key.startswith("dropout/param")]
    for o in outs[1:]:
        for key in paths:
            np.testing.assert_array_equal(o[key], outs[0][key], err_msg=key)


def test_composed_training_decreases_loss(ranks):
    _, _, outs = ranks
    losses = outs[0]["train/losses"]
    assert np.isfinite(losses).all() and losses[-1] <= losses[0]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["train/losses"], losses)


def test_composed_step_refuses_what_jax_refuses(ranks):
    _, _, outs = ranks
    errs = {key[4:]: outs[0][key].item() for key in outs[0] if key.startswith("err/")}
    assert "requires halo mode" in errs["local_roll_dense"]
    assert "unknown neg_mode" in errs["unknown_neg"]
    assert "unknown contrib backend" in errs["unknown_contrib"]
    assert "needs agg_sorted=True" in errs["kernel_unsorted"]
    # Stricter than JAX: the kernels' plan indexes dst by local row, which
    # the dense v1's gathered table has only on the first rank.
    assert "needs halo mode" in errs["kernel_dense_v1"]
