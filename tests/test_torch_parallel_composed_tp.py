"""The port's 2D composed step (``parallel/composed_tp.py``) on an ("edge",
"model") mesh of gloo ranks ((1, 2) at k = 2, (2, 2) at k = 4): the twin of
``tests/test_composed_tp.py``.

- ``contrib`` ``grouped`` and ``dense``: the 2D step against JAX's 2D step
  on the same mesh shape (JAX's rotations), and against the port's 1D
  composed step on the edge axis: the loss within 1e-5, the gradients and
  the parameters after Adam as ``torch_composed_cases.
  assert_adam_step_close`` holds them (a rank's blocks of the split heads);
- dropout 0.35: the 2D step's coordinated masks (generators seeded by the
  edge index) give the 1D step's loss and parameters;
- the banks' producers (the matrix heads' final Linears) hold 1/k_m of
  their bytes a rank, the placements are the JAX specs', and the step
  refuses what JAX refuses.

One spawn of k ranks per world size (``torch_parallel_ranks_cd.composed_tp``).
"""

import functools

import numpy as np
import pytest

from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_composed_cases import (
    assert_adam_step_close,
    jax_tp_step,
    rank_inputs,
    raw_case,
)
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
K_M, N = 2, 26
CASES = {"grouped": raw_case(5), "dense": raw_case(5),
         "dropout": raw_case(9, dropout=0.35)}


def _block(a, path: str, m: int):
    """Model rank ``m``'s block of a whole leaf (tp_param_specs): the matrix
    heads' layers 0 and 2 split on their output axis, layer 1's weight on
    its input axis."""
    parts = path.split(".")
    if parts[0] != "weight_generators" or parts[2] != "heads" or parts[3] == "bias":
        return a
    axis = {(0, "w"): 1, (0, "b"): 0, (1, "w"): 0, (2, "w"): 1, (2, "b"): 0}.get(
        (int(parts[4]), parts[5]))
    return a if axis is None else np.split(np.asarray(a), K_M, axis=axis)[m]


def _blocks(tree, m: int) -> dict:
    return {path: _block(a, path, m) for path, a in named_leaves(tree)}


def _rank_tree(o: dict, prefix: str, m: int) -> dict:
    """A rank's outputs under ``prefix`` by leaf path, cut to model rank
    ``m``'s blocks."""
    start = prefix + "/"
    return {key[len(start):]: _block(v, key[len(start):], m)
            for key, v in o.items() if key.startswith(start)}


@functools.lru_cache(maxsize=None)
def _jax(k):
    k_e = k // K_M
    return {name: jax_tp_step(CASES[name], N, k_e, K_M, rng_seed=17, contrib=name)
            for name in ("grouped", "dense")}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    want = _jax(k)
    inputs = {}
    for name, case in CASES.items():
        shifts = want[name][2] if name in want else 1 + np.arange(k // K_M)
        inputs.update({f"{name}/{key}": v
                       for key, v in rank_inputs(case, N, shifts=shifts).items()})
    outs = spawn("torch_parallel_ranks_cd:composed_tp", k,
                 tmp_path_factory.mktemp(f"composed_tp_k{k}"), inputs)
    return want, outs


@pytest.mark.parametrize("contrib", ["grouped", "dense"])
def test_2d_matches_jax_2d_and_port_1d(ranks, contrib):
    want, outs = ranks
    loss, params, _, grads = want[contrib]
    for o in outs:
        m = int(o["coordinate"][1])
        np.testing.assert_allclose(float(o[f"{contrib}/2d/loss"]), loss, atol=1e-5)
        np.testing.assert_allclose(float(o[f"{contrib}/1d/loss"]), loss, atol=1e-5)
        assert_adam_step_close(o, f"{contrib}/2d", _blocks(params, m), _blocks(grads, m))
        assert_adam_step_close(o, f"{contrib}/1d", dict(named_leaves(params)),
                               dict(named_leaves(grads)))


def test_2d_dropout_matches_1d(ranks):
    _, outs = ranks
    for o in outs:
        m = int(o["coordinate"][1])
        np.testing.assert_allclose(float(o["dropout/2d/loss"]), float(o["dropout/1d/loss"]),
                                   atol=1e-5)
        params, grads = (_rank_tree(o, f"dropout/1d/{kind}", m) for kind in ("param", "grad"))
        assert_adam_step_close(o, "dropout/2d", params, grads)
    # Dropout is on: not the loss of the same step without it.
    assert all(float(o["dropout/2d/loss"]) != float(o["dense/2d/loss"]) for o in outs)


def test_2d_bank_params_are_model_sharded(ranks):
    _, outs = ranks
    config = CASES["dense"][3]
    whole = config.weight_generator.hidden_dim * config.hidden_dim ** 2 * 4
    for o in outs:
        for n in ("W_msg", "W_self"):
            assert int(o[f"bank_bytes/{n}"]) * K_M == whole
        for path, _ in named_leaves(CASES["dense"][4]):
            split = _block(np.zeros((4, 4)), path, 0).shape != (4, 4)
            assert ("S(" in o[f"placement/{path}"].item()) == split, path


def test_2d_validation(ranks):
    _, outs = ranks
    assert "requires halo mode" in outs[0]["err/no_halo"].item()
    assert "unknown contrib backend" in outs[0]["err/contrib"].item()
