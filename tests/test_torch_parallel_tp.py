"""The port's tensor parallelism (``parallel/tensor_parallel.py``) on k gloo
ranks against the JAX package's on k virtual CPU devices: the twin of
``tests/test_sharding.py::TestTensorParallelGenerator``.

Megatron-split generation: each rank's bank blocks and the whole bias
within 2e-5 of JAX's (test_sharding.py:195), the gradients of a
fixed-cotangent loss w.r.t. every parameter block and the text embeddings
within 3e-5 after dividing by max(1, max|JAX|); the bank bytes and the
final head divide by k. ``tp_message_passing`` within 3e-5
(test_sharding.py:247), its gradients at the gradient gate.

One spawn of k ranks per world size (``torch_parallel_ranks_cd.tp``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graph_hypernetwork_forge_tpu.models.weight_generator import (
    WeightGeneratorConfig,
    apply_weight_generator,
    init_weight_generator,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu.parallel.tensor_parallel import (
    shard_generator_params,
    tp_generate_weights,
    tp_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import assert_scaled_close
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
NAMES = ("W_msg", "W_self", "bias")


def _config(d, text_dim=32, hidden=64):
    return WeightGeneratorConfig(text_dim=text_dim, d_in=d, d_out=d, hidden_dim=hidden,
                                 num_hidden=2)


@functools.lru_cache(maxsize=1)
def _cases():
    """test_sharding.py's shapes: generation at u=16, d=64; message passing
    at u=6, d=32 over n=24 nodes and e=96 edges."""
    rng = np.random.default_rng(0)
    cases = {}
    for name, (u, d) in (("gen", (16, 64)), ("mp", (6, 32))):
        params = jax.tree_util.tree_map(
            np.asarray, init_weight_generator(_config(d), jax.random.PRNGKey(1)))
        cases[name] = dict(
            params=params, dims=np.array([32, d, 64]),
            text=rng.standard_normal((u, 32)).astype(np.float32),
            r_W_msg=rng.standard_normal((u, d, d)).astype(np.float32),
            r_W_self=rng.standard_normal((u, d, d)).astype(np.float32),
            r_bias=rng.standard_normal((u, d)).astype(np.float32),
        )
    n, e = 24, 96
    cases["mp"].update(
        h=rng.standard_normal((n, 32)).astype(np.float32),
        src=rng.integers(0, n, e).astype(np.int32),
        dst=rng.integers(0, n, e).astype(np.int32),
        rel=rng.integers(0, 6, e).astype(np.int32),
        r=rng.standard_normal((n, 32)).astype(np.float32),
    )
    return cases


def _inputs():
    out = {}
    for name, c in _cases().items():
        for key, v in c.items():
            if key == "params":
                out.update({f"{name}/params/{p}": a for p, a in named_leaves(v)})
            else:
                out[f"{name}/{key}"] = v
    return out


def _jax(k):
    """JAX's generation and message passing on k devices, and the gradients
    of ``Σ out · R``, jitted."""
    mesh = make_mesh((k,), ("model",), devices=jax.devices()[:k])
    res = {}
    c = _cases()["gen"]
    cfg = _config(64)

    def gen_loss(p, text):
        out = tp_generate_weights(mesh, cfg, p, text)
        return sum(jnp.sum(out[n] * c[f"r_{n}"]) for n in NAMES), out

    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    (_, res["gen_out"]), res["gen_grads"] = jax.jit(
        jax.value_and_grad(gen_loss, argnums=(0, 1), has_aux=True))(params, c["text"])
    res["gen_single"] = apply_weight_generator(cfg, params, jnp.asarray(c["text"]))
    res["gen_sharded"] = shard_generator_params(params, cfg, mesh)

    m = _cases()["mp"]
    cfg = _config(32)
    w = tp_generate_weights(mesh, cfg, jax.tree_util.tree_map(jnp.asarray, m["params"]),
                            jnp.asarray(m["text"]))

    def mp_loss(h, wm, ws, b):
        out = tp_message_passing(mesh, h, m["src"], m["dst"], m["rel"],
                                 {"W_msg": wm, "W_self": ws, "bias": b}, h.shape[0])
        return jnp.sum(out * m["r"]), out

    (_, res["mp_out"]), res["mp_grads"] = jax.jit(
        jax.value_and_grad(mp_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(m["h"]), w["W_msg"], w["W_self"], w["bias"])
    return res


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    outs = spawn("torch_parallel_ranks_cd:tp", k, tmp_path_factory.mktemp(f"tp_k{k}"),
                 _inputs())
    return k, _jax(k), outs


def _block(a, path: str, r: int, k: int):
    """Rank ``r``'s block of a whole generator leaf under tp_param_specs:
    the matrix heads' layers 0 and 2 split on their output axis, layer 1's
    weight on its input axis; the rest whole."""
    parts = path.split(".")
    if parts[0] != "heads" or parts[1] == "bias":
        return a
    layer, leaf = int(parts[2]), parts[3]
    axis = {(0, "w"): 1, (0, "b"): 0, (1, "w"): 0, (2, "w"): 1, (2, "b"): 0}.get((layer, leaf))
    if axis is None:
        return a
    return np.split(np.asarray(a), k, axis=axis)[r]


def test_generation_matches_jax_and_replicated(ranks):
    k, want, outs = ranks
    for r, o in enumerate(outs):
        for n in NAMES:
            whole = np.asarray(want["gen_out"][n])
            block = whole if n == "bias" else np.split(whole, k, axis=1)[r]
            np.testing.assert_allclose(o[f"gen/out/{n}"], block, atol=2e-5, rtol=1e-5)
            single = np.asarray(want["gen_single"][n])
            single = single if n == "bias" else np.split(single, k, axis=1)[r]
            np.testing.assert_allclose(o[f"gen/out/{n}"], single, atol=2e-5, rtol=1e-5)


def test_generation_gradients_match_jax(ranks):
    k, want, outs = ranks
    dparams, dtext = want["gen_grads"]
    for r, o in enumerate(outs):
        for path, g in named_leaves(jax.tree_util.tree_map(np.asarray, dparams)):
            assert_scaled_close(o[f"gen/grad/{path}"], _block(g, path, r, k), err_msg=path)
        assert_scaled_close(o["gen/dtext"], np.asarray(dtext))


def test_blocks_and_placements_match_jax(ranks):
    k, want, outs = ranks
    for r, o in enumerate(outs):
        for path, leaf in named_leaves(want["gen_sharded"]):
            got = o[f"gen/placement/{path}"].item()
            shard = np.asarray(leaf.addressable_shards[r].data)
            assert ("S(" in got) == (shard.shape != leaf.shape), path
            np.testing.assert_array_equal(_block(np.asarray(leaf), path, r, k), shard,
                                          err_msg=path)
            np.testing.assert_array_equal(o[f"gen/block/{path}"], shard, err_msg=path)


def test_bank_and_param_bytes_divide(ranks):
    k, _, outs = ranks
    u, d = _cases()["gen"]["text"].shape[0], 64
    for o in outs:
        assert int(o["gen/bank_bytes"]) * k == 2 * u * d * d * 4
        assert int(o["gen/w3_bytes"]) * k == 64 * d * d * 4


def test_tp_message_passing_matches_jax(ranks):
    _, want, outs = ranks
    grads = dict(zip(("dh", "dW_msg", "dW_self", "dbias"), want["mp_grads"]))
    k = len(outs)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["mp/out"], np.asarray(want["mp_out"]), atol=3e-5,
                                   rtol=1e-5)
        for name, g in grads.items():
            g = np.asarray(g)
            if name in ("dW_msg", "dW_self"):
                g = np.split(g, k, axis=1)[r]
            assert_scaled_close(o[f"mp/{name}"], g, err_msg=name)


def test_refusals(ranks):
    _, _, outs = ranks
    assert "num_hidden=2" in outs[0]["err/hidden3"].item()
    assert "must divide the model axis" in outs[0]["err/divide"].item()
