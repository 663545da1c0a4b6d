"""The port's meshes, DTensor placements and relation sharding on k gloo
ranks, against the JAX package's on k virtual CPU devices.

One spawn of k ranks per world size runs every case of this file
(``torch_parallel_ranks.sharding``). At k = 4 the mesh is ``(2, 2)`` over
("edge", "model"); at k = 2 it is ``(2,)`` and "model" is absent, so what
JAX shards on it is replicated. Placements and each rank's local shards
must equal JAX's shardings and the shard on the device at the same mesh
coordinate exactly; relation-sharded banks agree with JAX's to 1e-6
(test_parallel_advanced.py:58) and bit for bit with the same rank's
generation of every row at once; their parameters' gradients agree with
JAX's to 3e-5 after dividing by max(1, max|JAX|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from graph_hypernetwork_forge_tpu.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu.models.text_encoder import (
    TextEncoderConfig,
    init_text_encoder,
    tokenize_texts,
)
from graph_hypernetwork_forge_tpu.models.weight_generator import (
    WeightGeneratorConfig,
    init_weight_generator,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu.parallel.relation_sharding import relation_sharded_generate
from graph_hypernetwork_forge_tpu.parallel.sharding import (
    hypergnn_param_shardings,
    shard_graph_arrays,
    shard_params,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
from torch_cases import assert_scaled_close
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16, num_layers=2)
WG_CONFIG = WeightGeneratorConfig(text_dim=16, d_in=8, d_out=8, hidden_dim=32)


@functools.lru_cache(maxsize=1)
def _cases():
    params = jax.tree_util.tree_map(np.asarray, init_hypergnn(CONFIG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    n, e, u = 24, 64, 5
    edge_index = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    texts = [f"rel {i}" for i in range(u)]
    graph = encode_graph(edge_index, [texts[i] for i in rng.integers(0, u, e)], n)
    te = jax.tree_util.tree_map(np.asarray, init_text_encoder(
        TextEncoderConfig(text_dim=16, char_emb_dim=8), jax.random.PRNGKey(0)))
    wg = jax.tree_util.tree_map(np.asarray, init_weight_generator(
        WG_CONFIG, jax.random.PRNGKey(1)))
    chars, lens = tokenize_texts([f"relation number {i}" for i in range(16)])
    r = {name: rng.standard_normal((16,) + shape).astype(np.float32)
         for name, shape in WG_CONFIG.weight_specs}
    return params, graph.arrays, te, wg, chars, lens, r


def _inputs():
    params, arrays, te, wg, chars, lens, r = _cases()
    out = {f"params/{p}": v for p, v in named_leaves(params)}
    out.update({f"graph/{i}": a for i, a in enumerate(arrays)})
    out.update({f"te/{p}": v for p, v in named_leaves(te)})
    out.update({f"wg/{p}": v for p, v in named_leaves(wg)})
    out.update({"rel/chars": chars, "rel/lens": lens})
    out.update({f"rel/r_{name}": v for name, v in r.items()})
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    return k, spawn("sharding", k, tmp_path_factory.mktemp(f"sharding_k{k}"), _inputs())


def _jax_mesh(k):
    if k == 4:
        return make_mesh((2, 2), ("edge", "model"), devices=jax.devices()[:4])
    return make_mesh((2,), ("edge", "model"), devices=jax.devices()[:2])


def _placements(mesh, spec) -> str:
    """A JAX PartitionSpec as the port's placement tuple prints."""
    axes = tuple(spec)
    return ",".join(str(Shard(axes.index(name))) if name in axes else str(Replicate())
                    for name in mesh.axis_names)


def _shard_on(arr, mesh, coordinate) -> np.ndarray:
    device = mesh.devices[tuple(coordinate)]
    (shard,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def test_meshes(ranks):
    k, outs = ranks
    for o in outs:
        assert o["default_mesh"].tolist() == ["edge", str(k)]
        assert o["mesh_names"].tolist() == list(_jax_mesh(k).axis_names)
        assert o["axis_sizes"].tolist() == ([2, 2, 1] if k == 4 else [2, 1, 1])
    jmesh = _jax_mesh(k)
    coords = sorted(tuple(o["coordinate"].tolist()) for o in outs)
    assert coords == sorted(np.ndindex(jmesh.devices.shape))


def test_param_placements_and_local_shards_match_jax(ranks):
    k, outs = ranks
    params = _cases()[0]
    jmesh = _jax_mesh(k)
    specs = dict(named_leaves(hypergnn_param_shardings(CONFIG, jmesh)))
    sharded = dict(named_leaves(shard_params(params, CONFIG, jmesh)))
    assert {p for p in outs[0] if p.startswith("param/")} == {f"param/{p}" for p in sharded}
    for o in outs:
        for path, arr in sharded.items():
            assert str(o[f"placement/{path}"]) == _placements(jmesh, specs[path].spec), path
            np.testing.assert_array_equal(
                o[f"param/{path}"], _shard_on(arr, jmesh, o["coordinate"]), err_msg=path)
    # The last generator layer is split over "model" where the mesh has it.
    w = "weight_generators.0.heads.W_msg.2.w"
    assert outs[0][f"param/{w}"].shape[1] == 256 // (2 if k == 4 else 1)


def test_graph_arrays_and_replicate_match_jax(ranks):
    k, outs = ranks
    arrays = _cases()[1]
    jmesh = _jax_mesh(k)
    sharded = shard_graph_arrays(arrays, jmesh)
    for o in outs:
        for i, arr in enumerate(sharded):
            assert str(o[f"graph_placement/{i}"]) == _placements(jmesh, arr.sharding.spec)
            np.testing.assert_array_equal(
                o[f"graph/{i}"], _shard_on(arr, jmesh, o["coordinate"]), err_msg=str(i))
        np.testing.assert_array_equal(o["replicated/a"], arrays[4])
        assert str(o["replicated_placement/a"]) == _placements(jmesh, ())


def test_relation_sharded_banks_match_jax_and_single_rank(ranks):
    k, outs = ranks
    _, _, te, wg, chars, lens, r = _cases()
    mesh = make_mesh((k,), ("model",), devices=jax.devices()[:k])
    args = (jax.tree_util.tree_map(jnp.asarray, te), jax.tree_util.tree_map(jnp.asarray, wg))

    def run(te, wg):
        def loss(te, wg):
            banks = relation_sharded_generate(mesh, WG_CONFIG, te, wg, jnp.asarray(chars),
                                              jnp.asarray(lens), axis="model")
            return sum(jnp.sum(banks[n] * jnp.asarray(r[n])) for n in banks), banks
        return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(te, wg)

    (_, want), grads = jax.jit(run)(*args)
    want_grads = dict(named_leaves({"te": grads[0], "wg": grads[1]}))
    for o in outs:
        for name in want:
            np.testing.assert_allclose(o[f"banks/{name}"], np.asarray(want[name]),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
            np.testing.assert_array_equal(o[f"banks/{name}"], o[f"single/{name}"],
                                          err_msg=name)
        for path, g in want_grads.items():
            assert_scaled_close(o[f"grad/{path}"], np.asarray(g), err_msg=path)
