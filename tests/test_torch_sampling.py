"""The port's neighbor sampler against the JAX package's: from the same
``default_rng`` seed, in native mode (both packages' C++ hop) and in numpy
mode (both bridges patched to None), the same subgraph, array for array,
and the generator left in the same state."""

import numpy as np
import pytest

from graph_hypernetwork_forge_tpu import native_bridge as jax_bridge
from graph_hypernetwork_forge_tpu.data.sampling import NeighborSampler as JaxSampler
from graph_hypernetwork_forge_tpu_torch import native_bridge
from graph_hypernetwork_forge_tpu_torch.data.datasets import generate_synthetic_kg
from graph_hypernetwork_forge_tpu_torch.data.sampling import NeighborSampler
from test_torch_encoding import _assert_same_array, _assert_same_graph


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native_bridge, "get_native", lambda: None)
        monkeypatch.setattr(jax_bridge, "get_native", lambda: None)
    elif native_bridge.get_native() is None or jax_bridge.get_native() is None:
        pytest.skip("no C++ toolchain to build the native extension")
    return request.param


def _kg(seed):
    return generate_synthetic_kg(120, 1500, 7, feat_dim=8, seed=seed)


@pytest.mark.parametrize("case", [
    (0, [0, 1, 2, 3], (4, 4)),
    (1, [5, 5, 17, 90, 3], (3, 2, 2)),
    (2, [11], (2,)),
])
def test_sample_matches_jax_from_the_same_generator(mode, case):
    seed, seeds, fanouts = case
    kg = _kg(seed)
    got_rng, want_rng = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    sampler = NeighborSampler(kg.edge_index, kg.edge_texts, kg.num_nodes)
    got = sampler.sample(seeds, fanouts, kg.node_features, rng=got_rng)
    ref = JaxSampler(kg.edge_index, kg.edge_texts, kg.num_nodes)
    want = ref.sample(seeds, fanouts, kg.node_features, rng=want_rng)
    _assert_same_array(sampler._csr_ptr, ref._csr_ptr, "csr ptr")
    _assert_same_array(sampler._csr_eid, ref._csr_eid, "csr eid")
    for name in ("node_ids", "seed_local_ids", "node_features"):
        _assert_same_array(getattr(got, name), getattr(want, name), name)
    _assert_same_graph(got.graph, want.graph)
    # The same number of draws, in the same order: the generators agree after.
    assert got_rng.integers(0, 2**62) == want_rng.integers(0, 2**62)


def test_native_and_numpy_modes_draw_different_valid_samples(monkeypatch):
    if native_bridge.get_native() is None:
        pytest.skip("no C++ toolchain to build the native extension")
    kg = generate_synthetic_kg(60, 2000, 5, feat_dim=4, seed=3)
    native = NeighborSampler(kg.edge_index, kg.edge_texts, kg.num_nodes).sample(
        [1, 2], (3,), kg.node_features, rng=np.random.default_rng(0))
    monkeypatch.setattr(native_bridge, "get_native", lambda: None)
    plain = NeighborSampler(kg.edge_index, kg.edge_texts, kg.num_nodes).sample(
        [1, 2], (3,), kg.node_features, rng=np.random.default_rng(0))
    for batch in (native, plain):
        assert batch.graph.num_edges == 6  # both seeds have > 3 in-edges
    assert not np.array_equal(native.node_ids, plain.node_ids)


def test_sample_contains_the_seeds_and_bounds_the_fanout(mode):
    kg = generate_synthetic_kg(50, 300, 5, seed=2)
    sampler = NeighborSampler(kg.edge_index, kg.edge_texts, kg.num_nodes)
    batch = sampler.sample([0, 1, 2, 3], fanouts=[4, 4], node_features=kg.node_features,
                           rng=np.random.default_rng(0))
    np.testing.assert_array_equal(batch.node_ids[batch.seed_local_ids], [0, 1, 2, 3])
    assert batch.node_features.shape[0] == len(batch.node_ids)
    e = batch.graph.num_edges
    assert batch.graph.src[:e].max(initial=0) < len(batch.node_ids)
    # Each sampled edge is a real edge of the graph, under its own text.
    g_src, g_dst = batch.node_ids[batch.graph.src[:e]], batch.node_ids[batch.graph.dst[:e]]
    edges = {(int(s), int(d), t) for s, d, t in zip(*kg.edge_index, kg.edge_texts)}
    texts = [batch.graph.unique_texts[r] for r in batch.graph.rel_ids[:e]]
    assert all((int(s), int(d), t) in edges for s, d, t in zip(g_src, g_dst, texts))
    # A seed keeps min(fanout, in-degree) of its in-edges.
    for v in (0, 1, 2, 3):
        deg = int((kg.edge_index[1] == v).sum())
        assert int((g_dst == v).sum()) == min(4, deg)

    one = sampler.sample([5], fanouts=[2], node_features=kg.node_features,
                         rng=np.random.default_rng(1))
    assert one.graph.num_edges <= 2
