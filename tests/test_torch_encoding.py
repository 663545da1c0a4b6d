"""The port's host encoding against the JAX package's, array for array.

Every ``EncodedGraph`` and ``SortPlan`` array must be equal exactly (values
and dtype), and the seed-42 ToyKnowledgeGraph features bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.data import encoding as jenc
from graph_hypernetwork_forge_tpu.data.knowledge_graph import (
    ToyKnowledgeGraph as JaxToyKG,
)
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig as JaxConfig
from graph_hypernetwork_forge_tpu.utils.text import tokenize_texts as jax_tokenize
from graph_hypernetwork_forge_tpu_torch.data import encoding as penc
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.utils.text import tokenize_texts

_PLAN_FIELDS = [f.name for f in dataclasses.fields(jenc.SortPlan)]
_ARRAY_FIELDS = ("src", "dst", "rel_ids", "edge_mask", "char_ids", "text_lengths")
_SCALAR_FIELDS = (
    "num_nodes", "num_edges", "num_relations", "unique_texts", "rel_sorted",
    "group_pad",
)


def _assert_same_array(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{name}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{name} differs"


def _assert_same_graph(got, want):
    for name in _ARRAY_FIELDS:
        _assert_same_array(getattr(got, name), getattr(want, name), name)
    for name in _SCALAR_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert (got.sort_plan is None) == (want.sort_plan is None)
    if want.sort_plan is not None:
        for name in _PLAN_FIELDS:
            _assert_same_array(
                getattr(got.sort_plan, name), getattr(want.sort_plan, name),
                f"sort_plan.{name}",
            )


def _random_graph(seed, n=60, e=700, u=9):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)] + ["", "naïve ünïcode"]
    etexts = [texts[i] for i in rng.integers(0, len(texts), e)]
    return ei, etexts, n


_LAYOUTS = [
    dict(),
    dict(pad=False),
    dict(sort_by_relation=True),
    dict(sort_by_relation=True, with_sort_plan=True),
    dict(with_sort_plan=True),
    dict(sort_by_relation=True, with_sort_plan=True, group_pad=256),
    dict(sort_by_relation=True, with_sort_plan=True, group_pad=64, pad=False),
]


def test_toy_kg_features_bitwise_equal():
    got, want = ToyKnowledgeGraph(feat_dim=16), JaxToyKG(feat_dim=16)
    assert got.node_features.dtype == want.node_features.dtype == np.float32
    assert got.node_features.tobytes() == want.node_features.tobytes()
    _assert_same_array(got.edge_index, want.edge_index, "edge_index")
    assert got.edge_texts == want.edge_texts
    assert got.relation_types == want.relation_types
    assert repr(got) == repr(want)


@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda d: str(sorted(d.items())))
def test_toy_kg_encoding_matches(layout):
    kg = ToyKnowledgeGraph()
    got = penc.encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, **layout)
    want = jenc.encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, **layout)
    _assert_same_graph(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda d: str(sorted(d.items())))
def test_random_graph_encoding_matches(layout, seed):
    ei, etexts, n = _random_graph(seed)
    got = penc.encode_graph(ei, etexts, n, **layout)
    want = jenc.encode_graph(ei, etexts, n, **layout)
    _assert_same_graph(got, want)


@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda d: str(sorted(d.items())))
def test_empty_graph_encoding_matches(layout):
    ei = np.zeros((2, 0), dtype=np.int64)
    got = penc.encode_graph(ei, [], 5, **layout)
    want = jenc.encode_graph(ei, [], 5, **layout)
    _assert_same_graph(got, want)


def test_group_pad_tiles_hold_one_relation_and_splits_align():
    ei, etexts, n = _random_graph(3, e=900)
    g = penc.encode_graph(
        ei, etexts, n, sort_by_relation=True, with_sort_plan=True, group_pad=256
    )
    tiles = g.rel_ids.reshape(-1, 256)
    assert (tiles == tiles[:, :1]).all()
    assert not (g.sort_plan.rel_splits % 256).any()
    assert g.edge_mask.sum() == 900


def test_tokenizer_matches():
    texts = ["knows", "", "a" * 13, "ünïcode ☃", "x"]
    got, want = tokenize_texts(texts), jax_tokenize(texts)
    for a, b, name in zip(got, want, ("char_ids", "lengths")):
        _assert_same_array(a, b, name)


def test_sort_plan_to_device_keeps_values_and_dtypes():
    ei, etexts, n = _random_graph(4)
    plan = penc.encode_graph(ei, etexts, n, with_sort_plan=True).sort_plan
    moved = plan.to("cpu")
    for name in _PLAN_FIELDS:
        t = getattr(moved, name)
        assert isinstance(t, torch.Tensor)
        _assert_same_array(t.numpy(), getattr(plan, name), name)


@pytest.mark.parametrize(
    "layout,cfg",
    [
        (dict(), dict(rel_sorted=True)),
        (dict(sort_by_relation=True), dict(rel_sorted=True, group_padded=True)),
        (dict(sort_by_relation=True), dict(rel_sorted=True, backend="pallas")),
    ],
)
def test_validate_graph_refuses_like_jax(layout, cfg):
    kg = ToyKnowledgeGraph()
    jg = jenc.encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, **layout)
    pg = penc.encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, **layout)
    with pytest.raises(ValueError):
        jenc.validate_graph_for_config(jg, JaxConfig(16, 16, 16, **cfg))
    with pytest.raises(ValueError):
        penc.validate_graph_for_config(pg, HyperGNNConfig(16, 16, 16, **cfg))


def test_encode_graph_rejects_bad_input_like_jax():
    for mod in (penc, jenc):
        with pytest.raises(ValueError):
            mod.encode_graph(np.zeros((3, 2)), ["a", "b"], 4)
        with pytest.raises(ValueError):
            mod.encode_graph(np.zeros((2, 2), dtype=np.int64), ["a"], 4)
        with pytest.raises(ValueError):
            mod.encode_graph(np.zeros((2, 1), dtype=np.int64), ["a"], 4, group_pad=256)
