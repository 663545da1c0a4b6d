"""The port's synthetic datasets and triples loader against the JAX
package's: for the same seed, scale and arguments every array, text and
split is identical."""

import os

import numpy as np
import pytest

from graph_hypernetwork_forge_tpu.data import datasets as jds
from graph_hypernetwork_forge_tpu.data import triples as jtr
from graph_hypernetwork_forge_tpu_torch.data import datasets as pds
from graph_hypernetwork_forge_tpu_torch.data import triples as ptr

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_kg")


def _assert_same_kg(got, want):
    assert type(got).__module__.startswith("graph_hypernetwork_forge_tpu_torch")
    for name in ("node_features", "edge_index"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.edge_texts == want.edge_texts
    assert got.relation_texts == want.relation_texts
    assert got.zero_shot_relations == want.zero_shot_relations
    assert got.splits.keys() == want.splits.keys()
    for name in want.splits:
        a, b = got.splits[name], want.splits[name]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in want.splits:
        (ea, ta), (eb, tb) = got.split_edges(name), want.split_edges(name)
        assert np.array_equal(ea, eb) and ta == tb
    assert (got.num_nodes, got.num_edges) == (want.num_nodes, want.num_edges)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("zero_shot_fraction", [0.0, 0.3])
def test_generate_synthetic_kg_matches_jax(seed, zero_shot_fraction):
    args = (300, 2500, 12)
    kw = dict(feat_dim=16, seed=seed, zero_shot_fraction=zero_shot_fraction)
    _assert_same_kg(pds.generate_synthetic_kg(*args, **kw),
                    jds.generate_synthetic_kg(*args, **kw))


@pytest.mark.parametrize("name", ["fb15k237_like", "wn18rr_zero_shot_like"])
def test_published_shapes_at_small_scale_match_jax(name):
    got = getattr(pds, name)(seed=3, scale=0.02)
    want = getattr(jds, name)(seed=3, scale=0.02)
    _assert_same_kg(got, want)
    if name == "wn18rr_zero_shot_like":
        # 27% of 11 relations held out, present only in the test split.
        assert len(got.zero_shot_relations) == 3
        rel = np.asarray([got.relation_texts.index(t) for t in got.edge_texts])
        held = np.isin(rel, got.zero_shot_relations)
        assert not held[got.splits["train"]].any()
        assert held[got.splits["test"]].any()


def test_relation_vocabulary_matches_jax():
    assert pds.make_relation_vocabulary(40, seed=5) == jds.make_relation_vocabulary(40, seed=5)


@pytest.mark.parametrize("seed", [0, 3])
def test_load_triples_dataset_matches_jax(seed):
    got = ptr.load_triples_dataset(FIXTURE, feat_dim=8, seed=seed)
    want = jtr.load_triples_dataset(FIXTURE, feat_dim=8, seed=seed)
    _assert_same_kg(got, want)
    assert {got.relation_texts[r] for r in got.zero_shot_relations} == {"is a colleague of"}


def test_save_load_round_trip_matches_jax(tmp_path):
    kg = pds.generate_synthetic_kg(60, 400, 6, feat_dim=8, seed=2, zero_shot_fraction=0.2)
    ptr.save_triples_dataset(str(tmp_path / "port"), kg)
    jtr.save_triples_dataset(str(tmp_path / "jax"),
                             jds.generate_synthetic_kg(60, 400, 6, feat_dim=8, seed=2,
                                                       zero_shot_fraction=0.2))
    for name in ("train.txt", "valid.txt", "test.txt", "relation_texts.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = ptr.load_triples_dataset(str(tmp_path / "port"), feat_dim=8)
    _assert_same_kg(got, jtr.load_triples_dataset(str(tmp_path / "jax"), feat_dim=8))
    # The round trip keeps every edge and its relation text, split by split.
    for name in ("train", "valid", "test"):
        texts = got.split_edges(name)[1]
        assert texts == kg.split_edges(name)[1]


def test_loader_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(FileNotFoundError):
        ptr.load_triples_dataset(str(tmp_path))
    bad = tmp_path / "train.txt"
    bad.write_text("only_two\tfields\n")
    with pytest.raises(ValueError):
        ptr.read_triples(str(bad))
    kg = pds.generate_synthetic_kg(20, 50, 3, feat_dim=4, seed=0)
    kg.relation_texts[1] = kg.relation_texts[0]
    with pytest.raises(ValueError):
        ptr.save_triples_dataset(str(tmp_path / "dup"), kg)
