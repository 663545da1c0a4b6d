"""The port's filtered link-prediction evaluator against the JAX package's:
the same embeddings give the same ranks, MRR and Hits@K, exactly.

Random Gaussian embeddings have no near ties, so both packages' f32 score
products order every candidate alike; exact ties are built from
duplicated rows, whose scores are bitwise equal in either package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.training import evaluate as jev
from graph_hypernetwork_forge_tpu_torch.training import evaluate as pev


def _case(seed, n=90, d=12, b=70, e=600, dup=False):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        # Rows 1-9 copy row 0 and rows 11-14 copy row 10: exact ties.
        embs[1:10] = embs[0]
        embs[11:15] = embs[10]
    src, dst = rng.integers(0, n, b), rng.integers(0, n, b)
    known = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    # Half the test pairs are themselves known edges.
    known = np.concatenate([known, np.stack([src[::2], dst[::2]])], axis=1)
    return embs, src, dst, known


def _jax_ranks(embs, src, dst, known, n):
    """The JAX package's per-pair ranks, through its chunk function."""
    src_c, dst_c = src.astype(np.int32), dst.astype(np.int32)
    if known is None:
        rows, cols = np.zeros(1, np.int32), np.full(1, -1, np.int32)
    else:
        ptr, tails = jev._csr_by_src(known, n)
        rows, cols = jev._chunk_filter_pairs(ptr, tails, src_c)
    return np.asarray(jev._chunk_ranks(
        jnp.asarray(embs), jnp.asarray(src_c), jnp.asarray(dst_c),
        jnp.asarray(rows), jnp.asarray(cols), num_nodes=n))


def _port_ranks(embs, src, dst, known, n):
    rows = cols = None
    if known is not None:
        ptr, tails = pev._csr_by_src(known, n)
        r, c = pev._chunk_filter_pairs(ptr, tails, src)
        rows, cols = torch.from_numpy(r), torch.from_numpy(c)
    return pev._chunk_ranks(torch.from_numpy(embs), torch.from_numpy(src),
                            torch.from_numpy(dst), rows, cols, n).numpy()


@pytest.mark.parametrize("dup", [False, True], ids=["gaussian", "exact-ties"])
@pytest.mark.parametrize("filtered", [False, True], ids=["raw", "filtered"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ranks_equal_jax(seed, filtered, dup):
    embs, src, dst, known = _case(seed, dup=dup)
    known = known if filtered else None
    got = _port_ranks(embs, src, dst, known, embs.shape[0])
    want = _jax_ranks(embs, src, dst, known, embs.shape[0])
    np.testing.assert_array_equal(got, want.astype(np.float64))
    if dup:
        assert (got != np.round(got)).any(), "no half ranks: the case has no ties"


@pytest.mark.parametrize("chunk_size", [16, 1024], ids=["chunked", "one-chunk"])
@pytest.mark.parametrize("filtered", [False, True], ids=["raw", "filtered"])
@pytest.mark.parametrize("dup", [False, True], ids=["gaussian", "exact-ties"])
def test_metrics_equal_jax(filtered, chunk_size, dup):
    # B = 70 pairs is not a multiple of a 16-pair chunk.
    embs, src, dst, known = _case(3, dup=dup)
    kw = dict(ks=(1, 3, 10), chunk_size=chunk_size)
    if filtered:
        kw["filter_edges"] = known
    got = pev.evaluate_link_prediction(embs, src, dst, device="cpu", **kw)
    want = jev.evaluate_link_prediction(embs, src, dst, **kw)
    assert got == want


def test_a_known_target_keeps_its_rank_and_filtering_only_lifts_others():
    embs = np.asarray([[1, 0], [0.9, 0], [0.8, 0], [0, 1]], dtype=np.float32)
    src, dst = np.asarray([0, 0]), np.asarray([2, 1])
    # Node 1 is a known tail of node 0, and so is the target 2 itself.
    known = np.asarray([[0, 0], [1, 2]])
    got = pev.evaluate_link_prediction(embs, src, dst, filter_edges=known,
                                       ks=(1,), device="cpu")
    want = jev.evaluate_link_prediction(embs, src, dst, filter_edges=known, ks=(1,))
    assert got == want
    # Pair (0 → 2): node 0 scores higher (rank 2); (0 → 1): node 0 too.
    assert got["mrr"] == 0.5 and got["hits@1"] == 0.0


def test_num_nodes_limits_the_candidates_like_jax():
    embs, src, dst, known = _case(4)
    src, dst = src % 60, dst % 60
    known = known % 60
    got = pev.evaluate_link_prediction(embs, src, dst, filter_edges=known,
                                       num_nodes=60, device="cpu")
    assert got == jev.evaluate_link_prediction(embs, src, dst, filter_edges=known,
                                               num_nodes=60)
    with pytest.raises(ValueError):
        pev.evaluate_link_prediction(embs, src, dst, num_nodes=91, device="cpu")


def test_tensor_embeddings_are_scored_where_they_are():
    embs, src, dst, known = _case(5)
    t = torch.from_numpy(embs).requires_grad_(True)
    got = pev.evaluate_link_prediction(t, src, dst, filter_edges=known)
    assert got == pev.evaluate_link_prediction(embs, src, dst, filter_edges=known,
                                               device="cpu")
