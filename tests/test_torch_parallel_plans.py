"""The port's host-side partition and halo plans against the JAX package's:
``partition_edges_by_dst``, ``build_halo_plan``, ``locality_relabel``,
``_schedule_rounds``, ``build_scheduled_halo_plan`` and the volume helpers
must give the same arrays, dtypes and numbers exactly. No process group:
the plans are numpy on the host."""

import numpy as np
import pytest

from graph_hypernetwork_forge_tpu.parallel import halo as jhalo
from graph_hypernetwork_forge_tpu.parallel import node_partition as jnp_part
from graph_hypernetwork_forge_tpu_torch.parallel import halo as phalo
from graph_hypernetwork_forge_tpu_torch.parallel import node_partition as pnp_part


def _random(seed, n=67, e=400, u=5, pad=0, idx_dtype=np.int64):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(idx_dtype)
    dst = rng.integers(0, n, e).astype(idx_dtype)
    rel = rng.integers(0, u, e).astype(np.int32)
    mask = (np.arange(e) < e - pad).astype(np.float32)
    return n, src, dst, rel, mask


def _clustered(seed, clusters=8, size=64, intra=400, inter=8, relabel=False):
    """tests/test_halo.py's ring of clusters, node ids shuffled."""
    rng = np.random.default_rng(seed)
    n = clusters * size
    src, dst = [], []
    for c in range(clusters):
        base, nxt = c * size, ((c + 1) % clusters) * size
        src += [base + rng.integers(0, size, intra), base + rng.integers(0, size, inter)]
        dst += [base + rng.integers(0, size, intra), nxt + rng.integers(0, size, inter)]
    shuffle = rng.permutation(n)
    src, dst = shuffle[np.concatenate(src)], shuffle[np.concatenate(dst)]
    if relabel:
        perm = jhalo.locality_relabel(src, dst, n)
        src, dst = perm[src], perm[dst]
    rel = rng.integers(0, 4, src.size).astype(np.int32)
    return n, src, dst, rel, np.ones(src.size, np.float32)


def _hub(seed):
    """tests/test_halo.py's skewed graph: clusters read from 8 hub nodes."""
    rng = np.random.default_rng(seed)
    n, e = 512, 4000
    c = rng.integers(0, 8, e)
    src = np.where(rng.random(e) < 0.1, rng.integers(0, 8, e), c * 64 + rng.integers(0, 64, e))
    dst = c * 64 + rng.integers(0, 64, e)
    perm = jhalo.locality_relabel(src, dst, n)
    rel = rng.integers(0, 4, e).astype(np.int32)
    return n, perm[src], perm[dst], rel, np.ones(e, np.float32)


def _hot_pair(seed):
    """tests/test_halo.py's one hot pair (rank 0 → rank 1 at k=8) and a ring."""
    rng = np.random.default_rng(seed)
    n, npp = 256, 32
    src = np.concatenate([rng.integers(0, npp, 200), rng.integers(0, n, 160)])
    dst = np.concatenate([npp + rng.integers(0, npp, 200), (src[200:] + npp) % n])
    rel = rng.integers(0, 4, src.size).astype(np.int32)
    return n, src, dst, rel, np.ones(src.size, np.float32)


def _isolated(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 24, 20), rng.integers(0, 4, 20)
    return 24, src, dst, rng.integers(0, 3, 20).astype(np.int32), np.ones(20, np.float32)


GRAPHS = {
    "random": lambda: _random(0),
    "random_int32_padded": lambda: _random(1, n=30, e=120, pad=17, idx_dtype=np.int32),
    "clustered": lambda: _clustered(2),
    "clustered_relabeled": lambda: _clustered(3, relabel=True),
    "hub": lambda: _hub(7),
    "hot_pair": lambda: _hot_pair(7),
    "isolated": lambda: _isolated(1),
}
SHARDS = (1, 2, 4, 8)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_partition_edges_by_dst_matches_jax(graph, k):
    args = GRAPHS[graph]()
    n, rest = args[0], args[1:]
    got = pnp_part.partition_edges_by_dst(*rest, n, k)
    want = jnp_part.partition_edges_by_dst(*rest, n, k)
    for i, (g, w) in enumerate(zip(got[:4], want[:4])):
        _assert_same(g, w, f"array {i}")
    assert got[4] == want[4]


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in plan.__dataclass_fields__.values()}


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_halo_plans_and_volumes_match_jax(graph, k):
    n, src, dst, rel, mask = GRAPHS[graph]()
    got = phalo.build_halo_plan(src, dst, rel, mask, n, k)
    want = jhalo.build_halo_plan(src, dst, rel, mask, n, k)
    assert _plan_fields(got).keys() == _plan_fields(want).keys()
    for name, w in _plan_fields(want).items():
        g = getattr(got, name)
        if isinstance(w, np.ndarray):
            _assert_same(g, w, name)
        else:
            assert g == w, name
    for fn in ("halo_bytes_per_device", "halo_true_bytes_per_device",
               "allgather_bytes_per_device"):
        assert getattr(phalo, fn)(got, 16) == getattr(jhalo, fn)(want, 16), fn
    assert phalo.halo_padding_factor(got) == jhalo.halo_padding_factor(want)

    sgot = phalo.build_scheduled_halo_plan(src, dst, rel, mask, n, k)
    swant = jhalo.build_scheduled_halo_plan(src, dst, rel, mask, n, k)
    for name, w in _plan_fields(swant).items():
        g = getattr(sgot, name)
        if name == "send_tables":
            assert len(g) == len(w)
            for i, (gt, wt) in enumerate(zip(g, w)):
                _assert_same(gt, wt, f"send_tables[{i}]")
        elif isinstance(w, np.ndarray):
            _assert_same(g, w, name)
        else:
            assert g == w, name
    assert (sgot.halo_rows, sgot.num_rounds) == (swant.halo_rows, swant.num_rounds)
    assert phalo.scheduled_halo_wire_rows(sgot) == jhalo.scheduled_halo_wire_rows(swant)
    assert (phalo.scheduled_halo_bytes_per_device(sgot, 16)
            == jhalo.scheduled_halo_bytes_per_device(swant, 16))
    assert (phalo.scheduled_halo_padding_factor(sgot)
            == jhalo.scheduled_halo_padding_factor(swant))


@pytest.mark.parametrize("slack", [1.0, 1.5, 2.0, 4.0])
def test_schedule_rounds_matches_jax(slack):
    rng = np.random.default_rng(int(slack * 10))
    for k in (2, 3, 5, 8):
        widths = rng.integers(0, 50, (k, k)) * (rng.random((k, k)) < 0.7)
        np.fill_diagonal(widths, 0)
        assert phalo._schedule_rounds(widths, slack) == jhalo._schedule_rounds(widths, slack)


@pytest.mark.parametrize("graph", ["random", "clustered", "hub"])
@pytest.mark.parametrize("iters", [0, 1, 10])
def test_locality_relabel_matches_jax(graph, iters):
    n, src, dst, _, _ = GRAPHS[graph]()
    got = phalo.locality_relabel(src, dst, n, iters=iters)
    _assert_same(got, jhalo.locality_relabel(src, dst, n, iters=iters), "perm")
    assert sorted(got.tolist()) == list(range(n))


def test_relabel_shrinks_the_clustered_boundary():
    # tests/test_halo.py's volume claims, on the port's plans.
    n, src, dst, rel, mask = _clustered(2)
    raw = phalo.build_halo_plan(src, dst, rel, mask, n, 8)
    perm = phalo.locality_relabel(src, dst, n)
    loc = phalo.build_halo_plan(perm[src], perm[dst], rel, mask, n, 8)
    assert loc.halo_width < raw.halo_width
    assert phalo.halo_bytes_per_device(loc, 16) < phalo.allgather_bytes_per_device(loc, 16) / 2
    hot = _hot_pair(7)
    dense = phalo.build_halo_plan(*hot[1:], hot[0], 8)
    sched = phalo.build_scheduled_halo_plan(*hot[1:], hot[0], 8)
    assert phalo.scheduled_halo_padding_factor(sched) < 2.0
    assert phalo.scheduled_halo_padding_factor(sched) < 0.2 * phalo.halo_padding_factor(dense)
    for prs in sched.round_perms:
        assert len({i for i, _ in prs}) == len(prs) == len({j for _, j in prs})
