"""The port's collectives and its four forms of distributed message passing
(edge-partitioned, node-partitioned, halo, scheduled halo) on k gloo ranks,
against the JAX package's on k virtual CPU devices: values, and the
gradients of a fixed-cotangent loss ``Σ out · R`` w.r.t. h, W_msg, W_self
and the bias.

One spawn of k ranks per world size runs every case of this file
(``torch_parallel_ranks.passing``). Outputs agree to 1e-5, as the JAX
package's own tests gate them (test_sharding.py:51, test_halo.py:91);
isolated nodes are exactly zero (test_halo.py:120); gradients to 3e-5
after dividing by max(1, max|JAX|) (the port's gradient gate).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from graph_hypernetwork_forge_tpu.parallel.edge_partition import (
    edge_partitioned_message_passing,
)
from graph_hypernetwork_forge_tpu.parallel.halo import (
    build_halo_plan,
    build_scheduled_halo_plan,
    halo_message_passing,
    locality_relabel,
    scheduled_halo_message_passing,
)
from graph_hypernetwork_forge_tpu.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu.parallel.node_partition import (
    node_partitioned_message_passing,
    partition_edges_by_dst,
)
from torch_cases import assert_scaled_close
from torch_parallel_ranks import spawn

OUT_ATOL = 1e-5
WORLDS = (2, 4)


def _mp_case(seed, n, e, u=5, d=8, *, src=None, dst=None, scale=0.1):
    rng = np.random.default_rng(seed)
    if src is None:
        src = rng.integers(0, n, size=e)
        dst = rng.integers(0, n, size=e)
    e = src.size
    return dict(
        h=rng.standard_normal((n, d)).astype(np.float32),
        src=np.asarray(src, np.int64), dst=np.asarray(dst, np.int64),
        rel=rng.integers(0, u, size=e).astype(np.int32),
        mask=np.ones(e, np.float32),
        wm=(scale * rng.standard_normal((u, d, d))).astype(np.float32),
        ws=(scale * rng.standard_normal((u, d, d))).astype(np.float32),
        b=(scale * rng.standard_normal((u, d))).astype(np.float32),
        # Cotangent rows for up to n + 7 padded nodes.
        r=rng.standard_normal((n + 8, d)).astype(np.float32),
    )


@functools.lru_cache(maxsize=1)
def _cases():
    rng = np.random.default_rng(11)
    cases = {
        "coll": dict(
            x=rng.standard_normal((32, 3)).astype(np.float32),
            r=rng.standard_normal((32, 3)).astype(np.float32),
            w=rng.standard_normal((3, 5)).astype(np.float32),
            rw=rng.standard_normal((32, 5)).astype(np.float32),
        ),
        # tests/test_sharding.py's cases: n=16, e=64, u=4, d=8.
        "edge": _mp_case(0, 16, 64, u=4),
        "edge_masked": dict(_mp_case(1, 16, 64, u=4),
                            mask=(np.arange(64) < 40).astype(np.float32)),
        # tests/test_parallel_advanced.py and tests/test_halo.py's.
        "node": _mp_case(0, 30, 120),
        "halo": _mp_case(0, 30, 120),
        "scheduled": _mp_case(3, 30, 120),
    }
    # Only nodes 0..3 receive edges; the rest are isolated.
    rng = np.random.default_rng(1)
    iso_src, iso_dst = rng.integers(0, 24, 20), rng.integers(0, 4, 20)
    cases["halo_isolated"] = _mp_case(1, 24, 20, u=3, src=iso_src, dst=iso_dst, scale=1.0)
    # Relabeled by locality: the JAX package's relabel on the host, the
    # rows of h moved with it (test_halo.py's test_relabeled_graph_same_result).
    c = _mp_case(5, 48, 200, u=4)
    perm = locality_relabel(c["src"], c["dst"], 48)
    cases["halo_relabeled"] = dict(c, src=perm[c["src"]], dst=perm[c["dst"]],
                                   rows=np.argsort(perm))
    # Every edge inside one 8-node block: no boundary at k = 2 or 4, so the
    # schedule has no rounds and the halo buffer is empty.
    rng = np.random.default_rng(6)
    loc_src = rng.integers(0, 32, 96)
    loc_dst = loc_src // 8 * 8 + rng.integers(0, 8, 96)
    cases["scheduled_local"] = _mp_case(6, 32, 96, src=loc_src, dst=loc_dst)
    return cases


def _inputs():
    return {f"{name}/{k}": v for name, c in _cases().items() for k, v in c.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    return k, spawn("passing", k, tmp_path_factory.mktemp(f"passing_k{k}"), _inputs())


def _mesh(k):
    return make_mesh((k,), ("edge",), devices=jax.devices()[:k])


def _jax_value_and_grads(fn, c, h):
    """``fn(h, W_msg, W_self, bias)`` and the gradients of ``Σ out · R``,
    in one jitted program."""
    args = (jnp.asarray(h), jnp.asarray(c["wm"]), jnp.asarray(c["ws"]), jnp.asarray(c["b"]))
    r = jnp.asarray(c["r"][: jax.eval_shape(fn, *args).shape[0]])

    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(r)

    out, grads = jax.jit(run)(*args)
    return np.asarray(out), dict(zip(("dh", "dwm", "dws", "db"), map(np.asarray, grads)))


def _check(outs, name, want_out, want_grads, *, per_rank_out, n=None):
    """Per-rank outputs concatenate to the JAX output (a replicated one is
    whole on every rank); h's gradient too when h is per-rank; the weights'
    gradients are whole on every rank."""
    got = [o[f"{name}/out"] for o in outs]
    got = [np.concatenate(got)] if per_rank_out else got
    for g in got:
        np.testing.assert_allclose(g[:n], want_out[:n], rtol=0, atol=OUT_ATOL, err_msg=name)
    if per_rank_out:
        assert_scaled_close(np.concatenate([o[f"{name}/dh"] for o in outs]),
                            want_grads["dh"], err_msg=f"{name} dh")
    for o in outs:
        for key, want in want_grads.items():
            if key == "dh" and per_rank_out:
                continue
            assert_scaled_close(o[f"{name}/{key}"], want, err_msg=f"{name} {key}")


def _padded(c, n_pad):
    h = np.zeros((n_pad, c["h"].shape[1]), np.float32)
    h[: c["h"].shape[0]] = c["h"] if "rows" not in c else c["h"][c["rows"]]
    return h


# ---------------------------------------------------------------------------
# The collectives, against jax.lax inside shard_map
# ---------------------------------------------------------------------------


def _jax_collective(k, fn, out_spec, x, check_vma=True):
    mesh = _mesh(k)
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("edge"), out_specs=out_spec,
                      check_vma=check_vma)
    x = jnp.asarray(x)
    r = jnp.asarray(_cases()["coll"]["r"][: jax.eval_shape(f, x).shape[0]])
    out, dx = jax.jit(lambda x: (f(x), jax.grad(lambda x: jnp.sum(f(x) * r))(x)))(x)
    return np.asarray(out), np.asarray(dx)


@pytest.mark.parametrize("name", ["psum", "all_gather", "all_to_all", "ppermute_ring",
                                  "ppermute_one_pair"])
def test_collective_and_its_transpose_match_jax(ranks, name):
    k, outs = ranks
    x = _cases()["coll"]["x"]
    ring = [(i, (i + 1) % k) for i in range(k)]
    fn, spec, rows, check_vma = {
        "psum": (lambda x: jax.lax.psum(x, "edge"), P(), 2 * k, True),
        # JAX's relation sharding gathers to a P() output the same way.
        "all_gather": (lambda x: jax.lax.all_gather(x, "edge", tiled=True), P(), 2 * k,
                       False),
        "all_to_all": (lambda x: jax.lax.all_to_all(x, "edge", 0, 0, tiled=True),
                       P("edge"), 2 * k * k, True),
        "ppermute_ring": (lambda x: jax.lax.ppermute(x, "edge", ring), P("edge"), 2 * k,
                          True),
        "ppermute_one_pair": (lambda x: jax.lax.ppermute(x, "edge", [(0, 1)]), P("edge"),
                              2 * k, True),
    }[name]
    want, want_dx = _jax_collective(k, fn, spec, x[:rows], check_vma)
    replicated = spec == P()
    got = [o[f"coll/{name}/out"] for o in outs]
    for g in ([np.concatenate(got)] if not replicated else got):
        np.testing.assert_allclose(g, want, rtol=0, atol=OUT_ATOL, err_msg=name)
    np.testing.assert_allclose(np.concatenate([o[f"coll/{name}/dx"] for o in outs]),
                               want_dx, rtol=0, atol=OUT_ATOL, err_msg=f"{name} dx")


def test_copy_sums_the_replicated_operands_gradient(ranks):
    k, outs = ranks
    c = _cases()["coll"]
    f = jax.shard_map(lambda w, x: x @ w, mesh=_mesh(k), in_specs=(P(), P("edge")),
                      out_specs=P("edge"))
    x, w, r = jnp.asarray(c["x"][: 2 * k]), jnp.asarray(c["w"]), jnp.asarray(c["rw"][: 2 * k])
    want, want_dw = jax.jit(lambda w: (f(w, x), jax.grad(lambda w: jnp.sum(f(w, x) * r))(w)))(w)
    np.testing.assert_allclose(np.concatenate([o["coll/copy/out"] for o in outs]),
                               np.asarray(want), rtol=0, atol=OUT_ATOL)
    for o in outs:
        np.testing.assert_allclose(o["coll/copy/dw"], np.asarray(want_dw), rtol=0,
                                   atol=OUT_ATOL)


# ---------------------------------------------------------------------------
# Message passing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["edge", "edge_masked"])
def test_edge_partitioned_matches_jax(ranks, name):
    k, outs = ranks
    c = _cases()[name]
    mask = jnp.asarray(c["mask"]) if name == "edge_masked" else None
    edges = [jnp.asarray(c[a]) for a in ("src", "dst", "rel")]

    def fn(h, wm, ws, b):
        return edge_partitioned_message_passing(_mesh(k), h, *edges, wm, ws, b,
                                                edge_mask=mask)

    want, grads = _jax_value_and_grads(fn, c, c["h"])
    _check(outs, name, want, grads, per_rank_out=False)


def test_node_partitioned_matches_jax(ranks):
    k, outs = ranks
    c = _cases()["node"]
    n = c["h"].shape[0]
    p_src, p_dst, p_rel, p_mask, npp = partition_edges_by_dst(
        c["src"], c["dst"], c["rel"], c["mask"], n, k
    )
    arrays = [jnp.asarray(a) for a in (p_src, p_dst, p_rel)]

    def fn(h, wm, ws, b):
        return node_partitioned_message_passing(_mesh(k), h, *arrays, wm, ws, b,
                                                jnp.asarray(p_mask), npp)

    want, grads = _jax_value_and_grads(fn, c, _padded(c, npp * k))
    _check(outs, "node", want, grads, per_rank_out=True)


@pytest.mark.parametrize("name", ["halo", "halo_isolated", "halo_relabeled"])
def test_halo_matches_jax(ranks, name):
    k, outs = ranks
    c = _cases()[name]
    n = c["h"].shape[0]
    plan = build_halo_plan(c["src"], c["dst"], c["rel"], c["mask"], n, k)
    arrays = tuple(jnp.asarray(a) for a in plan.edge_arrays)

    def fn(h, wm, ws, b):
        return halo_message_passing(_mesh(k), h, arrays, jnp.asarray(plan.send_idx), wm,
                                    ws, b, plan.nodes_per_shard, plan.halo_width)

    want, grads = _jax_value_and_grads(fn, c, _padded(c, plan.nodes_per_shard * k))
    _check(outs, name, want, grads, per_rank_out=True)
    if name == "halo_isolated":
        got = np.concatenate([o[f"{name}/out"] for o in outs])
        np.testing.assert_array_equal(got[4:n], 0.0)


@pytest.mark.parametrize("name", ["scheduled", "scheduled_local"])
def test_scheduled_halo_matches_jax(ranks, name):
    k, outs = ranks
    c = _cases()[name]
    n = c["h"].shape[0]
    plan = build_scheduled_halo_plan(c["src"], c["dst"], c["rel"], c["mask"], n, k)

    def fn(h, wm, ws, b):
        return scheduled_halo_message_passing(_mesh(k), h, plan, wm, ws, b)

    want, grads = _jax_value_and_grads(fn, c, _padded(c, plan.nodes_per_shard * k))
    _check(outs, name, want, grads, per_rank_out=True)
    assert all(int(o[f"{name}/rounds"]) == plan.num_rounds for o in outs)
    if name == "scheduled_local":
        assert plan.num_rounds == 0
