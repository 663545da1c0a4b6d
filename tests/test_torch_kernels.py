"""The port's two CUDA kernels, through their plain PyTorch versions.

On the CPU each wrapper runs its plain version; these tests hold those
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs, at f32 atol 3e-5 (the parity gate). The kernels themselves
are held against these plain versions on the card by test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.ops.pallas.edge_transform import (
    edge_transform_sorted_combined as jax_edge_transform,
)
from graph_hypernetwork_forge_tpu.ops.pallas.segment_sum import (
    sorted_segment_sum_packed64,
    sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda import _common
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
    edge_transform_sorted_combined_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    csr_segment_sum_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.segment import sorted_segment_sum
from torch_cases import edge_case, segment_case

ATOL = 3e-5


@pytest.mark.parametrize("skew", [False, True])
def test_csr_plain_matches_pallas_d128(skew):
    x, ids, splits = segment_case(0, 900, 70, 128, skew)
    want = sorted_segment_sum_pallas(
        jnp.asarray(x), jnp.asarray(ids), 70, interpret=True,
        splits=jnp.asarray(splits),
    )
    got = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 70)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not got[-3:].any()


@pytest.mark.parametrize("skew", [False, True])
def test_csr_plain_matches_packed64_d64(skew):
    x, ids, splits = segment_case(1, 1024, 64, 64, skew)
    want = sorted_segment_sum_packed64(
        jnp.asarray(x), jnp.asarray(ids), 64, True, "exact", jnp.asarray(splits)
    )
    got = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_csr_reads_only_the_first_n_plus_one_bounds():
    x, ids, splits = segment_case(2, 300, 20, 8, False)
    longer = np.concatenate([splits, [splits[-1]] * 5]).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=20)
    got = sorted_segment_sum(
        torch.from_numpy(x), torch.from_numpy(ids), 20, torch.from_numpy(longer)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_plain_matches_pallas(d, tail_cut):
    xs, xd, rel, wm, ws, b = edge_case(3, d, tail_cut)
    want = jax_edge_transform(
        jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(rel), jnp.asarray(wm),
        jnp.asarray(ws), jnp.asarray(b), None, 256, True,
    )
    got = edge_transform_sorted_combined_plain(
        *(torch.from_numpy(a) for a in (xs, xd, rel, wm, ws, b))
    )
    assert got.shape == (rel.shape[0], d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_edge_transform_tile_takes_its_first_rows_relation():
    # Mixed relations inside one tile: the tile's first row decides, as on
    # the TPU (the contract the group-padded layout exists for).
    rng = np.random.default_rng(4)
    e, d, u = 300, 8, 3
    rel = np.sort(rng.integers(0, u, e)).astype(np.int32)
    xs, xd = (rng.standard_normal((e, d)).astype(np.float32) for _ in range(2))
    wm, ws = (rng.standard_normal((u, d, d)).astype(np.float32) for _ in range(2))
    b = rng.standard_normal((u, d)).astype(np.float32)
    got = edge_transform_sorted_combined_plain(
        *(torch.from_numpy(a) for a in (xs, xd, rel, wm, ws, b))
    ).numpy()
    tile_rel = rel[(np.arange(e) // 256) * 256]
    want = (
        np.einsum("ed,edo->eo", xs, wm[tile_rel])
        + np.einsum("ed,edo->eo", xd, ws[tile_rel]) + b[tile_rel]
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launch_counts()
    x, _, splits = segment_case(5, 200, 16, 64, False)
    out = csr_segment_sum(torch.from_numpy(x), torch.from_numpy(splits), 16)
    torch.testing.assert_close(
        out, csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), 16),
        rtol=0, atol=0,
    )
    args = [torch.from_numpy(a) for a in edge_case(6, 64, 0)]
    torch.testing.assert_close(
        edge_transform_sorted_combined(*args),
        edge_transform_sorted_combined_plain(*args), rtol=0, atol=0,
    )
    assert csr_segment_sum.launches == 0
    assert edge_transform_sorted_combined.launches == 0


def test_inputs_that_want_a_gradient_are_refused():
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        _common.require_inference("k", t)
    with torch.no_grad():
        _common.require_inference("k", t)


def test_segment_ops_match_jax():
    from graph_hypernetwork_forge_tpu.ops import segment as jseg
    from graph_hypernetwork_forge_tpu_torch.ops import segment as pseg

    rng = np.random.default_rng(9)
    e, n, d = 400, 50, 16
    ids = rng.integers(0, n - 5, e).astype(np.int32)  # the last 5 stay empty
    x = rng.standard_normal((e, d)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    table = rng.standard_normal((n, d)).astype(np.float32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(e, dtype=np.int32)
    ids_sorted = ids[perm]
    splits = np.searchsorted(ids_sorted, np.arange(n + 1)).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x=x, ids=ids, w=w, table=table, perm=perm, ids_sorted=ids_sorted,
        splits=splits).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    pairs = [
        (pseg.segment_sum(t["x"], t["ids"], n), jseg.segment_sum(j["x"], j["ids"], n)),
        (pseg.segment_count(t["ids"], n, t["w"]),
         jseg.segment_count(j["ids"], n, j["w"])),
        *zip(pseg.segment_mean_clamped(t["x"], t["ids"], n, t["w"]),
             jseg.segment_mean_clamped(j["x"], j["ids"], n, j["w"])),
        (pseg.permute_rows(t["x"], t["perm"]),
         jseg.permute_rows(j["x"], j["perm"], jnp.asarray(inv))),
        *zip(pseg.take_rows_pair(t["table"], t["ids"], t["ids_sorted"]),
             (j["table"][j["ids"]], j["table"][j["ids_sorted"]])),
        *[(pseg.sorted_segment_sum_by_plan(t["x"], t["perm"], t["ids_sorted"], n, s),
           jseg.sorted_segment_sum_by_plan(
               j["x"], j["perm"], jnp.asarray(inv), j["ids_sorted"], n))
          for s in (None, t["splits"])],
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
