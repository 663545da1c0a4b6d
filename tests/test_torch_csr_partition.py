"""Kernel 1's partition of the rows and order of sums, on the CPU.

Kernel 1 (``csrc/segment_sum.cu``, the port of ``sorted_segment_sum_pallas``
and ``sorted_segment_sum_packed64``) is one launch: blocks of 2048 rows,
lane groups that walk spans of consecutive rows as segmented sums, the
block's chains of span heads and tails, an ordered last-arriver sum of
the pieces of segments that cross blocks, and zero blocks of 2048
segments that write the empty ones. ``torch_cases.emulate_csr_segment_sum``
emulates that partition and order in float32 numpy. Here, without a card:

- every segment is written exactly once, by the writer the design names,
  and empty segments are exactly 0, each by the zero block that owns it;
- every sum is bitwise the one of the design before the zero blocks, in
  which the group that ends a segment zeroed the empty ones after it
  (``emulate_csr_segment_sum_serial_zeros``);
- the emulation agrees with ``csr_segment_sum_plain`` (f32, bf16 rows
  summed in f32, ``mode="fast"``) and with the JAX package's kernels in
  interpret mode, within the f32 gate (3e-5 after scaling);
- on a small group-padded layout with its SortPlan, over ``dst_splits``,
  ``src_splits`` and ``rel_splits``, and on the composed step's shard
  plans at k = 4 over their ``[local ++ halo]`` tables.

The kernel itself is held bitwise to this emulation on the card by
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.ops.pallas.segment_sum import (
    sorted_segment_sum_packed64,
    sorted_segment_sum_pallas,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum_plain,
)
from graph_hypernetwork_forge_tpu_torch.parallel.composed import prepare_composed_inputs
from torch_cases import (
    CSR_BLOCK_ROWS,
    CSR_CASES as CASES,
    CSR_ZERO_SEGS,
    assert_scaled_close,
    csr_case,
    csr_lanes_per_row,
    emulate_csr_segment_sum,
    emulate_csr_segment_sum_serial_zeros,
)

# Lanes a row: 8 (bf16 at d=64), 16 (f32 at d=64, bf16 at d=128), 32 (f32
# at d=128), and 4 (narrow rows): spans of 64, 128, 256 and 32 rows.
LANES = (4, 8, 16, 32)


def _rows(rows, d, seed):
    return np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32)


def _ids(splits, rows):
    """Sorted ids of every row: a row before splits[0] takes segment 0 and
    one past splits[n] the last (both outside every CSR interval)."""
    n = splits.shape[0] - 1
    return np.clip(np.searchsorted(splits[1:], np.arange(rows), side="right"),
                   0, n - 1).astype(np.int32)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", CASES)
def test_each_segment_is_written_once_by_its_owner(name, lanes):
    rows, splits, n = csr_case(name)
    out, writers = emulate_csr_segment_sum(_rows(rows, 3, 1), splits, n, lanes)
    sizes = np.diff(splits[: n + 1])
    for s in range(n):
        assert len(writers[s]) == 1, (s, writers[s])
        kind = writers[s][0][0]
        if sizes[s] == 0:
            assert writers[s] == [("zero", s // CSR_ZERO_SEGS)], (s, writers[s])
            assert not out[s].any() and not np.signbit(out[s]).any(), s
        else:
            assert kind in ("span", "chain", "ticket"), (s, writers[s])
    # A segment across blocks is summed by a ticket over exactly its blocks.
    for s in np.flatnonzero(sizes):
        b0, b1 = splits[s] // CSR_BLOCK_ROWS, (splits[s + 1] - 1) // CSR_BLOCK_ROWS
        if b1 > b0:
            assert writers[s][0] == ("ticket", b0, b1)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", CASES)
def test_zero_blocks_leave_every_sum_as_the_serial_zeroing_had_it(name, lanes):
    # The zero blocks and the search past empty runs change who writes the
    # empty segments, not the partition or order of any sum: every output
    # is bitwise the earlier design's.
    rows, splits, n = csr_case(name)
    x = _rows(rows, 5, 9)
    got, _ = emulate_csr_segment_sum(x, splits, n, lanes)
    want, writers = emulate_csr_segment_sum_serial_zeros(x, splits, n, lanes)
    assert all(len(w) == 1 for w in writers)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pad_segment_is_summed_over_blocks_in_block_order():
    # Node 0's 5,000 rows: the pieces of blocks 0, 1 and 2 (each summed
    # span by span, in span order) are added in block order.
    rows, splits, n = csr_case("pad_segment")
    x = _rows(rows, 4, 2)
    out, writers = emulate_csr_segment_sum(x, splits, n, 8)
    assert writers[0] == [("ticket", 0, 2)]

    def in_order(rows_):
        acc = np.zeros(4, dtype=np.float32)
        for r in rows_:
            acc = acc + r
        return acc

    span = CSR_BLOCK_ROWS // 32
    blocks = []
    for b0, b1 in ((0, 2048), (2048, 4096), (4096, 5000)):
        pieces = [in_order(x[r: min(r + span, b1)]) for r in range(b0, b1, span)]
        blocks.append(in_order(pieces))
    np.testing.assert_array_equal(out[0], in_order(blocks))


@pytest.mark.parametrize("form", ["f32", "bf16", "fast"])
@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_plain(name, form):
    rows, splits, n = csr_case(name)
    d = 64
    xt = torch.from_numpy(_rows(rows, d, 3))
    if form == "bf16":
        xt = xt.bfloat16()
    mode = "fast" if form == "fast" else "exact"
    want = csr_segment_sum_plain(xt, torch.from_numpy(splits), n, mode).numpy()
    widened = (xt.bfloat16() if form != "f32" else xt).float().numpy()
    vec = 8 if form == "bf16" else 4
    got, _ = emulate_csr_segment_sum(widened, splits, n, csr_lanes_per_row(d, vec))
    assert_scaled_close(got, want, err_msg=f"{name} {form}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["pad_segment", "splits0_positive",
                                  "ends_on_span_and_block_rows", "dbias_like",
                                  "long_empty_runs"])
def test_emulation_matches_jax_pallas(name, dtype):
    # sorted_segment_sum_pallas in interpret mode (its rows d % 128 == 0),
    # given the CSR bounds, as tests/test_pallas_kernels.py runs it.
    # long_empty_runs keeps its whole trailing run of 49,792 empty
    # segments: interpret mode takes about a second over its 61,503.
    rows, splits, n = csr_case(name)
    x = _rows(rows, 128, 4)
    xj = jnp.asarray(x).astype(dtype)
    want = sorted_segment_sum_pallas(xj, jnp.asarray(_ids(splits, rows)), n,
                                     128, 256, True, "exact", jnp.asarray(splits))
    widened = np.asarray(xj.astype(jnp.float32))
    vec = 8 if dtype == "bfloat16" else 4
    got, _ = emulate_csr_segment_sum(widened, splits, n, csr_lanes_per_row(128, vec))
    assert_scaled_close(got, np.asarray(want), err_msg=f"{name} {dtype}")


@pytest.mark.parametrize("name", ["pad_segment", "dbias_like", "one_segment"])
def test_emulation_matches_jax_packed64(name):
    rows, splits, n = csr_case(name)
    rows += rows % 2  # the pair-packed kernel takes an even row count
    x = _rows(rows, 64, 5)
    want = sorted_segment_sum_packed64(jnp.asarray(x), jnp.asarray(_ids(splits, rows)),
                                       n, True, "exact", jnp.asarray(splits))
    got, _ = emulate_csr_segment_sum(x, splits, n, csr_lanes_per_row(64, 4))
    assert_scaled_close(got, np.asarray(want), err_msg=name)


def _plan_graph():
    """A small group-padded, relation-sorted layout with its SortPlan: the
    masked pad rows all point at node 0."""
    rng = np.random.default_rng(6)
    n, e, u = 300, 3000, 30
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    return encode_graph(ei, etexts, n, sort_by_relation=True, with_sort_plan=True,
                        group_pad=256), n


@pytest.mark.parametrize("which", ["dst_splits", "src_splits", "rel_splits"])
@pytest.mark.parametrize("lanes", [8, 16])
def test_emulation_on_a_sort_plan(which, lanes):
    graph, n_nodes = _plan_graph()
    splits = np.asarray(getattr(graph.sort_plan, which))
    n = splits.shape[0] - 1
    rows = graph.rel_ids.shape[0]
    x = _rows(rows, 64, 7)
    got, writers = emulate_csr_segment_sum(x, splits, n, lanes)
    want = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits), n).numpy()
    assert_scaled_close(got, want, err_msg=which)
    assert all(len(w) == 1 for w in writers)
    if which == "dst_splits":  # node 0's pad segment crosses blocks
        assert n == n_nodes and splits[1] > CSR_BLOCK_ROWS
        assert writers[0][0][0] == "ticket"


def test_emulation_on_a_composed_shard_plan():
    # The composed step's kernel plans at k = 4 (halo, relation-sorted and
    # group-padded per shard): shard 0's dst and src gather cotangents sum
    # its edge rows over the [local ++ halo] table, whose halo rows have no
    # dst edge, so the dst bounds end in a long run of empty segments.
    rng = np.random.default_rng(10)
    n_nodes, e, u = 4000, 8000, 12
    ei = np.stack([rng.integers(0, n_nodes, e), rng.integers(0, n_nodes, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    graph = encode_graph(ei, [texts[i] for i in rng.integers(0, u, e)], n_nodes)
    feats = rng.standard_normal((n_nodes, 8)).astype(np.float32)
    k = 4
    inputs = prepare_composed_inputs(graph, feats, k, halo=True, rel_sort_local=True,
                                     group_pad=256)
    cap, npp = inputs.src.shape[0] // k, inputs.nodes_per_shard
    n = npp + k * inputs.halo_width
    x = _rows(cap, 64, 11)
    for which in ("kernel_dst_splits", "kernel_src_splits"):
        splits = np.asarray(getattr(inputs, which)[0])
        assert splits.shape[0] == n + 1
        sizes = np.diff(splits)
        for lanes in (8, 16):
            got, writers = emulate_csr_segment_sum(x, splits, n, lanes)
            want = csr_segment_sum_plain(torch.from_numpy(x), torch.from_numpy(splits),
                                         n).numpy()
            assert_scaled_close(got, want, err_msg=f"{which} lanes={lanes}")
            assert all(len(w) == 1 for w in writers)
            assert not got[sizes == 0].any()
            assert not np.signbit(got[sizes == 0]).any()
        if which == "kernel_dst_splits":  # the halo rows: empty, over two zero blocks
            assert (sizes[npp:] == 0).all() and n > CSR_ZERO_SEGS > npp
