"""Inputs for the kernel tests of the PyTorch port, made with numpy from a
seed. Imports no JAX, so the card tests can use them where JAX is absent."""

import numpy as np

from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph

# The parity gate: f32 atol 3e-5 per layer (CLAUDE.md:50-61).
ATOL = 3e-5


def assert_scaled_close(got, want, err_msg=""):
    """The gradient gate: atol 3e-5 after dividing both by
    ``max(1, max|want|)`` (tests/test_pallas_kernels.py:447-451), since a
    gradient or a segment sum adds many per-edge terms."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(
        np.asarray(got) / scale, want / scale, rtol=0, atol=ATOL, err_msg=err_msg
    )


def segment_case(seed, e, n, d, skew):
    """Sorted ids with empty segments (a hot node, gaps, an empty tail):
    ``(x [e, d] f32, ids [e] int32, splits [n + 1] int32)``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - 3, e)  # the last 3 segments stay empty
    if skew:
        ids = np.where(rng.random(e) < 0.4, 1, ids)  # long segment 1
    ids = np.sort(ids).astype(np.int32)
    splits = np.searchsorted(ids, np.arange(n + 1), side="left").astype(np.int32)
    x = rng.standard_normal((e, d)).astype(np.float32)
    return x, ids, splits


def edge_case(seed, d, tail_cut, d_out=None):
    """Group-padded relation-sorted rows whose bank has relations with no
    rows, cut to a length that is not a multiple of 256 when ``tail_cut``:
    ``(x_src, x_dst, rel, w_msg, w_self, bias)``, the banks ``[U, d, d_out]``
    (``d_out`` defaults to ``d``)."""
    rng = np.random.default_rng(seed)
    n, e, u = 40, 600, 6
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    graph = encode_graph(ei, etexts, n, sort_by_relation=True, group_pad=256)
    rel = graph.rel_ids[: graph.rel_ids.shape[0] - tail_cut]
    e_rows = rel.shape[0]
    u_pad = graph.char_ids.shape[0]  # 8: relations 6 and 7 have no rows
    d_out = d if d_out is None else d_out
    xs = rng.standard_normal((e_rows, d)).astype(np.float32)
    xd = rng.standard_normal((e_rows, d)).astype(np.float32)
    wm = (rng.standard_normal((u_pad, d, d_out)) / np.sqrt(d)).astype(np.float32)
    ws = (rng.standard_normal((u_pad, d, d_out)) / np.sqrt(d)).astype(np.float32)
    b = rng.standard_normal((u_pad, d_out)).astype(np.float32)
    return xs, xd, rel, wm, ws, b


def run_case(seed, d_in, d_out, tail_cut):
    """Group-padded relation-sorted rows whose relations span several
    256-row tiles (5, 4, 9 and 1 tiles, then an empty relation and a 3-tile
    one), so kernel 3 walks full and ragged runs of tiles; the bank has 8
    relations, 4, 6 and 7 without rows, and the last ``tail_cut`` rows are
    cut: ``(x_src, x_dst, rel, w_msg, w_self, bias)``, the banks
    ``[8, d_in, d_out]``."""
    rng = np.random.default_rng(seed)
    counts = [1100, 1024, 2300, 10, 0, 600]
    rel = np.concatenate(
        [np.full(-(-n // 256) * 256, u, dtype=np.int32) for u, n in enumerate(counts)]
    )
    rel = rel[: rel.shape[0] - tail_cut]
    e_rows, u_pad = rel.shape[0], 8
    xs = rng.standard_normal((e_rows, d_in)).astype(np.float32)
    xd = rng.standard_normal((e_rows, d_in)).astype(np.float32)
    wm = (rng.standard_normal((u_pad, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    ws = (rng.standard_normal((u_pad, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = rng.standard_normal((u_pad, d_out)).astype(np.float32)
    return xs, xd, rel, wm, ws, b


# Kernels 1 and 7's partition of the rows (csrc/segment_sum.cu): blocks of
# CSR_BLOCK_ROWS rows, CSR_WARPS warps a block, lane groups of
# lanes_per_row lanes, each group walking one span of consecutive rows;
# zero blocks of CSR_ZERO_SEGS segments each.
CSR_BLOCK_ROWS = 2048
CSR_WARPS = 8
CSR_ZERO_SEGS = 2048


def csr_lanes_per_row(d, vec):
    """Lanes that read one row of ``d`` elements ``vec`` at a time: the
    power of two at least ``d // vec``, at most 32 (wider rows take several
    32-lane column windows, which change no order)."""
    lanes = 1
    while lanes < d // vec and lanes < 32:
        lanes *= 2
    return lanes


def emulate_csr_segment_sum(x, splits, n, lanes_per_row):
    """Kernel 1's partition and order of sums, in float32 numpy.

    ``x`` holds the rows as the kernel widens them to f32 (bf16 rows
    upcast, ``mode="fast"`` rows rounded to bf16 first). Block ``b`` owns
    rows ``[2048 b, 2048 (b + 1))``; its ``8 * 32 / lanes_per_row`` lane
    groups each walk a span of consecutive rows and add them in row order,
    flushing at every segment end: a segment inside the span is written by
    its group, a span's head (a segment begun before it) and tail (one that
    runs on) wait in shared memory. After a segment ends, the group goes on
    with the segment of its span's next row, past any run of empty
    segments (a search, not a walk), and stops where the span has no row
    left. The block chains each tail, and its first head, with the heads of
    the same segment in the spans after it, in span order: a whole segment
    is written, a segment that leaves the block becomes the block's piece,
    slot 0 (begun in an earlier block) or 1. The last block of a crossing
    segment to draw its ticket sums the pieces in block order. Empty
    segments are zeroed by the zero blocks, zero block ``z`` owning
    segments ``[2048 z, 2048 (z + 1))``.

    Returns ``(out [n, d] float32, writers)``: ``writers[s]`` lists who
    wrote segment ``s``, as ``("span", block, group)``, ``("zero", zero
    block)``, ``("chain", block)`` or ``("ticket", first block, last
    block)``.
    """
    x = np.asarray(x, dtype=np.float32)
    rows, d = x.shape
    sp = np.asarray(splits[: n + 1], dtype=np.int64)
    groups = CSR_WARPS * (32 // lanes_per_row)
    span = CSR_BLOCK_ROWS // groups
    blocks = max(1, -(-rows // CSR_BLOCK_ROWS))
    begin, end = sp[0], sp[n]
    zero = np.zeros(d, dtype=np.float32)
    out = np.full((n, d), np.nan, dtype=np.float32)
    writers = [[] for _ in range(n)]

    def write(s, value, who):
        out[s] = value
        writers[s].append(who)

    for s in np.flatnonzero(sp[1:] == sp[:-1]):
        write(s, zero, ("zero", int(s) // CSR_ZERO_SEGS))
    pieces = {}  # (block, slot) -> (segment, f32 piece)
    for blk in range(blocks):
        brow0 = blk * CSR_BLOCK_ROWS
        heads, tails = {}, {}  # group -> (segment, f32 piece)
        for k in range(groups):
            span0 = brow0 + k * span
            r0, r1 = max(span0, begin), min(span0 + span, end)
            if r0 >= r1:
                continue
            s = int(np.searchsorted(sp, r0, side="right")) - 1
            seg_start, head = sp[s], sp[s] < span0
            acc = zero.copy()
            for row in range(r0, r1):
                acc = acc + x[row]
                if row + 1 != sp[s + 1]:
                    continue
                if head:
                    heads[k] = (s, acc)
                else:
                    write(s, acc, ("span", blk, k))
                acc, head, seg_start = zero.copy(), False, sp[s + 1]
                if row + 1 >= r1:
                    break
                s = int(np.searchsorted(sp, row + 1, side="right")) - 1
            if max(seg_start, r0) < r1:
                (heads if head else tails)[k] = (s, acc)
        chains = [(True, 0) + heads[0]] if 0 in heads else []
        chains += [(False, j) + tails[j] for j in sorted(tails)]
        for before, j, seg, total in chains:
            j += 1
            while j < groups and j in heads and heads[j][0] == seg:
                total = total + heads[j][1]
                j += 1
            if not before and sp[seg + 1] <= brow0 + CSR_BLOCK_ROWS:
                write(seg, total, ("chain", blk))
            else:
                pieces[(blk, 0 if before else 1)] = (seg, total)
    for (b0, slot), (seg, total) in sorted(pieces.items()):
        if slot == 1:  # the segment begins in block b0
            b1 = (int(sp[seg + 1]) - 1) // CSR_BLOCK_ROWS
            for b in range(b0 + 1, b1 + 1):
                assert pieces[(b, 0)][0] == seg
                total = total + pieces[(b, 0)][1]
            write(seg, total, ("ticket", b0, b1))
    return out, writers


def emulate_csr_segment_sum_serial_zeros(x, splits, n, lanes_per_row):
    """Kernel 1's partition and order of sums before its zero blocks, in
    float32 numpy: the group that ends a segment zeroes the empty ones
    after it, one at a time. Kept to show that the zero blocks left every
    non-empty segment's bits as they were.

    ``x`` holds the rows as the kernel widens them to f32 (bf16 rows
    upcast, ``mode="fast"`` rows rounded to bf16 first). Block ``b`` owns
    rows ``[2048 b, 2048 (b + 1))``; its ``8 * 32 / lanes_per_row`` lane
    groups each walk a span of consecutive rows and add them in row order,
    flushing at every segment end: a segment inside the span is written by
    its group, a span's head (a segment begun before it) and tail (one that
    runs on) wait in shared memory. The block chains each tail, and its
    first head, with the heads of the same segment in the spans after it,
    in span order: a whole segment is written, a segment that leaves the
    block becomes the block's piece, slot 0 (begun in an earlier block) or
    1. The last block of a crossing segment to draw its ticket sums the
    pieces in block order. Empty segments are zeroed by the group that ends
    the segment before them, leading ones by the group whose span holds row
    ``splits[0]``, and all of them, when no segment has a row, by block 0's
    group 0.

    Returns ``(out [n, d] float32, writers)``: ``writers[s]`` lists who
    wrote segment ``s``, as ``("span", block, group)``, ``("zero", block,
    group)``, ``("chain", block)`` or ``("ticket", first block, last
    block)``.
    """
    x = np.asarray(x, dtype=np.float32)
    rows, d = x.shape
    sp = np.asarray(splits[: n + 1], dtype=np.int64)
    groups = CSR_WARPS * (32 // lanes_per_row)
    span = CSR_BLOCK_ROWS // groups
    blocks = max(1, -(-rows // CSR_BLOCK_ROWS))
    begin, end = sp[0], sp[n]
    zero = np.zeros(d, dtype=np.float32)
    out = np.full((n, d), np.nan, dtype=np.float32)
    writers = [[] for _ in range(n)]

    def write(s, value, who):
        out[s] = value
        writers[s].append(who)

    pieces = {}  # (block, slot) -> (segment, f32 piece)
    for blk in range(blocks):
        brow0 = blk * CSR_BLOCK_ROWS
        heads, tails = {}, {}  # group -> (segment, f32 piece)
        for k in range(groups):
            span0 = brow0 + k * span
            r0, r1 = max(span0, begin), min(span0 + span, end)
            if begin == end and blk == 0 and k == 0:
                for z in range(n):
                    write(z, zero, ("zero", blk, k))
            if r0 >= r1:
                continue
            s = int(np.searchsorted(sp, r0, side="right")) - 1
            if r0 == begin:
                for z in range(s):
                    write(z, zero, ("zero", blk, k))
            seg_start, head = sp[s], sp[s] < span0
            acc = zero.copy()
            for row in range(r0, r1):
                acc = acc + x[row]
                if row + 1 != sp[s + 1]:
                    continue
                if head:
                    heads[k] = (s, acc)
                else:
                    write(s, acc, ("span", blk, k))
                acc, head, seg_start = zero.copy(), False, sp[s + 1]
                s += 1
                while s < n and sp[s + 1] == seg_start:
                    write(s, zero, ("zero", blk, k))
                    s += 1
            if max(seg_start, r0) < r1:
                (heads if head else tails)[k] = (s, acc)
        chains = [(True, 0) + heads[0]] if 0 in heads else []
        chains += [(False, j) + tails[j] for j in sorted(tails)]
        for before, j, seg, total in chains:
            j += 1
            while j < groups and j in heads and heads[j][0] == seg:
                total = total + heads[j][1]
                j += 1
            if not before and sp[seg + 1] <= brow0 + CSR_BLOCK_ROWS:
                write(seg, total, ("chain", blk))
            else:
                pieces[(blk, 0 if before else 1)] = (seg, total)
    for (b0, slot), (seg, total) in sorted(pieces.items()):
        if slot == 1:  # the segment begins in block b0
            b1 = (int(sp[seg + 1]) - 1) // CSR_BLOCK_ROWS
            for b in range(b0 + 1, b1 + 1):
                assert pieces[(b, 0)][0] == seg
                total = total + pieces[(b, 0)][1]
            write(seg, total, ("ticket", b0, b1))
    return out, writers


def _splits_of_counts(counts, start=0):
    return np.concatenate([[start], start + np.cumsum(counts)]).astype(np.int32)


# Empty segments after the last row of the composed step's shard at k = 4
# on the xl graph: its dst cotangent sums over the [local ++ halo] table of
# 62,292 segments, of which only the 12,500 local nodes have rows.
SHARD_TRAILING_EMPTY = 49_792


def _long_empty_runs(rng, trailing):
    """Segment sizes: a leading run of 300 empty segments; runs of 1, 2, 31,
    32, 33, 2047, 2048, 2049 and 5000 empty ones between groups of short
    segments; a 3,000-row segment across blocks; the segment before the
    2049-run ending on a block's (and every span's) last row; then
    ``trailing`` empty segments."""
    counts = [np.zeros(300, dtype=np.int64)]
    for run in (1, 2, 31, 32, 33, 2047, 2048, 2049, 5000):
        group = rng.integers(1, 40, rng.integers(4, 24))
        if run == 2049:
            before = sum(int(c.sum()) for c in counts) + int(group[:-1].sum())
            group[-1] = -(-(before + 1) // CSR_BLOCK_ROWS) * CSR_BLOCK_ROWS - before
        counts += [group, np.zeros(run, dtype=np.int64)]
        if run == 32:
            counts.append(np.array([3000]))
    counts += [rng.integers(1, 40, 10), np.zeros(trailing, dtype=np.int64)]
    return np.concatenate(counts)


def csr_case(name, seed=0, trailing=SHARD_TRAILING_EMPTY):
    """``(rows, splits [n + 1] int32, n)`` of a named layout of segments;
    ``trailing``: the empty segments that end ``"long_empty_runs"``."""
    rng = np.random.default_rng(seed)
    if name == "long_empty_runs":
        counts = _long_empty_runs(rng, trailing)
        return int(counts.sum()), _splits_of_counts(counts), counts.shape[0]
    if name == "pad_segment":
        # Node 0 holds 5,000 rows across three blocks (the group-padded
        # layout's pad rows), then ~20-row segments, some empty, 3 empty last.
        counts = np.concatenate([[5000], rng.integers(0, 40, 296), [0, 0, 0]])
        return int(counts.sum()), _splits_of_counts(counts), 300
    if name == "all_empty":
        return 300, np.full(51, 120, dtype=np.int32), 50
    if name == "splits0_positive":
        # Rows before splits[0] and after splits[n] belong to no segment;
        # segments 0-3 are empty at splits[0].
        counts = np.concatenate([[0, 0, 0, 0], rng.integers(0, 60, 196)])
        splits = _splits_of_counts(counts, start=777)
        return int(splits[-1]) + 333, splits, 200
    if name == "one_segment":
        return 5000, np.array([0, 5000], dtype=np.int32), 1
    if name == "ends_on_span_and_block_rows":
        # Boundaries on the last row of a span (every span length) and of a
        # block, on the first row after, and one row either side.
        cuts = {1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                2047, 2048, 2049, 4095, 4096, 4097, 4160, 6143, 6144}
        bounds = np.array(sorted(cuts | {0, 6500}), dtype=np.int32)
        return 6500, bounds, bounds.shape[0] - 1
    if name == "dbias_like":
        # The relation-sorted, group-padded rows that dbias sums over
        # rel_splits: long segments, one empty, the last two empty.
        counts = [1100, 1024, 2300, 10, 0, 600, 0, 0]
        padded = [-(-c // 256) * 256 for c in counts]
        return int(sum(padded)), _splits_of_counts(padded), len(counts)
    raise ValueError(name)


CSR_CASES = ("pad_segment", "all_empty", "splits0_positive", "one_segment",
             "ends_on_span_and_block_rows", "dbias_like", "long_empty_runs")
