"""The staged output epilogue of kernels 2 and 5's bf16 body, emulated.

``edge_transform_bf16_kernel`` (``csrc/edge_transform.cu``) ends with each
thread holding the f32 accumulators of its mma.m16n8k16 fragments for a
128-row x kBN-column output tile. Where d_out % 8 == 0 the tile leaves
through shared memory: each thread adds the bias in f32, rounds once to
bf16 and writes pairs of columns into a staged tile whose rows are kBN + 8
bf16 apart; then the block stores whole output rows in 16-byte pieces,
consecutive threads on consecutive pieces of a row. Where d_out % 8 != 0
each thread stores its own elements, masked. Without a card the kernel
cannot run, so these tests replay its index arithmetic thread by thread
and check that every output element of the slab is written exactly once
with its rounded value, that nothing outside the slab or past the last row
is written, that the staged tile fits in the ring's space, and that the
warps' shared-memory stores and loads are free of bank conflicts. Imports
no JAX.
"""

import numpy as np
import pytest
import torch

BM2, BKH, STAGES, THREADS = 128, 32, 3, 256  # csrc/edge_transform.cu
X_STRIDE_H = BKH + 8


def _ring_bytes(kbn):
    return STAGES * (BM2 * X_STRIDE_H + BKH * (kbn + 8)) * 2


def _fragments(kbn):
    """Per thread, the (row, column) in the tile of each accumulator, in
    the kernel's order [j][i][h][pair] (acc[i][j][2 h + pair])."""
    nt = kbn // 16
    out = {}
    for tid in range(THREADS):
        lane, warp = tid & 31, tid >> 5
        gid, tig = lane >> 2, lane & 3
        wm, wn = warp & 3, warp >> 2
        out[tid] = [
            [[[(wm * 32 + i * 16 + gid + 8 * h, wn * (kbn // 2) + j * 8 + 2 * tig + p)
               for p in range(2)] for h in range(2)] for i in range(2)]
            for j in range(nt)]
    return out


def _bf16(v):
    return torch.tensor(v, dtype=torch.float32).bfloat16().float().numpy()


def _epilogue(kbn, d_out, col0, rows_left, with_bias, seed):
    """Replay the epilogue of one block: ``(out, writes, want)``, where
    ``out`` [128, d_out] holds what the block stored (NaN elsewhere),
    ``writes`` counts the stores of each element, and ``want`` is the
    tile's accumulators plus the bias, rounded once to bf16."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((BM2, kbn)).astype(np.float32)
    bias = rng.standard_normal(d_out).astype(np.float32)
    b_slab = np.zeros(kbn, dtype=np.float32)
    width = min(kbn, d_out - col0)
    if with_bias:
        b_slab[:width] = bias[col0: col0 + width]
    want = _bf16(acc + b_slab)
    out = np.full((BM2, d_out), np.nan, dtype=np.float32)
    writes = np.zeros((BM2, d_out), dtype=np.int64)
    frags = _fragments(kbn)
    if d_out % 8 == 0:
        stride = kbn + 8
        assert BM2 * stride * 2 <= _ring_bytes(kbn)
        staged = np.full(BM2 * stride, np.nan, dtype=np.float32)
        staged_writes = np.zeros(BM2 * stride, dtype=np.int64)
        for tid, js in frags.items():
            for j in js:
                for i in j:
                    for h in i:
                        (r, c), (_, c1) = h
                        assert c1 == c + 1
                        n = col0 + c
                        pair = acc[r, c:c + 2] + (b_slab[c:c + 2] if n < d_out else 0)
                        staged[r * stride + c: r * stride + c + 2] = _bf16(pair)
                        staged_writes[r * stride + c: r * stride + c + 2] += 1
        assert (staged_writes[: BM2 * stride].reshape(BM2, stride)[:, :kbn] == 1).all()
        for v in range(BM2 * kbn // 8):
            r, c = v // (kbn // 8), (v % (kbn // 8)) * 8
            if r < rows_left and c < width:
                assert (col0 + c) % 8 == 0  # 16-byte aligned in a row of d_out bf16
                out[r, col0 + c: col0 + c + 8] = staged[r * stride + c: r * stride + c + 8]
                writes[r, col0 + c: col0 + c + 8] += 1
    else:
        for tid, js in frags.items():
            for j in js:
                for i in j:
                    for h in i:
                        for r, c in h:
                            n = col0 + c
                            if r < rows_left and n < d_out:
                                out[r, n] = _bf16(acc[r, c] + b_slab[c])
                                writes[r, n] += 1
    return out, writes, want


@pytest.mark.parametrize("d_out", [40, 64, 128, 192, 36, 30])
@pytest.mark.parametrize("rows_left", [128, 100])
@pytest.mark.parametrize("with_bias", [True, False])
def test_every_output_element_is_stored_once_with_its_rounded_value(d_out, rows_left, with_bias):
    # kBN is 64 for d_out <= 64, else 128-column slabs; rows_left < 128 is
    # the ragged last block; without the bias: selfc, and the backward's dx.
    kbn = 64 if d_out <= 64 else 128
    for col0 in range(0, d_out, kbn):
        out, writes, want = _epilogue(kbn, d_out, col0, rows_left, with_bias, d_out + col0)
        width = min(kbn, d_out - col0)
        assert (writes[:rows_left, col0: col0 + width] == 1).all()
        writes[:rows_left, col0: col0 + width] = 0
        assert not writes.any(), "a store outside the slab or past the last row"
        np.testing.assert_array_equal(out[:rows_left, col0: col0 + width],
                                      want[:rows_left, :width])


@pytest.mark.parametrize("kbn", [64, 128])
def test_staged_stores_and_loads_are_free_of_bank_conflicts(kbn):
    stride = kbn + 8  # bf16 a row: an odd multiple of 16 bytes
    assert (stride * 2) % 32 == 16
    frags = _fragments(kbn)
    # One warp store: 32 lanes x one bf16 pair (4 bytes) at fixed j, i, h.
    for warp in range(THREADS // 32):
        for j in range(kbn // 16):
            for i in range(2):
                for h in range(2):
                    banks = {((r * stride + c) * 2 // 4) % 32
                             for lane in range(32)
                             for (r, c) in [frags[warp * 32 + lane][j][i][h][0]]}
                    assert len(banks) == 32
    # One 16-byte load by 8 consecutive threads (a quarter warp's phase).
    for t0 in range(0, BM2 * kbn // 8, 8):
        groups = set()
        for v in range(t0, t0 + 8):
            r, c = v // (kbn // 8), (v % (kbn // 8)) * 8
            groups.add(((r * stride + c) * 2 // 16) % 8)
        assert len(groups) == 8
