"""The fragment maps of the bf16 tensor-core products, emulated on the CPU.

``csrc/bf16_mma.cuh`` loads the A and B fragments of ``mma.m16n8k16`` from
row-major shared-memory tiles with ``ldmatrix`` (plain, or ``.trans`` where
the tile holds the operand's transpose), and the bf16 forms of kernels 2
and 5 (one body), 3 and 6 walk their tiles with those loads. Without a card they cannot run, so
these tests emulate ``ldmatrix.x4`` and ``mma.m16n8k16`` as the PTX ISA
defines them, lane by lane, drive them with the kernels' own address
arithmetic, and hold every warp's accumulators, read back through the
kernels' store maps, against the products they stand for. Imports no JAX.
"""

import numpy as np
import pytest


def _ldsm_x4(flat, addrs, trans):
    """Registers ``[32 lanes, 4, 2]``: lane l gives the element offset of
    row l % 8 of matrix l // 8; without ``trans`` thread t receives row
    t // 4, columns 2 (t % 4) and +1, with it column t // 4, rows 2 (t % 4)
    and +1."""
    regs = np.zeros((32, 4, 2))
    for i in range(4):
        m = np.stack([flat[addrs[8 * i + r]: addrs[8 * i + r] + 8] for r in range(8)])
        for t in range(32):
            regs[t, i] = m[t // 4, 2 * (t % 4): 2 * (t % 4) + 2] if not trans else \
                m[2 * (t % 4): 2 * (t % 4) + 2, t // 4]
    return regs


def _mma(acc, a, b):
    """acc [32, 4] += A [16, 16] @ B [16, 8] from the lanes' fragments."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for t in range(32):
        g, k = t // 4, 2 * (t % 4)
        A[g, k:k + 2], A[g + 8, k:k + 2] = a[t, 0], a[t, 1]
        A[g, k + 8:k + 10], A[g + 8, k + 8:k + 10] = a[t, 2], a[t, 3]
        B[k:k + 2, g], B[k + 8:k + 10, g] = b[t, 0], b[t, 1]
    c = A @ B
    for t in range(32):
        g, n = t // 4, 2 * (t % 4)
        acc[t] += [c[g, n], c[g, n + 1], c[g + 8, n], c[g + 8, n + 1]]


# The address arithmetic of bf16mma::load_a, load_a_trans, load_b2 and
# load_b2_trans, lane l = 8 i + r.
def _load_a(flat, base, stride):
    return _ldsm_x4(flat, [base + (l & 15) * stride + (l >> 4) * 8 for l in range(32)], False)


def _load_a_trans(flat, base, stride):
    return _ldsm_x4(flat, [base + ((l >> 4) * 8 + (l & 7)) * stride + ((l >> 3) & 1) * 8
                           for l in range(32)], True)


def _load_b2(flat, base, stride):
    q = _ldsm_x4(flat, [base + ((l >> 4) * 8 + (l & 7)) * stride + ((l >> 3) & 1) * 8
                        for l in range(32)], False)
    return q[:, 0:2], q[:, 2:4]


def _load_b2_trans(flat, base, stride):
    q = _ldsm_x4(flat, [base + (((l >> 3) & 1) * 8 + (l & 7)) * stride + (l >> 4) * 8
                        for l in range(32)], True)
    return q[:, 0:2], q[:, 2:4]


def _tile(m, stride):
    """A row-major matrix in shared memory, rows padded to ``stride``."""
    flat = np.zeros(m.shape[0] * stride)
    for r, row in enumerate(m):
        flat[r * stride: r * stride + m.shape[1]] = row
    return flat


def _stored(acc, rows_of, cols_of, shape):
    """The accumulators [i, j, lane, 4] written back as the kernels store
    them: c0, c1 at (row of gid, columns 2 tig, +1), c2, c3 eight rows on."""
    out = np.full(shape, np.nan)
    for i in range(acc.shape[0]):
        for j in range(acc.shape[1]):
            for t in range(32):
                for h in range(2):
                    r, c = rows_of(i, t // 4 + 8 * h), cols_of(j, 2 * (t % 4))
                    out[r, c:c + 2] = acc[i, j, t, 2 * h: 2 * h + 2]
    return out


@pytest.mark.parametrize("kbn", [64, 128])
def test_kernel_2_fragments_give_x_times_the_bank(kbn):
    # One 32-deep K slice of a 128-row block: A = x [rows][k] (ldmatrix),
    # B = the bank slice [k][n] (ldmatrix.trans); 4 x 2 warps of 32 rows x
    # kbn / 2 columns.
    rng = np.random.default_rng(kbn)
    bm, bk = 128, 32
    kx, kws = bk + 8, kbn + 8
    x, w = rng.standard_normal((bm, bk)), rng.standard_normal((bk, kbn))
    xs, ws = _tile(x, kx), _tile(w, kws)
    nt = kbn // 16
    got = np.full((bm, kbn), np.nan)
    for warp in range(8):
        wm, wn = warp & 3, warp >> 2
        acc = np.zeros((2, nt, 32, 4))
        for kb in range(0, bk, 16):
            af = [_load_a(xs, wm * 32 * kx + i * 16 * kx + kb, kx) for i in range(2)]
            for q in range(nt // 2):
                bf = _load_b2_trans(ws, wn * (kbn // 2) + kb * kws + q * 16, kws)
                for i in range(2):
                    _mma(acc[i, 2 * q], af[i], bf[0])
                    _mma(acc[i, 2 * q + 1], af[i], bf[1])
        part = _stored(acc, lambda i, r: wm * 32 + i * 16 + r,
                       lambda j, c: wn * (kbn // 2) + j * 8 + c, (bm, kbn))
        got = np.where(np.isnan(part), got, part)
    np.testing.assert_allclose(got, x @ w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dout", [64, 128])
def test_kernel_3_fragments_give_dx_and_dw(dout):
    # One 64-row chunk and one 64-column d_in slab: dx = g Wᵀ with A = g
    # (ldmatrix) and B = Wᵀ staged as W [c][o] (ldmatrix), 2 x 4 warps of
    # 32 rows x 32 columns of one bank; dW = Xᵀ g with A = Xᵀ staged as X
    # [rows][c] (ldmatrix.trans) and B = g (ldmatrix.trans), 4 x 2 warps of
    # 32 rows of [x_srcᵀ | x_dstᵀ] x dout / 2 columns.
    rng = np.random.default_rng(dout)
    bm, cs = 64, 64
    kgs, kxh, kws = dout + 8, cs + 8, dout + 8
    g = rng.standard_normal((bm, dout))
    x = [rng.standard_normal((bm, cs)) for _ in range(2)]
    w = [rng.standard_normal((cs, dout)) for _ in range(2)]
    gs, xs = _tile(g, kgs), [_tile(a, kxh) for a in x]
    wst = _tile(np.concatenate(w), kws)
    dx = [np.full((bm, cs), np.nan) for _ in range(2)]
    for warp in range(8):
        wm, wn = warp >> 2, warp & 3
        b, cb = wn >> 1, (wn & 1) * 32
        acc = np.zeros((2, 4, 32, 4))
        for kb in range(0, dout, 16):
            af = [_load_a(gs, (wm * 32 + i * 16) * kgs + kb, kgs) for i in range(2)]
            for q in range(2):
                bf = _load_b2(wst, (b * cs + cb + q * 16) * kws + kb, kws)
                for i in range(2):
                    _mma(acc[i, 2 * q], af[i], bf[0])
                    _mma(acc[i, 2 * q + 1], af[i], bf[1])
        part = _stored(acc, lambda i, r: wm * 32 + i * 16 + r,
                       lambda j, c: cb + j * 8 + c, (bm, cs))
        dx[b] = np.where(np.isnan(part), dx[b], part)
    for b in range(2):
        np.testing.assert_allclose(dx[b], g @ w[b].T, rtol=0, atol=1e-12)

    nw = dout // 16
    dw = [np.full((cs, dout), np.nan) for _ in range(2)]
    for warp in range(8):
        wm, wn = warp >> 1, warp & 1
        b = wm >> 1
        acc = np.zeros((2, nw, 32, 4))
        for kb in range(0, bm, 16):
            af = [_load_a_trans(xs[b], (wm & 1) * 32 + kb * kxh + i * 16, kxh)
                  for i in range(2)]
            for q in range(nw // 2):
                bf = _load_b2_trans(gs, wn * (dout // 2) + kb * kgs + q * 16, kgs)
                for i in range(2):
                    _mma(acc[i, 2 * q], af[i], bf[0])
                    _mma(acc[i, 2 * q + 1], af[i], bf[1])
        part = _stored(acc, lambda i, r: (wm & 1) * 32 + i * 16 + r,
                       lambda j, c: wn * (dout // 2) + j * 8 + c, (cs, dout))
        dw[b] = np.where(np.isnan(part), dw[b], part)
    for b in range(2):
        np.testing.assert_allclose(dw[b], x[b].T @ g, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dout", [64, 128])
def test_kernel_6_fragments_give_dw(dout):
    # One 64-row chunk, one 64-column d_in slab and one d_out slab of a
    # ring stage [X | G]: dW = Xᵀ g with A = Xᵀ staged as X [rows][c]
    # (ldmatrix.trans) and B = g [rows][o] (ldmatrix.trans); 2 x 2 warps of
    # 32 d_in rows x dout / 2 columns.
    rng = np.random.default_rng(dout + 1)
    bm, cs = 64, 64
    kxh, kgh = cs + 8, dout + 8
    x, g = rng.standard_normal((bm, cs)), rng.standard_normal((bm, dout))
    stage = np.concatenate([_tile(x, kxh), _tile(g, kgh)])
    g0 = bm * kxh  # G follows X in the stage
    nw = dout // 16
    got = np.full((cs, dout), np.nan)
    for warp in range(4):
        wm, wn = warp // 2, warp % 2
        cb, nb = wm * 32, wn * nw * 8
        acc = np.zeros((2, nw, 32, 4))
        for kb in range(0, bm, 16):
            af = [_load_a_trans(stage, kb * kxh + cb + i * 16, kxh) for i in range(2)]
            for q in range(nw // 2):
                bf = _load_b2_trans(stage, g0 + kb * kgh + nb + q * 16, kgh)
                for i in range(2):
                    _mma(acc[i, 2 * q], af[i], bf[0])
                    _mma(acc[i, 2 * q + 1], af[i], bf[1])
        part = _stored(acc, lambda i, r: cb + i * 16 + r, lambda j, c: nb + j * 8 + c,
                       (cs, dout))
        got = np.where(np.isnan(part), got, part)
    np.testing.assert_allclose(got, x.T @ g, rtol=0, atol=1e-12)
