"""The 3xTF32 arithmetic of kernels 2, 3, 5 and 6 (``csrc/tf32x3.cuh``), emulated
in torch on the CPU and held to the repository's f32 gates against float64.

Each f32 operand x splits into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``,
rounded to nearest (ties away from zero, as ``cvt.rna.tf32.f32``) by bit
operations. A product runs in 8-deep steps as the m16n8k8 tensor-core
instruction does: per step the three products ``lo·hi``, ``hi·lo``,
``hi·hi`` (TF32 products are exact) go into a zeroed f32 fragment, one
rounding each, and the fragment is added to the running f32 sum, as the
kernels do (``tf32x3::mma3_tile``). Kernel 3 keeps a relation's dW over
runs of 4 tiles (1,024 rows), kernel 6 over runs of 2 (512 rows), and
kernel 1 then adds the runs in f32, as emulated here. Kernel 5's products are kernel 2's with one bank (K =
d_in), the bias added to the sum in the epilogue. The card
tests (``tests/test_torch_cuda.py``) hold the real kernels to at most twice
the plain f32 version's float64 error; this file is the design's evidence
in the CPU lane, and shows that single-pass TF32 misses the same gates.
Imports no JAX.
"""

import numpy as np
import pytest
import torch

# The repo's f32 parity gate (CLAUDE.md:50-61): atol 3e-5, for sums of many
# terms after dividing by max(1, max|reference|).
GATE = 3e-5
RUN_ROWS = 1024  # kernel 3's runs of 4 tiles of 256 rows
DW_ROWS = 4352   # one xl relation: 17 tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 (10 explicit mantissa bits), ties away from
    zero, still stored as f32: add half a TF32 ulp to the magnitude bits,
    then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def tc_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3, acc=None) -> torch.Tensor:
    """``a @ b`` ([M, K] @ [K, N], f32) as tensor-core steps of 8: with
    ``passes=3`` the 3xTF32 split, small terms first; with ``passes=1``
    single-pass TF32 (``hi·hi``). ``acc``: an f32 accumulator to add into."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]
    acc = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc
    for k in range(0, a.shape[1], 8):
        step = torch.zeros_like(acc)
        for p, q in terms:
            step = (step.double() + p[:, k:k + 8].double() @ q[k:k + 8].double()).float()
        acc = acc + step
    return acc


def sequential_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` one k at a time in f32, each product and sum rounded."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def dw_by_runs(x: torch.Tensor, g: torch.Tensor, passes: int = 3,
               run_rows: int = RUN_ROWS) -> torch.Tensor:
    """``xᵀ g`` as kernels 3 and 6 take it: one tensor-core sum per run of
    ``run_rows`` rows, the runs' partials then added in f32."""
    total = torch.zeros(x.shape[1], g.shape[1])
    for r in range(0, x.shape[0], run_rows):
        total = total + tc_product(x[r:r + run_rows].T, g[r:r + run_rows], passes)
    return total


def _rng(seed):
    return np.random.default_rng(seed)


def _product_case(seed, d):
    """Kernel 2's product on one 256-row tile: [x_src | x_dst] against
    [W_msg ; W_self], K = 2d, weights at the init scale 1/sqrt(d)."""
    rng = _rng(seed)
    x = torch.from_numpy(rng.standard_normal((256, 2 * d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((2 * d, d)) / np.sqrt(d)).astype(np.float32))
    return x, w


def _one_bank_case(seed, d):
    """Kernel 5's product on one tile: x_src against W_msg, K = d, and the
    relation's bias."""
    x, w = _product_case(seed, d)
    bias = torch.from_numpy(_rng(seed + 1).standard_normal(d).astype(np.float32))
    return x[:, :d], w[:d], bias


def _dw_case(seed, d_in, d_out=None):
    rng = _rng(seed)
    x = torch.from_numpy(rng.standard_normal((DW_ROWS, d_in)).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal((DW_ROWS, d_out or d_in)).astype(np.float32))
    return x, g


def _err(got, ref, scaled=False):
    scale = max(1.0, ref.abs().max().item()) if scaled else 1.0
    return (got.double() - ref).abs().max().item() / scale


def test_tf32_rounds_to_nearest_by_its_bits():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                      1 + 3 * ulp / 4, 3.0e-38, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 3.0e-38, -0.0])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5])  # ties away from zero
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(got[6:].view(torch.int32), x[6:].view(torch.int32))


def test_split_keeps_21_bits():
    x = torch.from_numpy(_rng(0).standard_normal(100_000).astype(np.float32) * 10)
    hi, lo = split(x)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).eq(0).all()
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel


@pytest.mark.parametrize("d", [40, 64, 128])
def test_3xtf32_products_meet_the_gate(d):
    x, w = _product_case(d, d)
    ref = x.double() @ w.double()
    err = _err(tc_product(x, w), ref)
    assert err <= GATE, err
    # f32-class: no worse than twice one-k-at-a-time f32 on the same inputs.
    assert err <= 2 * _err(sequential_f32(x, w), ref), err


@pytest.mark.parametrize("d", [40, 64, 128])
def test_3xtf32_one_bank_products_with_the_bias_meet_the_gate(d):
    # Kernel 5: K = d_in, the bias added to the 3xTF32 sum in f32.
    x, w, bias = _one_bank_case(d, d)
    ref = x.double() @ w.double() + bias.double()
    err = _err(tc_product(x, w) + bias, ref)
    assert err <= GATE, err
    assert err <= 2 * _err(sequential_f32(x, w) + bias, ref), err


def _check_dw_by_runs(x, g, run_rows=RUN_ROWS):
    ref = x.double().T @ g.double()
    err = _err(dw_by_runs(x, g, run_rows=run_rows), ref, scaled=True)
    assert err <= GATE, err
    assert err <= 2 * _err(sequential_f32(x.T.contiguous(), g), ref, scaled=True), err


@pytest.mark.parametrize("d", [40, 64, 128])
def test_3xtf32_dw_sum_over_runs_meets_the_scaled_gate(d):
    _check_dw_by_runs(*_dw_case(100 + d, d))


@pytest.mark.parametrize("d_in,d_out", [(40, 72), (72, 40)])
def test_3xtf32_dw_sum_over_runs_at_two_widths(d_in, d_out):
    # Kernel 6 takes any d_in and d_out, in runs of 2 tiles: its dW against
    # a float64 sum.
    _check_dw_by_runs(*_dw_case(200 + d_in, d_in, d_out), run_rows=512)


@pytest.mark.parametrize("d", [64, 128])
def test_single_pass_tf32_misses_the_gates(d):
    x, w = _product_case(d, d)
    assert _err(tc_product(x, w, passes=1), x.double() @ w.double()) > GATE
    x, g = _dw_case(100 + d, d)
    assert _err(dw_by_runs(x, g, passes=1), x.double().T @ g.double(), scaled=True) > GATE
