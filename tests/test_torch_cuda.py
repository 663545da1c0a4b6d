"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no NVIDIA GPU. This file
imports no JAX, so it also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNN
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
    edge_transform_sorted_combined_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum
from torch_cases import edge_case, segment_case

pytestmark = pytest.mark.cuda

# Kernel 2: f32 dot products of at most 2 * 128 order-1 terms.
ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels run only there")
    return resolve_device(None)


def _check_csr(x, splits, n, dev):
    """Run the kernel twice: bitwise equal, and within f32 summation error
    of a float64 reference, 1e-5 + 1e-6 * sum(|x|) per segment (segments
    here reach 35,000 rows)."""
    xt, st = torch.from_numpy(x).to(dev), torch.from_numpy(splits).to(dev)
    a, b = csr_segment_sum(xt, st, n), csr_segment_sum(xt, st, n)
    torch.cuda.synchronize()
    assert torch.equal(a, b), "two runs differ"
    zero = np.zeros((1, x.shape[1]))
    lo, hi = splits[:n], splits[1 : n + 1]
    total = np.concatenate([zero, np.cumsum(x, axis=0, dtype=np.float64)])
    mass = np.concatenate([zero, np.cumsum(np.abs(x), axis=0, dtype=np.float64)])
    want, tol = total[hi] - total[lo], 1e-5 + 1e-6 * (mass[hi] - mass[lo])
    err = np.abs(a.cpu().numpy() - want)
    assert (err <= tol).all(), f"max error {err.max()}, over tolerance {(err - tol).max()}"
    return a


@pytest.mark.parametrize("d", [3, 64, 128, 256])
@pytest.mark.parametrize("skew", [False, True])
def test_csr_kernel_matches_plain_and_is_deterministic(dev, d, skew):
    # skew: segment 1 holds ~40% of the 5,000 rows, across several chunks.
    x, _, splits = segment_case(7, 5000, 300, d, skew)
    out = _check_csr(x, splits, 300, dev)
    assert not out[-3:].any()


@pytest.mark.parametrize(
    "e,n", [(100, 5000), (0, 7), (256, 1), (257, 2), (70_000, 64), (70_000, 3)]
)
def test_csr_kernel_edge_shapes(dev, e, n):
    # Mostly-empty segments, no rows, one segment, a row past one chunk,
    # segments spanning a few chunks, and over a hundred chunks.
    rng = np.random.default_rng(e + n)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    splits = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    x = rng.standard_normal((e, 64)).astype(np.float32)
    _check_csr(x, splits, n, dev)


def test_csr_kernel_reads_only_rows_inside_the_bounds(dev):
    x, _, splits = segment_case(8, 3000, 90, 64, True)
    junk = np.full((300, 64), 1e6, dtype=np.float32)
    padded = np.concatenate([junk, x, junk])
    shifted = (splits + 300).astype(np.int32)
    # The reference sums the same bounds of `padded`: a junk row summed in
    # would miss it by ~1e6.
    _check_csr(padded, shifted, 90, dev)


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_kernel_matches_plain(dev, d, tail_cut):
    args = [torch.from_numpy(a).to(dev) for a in edge_case(8, d, tail_cut)]
    got = edge_transform_sorted_combined(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.cpu(), edge_transform_sorted_combined_plain(*args).cpu(),
        rtol=0, atol=ATOL,
    )


def test_kernels_refuse_inputs_that_want_a_gradient(dev):
    args = [torch.from_numpy(a).to(dev) for a in edge_case(9, 16, 0)]
    args[3].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        edge_transform_sorted_combined(*args)
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        csr_segment_sum(x, torch.zeros(3, dtype=torch.int32, device=dev), 2)


def test_hypergnn_on_the_card_matches_the_cpu(dev):
    kg = ToyKnowledgeGraph()
    kernels.reset_launch_counts()
    on_card = HyperGNN(64, 16, 32, seed=3, device=None).eval()
    assert on_card.device.type == "cuda"
    got = on_card(kg.node_features, kg.edge_index, kg.edge_texts)
    assert csr_segment_sum.launches == edge_transform_sorted_combined.launches == 2
    want = HyperGNN(64, 16, 32, seed=3, device="cpu").eval()(
        kg.node_features, kg.edge_index, kg.edge_texts
    )
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=3e-5)
