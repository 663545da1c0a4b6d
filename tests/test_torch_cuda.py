"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no NVIDIA GPU. This file
imports no JAX, so it also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNN,
    HyperGNNConfig,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform import (
    edge_transform_sorted_combined,
    edge_transform_sorted_combined_plain,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import GROUP_PAD, RUN_TILES
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    edge_transform_combined_bwd,
    edge_transform_combined_bwd_plain,
    run_bounds,
    plan_runs,
    run_table,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer import (
    segment_outer,
    segment_outer_plain,
)
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import (
    csr_segment_sum,
    dual_sorted_segment_sum,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    relational_message_passing,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves, tree_map
from torch_cases import (
    CSR_CASES,
    csr_case,
    csr_lanes_per_row,
    edge_case,
    emulate_csr_segment_sum,
    run_case,
    segment_case,
)

pytestmark = pytest.mark.cuda

# Kernels 2, 3 and 5's products: f32 dot products of at most 2 * 128
# order-1 terms. Kernels 3 and 6's dW and the gradients: sums over hundreds
# of rows, compared after dividing by max(1, max|plain|).
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
    _check_sums(a, x, splits, n)
    return a


def _check_sums(a, x, splits, n):
    """``a`` within f32 summation error of the float64 segment sums."""
    zero = np.zeros((1, x.shape[1]))
    lo, hi = splits[:n], splits[1 : n + 1]
    total = np.concatenate([zero, np.cumsum(x, axis=0, dtype=np.float64)])
    mass = np.concatenate([zero, np.cumsum(np.abs(x), axis=0, dtype=np.float64)])
    want, tol = total[hi] - total[lo], 1e-5 + 1e-6 * (mass[hi] - mass[lo])
    err = np.abs(a.cpu().numpy() - want)
    assert (err <= tol).all(), f"max error {err.max()}, over tolerance {(err - tol).max()}"


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


def _csr_form_case(name, d, form, dev, seed=0):
    """Kernel 1's input in ``form`` at a named layout: ``(rows on dev,
    splits on dev, n, splits, rows as the kernel widens them, lanes a
    row)``."""
    rows, splits, n = csr_case(name, seed)
    x = np.random.default_rng(seed + d).standard_normal((rows, d)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    if form == "bf16":
        xt = xt.bfloat16()
    widened = (xt if form == "f32" else xt.bfloat16()).float().cpu().numpy()
    per16 = 8 if form == "bf16" else 4
    lanes = csr_lanes_per_row(d, per16 if d % per16 == 0 else 1)
    return xt, torch.from_numpy(splits).to(dev), n, splits, widened, lanes


@pytest.mark.parametrize("form", ["f32", "bf16", "fast"])
@pytest.mark.parametrize("d", [3, 64, 128, 256])
@pytest.mark.parametrize("name", CSR_CASES)
def test_csr_kernel_is_bitwise_its_partition_emulation(dev, name, d, form):
    # The one-launch kernel against torch_cases.emulate_csr_segment_sum:
    # the same partition and order of f32 sums, so the same bits; d=3 takes
    # the one-element loads, 256 two column windows.
    xt, st, n, splits, widened, lanes = _csr_form_case(name, d, form, dev)
    mode = "fast" if form == "fast" else "exact"
    kernels.reset_launch_counts()
    a, b = csr_segment_sum(xt, st, n, mode), csr_segment_sum(xt, st, n, mode)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches_by_form[form] == 2
    assert torch.equal(a, b), "two runs differ"
    want, _ = emulate_csr_segment_sum(widened, splits, n, lanes)
    assert torch.equal(a.cpu(), torch.from_numpy(want)), "not the emulation's bits"
    _check_sums(a, widened, splits, n)
    assert not a[torch.from_numpy(np.diff(splits[: n + 1]) == 0).to(dev)].any()


@pytest.mark.parametrize("form", ["f32", "bf16", "fast"])
def test_csr_kernels_over_two_layouts_in_turn(dev, form):
    # The ticket counters are one buffer per stream, left at zero by each
    # launch: layouts in turn, and kernel 7 between them, give the same bits.
    mode = "fast" if form == "fast" else "exact"
    a = _csr_form_case("pad_segment", 64, form, dev)
    b = _csr_form_case("dbias_like", 64, form, dev)
    first = [csr_segment_sum(t[0], t[1], t[2], mode) for t in (a, b)]
    dual = dual_sorted_segment_sum(a[0][: b[0].shape[0]], b[0], b[2], b[1], b[1], mode)
    again = [csr_segment_sum(t[0], t[1], t[2], mode) for t in (a, b, a)]
    dual_again = dual_sorted_segment_sum(a[0][: b[0].shape[0]], b[0], b[2], b[1], b[1], mode)
    torch.cuda.synchronize()
    for x, y in zip(first + first[:1], again):
        assert torch.equal(x, y), "a layout run before changed the result"
    assert all(torch.equal(x, y) for x, y in zip(dual, dual_again))
    assert torch.equal(dual[1], first[1])


@pytest.mark.parametrize("form", ["f32", "bf16", "fast"])
@pytest.mark.parametrize("name", ["pad_segment", "dbias_like", "splits0_positive", "all_empty",
                                  "long_empty_runs"])
def test_dual_kernel_is_bitwise_two_partition_emulations(dev, name, form):
    # Stream a at the named layout, stream b at random bounds over as many
    # rows: each stream is summed as kernel 1 sums it alone.
    xa, sa, n, splits_a, wa, lanes = _csr_form_case(name, 64, form, dev)
    rng = np.random.default_rng(3)
    ids = np.sort(rng.integers(0, n, xa.shape[0]))
    splits_b = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    xb = xa.flip(0).contiguous()
    mode = "fast" if form == "fast" else "exact"
    kernels.reset_launch_counts()
    got = dual_sorted_segment_sum(xa, xb, n, sa, torch.from_numpy(splits_b).to(dev), mode)
    torch.cuda.synchronize()
    assert kernels.dual_sorted_segment_sum.launches_by_form[form] == 1
    for out, x, splits in zip(got, (wa, wa[::-1].copy()), (splits_a, splits_b)):
        want, _ = emulate_csr_segment_sum(x, splits, n, lanes)
        assert torch.equal(out.cpu(), torch.from_numpy(want)), "not the emulation's bits"
        _check_sums(out, x, splits, n)


@pytest.mark.parametrize("form", ["f32", "bf16", "fast"])
def test_csr_kernel_over_a_million_segments_and_ten_rows(dev, form):
    # Ten rows in eight of a million segments (two hold two rows): the zero
    # blocks write 999,992 zero rows beside one row block. Exact against
    # the plain version on the CPU (a sum of at most two rows has one
    # order), every empty segment +0.0, twice the same bits.
    rng = np.random.default_rng(14)
    n = 1_000_000
    ids = np.sort(rng.choice(n, 8, replace=False))
    ids = np.sort(np.concatenate([ids, ids[[2, 5]]]))
    splits = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((10, 64)).astype(np.float32))
    if form == "bf16":
        x = x.bfloat16()
    mode = "fast" if form == "fast" else "exact"
    xt, st = x.to(dev), torch.from_numpy(splits).to(dev)
    kernels.reset_launch_counts()
    a, b = csr_segment_sum(xt, st, n, mode), csr_segment_sum(xt, st, n, mode)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches_by_form[form] == 2
    assert torch.equal(a, b), "two runs differ"
    want = kernels.csr_segment_sum_plain(x, torch.from_numpy(splits), n, mode)
    assert torch.equal(a.cpu(), want), "not the plain version's sums"
    empty = torch.from_numpy(np.diff(splits) == 0).to(dev)
    assert int(empty.sum()) == n - 8
    assert not a[empty].any() and not a[empty].signbit().any()


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
    # The raw launches record nothing for autograd and refuse such inputs;
    # the combined transform is differentiable and takes them.
    args = [torch.from_numpy(a).to(dev) for a in edge_case(9, 16, 0)]
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="differentiable entry points"):
        csr_segment_sum(x, torch.zeros(3, dtype=torch.int32, device=dev), 2)
    g = torch.ones_like(args[0], requires_grad=True)
    with pytest.raises(NotImplementedError, match="differentiable entry points"):
        edge_transform_combined_bwd(g, *args[:5])
    args[3].requires_grad_(True)
    out = edge_transform_sorted_combined(*args)
    out.sum().backward()
    assert args[3].grad is not None and args[3].grad.shape == args[3].shape


def _close_scaled(got, want, msg):
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=ATOL, msg=msg)


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_kernel_matches_plain(dev, d, tail_cut):
    xs, xd, rel, wm, ws, _ = (torch.from_numpy(a).to(dev) for a in edge_case(10, d, tail_cut))
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(d)).to(dev)
    kernels.reset_launch_counts()
    got = edge_transform_combined_bwd(g, xs, xd, rel, wm, ws)
    again = edge_transform_combined_bwd(g, xs, xd, rel, wm, ws)
    torch.cuda.synchronize()
    assert edge_transform_combined_bwd.launches == 2
    # dW is reduced inside kernel 3; without a plan each call builds its
    # run table in one launch.
    assert csr_segment_sum.launches == 0 and kernels.run_table.launches == 2
    want = edge_transform_combined_bwd_plain(g, xs, xd, rel, wm, ws)
    for name, a, b, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), got, again, want):
        assert torch.equal(a, b), f"{name}: two runs differ"
        _close_scaled(a.cpu(), w.cpu(), name)
    for dw in got[2:]:
        assert not dw[6:].any(), "relations without rows must be exactly zero"


_WIDTHS = [(40, 40), (64, 64), (128, 128), (16, 40), (128, 64)]


def _errors_against_float64(fn, plain, args, scaled=()):
    """Max errors of ``fn(*args)`` and ``plain(*args)`` against ``plain`` in
    float64 on the same inputs, one pair per output (outputs in ``scaled``
    after dividing by max(1, max|reference|))."""
    got, want = fn(*args), plain(*args)
    ref = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args))
    if isinstance(got, torch.Tensor):
        got, want, ref = (got,), (want,), (ref,)
    errs = []
    for i, (a, w, r) in enumerate(zip(got, want, ref)):
        scale = max(1.0, r.abs().max().item()) if i in scaled else 1.0
        errs.append(((a.double() - r).abs().max().item() / scale,
                     (w.double() - r).abs().max().item() / scale))
    return errs


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
def test_edge_transform_kernel_float64_error_within_twice_plain(dev, d_in, d_out):
    # 3xTF32 on the tensor cores is held to f32's own error: against a
    # float64 reference, at most twice that of the plain f32 version.
    args = [torch.from_numpy(a).to(dev) for a in run_case(16, d_in, d_out, 100)]
    [(err, plain_err)] = _errors_against_float64(
        edge_transform_sorted_combined, edge_transform_sorted_combined_plain, args)
    assert err <= 2 * plain_err, (err, plain_err)


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
def test_edge_transform_bwd_kernel_float64_error_within_twice_plain(dev, d_in, d_out):
    xs, xd, rel, wm, ws, _ = (torch.from_numpy(a).to(dev) for a in run_case(17, d_in, d_out, 0))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(3)).to(dev)
    errs = _errors_against_float64(
        edge_transform_combined_bwd, edge_transform_combined_bwd_plain,
        (g, xs, xd, rel, wm, ws), scaled=(2, 3))
    for name, (err, plain_err) in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), errs):
        assert err <= 2 * plain_err, (name, err, plain_err)


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
def test_edge_transform_sorted_kernel_float64_error_within_twice_plain(dev, d_in, d_out):
    # Kernel 5, output by output, on the tensor cores in 3xTF32.
    args = [torch.from_numpy(a).to(dev) for a in run_case(21, d_in, d_out, 100)]
    errs = _errors_against_float64(
        kernels.edge_transform_sorted, kernels.edge_transform_sorted_plain, args)
    for name, (err, plain_err) in zip(("msg", "selfc"), errs):
        assert err <= 2 * plain_err, (name, err, plain_err)


@pytest.mark.parametrize("d_in,d_out", _WIDTHS)
def test_segment_outer_kernel_float64_error_within_twice_plain(dev, d_in, d_out):
    # Kernel 6's dW sums hundreds of rows: compared after scaling.
    xs, _, rel, *_ = (torch.from_numpy(a).to(dev) for a in run_case(22, d_in, d_out, 0))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(5)).to(dev)
    [(err, plain_err)] = _errors_against_float64(
        segment_outer, segment_outer_plain, (xs, g, rel, 8), scaled=(0,))
    assert err <= 2 * plain_err, (err, plain_err)


_RUN_WIDTHS = [(64, 64), (128, 128), (36, 30), (32, 200)]


@pytest.mark.parametrize("d_in,d_out", _RUN_WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_two_output_kernels_over_runs_of_tiles(dev, d_in, d_out, tail_cut):
    # Kernel 6 over runs of RUN_TILES tiles (relations of 5, 4, 9 and 1
    # tiles: full and ragged runs) and kernel 5 on the same rows. 36 -> 30
    # takes the 4-byte copies; d_out = 200 two column slabs of both.
    xs, xd, rel, wm, ws, b = (
        torch.from_numpy(a).to(dev) for a in run_case(23, d_in, d_out, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(6)).to(dev)
    kernels.reset_launch_counts()
    outs = kernels.edge_transform_sorted(xs, xd, rel, wm, ws, b)
    got, again = segment_outer(xs, g, rel, 8), segment_outer(xs, g, rel, 8)
    torch.cuda.synchronize()
    assert kernels.edge_transform_sorted.launches == 1
    assert segment_outer.launches == 2 and csr_segment_sum.launches == 0
    for name, a, w in zip(("msg", "selfc"), outs,
                          kernels.edge_transform_sorted_plain(xs, xd, rel, wm, ws, b)):
        torch.testing.assert_close(a.cpu(), w.cpu(), rtol=0, atol=ATOL, msg=name)
    assert torch.equal(got, again), "two runs differ"
    assert not got[[4, 6, 7]].any(), "relations without rows must be exactly zero"
    _close_scaled(got.cpu(), segment_outer_plain(xs, g, rel, 8).cpu(), "dW")


@pytest.mark.parametrize("d_in,d_out", _RUN_WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_kernels_over_runs_of_tiles(dev, d_in, d_out, tail_cut):
    # Relations of 5, 4, 9 and 1 tiles: kernel 3's runs of RUN_TILES tiles,
    # full and ragged, summed per relation. 36 -> 30 takes the 4-byte
    # copies; d_out = 200 two column slabs (kernel 2) and two passes over
    # each run (kernel 3).
    xs, xd, rel, wm, ws, b = (
        torch.from_numpy(a).to(dev) for a in run_case(18, d_in, d_out, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(4)).to(dev)
    kernels.reset_launch_counts()
    out = edge_transform_sorted_combined(xs, xd, rel, wm, ws, b)
    got = edge_transform_combined_bwd(g, xs, xd, rel, wm, ws)
    again = edge_transform_combined_bwd(g, xs, xd, rel, wm, ws)
    torch.cuda.synchronize()
    assert edge_transform_sorted_combined.launches == 1
    assert edge_transform_combined_bwd.launches == 2 and csr_segment_sum.launches == 0
    torch.testing.assert_close(
        out.cpu(), edge_transform_sorted_combined_plain(xs, xd, rel, wm, ws, b).cpu(),
        rtol=0, atol=ATOL)
    want = edge_transform_combined_bwd_plain(g, xs, xd, rel, wm, ws)
    for name, a, b2, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), got, again, want):
        assert torch.equal(a, b2), f"{name}: two runs differ"
        _close_scaled(a.cpu(), w.cpu(), name)
    for dw in got[2:]:
        assert not dw[[4, 6, 7]].any(), "relations without rows must be exactly zero"


def test_training_step_on_the_card_matches_the_cpu(dev):
    kg = ToyKnowledgeGraph()
    graph = encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes,
                         sort_by_relation=True, with_sort_plan=True, group_pad=256)
    cfg = HyperGNNConfig(64, 16, 32, rel_sorted=True, group_padded=True)
    init = init_hypergnn(cfg, torch.Generator().manual_seed(4))
    lr, runs = 1e-3, []
    for device in (dev, torch.device("cpu")):
        state = create_train_state(tree_map(lambda t: t.to(device), init), adam(lr))
        feats = torch.as_tensor(kg.node_features, dtype=torch.float32, device=device)
        arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
        kernels.reset_launch_counts()
        params, _, loss = make_train_step(cfg, neg_mode="roll")(
            state.params, state.opt_state, feats, *arrays,
            torch.Generator(device=device), neg_dst=3,
            sort_plan=graph.sort_plan.to(device))
        if device.type == "cuda":
            # One step at 2 layers: kernel 1 in 2 forward tails, per layer 2
            # gather cotangents + dbias, and 2 in the loss; kernel 3 reduces
            # its dW itself, over the plan's run table.
            launches = (csr_segment_sum.launches,
                        edge_transform_sorted_combined.launches,
                        edge_transform_combined_bwd.launches,
                        kernels.run_table.launches)
            assert launches == (10, 2, 2, 0)
        runs.append((loss.item(), {p: (t.detach().cpu(), t.grad.cpu())
                                   for p, t in named_leaves(params)}))
    (l_card, card), (l_cpu, cpu) = runs
    assert abs(l_card - l_cpu) <= 1e-5 * max(1.0, abs(l_cpu))
    for path, (p_cpu, g_cpu) in cpu.items():
        _close_scaled(card[path][1], g_cpu, f"grad {path}")
        # Adam's first step is about lr·sign(g); a gradient at rounding
        # noise may take the other sign on the card: at most 2·lr apart.
        torch.testing.assert_close(card[path][0], p_cpu, rtol=0, atol=2 * lr, msg=path)


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


@pytest.mark.parametrize("d_in,d_out", [(40, 40), (64, 64), (128, 128), (16, 40), (128, 64)])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_sorted_kernel_and_its_backward_match_plain(dev, d_in, d_out, tail_cut):
    # Kernel 5 forward, then its backward: kernel 5 on the cotangents with
    # the banks transposed (d_in and d_out swap), kernel 6 twice (each
    # reducing its own dW), kernel 1 for dbias.
    arrays = edge_case(11, d_in, tail_cut, d_out)
    g = torch.randn((2, arrays[0].shape[0], d_out), generator=torch.Generator().manual_seed(1))
    runs = []
    for device in (dev, torch.device("cpu")):
        xs, xd, rel, wm, ws, b = (torch.from_numpy(a).to(device) for a in arrays)
        leaves = [t.requires_grad_(True) for t in (xs, xd, wm, ws, b)]
        kernels.reset_launch_counts()
        outs = kernels.edge_transform_sorted(xs, xd, rel, wm, ws, b)
        torch.autograd.backward(outs, [t.to(device) for t in g])
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.edge_transform_sorted.launches == 2
            assert segment_outer.launches == 2
            assert csr_segment_sum.launches == 1
        runs.append(([o.detach().cpu() for o in outs], [t.grad.cpu() for t in leaves]))
    (outs, grads), (outs_cpu, grads_cpu) = runs
    for name, a, w in zip(("msg", "selfc"), outs, outs_cpu):
        torch.testing.assert_close(a, w, rtol=0, atol=ATOL, msg=name)
    for name, a, w in zip(("x_src", "x_dst", "w_msg", "w_self", "bias"), grads, grads_cpu):
        _close_scaled(a, w, name)


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (128, 128), (40, 72)])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_segment_outer_kernel_matches_plain(dev, d_in, d_out, tail_cut):
    xs, _, rel, *_ = (torch.from_numpy(a).to(dev) for a in edge_case(12, d_in, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels.reset_launch_counts()
    got, again = segment_outer(xs, g, rel, 8), segment_outer(xs, g, rel, 8)
    torch.cuda.synchronize()
    assert segment_outer.launches == 2 and csr_segment_sum.launches == 0
    assert torch.equal(got, again), "two runs differ"
    assert not got[6:].any(), "relations without rows must be exactly zero"
    _close_scaled(got.cpu(), segment_outer_plain(xs, g, rel, 8).cpu(), "dW")


@pytest.mark.parametrize("d", [3, 64, 128])
@pytest.mark.parametrize("skew", [False, True])
def test_dual_kernel_matches_plain_and_is_deterministic(dev, d, skew):
    # Stream a as kernel 1's tests draw it; stream b with its own bounds.
    xa, _, sa = segment_case(13, 5000, 300, d, skew)
    xb, _, sb = segment_case(14, 5000, 300, d, not skew)
    t = [torch.from_numpy(a).to(dev) for a in (xa, xb, sa, sb)]
    kernels.reset_launch_counts()
    got = dual_sorted_segment_sum(t[0], t[1], 300, t[2], t[3])
    again = dual_sorted_segment_sum(t[0], t[1], 300, t[2], t[3])
    torch.cuda.synchronize()
    assert kernels.dual_sorted_segment_sum.launches == 2
    assert csr_segment_sum.launches == 0
    for a, b, x, splits in zip(got, again, (xa, xb), (sa, sb)):
        assert torch.equal(a, b), "two runs differ"
        _check_sums(a, x, splits, 300)
        assert not a[-3:].any()


def test_dual_kernel_refuses_inputs_that_want_a_gradient(dev):
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    splits = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="differentiable entry points"):
        dual_sorted_segment_sum(x, x.detach(), 2, splits, splits)


def _toy_layer_inputs(device, layout, d=32):
    kg = ToyKnowledgeGraph()
    graph = encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, **layout)
    rng = np.random.default_rng(15)
    u_pad = graph.char_ids.shape[0]
    h, wm, ws, b = (
        torch.from_numpy(a.astype(np.float32)).to(device).requires_grad_(True)
        for a in (rng.standard_normal((kg.num_nodes, d)),
                  rng.standard_normal((u_pad, d, d)) / d**0.5,
                  rng.standard_normal((u_pad, d, d)) / d**0.5,
                  rng.standard_normal((u_pad, d)))
    )
    arrays = [torch.as_tensor(a, device=device) for a in graph.arrays[:4]]
    plan = None if graph.sort_plan is None else graph.sort_plan.to(device)
    r = torch.from_numpy(rng.standard_normal((kg.num_nodes, d)).astype(np.float32)).to(device)
    return (h, wm, ws, b), arrays, plan, r


_PADDED = dict(sort_by_relation=True, with_sort_plan=True, group_pad=256)


def test_two_stream_layer_on_the_card_matches_the_cuda_backend(dev):
    # Kernels 5 and 6 checked by kernels 2 and 3 on the same layer.
    runs = []
    for two_stream in (True, False):
        leaves, (src, dst, rel, mask), plan, r = _toy_layer_inputs(dev, _PADDED)
        h, wm, ws, b = leaves
        if two_stream:
            msg, selfc = kernels.edge_contributions_cuda_sorted(
                h, src, dst, rel, wm, ws, b, sort_plan=plan)
            out = two_stream_tail(msg, selfc, dst, h.shape[0], edge_mask=mask,
                                  sort_plan=plan)
        else:
            out = relational_message_passing(
                h, src, dst, rel, wm, ws, b, edge_mask=mask, backend="cuda",
                rel_sorted=True, group_padded=True, sort_plan=plan)
        (out * r).sum().backward()
        runs.append((out.detach().cpu(), [t.grad.cpu() for t in leaves]))
    (out, grads), (ref, ref_grads) = runs
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-5)
    for name, a, w in zip(("h", "w_msg", "w_self", "bias"), grads, ref_grads):
        _close_scaled(a, w, name)


@pytest.mark.parametrize("backend,layout", [
    ("dense", dict(sort_by_relation=False)),
    ("grouped", dict(sort_by_relation=False)),
    ("grouped", dict(sort_by_relation=True, with_sort_plan=True)),
    ("chunked", dict(sort_by_relation=False)),
])
def test_backends_on_the_card_match_the_cpu(dev, backend, layout):
    runs = []
    for device in (dev, torch.device("cpu")):
        leaves, (src, dst, rel, mask), plan, r = _toy_layer_inputs(device, layout)
        out = relational_message_passing(
            *leaves[:1], src, dst, rel, *leaves[1:], edge_mask=mask, backend=backend,
            rel_sorted=layout["sort_by_relation"], sort_plan=plan)
        (out * r).sum().backward()
        runs.append((out.detach().cpu(), [t.grad.cpu() for t in leaves]))
    (out, grads), (ref, ref_grads) = runs
    torch.testing.assert_close(out, ref, rtol=0, atol=3e-5)
    for name, a, w in zip(("h", "w_msg", "w_self", "bias"), grads, ref_grads):
        _close_scaled(a, w, name)


# ---------------------------------------------------------------------------
# Speed mode: the bf16 forms of kernels 1, 2 and 3, and the one-TF32-pass
# mode of kernels 2 and 3 (precision="default").
# ---------------------------------------------------------------------------

# One bf16 ulp of the largest value: the kernel and its plain version sum
# the same exact f32 products in another order, so an element may round to
# either neighbour.
BF16_ULP = 2.0**-7
# One TF32 pass keeps 11 bits of each operand: bf16-class, against float64.
ONE_PASS_SCALED = 4e-3


def _within_ulp(got, want, msg):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_ULP * want.float().abs().max().item(), (msg, err)


@pytest.mark.parametrize("d", [3, 64, 128])
@pytest.mark.parametrize("skew", [False, True])
def test_csr_kernel_bf16_form_matches_plain_and_is_deterministic(dev, d, skew):
    # d=3 takes the 2-byte loads, 64 and 128 the 16-byte ones.
    x, _, splits = segment_case(31, 5000, 300, d, skew)
    xt = torch.from_numpy(x).to(dev).bfloat16()
    st = torch.from_numpy(splits).to(dev)
    kernels.reset_launch_counts()
    a, b = csr_segment_sum(xt, st, 300), csr_segment_sum(xt, st, 300)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches_by_form == {"f32": 0, "tf32": 0, "bf16": 2, "fast": 0}
    assert a.dtype == torch.float32 and torch.equal(a, b), "two runs differ"
    _check_sums(a, xt.float().cpu().numpy(), splits, 300)
    assert not a[-3:].any()


_BF16_WIDTHS = [(64, 64), (128, 128), (16, 40), (128, 64), (36, 30)]


@pytest.mark.parametrize("d_in,d_out", _BF16_WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_kernel_bf16_form_matches_plain(dev, d_in, d_out, tail_cut):
    # 36 -> 30 takes the 2-byte copies; the rest the 16-byte ones.
    args = [torch.from_numpy(a).to(dev) for a in run_case(24, d_in, d_out, tail_cut)]
    args = [a.bfloat16() if a.is_floating_point() else a for a in args]
    kernels.reset_launch_counts()
    got = edge_transform_sorted_combined(*args)
    torch.cuda.synchronize()
    assert edge_transform_sorted_combined.launches_by_form["bf16"] == 1
    assert got.dtype == torch.bfloat16
    _within_ulp(got.cpu(), edge_transform_sorted_combined_plain(*args).cpu(), "out")


@pytest.mark.parametrize("d_in,d_out", _BF16_WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_kernel_bf16_form_matches_plain(dev, d_in, d_out, tail_cut):
    xs, xd, rel, wm, ws, _ = (torch.from_numpy(a).to(dev)
                              for a in run_case(25, d_in, d_out, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(7))
    args = [t.to(dev).bfloat16() if t.is_floating_point() else t
            for t in (g, xs, xd, rel, wm, ws)]
    kernels.reset_launch_counts()
    got = edge_transform_combined_bwd(*args)
    again = edge_transform_combined_bwd(*args)
    torch.cuda.synchronize()
    assert edge_transform_combined_bwd.launches_by_form["bf16"] == 2
    assert csr_segment_sum.launches == 0  # dW is reduced inside kernel 3
    want = edge_transform_combined_bwd_plain(*args)
    for name, a, b, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), got, again, want):
        assert torch.equal(a, b), f"{name}: two runs differ"
        assert a.dtype == w.dtype, name
    for name, a, w in zip(("dx_src", "dx_dst"), got[:2], want[:2]):
        _within_ulp(a.cpu(), w.cpu(), name)
    for name, a, w in zip(("dW_msg", "dW_self"), got[2:], want[2:]):
        _close_scaled(a.cpu(), w.cpu(), name)
        assert not a[[4, 6, 7]].any(), "relations without rows must be exactly zero"


def test_bf16_forms_refuse_mixed_dtypes_and_kernel_5(dev):
    # Kernels 2 and 5 (which takes bf16 since kernel 5's bf16 form), 6 and 7
    # take one dtype across their data operands and refuse a mix.
    args = [torch.from_numpy(a).to(dev) for a in edge_case(26, 16, 0)]
    mixed = [a.bfloat16() if i in (0, 1) else a for i, a in enumerate(args)]
    for fn in (edge_transform_sorted_combined, kernels.edge_transform_sorted):
        with pytest.raises(TypeError, match="dtype"):
            fn(*mixed)
    with pytest.raises(TypeError, match="dtype"):
        segment_outer(args[0].bfloat16(), args[1], args[2], 8)
    splits = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        dual_sorted_segment_sum(x.bfloat16(), x, 2, splits, splits)
    bf16 = [a.bfloat16() if a.is_floating_point() else a for a in args]
    kernels.reset_launch_counts()
    msg, selfc = kernels.edge_transform_sorted(*bf16)
    assert msg.dtype == selfc.dtype == torch.bfloat16
    assert kernels.edge_transform_sorted.launches_by_form["bf16"] == 1


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (128, 128), (40, 72)])
def test_one_tf32_pass_modes_are_bf16_class(dev, d_in, d_out):
    # precision="default": kernels 2 and 3 in one TF32 pass, held against a
    # float64 reference after dividing by max(1, max|reference|).
    xs, xd, rel, wm, ws, b = (torch.from_numpy(a).to(dev)
                              for a in run_case(27, d_in, d_out, 100))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(8)).to(dev)
    kernels.reset_launch_counts()
    [(err2, _)] = _errors_against_float64(
        lambda *a: edge_transform_sorted_combined(*a, precision="default"),
        edge_transform_sorted_combined_plain, (xs, xd, rel, wm, ws, b), scaled=(0,))
    errs3 = _errors_against_float64(
        lambda *a: edge_transform_combined_bwd(*a, precision="default"),
        edge_transform_combined_bwd_plain, (g, xs, xd, rel, wm, ws), scaled=(0, 1, 2, 3))
    assert edge_transform_sorted_combined.launches_by_form["tf32"] == 1
    assert edge_transform_combined_bwd.launches_by_form["tf32"] == 1
    assert err2 < ONE_PASS_SCALED, err2
    for name, (err, _) in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), errs3):
        assert err < ONE_PASS_SCALED, (name, err)
    # Genuinely one pass: well above 3xTF32's f32-class error.
    assert err2 > 1e-6


@pytest.mark.parametrize("mode", [dict(compute_dtype="bfloat16"), dict(precision="default")])
def test_speed_mode_training_step_on_the_card_matches_the_cpu(dev, mode):
    kg = ToyKnowledgeGraph()
    graph = encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes,
                         sort_by_relation=True, with_sort_plan=True, group_pad=256)
    cfg = HyperGNNConfig(64, 16, 32, rel_sorted=True, group_padded=True, **mode)
    init = init_hypergnn(cfg, torch.Generator().manual_seed(4))
    runs = []
    for device in (dev, torch.device("cpu")):
        state = create_train_state(tree_map(lambda t: t.to(device), init), adam(1e-3))
        feats = torch.as_tensor(kg.node_features, dtype=torch.float32, device=device)
        arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
        kernels.reset_launch_counts()
        params, _, loss = make_train_step(cfg, neg_mode="roll")(
            state.params, state.opt_state, feats, *arrays,
            torch.Generator(device=device), neg_dst=3,
            sort_plan=graph.sort_plan.to(device))
        if device.type == "cuda":
            form = "bf16" if "compute_dtype" in mode else "tf32"
            # Per layer kernel 1 in the tail, the two gather cotangents and
            # dbias (bf16 rows in speed mode); 2 in the f32 loss backward.
            k1 = {"f32": 10, "tf32": 0, "bf16": 0, "fast": 0}
            if form == "bf16":
                k1 = {"f32": 2, "tf32": 0, "bf16": 8, "fast": 0}
            assert csr_segment_sum.launches_by_form == k1
            for fn in (edge_transform_sorted_combined, edge_transform_combined_bwd):
                assert fn.launches_by_form[form] == fn.launches == 2
        assert loss.dtype == torch.float32
        runs.append((loss.item(), {p: t.grad.detach().cpu().double().flatten()
                                   for p, t in named_leaves(params)}))
    (l_card, card), (l_cpu, cpu) = runs
    assert abs(l_card - l_cpu) <= 1e-2 * max(1.0, abs(l_cpu))
    a = torch.cat([card[p] for p in sorted(cpu)])
    b = torch.cat([cpu[p] for p in sorted(cpu)])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.999


# ---------------------------------------------------------------------------
# The last forms: kernels 5 and 6 in bf16 and in one TF32 pass (the
# two-stream path in speed mode), kernel 7 on bf16 rows, mode="fast" of
# kernels 1 and 7.
# ---------------------------------------------------------------------------

_TWO_WIDTHS = [(64, 64), (128, 128), (40, 72), (72, 40), (128, 64), (36, 30)]


@pytest.mark.parametrize("d_in,d_out", _TWO_WIDTHS)
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_sorted_kernel_bf16_form_matches_plain(dev, d_in, d_out, tail_cut):
    # Kernel 5's bf16 form, both outputs; d_in and d_out free both ways (its
    # backward's dx runs it transposed); 36 -> 30 takes the 2-byte copies.
    args = [torch.from_numpy(a).to(dev) for a in run_case(28, d_in, d_out, tail_cut)]
    args = [a.bfloat16() if a.is_floating_point() else a for a in args]
    kernels.reset_launch_counts()
    got = kernels.edge_transform_sorted(*args)
    torch.cuda.synchronize()
    assert kernels.edge_transform_sorted.launches_by_form["bf16"] == 1
    for name, a, w in zip(("msg", "selfc"), got, kernels.edge_transform_sorted_plain(*args)):
        assert a.dtype == torch.bfloat16, name
        _within_ulp(a.cpu(), w.cpu(), name)


@pytest.mark.parametrize("d_out", [40, 64, 128, 192])
@pytest.mark.parametrize("tail_cut", [0, 100])
@pytest.mark.parametrize("kernel", ["combined", "two", "two_transposed_banks"])
def test_bf16_transform_body_stages_every_slab_width(dev, d_out, tail_cut, kernel):
    # Kernels 2 and 5's bf16 body stores its output tile through shared
    # memory in 16-byte row pieces (one 64-column slab, one 128, or two at
    # 192): within one ulp of the plain version and the same bits twice;
    # kernel 5 also as its backward's dx runs it, on cotangents [E, d_out]
    # through the banks transposed to [U, d_out, 64] with a zero bias.
    xs, xd, rel, wm, ws, b = (torch.from_numpy(a).to(dev)
                              for a in run_case(29, 64, d_out, tail_cut))
    if kernel == "two_transposed_banks":
        gen = torch.Generator().manual_seed(d_out)
        xs, xd = (torch.randn((rel.shape[0], d_out), generator=gen).to(dev) for _ in range(2))
        wm, ws = (w.transpose(1, 2).contiguous() for w in (wm, ws))
        b = torch.zeros((b.shape[0], 64), device=dev)
    args = [t.bfloat16() if t.is_floating_point() else t for t in (xs, xd, rel, wm, ws, b)]
    fn, plain = ((edge_transform_sorted_combined, edge_transform_sorted_combined_plain)
                 if kernel == "combined"
                 else (kernels.edge_transform_sorted, kernels.edge_transform_sorted_plain))
    kernels.reset_launch_counts()
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches_by_form["bf16"] == 2
    got, again, want = ((t,) if kernel == "combined" else t
                        for t in (got, again, plain(*args)))
    for a, a2, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, a2)
        _within_ulp(a.cpu(), w.cpu(), kernel)


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (128, 128), (40, 72), (36, 30), (32, 200)])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_segment_outer_kernel_bf16_form_matches_plain(dev, d_in, d_out, tail_cut):
    # Kernel 6's bf16 form over runs of tiles: f32 dW within the f32 gate,
    # bitwise deterministic, exactly 0 for relations without rows; 36 -> 30
    # takes the 2-byte copies, d_out = 200 two column slabs.
    xs, _, rel, *_ = (torch.from_numpy(a).to(dev) for a in run_case(29, d_in, d_out, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(9))
    xs, g = xs.bfloat16(), g.to(dev).bfloat16()
    kernels.reset_launch_counts()
    got, again = segment_outer(xs, g, rel, 8), segment_outer(xs, g, rel, 8)
    torch.cuda.synchronize()
    assert segment_outer.launches_by_form["bf16"] == 2
    assert csr_segment_sum.launches == 0  # dW is reduced inside kernel 6
    assert got.dtype == torch.float32 and torch.equal(got, again), "two runs differ"
    assert not got[[4, 6, 7]].any(), "relations without rows must be exactly zero"
    _close_scaled(got.cpu(), segment_outer_plain(xs, g, rel, 8).cpu(), "dW")


@pytest.mark.parametrize("d_in,d_out", [(64, 64), (128, 128), (40, 72)])
def test_two_stream_one_tf32_pass_modes_are_bf16_class(dev, d_in, d_out):
    # precision="default": kernels 5 and 6 in one TF32 pass, held against a
    # float64 reference after dividing by max(1, max|reference|).
    xs, xd, rel, wm, ws, b = (torch.from_numpy(a).to(dev)
                              for a in run_case(30, d_in, d_out, 100))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(10)).to(dev)
    kernels.reset_launch_counts()
    errs5 = _errors_against_float64(
        lambda *a: kernels.edge_transform_sorted(*a, precision="default"),
        kernels.edge_transform_sorted_plain, (xs, xd, rel, wm, ws, b), scaled=(0, 1))
    [(err6, _)] = _errors_against_float64(
        lambda *a: segment_outer(*a, precision="default"),
        segment_outer_plain, (xs, g, rel, 8), scaled=(0,))
    assert kernels.edge_transform_sorted.launches_by_form["tf32"] == 1
    assert segment_outer.launches_by_form["tf32"] == 1
    for name, err in (("msg", errs5[0][0]), ("selfc", errs5[1][0]), ("dW", err6)):
        assert 1e-6 < err < ONE_PASS_SCALED, (name, err)  # one pass, bf16-class


@pytest.mark.parametrize("kernel,form", [("K1", "fast"), ("K7", "bf16"), ("K7", "fast")])
@pytest.mark.parametrize("d", [3, 64, 128])
def test_segment_sum_kernel_forms_match_plain_and_are_deterministic(dev, kernel, form, d):
    # The rows each form sums: bf16 rows, or f32 rows rounded to bf16 as
    # they are read (mode="fast"), summed in f32; d=3 takes the one-element
    # loads.
    xa, _, sa = segment_case(32, 5000, 300, d, True)
    xb, _, sb = segment_case(33, 5000, 300, d, False)
    mode = "fast" if form == "fast" else "exact"
    t = [torch.from_numpy(a).to(dev) for a in (xa, xb, sa, sb)]
    if form == "bf16":
        t[:2] = [a.bfloat16() for a in t[:2]]
    kernels.reset_launch_counts()
    if kernel == "K1":
        got, again = [csr_segment_sum(t[0], t[2], 300, mode=mode) for _ in range(2)]
        got, again = [got], [again]
    else:
        got = dual_sorted_segment_sum(*t[:2], 300, *t[2:], mode=mode)
        again = dual_sorted_segment_sum(*t[:2], 300, *t[2:], mode=mode)
    torch.cuda.synchronize()
    fn = csr_segment_sum if kernel == "K1" else dual_sorted_segment_sum
    assert fn.launches_by_form[form] == fn.launches == 2
    for a, b, x, splits in zip(got, again, (xa, xb), (sa, sb)):
        assert a.dtype == torch.float32 and torch.equal(a, b), "two runs differ"
        _check_sums(a, torch.from_numpy(x).bfloat16().float().numpy(), splits, 300)
        assert not a[-3:].any()


@pytest.mark.parametrize("mode", ["bf16", "default"])
def test_two_stream_layer_forms_on_the_card_match_the_cuda_backend(dev, mode):
    # The two-stream path in speed mode (bf16 h, banks and bias, cast from
    # the f32 leaves as the cuda backend's compute_dtype casts them) or in
    # one TF32 pass, against the cuda backend's layer: in speed mode in the
    # same form (the oracle gates: 1e-2 scaled, gradient cosine > 0.999),
    # in one pass against its f32 layer (4e-3 scaled).
    speed = mode == "bf16"
    runs = []
    for two_stream in (True, False):
        leaves, (src, dst, rel, mask), plan, r = _toy_layer_inputs(dev, _PADDED)
        kernels.reset_launch_counts()
        if two_stream:
            h, wm, ws, b = (t.bfloat16() for t in leaves) if speed else leaves
            msg, selfc = kernels.edge_contributions_cuda_sorted(
                h, src, dst, rel, wm, ws, b, sort_plan=plan,
                precision="highest" if speed else "default")
            out = two_stream_tail(msg, selfc, dst, h.shape[0], edge_mask=mask,
                                  sort_plan=plan)
        else:
            out = relational_message_passing(
                *leaves[:1], src, dst, rel, *leaves[1:], edge_mask=mask, backend="cuda",
                rel_sorted=True, group_padded=True, sort_plan=plan,
                compute_dtype="bfloat16" if speed else None)
        (out * r).sum().backward()
        torch.cuda.synchronize()
        if two_stream:
            form = "bf16" if speed else "tf32"
            assert kernels.edge_transform_sorted.launches_by_form[form] == 2
            assert segment_outer.launches_by_form[form] == 2
            # Kernel 1: the tail, dbias and the two gather cotangents over
            # the streams' rows; kernel 6 reduces its dW itself.
            k1 = {"f32": 0, "tf32": 0, "bf16": 4, "fast": 0} if speed else \
                {"f32": 4, "tf32": 0, "bf16": 0, "fast": 0}
            assert csr_segment_sum.launches_by_form == k1
            assert out.dtype == torch.float32
        runs.append((out.detach().cpu(), [t.grad.cpu() for t in leaves]))
    (out, grads), (ref, ref_grads) = runs
    atol = 1e-2 if speed else ONE_PASS_SCALED
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= atol * scale
    if speed:
        a = torch.cat([t.double().flatten() for t in grads])
        b = torch.cat([t.double().flatten() for t in ref_grads])
        assert torch.nn.functional.cosine_similarity(a, b, dim=0).item() > 0.999
    else:
        for name, a, w in zip(("h", "w_msg", "w_self", "bias"), grads, ref_grads):
            scale = max(1.0, w.abs().max().item())
            assert (a - w).abs().max().item() <= ONE_PASS_SCALED * scale, name


# ---------------------------------------------------------------------------
# Kernels 3 and 6 reduce their dW inside the kernel (an ordered
# last-arriver reduction over the run table), and kernel 3's bf16 form
# takes any d_out.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_in,d_out", [(64, 136), (64, 192), (64, 256), (36, 200)])
@pytest.mark.parametrize("tail_cut", [0, 100])
def test_edge_transform_bwd_kernel_bf16_form_at_any_d_out(dev, d_in, d_out, tail_cut):
    # Above 128 columns the bf16 body walks d_out in 128-column slabs, keeps
    # dx's f32 sums across them and rounds dx once; 36 -> 200 takes the
    # 2-byte copies.
    xs, xd, rel, wm, ws, _ = (torch.from_numpy(a).to(dev)
                              for a in run_case(31, d_in, d_out, tail_cut))
    g = torch.randn((xs.shape[0], d_out), generator=torch.Generator().manual_seed(11))
    args = [t.to(dev).bfloat16() if t.is_floating_point() else t
            for t in (g, xs, xd, rel, wm, ws)]
    kernels.reset_launch_counts()
    got = edge_transform_combined_bwd(*args)
    again = edge_transform_combined_bwd(*args)
    torch.cuda.synchronize()
    assert edge_transform_combined_bwd.launches_by_form["bf16"] == 2
    want = edge_transform_combined_bwd_plain(*args)
    for name, a, b, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), got, again, want):
        assert torch.equal(a, b), f"{name}: two runs differ"
        assert a.dtype == w.dtype, name
    for name, a, w in zip(("dx_src", "dx_dst"), got[:2], want[:2]):
        _within_ulp(a.cpu(), w.cpu(), name)
    for name, a, w in zip(("dW_msg", "dW_self"), got[2:], want[2:]):
        _close_scaled(a.cpu(), w.cpu(), name)
        assert not a[[4, 6, 7]].any(), "relations without rows must be exactly zero"


def _long_run_case(seed, d_in, d_out):
    """Relation 0 of 150 tiles (38 runs of 4 tiles), then
    relations of 3, 1, 0 and 37 tiles, the last one cut by 100 rows, in a
    bank of 7 (3, 5 and 6 without rows): ``(x_src, x_dst, rel, w_msg,
    w_self, g)``."""
    rng = np.random.default_rng(seed)
    tiles = [150, 3, 1, 0, 37]
    rel = np.concatenate([np.full(t * GROUP_PAD, u, dtype=np.int32)
                          for u, t in enumerate(tiles)])[:-100]
    e, u = rel.shape[0], 7
    xs, xd = (rng.standard_normal((e, d_in)).astype(np.float32) for _ in range(2))
    wm, ws = ((rng.standard_normal((u, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
              for _ in range(2))
    g = rng.standard_normal((e, d_out)).astype(np.float32)
    return xs, xd, rel, wm, ws, g


def _form_args(arrays, form, dev):
    """The arrays on the card in the form's dtype, and the precision."""
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    out = [torch.from_numpy(a).to(dev) for a in arrays]
    out = [t.to(dtype) if t.is_floating_point() else t for t in out]
    return out, "default" if form == "tf32" else "highest"


def _check_form(form, got, want, msg):
    """A kernel output against its plain version in the form's gate: f32
    after scaling; one TF32 pass bf16-class after scaling; bf16 outputs
    within one bf16 ulp of the largest value."""
    if got.dtype == torch.bfloat16:
        _within_ulp(got.cpu(), want.cpu(), msg)
    elif form == "tf32":
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= ONE_PASS_SCALED * scale, msg
    else:
        _close_scaled(got.cpu(), want.cpu(), msg)


@pytest.mark.parametrize("form", ["f32", "tf32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_kernels_3_and_6_over_more_than_32_runs_in_every_form(dev, form, d):
    # One relation of 150 tiles: 38 runs reduced by kernels 3 and 6, in
    # run order by the last arriver; 3 calls bitwise equal; relations
    # without rows exactly 0; single-run relations written directly.
    (xs, xd, rel, wm, ws, g), precision = _form_args(_long_run_case(32, d, d), form, dev)
    kernels.reset_launch_counts()
    k3 = [edge_transform_combined_bwd(g, xs, xd, rel, wm, ws, precision=precision)
          for _ in range(3)]
    k6 = [segment_outer(xs, g, rel, 7, precision=precision) for _ in range(3)]
    torch.cuda.synchronize()
    assert edge_transform_combined_bwd.launches_by_form[form] == 3
    assert segment_outer.launches_by_form[form] == 3
    assert csr_segment_sum.launches == 0
    for outs in k3[1:]:
        assert all(torch.equal(a, b) for a, b in zip(k3[0], outs)), "calls differ"
    for out in k6[1:]:
        assert torch.equal(k6[0], out), "calls differ"
    want3 = edge_transform_combined_bwd_plain(g, xs, xd, rel, wm, ws)
    for name, a, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), k3[0], want3):
        _check_form(form, a, w, name)
    _check_form(form, k6[0], segment_outer_plain(xs, g, rel, 7), "dW")
    for dw in (*k3[0][2:], k6[0]):
        assert dw.dtype == torch.float32
        assert not dw[[3, 5, 6]].any(), "relations without rows must be exactly zero"


def test_layouts_called_in_turn_leave_no_counter_behind(dev):
    # Two layouts in turn, A, B, A, through kernels 3 and 6 in every form
    # on one stream (they share the counters): an unreset counter would
    # make a later call's last arriver fire early or never.
    layouts = []
    for seed, case in ((33, _long_run_case(33, 64, 64)), (34, None)):
        if case is None:
            xs, xd, rel, wm, ws, _ = run_case(seed, 64, 64, 100)
            g = np.random.default_rng(seed).standard_normal((rel.shape[0], 64))
            case = (xs, xd, rel, wm, ws, g.astype(np.float32))
        layouts.append(case)
    for form in ("f32", "tf32", "bf16"):
        outs = []
        for arrays in (layouts[0], layouts[1], layouts[0]):
            (xs, xd, rel, wm, ws, g), precision = _form_args(arrays, form, dev)
            u = wm.shape[0]
            k3 = edge_transform_combined_bwd(g, xs, xd, rel, wm, ws, precision=precision)
            k6 = segment_outer(xd, g, rel, u, precision=precision)
            outs.append((k3, k6, (g, xs, xd, rel, wm, ws)))
        torch.cuda.synchronize()
        (a3, a6, _), (b3, b6, b_args), (c3, c6, _) = outs
        assert all(torch.equal(x, y) for x, y in zip(a3, c3)), form
        assert torch.equal(a6, c6), form
        want = edge_transform_combined_bwd_plain(*b_args)
        for name, a, w in zip(("dx_src", "dx_dst", "dW_msg", "dW_self"), b3, want):
            _check_form(form, a, w, f"{form} {name}")
        g, _, xd, rel, wm, _ = b_args
        _check_form(form, b6, segment_outer_plain(xd, g, rel, wm.shape[0]), f"{form} dW")


def test_run_tables_on_the_card_equal_run_bounds(dev):
    # The SortPlan's tables (built on the host) and the run-table kernel's
    # (built on the card where no plan is given) against run_bounds, on an
    # encoded graph, the run cases and a layout of 3,000 relations (more
    # than the kernel's 1,024 threads; every fourth one without rows).
    rng = np.random.default_rng(35)
    n, e, u = 400, 20000, 29
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    graph = encode_graph(ei, [texts[i] for i in rng.integers(0, u, e)], n,
                         sort_by_relation=True, with_sort_plan=True, group_pad=GROUP_PAD)
    plan = graph.sort_plan.to(dev)
    rel = torch.as_tensor(graph.rel_ids, device=dev)
    u_pad = graph.char_ids.shape[0]
    want = run_bounds(rel, u_pad, RUN_TILES)[:2]
    table = plan_runs(plan)
    assert table.run_tiles == RUN_TILES
    assert torch.equal(table.tile_splits, want[0]) and torch.equal(table.run_splits, want[1])
    many = np.repeat(np.arange(3000, dtype=np.int32), [0 if i % 4 == 3 else 1 + i % 3
                                                       for i in range(3000)])
    many = np.repeat(many, GROUP_PAD)
    layouts = [(graph.rel_ids, u_pad), (run_case(0, 4, 4, 0)[2], 8),
               (run_case(0, 4, 4, 100)[2], 8), (many[:-37], 3001)]
    kernels.reset_launch_counts()
    for rel_np, u in layouts:
        rel = torch.as_tensor(rel_np, device=dev)
        for run_tiles in (1, 2, 4, 7):
            got = run_table(rel, u, run_tiles)
            want = run_bounds(rel, u, run_tiles)[:2]
            torch.cuda.synchronize()
            assert torch.equal(got.tile_splits, want[0]), (u, run_tiles)
            assert torch.equal(got.run_splits, want[1]), (u, run_tiles)
    assert kernels.run_table.launches == 4 * len(layouts)


def test_no_run_table_launch_where_a_sort_plan_is_given(dev):
    # The cuda backend and the two-stream path with a SortPlan hand its run
    # tables to kernels 3 and 6: no per-call launch builds one.
    leaves, (src, dst, rel, mask), plan, r = _toy_layer_inputs(dev, _PADDED)
    for two_stream in (False, True):
        kernels.reset_launch_counts()
        if two_stream:
            msg, selfc = kernels.edge_contributions_cuda_sorted(
                leaves[0], src, dst, rel, *leaves[1:], sort_plan=plan)
            out = two_stream_tail(msg, selfc, dst, leaves[0].shape[0], edge_mask=mask,
                                  sort_plan=plan)
        else:
            out = relational_message_passing(
                leaves[0], src, dst, rel, *leaves[1:], edge_mask=mask, backend="cuda",
                rel_sorted=True, group_padded=True, sort_plan=plan)
        (out * r).sum().backward()
        torch.cuda.synchronize()
        assert kernels.run_table.launches == 0
        assert (segment_outer.launches == 2 if two_stream
                else edge_transform_combined_bwd.launches == 1)


# ---------------------------------------------------------------------------
# The host-side modules' device work: evaluation, minibatch steps, checkpoints
# ---------------------------------------------------------------------------


def test_evaluation_on_the_card_equals_the_cpu(dev):
    from graph_hypernetwork_forge_tpu_torch.training.evaluate import evaluate_link_prediction

    # Small-integer embeddings: every score is an exact integer on both
    # devices, so the ranks (exact ties included) must be equal.
    rng = np.random.default_rng(0)
    n = 700
    embs = rng.integers(-3, 4, (n, 8)).astype(np.float32)
    src, dst = rng.integers(0, n, 300), rng.integers(0, n, 300)
    known = np.stack([rng.integers(0, n, 4000), rng.integers(0, n, 4000)])
    for kw in (dict(), dict(filter_edges=known), dict(filter_edges=known, chunk_size=64)):
        on_card = evaluate_link_prediction(torch.as_tensor(embs, device=dev), src, dst, **kw)
        assert on_card == evaluate_link_prediction(embs, src, dst, device="cpu", **kw)


def test_minibatch_step_on_the_card_matches_the_cpu(dev):
    from graph_hypernetwork_forge_tpu_torch.data.datasets import generate_synthetic_kg
    from graph_hypernetwork_forge_tpu_torch.training.minibatch import (
        MinibatchSpec,
        MinibatchTrainer,
    )

    kg = generate_synthetic_kg(300, 3000, 12, feat_dim=16, seed=1)
    cfg = HyperGNNConfig(16, 16, 16, backend="grouped")
    spec = MinibatchSpec(batch_size=64, fanouts=(5, 5), node_bucket_multiple=128)
    init = init_hypergnn(cfg, torch.Generator().manual_seed(2))
    lr, runs, batch = 1e-3, [], None
    neg = torch.as_tensor(np.random.default_rng(3).integers(0, 128, 64).astype(np.int32))
    for device in (dev, torch.device("cpu")):
        trainer = MinibatchTrainer(cfg, adam(lr), kg.edge_index, kg.edge_texts,
                                   kg.node_features, spec, device=device)
        batch = batch or trainer.sample_batch(np.random.default_rng(4))
        state = create_train_state(tree_map(lambda t: t.to(device), init), adam(lr))
        kernels.reset_launch_counts()
        params, _, loss = trainer.device_step(state.params, state.opt_state,
                                              trainer.to_device(batch),
                                              neg_dst=neg.to(device))
        assert csr_segment_sum.launches == 0  # grouped: no kernel on this path
        runs.append((loss.item(), {p: (t.detach().cpu(), t.grad.cpu())
                                   for p, t in named_leaves(params)}))
    (l_card, card), (l_cpu, cpu) = runs
    assert abs(l_card - l_cpu) <= 3e-5
    for path, (p_cpu, g_cpu) in cpu.items():
        _close_scaled(card[path][1], g_cpu, f"grad {path}")
        torch.testing.assert_close(card[path][0], p_cpu, rtol=0, atol=2 * lr, msg=path)


def test_checkpoint_of_card_tensors_restores_on_the_card(dev, tmp_path):
    from graph_hypernetwork_forge_tpu_torch.training.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    kg = ToyKnowledgeGraph()
    cfg = HyperGNNConfig(64, 16, 32)
    init = init_hypergnn(cfg, torch.Generator().manual_seed(5))
    feats = torch.as_tensor(kg.node_features, dtype=torch.float32, device=dev)
    arrays = [torch.as_tensor(a, device=dev)
              for a in encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes).arrays]
    step = make_train_step(cfg)

    def fresh():
        return create_train_state(tree_map(lambda t: t.to(dev), init), adam(1e-3))

    state = fresh()
    for i in range(2):
        step(state.params, state.opt_state, feats, *arrays,
             torch.Generator(device=dev).manual_seed(i))
    saved = {p: t.detach().clone() for p, t in named_leaves(state.params)}
    path = save_checkpoint(str(tmp_path), state.params, state.opt_state, step=2)
    # An in-place step right after the save must not reach the checkpoint.
    step(state.params, state.opt_state, feats, *arrays, torch.Generator(device=dev))
    other = fresh()
    restore_checkpoint(path, other.params, other.opt_state)
    for p, t in named_leaves(other.params):
        assert t.device.type == "cuda" and torch.equal(t, saved[p]), p
    moments = [v for s in other.opt_state.state.values() for k, v in s.items()
               if k != "step"]
    assert moments and all(v.device.type == "cuda" for v in moments)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group and its ("edge",) mesh on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels run only there")
    import torch.distributed as dist

    from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh

    resolve_device(None)
    rendezvous = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1,), ("edge",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("form", ["edge", "node", "halo", "scheduled"])
def test_parallel_forms_at_world_size_one_match_the_cuda_backend(nccl_mesh, form):
    """Each ``parallel/`` message-passing form on one NCCL rank against the
    main path (the ``cuda`` backend: kernels 1 and 2, and 3 in the
    backward): output and the gradients of ``Σ out · R`` within the f32
    gate."""
    from graph_hypernetwork_forge_tpu_torch.parallel import halo
    from graph_hypernetwork_forge_tpu_torch.parallel.edge_partition import (
        edge_partitioned_message_passing,
    )
    from graph_hypernetwork_forge_tpu_torch.parallel.node_partition import (
        node_partitioned_message_passing,
        partition_edges_by_dst,
    )

    dev = torch.device(nccl_mesh.device_type)
    rng = np.random.default_rng(3)
    n, e, u, d = 300, 3000, 6, 64
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 10, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    g = encode_graph(ei, [texts[i] for i in rng.integers(0, u, e)], n,
                     sort_by_relation=True, with_sort_plan=True, group_pad=GROUP_PAD)
    u_pad = g.char_ids.shape[0]
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])

    inputs = [rng.standard_normal(shape).astype(np.float32) * scale
              for shape, scale in (((n, d), 1.0), ((u_pad, d, d), d**-0.5),
                                   ((u_pad, d, d), d**-0.5), ((u_pad, d), 1.0))]
    r = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=dev)

    def run(fn):
        args = [torch.as_tensor(a, device=dev).requires_grad_(True) for a in inputs]
        out = fn(*args)
        (out * r).sum().backward()
        return out.detach(), [a.grad for a in args]

    want, want_grads = run(lambda h, wm, ws, b: relational_message_passing(
        h, src, dst, rel, wm, ws, b, num_nodes=n, edge_mask=mask, backend="cuda",
        rel_sorted=True, group_padded=True, sort_plan=g.sort_plan.to(dev)))
    host = [np.asarray(a) for a in g.arrays[:4]]
    if form == "edge":
        def fn(h, wm, ws, b):
            return edge_partitioned_message_passing(nccl_mesh, h, src, dst, rel, wm, ws, b,
                                                    edge_mask=mask)
    elif form == "node":
        p_src, p_dst, p_rel, p_mask, npp = (
            torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
            for a in partition_edges_by_dst(*host, n, 1))

        def fn(h, wm, ws, b):
            return node_partitioned_message_passing(nccl_mesh, h, p_src, p_dst, p_rel, wm,
                                                    ws, b, p_mask, npp)
    elif form == "halo":
        plan = halo.build_halo_plan(*host, n, 1)
        arrays = [torch.as_tensor(a, device=dev) for a in plan.edge_arrays]

        def fn(h, wm, ws, b):
            return halo.halo_message_passing(
                nccl_mesh, h, arrays, torch.as_tensor(plan.send_idx, device=dev), wm, ws,
                b, plan.nodes_per_shard, plan.halo_width)
    else:
        plan = halo.build_scheduled_halo_plan(*host, n, 1)

        def fn(h, wm, ws, b):
            return halo.scheduled_halo_message_passing(nccl_mesh, h, plan, wm, ws, b)

    got, grads = run(fn)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
    for name, a, b in zip(("h", "W_msg", "W_self", "bias"), grads, want_grads):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=3e-5, msg=name)
