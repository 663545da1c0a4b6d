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
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (
    edge_transform_combined_bwd,
    edge_transform_combined_bwd_plain,
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
from torch_cases import edge_case, run_case, segment_case

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
    assert csr_segment_sum.launches == 2  # one dW reduction per call
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
    assert segment_outer.launches == 2 and csr_segment_sum.launches == 2
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
    assert edge_transform_combined_bwd.launches == 2 and csr_segment_sum.launches == 2
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
            # gather cotangents + dbias + kernel 3's dW, and 2 in the loss.
            launches = (csr_segment_sum.launches,
                        edge_transform_sorted_combined.launches,
                        edge_transform_combined_bwd.launches)
            assert launches == (12, 2, 2)
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
    # the banks transposed (d_in and d_out swap), kernel 6 twice, kernel 1
    # for dbias and kernel 6's two reductions.
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
            assert csr_segment_sum.launches == 3
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
    assert segment_outer.launches == 2 and csr_segment_sum.launches == 2
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
