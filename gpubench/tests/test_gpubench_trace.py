"""The device trace's arithmetic and the per-layer readers, on a trace
built by hand."""

from types import SimpleNamespace

import pytest

from gpubench import counts, run, trace

K1 = "void (anonymous namespace)::csr_segment_sum_kernel<4, float>((anonymous namespace)::Stream<4, float>)"
K2 = "void (anonymous namespace)::edge_transform_kernel<64, true, false, 3>(float const*)"
K3 = "void (anonymous namespace)::edge_transform_bwd_kernel<64, true, 3>(float const*)"
GATHER = "void at::native::vectorized_gather_kernel<16, int>(char*, char*, int*, int)"
MODEL = {"text_dim": 64, "char_emb_dim": 32, "node_feat_dim": 64, "hidden_dim": 64,
         "num_layers": 2, "compute_dtype": "float32"}
SHAPES = dict(rows=1_031_680, num_nodes=50_000, num_edges=1_000_000, num_rel=237,
              num_rel_pad=240, visited_rel=237)


def _trace(ops, spans=(), start=0.0, end=100.0, units=1):
    return trace.Trace(ops=list(ops), spans=list(spans), start_us=start, end_us=end, units=units)


def test_busy_time_is_the_union_of_overlapping_intervals():
    t = _trace([("a", 10, 30), ("b", 20, 40), ("c", 60, 70), ("d", 95, 120)])
    assert t.busy == [(10, 40), (60, 70), (95, 100)]
    assert t.busy_s == pytest.approx(45e-6) and t.window_s == pytest.approx(100e-6)
    assert t.idle_share(t.units, t.window_s) == pytest.approx(0.55)
    assert t.gaps() == [(0, 10), (40, 60), (70, 95)]


def test_gaps_are_labelled_by_the_innermost_span_at_their_middle():
    spans = [("gpubench.window", 0, 100), ("gpubench.step", 0, 50),
             ("gpubench.preprocess", 35, 65)]
    t = _trace([("k", 10, 30), ("k", 70, 80)], spans)
    rows = dict(t.breakdown()["idle_gaps"])
    assert rows["idle while the host was in step (1 gaps)"] == pytest.approx(10e-6)
    assert rows["idle while the host was in preprocess (1 gaps)"] == pytest.approx(40e-6)
    assert rows["idle while the host was in outside any span (1 gaps)"] == pytest.approx(20e-6)
    assert t.breakdown()["device_ops"] == [["k", pytest.approx(30e-6)]]


def _step_trace(steps=2, extra=()):
    table = counts.train_step_kernels(MODEL, SHAPES, "roll")
    ops, t = [], 0.0
    for _ in range(steps):
        for name, op in ((K1, "csr_segment_sum_kernel"), (K2, "edge_transform_kernel"),
                         (K3, "edge_transform_bwd_kernel")):
            for least in table[op]:
                ops.append((name, t, t + 2e3 * least))   # at half its roofline
                t += 2e3 * least
        ops.append((GATHER, t, t + 500.0))
        t += 500.0
    return _trace(ops + list(extra), end=t, units=steps)


def _ctx(tr):
    return SimpleNamespace(trace=tr, model=MODEL, shapes=SHAPES, neg_mode="roll")


@pytest.mark.parametrize("metric", ["csr_segment_sum_roofline", "edge_transform_roofline",
                                    "edge_transform_bwd_roofline"])
def test_roofline_readers(metric):
    reader = run.load_reader(metric)
    assert reader.read(_ctx(_step_trace())) == pytest.approx(50.0)
    assert reader.read(_ctx(None)) is None
    # A launch the table does not count: no reading of that kernel's share.
    extra = {"csr_segment_sum_roofline": K1, "edge_transform_roofline": K2,
             "edge_transform_bwd_roofline": K3}[metric]
    assert reader.read(_ctx(_step_trace(extra=[(extra, 0, 1)]))) is None
    # A port kernel the table does not know: no reading of any.
    unknown = "void (anonymous namespace)::segment_outer_kernel<64>(float const*)"
    assert reader.read(_ctx(_step_trace(extra=[(unknown, 0, 1)]))) is None


def test_index_and_idle_readers():
    tr = _step_trace()
    assert run.load_reader("index_ms.train").read(_ctx(tr)) == pytest.approx(0.5)
    # The device is busy all through the profiled steps; the unprofiled
    # window took a quarter longer a step, so the device idled a fifth of it.
    step_s = tr.busy_s / tr.units
    window = dict(steps=40, seconds=40 * step_s * 1.25)
    ctx = SimpleNamespace(**vars(_ctx(tr)), **window)
    assert run.load_reader("idle.train").read(ctx) == pytest.approx(20.0)
    ctx = SimpleNamespace(trace=tr, requests=40, seconds=40 * step_s * 1.25)
    assert run.load_reader("idle.serve").read(ctx) == pytest.approx(20.0)
    assert run.load_reader("idle.train").read(_ctx(None)) is None
