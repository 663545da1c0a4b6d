"""The readers of the port's own spans and counters (``program_span`` and
``program_counter``), on a registry filled by a tiny encode, serve and
training step on the CPU with recording on."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import counts, port, run, trace
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import init_hypergnn
from graph_hypernetwork_forge_tpu_torch.utils import profiling

SPANS = {"encode_dedup_ms.serve": "encode.dedup", "encode_tokenize_ms.serve": "encode.tokenize",
         "encode_layout_ms.serve": "encode.layout", "encode_plan_ms.serve": "encode.sort_plan",
         "h2d_ms.serve": "forward.to_device"}
ALL = sorted(SPANS) + ["h2d_mb.serve", "gather_roofline.train"]
GATHER = "void at::native::vectorized_gather_kernel<16, int>(char*, char*, int*, int)"
N, E = 40, 300


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.stop()
    profiling.reset()
    yield
    profiling.stop()
    profiling.reset()


def _ctx(units=2, gather_us=400.0):
    """A traced context whose profiled stretch held ``units`` steps and
    ``gather_us`` of a gather kernel beside another kernel."""
    ops = [(GATHER, 0.0, gather_us), ("void other_kernel<4>(float*)", 0.0, 50.0)]
    return SimpleNamespace(trace=trace.Trace(ops=ops, spans=[], start_us=0.0, end_us=1e4,
                                             units=units))


def _fill():
    """One tiny request (encode, forward) and two tiny roll steps, with
    recording on."""
    rng = np.random.default_rng(0)
    ei = rng.integers(0, N, (2, E))
    texts = [f"relation {i}" for i in rng.integers(0, 5, E)]
    feats = torch.as_tensor(rng.standard_normal((N, 16)).astype(np.float32))
    model = dict(text_dim=16, char_emb_dim=8, node_feat_dim=16, hidden_dim=16, num_layers=2,
                 dropout=0.0, precision="highest", compute_dtype="float32", group_pad=256)
    server = port.HyperGNN(16, 16, 16, 2, 0.0, 8, backend="cuda", device="cpu").eval()
    config = port.config(model)
    params = init_hypergnn(config, torch.Generator().manual_seed(0))
    state = port.train.create_train_state(params, port.train.adam(1e-3))
    step = port.train.make_train_step(config, neg_mode="roll")
    profiling.record()
    graph = server.preprocess(ei, texts, N)
    server.forward_encoded(feats, graph)
    arrays = [torch.as_tensor(a) for a in graph.arrays]
    plan = graph.sort_plan.to("cpu")
    for shift in (3, 7):
        step(state.params, state.opt_state, feats, *arrays, torch.Generator(),
             neg_dst=torch.tensor(shift), sort_plan=plan)
    profiling.stop()
    return profiling.snapshot()


def test_the_readers_against_the_registry():
    snap = _fill()
    ctx = _ctx()
    for metric, name in SPANS.items():
        s = snap["spans"][name]
        assert s["entries"] == 1
        assert run.load_reader(metric).read(ctx) == pytest.approx(1e3 * s["seconds"])
    to_device = snap["counters"]["to_device_bytes"]
    assert run.load_reader("h2d_mb.serve").read(ctx) == pytest.approx(to_device / 1e6)
    # Two steps' gather bytes (plus the request's forward, counted once)
    # over the two entries of train_step, at HBM's rate, over the 400 us of
    # gathers the trace holds for its two steps.
    assert snap["spans"]["train_step"]["entries"] == 2
    per_step = snap["counters"]["gather_bytes"] / 2
    want = 100.0 * per_step / counts.HBM_BYTES_PER_S / (400e-6 / 2)
    assert run.load_reader("gather_roofline.train").read(ctx) == pytest.approx(want)


def test_the_roofline_divides_by_the_steps_the_span_saw():
    """A profiled stretch tried twice fills the registry twice: the share
    is read per entry of ``train_step``, not per unit of the last trace."""
    profiling.record()
    for _ in range(6):
        with profiling.span("train_step"):
            profiling.count("gather_bytes", 3_350_000)
    profiling.stop()
    got = run.load_reader("gather_roofline.train").read(_ctx(units=3, gather_us=6.0))
    assert got == pytest.approx(100.0 * 1e-6 / 2e-6)


@pytest.mark.parametrize("metric", ALL)
def test_a_reader_reads_nothing_where_nothing_was_recorded(metric):
    assert run.load_reader(metric).read(_ctx()) is None
    profiling.record()
    with profiling.span("train_step" if metric.endswith(".train") else "forward.to_device"):
        pass
    profiling.stop()
    if metric not in SPANS:
        # The span was entered, its counter never.
        assert run.load_reader(metric).read(_ctx()) is None


@pytest.mark.parametrize("metric", ALL)
def test_a_reader_reads_nothing_from_a_program_without_the_registry(metric, monkeypatch):
    _fill()
    monkeypatch.delattr(profiling, "snapshot")
    assert run.load_reader(metric).read(_ctx()) is None


def test_the_roofline_reads_nothing_untraced():
    _fill()
    assert run.load_reader("gather_roofline.train").read(SimpleNamespace(trace=None)) is None
