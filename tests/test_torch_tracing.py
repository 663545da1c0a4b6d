"""The port's spans and work counters (``utils/profiling.py``): off they
cost one check and record nothing; ``record()`` or a running profiler fills
the registry; the profiler's ``ghf.*`` ranges nest as the port's stages do;
and the counters of the host-to-device copies, the row gathers and the
collectives equal counts made by hand from the arrays' shapes."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNN,
    HyperGNNConfig,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.parallel import collectives as coll
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.utils import profiling

train = importlib.import_module("graph_hypernetwork_forge_tpu_torch.training.train")

N, F, D, E = 40, 8, 16, 300
LAYOUT = dict(sort_by_relation=True, with_sort_plan=True, group_pad=256)


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.stop()
    profiling.reset()
    yield
    profiling.stop()
    profiling.reset()


def _raw_graph(seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N, (2, E))
    texts = [f"relation {i} of the graph" for i in rng.integers(0, 5, E)]
    return ei, texts, rng.standard_normal((N, F)).astype(np.float32)


def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def refuse(*_):
        raise AssertionError("entered while recording is off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=refuse))
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 5)
    ei, texts, _ = _raw_graph()
    encode_graph(ei, texts, N, **LAYOUT)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_record_fills_the_registry_until_stop():
    profiling.record()
    assert profiling.enabled()
    for _ in range(3):
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("rows", 7)
    profiling.stop()
    with profiling.span("outer"):
        profiling.count("rows", 1)
    assert not profiling.enabled()
    snap = profiling.snapshot()
    assert snap["counters"] == {"rows": 21}
    assert {k: v["entries"] for k, v in snap["spans"].items()} == {"outer": 3, "inner": 3}
    assert snap["spans"]["outer"]["seconds"] >= snap["spans"]["inner"]["seconds"] > 0


def _ranges(prof):
    return [(e.name[len(profiling.RANGE_PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(profiling.RANGE_PREFIX)]


def _inside(ranges, child, parent):
    parents = [(a, b) for name, a, b in ranges if name == parent]
    kids = [(a, b) for name, a, b in ranges if name == child]
    return kids and all(any(pa <= a and b <= pb for pa, pb in parents) for a, b in kids)


CONFIG = HyperGNNConfig(text_dim=16, node_feat_dim=F, hidden_dim=D, char_emb_dim=8,
                        backend="cuda", rel_sorted=True, group_padded=True)


def _step(graph, feats, neg, neg_mode="roll", num_negatives=1):
    """One training step of a fresh state on ``graph``, negatives ``neg``."""
    state = train.create_train_state(init_hypergnn(CONFIG, torch.Generator().manual_seed(0)),
                                     train.adam(1e-3))
    step = train.make_train_step(CONFIG, neg_mode=neg_mode, num_negatives=num_negatives)
    arrays = [torch.as_tensor(a) for a in graph.arrays]
    plan = graph.sort_plan.to("cpu")
    return lambda: step(state.params, state.opt_state, torch.as_tensor(feats), *arrays,
                        torch.Generator().manual_seed(1), neg_dst=neg, sort_plan=plan)


def test_the_profiler_turns_recording_on_and_its_ranges_nest():
    ei, texts, feats = _raw_graph()
    step = _step(encode_graph(ei, texts, N, **LAYOUT), feats, torch.tensor(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        encode_graph(ei, texts, N, **LAYOUT)
        step()
    assert not profiling.enabled()
    ranges = _ranges(prof)
    for stage in ("dedup", "tokenize", "layout", "sort_plan"):
        assert _inside(ranges, f"encode.{stage}", "encode"), stage
    for stage in ("loss", "backward", "optimizer"):
        assert _inside(ranges, stage, "train_step"), stage
    assert _inside(ranges, "forward", "loss")
    for stage in ("text_encoder", "generator", "message_passing"):
        assert _inside(ranges, stage, "forward"), stage
    entries = {k: v["entries"] for k, v in profiling.snapshot()["spans"].items()}
    assert entries == {"encode": 1, "encode.dedup": 1, "encode.tokenize": 1, "encode.layout": 1,
                       "encode.sort_plan": 1, "train_step": 1, "loss": 1, "forward": 1,
                       "text_encoder": 1, "generator": 2, "message_passing": 2,
                       "backward": 1, "optimizer": 1}


def test_to_device_bytes_of_forward_encoded():
    ei, texts, feats = _raw_graph()
    model = HyperGNN(16, F, D, 2, 0.0, 8, backend="cuda", device="cpu").eval()
    graph = model.preprocess(ei, texts, N)
    plan = graph.sort_plan
    by_hand = sum(a.nbytes for a in graph.arrays) + sum(
        a.nbytes for a in (plan.dst_perm, plan.inv_dst_perm, plan.dst_sorted, plan.src_perm,
                           plan.inv_src_perm, plan.src_sorted, plan.in_degree,
                           plan.rel_counts, plan.dst_splits, plan.src_splits,
                           plan.rel_splits, plan.tile_splits, plan.run_splits))
    profiling.record()
    model.forward_encoded(torch.as_tensor(feats), graph)
    profiling.stop()
    snap = profiling.snapshot()
    assert snap["counters"]["to_device_bytes"] == by_hand
    assert snap["spans"]["forward.to_device"]["entries"] == 1


def _gather(n, table_rows, row_bytes, index_bytes):
    """Least bytes of an n-row gather: rows written, indices read, table
    rows read (the table once where it is smaller)."""
    return n * row_bytes + n * index_bytes + min(n, table_rows) * row_bytes


@pytest.mark.parametrize("loss", ["roll", "uniform", "multi"])
def test_gather_bytes_of_one_training_step(loss):
    ei, texts, feats = _raw_graph()
    graph = encode_graph(ei, texts, N, **LAYOUT)
    n, row, k = graph.src.shape[0], D * 4, 3 if loss == "multi" else 1
    # Each layer: the h[src], h[dst] pair and the dst-sorted permute of the
    # contributions; backward, the pair's two permutes, then the segment
    # sum's index composition ([n] int32 from [n]) and its row gather.
    layer = 2 * _gather(n, N, row, 4) + _gather(n, n, row, 4)
    layer += 2 * _gather(n, n, row, 4) + _gather(n, n, 4, 4) + _gather(n, N, row, 4)
    if loss == "roll":
        # The rows of src and dst, the rolled tails (int64 indices); back,
        # two rolls and the two plan permutes.
        loss_bytes = 2 * _gather(n, N, row, 4) + _gather(n, n, row, 8)
        loss_bytes += 2 * _gather(n, n, row, 8) + 2 * _gather(n, n, row, 4)
        neg = torch.tensor(5)
    elif loss == "uniform":
        # The rows of src, dst and neg; back, the permute of the three
        # cotangent streams' 3n rows by their sort (int64 indices).
        loss_bytes = 3 * _gather(n, N, row, 4) + _gather(3 * n, 3 * n, row, 8)
    else:
        # embs[src] twice, embs[dst], embs[neg]: each forward and backward.
        loss_bytes = 2 * (3 * _gather(n, N, row, 4) + _gather(n * k, N, row, 4))
    if loss != "roll":
        neg = torch.randint(0, N, (n, k) if k > 1 else (n,), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    step = _step(graph, feats, neg, "roll" if loss == "roll" else "uniform", k)
    profiling.record()
    step()
    profiling.stop()
    snap = profiling.snapshot()
    assert snap["spans"]["train_step"]["entries"] == 1
    assert snap["counters"]["gather_bytes"] == CONFIG.num_layers * layer + loss_bytes


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        yield make_mesh((1,), ("edge",), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("op", ["psum", "all_gather", "all_to_all", "ppermute"])
def test_collective_calls_and_bytes(one_rank, op):
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4).requires_grad_(True)
    profiling.record()
    if op == "ppermute":
        # A rank sends nothing to itself: one call, no bytes on the wire.
        out = coll.ppermute(x, one_rank, "edge", [(0, 0)])
    else:
        out = getattr(coll, op)(x, one_rank, "edge")
    profiling.stop()
    snap = profiling.snapshot()
    assert torch.equal(out, x)
    assert snap["counters"] == {"collective_calls": 1,
                                "collective_bytes": 0 if op == "ppermute" else 96}
    assert snap["spans"][f"collective.{op.replace('psum', 'all_reduce')}"]["entries"] == 1
