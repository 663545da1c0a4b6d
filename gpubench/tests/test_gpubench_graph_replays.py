"""The reader of ``graph_replays.train``: the share of the recorded
training steps that the port replayed from its CUDA graph, on registries
filled by hand and by eager steps on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import port, run
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import init_hypergnn
from graph_hypernetwork_forge_tpu_torch.utils import profiling

METRIC = "graph_replays.train"
UNTRACED = SimpleNamespace(trace=None)


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.stop()
    profiling.reset()
    yield
    profiling.stop()
    profiling.reset()


def _steps(n: int, replays: int) -> None:
    """``n`` recorded entries of ``train_step``, the first ``replays`` of
    them counted as replays (the CPU never replays: counted by hand)."""
    profiling.record()
    for k in range(n):
        with profiling.span("train_step"):
            if k < replays:
                profiling.count("train_step_graph_replays", 1)
    profiling.stop()


@pytest.mark.parametrize("replays", [1, 3, 6])
def test_the_share_divides_by_the_entries_of_the_step(replays):
    _steps(6, replays)
    assert run.load_reader(METRIC).read(UNTRACED) == pytest.approx(100.0 * replays / 6)


def test_nothing_is_read_where_no_step_replayed():
    assert run.load_reader(METRIC).read(UNTRACED) is None
    _steps(4, 0)
    assert run.load_reader(METRIC).read(UNTRACED) is None


def test_nothing_is_read_from_a_program_without_the_registry(monkeypatch):
    _steps(2, 2)
    monkeypatch.delattr(profiling, "snapshot")
    assert run.load_reader(METRIC).read(UNTRACED) is None


def test_eager_steps_on_the_cpu_read_nothing():
    n, e = 40, 300
    rng = np.random.default_rng(0)
    ei = rng.integers(0, n, (2, e))
    texts = [f"relation {i}" for i in rng.integers(0, 5, e)]
    feats = torch.as_tensor(rng.standard_normal((n, 16)).astype(np.float32))
    model = dict(text_dim=16, char_emb_dim=8, node_feat_dim=16, hidden_dim=16, num_layers=2,
                 dropout=0.0, precision="highest", compute_dtype="float32", group_pad=256)
    config = port.config(model)
    state = port.train.create_train_state(init_hypergnn(config, torch.Generator().manual_seed(0)),
                                          port.train.adam(1e-3))
    step = port.train.make_train_step(config, neg_mode="roll")
    graph = port.encode(model, ei, texts, n)
    arrays = [torch.as_tensor(a) for a in graph.arrays]
    plan = graph.sort_plan.to("cpu")
    profiling.record()
    for shift in (3, 7):
        step(state.params, state.opt_state, feats, *arrays, torch.Generator(),
             neg_dst=torch.tensor(shift), sort_plan=plan)
    profiling.stop()
    assert profiling.snapshot()["spans"]["train_step"]["entries"] == 2
    assert run.load_reader(METRIC).read(UNTRACED) is None
