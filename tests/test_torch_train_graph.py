"""The training step's CUDA graph (``training/train.py`` ``make_train_step``).

On the CPU: which calls stay eager (nothing captured), where :func:`adam`
is capturable, the profiling tally a capture counts into, the launch-count
arithmetic of a replay, and what tells two calls' inputs apart. On the card
(``cuda`` marker; each test skips without an NVIDIA GPU): graphed steps
against eager ones, bit for bit, in both negative modes; a kept loss; a new
input capturing again; the counters and launch counts of a replay; a
capture that raises. This file imports no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graph.py
"""

import copy
import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from graph_hypernetwork_forge_tpu_torch.data.datasets import generate_synthetic_kg
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig, init_hypergnn
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels
from graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_sum import csr_segment_sum
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    adamw,
    create_train_state,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from graph_hypernetwork_forge_tpu_torch.utils import profiling
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves, tree_map

# The module, which the package's ``train`` function shadows.
tr = importlib.import_module("graph_hypernetwork_forge_tpu_torch.training.train")
GRAPH_COUNTERS = ("train_step_graph_captures", "train_step_graph_replays",
                  "train_step_graph_fallbacks")
STEPS = 6


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.stop()
    profiling.reset()
    yield
    profiling.stop()
    profiling.reset()


@pytest.fixture(scope="module")
def kg_graph():
    kg = generate_synthetic_kg(400, 4000, 12, feat_dim=16, seed=1)
    graph = encode_graph(kg.edge_index, kg.edge_texts, kg.num_nodes, sort_by_relation=True,
                         with_sort_plan=True, group_pad=256)
    return kg, graph


def _config(**kw):
    return HyperGNNConfig(**{**dict(text_dim=32, node_feat_dim=16, hidden_dim=16, num_layers=2,
                                    rel_sorted=True, group_padded=True), **kw})


class _Run:
    """One step object over fresh Adam state on ``device``, from the same
    weights every time."""

    def __init__(self, kg_graph, device, neg_mode="roll", optimizer=None, **config):
        kg, graph = kg_graph
        self.config = _config(**config)
        init = init_hypergnn(self.config, torch.Generator().manual_seed(3))
        self.state = create_train_state(tree_map(lambda t: t.to(device), init),
                                        optimizer or adam(1e-3))
        self.step = make_train_step(self.config, neg_mode=neg_mode)
        self.feats = torch.as_tensor(kg.node_features, dtype=torch.float32, device=device)
        self.arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
        self.plan = graph.sort_plan.to(device)
        self.rows = int(graph.src.shape[0])
        self.num_nodes = kg.num_nodes
        self.device = device
        self.neg_mode = neg_mode

    def negatives(self, k: int):
        """Step k's negatives: a roll shift, or a uniform tail a layout row."""
        rng = np.random.default_rng(100 + k)
        if self.neg_mode == "roll":
            return torch.tensor(int(rng.integers(1, self.rows)), device=self.device)
        return torch.as_tensor(rng.integers(0, self.num_nodes, self.rows).astype(np.int32),
                               device=self.device)

    def __call__(self, neg_dst, feats=None, step=None):
        _, _, loss = (step or self.step)(
            self.state.params, self.state.opt_state,
            self.feats if feats is None else feats, *self.arrays,
            torch.Generator(device=self.device), neg_dst=neg_dst, sort_plan=self.plan)
        return loss

    def leaves(self) -> dict:
        return {p: t.detach().clone() for p, t in named_leaves(self.state.params)}


def _refusal(run: _Run, neg_dst) -> str:
    plan = [t for t in vars(run.plan).values() if t is not None]
    tensors = [*tr.tree_leaves(run.state.params), run.feats, *run.arrays, *plan]
    return tr._graph_refusal(run.config, None, run.state.opt_state, tensors, neg_dst)


# ---------------------------------------------------------------------------
# On the CPU: what stays eager.


EAGER_CASES = {
    "cpu_tensors": (dict(), "one CUDA device"),
    "negatives_from_gen": (dict(neg=None), "negatives are drawn from gen"),
    "dropout": (dict(dropout=0.1), "dropout"),
    "schedule": (dict(optimizer=adam(warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10))),
                 "hooks"),
}


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
@pytest.mark.parametrize("neg_mode", ["roll", "uniform"])
def test_eager_calls_capture_nothing(kg_graph, case, neg_mode):
    kw, reason = EAGER_CASES[case]
    kw = dict(kw)
    no_neg = "neg" in kw and kw.pop("neg") is None
    run = _Run(kg_graph, torch.device("cpu"), neg_mode, **kw)
    assert reason in _refusal(run, None if no_neg else run.negatives(0))
    profiling.record()
    losses = [run(None if no_neg else run.negatives(k)) for k in range(3)]
    profiling.stop()
    counters = profiling.snapshot()["counters"]
    assert not set(GRAPH_COUNTERS) & set(counters), counters
    assert run.step.graph is None and run.step.stream is None and run.step.warmed is None
    assert all(torch.isfinite(loss) for loss in losses)


def test_dtensor_params_stay_eager(kg_graph, tmp_path):
    from graph_hypernetwork_forge_tpu_torch.parallel import (
        make_mesh,
        shard_graph_arrays,
        shard_params,
    )

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), device_type="cpu")
        run = _Run(kg_graph, torch.device("cpu"))
        params = shard_params(tree_map(lambda t: t.detach(), run.state.params), run.config, mesh)
        state = create_train_state(params, adam(1e-3))
        arrays = shard_graph_arrays(tuple(a.numpy() for a in run.arrays), mesh)
        tensors = [*tr.tree_leaves(state.params), run.feats, *arrays]
        assert "DTensors" in tr._graph_refusal(run.config, None, state.opt_state, tensors,
                                               run.negatives(0))
        profiling.record()
        for k in range(2):
            _, _, loss = run.step(state.params, state.opt_state, run.feats, *arrays,
                                  torch.Generator(), neg_dst=run.negatives(k),
                                  sort_plan=run.plan)
        profiling.stop()
        assert not set(GRAPH_COUNTERS) & set(profiling.snapshot()["counters"])
        assert run.step.graph is None and torch.isfinite(loss)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("make", [adam, adamw])
@pytest.mark.parametrize("lr", [1e-3, warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)])
def test_adam_over_cpu_leaves_is_not_capturable(make, lr):
    opt = make(lr)([torch.zeros(3, requires_grad=True), torch.ones(2, requires_grad=True)])
    assert all(g["capturable"] is False for g in opt.param_groups)
    assert tr._on_card(opt.param_groups[0]["params"]) is False


def test_the_refusals_come_in_their_order(kg_graph):
    run = _Run(kg_graph, torch.device("cpu"))
    sgd = torch.optim.SGD(tr.tree_leaves(run.state.params), lr=0.1)
    tensors = [*tr.tree_leaves(run.state.params), run.feats, *run.arrays]
    refusal = lambda *a: tr._graph_refusal(run.config, *a)  # noqa: E731
    assert "positives" in refusal(8, sgd, tensors, 3)
    assert "neither" in refusal(None, sgd, tensors, 3.5)
    assert "not a tensor" in refusal(None, sgd, [*tensors, np.zeros(3)], 3)
    # On the CPU the device rule refuses before the optimizer's own.
    assert "one CUDA device" in refusal(None, sgd, tensors, 3)


def test_the_key_tells_inputs_apart(kg_graph):
    run = _Run(kg_graph, torch.device("cpu"))
    run(run.negatives(0))  # Adam's state exists from here on
    opt = run.state.opt_state
    tensors = [*tr.tree_leaves(run.state.params), run.feats, *run.arrays]
    key = tr._graph_key(tensors, opt, run.negatives(1))
    # Other negatives of the same kind, and the same tensors updated in
    # place, keep the key.
    run(run.negatives(1))
    assert tr._graph_key(tensors, opt, run.negatives(2)) == key
    assert tr._graph_key([*tensors[:-1], tensors[-1].clone()], opt, run.negatives(1)) != key
    assert tr._graph_key(tensors, opt, run.negatives(1).int()) != key
    assert tr._graph_key(tensors, opt, 5) != key
    opt.param_groups[0]["lr"] = 2e-3
    assert tr._graph_key(tensors, opt, run.negatives(1)) != key
    opt.param_groups[0]["lr"] = 1e-3
    assert tr._graph_key(tensors, opt, run.negatives(1)) == key
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # new state tensors
    assert tr._graph_key(tensors, opt, run.negatives(1)) != key


# ---------------------------------------------------------------------------
# On the CPU: the bookkeeping a replay does.


@pytest.mark.parametrize("recording", [False, True])
def test_the_tally_takes_counts_and_spans_out_of_the_registry(recording):
    if recording:
        profiling.record()
    assert profiling.enabled() is recording
    with profiling.tally() as counts:
        assert profiling.enabled()
        with profiling.span("loss"):
            profiling.count("gather_bytes", 7)
            profiling.count("gather_bytes", 5)
            profiling.count("loss_plain", 1)
    assert counts == {"gather_bytes": 12, "loss_plain": 1}
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    for _ in range(2):
        with profiling.span("train_step"):
            for name, n in counts.items():
                profiling.count(name, n)
    snap = profiling.snapshot()
    if recording:
        assert snap["counters"] == {"gather_bytes": 24, "loss_plain": 2}
        assert list(snap["spans"]) == ["train_step"]
    else:
        assert snap == {"spans": {}, "counters": {}}


def test_launch_counts_add_and_undo():
    kernels.reset_launch_counts()
    before = kernels.launch_counts()
    for form in ("f32", "f32", "bf16"):
        kernels._common.count_launch(csr_segment_sum, form)
    kernels.run_table.launches += 1
    after = kernels.launch_counts()
    kernels.add_launch_counts(after, before, times=-1)
    assert kernels.launch_counts() == before
    kernels.add_launch_counts(after, before, times=2)
    assert csr_segment_sum.launches == 6
    assert csr_segment_sum.launches_by_form == {"f32": 4, "tf32": 0, "bf16": 2, "fast": 0}
    assert kernels.run_table.launches == 2
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# On the card.


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: a CUDA graph is captured only there")
    return torch.device("cuda", torch.cuda.current_device())


def _eager_run(run: _Run, k: int) -> torch.Tensor:
    """Step k through a step object of its own, whose first call runs
    eagerly: the same code and Adam, no graph."""
    return run(run.negatives(k), step=make_train_step(run.config, neg_mode=run.neg_mode))


@pytest.mark.cuda
@pytest.mark.parametrize("neg_mode", ["roll", "uniform"])
def test_graphed_steps_equal_eager_steps(kg_graph, dev, neg_mode):
    graphed, eager = _Run(kg_graph, dev, neg_mode), _Run(kg_graph, dev, neg_mode)
    assert graphed.state.opt_state.param_groups[0]["capturable"] is True
    profiling.record()
    got = [graphed(graphed.negatives(k)) for k in range(STEPS)]
    want = [_eager_run(eager, k) for k in range(STEPS)]
    profiling.stop()
    counters = profiling.snapshot()["counters"]
    # Calls 1 (the warm-up) and 2 (capture, then replay) of the graphed run.
    assert counters["train_step_graph_captures"] == 1
    assert counters["train_step_graph_replays"] == STEPS - 1
    assert graphed.step.graph is not None and eager.step.graph is None
    assert torch.equal(torch.stack(got), torch.stack(want)), (got, want)
    a, b = graphed.leaves(), eager.leaves()
    for path in b:
        assert torch.equal(a[path], b[path]), path
    grads = dict(named_leaves(graphed.state.params))
    for path, t in named_leaves(eager.state.params):
        assert torch.equal(grads[path].grad, t.grad), path


@pytest.mark.cuda
def test_a_kept_loss_does_not_change_with_later_steps(kg_graph, dev):
    run = _Run(kg_graph, dev)
    kept = [run(run.negatives(k)) for k in range(STEPS)]
    values = [loss.item() for loss in kept]
    run(run.negatives(STEPS))
    torch.cuda.synchronize()
    assert [loss.item() for loss in kept] == values
    assert len(set(values)) == STEPS


@pytest.mark.cuda
def test_new_features_capture_again(kg_graph, dev):
    run = _Run(kg_graph, dev)
    profiling.record()
    for k in range(3):
        run(run.negatives(k))
    first = run.step.graph
    feats = run.feats.clone()
    run(run.negatives(3), feats=feats)  # new inputs: eager, on the capture stream
    assert run.step.graph is first
    run(run.negatives(4), feats=feats)  # captured and replayed
    run(run.negatives(5), feats=feats)
    profiling.stop()
    assert run.step.graph is not first
    counters = profiling.snapshot()["counters"]
    assert counters["train_step_graph_captures"] == 2
    assert counters["train_step_graph_replays"] == 4


def _one_step_counts(run: _Run, k: int) -> tuple:
    kernels.reset_launch_counts()
    profiling.reset()
    profiling.record()
    run(run.negatives(k))
    profiling.stop()
    snap = profiling.snapshot()
    launches = {fn.__name__: v for fn, v in kernels.launch_counts().items()}
    return snap["counters"], launches


@pytest.mark.cuda
@pytest.mark.parametrize("neg_mode", ["roll", "uniform"])
def test_a_replay_counts_what_an_eager_step_counts(kg_graph, dev, neg_mode):
    run = _Run(kg_graph, dev, neg_mode)
    eager_counts, eager_launches = _one_step_counts(run, 0)
    assert "train_step_graph_replays" not in eager_counts
    assert eager_launches["csr_segment_sum"][0] > 0
    for k in (1, 2):  # the capture's call, then a replay alone
        counts, launches = _one_step_counts(run, k)
        assert counts.pop("train_step_graph_replays") == 1
        counts.pop("train_step_graph_captures", None)
        assert counts == eager_counts and launches == eager_launches
        spans = profiling.snapshot()["spans"]
        assert spans["train_step"]["entries"] == 1
        assert "loss" not in spans and "backward" not in spans and "optimizer" not in spans


@pytest.mark.cuda
def test_replays_count_every_call_after_the_first(kg_graph, dev):
    run = _Run(kg_graph, dev, "uniform")
    run(run.negatives(0))
    profiling.record()
    for k in range(1, STEPS):
        run(run.negatives(k))
    profiling.stop()
    snap = profiling.snapshot()
    assert snap["counters"]["train_step_graph_replays"] == STEPS - 1
    assert snap["spans"]["train_step"]["entries"] == STEPS - 1


@pytest.mark.cuda
def test_a_capture_that_raises_leaves_the_step_eager(kg_graph, dev):
    # The grouped backend reads its group sizes back to the host, which a
    # capture refuses.
    graphed, eager = (_Run(kg_graph, dev, backend="grouped") for _ in range(2))
    profiling.record()
    graphed(graphed.negatives(0))
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        graphed(graphed.negatives(1))
    got = [graphed(graphed.negatives(k)) for k in range(2, 4)]
    profiling.stop()
    want = [_eager_run(eager, k) for k in range(4)][2:]
    counters = profiling.snapshot()["counters"]
    assert counters["train_step_graph_fallbacks"] == 1
    assert "train_step_graph_captures" not in counters
    assert "train_step_graph_replays" not in counters
    assert graphed.step.eager and graphed.step.graph is None
    assert torch.equal(torch.stack(got), torch.stack(want))
    a, b = graphed.leaves(), eager.leaves()
    assert all(torch.equal(a[p], b[p]) for p in b)


@pytest.mark.cuda
def test_adam_over_card_leaves_is_capturable(dev):
    for make in (adam, adamw):
        opt = make(1e-3)([torch.zeros(3, device=dev, requires_grad=True)])
        assert opt.param_groups[0]["capturable"] is True


@pytest.mark.cuda
def test_a_schedule_on_the_card_stays_eager(kg_graph, dev):
    run = _Run(kg_graph, dev, optimizer=adam(warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)))
    assert "hooks" in _refusal(run, run.negatives(0))
    profiling.record()
    for k in range(3):
        run(run.negatives(k))
    profiling.stop()
    assert not set(GRAPH_COUNTERS) & set(profiling.snapshot()["counters"])
    assert run.step.graph is None and run.step.stream is None


@pytest.mark.cuda
def test_a_config_with_dropout_on_the_card_stays_eager(kg_graph, dev):
    run = _Run(kg_graph, dev, dropout=0.1)
    assert "dropout" in _refusal(run, run.negatives(0))
