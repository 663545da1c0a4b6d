"""Full-graph training: the port of ``graph_hypernetwork_forge_tpu/training/train.py``.

The reference training semantics (Adam, margin-ranking loss, negatives by
corrupting the tail) as a step function: forward, loss, backward and one
``torch.optim.Adam`` update. The JAX step is one jitted XLA program; here
a step on the card whose launches can be recorded once is recorded as one
CUDA graph and replayed (:func:`make_train_step`), so the host issues one
graph launch a step, not each of the step's ~400 kernels. Any other step
runs eagerly, its launches queued without a host round trip (the roll
shift and the negatives are drawn on the device), so the host only waits
when the caller reads the loss.

Where the JAX step splits a ``jax.random`` key, the port draws from one
explicit ``torch.Generator`` on the device: the positive subsample, then
the negatives or the roll shift, then the dropout masks. The two packages'
random numbers differ, so ``neg_dst`` (the roll shift in ``neg_mode="roll"``)
can be handed in, which is how the tests give both the same negatives.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from graph_hypernetwork_forge_tpu_torch.data.encoding import EncodedGraph
from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (
    HyperGNNConfig,
    apply_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.training.objectives import (
    link_prediction_loss,
    link_prediction_loss_sorted,
    multi_negative_loss,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_leaves, tree_map
from graph_hypernetwork_forge_tpu_torch.utils.profiling import count, span, tally

Optimizer = Callable[[List[torch.Tensor]], torch.optim.Optimizer]
# A learning rate by update count, as optax's schedules: update i (from 0)
# uses schedule(i).
Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``'s counterpart: a linear warmup
    from ``init_value`` to ``peak_value`` over ``warmup_steps`` updates,
    then a cosine decay to ``end_value`` at ``decay_steps`` (which counts
    the warmup), held there after."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(
            f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return (init_value - peak_value) * (1.0 - count / warmup_steps) + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _scheduled(opt: torch.optim.Optimizer, schedule: Schedule) -> torch.optim.Optimizer:
    """``opt`` (made with lr 1) driven by ``schedule`` through ``LambdaLR``:
    the first update at ``schedule(0)``, the scheduler stepped after every
    update, and its count taken from the optimizer's step count when a
    state dict is loaded, so a resumed run goes on where it stopped."""
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: float(schedule(count)))
    opt.register_step_post_hook(lambda *_: sched.step())

    def resync(o: torch.optim.Optimizer) -> None:
        counts = [int(st["step"]) for st in o.state.values() if "step" in st]
        sched.last_epoch = counts[0] if counts else 0
        for group in o.param_groups:
            group["lr"] = float(schedule(sched.last_epoch))

    opt.register_load_state_dict_post_hook(resync)
    return opt


def _on_card(leaves) -> bool:
    """Whether every leaf is a plain tensor (not a DTensor) on a CUDA device."""
    return bool(leaves) and all(
        not isinstance(t, DTensor) and t.device.type == "cuda" for t in leaves)


def _adam_like(cls, learning_rate: Union[float, Schedule], **hyper) -> Optimizer:
    """A maker of ``cls`` (Adam or AdamW) over a list of leaves, at
    ``learning_rate`` (a float, or a :data:`Schedule` through
    :func:`_scheduled`), capturable over plain CUDA leaves."""
    def make(leaves):
        leaves = list(leaves)
        lr = 1.0 if callable(learning_rate) else learning_rate
        opt = cls(leaves, lr=lr, capturable=_on_card(leaves), **hyper)
        return _scheduled(opt, learning_rate) if callable(learning_rate) else opt

    return make


def adam(
    learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """``optax.adam``'s counterpart: makes a ``torch.optim.Adam`` over a
    list of parameter leaves, with optax's defaults. ``learning_rate`` is a
    float or a :data:`Schedule` (e.g. :func:`warmup_cosine_decay_schedule`).

    Over plain CUDA leaves the optimizer is ``capturable``: its step count
    lives on the device and its bias correction is computed there in f32,
    so its update can be replayed from a CUDA graph (:func:`make_train_step`)."""
    return _adam_like(torch.optim.Adam, learning_rate, betas=(b1, b2), eps=eps)


def adamw(
    learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 1e-4,
) -> Optimizer:
    """``optax.adamw``'s counterpart, with optax's defaults: a
    ``torch.optim.AdamW``, whose decay ``p · (1 - lr·wd)`` before the Adam
    step is optax's decoupled ``-lr · (adam_update + wd · p)``.
    ``learning_rate`` and ``capturable`` as :func:`adam`'s."""
    return _adam_like(torch.optim.AdamW, learning_rate, betas=(b1, b2), eps=eps,
                      weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: torch.optim.Optimizer
    step: int = 0


def create_train_state(params: Any, optimizer: Optimizer) -> TrainState:
    """A state over ``params``, whose leaves become (or stay) leaf tensors
    that require a gradient, and a fresh optimizer over them (zero
    moments, as ``optimizer.init`` gives in optax)."""
    params = tree_map(
        lambda t: t if t.is_leaf and t.requires_grad
        else t.detach().clone().requires_grad_(True),
        params,
    )
    return TrainState(params=params, opt_state=optimizer(tree_leaves(params)))


def _whole(t):
    """A DTensor's whole value, through a differentiable all-gather (the
    gradient returns to the DTensor's own placements); any other value as
    it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _check_modes(neg_mode: str, num_pos_samples: Optional[int]) -> None:
    if neg_mode not in ("uniform", "roll"):
        raise ValueError(f"unknown neg_mode: {neg_mode!r}")
    if neg_mode == "roll" and num_pos_samples is not None:
        raise ValueError("neg_mode='roll' scores all positives; it is "
                         "incompatible with num_pos_samples")


def _graph_refusal(config: HyperGNNConfig, num_pos_samples: Optional[int],
                   opt: torch.optim.Optimizer, tensors: list, neg_dst) -> Optional[str]:
    """Why a call of the step runs eagerly, or None where a CUDA graph of
    it can stand in for it: the call draws nothing from ``gen``, every
    tensor in ``tensors`` (the parameter leaves, the features, the graph
    arrays, the SortPlan's arrays) is a plain tensor on one CUDA device, and
    the optimizer's update does not change on the host from one step to
    the next (a capturable Adam or AdamW without step hooks, such as a
    schedule's ``LambdaLR``)."""
    if config.dropout > 0.0:
        return "dropout draws its masks from gen"
    if num_pos_samples is not None:
        return "the positives are drawn from gen"
    if neg_dst is None:
        return "the negatives are drawn from gen"
    if not isinstance(neg_dst, (int, torch.Tensor)):
        return "neg_dst is neither a tensor nor an int"
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        return "an input is not a tensor"
    if any(isinstance(t, DTensor) for t in (*tensors, neg_dst)):
        return "DTensors: the sharded step gathers them at its entry"
    if getattr(opt, "_optimizer_step_pre_hooks", None) or getattr(
            opt, "_optimizer_step_post_hooks", None):
        return "the optimizer's step has hooks (a learning-rate schedule)"
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors) or (
            isinstance(neg_dst, torch.Tensor) and neg_dst.device != dev):
        return "the tensors are not all on one CUDA device"
    if type(opt) not in (torch.optim.Adam, torch.optim.AdamW) or not all(
            g["capturable"] for g in opt.param_groups):
        return "the optimizer is not a capturable Adam or AdamW"
    return None


def _identity(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.shape, t.stride(), t.dtype


def _graph_key(tensors: list, opt: torch.optim.Optimizer, neg_dst) -> tuple:
    """What a captured step is good for: the memory of every input and of
    the optimizer's parameters and state, its hyperparameters, and the
    kind of ``neg_dst`` (whose values the replay copies in)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    state = [v for p in params for v in opt.state.get(p, {}).values()
             if isinstance(v, torch.Tensor)]
    hyper = tuple(tuple((k, v) for k, v in g.items() if k != "params")
                  for g in opt.param_groups)
    neg = (neg_dst.shape, neg_dst.dtype) if isinstance(neg_dst, torch.Tensor) else int
    return tuple(map(_identity, (*tensors, *params, *state))), hyper, neg


@dataclasses.dataclass
class _Graph:
    """A captured step: its key, the graph, its static negatives and loss,
    the gradients it writes, and what its capture counted (the port's
    counters, the kernels' launches among them)."""

    key: tuple
    graph: Any
    neg: torch.Tensor
    loss: torch.Tensor
    grads: list
    counts: dict


class _TrainStep:
    """The step :func:`make_train_step` returns: ``run`` (one eager step)
    behind the CUDA graph that stands in for it where it can."""

    def __init__(self, config: HyperGNNConfig, num_pos_samples: Optional[int], run: Callable):
        self.config, self.num_pos_samples, self.run = config, num_pos_samples, run
        self.graph: Optional[_Graph] = None
        self.warmed = None  # the key of the inputs after the last warm-up
        self.eager = False  # set for good when a capture raises
        self.stream = None

    def __call__(self, params, opt_state: torch.optim.Optimizer, node_features, src, dst,
                 rel_ids, edge_mask, char_ids, text_lengths, gen: torch.Generator,
                 neg_dst=None, sort_plan=None) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        args = (params, opt_state, node_features, src, dst, rel_ids, edge_mask, char_ids,
                text_lengths, gen)
        with span("train_step"):
            loss = None if self.eager else self._graphed(args, neg_dst, sort_plan)
            if loss is None:
                loss = self.run(*args, neg_dst, sort_plan)
            return params, opt_state, loss

    def _graphed(self, args, neg_dst, sort_plan) -> Optional[torch.Tensor]:
        """The call's loss through the graph, or None where it runs eagerly."""
        opt = args[1]
        plan = [] if sort_plan is None else [t for t in vars(sort_plan).values() if t is not None]
        tensors = [*tree_leaves(args[0]), *args[2:9], *plan]
        if _graph_refusal(self.config, self.num_pos_samples, opt, tensors, neg_dst):
            return None
        key = _graph_key(tensors, opt, neg_dst)
        if self.graph is not None and self.graph.key == key:
            return self._replay(neg_dst)
        if self.warmed != key:
            loss = self._warm_up(args, neg_dst, sort_plan)
            # The key the next call brings: a first step makes Adam's state.
            self.warmed = _graph_key(tensors, opt, neg_dst)
            return loss
        return self._capture(key, args, neg_dst, sort_plan)

    def _warm_up(self, args, neg_dst, sort_plan) -> torch.Tensor:
        """The call's step, eagerly, on the stream that will capture it, so
        that what a first call makes (Adam's state, the gradients, the
        kernels' ticket counters of that stream, library handles) is made
        outside the capture."""
        dev = args[2].device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        caller = torch.cuda.current_stream(dev)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            loss = self.run(*args, neg_dst, sort_plan)
        caller.wait_stream(self.stream)
        return loss

    def _capture(self, key, args, neg_dst, sort_plan) -> Optional[torch.Tensor]:
        """Capture the call's step and replay it; None where the capture
        raised (the step then runs eagerly, this call and every later one).
        The capture runs under a tally, so what it counts, the kernels'
        launches among it, stays out of the registry: the replays count it,
        and a capture that raised counted nothing."""
        opt, dev = args[1], args[2].device
        self.graph = None
        neg = (neg_dst.clone() if isinstance(neg_dst, torch.Tensor)
               else torch.tensor(neg_dst, device=dev))
        # The gradients of the capture are the graph's own, written anew by
        # every replay.
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        try:
            with tally() as counts, torch.cuda.graph(graph, stream=self.stream):
                loss = self.run(*args, neg, sort_plan)
        except RuntimeError as err:  # CUDA's refusals of work a capture cannot hold
            self.eager = True
            count("train_step_graph_fallbacks", 1)
            warnings.warn(f"the training step could not be captured as a CUDA graph and "
                          f"runs eagerly from now on: {err}", RuntimeWarning, stacklevel=4)
            return None
        grads = [(p, p.grad) for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        self.graph = _Graph(key, graph, neg, loss, grads, counts)
        count("train_step_graph_captures", 1)
        return self._replay(None)

    def _replay(self, neg_dst) -> torch.Tensor:
        """One step from the graph, on the caller's stream, with the call's
        negatives copied in (None: they are there); a copy of its loss."""
        g = self.graph
        if isinstance(neg_dst, torch.Tensor):
            g.neg.copy_(neg_dst)
        elif neg_dst is not None:
            g.neg.fill_(neg_dst)
        g.graph.replay()
        for p, grad in g.grads:
            if p.grad is not grad:
                p.grad = grad
        count("train_step_graph_replays", 1)
        for name, n in g.counts.items():
            count(name, n)
        return g.loss.clone()


def make_train_step(
    config: HyperGNNConfig,
    *,
    margin: float = 1.0,
    num_pos_samples: Optional[int] = None,
    neg_mode: str = "uniform",
    num_negatives: int = 1,
    adversarial_temperature: float = 0.0,
) -> Callable:
    """Build a ``(params, opt_state, node_features, src, dst, rel_ids,
    edge_mask, char_ids, text_lengths, gen, neg_dst=None, sort_plan=None) →
    (params, opt_state, loss)`` step.

    ``opt_state`` is the ``torch.optim.Optimizer`` over the leaves of
    ``params`` (:func:`create_train_state`); it carries its own
    hyperparameters, which the JAX step takes as its ``optimizer``
    argument. The update is in place; ``params`` and ``opt_state`` are
    returned as the JAX step returns them. ``loss`` is a 0-d tensor on the
    device, read by nobody inside the step, and a loss a caller keeps is
    never changed by a later step.

    Negatives are drawn from ``gen`` uniformly over nodes (tail corruption),
    unless ``neg_dst`` is given. ``num_pos_samples`` scores a uniform
    subsample of positives instead of all E. ``neg_mode="roll"`` takes the
    positive tails under one random rotation per step, the shift drawn in
    ``[1, E)`` or given as ``neg_dst``; the loss then runs sort-free through
    ``sort_plan``, which it requires, and all positives are scored.
    ``num_negatives`` K > 1 averages the hinge over K uniform tails per
    positive, and ``adversarial_temperature`` T > 0 weights them by
    ``softmax(T * neg_score)``. Dropout is on when ``config.dropout > 0``.

    **CUDA graph.** A call replays its whole step (forward, loss, backward,
    Adam) from one CUDA graph where its inputs allow it: ``neg_dst`` given,
    no dropout, no ``num_pos_samples``, every parameter and array a plain
    tensor on one CUDA device, and a capturable Adam or AdamW without step
    hooks (:func:`adam` over CUDA leaves, at a constant learning rate; a
    schedule keeps the step eager). Every call makes one update on its own
    inputs. The first call with given inputs runs eagerly on the stream the
    graph is captured on; the next with the same inputs captures the step
    and replays it; later ones replay it, with their ``neg_dst`` copied into
    the graph's own buffer. The inputs are told apart by the data pointer,
    shape, stride and dtype of every array, parameter leaf and Adam state
    tensor, and by Adam's hyperparameters: a change makes the next calls
    capture again. A replay adds to the port's counters, the kernels'
    launches among them, what the captured step counted. A capture that raises
    warns, counts ``train_step_graph_fallbacks`` and leaves the step eager
    for good; ``train_step_graph_captures`` and ``train_step_graph_replays``
    count the rest. Every other call (the CPU, the sharded step, negatives
    or dropout drawn from ``gen``, schedules) runs eagerly, as it is.

    The parameters and the arrays may be DTensors placed by
    ``parallel.shard_params`` / ``shard_graph_arrays`` (the sharded step):
    the step computes on their whole values, gathered at its entry, since
    the kernels' launches take plain tensors; the gradients return to each
    parameter's own shards, and Adam updates them in place, so the
    parameters keep their placements. Every rank computes the whole step,
    so every rank passes the same ``gen`` state (or ``neg_dst``).

    A step is span ``train_step``, with ``loss`` (the forward and the
    loss), ``backward`` and ``optimizer`` inside it (``utils/profiling.py``)
    where it runs eagerly; a replay enters ``train_step`` alone.
    """
    _check_modes(neg_mode, num_pos_samples)
    if num_negatives < 1:
        raise ValueError(f"num_negatives must be >= 1, got {num_negatives}")
    if num_negatives > 1 and neg_mode != "uniform":
        raise ValueError("num_negatives > 1 requires neg_mode='uniform'")
    if adversarial_temperature > 0.0 and num_negatives <= 1:
        raise ValueError("adversarial_temperature requires num_negatives > 1")

    def loss_fn(params, node_features, src, dst, rel_ids, edge_mask, char_ids,
                text_lengths, pos_src, pos_dst, pos_mask, neg_dst, gen,
                sort_plan):
        embs = apply_hypergnn(
            config, params, node_features, src, dst, rel_ids, edge_mask,
            char_ids, text_lengths, train=config.dropout > 0.0, gen=gen,
            sort_plan=sort_plan,
        )
        if neg_mode == "roll":
            # neg_dst carries the scalar rotation shift in this mode.
            return link_prediction_loss_sorted(
                embs, pos_src, pos_dst, sort_plan, neg_dst,
                margin=margin, edge_mask=pos_mask,
            )
        if num_negatives > 1:
            return multi_negative_loss(
                embs, pos_src, pos_dst, neg_dst, margin=margin,
                edge_mask=pos_mask,
                adversarial_temperature=adversarial_temperature,
            )
        return link_prediction_loss(
            embs, pos_src, pos_dst, neg_dst, margin=margin, edge_mask=pos_mask
        )

    def run(params, opt_state, node_features, src, dst, rel_ids, edge_mask, char_ids,
            text_lengths, gen, neg_dst, sort_plan) -> torch.Tensor:
        """One eager step; its loss, detached."""
        whole = tree_map(_whole, params)
        node_features, src, dst, rel_ids, edge_mask, char_ids, text_lengths = (
            _whole(t) for t in (node_features, src, dst, rel_ids, edge_mask, char_ids,
                                text_lengths))
        dev = node_features.device
        if num_pos_samples is None:
            pos_src, pos_dst, pos_mask = src, dst, edge_mask
        else:
            idx = torch.randint(
                0, src.shape[0], (num_pos_samples,), generator=gen, device=dev
            )
            pos_src, pos_dst, pos_mask = src[idx], dst[idx], edge_mask[idx]
        if neg_mode == "roll":
            if sort_plan is None:
                raise ValueError("neg_mode='roll' requires sort_plan")
            if neg_dst is None:
                neg_dst = torch.randint(
                    1, pos_src.shape[0], (), generator=gen, device=dev
                )
        elif neg_dst is None:
            neg_shape = (
                pos_src.shape if num_negatives == 1
                else (pos_src.shape[0], num_negatives)
            )
            neg_dst = torch.randint(
                0, node_features.shape[0], neg_shape, generator=gen,
                device=dev, dtype=pos_src.dtype,
            )
        opt_state.zero_grad(set_to_none=True)
        with span("loss"):
            loss = loss_fn(
                whole, node_features, src, dst, rel_ids, edge_mask, char_ids,
                text_lengths, pos_src, pos_dst, pos_mask, neg_dst, gen, sort_plan,
            )
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            opt_state.step()
        return loss.detach()

    return _TrainStep(config, num_pos_samples, run)


def make_multi_step(
    config: HyperGNNConfig,
    num_steps: int,
    *,
    margin: float = 1.0,
    num_pos_samples: Optional[int] = None,
    neg_mode: str = "uniform",
) -> Callable:
    """``num_steps`` training steps per call: ``(params, opt_state,
    node_features, *graph arrays, gen, sort_plan=None) → (params,
    opt_state, losses [num_steps])``.

    A Python loop over :func:`make_train_step`'s step, each drawing its own
    negatives from ``gen``; JAX fuses the loop into one program with
    ``lax.scan``, which has no counterpart to port. The losses stay on the
    device.
    """
    _check_modes(neg_mode, num_pos_samples)
    step = make_train_step(
        config, margin=margin, num_pos_samples=num_pos_samples, neg_mode=neg_mode
    )

    def multi_step(params, opt_state, node_features, src, dst, rel_ids,
                   edge_mask, char_ids, text_lengths, gen, sort_plan=None):
        losses = []
        for _ in range(num_steps):
            params, opt_state, loss = step(
                params, opt_state, node_features, src, dst, rel_ids,
                edge_mask, char_ids, text_lengths, gen, sort_plan=sort_plan,
            )
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return multi_step


def train(
    config: HyperGNNConfig,
    params: Any,
    node_features,
    graph: EncodedGraph,
    *,
    num_steps: int = 20,
    learning_rate: float = 1e-3,
    margin: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
    device=None,
) -> Tuple[Any, list]:
    """Convenience full-graph training loop (the ``demo.py`` §4 equivalent)
    on ``device`` (``None`` = the CUDA card; the CPU when asked by name).

    Returns the trained parameter tree and the per-step losses as floats.
    """
    dev = resolve_device(device)
    state = create_train_state(
        tree_map(lambda t: t.to(dev), params), adam(learning_rate)
    )
    step_fn = make_train_step(config, margin=margin)
    feats = torch.as_tensor(np.asarray(node_features), dtype=torch.float32, device=dev)
    arrays = tuple(torch.as_tensor(a, device=dev) for a in graph.arrays)
    plan = None if graph.sort_plan is None else graph.sort_plan.to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    params, opt_state, losses = state.params, state.opt_state, []
    for step in range(num_steps):
        params, opt_state, loss = step_fn(
            params, opt_state, feats, *arrays, gen, sort_plan=plan
        )
        losses.append(float(loss))
        if log_every and (step + 1) % log_every == 0:
            print(f"  step {step + 1:4d}  loss={losses[-1]:.4f}")
    return params, losses
