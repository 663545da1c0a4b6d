"""Full-graph training: the port of ``graph_hypernetwork_forge_tpu/training/train.py``.

The reference training semantics (Adam, margin-ranking loss, negatives by
corrupting the tail) as a step function: forward, loss, backward and one
``torch.optim.Adam`` update. The JAX step is one jitted XLA program; here
PyTorch runs eagerly and every launch of the step is queued without a host
round trip (the roll shift and the negatives are drawn on the device), so
the host only waits when the caller reads the loss.

Where the JAX step splits a ``jax.random`` key, the port draws from one
explicit ``torch.Generator`` on the device: the positive subsample, then
the negatives or the roll shift, then the dropout masks. The two packages'
random numbers differ, so ``neg_dst`` (the roll shift in ``neg_mode="roll"``)
can be handed in, which is how the tests give both the same negatives.
"""

from __future__ import annotations

import dataclasses
import math
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
from graph_hypernetwork_forge_tpu_torch.utils.profiling import span

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


def adam(
    learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """``optax.adam``'s counterpart: makes a ``torch.optim.Adam`` over a
    list of parameter leaves, with optax's defaults. ``learning_rate`` is a
    float or a :data:`Schedule` (e.g. :func:`warmup_cosine_decay_schedule`)."""
    if callable(learning_rate):
        return lambda leaves: _scheduled(
            torch.optim.Adam(leaves, lr=1.0, betas=(b1, b2), eps=eps), learning_rate)
    return lambda leaves: torch.optim.Adam(
        leaves, lr=learning_rate, betas=(b1, b2), eps=eps
    )


def adamw(
    learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 1e-4,
) -> Optimizer:
    """``optax.adamw``'s counterpart, with optax's defaults: a
    ``torch.optim.AdamW``, whose decay ``p · (1 - lr·wd)`` before the Adam
    step is optax's decoupled ``-lr · (adam_update + wd · p)``.
    ``learning_rate`` as :func:`adam`'s."""
    if callable(learning_rate):
        return lambda leaves: _scheduled(
            torch.optim.AdamW(leaves, lr=1.0, betas=(b1, b2), eps=eps,
                              weight_decay=weight_decay), learning_rate)
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )


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
    device, read by nobody inside the step.

    Negatives are drawn from ``gen`` uniformly over nodes (tail corruption),
    unless ``neg_dst`` is given. ``num_pos_samples`` scores a uniform
    subsample of positives instead of all E. ``neg_mode="roll"`` takes the
    positive tails under one random rotation per step, the shift drawn in
    ``[1, E)`` or given as ``neg_dst``; the loss then runs sort-free through
    ``sort_plan``, which it requires, and all positives are scored.
    ``num_negatives`` K > 1 averages the hinge over K uniform tails per
    positive, and ``adversarial_temperature`` T > 0 weights them by
    ``softmax(T * neg_score)``. Dropout is on when ``config.dropout > 0``.

    The parameters and the arrays may be DTensors placed by
    ``parallel.shard_params`` / ``shard_graph_arrays`` (the sharded step):
    the step computes on their whole values, gathered at its entry, since
    the kernels' launches take plain tensors; the gradients return to each
    parameter's own shards, and Adam updates them in place, so the
    parameters keep their placements. Every rank computes the whole step,
    so every rank passes the same ``gen`` state (or ``neg_dst``).

    A step is span ``train_step``, with ``loss`` (the forward and the
    loss), ``backward`` and ``optimizer`` inside it (``utils/profiling.py``).
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

    def train_step(
        params,
        opt_state: torch.optim.Optimizer,
        node_features: torch.Tensor,
        src: torch.Tensor,
        dst: torch.Tensor,
        rel_ids: torch.Tensor,
        edge_mask: torch.Tensor,
        char_ids: torch.Tensor,
        text_lengths: torch.Tensor,
        gen: torch.Generator,
        neg_dst=None,
        sort_plan=None,
    ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        with span("train_step"):
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
            return params, opt_state, loss.detach()

    return train_step


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
