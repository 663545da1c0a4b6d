"""Carry a JAX HyperGNN parameter tree across to the port.

The JAX package stores linear weights ``[d_in, d_out]`` and applied as
``x @ w + b``, and so does the port, so every leaf copies as it is. The
mapping goes key for key over the tree of
``graph_hypernetwork_forge_tpu/models/hypergnn.py:init_hypergnn`` and fails
with a ``KeyError`` on a missing key. Its input holds numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); this module imports no
JAX.

Optimizer state carries across too: :func:`train_state_from_jax` turns
``optax.adam`` state (``ScaleByAdamState``: ``mu``, ``nu``, ``count``) into
a ``torch.optim.Adam`` state (``exp_avg``, ``exp_avg_sq``, ``step``), key
for key over the same tree, so a JAX run restored from its checkpoint
resumes in the port where it stopped.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.training.train import (
    Optimizer,
    TrainState,
    create_train_state,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_leaves, tree_map


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _linear(p: dict) -> dict:
    return {"w": _tensor(p["w"]), "b": _tensor(p["b"])}


def text_encoder_from_jax(p: dict) -> dict:
    return {"char_emb": _tensor(p["char_emb"]), "proj": _linear(p["proj"])}


def weight_generator_from_jax(p: dict) -> dict:
    return {
        "heads": {
            name: [_linear(layer) for layer in layers]
            for name, layers in p["heads"].items()
        },
        "log_scales": {
            name: _tensor(s) for name, s in p["log_scales"].items()
        },
    }


def params_from_jax(p: dict) -> dict:
    """The port's HyperGNN parameter tree (CPU float32 tensors) from the
    JAX package's tree of numpy arrays."""
    return {
        "text_encoder": text_encoder_from_jax(p["text_encoder"]),
        "input_proj": _linear(p["input_proj"]),
        "weight_generators": [
            weight_generator_from_jax(g) for g in p["weight_generators"]
        ],
        "layer_norms": [
            {"g": _tensor(ln["g"]), "b": _tensor(ln["b"])} for ln in p["layer_norms"]
        ],
    }


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax state (``optax.adam``'s is
    ``(ScaleByAdamState, EmptyState)``)."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def train_state_from_jax(
    params: dict, opt_state, optimizer: Optimizer, *, device=None
) -> TrainState:
    """A :class:`TrainState` on ``device`` (None: the CUDA card) from the
    JAX package's parameters and ``optax.adam`` state, both as numpy trees
    (``jax.tree_util.tree_map(np.asarray, ...)``). ``optimizer`` is
    ``training.adam`` with the JAX run's hyperparameters; its moments and
    step count, and the state's ``step``, are the JAX run's."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no optax ScaleByAdamState (mu, nu, count)")
    dev = resolve_device(device)
    state = create_train_state(
        tree_map(lambda t: t.to(dev), params_from_jax(params)), optimizer
    )
    mu, nu = tree_leaves(params_from_jax(adam.mu)), tree_leaves(params_from_jax(adam.nu))
    count = int(np.asarray(adam.count))
    leaves = state.opt_state.param_groups[0]["params"]
    for p, m, v in zip(leaves, mu, nu, strict=True):
        state.opt_state.state[p] = {
            "step": torch.tensor(float(count)), "exp_avg": m.to(dev),
            "exp_avg_sq": v.to(dev),
        }
    state.step = count
    return state
