"""Carry a JAX HyperGNN parameter tree across to the port.

The JAX package stores linear weights ``[d_in, d_out]`` and applied as
``x @ w + b``, and so does the port, so every leaf copies as it is. The
mapping goes key for key over the tree of
``graph_hypernetwork_forge_tpu/models/hypergnn.py:init_hypergnn`` and fails
with a ``KeyError`` on a missing key. Its input holds numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); this module imports no
JAX.

Only parameters carry across, not optimizer state: training in either
package starts Adam from fresh zero moments (``optax.adam(...).init`` and
``training.create_train_state``), so a run moved to the port at step 0
needs nothing else.
"""

from __future__ import annotations

import numpy as np
import torch


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
