"""Parameter initializers with torch-default distributions, and the
linear and LayerNorm applications of the parameter tree.

- Linear:    weight, bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
- Embedding: weight ~ N(0, 1)
- WeightGenerator head: weight ~ N(0, 0.01), bias = 0

Every draw takes an explicit ``torch.Generator``. Linear weights are stored
``[d_in, d_out]`` and applied as ``x @ w + b``, the JAX package's layout
(``graph_hypernetwork_forge_tpu/utils/initializers.py:16-18``), so its
parameters carry across without a transpose.
"""

from __future__ import annotations

import math

import torch


def linear_params(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    """Torch-default Linear init: U(-k, k) with k = 1/sqrt(d_in)."""
    bound = 1.0 / math.sqrt(d_in)
    w = torch.empty(d_in, d_out).uniform_(-bound, bound, generator=gen)
    b = torch.empty(d_out).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def linear_params_normal(
    gen: torch.Generator, d_in: int, d_out: int, std: float
) -> dict:
    """Normal(0, std) weight with zero bias (WeightGenerator head init)."""
    return {
        "w": torch.randn(d_in, d_out, generator=gen) * std,
        "b": torch.zeros(d_out),
    }


def embedding_params(gen: torch.Generator, vocab_size: int, dim: int) -> torch.Tensor:
    """Torch-default Embedding init: N(0, 1)."""
    return torch.randn(vocab_size, dim, generator=gen)


def layer_norm_params(dim: int) -> dict:
    """Torch-default LayerNorm init: scale 1, bias 0."""
    return {"g": torch.ones(dim), "b": torch.zeros(dim)}


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with ``w`` stored ``[d_in, d_out]``."""
    return x @ params["w"] + params["b"]


def layer_norm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps inside the sqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["g"] + params["b"]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_to(tree, device: torch.device):
    """Move every tensor of a parameter tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a parameter tree, paths joined with ``.``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def tree_leaves(tree) -> list:
    """Every leaf of a parameter tree."""
    return [leaf for _, leaf in named_leaves(tree)]
