"""WeightGenerator: text embedding → one GNN layer's weight matrices.

The port of ``graph_hypernetwork_forge_tpu/models/weight_generator.py``:
three MLP heads (``W_msg [d_in, d_out]``, ``W_self [d_in, d_out]``,
``bias [d_out]``), each ``[Linear → ReLU] × num_hidden → Linear``, with

- the final Linear of each head initialized ``N(0, 0.01)`` weight / zero bias,
- a per-head scalar scale stored in log space (``log(init_scale)``) and
  applied as ``exp(log_scale)`` to the reshaped output,
- the batched/unbatched contract: ``[text_dim]`` gives unbatched shapes,
  ``[B, text_dim]`` batched ones,
- ``ValueError`` on non-positive ``text_dim``/``d_in``/``d_out``.

For U relation texts the whole ``[U, d_in, d_out]`` bank comes out at once
and stays at relation granularity. In training mode with ``dropout > 0``,
dropout follows each hidden ReLU (torch ``nn.Dropout`` semantics: kept
entries scaled by ``1 / (1 - p)``), its keep masks drawn from an explicit
``torch.Generator`` or handed in by the caller.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from graph_hypernetwork_forge_tpu_torch.device import resolve_device
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    linear_apply,
    linear_params,
    linear_params_normal,
    tree_leaves,
    tree_to,
)


@dataclasses.dataclass(frozen=True)
class WeightGeneratorConfig:
    text_dim: int
    d_in: int
    d_out: int
    hidden_dim: int = 128
    num_hidden: int = 2
    dropout: float = 0.0
    init_scale: float = 0.01

    def __post_init__(self):
        if self.text_dim <= 0 or self.d_in <= 0 or self.d_out <= 0:
            raise ValueError("text_dim, d_in, d_out must all be positive integers")

    @property
    def weight_specs(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        return (
            ("W_msg", (self.d_in, self.d_out)),
            ("W_self", (self.d_in, self.d_out)),
            ("bias", (self.d_out,)),
        )


def init_weight_generator(config: WeightGeneratorConfig, gen: torch.Generator) -> dict:
    params: dict = {"heads": {}, "log_scales": {}}
    for name, shape in config.weight_specs:
        layers = []
        prev = config.text_dim
        for _ in range(config.num_hidden):
            layers.append(linear_params(gen, prev, config.hidden_dim))
            prev = config.hidden_dim
        # Final head: small init so generated weights start near zero.
        layers.append(linear_params_normal(gen, prev, math.prod(shape), std=0.01))
        params["heads"][name] = layers
        params["log_scales"][name] = torch.full((1,), math.log(config.init_scale))
    return params


def draw_dropout_masks(
    config: WeightGeneratorConfig, batch: int, gen: torch.Generator
) -> Dict[str, List[torch.Tensor]]:
    """Keep masks ``{head: [[batch, hidden_dim] bool] * num_hidden}``, each
    entry kept with probability ``1 - dropout``, drawn from ``gen`` on its
    device."""
    return {
        name: [
            torch.rand((batch, config.hidden_dim), generator=gen, device=gen.device)
            < 1.0 - config.dropout
            for _ in range(config.num_hidden)
        ]
        for name, _ in config.weight_specs
    }


def apply_weight_generator(
    config: WeightGeneratorConfig,
    params: dict,
    text_emb: torch.Tensor,
    *,
    train: bool = False,
    gen: torch.Generator | None = None,
    keep: Dict[str, List[torch.Tensor]] | None = None,
) -> Dict[str, torch.Tensor]:
    """``{"W_msg": [B, d_in, d_out], "W_self": ..., "bias": [B, d_out]}``.

    Accepts ``[text_dim]`` (returns unbatched) or ``[B, text_dim]``.
    Dropout between hidden layers is active only when ``train`` and
    ``config.dropout > 0``; its masks are ``keep`` (as
    :func:`draw_dropout_masks` makes them) or else drawn from ``gen``.
    """
    single = text_emb.dim() == 1
    if single:
        text_emb = text_emb[None, :]
    p = config.dropout
    use_dropout = train and p > 0.0
    if use_dropout and keep is None:
        if gen is None:
            raise ValueError("dropout requires a torch.Generator in training mode")
        keep = draw_dropout_masks(config, text_emb.shape[0], gen)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in config.weight_specs:
        x = text_emb
        layers = params["heads"][name]
        for i, layer in enumerate(layers[:-1]):
            x = torch.relu(linear_apply(layer, x))
            if use_dropout:
                x = torch.where(keep[name][i], x / (1.0 - p), 0.0)
        flat = linear_apply(layers[-1], x)  # [B, prod(shape)]
        w = flat.reshape((x.shape[0],) + shape) * torch.exp(params["log_scales"][name])
        out[name] = w[0] if single else w
    return out


class WeightGenerator:
    """Standalone generator on ``device`` (``None`` = the CUDA card)."""

    def __init__(
        self,
        text_dim: int,
        d_in: int,
        d_out: int,
        hidden_dim: int = 128,
        num_hidden: int = 2,
        dropout: float = 0.0,
        init_scale: float = 0.01,
        *,
        seed: int = 0,
        device=None,
    ) -> None:
        self.config = WeightGeneratorConfig(
            text_dim=text_dim,
            d_in=d_in,
            d_out=d_out,
            hidden_dim=hidden_dim,
            num_hidden=num_hidden,
            dropout=dropout,
            init_scale=init_scale,
        )
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = tree_to(init_weight_generator(self.config, gen), self.device)

    @torch.inference_mode()
    def __call__(self, text_emb) -> Dict[str, torch.Tensor]:
        text_emb = torch.as_tensor(text_emb, dtype=torch.float32, device=self.device)
        return apply_weight_generator(self.config, self.params, text_emb)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in tree_leaves(self.params))
