"""Relation sharding: the hypernetwork's expert-parallel axis.

The port of ``graph_hypernetwork_forge_tpu/parallel/relation_sharding.py``.
Text encoding and weight generation cost O(U · MLP) and are independent
per relation, so the padded relation arrays are sharded over a mesh axis:
each rank encodes its U/k texts and generates its rows of the ``[U, d_in,
d_out]`` banks, and an ``all_gather`` assembles the whole banks. Each row
is computed as one rank would compute it alone.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.models.text_encoder import apply_text_encoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    WeightGeneratorConfig,
    apply_weight_generator,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import all_gather, copy
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_map


def relation_sharded_generate(
    mesh: DeviceMesh,
    wg_config: WeightGeneratorConfig,
    text_encoder_params: dict,
    weight_generator_params: dict,
    char_ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    axis: str = "model",
    precision: str = "highest",
) -> Dict[str, torch.Tensor]:
    """Encode texts and generate the weight banks with U sharded over
    ``axis``.

    ``char_ids`` ``[U/k, L]`` and ``lengths`` ``[U/k]`` are this rank's
    rows of the padded relation arrays (``U_pad`` divisible by the axis
    size: the encoding pads U to a multiple of 8); the parameters are
    whole. Returns the whole ``{"W_msg": [U, d_in, d_out], "W_self": ...,
    "bias": [U, d_out]}``, replicated.
    """
    te_params, wg_params = (
        tree_map(lambda t: copy(t, mesh, axis), p)
        for p in (text_encoder_params, weight_generator_params)
    )
    text_embs = apply_text_encoder(te_params, char_ids, lengths, precision=precision)
    local = apply_weight_generator(wg_config, wg_params, text_embs)
    return {name: all_gather(v, mesh, axis) for name, v in local.items()}
