"""Tensor parallelism for the hypernetwork: Megatron-split generator heads
and d_in-sharded weight banks.

The port of ``graph_hypernetwork_forge_tpu/parallel/tensor_parallel.py``.
Each matrix head's final Linear is ``[hidden, d_in·d_out]`` and the banks it
generates ``[U, d_in, d_out]`` per layer; here both divide over one mesh
axis (``"model"``):

- head Linear 1 column-parallel (``[text_dim, hidden/k]``, bias sharded);
- head Linear 2 row-parallel (``[hidden/k, hidden]``), then one ``psum``
  (Megatron's MLP: one collective in the middle of the head);
- the final Linear column-parallel over the flattened ``d_in·d_out``
  output: a contiguous 1/k block of the row-major ``(d_in, d_out)`` space
  is ``d_in/k`` whole rows, so a rank's bank is ``[U, d_in/k, d_out]``;
- the ``bias`` head and ``log_scales`` stay whole.

Message passing contracts each rank's ``h[:, d_in-slice]`` against its bank
block, and one ``psum`` of the ``[2U, N, d_out]`` product restores the
whole contraction. Functions follow ``collectives.py``'s convention: a
rank's blocks in and out where JAX says ``P(axis)``, whole arrays for
``P()``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    WeightGeneratorConfig,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import two_stream_tail
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    axis_index,
    copy,
    psum,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import _named, local_shard
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    check_precision,
    linear_apply,
)


def tp_head_specs(config: WeightGeneratorConfig, mesh: DeviceMesh,
                  axis: str = "model") -> list:
    """Placements of one matrix head's layer list: column-, row-, then
    column-parallel. Defined for the reference topology only
    (``num_hidden=2``)."""
    if config.num_hidden != 2:
        raise ValueError(
            "TP head split is defined for the reference topology "
            f"num_hidden=2 (got {config.num_hidden})"
        )
    return [
        {"w": _named(mesh, None, axis), "b": _named(mesh, axis)},
        {"w": _named(mesh, axis, None), "b": _named(mesh)},
        {"w": _named(mesh, None, axis), "b": _named(mesh, axis)},
    ]


def tp_param_specs(config: WeightGeneratorConfig, mesh: DeviceMesh,
                   axis: str = "model") -> dict:
    """Placements mirroring ``init_weight_generator``'s tree: the matrix
    heads split, the ``bias`` head and the log-scales whole."""
    repl = _named(mesh)
    return {
        "heads": {
            "W_msg": tp_head_specs(config, mesh, axis),
            "W_self": tp_head_specs(config, mesh, axis),
            "bias": [{"w": repl, "b": repl} for _ in range(config.num_hidden + 1)],
        },
        "log_scales": {name: repl for name, _ in config.weight_specs},
    }


def _check_divides(config: WeightGeneratorConfig, k: int) -> None:
    if config.hidden_dim % k or config.d_in % k:
        raise ValueError(
            f"generator hidden_dim ({config.hidden_dim}) and d_in ({config.d_in}) "
            f"must divide the model axis ({k})"
        )


def _shard_tree(params, specs, mesh: DeviceMesh):
    if isinstance(params, dict):
        return {k: _shard_tree(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [_shard_tree(v, s, mesh) for v, s in zip(params, specs)]
    return local_shard(params, specs, mesh)


def shard_generator_params(params: dict, config: WeightGeneratorConfig,
                           mesh: DeviceMesh, axis: str = "model") -> dict:
    """This rank's blocks of one generator's whole parameters under
    :func:`tp_param_specs` (copies, so they can be optimised as leaves)."""
    _check_divides(config, mesh_axis_size(mesh, axis))
    return _shard_tree(params, tp_param_specs(config, mesh, axis), mesh)


def tp_generate_local(
    mesh: DeviceMesh,
    config: WeightGeneratorConfig,
    params: dict,
    text_emb: torch.Tensor,
    *,
    axis: str = "model",
    keep: Dict[str, list] | None = None,
) -> Dict[str, torch.Tensor]:
    """The Megatron-split heads on this rank: ``W_msg`` / ``W_self`` as
    ``[U, d_in/k, d_out]`` blocks, ``bias`` whole ``[U, d_out]``.

    ``params`` are the rank's blocks; ``text_emb`` is replicated over
    ``axis``. It reaches the split heads through :func:`copy` and the
    replicated bias head directly, so its gradient sums the heads' ranks
    once and the bias head once. ``keep`` are whole-width dropout masks
    (``draw_dropout_masks``): the column-parallel first hidden layer takes
    this rank's columns of them, so every rank applies the mask one rank
    would.
    """
    k, me = mesh_axis_size(mesh, axis), axis_index(mesh, axis)
    _check_divides(config, k)
    h_k, p = config.hidden_dim // k, config.dropout
    prec = config.precision
    out = {}
    for name, shape in config.weight_specs:
        l1, l2, l3 = params["heads"][name]
        split = name != "bias"
        x = copy(text_emb, mesh, axis) if split else text_emb
        x = torch.relu(linear_apply(l1, x, precision=prec))
        if keep is not None:
            mask = keep[name][0][:, me * h_k:(me + 1) * h_k] if split else keep[name][0]
            x = torch.where(mask, x / (1.0 - p), 0.0)
        x = x @ l2["w"]
        if split:
            x = psum(x, mesh, axis)  # row-parallel reduction
        x = torch.relu(x + l2["b"])
        if keep is not None:
            x = torch.where(keep[name][1], x / (1.0 - p), 0.0)
        log_scale = params["log_scales"][name]
        if split:
            x, log_scale = copy(x, mesh, axis), copy(log_scale, mesh, axis)
        flat = linear_apply(l3, x, precision=prec)
        rows = (config.d_in // k, config.d_out) if split else shape
        out[name] = flat.reshape((x.shape[0],) + tuple(rows)) * torch.exp(log_scale)
    return out


def tp_generate_weights(
    mesh: DeviceMesh,
    config: WeightGeneratorConfig,
    params: dict,
    text_emb: torch.Tensor,
    *,
    axis: str = "model",
) -> Dict[str, torch.Tensor]:
    """Generate the weight banks with Megatron-split heads.

    ``params`` are this rank's blocks (:func:`shard_generator_params`),
    ``text_emb`` ``[U, text_dim]`` whole. Returns ``{"W_msg": [U, d_in/k,
    d_out], "W_self": same}`` (the rank's blocks of ``P(None, axis,
    None)``) and ``"bias": [U, d_out]`` whole: the matrix banks exist only
    as blocks.
    """
    return tp_generate_local(mesh, config, params, text_emb, axis=axis)


def tp_message_passing(
    mesh: DeviceMesh,
    h: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rel_ids: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    num_nodes: int,
    *,
    edge_mask: torch.Tensor | None = None,
    axis: str = "model",
    precision="highest",
) -> torch.Tensor:
    """Message passing over d_in-sharded banks, one ``psum`` a call.

    ``h`` ``[N, d_in]`` and the edge arrays are whole; ``weights`` are this
    rank's bank blocks and the whole bias (:func:`tp_generate_weights`).
    Each rank contracts its ``h[:, d_in-slice]`` against its blocks (the
    ``dense`` backend's all-relations product on the slice); the ``psum``
    restores the whole product before the count-clamped mean. Returns the
    whole ``[N, d_out]``, replicated.
    """
    check_precision(precision)
    me = axis_index(mesh, axis)
    w_msg, w_self = weights["W_msg"], weights["W_self"]
    din = w_msg.shape[1]
    h_slice = copy(h, mesh, axis)[:, me * din:(me + 1) * din]
    hw = psum(torch.matmul(h_slice, torch.cat([w_msg, w_self])), mesh, axis)
    u = w_msg.shape[0]
    rel, src, dst = rel_ids.long(), src.long(), dst.long()
    msg = hw[rel, src] + weights["bias"][rel]
    return two_stream_tail(msg, hw[rel + u, dst], dst, num_nodes, edge_mask=edge_mask)


def bank_shard_bytes(weights: Dict[str, torch.Tensor]) -> int:
    """Bytes this rank holds of the two matrix banks."""
    return sum(weights[n].numel() * weights[n].element_size() for n in ("W_msg", "W_self"))
