"""2D composed training: the composed step's edge/node/relation sharding
times tensor parallelism, over an ``("edge", "model")`` mesh.

The port of ``graph_hypernetwork_forge_tpu/parallel/composed_tp.py``.

- The **edge axis** works as in ``composed.py``: nodes range-sharded, edges
  owned by dst, relation texts sharded, the halo exchange a layer and local
  scoring (``local_roll``).
- The **model axis** splits the generator heads as ``tensor_parallel.py``
  does (column- then row-parallel hidden layers, one ``psum("model")``
  mid-head, a column-parallel final Linear), so a rank generates
  ``[U/k_e, d_in/k_m, d_out]`` bank blocks.
- The banks are gathered over the edge axis only: ``[U, d_in/k_m, d_out]``;
  no rank holds them whole.
- A rank contracts its ``rows[:, d_in-slice]`` against its bank blocks and
  one ``psum("model")`` of the per-edge ``[cap, d_out]`` partials restores
  the whole contraction before the bias, mask and aggregation.

Halo mode only, ``contrib`` ``dense`` or ``grouped`` (no kernel, as in JAX).
The model axis only re-orders the d_in contraction, so the step matches the
1D composed step to float tolerance.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import apply_text_encoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import draw_dropout_masks
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import _RaggedTransform
from graph_hypernetwork_forge_tpu_torch.ops.segment import (
    segment_count,
    segment_sum,
    sorted_segment_sum_by_plan,
)
from graph_hypernetwork_forge_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    copy,
    psum,
)
from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
    _gather_rows,
    _halo_exchange,
    _local_roll_loss,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import _named
from graph_hypernetwork_forge_tpu_torch.parallel.tensor_parallel import (
    _check_divides,
    _shard_tree,
    tp_generate_local,
    tp_param_specs,
)
from graph_hypernetwork_forge_tpu_torch.training.train import Optimizer
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (
    layer_norm_apply,
    linear_apply,
    tree_map,
)


def composed_tp_param_specs(config: HyperGNNConfig, mesh: DeviceMesh,
                            model_axis: str = "model") -> dict:
    """Placements of the whole parameter tree on an (edge, model) mesh:
    the generator heads split over ``model_axis`` (``tp_param_specs``),
    every other leaf replicated."""
    repl = _named(mesh)
    lin = {"w": repl, "b": repl}
    return {
        "text_encoder": {"char_emb": repl, "proj": lin},
        "input_proj": lin,
        "weight_generators": [tp_param_specs(config.weight_generator, mesh, model_axis)
                              for _ in range(config.num_layers)],
        "layer_norms": [{"g": repl, "b": repl} for _ in range(config.num_layers)],
    }


def shard_composed_tp_params(params: dict, config: HyperGNNConfig, mesh: DeviceMesh,
                             model_axis: str = "model") -> dict:
    """This rank's blocks of the whole parameters under
    :func:`composed_tp_param_specs` (copies, to be optimised as leaves)."""
    _check_divides(config.weight_generator, mesh_axis_size(mesh, model_axis))
    return _shard_tree(params, composed_tp_param_specs(config, mesh, model_axis), mesh)


def make_composed_tp_train_step(
    mesh: DeviceMesh,
    config: HyperGNNConfig,
    optimizer: Optimizer,
    nodes_per_shard: int,
    *,
    edge_axis: str = "edge",
    model_axis: str = "model",
    margin: float = 1.0,
    halo_width: Optional[int] = None,
    contrib: str = "dense",
    agg_sorted: bool = False,
) -> Callable:
    """The 2D-sharded training step (forward, backward, Adam).

    Returns ``step(params, opt_state, feats, src, dst, rel, mask, chars,
    lens, gen, src_halo=None, send_idx=None, rel_group_sizes=None,
    agg_plan=None, neg=None) → (params, opt_state, loss)``, the composed
    step's calling convention in halo mode: the arrays are this rank's
    blocks over ``edge_axis`` (the same on every model rank), ``params``
    this rank's blocks (:func:`shard_composed_tp_params`) and ``opt_state``
    the optimizer over them. ``neg`` is the rank's rotation, drawn from
    ``gen`` in ``[1, max(cap, 2))`` when None.

    Dropout (``config.dropout > 0``) is coordinated: ranks of one edge
    index hold generators in the same state, and each draws the 1D step's
    masks in its order (the column-parallel hidden layer takes its columns
    of the whole-width mask), so the masks equal the 1D composed step's
    under the same generators.
    """
    gen_cfg = config.weight_generator
    k_m = mesh_axis_size(mesh, model_axis)
    if halo_width is None:
        raise ValueError("make_composed_tp_train_step requires halo mode "
                         "(halo_width from prepare_composed_inputs(halo=True))")
    _check_divides(gen_cfg, k_m)
    if contrib not in ("dense", "grouped"):
        raise ValueError(f"unknown contrib backend: {contrib!r}")
    npp, p = nodes_per_shard, config.dropout
    din = gen_cfg.d_in // k_m

    def forward_local(params, feats_l, srch_l, dst_l, rel_l, mask_l, chars_l, lens_l,
                      exchange, sizes, agg, gen):
        me_e, me_m = axis_index(mesh, edge_axis), axis_index(mesh, model_axis)
        h = torch.relu(linear_apply(params["input_proj"], feats_l,
                                    precision=config.precision))
        text = apply_text_encoder(params["text_encoder"], chars_l, lens_l,
                                  precision=config.precision)
        local_dst = _gather_rows(dst_l - me_e * npp, npp)
        for layer in range(config.num_layers):
            wg_keep = h_keep = None
            if gen is not None:
                wg_keep = draw_dropout_masks(gen_cfg, text.shape[0], gen)
                h_keep = torch.rand((npp, config.hidden_dim), generator=gen,
                                    device=gen.device) < 1.0 - p
            local_w = tp_generate_local(mesh, gen_cfg, params["weight_generators"][layer],
                                        text, axis=model_axis, keep=wg_keep)
            # Banks gathered over the edge axis only: [U, d_in/k_m, d_out].
            w = {name: copy(all_gather(v, mesh, edge_axis), mesh, edge_axis)
                 for name, v in local_w.items()}
            rows = copy(exchange(h), mesh, model_axis)[:, me_m * din:(me_m + 1) * din]
            if contrib == "grouped":
                part = (_RaggedTransform.apply(rows.index_select(0, srch_l), w["W_msg"], sizes)
                        + _RaggedTransform.apply(rows.index_select(0, local_dst),
                                                 w["W_self"], sizes))
            else:
                hw = torch.matmul(rows, torch.cat([w["W_msg"], w["W_self"]]))
                u, rel = w["W_msg"].shape[0], rel_l.long()
                part = hw[rel, srch_l.long()] + hw[rel + u, local_dst.long()]
            # One activation psum restores the whole d_in contraction.
            full = (psum(part, mesh, model_axis) + w["bias"].index_select(0, rel_l)
                    ) * mask_l[:, None]
            if agg is not None:
                perm, inv, dsort, splits, indeg = agg
                total = sorted_segment_sum_by_plan(full, perm, inv, dsort.clamp(0, npp - 1),
                                                   npp, splits[0])
                cnt = indeg[0].clamp(min=1.0)
            else:
                total = segment_sum(full, local_dst, npp)
                cnt = segment_count(local_dst, npp, mask_l).clamp(min=1.0)
            h_new = torch.relu(total / cnt[:, None] + h)
            if h_keep is not None:
                h_new = torch.where(h_keep, h_new / (1.0 - p), 0.0)
            h = layer_norm_apply(params["layer_norms"][layer], h_new)
        return h, local_dst

    def step(params, opt_state: torch.optim.Optimizer, feats, src, dst, rel, mask,
             chars, lens, gen: torch.Generator, src_halo=None, send_idx=None,
             rel_group_sizes=None, agg_plan=None, neg=None
             ) -> Tuple[Any, torch.optim.Optimizer, torch.Tensor]:
        if src_halo is None or send_idx is None:
            raise ValueError("2D step needs src_halo and send_idx "
                             "(prepare_composed_inputs(halo=True))")
        if contrib == "grouped" and rel_group_sizes is None:
            raise ValueError("contrib='grouped' needs rel_group_sizes")
        if agg_sorted and agg_plan is None:
            raise ValueError("agg_sorted=True needs agg_plan")
        cap = dst.shape[0]
        if neg is None:
            neg = torch.randint(1, max(cap, 2), (), generator=gen, device=feats.device)
        opt_state.zero_grad(set_to_none=True)
        # Every parameter enters per-edge-rank work through copy("edge");
        # model-replicated values that feed per-model-rank work take the
        # model copy where they are used (tp_generate_local, the row slice).
        prm = tree_map(lambda t: copy(t, mesh, edge_axis), params)
        exchange = _halo_exchange(mesh, edge_axis, send_idx, halo_width, None)
        h, local_dst = forward_local(
            prm, feats, src_halo, dst, rel, mask, chars, lens, exchange,
            None if rel_group_sizes is None else rel_group_sizes[0].tolist(),
            agg_plan if agg_sorted else None, gen if p > 0.0 else None)
        loss = _local_roll_loss(mesh, edge_axis, h, exchange(h), src_halo, local_dst, mask,
                                int(neg), margin)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step
