"""Placements for HyperGNN training over a mesh (``torch.distributed.tensor``).

The port of ``graph_hypernetwork_forge_tpu/parallel/sharding.py``: the same
trees, key for key, with a tuple of DTensor placements (one per mesh axis)
where JAX has a ``NamedSharding``.

- Edge arrays (``src``, ``dst``, ``rel_ids``, ``edge_mask``) are
  ``Shard(0)`` on ``"edge"``; the relation texts are replicated.
- The last Linear of each WeightGenerator head is sharded on ``"model"``
  over its flattened output (``w``: ``Shard(1)``, ``b``: ``Shard(0)``);
  every other parameter is replicated.
- An axis the mesh lacks is replicated (JAX's ``_named``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.utils.initializers import tree_map

Placements = Tuple[Any, ...]


def _named(mesh: DeviceMesh, *axes) -> Placements:
    """The placements of ``PartitionSpec(*axes)``: ``Shard(i)`` on the mesh
    axis that tensor dim ``i`` names, ``Replicate()`` on every other."""
    return tuple(
        Shard(axes.index(name)) if name in axes else Replicate()
        for name in mesh.mesh_dim_names
    )


def hypergnn_param_shardings(config: HyperGNNConfig, mesh: DeviceMesh) -> Any:
    """Placements mirroring ``init_hypergnn``'s tree."""
    repl = _named(mesh)
    lin_repl = {"w": repl, "b": repl}

    def head_shardings() -> list:
        layers = [lin_repl for _ in range(config.weight_generator.num_hidden)]
        # Final generator layer: shard the flattened generated-weight dim.
        layers.append({"w": _named(mesh, None, "model"), "b": _named(mesh, "model")})
        return layers

    specs = config.weight_generator.weight_specs
    wg = {
        "heads": {name: head_shardings() for name, _ in specs},
        "log_scales": {name: repl for name, _ in specs},
    }
    return {
        "text_encoder": {"char_emb": repl, "proj": lin_repl},
        "input_proj": lin_repl,
        "weight_generators": [wg for _ in range(config.num_layers)],
        "layer_norms": [{"g": repl, "b": repl} for _ in range(config.num_layers)],
    }


def graph_array_shardings(mesh: DeviceMesh) -> tuple:
    """Placements in ``EncodedGraph.arrays`` order:
    (src, dst, rel_ids, edge_mask, char_ids, text_lengths)."""
    edge = _named(mesh, "edge")
    repl = _named(mesh)
    return (edge, edge, edge, edge, repl, repl)


def _distribute(tree: Any, placements: Any, mesh: DeviceMesh) -> Any:
    if isinstance(tree, dict):
        return {k: _distribute(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute(v, p, mesh) for v, p in zip(tree, placements)]
    return distribute_tensor(torch.as_tensor(tree), mesh, placements)


def shard_params(params: Any, config: HyperGNNConfig, mesh: DeviceMesh) -> Any:
    """The parameter tree as DTensors placed by :func:`hypergnn_param_shardings`."""
    return _distribute(params, hypergnn_param_shardings(config, mesh), mesh)


def shard_graph_arrays(arrays: tuple, mesh: DeviceMesh) -> tuple:
    """The graph arrays as DTensors placed by :func:`graph_array_shardings`."""
    return tuple(_distribute(a, p, mesh)
                 for a, p in zip(arrays, graph_array_shardings(mesh)))


def local_shard(t: torch.Tensor, placements: Placements, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``placements``: the
    block the ``shard_map`` body sees (DTensor's ``to_local``, cut here
    without a collective). A sharded dim must divide by its axis size."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            k = mesh.size(i)
            if t.shape[p.dim] % k:
                raise ValueError(f"dim {p.dim} of size {t.shape[p.dim]} does not split "
                                 f"over {k} ranks of {mesh.mesh_dim_names[i]!r}")
            t = t.chunk(k, dim=p.dim)[coord[i]]
    return t.contiguous()


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every leaf of ``tree`` as a replicated DTensor."""
    repl = _named(mesh)
    return tree_map(lambda t: distribute_tensor(torch.as_tensor(t), mesh, repl), tree)
