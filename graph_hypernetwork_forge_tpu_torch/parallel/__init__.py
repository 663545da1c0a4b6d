"""The multi-device layer of the port: meshes over ``torch.distributed``
ranks, DTensor placements, and collectives differentiated as JAX
differentiates ``shard_map`` (``collectives.py`` states the convention
every module here follows).

The names of ``graph_hypernetwork_forge_tpu.parallel``, all ported. The
tensor-parallel, composed-TP and pipeline-training functions are in their
modules (``tensor_parallel``, ``composed_tp``, ``pipeline``), as in JAX.
"""

from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
    composed_forward,
    make_composed_train_step,
    prepare_composed_inputs,
)
from graph_hypernetwork_forge_tpu_torch.parallel.data_parallel import (
    make_data_parallel_step,
)
from graph_hypernetwork_forge_tpu_torch.parallel.edge_partition import (
    edge_partitioned_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh, mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.parallel.node_partition import (
    node_partitioned_message_passing,
    partition_edges_by_dst,
)
from graph_hypernetwork_forge_tpu_torch.parallel.pipeline import (
    pipelined_forward,
    stack_layer_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.relation_sharding import (
    relation_sharded_generate,
)
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import (
    graph_array_shardings,
    hypergnn_param_shardings,
    replicate,
    shard_graph_arrays,
    shard_params,
)

__all__ = [
    "composed_forward",
    "edge_partitioned_message_passing",
    "graph_array_shardings",
    "hypergnn_param_shardings",
    "make_composed_train_step",
    "make_data_parallel_step",
    "make_mesh",
    "mesh_axis_size",
    "node_partitioned_message_passing",
    "partition_edges_by_dst",
    "pipelined_forward",
    "prepare_composed_inputs",
    "relation_sharded_generate",
    "replicate",
    "shard_graph_arrays",
    "shard_params",
    "stack_layer_params",
]
