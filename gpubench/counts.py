"""Operations, bytes and peaks: the arithmetic behind the benchmark's
utilization and roofline metrics, frozen here so that a change to the
program cannot change what it is measured against.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates). A kernel's least time is the larger of its bytes over the HBM
bandwidth and its operations over its form's peak; each input byte is
counted read once and each output byte written once, at the cell's shapes.
The port's f32 matrix kernels (2 and 3) take three TF32 passes (3xTF32), so
their operations peak is a third of the TF32 rate; its segment sums
(kernel 1) run on the CUDA cores at the f32 rate.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
TF32X3_PASSES = 3
F32_BYTES = 4
# The peak an f32 configuration's model FLOPs are held against: no
# f32-accurate product on the tensor cores runs faster than dense TF32.
MODEL_PEAK = {"float32": TF32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}


def generator_forward_flops(model: dict, num_rel: int) -> float:
    """One layer's three generator MLPs (text → hidden → hidden → bank) over
    ``num_rel`` relation texts, forward."""
    t, d = model["text_dim"], model["hidden_dim"]
    g = max(64, 2 * t)  # the generators' hidden width (models/hypergnn.py)
    per_text = sum(t * g + g * g + g * out for out in (d * d, d * d, d))
    return 2.0 * num_rel * per_text


def model_flops(model: dict, num_nodes: int, num_edges: int, num_rel: int) -> float:
    """Model FLOPs of one full-graph training step, from the configuration's
    shapes over the real (unpadded) edges and relations; nothing that is
    recomputed counts. Per layer and edge the two edge transforms cost
    4·d² forward and 8·d² backward (both inputs' and both banks'
    gradients); the generators' MLPs cost three times their forward; the
    input projection its forward and its weight gradient (the features
    take no gradient)."""
    d, layers = model["hidden_dim"], model["num_layers"]
    edges = 12.0 * d * d * num_edges * layers
    gens = 3.0 * generator_forward_flops(model, num_rel) * layers
    proj = 4.0 * num_nodes * model["node_feat_dim"] * d
    return edges + gens + proj


def least_ms(nbytes: float, flops: float, flop_per_s: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s) * 1e3


def csr_segment_sum_ms(rows: int, segments: int, d: int) -> float:
    """Kernel 1: ``rows`` f32 rows summed into ``segments`` by CSR bounds
    (``segments + 1`` int32 reads), one f32 output row a segment."""
    return least_ms((rows * d + segments + 1 + segments * d) * F32_BYTES, rows * d,
                    F32_FLOP_PER_S)


def edge_transform_ms(rows: int, visited: int, d: int) -> float:
    """Kernel 2, f32 form: both input rows and the output row of each layout
    row, one relation id per 256-row tile, the two banks and the bias of
    each visited relation; ``[x_src | x_dst] @ [W_msg; W_self] + bias``."""
    tiles = rows // 256
    nbytes = (3 * rows * d + tiles + 2 * visited * d * d + visited * d) * F32_BYTES
    return least_ms(nbytes, 4.0 * rows * d * d + rows * d, TF32_FLOP_PER_S / TF32X3_PASSES)


def edge_transform_bwd_ms(rows: int, visited: int, num_rel_pad: int, d: int) -> float:
    """Kernel 3, f32 form: the cotangent and both input rows read, both
    input gradients written, the visited banks read and every relation's
    two dW banks written; two products for dx and two for dW."""
    tiles = rows // 256
    nbytes = (5 * rows * d + tiles + 2 * visited * d * d + 2 * num_rel_pad * d * d) * F32_BYTES
    return least_ms(nbytes, 8.0 * rows * d * d, TF32_FLOP_PER_S / TF32X3_PASSES)


def train_step_kernels(model: dict, shapes: dict, neg_mode: str) -> Dict[str, List[float]]:
    """Least ms of every launch of the port's kernels in one f32 training
    step, by kernel name: per layer kernel 1 sums over the nodes in the
    forward's aggregation and for the h[src] and h[dst] cotangents, and
    over the relations for dbias; the roll loss's backward adds two sums
    over the nodes; kernels 2 and 3 run once a layer."""
    d, layers = model["hidden_dim"], model["num_layers"]
    rows, n, u_pad, visited = (shapes[k] for k in ("rows", "num_nodes", "num_rel_pad",
                                                   "visited_rel"))
    node_sums = 3 * layers + (2 if neg_mode == "roll" else 0)
    return {
        "csr_segment_sum_kernel": [csr_segment_sum_ms(rows, n, d)] * node_sums
        + [csr_segment_sum_ms(rows, u_pad, d)] * layers,
        "edge_transform_kernel": [edge_transform_ms(rows, visited, d)] * layers,
        "edge_transform_bwd_kernel": [edge_transform_bwd_ms(rows, visited, u_pad, d)] * layers,
    }


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def port_kernel_names(csrc: Path) -> set:
    """The name of every ``__global__`` function in the port's CUDA sources."""
    return {m.group(1) for src in sorted(csrc.glob("*.cu"))
            for m in _GLOBAL.finditer(src.read_text())}
