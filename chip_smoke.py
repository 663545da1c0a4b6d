#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port (``graph_hypernetwork_forge_tpu_torch``) and nothing of
JAX, and fails (non-zero exit, no result line) on any failed phase:

1. device: require CUDA, print the card's name and power limit, TF32 off;
   native: build ``native/ghf_native.cpp`` with g++ and load it (the host
   encoder's dedup, tokenizer and sorts, the sampler's hops); fail without
   it, and print which path encodes;
2. build: compile the five CUDA sources of ``csrc/`` with nvcc, in
   parallel;
3. kernels: each of the six kernels, and the row-gather kernel (on a
   layer's [E, d] permute, bit for bit ``index_select``, its plain version
   and library call), against its plain PyTorch version at
   the xl shapes (N=50,000 nodes, E_pad≈1.03M group-padded edge rows,
   U_pad=240) at d=64 and d=128, on a layout with an empty relation and a
   node with no in-edges: max abs error against the stated tolerance,
   CUDA-event times of kernel, plain version and one PyTorch library call
   (for kernels 3 and 6, the nearest composition of ``bmm`` calls), and
   the bound (bytes over 3.35 TB/s, or operations: for the matrix kernels
   2, 3, 5 and 6 three TF32 passes of their f32-class operations over 495
   TFLOP/s, with the CUDA-core bound of f32 operations over 67 TFLOP/s
   beside it; for the sums f32 operations over 67 TFLOP/s); kernels 2, 3,
   5 and 6 (3xTF32 on the tensor cores) must come within twice the plain
   f32 version's error of a float64 reference, output by output (dW
   scaled); kernels 1, 3, 6 and 7 must be bitwise deterministic, and
   kernels 3 and 6's dW of relations no tile visits exactly 0; kernels 3
   and 6 are also timed against the fair library composition, ``bmm`` per
   tile plus ``index_add_`` of the tile partials into their relations;
   then every other form of the kernels at the same shapes: the bf16
   forms of kernels 1, 2, 3, 5, 6 and 7 against their plain bf16 versions
   (bf16 outputs within one bf16 ulp of the largest value, 2^-7 ·
   max|plain|; f32 sums of bf16 rows, the dW of kernels 3 and 6 among
   them, within the f32 gate), deterministic, dW of unvisited relations 0,
   bounds in bf16 bytes or operations over 989 TFLOP/s of dense bf16; the
   one-TF32-pass mode of kernels 2, 3, 5 and 6 (precision="default") by its
   float64 error, scaled under 4e-3 (bf16-class), its bound at 495 TFLOP/s
   of TF32; and mode="fast" of kernels 1 and 7 (f32 rows rounded to bf16
   as read) within the f32 gate of its plain version, with its error
   against the exact sums printed;
4. serving: the xl model at full width (text=64, F=H=64, 2 layers, random
   weights from seed 0) answers 3 zero-shot requests, each wiring two edges
   of a never-seen relation text into the xl graph, then encoding, running
   the forward and ranking all 50,000 tails for 256 query heads; kernels 1
   and 2 must each have launched 2 × 3 times, the outputs must be finite,
   and the first request must agree with the ``gather`` oracle on the card
   and a toy graph with the CPU run of the same model; one more warm
   request's device time is broken down by kernel with torch.profiler,
   and its host encode by stage (dedup, tokenize, relation sort, group
   pad, sort plan);
5. training: the same xl model (seed 0) takes 1 warm-up and 5 timed
   full-graph steps (``make_train_step(neg_mode="roll")``, Adam lr 1e-3,
   dropout 0, all positives): finite losses, the per-step launches of the
   three kernels equal to the count derived from the code, ms/step and
   edges/s (1,000,000 real edges per step), and one more step broken down
   by torch.profiler; then the same at xl-d128 (node_feat = hidden = 128,
   benchmarks/scaling.py's other xl config). At the bench size (N=1k,
   E=10k, U=50, d=64,
   group-padded) 3 steps with the same roll shifts on the card's ``cuda``
   backend must agree with the card's ``gather`` oracle and with the CPU;
   kernels 5, 6 and 7 must launch 0 times in the serving and training runs;
   speed mode: the xl and xl-d128 models in ``compute_dtype="bfloat16"``
   and, separately, in ``precision="default"`` take 1 warm-up and 5 timed
   steps each (finite losses, launches by form equal to the count derived
   from the code, ms/step, edges/s, peak memory, one profiled step); one
   xl speed-mode forward with its device time; and at the bench size 3
   speed-mode steps on the card's ``cuda`` backend against the card's
   ``gather`` oracle in speed mode (per-layer embeddings within 1e-2
   scaled, gradient cosine > 0.999) and against the card's f32 run
   (relative error < 5e-2, gradient cosine > 0.99), and one step with
   ``precision="default"``;
6. two-stream layer: one xl message-passing layer at d=64 and d=128
   through ``edge_contributions_cuda_sorted`` (kernel 5) and the
   two-stream tail, forward and backward (kernels 5, 6 and 1), against the
   same layer through the ``cuda`` backend (kernels 2, 3 and 1): in f32
   the output and the gradients of ``Σ out · R`` within the f32 gate (both
   sum in 3xTF32 on the tensor cores, in other orders, so they agree to
   rounding and not bit for bit); in speed mode (bf16 h, banks and bias)
   against the ``cuda`` backend in speed mode (1e-2 scaled, gradient
   cosine > 0.999); with precision="default" against the f32 layer (4e-3
   scaled); in each form the launches by form equal to the count derived
   from the code, and CUDA-event ms of both layers in that form;
7. grouped: the xl model (weights at scale 1) on the relation-sorted
   layout with a sort plan and no group padding, where ``auto`` picks the
   ``grouped`` backend as the JAX package does, against the ``cuda``
   backend on the group-padded layout of the same graph: per-layer
   embeddings and parameter gradients of ``Σ out · R``, launches, and ms
   per forward + backward (1 warm-up, 3 timed) of both;
8. dense and chunked: the bench config in the stored edge order, per-layer
   embeddings and parameter gradients against the card's ``gather`` oracle
   and against the CPU;
9. link prediction (BASELINE.json #2, #3 at scale 1.0): FB15k-237-like
   (14,541 nodes, 310,116 edges, 237 relations; text 64, F = H = 64, 2
   layers) trains 20 steps on its train split on the kernel layout
   (kernels 1-3, launches equal to the count derived from the code) with
   a MetricsLogger and a PhaseTimer, saves an async checkpoint at step 10
   and restores it into a fresh state, whose steps 10-20 must equal the
   uninterrupted run's bitwise (parameters and Adam moments); filtered MRR
   and Hits@1/3/10 of the test split against every node, all edges as the
   filter, the ranks equal to a float64 ranking on the card wherever no
   candidate lies within 1e-5 x max|score| of the target; then
   WN18RR-zero-shot-like (40,943 nodes, 93,003 edges, 11 relations, 27%
   held out) trains 20 steps and ranks the held-out relations' test edges
   (weights from text alone); ms/step, evaluation, checkpoint save (return
   and commit) and restore times;
10. minibatch (BASELINE.json #4 at benchmarks/minibatch_xxl.py's shapes:
   N=1M, E=10M, U=237, F = H = 64, batch 1024, fanouts (10, 10), nodes
   padded to multiples of 32,768): one step at the bench size on the card
   against the same batch and negatives on the CPU, then 1 warm-up and 5
   timed steps, each split into host sampling, host-to-device copies and
   the device step (CUDA events), the backend ``auto`` picks (``grouped``,
   as in JAX; no kernel in the model, kernel 1 once a step in the loss),
   subgraph sizes, peak memory, and one profiled device step;
11. parallel (``parallel/`` slices A and B): an NCCL process group of one
   rank through a ``file://`` rendezvous and ``make_mesh((1,), ("edge",))``
   on the card; at xl, relation-sharded generation of the banks (seed 0,
   weights at scale one) bit for bit equal to single-rank generation;
   edge-partitioned, node-partitioned, halo and scheduled-halo message
   passing each against the main path (the ``cuda`` backend over the
   SortPlan: kernels 1 and 2, kernel 3 in the backward) and ``dense``:
   output and the gradients of ``Σ out · R`` w.r.t. h, W_msg, W_self and
   the bias within 3e-5 (scaled), CUDA-event ms of a forward + backward and
   its peak memory; a data-parallel step over 2 copies of the xl graph
   against the single-process step on the mean of their losses (loss
   1e-5, parameters after Adam 3e-5) and its ms; then, on the host, the
   halo plans of the xl graph for 4 and 8 ranks, on raw labels and after
   ``locality_relabel``: build ms, bytes per device, padding factors and
   rounds; slices C and D on the same group: ``tp_generate_weights``
   against ``apply_weight_generator`` and ``tp_message_passing`` against the
   main path (values, gradients, ms); ``pipelined_forward`` and
   ``make_pipelined_train_step`` at S=1 over 2 xl microbatches against
   ``apply_hypergnn`` and the sequential step (on the backend ``auto``
   picks without a plan, as JAX's pipeline passes none); the composed step
   at k=1 on the halo (local_roll) and dense v1 (uniform_global) layouts,
   relation-sorted and group-padded per shard, with the contributions
   ``pallas`` and ``pallas_packed`` (the ``cuda`` backend over the shard's
   SortPlan: kernels 1-3, launches per step equal to the count from the
   code and no run-table launch), ``grouped`` and ``dense``, the uniform
   forms against ``make_train_step`` on the same negatives (loss 1e-5,
   gradients 3e-5 scaled, parameters after Adam at that gate where |g| >=
   1e-6), ms per step and peak memory; the 2D composed step on a (1, 1)
   mesh against the 1D step; the sharded ``make_train_step`` over DTensors
   against the plain step; kernel 1 alone on each reduction of the first
   shard's plan at k=4, and kernel 7 on its cotangent pair, each against
   its plain version, twice the same bits, every empty segment +0.0, with
   its bound, torch.segment_reduce's and the plain version's times, and
   the dst cotangent under 10x the aggregation (no walk of empty runs);
   ``DistributedMinibatchTrainer`` on the (1,) mesh: at the bench size one
   step in ``dense`` and in ``grouped`` against
   ``MinibatchTrainer.device_step`` on the same batch, negatives and
   weights (the Adam-step gate), and on the minibatch phase's xxl graph
   (drawn once) 1 warm-up and 5 timed steps split into host sampling, the
   partition and ladder, host-to-device copies and the device step, peak
   memory, the busy share and no kernel launch;
12. experiments: the scripts of ``graph_hypernetwork_forge_tpu_torch.
   experiments`` on the card, ``train_linkpred`` on WN18RR-zero-shot-like
   at scale 1.0 (100 steps, evaluating every 50), ``sweep_zeroshot``'s
   ``run_one`` (K=8, cosine, best-on-valid every 50) and the port side of
   ``parity_zeroshot`` at scale 0.1 (100 steps): ms/step, MRR and
   zero-shot MRR as readouts;
13. the training line, the kernels line (each kernel, then each bf16 form,
   one-TF32-pass mode and ``mode="fast"`` as an entry of its own,
   ``name[form]``, with its launches on its path), the card line and the
   result line, which is
   last: ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": 1}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
if not (ROOT / "graph_hypernetwork_forge_tpu_torch" / "csrc").is_dir():
    raise SystemExit(
        f"chip_smoke.py: the port's package is not beside this script in {ROOT}; "
        "run it from the root of a checkout of the repository"
    )
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from graph_hypernetwork_forge_tpu_torch import native_bridge  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.data.datasets import (  # noqa: E402
    fb15k237_like,
    wn18rr_zero_shot_like,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import (  # noqa: E402
    build_sort_plan,
    dedup_texts,
    encode_graph,
    relation_order,
)
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import (  # noqa: E402
    ToyKnowledgeGraph,
)
from graph_hypernetwork_forge_tpu_torch.device import resolve_device  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.experiments import (  # noqa: E402
    parity_zeroshot,
    sweep_zeroshot,
    train_linkpred,
)
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import (  # noqa: E402
    HyperGNN,
    HyperGNNConfig,
    apply_hypergnn,
    init_hypergnn,
)
from graph_hypernetwork_forge_tpu_torch.ops import cuda as kernels  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda._common import FORMS  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda.gather_rows import VECTOR_BYTES  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda.edge_transform_bwd import (  # noqa: E402
    plan_runs,
    run_bounds,
)
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (  # noqa: E402
    relational_message_passing,
    resolve_backend,
    two_stream_tail,
)
from graph_hypernetwork_forge_tpu_torch.ops.scoring import score_all_tails, score_pairs  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.segment import gather_bytes  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import (  # noqa: E402
    apply_text_encoder,
)
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (  # noqa: E402
    apply_weight_generator,
)
from graph_hypernetwork_forge_tpu_torch.parallel import halo  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.parallel import (  # noqa: E402
    edge_partitioned_message_passing,
    make_composed_train_step,
    make_data_parallel_step,
    make_mesh,
    node_partitioned_message_passing,
    partition_edges_by_dst,
    pipelined_forward,
    prepare_composed_inputs,
    relation_sharded_generate,
    shard_graph_arrays,
    shard_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.composed import local_inputs  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.parallel.composed_tp import (  # noqa: E402
    make_composed_tp_train_step,
    shard_composed_tp_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipelined_train_step,
)
from graph_hypernetwork_forge_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    shard_generator_params,
    tp_generate_weights,
    tp_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.training.objectives import (  # noqa: E402
    link_prediction_loss,
    margin_ranking_loss,
)
from graph_hypernetwork_forge_tpu_torch.training import (  # noqa: E402
    DistributedMinibatchTrainer,
    MinibatchSpec,
    MinibatchTrainer,
    adam,
    create_train_state,
    evaluate_link_prediction,
    make_composed_minibatch_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import (  # noqa: E402
    named_leaves,
    tree_map,
)
from graph_hypernetwork_forge_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.utils import profiling  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.utils.profiling import PhaseTimer  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.utils.shapes import pad_bucket_relations  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.utils.text import tokenize_texts  # noqa: E402

# By module path: the package's name ``train`` is the function.
train_module = importlib.import_module("graph_hypernetwork_forge_tpu_torch.training.train")

# The xl config (benchmarks/scaling.py): N, E, U, text_dim, width, layers.
XL_N, XL_E, XL_U, TEXT_DIM, WIDTH, LAYERS = 50_000, 1_000_000, 237, 64, 64, 2
REQUESTS, QUERY_HEADS, TOP_K = 3, 256, 10
# Training: steps timed at xl after one warm-up, Adam's learning rate
# (benchmarks/scaling.py), and the bench config (bench.py) of the parity run.
TRAIN_STEPS, LEARNING_RATE = 5, 1e-3
BENCH_N, BENCH_E, BENCH_U, PARITY_STEPS = 1_000, 10_000, 50, 3
# Link prediction (BASELINE.json #2, #3): the datasets' scale, the steps,
# the step the run is checkpointed and resumed at, and the evaluator's chunk.
LINKPRED_SCALE, LINKPRED_STEPS, LINKPRED_RESUME_AT = 1.0, 20, 10
EVAL_CHUNK = 1024
# Minibatch (BASELINE.json #4, benchmarks/minibatch_xxl.py:45-76): the
# graph, the trainer's spec, and the steps timed after one warm-up.
MB_N, MB_E, MB_U = 1_000_000, 10_000_000, 237
MB_SPEC = dict(batch_size=1024, fanouts=(10, 10), node_bucket_multiple=32_768)
MB_TIMED = 5
# The distributed minibatch trainer's ladder of per-shard edge caps
# (benchmarks/minibatch_xxl.py:67-73).
MB_CAP_MULTIPLE = 8192
# The experiment scripts on the card: steps, the evaluation interval, the
# sweep's negatives, the datasets' scale, and the parity run's scale (its
# JAX script's default).
EXP_STEPS, EXP_EVAL_EVERY, EXP_SWEEP_K = 100, 50, 8
EXP_SCALE, EXP_PARITY_SCALE = 1.0, 0.1
# parallel/ at world size 1 (one card): the f32 gate of each form against
# the main path (ROADMAP), the DP step's gates (tests/test_data_parallel.py:
# 57, :64), its batch of xl copies (__graft_entry__.py:139-140), and the
# mesh sizes the host plans are built for.
PARALLEL_ATOL, DP_LOSS_ATOL, DP_PARAM_ATOL = 3e-5, 1e-5, 3e-5
DP_BATCH, PLAN_SHARDS = 2, (4, 8)
# parallel/ slices C and D at world size 1: the composed step's
# contribution backends (JAX's names; "pallas" and "pallas_packed" run the
# cuda backend over the shard's SortPlan), its timed steps, the pipeline's
# microbatches, and the Adam gate of the step comparisons: the loss within
# 1e-5, the gradients at the f32 gate scaled, the parameters after Adam at
# that gate wherever |g| is above ADAM_NOISE_GRAD (below it Adam's first
# step, lr·g/(|g| + eps), follows the rounding of g, up to a flipped sign:
# within 2·lr there).
COMPOSED_CONTRIBS = ("pallas", "pallas_packed", "grouped", "dense")
COMPOSED_TIMED, PIPE_MICRO, STEP_LOSS_ATOL, ADAM_NOISE_GRAD = 3, 2, 1e-5, 1e-6

# NVIDIA H100 SXM data sheet, at the 700 W limit: HBM3 bandwidth, the f32
# rate outside the tensor cores, and the dense TF32 rate of the tensor cores.
# A matrix kernel's f32-class product takes three TF32 passes (3xTF32,
# csrc/tf32x3.cuh), so its operations bound is 3 x its operations at the
# TF32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TF32X3_PASSES = 3
# Dense bf16 on the tensor cores (the same data sheet): the bound of the
# bf16 forms' products.
BF16_FLOP_PER_S = 989e12

# Kernel vs plain: f32 sums of a few dozen order-1 terms (segments of ~20
# rows; kernels 2 and 3's dot products of d terms), taken in another order.
# Kernel 3's dW sums ~4,300 products per relation, so it is compared after
# dividing by max(1, max|plain|). Serving vs the gather oracle and the CPU:
# the repo's per-layer f32 parity gate.
KERNEL_ATOL = 1e-4
SERVING_ATOL = 3e-5
# Training parity at the bench size. First-step gradients (same parameters
# on every side): the f32 gate after dividing by max(1, max|ref|). Losses:
# Adam's first steps move each parameter by about lr·sign(g), and where |g|
# sits at rounding noise the sign can differ between two summation orders,
# so later losses differ by more than rounding: 1e-4 relative (a wrong
# gradient moves them by percents). Parameters after the steps: each within
# that 2·lr-per-step sign flip, and 99.9% of them within 1e-5.
GRAD_ATOL, LOSS_RTOL, PARAM_Q999_ATOL = 3e-5, 1e-4, 1e-5
# Speed mode. A bf16 output of a kernel against its plain bf16 version:
# one bf16 ulp of the largest value (the same exact f32 products summed in
# another order may round to either neighbour). The one-TF32-pass mode
# against float64, after dividing by max(1, max|reference|): bf16-class.
# The model in speed mode at the bench size: per-layer embeddings against
# the gather oracle in speed mode within 1e-2 scaled (contribution rows
# rounded to bf16 on both sides, one ulp apart where their f32 sums differ
# in order) and gradient cosine > 0.999; against the f32 run the JAX
# package's gates (tests/test_speed_mode.py:73, :136).
BF16_ULP, ONE_PASS_SCALED = 2.0**-7, 4e-3
SPEED_ATOL, SPEED_COS_ORACLE = 1e-2, 0.999
SPEED_VS_F32_RTOL, SPEED_COS_F32 = 5e-2, 0.99
SPEED = dict(compute_dtype="bfloat16")
ONE_PASS = dict(precision="default")

KERNELS = {
    "csr_segment_sum": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_sum.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:415 "
            "sorted_segment_sum_packed64 (d=64); same file :198 "
            "sorted_segment_sum_pallas (d%128==0)"
        ),
    ),
    "edge_transform_sorted_combined": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239 "
            "edge_transform_sorted_combined"
        ),
    ),
    "edge_transform_combined_bwd": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform_bwd.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368 "
            "_combined_bwd_fused_impl (kernel body :334-365)"
        ),
    ),
    "edge_transform_sorted": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/edge_transform.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:108 "
            "_edge_transform_fwd_impl (pallas_call :140), the kernel of "
            "edge_transform_sorted (:530)"
        ),
    ),
    "segment_outer": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_outer.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473 "
            "_segment_outer_impl (pallas_call :504)"
        ),
    ),
    "dual_sorted_segment_sum": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/segment_sum.cu",
        replaces=(
            "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:463 "
            "dual_sorted_segment_sum_pallas (pallas_call in _dual_impl :396)"
        ),
    ),
    "gather_rows": dict(
        source="graph_hypernetwork_forge_tpu_torch/csrc/gather_rows.cu",
        replaces=(
            "no TPU kernel: XLA's gathers there (jnp.take in graph_hypernetwork_forge_tpu/"
            "ops/segment.py and training/objectives.py); in the port, PyTorch's "
            "index_select (vectorized_gather_kernel)"
        ),
    ),
}
# The gather kernel's forms: the bytes a lane moves at a time.
GATHER_FORMS = tuple(f"v{v}" for v in VECTOR_BYTES)


def forms_of(name: str) -> tuple:
    return GATHER_FORMS if name == "gather_rows" else FORMS

# Launches of each kernel per training step, counted from the code: kernel
# 2 once per layer; kernel 3 once per layer (edge transform backward, its
# dW reduced inside the kernel over the SortPlan's run table); kernel 1 per
# layer once in the forward's aggregation tail and three times in the
# backward (the h[src] and h[dst] cotangents, dbias), plus twice in the
# loss backward (src- and dst-sorted streams). The gather kernel per layer
# once for the h[src], h[dst] pair and once for the aggregation's permute,
# and in the backward for the pair's two cotangent permutes, the
# aggregation's [E] index composition (4-byte rows: form v4) and its row
# gather; in the rolled loss once for the src and dst rows, once for the
# rolled tails, and in its backward for the two rolls and two permutes.
STEP_LAUNCHES = {
    "csr_segment_sum": LAYERS * 4 + 2,
    "edge_transform_sorted_combined": LAYERS,
    "edge_transform_combined_bwd": LAYERS,
    "edge_transform_sorted": 0,
    "segment_outer": 0,
    "dual_sorted_segment_sum": 0,
    "gather_rows": LAYERS * 6 + 6,
}
# The composed step with the cuda contribution: kernels 1-3 and the gather
# kernel as a training step's layers launch them; its loss (local or
# uniform scoring) gathers rows with PyTorch and launches no kernel.
COMPOSED_LAUNCHES = dict(STEP_LAUNCHES, csr_segment_sum=LAYERS * 4, gather_rows=LAYERS * 6)
# A forward (serving) runs kernels 1 and 2 once per layer, and the gather
# kernel twice (the h[src], h[dst] pair and the aggregation's permute).
FORWARD_LAUNCHES = dict(
    {name: 0 for name in STEP_LAUNCHES},
    csr_segment_sum=LAYERS, edge_transform_sorted_combined=LAYERS, gather_rows=2 * LAYERS,
)
# One two-stream layer, forward and backward: kernel 5 in the forward and
# once more for dx; kernel 6 for dW_msg and dW_self (each reducing its own
# dW); kernel 1 in the tail, for dbias and for the h[src] and h[dst]
# cotangents; the gather kernel as one layer of a training step.
TWO_STREAM_LAUNCHES = dict(
    {name: 0 for name in STEP_LAUNCHES},
    csr_segment_sum=4, edge_transform_sorted=2, segment_outer=2, gather_rows=6,
)
# One forward and backward of the model on the grouped backend with a sort
# plan: per layer kernel 1 in the tail and for the h[src], h[dst] and bias
# cotangents; the gather kernel as a training step's layer and once more
# for the bias rows (whose cotangent needs no permute); the per-relation
# products are PyTorch matmuls.
# A link-prediction step with uniform negatives: the model's launches of a
# training step, and kernel 1 once in the loss's backward (its three
# cotangent streams, sorted together on the card); the gather kernel once
# for the loss's three rows and once for the permute of its streams.
LINKPRED_STEP_LAUNCHES = dict(STEP_LAUNCHES, csr_segment_sum=LAYERS * 4 + 1,
                              gather_rows=LAYERS * 6 + 2)
GROUPED_LAUNCHES = dict({name: 0 for name in STEP_LAUNCHES}, csr_segment_sum=4 * LAYERS,
                        gather_rows=7 * LAYERS)
GROUPED_TIMED = 3


def two_stream_launches_per_form(form: str) -> dict:
    """Launches by form of one two-stream layer, forward and backward,
    counted from the code: kernels 5 and 6 twice each in the layer's form
    (as TWO_STREAM_LAUNCHES); kernel 1 four times, for the tail, dbias and
    the two gather cotangents, in speed mode over bf16 rows; the gather
    kernel 16 bytes a lane, but on the [E] index composition's 4-byte rows."""
    out = {name: dict.fromkeys(forms_of(name), 0) for name in KERNELS}
    out["edge_transform_sorted"][form] = out["segment_outer"][form] = 2
    out["gather_rows"].update(v16=TWO_STREAM_LAUNCHES["gather_rows"] - 1, v4=1)
    if form == "bf16":
        out["csr_segment_sum"]["bf16"] = TWO_STREAM_LAUNCHES["csr_segment_sum"]
    else:
        out["csr_segment_sum"]["f32"] = TWO_STREAM_LAUNCHES["csr_segment_sum"]
    return out


def mode_form(mode: dict) -> str:
    """The form kernels 2 and 3 run in under a config ``mode``."""
    if mode.get("compute_dtype") == "bfloat16":
        return "bf16"
    return "tf32" if mode.get("precision") == "default" else "f32"


def step_launches_per_form(mode: dict) -> dict:
    """Launches per training step by form, counted from the code: kernels
    2 and 3 once a layer in the mode's form. Kernel 1 as in STEP_LAUNCHES;
    in speed mode its rows are bf16 in the forward tail, the h[src] and
    h[dst] cotangents and dbias (4 a layer), and f32 in the f32 loss (2).
    The gather kernel moves 16 bytes a lane in every mode, but 4 on the [E]
    index composition's rows (one a layer)."""
    out = {name: dict.fromkeys(forms_of(name), 0) for name in KERNELS}
    out["gather_rows"].update(v16=STEP_LAUNCHES["gather_rows"] - LAYERS, v4=LAYERS)
    form = mode_form(mode)
    if form == "bf16":
        out["csr_segment_sum"].update(bf16=4 * LAYERS, f32=2)
    else:
        out["csr_segment_sum"]["f32"] = STEP_LAUNCHES["csr_segment_sum"]
    out["edge_transform_sorted_combined"][form] = LAYERS
    out["edge_transform_combined_bwd"][form] = LAYERS
    return out


# The speed mode's forms in the kernels line, with the TPU kernel branch
# each replaces.
FORM_REPLACES = {
    ("csr_segment_sum", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:65 _make_kernel, "
        "its bf16 rows (:69, :117-118), of sorted_segment_sum_pallas (:198) and "
        "sorted_segment_sum_packed64 (:415)"
    ),
    ("edge_transform_sorted_combined", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239 "
        "edge_transform_sorted_combined, its kernel's bf16 branch (:166-182)"
    ),
    ("edge_transform_combined_bwd", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368 "
        "_combined_bwd_fused_impl, its kernel's bf16 branch (:344, :351, :355, "
        ":410-411)"
    ),
    ("edge_transform_sorted_combined", "tf32"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:239 "
        "edge_transform_sorted_combined at default precision (one pass, :169)"
    ),
    ("edge_transform_combined_bwd", "tf32"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:368 "
        "_combined_bwd_fused_impl at default precision (one pass, :344)"
    ),
    ("edge_transform_sorted", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:108 "
        "_edge_transform_fwd_impl of edge_transform_sorted (:530), its kernel's "
        "bf16 branch (:90-103)"
    ),
    ("edge_transform_sorted", "tf32"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:108 "
        "_edge_transform_fwd_impl at default precision (one pass, :92)"
    ),
    ("segment_outer", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473 "
        "_segment_outer_impl, its kernel's bf16 branch (:461-468)"
    ),
    ("segment_outer", "tf32"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/edge_transform.py:473 "
        "_segment_outer_impl at default precision (one pass, :461)"
    ),
    ("dual_sorted_segment_sum", "bf16"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:463 "
        "dual_sorted_segment_sum_pallas, its kernel's bf16 rows (_make_dual_kernel "
        ":270-271, :327-329)"
    ),
    ("csr_segment_sum", "fast"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:198 "
        "sorted_segment_sum_pallas and :415 sorted_segment_sum_packed64 in "
        "mode='fast' (_make_kernel :119-120)"
    ),
    ("dual_sorted_segment_sum", "fast"): (
        "graph_hypernetwork_forge_tpu/ops/pallas/segment_sum.py:463 "
        "dual_sorted_segment_sum_pallas in mode='fast' (_make_dual_kernel :330-333)"
    ),
}

FAILURES: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check and go on, so one run reports every phase;
    main() exits non-zero without a result line if any check failed."""
    if not ok:
        FAILURES.append(msg)
        log(f"FAIL: {msg}")


def kernel_launches_per_form(counts: dict) -> dict:
    """Launches of each kernel by form, as the ``kernel.<name>.<form>``
    counters of ``counts`` (a ``profiling.tally()``) read."""
    return {name: {form: counts.get(f"kernel.{name}.{form}", 0) for form in forms_of(name)}
            for name in KERNELS}


def kernel_launches(counts: dict) -> dict:
    """Launches of each kernel in every form, from ``counts`` as above."""
    return {name: sum(forms.values())
            for name, forms in kernel_launches_per_form(counts).items()}


def nonzero(by_form: dict) -> dict:
    """Launches by form without the zero counts, for the log."""
    return {name: {f: n for f, n in forms.items() if n}
            for name, forms in by_form.items() if any(forms.values())}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_ms(fn, kernel: str, calls: int = 5) -> float:
    """Device milliseconds per call of the kernel named ``kernel`` (its
    template instance, any arguments) over ``calls`` warm calls of ``fn``,
    by torch.profiler: the kernel's own time, without the wrapper's host
    work and allocations."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Now and then the profiler hands back no record of a window's kernels,
    # in up to three windows in a row (H100 runs of PRs 10 and 11, each
    # followed by windows that recorded): the window is profiled again, six
    # times at most, after a pause that grows.
    for attempt in range(6):
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if f"{kernel}<" in e.key and e.device_type != torch.autograd.DeviceType.CPU)
        if us > 0:
            break
        log(f"torch.profiler: window {attempt + 1} recorded no time of {kernel}")
    check(us > 0, f"torch.profiler recorded no time of {kernel}")
    return us / 1e3 / calls


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference after dividing both by max(1, max|want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def bound(nbytes: float, flops: float, matrix: bool = False,
          rate: float | None = None) -> tuple[float, str]:
    """The least ms for ``nbytes`` of traffic and ``flops`` operations, and
    which of the two bounds it. ``matrix``: the operations are f32-class
    products, at the tensor cores' 3xTF32 rate; else f32 on the CUDA cores,
    unless ``rate`` (operations per second) is given."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if rate is None:
        rate = TF32_FLOP_PER_S / TF32X3_PASSES if matrix else F32_FLOP_PER_S
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matrix_bounds(nbytes: float, flops: float) -> dict:
    """A matrix kernel's bound on the tensor-core route, and the bound on
    the CUDA cores (f32 operations over 67 TFLOP/s) beside it."""
    b_ms, b_by = bound(nbytes, flops, matrix=True)
    return dict(bound_ms=b_ms, bound_by=b_by,
                cuda_core_bound_ms=bound(nbytes, flops)[0])


def float64_errors(fn, plain, args, scaled=()) -> list[tuple[float, float]]:
    """``(kernel, plain)`` max errors against ``plain`` in float64 on the
    same inputs, one pair per output; outputs in ``scaled`` after dividing
    by max(1, max|reference|)."""
    got, want = fn(*args), plain(*args)
    ref = plain(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                  for a in args))
    if isinstance(got, torch.Tensor):
        got, want, ref = (got,), (want,), (ref,)
    errs = []
    for i, (a, w, r) in enumerate(zip(got, want, ref)):
        scale = max(1.0, r.abs().max().item()) if i in scaled else 1.0
        errs.append(((a.double() - r).abs().max().item() / scale,
                     (w.double() - r).abs().max().item() / scale))
    del got, want, ref
    torch.cuda.empty_cache()
    return errs


def xl_edges(seed: int = 0, width: int = WIDTH):
    """The xl graph as benchmarks/scaling.py draws it: features, edges, texts
    (the features first, so the edges depend on the width, as there)."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((XL_N, width)).astype(np.float32)
    ei = np.stack(
        [rng.integers(0, XL_N, size=XL_E), rng.integers(0, XL_N, size=XL_E)]
    ).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(XL_U)]
    etexts = [texts[i] for i in rng.integers(0, XL_U, size=XL_E)]
    return feats, ei, etexts, texts


def encode(ei, etexts):
    return encode_graph(
        ei, etexts, XL_N, sort_by_relation=True, with_sort_plan=True, group_pad=256
    )


@functools.lru_cache(maxsize=2)
def xl_graph(width: int = WIDTH):
    """The xl features and encoded graph at ``width``, encoded once."""
    feats_np, ei, etexts, _ = xl_edges(width=width)
    return feats_np, encode(ei, etexts)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false")
    dev = resolve_device(None)
    log(f"device: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return dev


def phase_native() -> dict:
    """The native host code (``native/ghf_native.cpp``), built with g++ into
    ``build/ghf_native/`` and loaded; without it the encoder would run its
    numpy versions, which is not the port's host path, so the run fails."""
    t0 = time.perf_counter()
    native = native_bridge.get_native()
    seconds = time.perf_counter() - t0
    check(native is not None, "native: the port's native extension did not build or load")
    where = getattr(native, "__file__", None)
    log(f"native: {getattr(native, '__name__', None)} from {where}, built and loaded in "
        f"{seconds:.2f} s; host encode path: "
        + ("native C++ (dedup, tokenizer, relation and plan sorts, sampling hops)"
           if native is not None else "numpy"))
    return dict(loaded=native is not None, seconds=seconds)


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build(kernels.KERNEL_SOURCES)
    for name, info in built.items():
        log(f"build: {name}.cu in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")
    log(f"build: all sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)")


def _kernel_graph():
    """The xl layout, with node 7's in-edges moved to node 8 so that one
    node has none. The bank's padding relations (237-239) have no edges."""
    _, ei, etexts, _ = xl_edges()
    ei[1, ei[1] == 7] = 8
    return encode(ei, etexts)


def phase_kernels(dev, g) -> dict:
    plan = g.sort_plan.to(dev)
    rel = torch.as_tensor(g.rel_ids, device=dev)
    e_rows, n, u_pad = g.rel_ids.shape[0], XL_N, g.char_ids.shape[0]
    log(f"kernels: E_pad={e_rows} N={n} U_pad={u_pad} "
        f"longest dst segment={int(np.diff(g.sort_plan.dst_splits).max())} rows")
    pad_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.dst_perm] == 0, device=dev)
    pad_src_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.src_perm] == 0, device=dev)
    visited = set(g.rel_ids[::256].tolist())
    unvisited = [r for r in range(u_pad) if r not in visited]
    # The bounds count what the kernels need of this data: one relation id
    # per 256-row tile and the banks of the visited relations only.
    u_vis = len(visited)
    # The run table of kernels 3 and 6: the SortPlan's, built on the host
    # once per layout (what the main path hands down), and the run-table
    # kernel's, which the wrappers launch where no plan is given, both
    # equal to run_bounds. The wrappers are timed both ways below.
    k3_runs = k6_runs = plan_runs(plan)
    want = run_bounds(rel, u_pad, k3_runs.run_tiles)[:2]
    built = kernels.run_table(rel, u_pad, k3_runs.run_tiles)
    check(all(torch.equal(a, b) for a, b in zip(
              (k3_runs.tile_splits, k3_runs.run_splits, built.tile_splits,
               built.run_splits), want + want)),
          "the run tables differ from run_bounds")
    log(f"run table of {k3_runs.run_tiles}-tile runs: {int(want[1][-1])} runs, "
        f"the longest relation {int(want[1].diff().max())} runs")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for d in (64, 128):
        # Kernel 1 over the dst-sorted rows, bounded by the plan's dst_splits;
        # the masked pad rows (all in node 0's segment) are zero, as on the
        # main path.
        x = torch.randn(e_rows, d, device=dev, generator=gen)
        x[pad_sorted] = 0.0
        splits = plan.dst_splits
        fn = kernels.csr_segment_sum
        out = fn(x, splits, n)
        again = fn(x, splits, n)
        plain = kernels.csr_segment_sum_plain(x, splits, n)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"csr_segment_sum d={d}: two runs differ")
        check(not out[7].any(), f"csr_segment_sum d={d}: empty segment 7 is not 0")
        err = (out - plain).abs().max().item()
        rows = int(g.sort_plan.dst_splits[n] - g.sort_plan.dst_splits[0])
        b_ms, b_by = bound((rows * d + (n + 1) + n * d) * 4, rows * d)
        offsets = splits[: n + 1].long()
        results[("csr_segment_sum", d)] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(x, splits, n)),
            plain_ms=cuda_ms(lambda: kernels.csr_segment_sum_plain(x, splits, n)),
            library_ms=cuda_ms(
                lambda: torch.segment_reduce(x, "sum", offsets=offsets, unsafe=True)
            ),
            bound_ms=b_ms, bound_by=b_by, **csr_own(lambda: fn(x, splits, n)),
            dbias=dbias_sums(dev, plan.rel_splits, e_rows, u_pad, d, torch.float32, gen),
        )
        del x, out, again, plain

        # Kernel 2 over the relation-sorted rows with random banks.
        xs = torch.randn(e_rows, d, device=dev, generator=gen)
        xd = torch.randn(e_rows, d, device=dev, generator=gen)
        wm = torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
        ws = torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
        bias = torch.randn(u_pad, d, device=dev, generator=gen)
        args = (xs, xd, rel, wm, ws, bias)
        fn = kernels.edge_transform_sorted_combined
        out = fn(*args)
        plain = kernels.edge_transform_sorted_combined_plain(*args)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        tiles = e_rows // 256
        tile_rel = rel[::256].long()
        x_cat = torch.cat([xs, xd], dim=1).view(tiles, 256, 2 * d)
        w_cat = torch.cat([wm, ws], dim=1)[tile_rel]
        b_tile = bias[tile_rel][:, None, :]
        nbytes = (2 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d
                  + e_rows * d) * 4
        [f64] = float64_errors(fn, kernels.edge_transform_sorted_combined_plain, args)
        results[("edge_transform_sorted_combined", d)] = dict(
            max_abs_err=err, f64_err=f64[0], plain_f64_err=f64[1],
            checked_f64=[f64],
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_sorted_combined_plain(*args)
            ),
            library_ms=cuda_ms(lambda: torch.baddbmm(b_tile, x_cat, w_cat)),
            **matrix_bounds(nbytes, 2 * 2 * e_rows * d * d + e_rows * d),
        )
        del args, out, plain, w_cat, b_tile

        # Kernel 3, the backward of kernel 2, on the same rows and banks with
        # a random cotangent; it reduces its dW itself. ms: the wrapper as
        # called without a run table (one launch of the run-table kernel
        # first); ms_plan_table: with the SortPlan's, as the main path calls
        # it; kernel_ms: kernel 3 alone, profiled.
        g_out = torch.randn(e_rows, d, device=dev, generator=gen)
        args = (g_out, xs, xd, rel, wm, ws)
        fn = kernels.edge_transform_combined_bwd
        out = fn(*args)
        again = fn(*args)
        plain = kernels.edge_transform_combined_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"edge_transform_combined_bwd d={d}: two runs differ")
        check(bool(unvisited) and not any(dw[unvisited].any() for dw in out[2:]),
              f"edge_transform_combined_bwd d={d}: dW of the unvisited "
              f"relations {unvisited} is not exactly 0")
        err = max((a - b).abs().max().item() for a, b in zip(out[:2], plain[:2]))
        dw_err = max(scaled_err(a, b) for a, b in zip(out[2:], plain[2:]))
        # The library composition: one bmm of the g tiles against
        # tile-gathered [W_msgᵀ | W_selfᵀ] for both dx, one bmm of the
        # [x_src | x_dst]ᵀ tiles against g for the per-tile dW, and
        # index_add_ of the tile partials into their relations (the same
        # function; the bank gather is not timed). bmm_ms leaves out the
        # reduction, as PRs 1-5 timed it.
        g_tiles = g_out.view(tiles, 256, d)
        w_t = torch.cat([wm, ws], dim=1)[tile_rel].transpose(1, 2).contiguous()
        x_t = x_cat.transpose(1, 2)

        def k3_library(g_tiles=g_tiles, w_t=w_t, x_t=x_t):
            dw = torch.zeros(u_pad, 2 * d, d, device=dev)
            return torch.bmm(g_tiles, w_t), dw.index_add_(0, tile_rel, torch.bmm(x_t, g_tiles))

        nbytes = (5 * e_rows * d + tiles + 2 * u_vis * d * d + 2 * u_pad * d * d) * 4
        f64 = float64_errors(fn, kernels.edge_transform_combined_bwd_plain, args,
                             scaled=(2, 3))
        results[("edge_transform_combined_bwd", d)] = dict(
            max_abs_err=err, dw_scaled_err=dw_err,
            f64_err=max(k for k, _ in f64), plain_f64_err=max(p for _, p in f64),
            checked_f64=f64,
            ms=cuda_ms(lambda: fn(*args)),
            ms_plan_table=cuda_ms(lambda: fn(*args, runs=k3_runs)),
            kernel_ms=kernel_ms(lambda: fn(*args, runs=k3_runs),
                                "edge_transform_bwd_kernel"),
            plain_ms=cuda_ms(
                lambda: kernels.edge_transform_combined_bwd_plain(*args)
            ),
            library_ms=cuda_ms(k3_library),
            bmm_ms=cuda_ms(lambda: (torch.bmm(g_tiles, w_t), torch.bmm(x_t, g_tiles))),
            **matrix_bounds(nbytes, 8 * e_rows * d * d),
        )
        del args, out, again, plain, x_cat, w_t, x_t, k3_library

        # Kernel 5, the two-output transform, on kernel 2's rows and banks.
        # Library: two batched products over the tile-gathered banks.
        args = (xs, xd, rel, wm, ws, bias)
        fn = kernels.edge_transform_sorted
        out = fn(*args)
        plain = kernels.edge_transform_sorted_plain(*args)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(out, plain))
        xs_t, xd_t = xs.view(tiles, 256, d), xd.view(tiles, 256, d)
        wm_t, ws_t = wm[tile_rel], ws[tile_rel]
        b_tile = bias[tile_rel][:, None, :]
        nbytes = (2 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d
                  + 2 * e_rows * d) * 4
        f64 = float64_errors(fn, kernels.edge_transform_sorted_plain, args)
        results[("edge_transform_sorted", d)] = dict(
            max_abs_err=err,
            f64_err=max(k for k, _ in f64), plain_f64_err=max(p for _, p in f64),
            checked_f64=f64,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: kernels.edge_transform_sorted_plain(*args)),
            library_ms=cuda_ms(
                lambda: (torch.baddbmm(b_tile, xs_t, wm_t), torch.bmm(xd_t, ws_t))
            ),
            **matrix_bounds(nbytes, 2 * 2 * e_rows * d * d + e_rows * d),
        )
        del args, out, plain, wm_t, ws_t, b_tile

        # Kernel 6, the segment outer product, of x_src against kernel 3's
        # cotangent; it reduces its dW itself (times as kernel 3's). Library:
        # one bmm of the xᵀ tiles against the g tiles and index_add_ of the
        # tile partials into their relations; bmm_ms the bmm alone.
        args = (xs, g_out, rel, u_pad)
        fn = kernels.segment_outer
        out = fn(*args)
        again = fn(*args)
        plain = kernels.segment_outer_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"segment_outer d={d}: two runs differ")
        check(not out[unvisited].any(),
              f"segment_outer d={d}: dW of the unvisited relations is not exactly 0")
        err = scaled_err(out, plain)
        xs_tt = xs_t.transpose(1, 2)

        def k6_library(xs_tt=xs_tt, g_tiles=g_tiles):
            dw = torch.zeros(u_pad, d, d, device=dev)
            return dw.index_add_(0, tile_rel, torch.bmm(xs_tt, g_tiles))

        [f64] = float64_errors(fn, kernels.segment_outer_plain, args, scaled=(0,))
        results[("segment_outer", d)] = dict(
            max_abs_err=(out - plain).abs().max().item(), dw_scaled_err=err,
            checked=[err], f64_err=f64[0], plain_f64_err=f64[1], checked_f64=[f64],
            ms=cuda_ms(lambda: fn(*args)),
            ms_plan_table=cuda_ms(lambda: fn(*args, runs=k6_runs)),
            kernel_ms=kernel_ms(lambda: fn(*args, runs=k6_runs), "segment_outer_kernel"),
            plain_ms=cuda_ms(lambda: kernels.segment_outer_plain(*args)),
            library_ms=cuda_ms(k6_library),
            bmm_ms=cuda_ms(lambda: torch.bmm(xs_tt, g_tiles)),
            **matrix_bounds((2 * e_rows * d + tiles + u_pad * d * d) * 4,
                            2 * e_rows * d * d),
        )
        del xs, xd, wm, ws, bias, g_out, args, out, again, plain, xs_t, xd_t, xs_tt
        del g_tiles, k6_library
        torch.cuda.empty_cache()

        # Kernel 7, the dual CSR segment-sum, over the src-sorted and
        # dst-sorted rows with their own bounds: the cotangent pair of a
        # layer's h[src], h[dst] gathers (pad rows zero, as there). Library:
        # two torch.segment_reduce calls.
        xa = torch.randn(e_rows, d, device=dev, generator=gen)
        xa[pad_src_sorted] = 0.0
        xb = torch.randn(e_rows, d, device=dev, generator=gen)
        xb[pad_sorted] = 0.0
        args = (xa, xb, n, plan.src_splits, plan.dst_splits)
        fn = kernels.dual_sorted_segment_sum
        out = fn(*args)
        again = fn(*args)
        plain = kernels.dual_sorted_segment_sum_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"dual_sorted_segment_sum d={d}: two runs differ")
        err = max((a - b).abs().max().item() for a, b in zip(out, plain))
        off_a = plan.src_splits[: n + 1].long()
        rows_a = int(g.sort_plan.src_splits[n] - g.sort_plan.src_splits[0])
        b_ms, b_by = bound(((rows_a + rows) * d + 2 * (n + 1) + 2 * n * d) * 4,
                           (rows_a + rows) * d)
        results[("dual_sorted_segment_sum", d)] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: kernels.dual_sorted_segment_sum_plain(*args)),
            library_ms=cuda_ms(lambda: (
                torch.segment_reduce(xa, "sum", offsets=off_a, unsafe=True),
                torch.segment_reduce(xb, "sum", offsets=offsets, unsafe=True),
            )),
            bound_ms=b_ms, bound_by=b_by, **csr_own(lambda: fn(*args)),
        )
        del xa, xb, args, out, again, plain
        torch.cuda.empty_cache()

        # The gather kernel on a layer's [E, d] permute into dst order by the
        # plan (int32 indices), against index_select, which is both its plain
        # version and the library call, bit for bit.
        x = torch.randn(e_rows, d, device=dev, generator=gen)
        perm = plan.dst_perm
        fn = kernels.gather_rows
        (out,) = fn(x, perm)
        want = kernels.gather_rows_plain(x, perm)[0]
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"gather_rows d={d}: differs from index_select")
        b_ms, b_by = bound(gather_bytes(x, perm), 0)
        plain_ms = cuda_ms(lambda: kernels.gather_rows_plain(x, perm))
        results[("gather_rows", d)] = dict(
            max_abs_err=(out - want).abs().max().item(), ms=cuda_ms(lambda: fn(x, perm)),
            kernel_ms=kernel_ms(lambda: fn(x, perm), "gather_rows_kernel"),
            plain_ms=plain_ms, library_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        )
        del x, out, want
        torch.cuda.empty_cache()

    for (name, d), r in results.items():
        dw = (f" dW scaled err {r['dw_scaled_err']:.3e}"
              if "dw_scaled_err" in r else "")
        f64 = (f" | vs float64 {r['f64_err']:.3e}, plain {r['plain_f64_err']:.3e}"
               if "f64_err" in r else "")
        core = (f" [CUDA-core bound {r['cuda_core_bound_ms']:.4f}]"
                if "cuda_core_bound_ms" in r else "")
        bmm = f" (bmm alone {r['bmm_ms']:.4f})" if "bmm_ms" in r else ""
        log(f"kernel {name} d={d}: max_abs_err {r['max_abs_err']:.3e}{dw} "
            f"(tol {KERNEL_ATOL}){f64} | ms {r['ms']:.4f}{own_times(r)} "
            f"bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}){core} plain {r['plain_ms']:.4f} "
            f"library {r['library_ms']:.4f}{bmm}")
        # A dW sums thousands of products: it is held after scaling.
        checked = r.get("checked", [r["max_abs_err"], r.get("dw_scaled_err", 0.0)])
        check(max(checked) <= KERNEL_ATOL, f"{name} d={d} disagrees with its plain version")
        # 3xTF32 is held to f32's own error against float64, output by output.
        check(all(k <= 2 * p for k, p in r.get("checked_f64", [])),
              f"{name} d={d}: float64 error over twice the plain version's "
              f"{r.get('checked_f64')}")
    return results


def own_times(r: dict) -> str:
    """The wrapper's time with the SortPlan's run table, the kernel's own
    and its device launches a call, for the log, where they were taken."""
    parts = []
    if "ms_plan_table" in r:
        parts.append(f"with the plan's run table {r['ms_plan_table']:.4f}")
    if "kernel_ms" in r:
        parts.append(f"kernel alone {r['kernel_ms']:.4f}")
    if "host_ms" in r:
        parts.append(f"host {r['host_ms']:.4f} a call")
    if "device_launches_per_call" in r:
        parts.append(f"{r['device_launches_per_call']} device launch(es) a call")
    return f" ({', '.join(parts)})" if parts else ""


def device_launches(fn) -> int:
    """Kernels that one warm call of ``fn`` launches on the device, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU)


def host_ms(fn, calls: int = 50) -> float:
    """Host milliseconds a call of ``fn`` takes to enqueue its work, over
    ``calls`` calls issued without a synchronise in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def csr_own(fn) -> dict:
    """Kernel 1's or 7's profiled time alone, its device launches a call and
    the wrapper's host time a call (back to back, the events time the
    larger of the host's and the device's)."""
    return dict(kernel_ms=kernel_ms(fn, "csr_segment_sum_kernel"),
                device_launches_per_call=device_launches(fn), host_ms=host_ms(fn))


def dbias_sums(dev, rel_splits, e_rows: int, u_pad: int, d: int, dtype, gen) -> dict:
    """Kernel 1 at the dbias shape of kernel 2's backward
    (ops/cuda/edge_transform.py): the cotangent rows [E_pad, d] summed over
    the relation-sorted layout's rel_splits, 240 segments of ~4,300 rows,
    the padding relations empty. Twice the same bits, the empty segments
    exactly 0, within the f32 gate of the plain version; times and bound.
    Library: torch.segment_reduce on the rows (upcast from bf16 outside the
    timing)."""
    x = torch.randn(e_rows, d, device=dev, generator=gen).to(dtype)
    fn = kernels.csr_segment_sum
    out, again = fn(x, rel_splits, u_pad), fn(x, rel_splits, u_pad)
    plain = kernels.csr_segment_sum_plain(x, rel_splits, u_pad)
    torch.cuda.synchronize()
    empty = (rel_splits[1: u_pad + 1] == rel_splits[:u_pad]).nonzero().flatten()
    check(torch.equal(out, again) and len(empty) > 0 and not out[empty].any(),
          f"csr_segment_sum dbias d={d} {dtype}: two runs differ, or an empty "
          "relation is not 0")
    rows = int(rel_splits[u_pad] - rel_splits[0])
    wide, offsets = x.float(), rel_splits[: u_pad + 1].long()
    b_ms, b_by = bound(rows * d * x.element_size() + ((u_pad + 1) + u_pad * d) * 4, rows * d)
    r = dict(max_abs_err=scaled_err(out, plain), ms=cuda_ms(lambda: fn(x, rel_splits, u_pad)),
             plain_ms=cuda_ms(lambda: kernels.csr_segment_sum_plain(x, rel_splits, u_pad)),
             library_ms=cuda_ms(lambda: torch.segment_reduce(wide, "sum", offsets=offsets,
                                                             unsafe=True)),
             bound_ms=b_ms, bound_by=b_by, **csr_own(lambda: fn(x, rel_splits, u_pad)))
    check(r["max_abs_err"] <= KERNEL_ATOL,
          f"csr_segment_sum dbias d={d} {dtype} disagrees with its plain version")
    log(f"kernel csr_segment_sum dbias ({u_pad} relations) d={d} {dtype}: scaled err "
        f"{r['max_abs_err']:.3e} | ms {r['ms']:.4f}{own_times(r)} bound "
        f"{r['bound_ms']:.4f} ({r['bound_by']}) plain {r['plain_ms']:.4f} library "
        f"{r['library_ms']:.4f}")
    return r


def _tf32_library_ms(fn) -> float:
    """``cuda_ms(fn)`` with PyTorch's TF32 on, so that its products take one
    TF32 pass as the one-pass mode does; TF32 is off again after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return cuda_ms(fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_kernel_forms(dev, g) -> dict:
    """Every form of the kernels besides f32, at the xl shapes: kernels 1,
    2, 3, 5, 6 and 7 in bf16 against their plain bf16 versions; kernels 2,
    3, 5 and 6 in one TF32 pass (precision="default") by their float64
    error; kernels 1 and 7 in mode="fast" against their plain versions;
    with times and bounds. Keys ``(name, form, d)``."""
    plan = g.sort_plan.to(dev)
    rel = torch.as_tensor(g.rel_ids, device=dev)
    e_rows, n, u_pad = g.rel_ids.shape[0], XL_N, g.char_ids.shape[0]
    pad_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.dst_perm] == 0, device=dev)
    visited = set(g.rel_ids[::256].tolist())
    unvisited = [r for r in range(u_pad) if r not in visited]
    u_vis, tiles = len(visited), e_rows // 256
    tile_rel = rel[::256].long()
    rows = int(g.sort_plan.dst_splits[n] - g.sort_plan.dst_splits[0])
    rows_a = int(g.sort_plan.src_splits[n] - g.sort_plan.src_splits[0])
    pad_src_sorted = torch.as_tensor(g.edge_mask[g.sort_plan.src_perm] == 0, device=dev)
    bf16 = torch.bfloat16
    k3_runs = k6_runs = plan_runs(plan)
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for d in (64, 128):
        # Kernel 1's bf16 form over the dst-sorted rows (pad rows zero):
        # f32 sums of bf16 rows against the plain version's, in another
        # order. Library: torch.segment_reduce on the bf16 rows.
        x = torch.randn(e_rows, d, device=dev, generator=gen).to(bf16)
        x[pad_sorted] = 0.0
        splits, fn = plan.dst_splits, kernels.csr_segment_sum
        out, again = fn(x, splits, n), fn(x, splits, n)
        plain = kernels.csr_segment_sum_plain(x, splits, n)
        torch.cuda.synchronize()
        check(out.dtype == torch.float32 and torch.equal(out, again),
              f"csr_segment_sum[bf16] d={d}: not f32, or two runs differ")
        check(not out[7].any(), f"csr_segment_sum[bf16] d={d}: empty segment 7 is not 0")
        offsets = splits[: n + 1].long()
        b_ms, b_by = bound(rows * d * 2 + ((n + 1) + n * d) * 4, rows * d)
        results[("csr_segment_sum", "bf16", d)] = dict(
            max_abs_err=(out - plain).abs().max().item(), tol=KERNEL_ATOL,
            ms=cuda_ms(lambda: fn(x, splits, n)),
            plain_ms=cuda_ms(lambda: kernels.csr_segment_sum_plain(x, splits, n)),
            library_ms=cuda_ms(
                lambda: torch.segment_reduce(x, "sum", offsets=offsets, unsafe=True)),
            bound_ms=b_ms, bound_by=b_by, **csr_own(lambda: fn(x, splits, n)),
            dbias=dbias_sums(dev, plan.rel_splits, e_rows, u_pad, d, bf16, gen),
        )
        del x, out, again, plain

        # Kernels 2 and 3 on random rows, banks and cotangent: in bf16, and
        # in f32 for the one-pass mode.
        xs, xd, g_out = (torch.randn(e_rows, d, device=dev, generator=gen) for _ in range(3))
        wm, ws = (torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
                  for _ in range(2))
        bias = torch.randn(u_pad, d, device=dev, generator=gen)
        f32_fwd, f32_bwd = (xs, xd, rel, wm, ws, bias), (g_out, xs, xd, rel, wm, ws)
        fwd, bwd = ([t.to(bf16) if t.is_floating_point() else t for t in a]
                    for a in (f32_fwd, f32_bwd))

        # Kernel 2's bf16 form. Library: baddbmm in bf16 over the
        # tile-gathered banks (the gather not timed).
        fn, plain_fn = (kernels.edge_transform_sorted_combined,
                        kernels.edge_transform_sorted_combined_plain)
        out, plain = fn(*fwd), plain_fn(*fwd)
        torch.cuda.synchronize()
        check(out.dtype == bf16, f"edge_transform_sorted_combined[bf16] d={d}: not bf16")
        x_cat = torch.cat(fwd[:2], dim=1).view(tiles, 256, 2 * d)
        w_cat = torch.cat(fwd[3:5], dim=1)[tile_rel]
        b_tile = fwd[5][tile_rel][:, None, :]
        b_ms, b_by = bound((2 * e_rows * d + 2 * u_vis * d * d + u_vis * d + e_rows * d) * 2
                           + tiles * 4, 2 * 2 * e_rows * d * d + e_rows * d,
                           rate=BF16_FLOP_PER_S)
        results[("edge_transform_sorted_combined", "bf16", d)] = dict(
            max_abs_err=(out.float() - plain.float()).abs().max().item(),
            tol=BF16_ULP * plain.float().abs().max().item(),
            ms=cuda_ms(lambda: fn(*fwd)), plain_ms=cuda_ms(lambda: plain_fn(*fwd)),
            library_ms=cuda_ms(lambda: torch.baddbmm(b_tile, x_cat, w_cat)),
            bound_ms=b_ms, bound_by=b_by,
        )
        del out, plain, w_cat, b_tile

        # Kernel 3's bf16 form: dx in bf16 within one ulp, dW f32 (summed
        # over the runs inside the kernel) within the f32 gate. Library: bmm
        # in bf16 per tile and index_add_ of the tile partials (rounded to
        # bf16 per tile) into their relations.
        fn, plain_fn = (kernels.edge_transform_combined_bwd,
                        kernels.edge_transform_combined_bwd_plain)
        out, again, plain = fn(*bwd), fn(*bwd), plain_fn(*bwd)
        torch.cuda.synchronize()
        name = "edge_transform_combined_bwd[bf16]"
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name} d={d}: two runs differ")
        check(bool(unvisited) and not any(dw[unvisited].any() for dw in out[2:]),
              f"{name} d={d}: dW of the unvisited relations is not exactly 0")
        check([t.dtype for t in out] == [bf16, bf16, torch.float32, torch.float32],
              f"{name} d={d}: dtypes {[t.dtype for t in out]}")
        g_tiles = bwd[0].view(tiles, 256, d)
        w_t = torch.cat(bwd[4:6], dim=1)[tile_rel].transpose(1, 2).contiguous()
        x_t = x_cat.transpose(1, 2)

        def k3_library(g_tiles=g_tiles, w_t=w_t, x_t=x_t):
            dw = torch.zeros(u_pad, 2 * d, d, device=dev)
            return (torch.bmm(g_tiles, w_t),
                    dw.index_add_(0, tile_rel, torch.bmm(x_t, g_tiles).float()))

        b_ms, b_by = bound(5 * e_rows * d * 2 + tiles * 4 + 2 * u_vis * d * d * 2
                           + 2 * u_pad * d * d * 4, 8 * e_rows * d * d,
                           rate=BF16_FLOP_PER_S)
        results[("edge_transform_combined_bwd", "bf16", d)] = dict(
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(out[:2], plain[:2])),
            tol=BF16_ULP * max(b.float().abs().max().item() for b in plain[:2]),
            dw_scaled_err=max(scaled_err(a, b) for a, b in zip(out[2:], plain[2:])),
            ms=cuda_ms(lambda: fn(*bwd)),
            ms_plan_table=cuda_ms(lambda: fn(*bwd, runs=k3_runs)),
            kernel_ms=kernel_ms(lambda: fn(*bwd, runs=k3_runs),
                                "edge_transform_bwd_bf16_kernel"),
            plain_ms=cuda_ms(lambda: plain_fn(*bwd)),
            library_ms=cuda_ms(k3_library), bound_ms=b_ms, bound_by=b_by,
        )
        del out, again, plain, w_t, x_t, x_cat, k3_library

        # Kernel 5's bf16 form on kernel 2's bf16 rows and banks: both
        # outputs within one ulp. Library: baddbmm and bmm in bf16 over the
        # tile-gathered banks (the gather not timed).
        fn, plain_fn = kernels.edge_transform_sorted, kernels.edge_transform_sorted_plain
        out, plain = fn(*fwd), plain_fn(*fwd)
        torch.cuda.synchronize()
        check([t.dtype for t in out] == [bf16, bf16],
              f"edge_transform_sorted[bf16] d={d}: outputs not bf16")
        xs_t, xd_t = (t.view(tiles, 256, d) for t in fwd[:2])
        wm_t, ws_t = fwd[3][tile_rel], fwd[4][tile_rel]
        b_tile = fwd[5][tile_rel][:, None, :]
        b_ms, b_by = bound((4 * e_rows * d + 2 * u_vis * d * d + u_vis * d) * 2 + tiles * 4,
                           4 * e_rows * d * d + e_rows * d, rate=BF16_FLOP_PER_S)
        results[("edge_transform_sorted", "bf16", d)] = dict(
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(out, plain)),
            tol=BF16_ULP * max(b.float().abs().max().item() for b in plain),
            ms=cuda_ms(lambda: fn(*fwd)), plain_ms=cuda_ms(lambda: plain_fn(*fwd)),
            library_ms=cuda_ms(lambda: (torch.baddbmm(b_tile, xs_t, wm_t),
                                        torch.bmm(xd_t, ws_t))),
            bound_ms=b_ms, bound_by=b_by,
            kernel_ms=kernel_ms(lambda: fn(*fwd), "edge_transform_bf16_kernel"),
        )
        # Kernel 2's bf16 form is the same body with one output: its times
        # beside kernel 5's, taken in turns.
        k2 = kernels.edge_transform_sorted_combined
        k2_ms = [cuda_ms(lambda: k2(*fwd)) for _ in range(2)]
        k5_ms = [results[("edge_transform_sorted", "bf16", d)]["ms"], cuda_ms(lambda: fn(*fwd))]
        results[("edge_transform_sorted", "bf16", d)]["kernel_2_bf16_ms"] = k2_ms
        log(f"kernel 5 bf16 d={d}: {k5_ms[0]:.4f}, {k5_ms[1]:.4f} ms; kernel 2 bf16 "
            f"beside it: {k2_ms[0]:.4f}, {k2_ms[1]:.4f} ms")
        del out, plain, xs_t, xd_t, wm_t, ws_t, b_tile

        # Kernel 6's bf16 form of x_src against the bf16 cotangent: f32 dW
        # (summed over the runs inside the kernel) within the f32 gate,
        # deterministic, 0 for unvisited relations. Library: bmm in bf16 per
        # tile and index_add_ of the tile partials into their relations.
        outer = (bwd[1], bwd[0], rel, u_pad)
        fn, plain_fn = kernels.segment_outer, kernels.segment_outer_plain
        out, again, plain = fn(*outer), fn(*outer), plain_fn(*outer)
        torch.cuda.synchronize()
        name = "segment_outer[bf16]"
        check(out.dtype == torch.float32 and torch.equal(out, again),
              f"{name} d={d}: not f32, or two runs differ")
        check(bool(unvisited) and not out[unvisited].any(),
              f"{name} d={d}: dW of the unvisited relations is not exactly 0")
        x_tt, g_tiles = bwd[1].view(tiles, 256, d).transpose(1, 2), bwd[0].view(tiles, 256, d)

        def k6_library(x_tt=x_tt, g_tiles=g_tiles):
            dw = torch.zeros(u_pad, d, d, device=dev)
            return dw.index_add_(0, tile_rel, torch.bmm(x_tt, g_tiles).float())

        scale = max(1.0, plain.abs().max().item())
        b_ms, b_by = bound(2 * e_rows * d * 2 + tiles * 4 + u_pad * d * d * 4,
                           2 * e_rows * d * d, rate=BF16_FLOP_PER_S)
        results[("segment_outer", "bf16", d)] = dict(
            max_abs_err=(out - plain).abs().max().item(), tol=KERNEL_ATOL * scale,
            dw_scaled_err=scaled_err(out, plain),
            ms=cuda_ms(lambda: fn(*outer)),
            ms_plan_table=cuda_ms(lambda: fn(*outer, runs=k6_runs)),
            kernel_ms=kernel_ms(lambda: fn(*outer, runs=k6_runs),
                                "segment_outer_bf16_kernel"),
            plain_ms=cuda_ms(lambda: plain_fn(*outer)),
            library_ms=cuda_ms(k6_library), bound_ms=b_ms, bound_by=b_by,
        )
        del out, again, plain, x_tt, g_tiles, k6_library, outer, fwd, bwd
        torch.cuda.empty_cache()

        # The one-TF32-pass mode of kernels 2 and 3 on the f32 data, by its
        # float64 error (scaled), bound at 495 TFLOP/s of TF32. Library:
        # the f32 compositions above with PyTorch's TF32 on.
        tiles_x = torch.cat([xs, xd], dim=1).view(tiles, 256, 2 * d)
        w_cat = torch.cat([wm, ws], dim=1)[tile_rel]
        b_tile = bias[tile_rel][:, None, :]
        g_tiles = g_out.view(tiles, 256, d)
        w_t = w_cat.transpose(1, 2).contiguous()

        def k3_tf32_library():
            dw = torch.zeros(u_pad, 2 * d, d, device=dev)
            return (torch.bmm(g_tiles, w_t),
                    dw.index_add_(0, tile_rel, torch.bmm(tiles_x.transpose(1, 2), g_tiles)))

        xs_t, xd_t = xs.view(tiles, 256, d), xd.view(tiles, 256, d)
        wm_t, ws_t = wm[tile_rel], ws[tile_rel]

        def k6_tf32_library():
            dw = torch.zeros(u_pad, d, d, device=dev)
            return dw.index_add_(0, tile_rel, torch.bmm(xs_t.transpose(1, 2), g_tiles))

        for kname, plain_fn, args, nout, nbytes, flops, lib in (
            ("edge_transform_sorted_combined", kernels.edge_transform_sorted_combined_plain,
             f32_fwd, 1, (2 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d
                          + e_rows * d) * 4, 4 * e_rows * d * d + e_rows * d,
             lambda: torch.baddbmm(b_tile, tiles_x, w_cat)),
            ("edge_transform_combined_bwd", kernels.edge_transform_combined_bwd_plain,
             f32_bwd, 4, (5 * e_rows * d + tiles + 2 * u_vis * d * d
                          + 2 * u_pad * d * d) * 4, 8 * e_rows * d * d, k3_tf32_library),
            ("edge_transform_sorted", kernels.edge_transform_sorted_plain, f32_fwd, 2,
             (4 * e_rows * d + tiles + 2 * u_vis * d * d + u_vis * d) * 4,
             4 * e_rows * d * d + e_rows * d,
             lambda: (torch.baddbmm(b_tile, xs_t, wm_t), torch.bmm(xd_t, ws_t))),
            ("segment_outer", kernels.segment_outer_plain, (xs, g_out, rel, u_pad), 1,
             (2 * e_rows * d + tiles + u_pad * d * d) * 4, 2 * e_rows * d * d,
             k6_tf32_library),
        ):
            fn = getattr(kernels, kname)

            def one_pass(*a, fn=fn, **kw):
                return fn(*a, precision="default", **kw)

            out, plain = one_pass(*args), plain_fn(*args)
            if kname == "segment_outer":
                check(torch.equal(out, one_pass(*args)) and not out[unvisited].any(),
                      f"segment_outer[tf32] d={d}: two runs differ, or the dW of the "
                      "unvisited relations is not exactly 0")
            out, plain = (out, plain) if nout > 1 else ((out,), (plain,))
            err = max((a - b).abs().max().item() for a, b in zip(out, plain))
            del out, plain
            f64 = float64_errors(one_pass, plain_fn, args, scaled=tuple(range(nout)))
            b_ms, b_by = bound(nbytes, flops, rate=TF32_FLOP_PER_S)
            own = {}
            if kname in ("edge_transform_combined_bwd", "segment_outer"):
                table, kernel = ((k3_runs, "edge_transform_bwd_kernel")
                                 if kname == "edge_transform_combined_bwd"
                                 else (k6_runs, "segment_outer_kernel"))
                own = dict(
                    ms_plan_table=cuda_ms(lambda: one_pass(*args, runs=table)),
                    kernel_ms=kernel_ms(lambda: one_pass(*args, runs=table), kernel))
            results[(kname, "tf32", d)] = dict(
                max_abs_err=err, f64_scaled_err=max(k for k, _ in f64),
                plain_f64_scaled_err=max(p for _, p in f64), **own,
                ms=cuda_ms(lambda: one_pass(*args)),
                plain_ms=cuda_ms(lambda: plain_fn(*args)),
                library_ms=_tf32_library_ms(lib), bound_ms=b_ms, bound_by=b_by,
            )
        del xs, xd, g_out, wm, ws, bias, f32_fwd, f32_bwd, tiles_x, w_cat, b_tile
        del g_tiles, w_t, k3_tf32_library, xs_t, xd_t, wm_t, ws_t, k6_tf32_library
        torch.cuda.empty_cache()

        # The sums' other forms over the src- and dst-sorted rows of a
        # layer's gather cotangents (pad rows zero): kernel 7 on bf16 rows,
        # kernels 1 and 7 in mode="fast" on f32 rows, each within the f32
        # gate of its plain version and bitwise deterministic; the fast
        # sums' error against the exact ones is printed. Library:
        # torch.segment_reduce on the rows upcast from bf16 or rounded to
        # bf16 (prepared outside the timing), once per stream.
        xa = torch.randn(e_rows, d, device=dev, generator=gen)
        xa[pad_src_sorted] = 0.0
        xb = torch.randn(e_rows, d, device=dev, generator=gen)
        xb[pad_sorted] = 0.0
        off_a = plan.src_splits[: n + 1].long()
        for kname, form in (("dual_sorted_segment_sum", "bf16"), ("csr_segment_sum", "fast"),
                            ("dual_sorted_segment_sum", "fast")):
            mode = "fast" if form == "fast" else "exact"
            streams = (xa.to(bf16), xb.to(bf16)) if form == "bf16" else (xa, xb)
            wide = [t.to(bf16).float() for t in streams]
            if kname == "csr_segment_sum":
                args, exact_args = (streams[1], plan.dst_splits, n), (xb, plan.dst_splits, n)
                n_rows, row_bytes = rows, 4

                def library(wide=wide):
                    return torch.segment_reduce(wide[1], "sum", offsets=offsets, unsafe=True)
            else:
                args = (*streams, n, plan.src_splits, plan.dst_splits)
                exact_args = (xa, xb, n, plan.src_splits, plan.dst_splits)
                n_rows, row_bytes = rows_a + rows, 2 if form == "bf16" else 4

                def library(wide=wide):
                    return (torch.segment_reduce(wide[0], "sum", offsets=off_a, unsafe=True),
                            torch.segment_reduce(wide[1], "sum", offsets=offsets, unsafe=True))

            fn = getattr(kernels, kname)
            plain_fn = getattr(kernels, f"{kname}_plain")
            out, again = fn(*args, mode=mode), fn(*args, mode=mode)
            plain, exact = plain_fn(*args, mode=mode), fn(*exact_args)
            torch.cuda.synchronize()
            out, again, plain, exact = (t if isinstance(t, tuple) else (t,)
                                        for t in (out, again, plain, exact))
            check(all(a.dtype == torch.float32 and torch.equal(a, b)
                      for a, b in zip(out, again)),
                  f"{kname}[{form}] d={d}: not f32, or two runs differ")
            check(not out[-1][7].any(), f"{kname}[{form}] d={d}: empty segment 7 is not 0")
            streams_n = len(out)
            b_ms, b_by = bound(n_rows * d * row_bytes + streams_n * ((n + 1) + n * d) * 4,
                               n_rows * d)
            results[(kname, form, d)] = dict(
                max_abs_err=max((a - b).abs().max().item() for a, b in zip(out, plain)),
                tol=KERNEL_ATOL,
                err_vs_exact=max((a - b).abs().max().item() for a, b in zip(out, exact)),
                ms=cuda_ms(lambda: fn(*args, mode=mode)),
                plain_ms=cuda_ms(lambda: plain_fn(*args, mode=mode)),
                library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
                **csr_own(lambda: fn(*args, mode=mode)),
            )
            del out, again, plain, exact, streams, wide, args, exact_args, library
        del xa, xb
        torch.cuda.empty_cache()

    # Kernel 3's bf16 form at d_in = 64, d_out = 192: two 128-column slabs,
    # dx's f32 sums kept across them and rounded once; against its plain
    # version as at d=64 and 128.
    d_in, d_out = 64, 192
    g_out = torch.randn(e_rows, d_out, device=dev, generator=gen).to(bf16)
    xs, xd = (torch.randn(e_rows, d_in, device=dev, generator=gen).to(bf16)
              for _ in range(2))
    wm, ws = ((torch.randn(u_pad, d_in, d_out, device=dev, generator=gen) / d_in**0.5)
              .to(bf16) for _ in range(2))
    bwd = (g_out, xs, xd, rel, wm, ws)
    fn, plain_fn = (kernels.edge_transform_combined_bwd,
                    kernels.edge_transform_combined_bwd_plain)
    out, again, plain = fn(*bwd), fn(*bwd), plain_fn(*bwd)
    torch.cuda.synchronize()
    name = "edge_transform_combined_bwd[bf16]"
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"{name} d_out={d_out}: two runs differ")
    check(not any(dw[unvisited].any() for dw in out[2:]),
          f"{name} d_out={d_out}: dW of the unvisited relations is not exactly 0")
    g_tiles = g_out.view(tiles, 256, d_out)
    w_t = torch.cat([wm, ws], dim=1)[tile_rel].transpose(1, 2).contiguous()
    x_t = torch.cat([xs, xd], dim=1).view(tiles, 256, 2 * d_in).transpose(1, 2)

    def k3_library_192():
        dw = torch.zeros(u_pad, 2 * d_in, d_out, device=dev)
        return (torch.bmm(g_tiles, w_t),
                dw.index_add_(0, tile_rel, torch.bmm(x_t, g_tiles).float()))

    b_ms, b_by = bound((e_rows * d_out + 4 * e_rows * d_in + 2 * u_vis * d_in * d_out) * 2
                       + tiles * 4 + 2 * u_pad * d_in * d_out * 4,
                       8 * e_rows * d_in * d_out, rate=BF16_FLOP_PER_S)
    results[("edge_transform_combined_bwd", "bf16", d_out)] = dict(
        max_abs_err=max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(out[:2], plain[:2])),
        tol=BF16_ULP * max(b.float().abs().max().item() for b in plain[:2]),
        dw_scaled_err=max(scaled_err(a, b) for a, b in zip(out[2:], plain[2:])),
        ms=cuda_ms(lambda: fn(*bwd)),
        ms_plan_table=cuda_ms(lambda: fn(*bwd, runs=k3_runs)),
        kernel_ms=kernel_ms(lambda: fn(*bwd, runs=k3_runs),
                            "edge_transform_bwd_bf16_kernel"),
        plain_ms=cuda_ms(lambda: plain_fn(*bwd)),
        library_ms=cuda_ms(k3_library_192), bound_ms=b_ms, bound_by=b_by,
    )
    del out, again, plain, bwd, g_out, xs, xd, wm, ws, g_tiles, w_t, x_t, k3_library_192
    torch.cuda.empty_cache()

    for (name, form, d), r in results.items():
        extra = (f" dW scaled err {r['dw_scaled_err']:.3e} (tol {KERNEL_ATOL})"
                 if "dw_scaled_err" in r else "")
        if "err_vs_exact" in r:
            extra += f"; vs the exact f32 sums {r['err_vs_exact']:.3e}"
        if form == "tf32":
            gate = (f"vs float64 scaled {r['f64_scaled_err']:.3e} (tol {ONE_PASS_SCALED}), "
                    f"plain f32 {r['plain_f64_scaled_err']:.3e}; vs plain "
                    f"{r['max_abs_err']:.3e}")
        else:
            gate = f"max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e})"
        width = f"d_in=64 d_out={d}" if d not in (64, 128) else f"d={d}"
        log(f"kernel {name}[{form}] {width}: {gate}{extra} | ms {r['ms']:.4f}"
            f"{own_times(r)} bound {r['bound_ms']:.4f} ({r['bound_by']}) plain "
            f"{r['plain_ms']:.4f} library {r.get('library_ms', float('nan')):.4f}")
        ok = (r["f64_scaled_err"] <= ONE_PASS_SCALED if form == "tf32"
              else r["max_abs_err"] <= r["tol"])
        check(ok and r.get("dw_scaled_err", 0.0) <= KERNEL_ATOL,
              f"{name}[{form}] d={d} disagrees with its reference")
    return results


def phase_serving(dev) -> dict:
    feats_np, ei, etexts, _ = xl_edges()
    feats = torch.as_tensor(feats_np, device=dev)
    model = HyperGNN(TEXT_DIM, WIDTH, WIDTH, LAYERS, seed=0, device=dev).eval()
    heads = torch.as_tensor(
        np.random.default_rng(1).choice(XL_N, QUERY_HEADS, replace=False), device=dev
    )
    requests = []
    for k in range(REQUESTS):
        # Two edges of a relation text the graph has never held (demo.py).
        new = np.asarray([[1 + k, 2 + k], [2 + k, k]], dtype=np.int64)
        requests.append((
            np.concatenate([ei, new], axis=1),
            etexts + [f"is colleague of, variant {k}"] * 2,
        ))

    with profiling.tally() as counts:
        latencies, first = [], None
        for ei_k, texts_k in requests:
            t0 = time.perf_counter()
            graph = model.preprocess(ei_k, texts_k, XL_N)
            t1 = time.perf_counter()
            embs = model.forward_encoded(feats, graph)
            with torch.inference_mode():
                scores, top = torch.topk(score_all_tails(embs, heads), TOP_K, dim=1)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(embs.shape == (XL_N, WIDTH) and bool(torch.isfinite(embs).all()),
                  "serving: embeddings not finite or of wrong shape")
            check(bool(torch.isfinite(scores).all()) and top.shape == (QUERY_HEADS, TOP_K),
                  "serving: scores not finite or of wrong shape")
            latencies.append(dict(host_encode_ms=(t1 - t0) * 1e3,
                                  device_ms=(t2 - t1) * 1e3,
                                  total_ms=(t2 - t0) * 1e3))
            if first is None:
                first = (graph, embs)
    launches = kernel_launches(counts)
    for i, lat in enumerate(latencies):
        log(f"serving request {i}: host encode {lat['host_encode_ms']:.1f} ms, "
            f"device {lat['device_ms']:.1f} ms, total {lat['total_ms']:.1f} ms")
    log(f"serving launches: {launches}")
    want = {name: n * REQUESTS for name, n in FORWARD_LAUNCHES.items()}
    check(launches == want, f"serving launch counts {launches} != {want}")

    def request():
        embs = model.forward_encoded(feats, first[0])
        with torch.inference_mode():
            torch.topk(score_all_tails(embs, heads), TOP_K, dim=1)

    profile = profile_device("one warm request", request)
    stages = encode_stages(*requests[-1])

    # The first request against the gather oracle, on the card.
    oracle = HyperGNN(TEXT_DIM, WIDTH, WIDTH, LAYERS, seed=0, device=dev,
                      backend="gather").eval()
    graph, embs = first
    err_oracle = (oracle.forward_encoded(feats, graph) - embs).abs().max().item()
    del oracle
    # A toy graph: the card against the CPU (plain versions), same weights.
    kg = ToyKnowledgeGraph()
    on_card = HyperGNN(64, 16, 32, seed=0, device=dev).eval()(
        kg.node_features, kg.edge_index, kg.edge_texts)
    on_cpu = HyperGNN(64, 16, 32, seed=0, device="cpu").eval()(
        kg.node_features, kg.edge_index, kg.edge_texts)
    err_cpu = (on_card.cpu() - on_cpu).abs().max().item()
    log(f"serving: first request vs gather oracle max_abs_err {err_oracle:.3e}, "
        f"toy graph card vs cpu {err_cpu:.3e} (tol {SERVING_ATOL})")
    check(err_oracle <= SERVING_ATOL and err_cpu <= SERVING_ATOL,
          "serving disagrees with its references")
    return dict(launches=launches, latencies=latencies, profile=profile,
                encode_stages=stages)


def encode_stages(ei, etexts) -> dict:
    """One more warm request's encode (``HyperGNN.preprocess``: the kernel
    layout with a plan) timed whole, and four stages each timed alone on the
    same inputs: dedup, tokenize, relation sort, sort plan. The rest (group
    pad, the text rows, the masks and copies) is not timed alone: it is the
    whole less those four, by subtraction."""
    t = [time.perf_counter()]
    unique, rel_ids = dedup_texts(etexts)
    t.append(time.perf_counter())
    tokenize_texts(unique)
    t.append(time.perf_counter())
    relation_order(rel_ids, pad_bucket_relations(len(unique)))
    t.append(time.perf_counter())
    graph = encode(ei, etexts)
    t.append(time.perf_counter())
    build_sort_plan(graph.src, graph.dst, graph.rel_ids, graph.edge_mask, XL_N,
                    graph.char_ids.shape[0])
    t.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    out = dict(dedup_ms=ms[0], tokenize_ms=ms[1], relation_sort_ms=ms[2],
               sort_plan_ms=ms[4], encode_total_ms=ms[3])
    out["rest_by_subtraction_ms"] = ms[3] - ms[0] - ms[1] - ms[2] - ms[4]
    names = dict(rest_by_subtraction="rest of encode (group pad, text rows, copies; "
                 "whole less the four stages, by subtraction)")
    log("serving encode by stage (one warm request, native host code): " + ", ".join(
        f"{names.get(k[:-3], k[:-3].replace('_', ' '))} {v:.1f} ms" for k, v in out.items())
        + "; the numpy encoder's only earlier record on this card class: 920-976 ms "
        "of host encode a warm request")
    return out


def profile_device(label: str, fn, rows: int = 14) -> dict:
    """Device time by kernel and copy of one more (warm) ``fn()``, by
    torch.profiler: the largest ``rows`` entries and the total."""
    from torch.profiler import ProfilerActivity, profile

    # As in kernel_ms, a window the profiler hands back empty is profiled
    # again, three times at most.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device events (kernels and copies) only: host ops (aten ops, the
        # autograd Functions) and annotated ranges (Optimizer.step) would
        # count the kernels they launch again.
        device = sorted(
            ((e.key, e.count, e.self_device_time_total / 1e3)
             for e in prof.key_averages()
             if e.self_device_time_total > 0
             and e.device_type != torch.autograd.DeviceType.CPU
             and not getattr(e, "is_user_annotation", False)),
            key=lambda r: -r[2],
        )
        total = sum(ms for _, _, ms in device)
        if total > 0:
            break
    check(total > 0, f"torch.profiler recorded no device time for {label}")
    log(f"profile of {label}: wall {wall_ms:.2f} ms, device {total:.3f} ms")
    for name, calls, ms in device[:rows]:
        log(f"  {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{calls:<4d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=total,
                top=[dict(name=n[:90], calls=c, ms=ms) for n, c, ms in device[:rows]])


def train_config(backend: str = "cuda", width: int = WIDTH, **mode) -> HyperGNNConfig:
    """The xl training config of benchmarks/scaling.py: 2 layers, width 64
    (128 for xl-d128), the relation-sorted group-padded layout, dropout 0;
    ``mode`` sets compute_dtype / precision (benchmarks/scaling.py's
    GHF_SCALING_DTYPE / GHF_SCALING_PRECISION)."""
    return HyperGNNConfig(
        text_dim=TEXT_DIM, node_feat_dim=width, hidden_dim=width,
        num_layers=LAYERS, backend=backend, rel_sorted=True, group_padded=True,
        **mode,
    )


def _trainer(graph, feats_np, init, backend, device, width=WIDTH, mode=None):
    """``step(shift=None) -> loss`` over fresh Adam state on ``device``, and
    the parameter tree it updates in place."""
    state = create_train_state(
        tree_map(lambda t: t.to(device), init), adam(LEARNING_RATE)
    )
    step = make_train_step(train_config(backend, width, **(mode or {})), neg_mode="roll")
    feats = torch.as_tensor(feats_np, device=device)
    arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
    plan = graph.sort_plan.to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def run(shift=None):
        _, _, loss = step(state.params, state.opt_state, feats, *arrays, gen,
                          neg_dst=shift, sort_plan=plan)
        return loss

    return run, state.params


def phase_training(dev, width: int = WIDTH, mode: dict | None = None) -> dict:
    """1 warm-up and TRAIN_STEPS timed xl steps at ``width`` (64: xl,
    128: xl-d128) in ``mode`` (f32 by default; SPEED or ONE_PASS), then one
    more step under the profiler."""
    mode = mode or {}
    name = ("xl" if width == WIDTH else f"xl-d{width}") + "".join(
        f" {k}={v}" for k, v in mode.items())
    feats_np, graph = xl_graph(width)
    init = init_hypergnn(train_config(width=width), torch.Generator().manual_seed(0))
    run, params = _trainer(graph, feats_np, init, "cuda", dev, width, mode)
    torch.cuda.reset_peak_memory_stats(dev)
    warm = run()
    torch.cuda.synchronize()

    with profiling.tally() as counts:
        t0 = time.perf_counter()
        losses = [run() for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, by_form = kernel_launches(counts), kernel_launches_per_form(counts)
    losses = [warm.item()] + [loss.item() for loss in losses]
    ms_step = seconds / TRAIN_STEPS * 1e3
    edges_s = XL_E * TRAIN_STEPS / seconds
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"training {name}: losses {['%.6f' % v for v in losses]} (warm-up first)")
    log(f"training {name}: {ms_step:.3f} ms/step, {edges_s:,.0f} edges/s "
        f"({TRAIN_STEPS} steps, {XL_E:,} real edges of {graph.src.shape[0]:,} rows), "
        f"peak memory {peak_gb:.2f} GB")
    tables = counts.get("kernel.run_table", 0)
    log(f"training {name} launches over {TRAIN_STEPS} steps: {launches}")
    log(f"training {name} launches by form: {by_form}")
    check(all(np.isfinite(losses)), f"training {name}: a loss is not finite")
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    check(launches == want, f"training {name} launch counts {launches} != {want}")
    want = {k: {f: v * TRAIN_STEPS for f, v in forms.items()}
            for k, forms in step_launches_per_form(mode).items()}
    check(by_form == want, f"training {name} launches by form {by_form} != {want}")
    check(tables == 0, f"training {name}: {tables} run-table launches; the "
          "SortPlan's run tables were not handed down to kernel 3")
    # Master parameters, their gradients and the loss stay f32 in every mode.
    check(warm.dtype == torch.float32
          and all(t.dtype == torch.float32 and t.grad.dtype == torch.float32
                  for _, t in named_leaves(params)),
          f"training {name}: the loss, a parameter or its gradient is not f32")
    profile = profile_device(f"one more {name} training step", run)
    # The profiler slows the host, not the kernels: the profiled step's
    # device time over the unprofiled step time is the card's busy share.
    busy = profile["device_ms"] / ms_step
    log(f"training {name}: device busy {100 * busy:.1f}% of a step "
        f"(profiled device time over unprofiled ms/step)")
    return dict(ms_per_step=ms_step, edges_per_s=edges_s, losses=losses,
                peak_memory_gb=peak_gb, device_busy_share=busy,
                launches=launches, launches_per_form=by_form, profile=profile)


def _leaves(params, grads: bool) -> dict:
    return {path: (t.grad if grads else t).detach().cpu().clone()
            for path, t in named_leaves(params)}


@functools.cache
def bench_graph():
    """The bench config's features and graph (bench.py), relation-sorted,
    group-padded, with a sort plan."""
    rng = np.random.default_rng(0)
    feats_np = rng.standard_normal((BENCH_N, WIDTH)).astype(np.float32)
    ei = np.stack([rng.integers(0, BENCH_N, BENCH_E),
                   rng.integers(0, BENCH_N, BENCH_E)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(BENCH_U)]
    etexts = [texts[i] for i in rng.integers(0, BENCH_U, BENCH_E)]
    return feats_np, encode_graph(ei, etexts, BENCH_N, sort_by_relation=True,
                                  with_sort_plan=True, group_pad=256)


def phase_training_parity(dev) -> dict:
    """The bench config (bench.py): PARITY_STEPS steps with the same roll
    shifts through the card's ``cuda`` backend, the card's ``gather``
    oracle and the CPU (the kernels' plain versions), from one init."""
    feats_np, graph = bench_graph()
    init = init_hypergnn(train_config(), torch.Generator().manual_seed(0))
    shifts = np.random.default_rng(2).integers(1, graph.src.shape[0], PARITY_STEPS)
    runs = {}
    for label, device, backend in (("cuda", dev, "cuda"), ("gather", dev, "gather"),
                                   ("cpu", torch.device("cpu"), "cuda")):
        run, params = _trainer(graph, feats_np, init, backend, device)
        losses, grads = [], None
        for shift in shifts:
            losses.append(run(int(shift)).item())
            grads = grads or _leaves(params, grads=True)
        runs[label] = (losses, grads, _leaves(params, grads=False))
    losses, grads, params = runs["cuda"]
    report = {"losses": losses}
    for ref in ("gather", "cpu"):
        r_losses, r_grads, r_params = runs[ref]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        grad_err = max(scaled_err(grads[p], g) for p, g in r_grads.items())
        diffs = torch.cat([(params[p] - t).abs().flatten() for p, t in r_params.items()])
        param_max = diffs.max().item()
        param_q999 = torch.quantile(diffs.double()[:: max(1, diffs.numel() // 2**24)],
                                    0.999).item()
        log(f"training parity vs {ref}: loss rel err {loss_err:.3e} (tol {LOSS_RTOL}), "
            f"first-step grad scaled err {grad_err:.3e} (tol {GRAD_ATOL}), params "
            f"max {param_max:.3e} (tol {2 * LEARNING_RATE * PARITY_STEPS}) "
            f"q99.9 {param_q999:.3e} (tol {PARAM_Q999_ATOL})")
        check(loss_err <= LOSS_RTOL and grad_err <= GRAD_ATOL
              and param_max <= 2 * LEARNING_RATE * PARITY_STEPS
              and param_q999 <= PARAM_Q999_ATOL,
              f"training on the card disagrees with the {ref} run")
        report[ref] = dict(loss_rel_err=loss_err, grad_scaled_err=grad_err,
                           param_max_abs_diff=param_max, param_q999_abs_diff=param_q999)
    return report


def _cosine(a: dict, b: dict) -> float:
    """Cosine of two gradient trees, flattened in one order."""
    x = torch.cat([a[p].double().flatten().cpu() for p in sorted(b)])
    y = torch.cat([b[p].double().flatten().cpu() for p in sorted(b)])
    return torch.nn.functional.cosine_similarity(x, y, dim=0).item()


def phase_speed_forward(dev) -> dict:
    """One xl forward in speed mode through ``apply_hypergnn`` (the JAX
    wrapper takes no compute_dtype, nor does the port's), against the f32
    forward, its launches by form and its device time."""
    feats_np, graph = xl_graph(WIDTH)
    init = init_hypergnn(train_config(), torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(dev), init)
    feats = torch.as_tensor(feats_np, device=dev)
    arrays = [torch.as_tensor(a, device=dev) for a in graph.arrays]
    plan = graph.sort_plan.to(dev)

    def forward(mode):
        with torch.inference_mode():
            return apply_hypergnn(train_config(**mode), params, feats, *arrays,
                                  sort_plan=plan)

    with profiling.tally() as counts:
        embs = forward(SPEED)
        torch.cuda.synchronize()
    by_form = kernel_launches_per_form(counts)
    ref = forward({})
    rel_err = ((embs - ref).abs().max() / ref.abs().max()).item()
    log(f"speed-mode xl forward: vs f32 rel err {rel_err:.3e} (tol {SPEED_VS_F32_RTOL}) "
        f"| launches by form {by_form}")
    check(embs.dtype == torch.float32 and embs.shape == (XL_N, WIDTH)
          and bool(torch.isfinite(embs).all()), "speed-mode forward: not finite f32")
    check(rel_err < SPEED_VS_F32_RTOL, "speed-mode forward: too far from f32")
    want = {name: dict.fromkeys(forms_of(name), 0) for name in KERNELS}
    want["csr_segment_sum"]["bf16"] = want["edge_transform_sorted_combined"]["bf16"] = LAYERS
    want["gather_rows"]["v16"] = FORWARD_LAUNCHES["gather_rows"]
    check(by_form == want, f"speed-mode forward launches {by_form} != {want}")
    profile = profile_device("one more speed-mode xl forward", lambda: forward(SPEED))
    ref_profile = profile_device("one f32 xl forward", lambda: forward({}))
    return dict(rel_err_vs_f32=rel_err, launches_per_form=by_form, profile=profile,
                f32_profile=ref_profile)


def phase_speed_parity(dev) -> dict:
    """Speed mode at the bench size on the card: per-layer embeddings and
    gradients of ``Σ out · R`` on the ``cuda`` backend against the
    ``gather`` oracle in speed mode and against the f32 run; then
    PARITY_STEPS training steps of each with the same roll shifts, and one
    step with precision="default" against the f32 step."""
    feats_np, graph = bench_graph()
    init = init_hypergnn(train_config(), torch.Generator().manual_seed(0))
    report = {}
    model = {label: _model_run(train_config(backend, **mode), _scale_one(
                 tree_map(torch.clone, init)), feats_np, graph, dev)()
             for label, backend, mode in (("speed", "cuda", SPEED),
                                          ("speed gather", "gather", SPEED),
                                          ("f32", "cuda", {}))}
    (layers, grads) = model["speed"]
    for ref, atol, cos_min in (("speed gather", SPEED_ATOL, SPEED_COS_ORACLE),
                               ("f32", SPEED_VS_F32_RTOL, SPEED_COS_F32)):
        ref_layers, ref_grads = model[ref]
        if ref == "f32":  # relative to the largest value, as the JAX test
            err = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(layers, ref_layers))
        else:
            err = max(scaled_err(a, b) for a, b in zip(layers, ref_layers))
        cos = _cosine(grads, ref_grads)
        log(f"speed mode (bench, cuda) vs {ref}: per-layer err {err:.3e} (tol {atol}), "
            f"gradient cosine {cos:.6f} (min {cos_min})")
        check(err < atol and cos > cos_min, f"speed mode disagrees with the {ref} run")
        report[f"model_vs_{ref}"] = dict(err=err, grad_cosine=cos)

    shifts = np.random.default_rng(2).integers(1, graph.src.shape[0], PARITY_STEPS)
    steps = {}
    for label, backend, mode, n_steps in (
        ("speed", "cuda", SPEED, PARITY_STEPS), ("speed gather", "gather", SPEED, PARITY_STEPS),
        ("f32", "cuda", {}, PARITY_STEPS), ("one pass", "cuda", ONE_PASS, 1),
    ):
        run, params = _trainer(graph, feats_np, init, backend, dev, mode=mode)
        losses = [run(int(shift)).item() for shift in shifts[:1]]
        grads = _leaves(params, grads=True)
        losses += [run(int(shift)).item() for shift in shifts[1:n_steps]]
        steps[label] = (losses, grads)
    for label, ref, rtol, cos_min in (
        ("speed", "speed gather", SPEED_ATOL, SPEED_COS_ORACLE),
        ("speed", "f32", SPEED_VS_F32_RTOL, SPEED_COS_F32),
        ("one pass", "f32", SPEED_VS_F32_RTOL, SPEED_COS_F32),
    ):
        (losses, grads), (r_losses, r_grads) = steps[label], steps[ref]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        cos = _cosine(grads, r_grads)
        log(f"training {label} vs {ref} (bench, {len(losses)} steps): losses {losses}, "
            f"loss rel err {loss_err:.3e} (tol {rtol}), first-step gradient cosine "
            f"{cos:.6f} (min {cos_min})")
        check(all(np.isfinite(losses)) and loss_err < rtol and cos > cos_min,
              f"training {label} disagrees with {ref}")
        report[f"training_{label}_vs_{ref}"] = dict(
            losses=losses, loss_rel_err=loss_err, grad_cosine=cos)
    return report


def phase_two_stream(dev, g, d: int) -> dict:
    """One xl layer at width ``d`` through the two-stream path (kernels 5,
    6 and 1) against the ``cuda`` backend (kernels 2, 3 and 1), forward and
    backward of ``Σ out · R``: in f32, in speed mode (bf16 ``h``, banks and
    bias, against the ``cuda`` backend in speed mode) and with
    precision="default" (against the f32 layer). Keyed by form."""
    plan = g.sort_plan.to(dev)
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
    u_pad = g.char_ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(d)
    init = [
        torch.randn(XL_N, d, device=dev, generator=gen),
        torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5,
        torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5,
        torch.randn(u_pad, d, device=dev, generator=gen),
    ]
    r = torch.randn(XL_N, d, device=dev, generator=gen)

    def two_stream(mode):
        def layer(h, wm, ws, b):
            if mode.get("compute_dtype") == "bfloat16":
                # Speed mode is the caller's on this path, as in JAX: the
                # cast the cuda backend's compute_dtype does inside.
                h, wm, ws, b = (t.bfloat16() for t in (h, wm, ws, b))
            msg, selfc = kernels.edge_contributions_cuda_sorted(
                h, src, dst, rel, wm, ws, b, sort_plan=plan,
                precision=mode.get("precision", "highest"))
            return two_stream_tail(msg, selfc, dst, XL_N, edge_mask=mask, sort_plan=plan)
        return layer

    def combined(mode):
        def layer(h, wm, ws, b):
            return relational_message_passing(
                h, src, dst, rel, wm, ws, b, edge_mask=mask, backend="cuda",
                rel_sorted=True, group_padded=True, sort_plan=plan, **mode)
        return layer

    def fwd_bwd(layer):
        leaves = [t.clone().requires_grad_(True) for t in init]
        out = layer(*leaves)
        (out * r).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    report, f32_ref = {}, None
    for form, mode in (("f32", {}), ("bf16", SPEED), ("tf32", ONE_PASS)):
        with profiling.tally() as counts:
            out, grads = fwd_bwd(two_stream(mode))
            torch.cuda.synchronize()
        launches, by_form = kernel_launches(counts), kernel_launches_per_form(counts)
        check(counts.get("kernel.run_table", 0) == 0,
              f"two-stream layer d={d} [{form}]: the SortPlan's run tables were not "
              "handed down to kernel 6")
        ref, ref_grads = fwd_bwd(combined(mode))
        if form == "f32":
            f32_ref = (ref, ref_grads)
        ms = cuda_ms(lambda: fwd_bwd(two_stream(mode)), iters=5, warmup=1)
        ref_ms = cuda_ms(lambda: fwd_bwd(combined(mode)), iters=5, warmup=1)
        if form == "bf16":
            # Against the cuda backend in speed mode: the oracle gates.
            err, tol = scaled_err(out, ref), SPEED_ATOL
            cos = _cosine(dict(enumerate(grads)), dict(enumerate(ref_grads)))
            ok, gate = err <= tol and cos > SPEED_COS_ORACLE, (
                f"scaled err {err:.3e} (tol {tol}), gradient cosine {cos:.6f} "
                f"(min {SPEED_COS_ORACLE}) against the cuda backend in speed mode")
            numbers = dict(scaled_err=err, grad_cosine=cos)
        else:
            # f32: both sum in 3xTF32 on the tensor cores, kernels 2 and 3
            # over K = 2 d_in and runs, kernels 5 and 6 per bank: they agree
            # within the f32 gate, not bit for bit. One pass: against the f32
            # layer, bf16-class.
            ref, ref_grads = f32_ref
            err = (out - ref).abs().max().item()
            grad_err = max(scaled_err(a, b) for a, b in zip(grads, ref_grads))
            if form == "f32":
                tol, grad_tol = SERVING_ATOL, GRAD_ATOL
                ok = err <= tol and grad_err <= grad_tol
            else:
                err = scaled_err(out, ref)
                tol = grad_tol = ONE_PASS_SCALED
                ok = err <= tol and grad_err <= grad_tol
            gate = (f"max err {err:.3e}, scaled grad err {grad_err:.3e} (tol {tol} / "
                    f"{grad_tol}) against the {'f32 ' if form == 'tf32' else ''}cuda backend")
            numbers = dict(max_abs_err=err, grad_scaled_err=grad_err)
        log(f"two-stream layer d={d} [{form}]: {gate} | fwd+bwd {ms:.3f} ms, cuda "
            f"backend {ref_ms:.3f} ms | launches by form {nonzero(by_form)}")
        profile = profile_device(f"one more xl two-stream layer d={d} [{form}]",
                                 lambda: fwd_bwd(two_stream(mode)), rows=8)
        check(ok, f"two-stream layer d={d} [{form}] disagrees with the cuda backend")
        want = two_stream_launches_per_form(form)
        check(by_form == want, f"two-stream layer d={d} [{form}] launches by form "
              f"{nonzero(by_form)} != {nonzero(want)}")
        if form == "f32":
            check(launches == TWO_STREAM_LAUNCHES,
                  f"two-stream layer d={d} launch counts {launches} != {TWO_STREAM_LAUNCHES}")
        report[form] = dict(numbers, ms=ms, cuda_backend_ms=ref_ms, launches=launches,
                            launches_per_form=by_form, profile=profile)
        del out, grads, ref, ref_grads
    return report


def _scale_one(params) -> dict:
    """The parameter tree with the generated weights at scale 1 instead of
    the 0.01 init, so message passing moves the output well beyond the
    residual (as the parity tests set them)."""
    for wg in params["weight_generators"]:
        wg["log_scales"] = {k: torch.zeros_like(v) for k, v in wg["log_scales"].items()}
    return params


def _model_run(config, init, feats, graph, device):
    """``run() -> (per-layer outputs, {path: grad})`` of ``Σ out · R`` for
    the model on ``device``, R drawn from a seeded generator."""
    feats = torch.as_tensor(feats, device=device)
    arrays = [torch.as_tensor(a, device=device) for a in graph.arrays]
    plan = None if graph.sort_plan is None else graph.sort_plan.to(device)
    r = torch.randn(feats.shape[0], config.hidden_dim,
                    generator=torch.Generator().manual_seed(7)).to(device)

    def run():
        params = tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), init)
        layers = apply_hypergnn(config, params, feats, *arrays,
                                return_all_layers=True, sort_plan=plan)
        (layers[-1] * r).sum().backward()
        return ([h.detach() for h in layers],
                {path: t.grad for path, t in named_leaves(params)})

    return run


def _compare_runs(label, got, want) -> tuple[float, float]:
    (layers, grads), (ref_layers, ref_grads) = got, want
    err = max((a.cpu() - b.cpu()).abs().max().item() for a, b in zip(layers, ref_layers))
    grad_err = max(scaled_err(grads[p].cpu(), g.cpu()) for p, g in ref_grads.items())
    log(f"{label}: per-layer max_abs_err {err:.3e} (tol {SERVING_ATOL}), "
        f"parameter grad scaled err {grad_err:.3e} (tol {GRAD_ATOL})")
    check(err <= SERVING_ATOL and grad_err <= GRAD_ATOL, f"{label}: disagree")
    return err, grad_err


def _host_ms(fn, timed: int) -> float:
    """Host milliseconds per ``fn()`` over ``timed`` runs after one warm-up,
    each ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / timed * 1e3


def phase_grouped(dev) -> dict:
    """The xl model on the relation-sorted layout with a sort plan and no
    group padding, where ``auto`` picks ``grouped``, against the ``cuda``
    backend on the group-padded layout of the same graph."""
    feats, ei, etexts, _ = xl_edges()
    sorted_graph = encode_graph(ei, etexts, XL_N, sort_by_relation=True,
                                with_sort_plan=True)
    padded_graph = encode(ei, etexts)
    cfg = HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=WIDTH, hidden_dim=WIDTH,
                         num_layers=LAYERS, backend="auto", rel_sorted=True)
    picked = resolve_backend(
        "auto", XL_N, sorted_graph.char_ids.shape[0], sorted_graph.src.shape[0],
        WIDTH, rel_sorted=True, group_padded=False, has_sort_plan=True)
    check(picked == "grouped", f"grouped: auto picked {picked!r}, not 'grouped'")
    init = _scale_one(init_hypergnn(cfg, torch.Generator().manual_seed(0)))
    grouped = _model_run(cfg, init, feats, sorted_graph, dev)
    padded = _model_run(train_config(), init, feats, padded_graph, dev)

    with profiling.tally() as counts:
        got = grouped()
        torch.cuda.synchronize()
    launches = kernel_launches(counts)
    err, grad_err = _compare_runs("grouped xl vs the cuda backend", got, padded())
    check(launches == GROUPED_LAUNCHES,
          f"grouped launch counts {launches} != {GROUPED_LAUNCHES}")
    ms = _host_ms(grouped, GROUPED_TIMED)
    cuda_backend_ms = _host_ms(padded, GROUPED_TIMED)
    log(f"grouped xl: {ms:.3f} ms per forward + backward ({sorted_graph.src.shape[0]:,} "
        f"rows), cuda backend on the padded layout {cuda_backend_ms:.3f} ms "
        f"({padded_graph.src.shape[0]:,} rows) | launches {launches}")
    profile = profile_device("one more grouped xl forward + backward", grouped)
    busy = profile["device_ms"] / ms
    log(f"grouped xl: device busy {100 * busy:.1f}% of a forward + backward")
    return dict(ms=ms, cuda_backend_ms=cuda_backend_ms, max_abs_err=err,
                grad_scaled_err=grad_err, launches=launches,
                device_busy_share=busy, profile=profile)


def phase_dense_chunked(dev) -> dict:
    """The bench config in the stored edge order (no sort, no plan) through
    ``dense`` and ``chunked``, against the card's ``gather`` oracle and the
    same backend on the CPU."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((BENCH_N, WIDTH)).astype(np.float32)
    ei = np.stack([rng.integers(0, BENCH_N, BENCH_E),
                   rng.integers(0, BENCH_N, BENCH_E)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(BENCH_U)]
    etexts = [texts[i] for i in rng.integers(0, BENCH_U, BENCH_E)]
    graph = encode_graph(ei, etexts, BENCH_N)

    def config(backend):
        return HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=WIDTH,
                              hidden_dim=WIDTH, num_layers=LAYERS, backend=backend)

    init = _scale_one(init_hypergnn(config("gather"), torch.Generator().manual_seed(0)))
    oracle = _model_run(config("gather"), init, feats, graph, dev)()
    report = {}
    for backend in ("dense", "chunked"):
        got = _model_run(config(backend), init, feats, graph, dev)()
        on_cpu = _model_run(config(backend), init, feats, graph, torch.device("cpu"))()
        report[backend] = dict(
            vs_gather=_compare_runs(f"{backend} bench vs the gather oracle", got, oracle),
            vs_cpu=_compare_runs(f"{backend} bench card vs cpu", got, on_cpu),
        )
    return report


# ---------------------------------------------------------------------------
# Link-prediction training, filtered evaluation, checkpoint and resume
# ---------------------------------------------------------------------------


def linkpred_config() -> HyperGNNConfig:
    """BASELINE.json configs #2 and #3 at text_dim 64, F = H = 64, 2 layers,
    on the kernel layout (kernels 1-3 carry the steps)."""
    return HyperGNNConfig(
        text_dim=TEXT_DIM, node_feat_dim=WIDTH, hidden_dim=WIDTH, num_layers=LAYERS,
        backend="cuda", rel_sorted=True, group_padded=True,
    )


def _kernel_layout(kg, split: str | None = None):
    """``kg``'s edges (or one split's) on the kernel layout, with a plan."""
    ei, texts = kg.split_edges(split) if split else (kg.edge_index, kg.edge_texts)
    return encode_graph(ei, texts, kg.num_nodes, sort_by_relation=True,
                        with_sort_plan=True, group_pad=256)


def _on(dev, graph):
    return ([torch.as_tensor(a, device=dev) for a in graph.arrays],
            graph.sort_plan.to(dev))


def _linkpred_steps(state, feats, arrays, plan, steps, logger=None, timer=None):
    """Train steps ``steps`` (step i draws from a generator seeded 1000 + i,
    as the JAX package keys each step), Adam in place; the losses."""
    step_fn = make_train_step(linkpred_config())
    timer = timer or PhaseTimer()
    losses = []
    for i in steps:
        t0 = time.perf_counter()
        with timer.phase("train step") as slot:
            gen = torch.Generator(device=feats.device).manual_seed(1000 + i)
            slot["out"] = step_fn(state.params, state.opt_state, feats, *arrays, gen,
                                  sort_plan=plan)[2]
        state.step = i + 1
        losses.append(slot["out"].item())
        if logger is not None:
            logger.log(i + 1, loss=losses[-1], step_ms=(time.perf_counter() - t0) * 1e3)
    return losses


def rank_check(embs, src, dst, filter_edges, metrics: dict, label: str) -> dict:
    """The evaluator's metrics against ranks computed here, apart from its
    code, at every pair: a dense ``[N, N]`` filter of the known edges (one
    ``index_put_``), and per pair the candidates that are neither filtered
    nor the target counted better or tied. The f32 scores are the
    evaluator's product, chunk for chunk, so MRR and Hits@K must agree
    exactly. Then float64: each f32 score must lie within the f32 bound of a
    d-term dot product, gamma_d * sum|a_i b_i|, of its float64 value, and a
    pair whose f32 and float64 ranks differ must hold a candidate whose
    float64 gap to the target lies within the two scores' bounds (the pairs
    that f32 cannot rank for certain, counted)."""
    n, d = embs.shape
    dev = embs.device
    # f32's bound, and float64's own (for the reference's rounding).
    gamma = sum(d * unit / (1 - d * unit) for unit in (2.0**-24, 2.0**-53))
    known = torch.zeros(n, n, dtype=torch.bool, device=dev)
    fe = torch.as_tensor(np.asarray(filter_edges), device=dev)
    known[fe[0], fe[1]] = True
    e64 = embs.double()
    a64 = e64.abs()
    ranks32, differ, unrankable, scores_out, ranks_out, worst = [], 0, 0, 0, 0, 0.0
    for lo in range(0, len(src), EVAL_CHUNK):
        s = torch.as_tensor(src[lo:lo + EVAL_CHUNK], device=dev)
        t = torch.as_tensor(dst[lo:lo + EVAL_CHUNK], device=dev)
        rows = torch.arange(len(s), device=dev)
        counted = ~known[s]
        counted[rows, t] = False

        def ranks(scores):
            target = scores[rows, t][:, None]
            better = ((scores > target) & counted).sum(1)
            ties = ((scores == target) & counted).sum(1)
            return 1.0 + better.double() + 0.5 * ties.double()

        s32 = embs[s] @ embs.T
        s64 = e64[s] @ e64.T
        bound = gamma * (a64[s] @ a64.T)
        err = (s32.double() - s64).abs()
        scores_out += int((err > bound).sum())
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
        r32, r64 = ranks(s32), ranks(s64)
        gap = (s64 - s64[rows, t][:, None]).abs()
        near = ((gap <= bound + bound[rows, t][:, None]) & counted).any(1)
        unrankable += int(near.sum())
        differ += int((r32 != r64).sum())
        ranks_out += int(((r32 != r64) & ~near).sum())
        ranks32.append(r32.cpu().numpy())
    ranks = np.concatenate(ranks32)
    mine = {"mrr": float(np.mean(1.0 / ranks))}
    for k in (1, 3, 10):
        mine[f"hits@{k}"] = float(np.mean(ranks <= k))
    log(f"linkpred {label}: metrics of ranks computed apart from the evaluator "
        f"{'equal' if mine == metrics else 'DIFFER: ' + str(mine)} over all {len(src)} "
        f"pairs; f32 scores within the f32 dot-product bound of float64 (worst "
        f"{worst:.3f} of it); f32 and float64 ranks differ at {differ} pairs, "
        f"{unrankable} pairs ({100 * unrankable / len(src):.2f}%) hold a candidate "
        f"within the bounds of the target; outside the bounds: {scores_out} scores, "
        f"{ranks_out} ranks")
    check(mine == metrics, f"linkpred {label}: evaluator {metrics} != ranks here {mine}")
    check(scores_out == 0 and ranks_out == 0,
          f"linkpred {label}: {scores_out} scores, {ranks_out} ranks outside f32's bound")
    return dict(pairs=len(src), f32_f64_ranks_differ=differ, unrankable_pairs=unrankable,
                worst_score_err_over_bound=worst, scores_outside_bound=scores_out,
                ranks_outside_bound=ranks_out)


def _evaluate(dev, config, params, kg, feats, pairs, label) -> dict:
    """Embeddings over all of ``kg``'s edges (the transductive protocol of
    experiments/train_linkpred.py), held against the card's ``gather``
    oracle, then filtered MRR and Hits@1/3/10 of ``pairs`` against every
    node, all edges as the filter."""
    full = _kernel_layout(kg)
    arrays, plan = _on(dev, full)
    with profiling.tally() as counts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            embs = apply_hypergnn(config, params, feats, *arrays, sort_plan=plan)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = evaluate_link_prediction(embs, pairs[0], pairs[1], filter_edges=kg.edge_index,
                                           chunk_size=EVAL_CHUNK)
        t2 = time.perf_counter()
    launches = kernel_launches(counts)
    check(launches == FORWARD_LAUNCHES,
          f"linkpred {label} forward launches {launches} != {FORWARD_LAUNCHES}")
    check(embs.shape == (kg.num_nodes, WIDTH) and bool(torch.isfinite(embs).all()),
          f"linkpred {label}: embeddings not finite or of wrong shape")
    with torch.no_grad():
        oracle = apply_hypergnn(gather_config(config), params, feats, *arrays)
    oracle_err = (embs - oracle).abs().max().item()
    log(f"linkpred {label}: embeddings over {full.src.shape[0]:,} rows vs the gather "
        f"oracle max_abs_err {oracle_err:.3e} (tol {SERVING_ATOL})")
    check(oracle_err <= SERVING_ATOL, f"linkpred {label}: embeddings disagree with gather")
    check(all(0.0 <= v <= 1.0 for v in metrics.values()),
          f"linkpred {label}: a metric outside [0, 1]: {metrics}")
    ranks = rank_check(embs, pairs[0], pairs[1], kg.edge_index, metrics, label)
    log(f"linkpred {label}: " + " ".join(f"{k}={v:.6f}" for k, v in metrics.items())
        + f" over {len(pairs[0])} pairs x {kg.num_nodes} candidates; forward "
        f"{(t1 - t0) * 1e3:.2f} ms, ranking {(t2 - t1) * 1e3:.2f} ms")
    return dict(metrics, pairs=len(pairs[0]), forward_ms=(t1 - t0) * 1e3,
                ranking_ms=(t2 - t1) * 1e3, rank_check=ranks, forward_launches=launches,
                vs_gather_max_abs_err=oracle_err)


def gather_config(config: HyperGNNConfig) -> HyperGNNConfig:
    return dataclasses.replace(config, backend="gather")


def plain_link_prediction_loss(embs, src, dst, neg_dst, margin=1.0, edge_mask=None):
    """The uniform loss with plain gathers, whose backward is PyTorch's
    index backward: the ``gather`` oracle's, apart from the port's sorted
    backward."""
    return margin_ranking_loss(score_pairs(embs[src], embs[dst]),
                               score_pairs(embs[src], embs[neg_dst]), margin, edge_mask)


def layout_vs_references(dev, init, feats, graph, label: str) -> dict:
    """Kernels 1-3 on this dataset's train layout (its hub segments and
    relation runs) against references on the same inputs: the model with its
    generated weights at scale one (per-layer outputs, gradients of
    ``sum(out * R)``) against a float64 run of the ``dense`` backend on the
    host (the kernels take no float64), and the first training step from
    ``init`` against the card's ``gather`` oracle with the same negatives
    (loss, per-leaf gradients; the oracle's loss is the plain one, whose
    backward PyTorch's index backward sums, against the sorted one). At
    scale one the oracle itself is no reference for the weight gradients:
    on an H100 its f32 sums over WN18RR-like's ~6k-row relations came
    2.9e-5 scaled from float64, the kernels' 1.0e-6."""
    config = linkpred_config()
    scaled = _scale_one(tree_map(lambda t: t.clone(), init))
    exact = _model_run(dataclasses.replace(config, backend="dense"),
                       tree_map(lambda t: t.double(), scaled), feats.double().cpu(), graph,
                       torch.device("cpu"))()
    model_err, model_grad_err = _compare_runs(
        f"linkpred {label} model at scale one, cuda vs float64 (dense, host)",
        _model_run(config, scaled, feats, graph, dev)(), exact)
    arrays, plan = _on(dev, graph)
    runs = {}
    for cfg in (config, gather_config(config)):
        state = create_train_state(tree_map(lambda t: t.to(dev), init), adam(LEARNING_RATE))
        gen = torch.Generator(device=dev).manual_seed(1000)
        # The gather oracle's loss is plain_link_prediction_loss.
        loss_fn = link_prediction_loss if cfg is config else plain_link_prediction_loss
        with mock.patch.object(train_module, "link_prediction_loss", loss_fn):
            loss = make_train_step(cfg)(state.params, state.opt_state, feats, *arrays, gen,
                                        sort_plan=plan)[2]
        runs[cfg.backend] = (loss.item(), _leaves(state.params, grads=True))
    (loss, grads), (r_loss, r_grads) = runs["cuda"], runs["gather"]
    loss_err = abs(loss - r_loss)
    grad_err = max(scaled_err(grads[p], g) for p, g in r_grads.items())
    log(f"linkpred {label} first step, cuda vs gather: loss {loss:.6f} err {loss_err:.3e} "
        f"(tol {SERVING_ATOL}), per-leaf grad scaled err {grad_err:.3e} (tol {GRAD_ATOL})")
    check(loss_err <= SERVING_ATOL and grad_err <= GRAD_ATOL,
          f"linkpred {label}: the first step disagrees with the gather oracle")
    return dict(model_vs_f64_max_abs_err=model_err, model_vs_f64_grad_scaled_err=model_grad_err,
                step_vs_gather_loss_err=loss_err, step_vs_gather_grad_scaled_err=grad_err)


def phase_linkpred(dev) -> dict:
    """FB15k-237-like (BASELINE.json #2): 20 steps on the train split with a
    MetricsLogger and a PhaseTimer, an async checkpoint at step 10, filtered
    evaluation of the test split, and a restore at step 10 that must retrace
    steps 10-20 bitwise; then WN18RR-like with 27% of the relations held out
    (#3): 20 steps and the zero-shot MRR of the held-out relations."""
    config = linkpred_config()
    kg = fb15k237_like(seed=0, scale=LINKPRED_SCALE)
    t0 = time.perf_counter()
    train_graph = _kernel_layout(kg, "train")
    encode_ms = (time.perf_counter() - t0) * 1e3
    feats = torch.as_tensor(kg.node_features, device=dev)
    arrays, plan = _on(dev, train_graph)
    init = init_hypergnn(config, torch.Generator().manual_seed(0))
    log(f"linkpred fb15k237-like: N={kg.num_nodes} E={kg.num_edges} "
        f"U={len(kg.relation_texts)} train {train_graph.num_edges} edges "
        f"({train_graph.src.shape[0]} rows) encoded in {encode_ms:.1f} ms")
    references = layout_vs_references(dev, init, feats, train_graph, "fb15k237-like")

    def fresh():
        return create_train_state(tree_map(lambda t: t.to(dev), init), adam(LEARNING_RATE))

    with tempfile.TemporaryDirectory(prefix="ghf_ckpt_") as ckpt_dir:
        state, logger, timer = fresh(), MetricsLogger(), PhaseTimer()
        with profiling.tally() as counts:
            losses = _linkpred_steps(state, feats, arrays, plan, range(LINKPRED_RESUME_AT),
                                     logger, timer)
            t0 = time.perf_counter()
            path = save_checkpoint(ckpt_dir, state.params, state.opt_state, step=state.step)
            save_return_ms = (time.perf_counter() - t0) * 1e3
            losses += _linkpred_steps(state, feats, arrays, plan,
                                      range(LINKPRED_RESUME_AT, LINKPRED_STEPS), logger, timer)
        launches = kernel_launches(counts)
        want = {k: v * LINKPRED_STEPS for k, v in LINKPRED_STEP_LAUNCHES.items()}
        check(launches == want, f"linkpred launches {launches} != {want}")
        check(all(np.isfinite(losses)), "linkpred: a loss is not finite")
        step_ms = [h["step_ms"] for h in logger.history.history]
        log(f"linkpred fb15k237-like: losses {['%.5f' % v for v in losses]}")
        log(f"linkpred fb15k237-like: {timer.totals['train step'] / LINKPRED_STEPS * 1e3:.3f} "
            f"ms/step (PhaseTimer, {LINKPRED_STEPS} steps; median {np.median(step_ms):.3f}, "
            f"first {step_ms[0]:.3f}); launches over the steps {launches}")
        want_params = _leaves(state.params, grads=False)
        want_moments = {f"{i}.{k}": v.cpu().clone() for i, s in
                        enumerate(state.opt_state.state.values()) for k, v in s.items()}

        t0 = time.perf_counter()
        save_checkpoint(ckpt_dir, state.params, state.opt_state, step=state.step)
        t1 = time.perf_counter()
        wait_for_checkpoints()
        t2 = time.perf_counter()
        ckpt = dict(save_return_ms_overlapped=save_return_ms,
                    save_return_ms=(t1 - t0) * 1e3, save_commit_ms=(t2 - t0) * 1e3)

        # The fault: a fresh process state restored from step 10 retraces
        # steps 10-20; kernels 1, 3 and 6 are bitwise deterministic, so the
        # parameters and moments must equal the uninterrupted run's bitwise.
        resumed = fresh()
        t0 = time.perf_counter()
        restored = restore_checkpoint(path, resumed.params, resumed.opt_state)
        ckpt["restore_ms"] = (time.perf_counter() - t0) * 1e3
        resumed.step = restored["step"]
        check(resumed.step == LINKPRED_RESUME_AT, f"linkpred: restored step {resumed.step}")
        resumed_losses = _linkpred_steps(resumed, feats, arrays, plan,
                                         range(LINKPRED_RESUME_AT, LINKPRED_STEPS))
    got_params = _leaves(resumed.params, grads=False)
    got_moments = {f"{i}.{k}": v.cpu() for i, s in
                   enumerate(resumed.opt_state.state.values()) for k, v in s.items()}
    differ = [p for p in want_params if not torch.equal(got_params[p], want_params[p])]
    differ += [m for m in want_moments if not torch.equal(got_moments[m], want_moments[m])]
    same_losses = resumed_losses == losses[LINKPRED_RESUME_AT:]
    log(f"linkpred resume at step {LINKPRED_RESUME_AT}: losses equal {same_losses}, "
        f"{len(differ)} of {len(want_params) + len(want_moments)} parameter and moment "
        f"tensors differ bitwise from the uninterrupted run")
    check(same_losses and not differ, f"linkpred: the resumed run differs: {differ[:5]}")
    step_fn = make_train_step(config)
    profile = profile_device(
        "one more fb15k237-like step",
        lambda: step_fn(resumed.params, resumed.opt_state, feats, *arrays,
                        torch.Generator(device=dev).manual_seed(0), sort_plan=plan))
    log("linkpred checkpoint: save returned in {save_return_ms_overlapped:.2f} ms at step "
        "10 (written while training went on); at step 20 returned in {save_return_ms:.2f} "
        "ms, committed in {save_commit_ms:.2f} ms; restore {restore_ms:.2f} ms".format(**ckpt))

    test_ei, _ = kg.split_edges("test")
    evaluation = _evaluate(dev, config, state.params, kg, feats, test_ei, "fb15k237-like test")
    train_ms = timer.totals["train step"] * 1e3
    run_ms = train_ms + evaluation["forward_ms"] + evaluation["ranking_ms"] + \
        ckpt["save_return_ms_overlapped"]
    shares = dict(train=train_ms / run_ms,
                  evaluation=(evaluation["forward_ms"] + evaluation["ranking_ms"]) / run_ms,
                  checkpoint=ckpt["save_return_ms_overlapped"] / run_ms)
    log(f"linkpred run of {run_ms:.1f} ms: " + ", ".join(
        f"{k} {100 * v:.2f}%" for k, v in shares.items()))

    # WN18RR-like, 27% of the relation types held out of training.
    kg2 = wn18rr_zero_shot_like(seed=0, scale=LINKPRED_SCALE)
    feats2 = torch.as_tensor(kg2.node_features, device=dev)
    train2 = _kernel_layout(kg2, "train")
    arrays2, plan2 = _on(dev, train2)
    references2 = layout_vs_references(dev, init, feats2, train2, "wn18rr-zero-shot-like")
    state2 = create_train_state(tree_map(lambda t: t.to(dev), init), adam(LEARNING_RATE))
    timer2 = PhaseTimer()
    losses2 = _linkpred_steps(state2, feats2, arrays2, plan2, range(LINKPRED_STEPS),
                              timer=timer2)
    check(all(np.isfinite(losses2)), "linkpred wn18rr: a loss is not finite")
    test2, test2_texts = kg2.split_edges("test")
    held_out = {kg2.relation_texts[r] for r in kg2.zero_shot_relations}
    zs = np.asarray([t in held_out for t in test2_texts])
    check(zs.any() and not (set(train2.unique_texts) & held_out),
          "linkpred wn18rr: held-out relations missing from test or present in train")
    log(f"linkpred wn18rr-zero-shot-like: N={kg2.num_nodes} E={kg2.num_edges} "
        f"U={len(kg2.relation_texts)}, held out {sorted(kg2.zero_shot_relations)}; "
        f"{timer2.totals['train step'] / LINKPRED_STEPS * 1e3:.3f} ms/step, losses "
        f"{losses2[0]:.5f} -> {losses2[-1]:.5f}")
    zero_shot = _evaluate(dev, config, state2.params, kg2, feats2, test2[:, zs],
                          "wn18rr zero-shot test")
    return dict(
        fb15k237=dict(losses=losses, ms_per_step=train_ms / LINKPRED_STEPS,
                      step_ms=step_ms, launches=launches, checkpoint=ckpt,
                      resume_bitwise=same_losses and not differ, evaluation=evaluation,
                      run_shares=shares, profile=profile, references=references),
        wn18rr_zero_shot=dict(losses=losses2,
                              ms_per_step=timer2.totals["train step"] / LINKPRED_STEPS * 1e3,
                              held_out=list(kg2.zero_shot_relations),
                              evaluation=zero_shot, references=references2),
    )


# ---------------------------------------------------------------------------
# Neighbor-sampled minibatch training
# ---------------------------------------------------------------------------


def mb_graph(n: int, e: int, u: int, seed: int = 0):
    """The graph of benchmarks/minibatch_xxl.py:45-60, drawn as it draws it:
    edges, texts, then features."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]).astype(np.int64)
    texts = [f"relation type number {i} with descriptive text" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    feats = rng.standard_normal((n, WIDTH)).astype(np.float32)
    return ei, etexts, feats


def mb_config() -> HyperGNNConfig:
    return HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=WIDTH, hidden_dim=WIDTH,
                          num_layers=LAYERS)


def _mb_backend(config, batch) -> str:
    feats, graph = batch[0], batch[1]
    return resolve_backend(config.backend, feats.shape[0], graph.char_ids.shape[0],
                           graph.src.shape[0], config.hidden_dim, rel_sorted=False,
                           group_padded=False, has_sort_plan=False)


def phase_minibatch_parity(dev) -> dict:
    """At the bench size (N=1k, E=10k, U=50), one minibatch step on the card
    against the same step on the CPU: the same sampled batch, negatives and
    initial weights; loss, gradients and updated parameters within the f32
    gate (gradients after dividing by max(1, max|ref|))."""
    ei, etexts, feats = mb_graph(BENCH_N, BENCH_E, BENCH_U)
    config, spec = mb_config(), MinibatchSpec(**MB_SPEC)
    init = init_hypergnn(config, torch.Generator().manual_seed(0))
    runs = {}
    batch = None
    for label, device in (("card", dev), ("cpu", torch.device("cpu"))):
        trainer = MinibatchTrainer(config, adam(LEARNING_RATE), ei, etexts, feats, spec,
                                   device=device)
        batch = batch or trainer.sample_batch(np.random.default_rng(3))
        neg = np.random.default_rng(4).integers(0, batch[0].shape[0], spec.batch_size)
        state = create_train_state(tree_map(lambda t: t.to(device), init),
                                   adam(LEARNING_RATE))
        _, _, loss = trainer.device_step(
            state.params, state.opt_state, trainer.to_device(batch),
            neg_dst=torch.as_tensor(neg.astype(np.int32), device=device))
        runs[label] = (loss.item(), _leaves(state.params, grads=True),
                       _leaves(state.params, grads=False))
    (loss, grads, params), (r_loss, r_grads, r_params) = runs["card"], runs["cpu"]
    loss_err = abs(loss - r_loss)
    grad_err = max(scaled_err(grads[p], g) for p, g in r_grads.items())
    diffs = torch.cat([(params[p] - t).abs().flatten() for p, t in r_params.items()])
    param_err, param_q999 = diffs.max().item(), torch.quantile(diffs.double(), 0.999).item()
    backend = _mb_backend(config, batch)
    log(f"minibatch parity (bench size, backend {backend}, {batch[1].num_edges} sampled "
        f"edges): card vs cpu loss {loss:.6f} err {loss_err:.3e}, grad scaled err "
        f"{grad_err:.3e} (tol {GRAD_ATOL}), params after Adam max err {param_err:.3e} "
        f"(tol {2 * LEARNING_RATE}: Adam's first step is lr·sign(g)) q99.9 "
        f"{param_q999:.3e} (tol {PARAM_Q999_ATOL})")
    check(loss_err <= SERVING_ATOL and grad_err <= GRAD_ATOL
          and param_err <= 2 * LEARNING_RATE and param_q999 <= PARAM_Q999_ATOL,
          "minibatch step on the card disagrees with the CPU")
    return dict(backend=backend, loss=loss, loss_err=loss_err, grad_scaled_err=grad_err,
                param_max_abs_err=param_err, param_q999_abs_err=param_q999)


def phase_minibatch(dev, mb, graph_s: float) -> dict:
    """BASELINE.json config #4 on one card at benchmarks/minibatch_xxl.py's
    shapes: N=1M, E=10M, U=237, F = H = 64, 2 layers, MinibatchSpec(1024,
    (10, 10), 32768); 1 warm-up and MB_TIMED timed steps, each split into
    host sampling, host-to-device copies and the device step (CUDA events),
    then one profiled device step. ``mb`` is the graph ``mb_graph`` drew,
    in ``graph_s`` seconds."""
    ei, etexts, feats = mb
    config = mb_config()
    t0 = time.perf_counter()
    trainer = MinibatchTrainer(config, adam(LEARNING_RATE), ei, etexts, feats,
                               MinibatchSpec(**MB_SPEC), device=dev)
    build_s = time.perf_counter() - t0
    log(f"minibatch: graph N={MB_N:,} E={MB_E:,} U={MB_U} drawn in {graph_s:.1f} s; "
        f"MinibatchTrainer built in {build_s:.2f} s (its NeighborSampler's CSR and "
        f"relation ids, and its copies of the edges and texts)")
    state = create_train_state(
        tree_map(lambda t: t.to(dev),
                 init_hypergnn(config, torch.Generator().manual_seed(0))),
        adam(LEARNING_RATE))
    rng_np, gen = np.random.default_rng(1), torch.Generator(device=dev).manual_seed(2)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    with profiling.tally() as counts:
        steps = []
        for i in range(1 + MB_TIMED):
            t0 = time.perf_counter()
            batch = trainer.sample_batch(rng_np)
            t1 = time.perf_counter()
            tensors = trainer.to_device(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            start.record()
            _, _, loss = trainer.device_step(state.params, state.opt_state, tensors, gen)
            stop.record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            graph = batch[1]
            steps.append(dict(
                loss=loss.item(), sample_ms=(t1 - t0) * 1e3, h2d_ms=(t2 - t1) * 1e3,
                device_ms=start.elapsed_time(stop), step_wall_ms=(t3 - t2) * 1e3,
                backend=_mb_backend(config, batch),
                nodes=graph.num_nodes, nodes_padded=batch[0].shape[0],
                edges=graph.num_edges, edges_padded=graph.src.shape[0],
                relations=graph.num_relations,
            ))
            s = steps[-1]
            log(f"minibatch step {i}{' (warm-up)' if i == 0 else ''}: loss {s['loss']:.6f}; "
                f"host sampling {s['sample_ms']:.1f} ms, host-to-device {s['h2d_ms']:.2f} ms, "
                f"device step {s['device_ms']:.2f} ms (CUDA events; wall {s['step_wall_ms']:.2f}); "
                f"backend {s['backend']}; nodes {s['nodes']:,} of {s['nodes_padded']:,}, "
                f"edges {s['edges']:,} of {s['edges_padded']:,}, relations {s['relations']}")
    launches = kernel_launches(counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    timed = steps[1:]

    def med(key):
        return float(np.median([s[key] for s in timed]))

    log(f"minibatch: medians over {MB_TIMED} steps: sampling {med('sample_ms'):.1f} ms, "
        f"host-to-device {med('h2d_ms'):.2f} ms, device step {med('device_ms'):.2f} ms; "
        f"peak memory {peak_gb:.2f} GB; kernel launches {launches}")
    check(all(np.isfinite(s["loss"]) for s in steps), "minibatch: a loss is not finite")
    # JAX's auto picks grouped on this subgraph (unsorted, U x N_pad x d
    # beyond the dense budget); the port's grouped runs cuBLAS per relation
    # and no hand-written kernel in the model.
    check(all(s["backend"] == "grouped" for s in steps),
          "minibatch: auto did not pick grouped, as the JAX package does")
    # No kernel in the model; kernel 1 once a step in the loss's backward,
    # the gather kernel twice (the loss's rows, the permute of its streams).
    want = dict({name: 0 for name in KERNELS}, csr_segment_sum=1 + MB_TIMED,
                gather_rows=2 * (1 + MB_TIMED))
    check(launches == want, f"minibatch: launches {launches} != {want}")
    profile = profile_device(
        "one minibatch device step",
        lambda: trainer.device_step(state.params, state.opt_state, tensors, gen))
    busy = profile["device_ms"] / med("device_ms")
    log(f"minibatch: device busy {100 * busy:.1f}% of a device step")
    return dict(build_s=build_s, graph_s=graph_s, steps=steps,
                median_sample_ms=med("sample_ms"), median_h2d_ms=med("h2d_ms"),
                median_device_ms=med("device_ms"), peak_memory_gb=peak_gb,
                device_busy_share=busy, launches=launches, profile=profile)


def _grad_run(fn, inputs, r):
    """``(out, [grads of Σ out · R w.r.t. inputs])`` of one call of ``fn``."""
    args = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*args)
    (out * r).sum().backward()
    return out.detach(), [a.grad for a in args]


def _parallel_forms(dev, mesh, g, h, banks, r) -> dict:
    """Edge-partitioned, node-partitioned, halo and scheduled-halo message
    passing on the one-rank mesh, each against the main path (the ``cuda``
    backend over the SortPlan: kernels 1 and 2 forward, 1-3 backward) and
    ``dense``: the output and the gradients of ``Σ out · R`` w.r.t. h,
    W_msg, W_self and the bias, CUDA-event ms of a forward + backward and
    its peak memory."""
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
    host = [np.asarray(a) for a in g.arrays[:4]]
    plan = g.sort_plan.to(dev)
    inputs = [h, banks["W_msg"], banks["W_self"], banks["bias"]]
    t0 = time.perf_counter()
    node = partition_edges_by_dst(*host, XL_N, 1)
    node_t = [torch.as_tensor(a, device=dev) for a in node[:4]]
    halo_plan = halo.build_halo_plan(*host, XL_N, 1)
    halo_t = [torch.as_tensor(a, device=dev) for a in halo_plan.edge_arrays]
    send_idx = torch.as_tensor(halo_plan.send_idx, device=dev)
    sched = halo.build_scheduled_halo_plan(*host, XL_N, 1)
    log(f"parallel: one-rank plans built on the host in {time.perf_counter() - t0:.2f} s")
    forms = {
        "edge_partitioned": lambda h, wm, ws, b: edge_partitioned_message_passing(
            mesh, h, src, dst, rel, wm, ws, b, edge_mask=mask),
        "node_partitioned": lambda h, wm, ws, b: node_partitioned_message_passing(
            mesh, h, *node_t[:3], wm, ws, b, node_t[3], node[4]),
        "halo": lambda h, wm, ws, b: halo.halo_message_passing(
            mesh, h, halo_t, send_idx, wm, ws, b, halo_plan.nodes_per_shard,
            halo_plan.halo_width),
        "scheduled_halo": lambda h, wm, ws, b: halo.scheduled_halo_message_passing(
            mesh, h, sched, wm, ws, b),
    }
    backends = {
        backend: (lambda h, wm, ws, b, backend=backend: relational_message_passing(
            h, src, dst, rel, wm, ws, b, num_nodes=XL_N, edge_mask=mask, backend=backend,
            rel_sorted=True, group_padded=True,
            sort_plan=plan if backend == "cuda" else None))
        for backend in ("cuda", "dense")
    }
    refs = {}
    for backend, fn in backends.items():
        refs[backend] = _grad_run(fn, inputs, r)
        torch.cuda.empty_cache()
    out = {}
    names = ("h", "W_msg", "W_self", "bias")
    for name, fn in forms.items():
        torch.cuda.reset_peak_memory_stats(dev)
        got, grads = _grad_run(fn, inputs, r)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        res = dict(peak_memory_gb=peak_gb)
        for ref_name, (want, want_grads) in refs.items():
            err = (got - want).abs().max().item()
            grad_errs = {n: scaled_err(a, b) for n, a, b in zip(names, grads, want_grads)}
            res[f"vs_{ref_name}"] = dict(max_abs_err=err, grad_scaled_err=grad_errs)
            log(f"parallel {name} vs {ref_name}: max_abs_err {err:.3e}, gradient scaled "
                f"errors " + ", ".join(f"{n} {e:.3e}" for n, e in grad_errs.items())
                + f" (tol {PARALLEL_ATOL})")
            check(err <= PARALLEL_ATOL and max(grad_errs.values()) <= PARALLEL_ATOL,
                  f"parallel {name} disagrees with {ref_name}")
        del got, grads
        res["ms"] = cuda_ms(lambda fn=fn: _grad_run(fn, inputs, r), iters=3, warmup=1)
        log(f"parallel {name}: {res['ms']:.3f} ms per forward + backward (CUDA events), "
            f"peak memory {peak_gb:.2f} GB")
        out[name] = res
        torch.cuda.empty_cache()
    for backend, fn in backends.items():
        out[f"{backend}_backend_ms"] = cuda_ms(lambda fn=fn: _grad_run(fn, inputs, r),
                                               iters=3, warmup=1)
        log(f"parallel: the {backend} backend {out[f'{backend}_backend_ms']:.3f} ms per "
            f"forward + backward (CUDA events)")
    return out


def _parallel_dp(dev, mesh, feats_np, g) -> dict:
    """One data-parallel step over DP_BATCH copies of the xl graph against
    the single-process step on the mean of the copies' losses, from the
    same parameters, Adam state and negatives; then its ms."""
    config = train_config()
    init = init_hypergnn(config, torch.Generator().manual_seed(3))
    feats = torch.as_tensor(np.stack([feats_np] * DP_BATCH), device=dev)
    arrays = [torch.as_tensor(np.stack([a] * DP_BATCH), device=dev) for a in g.arrays]
    gen = torch.Generator(device=dev).manual_seed(4)
    neg = torch.randint(0, XL_N, arrays[0].shape, generator=gen, device=dev,
                        dtype=arrays[0].dtype)

    def fresh():
        return create_train_state(tree_map(lambda t: t.to(dev), init), adam(LEARNING_RATE))

    dp = fresh()
    step = make_data_parallel_step(mesh, config, adam(LEARNING_RATE), axis="edge")
    ref = fresh()
    # Both steps sum the same terms in the same order, but without a plan
    # the cuda backend reduces over dst with index_add_, whose float atomics
    # round in any order; Adam's first step moves a parameter by ~lr·sign(g),
    # so a gradient at rounding noise could differ by 2·lr. PyTorch's
    # deterministic algorithms take the atomics out of the comparison.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, loss = step(dp.params, dp.opt_state, feats, *arrays, gen, neg=neg)
        ref.opt_state.zero_grad(set_to_none=True)
        ref_loss = sum(
            link_prediction_loss(
                apply_hypergnn(config, ref.params, feats[b], *(a[b] for a in arrays)),
                arrays[0][b], arrays[1][b], neg[b], edge_mask=arrays[3][b])
            for b in range(DP_BATCH)) / DP_BATCH
        ref_loss.backward()
        ref.opt_state.step()
    finally:
        torch.use_deterministic_algorithms(False)
    loss_err = abs(loss.item() - ref_loss.item())
    param_err = max((a.detach() - b.detach()).abs().max().item()
                    for (_, a), (_, b) in zip(named_leaves(dp.params),
                                              named_leaves(ref.params)))
    log(f"parallel DP step ({DP_BATCH} xl copies): loss {loss.item():.6f}, against the "
        f"single-process step {loss_err:.3e} (tol {DP_LOSS_ATOL}), parameters after Adam "
        f"{param_err:.3e} (tol {DP_PARAM_ATOL})")
    check(np.isfinite(loss.item()) and loss_err <= DP_LOSS_ATOL
          and param_err <= DP_PARAM_ATOL, "parallel: the DP step disagrees")
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: step(dp.params, dp.opt_state, feats, *arrays, gen, neg=neg),
                 iters=2, warmup=0)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"parallel DP step: {ms:.3f} ms (CUDA events, {DP_BATCH} xl copies on one rank), "
        f"peak memory {peak_gb:.2f} GB")
    return dict(loss=loss.item(), loss_err=loss_err, param_err=param_err, ms=ms,
                peak_memory_gb=peak_gb)


def _plan_numbers(g) -> dict:
    """Host ms of the halo plans at xl for meshes of PLAN_SHARDS ranks, on
    raw labels and after ``locality_relabel``, with their wire volumes at
    d=64: plans that ranks on other cards would use, built and measured on
    this host."""
    real = np.asarray(g.edge_mask) > 0
    src, dst, rel, mask = (np.asarray(a)[real] for a in g.arrays[:4])
    t0 = time.perf_counter()
    perm = halo.locality_relabel(src, dst, XL_N)
    relabel_ms = (time.perf_counter() - t0) * 1e3
    log(f"parallel plans (host): locality_relabel of the xl graph {relabel_ms:.1f} ms")
    out = dict(locality_relabel_ms=relabel_ms)
    for labels, (s, t) in (("raw", (src, dst)), ("relabeled", (perm[src], perm[dst]))):
        for k in PLAN_SHARDS:
            t0 = time.perf_counter()
            plan = halo.build_halo_plan(s, t, rel, mask, XL_N, k)
            t1 = time.perf_counter()
            sched = halo.build_scheduled_halo_plan(s, t, rel, mask, XL_N, k)
            t2 = time.perf_counter()
            res = dict(
                build_halo_plan_ms=(t1 - t0) * 1e3,
                build_scheduled_halo_plan_ms=(t2 - t1) * 1e3,
                halo_bytes_per_device=halo.halo_bytes_per_device(plan, WIDTH),
                allgather_bytes_per_device=halo.allgather_bytes_per_device(plan, WIDTH),
                halo_padding_factor=halo.halo_padding_factor(plan),
                scheduled_bytes_per_device=halo.scheduled_halo_bytes_per_device(sched, WIDTH),
                scheduled_padding_factor=halo.scheduled_halo_padding_factor(sched),
                rounds=sched.num_rounds, halo_width=plan.halo_width)
            log(f"parallel plans (host) {labels} k={k}: build_halo_plan "
                f"{res['build_halo_plan_ms']:.1f} ms, build_scheduled_halo_plan "
                f"{res['build_scheduled_halo_plan_ms']:.1f} ms; bytes per device: halo "
                f"{res['halo_bytes_per_device']:,}, all_gather "
                f"{res['allgather_bytes_per_device']:,}, scheduled "
                f"{res['scheduled_bytes_per_device']:,.0f}; padding factors "
                f"{res['halo_padding_factor']:.3f} / {res['scheduled_padding_factor']:.3f}; "
                f"{res['rounds']} rounds, B = {res['halo_width']}")
            out[f"{labels}_k{k}"] = res
    return out


def _events_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``iters`` calls, no
    warm-up (the caller warms up)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def adam_step_errors(label, got_loss, got_params, want_loss, want_params,
                     lr: float = LEARNING_RATE) -> dict:
    """One step against another from the same parameters: the loss, each
    leaf's gradient scaled, and the parameters after Adam (the gate where
    |g| is above ADAM_NOISE_GRAD, 2·lr elsewhere); recorded as checks."""
    got, want = dict(named_leaves(got_params)), dict(named_leaves(want_params))
    got_loss, want_loss = (float(x.detach()) if torch.is_tensor(x) else float(x)
                           for x in (got_loss, want_loss))
    loss_err = abs(got_loss - want_loss)
    grad_err = max(scaled_err(got[p].grad, w.grad) for p, w in want.items())
    param_err, flip_err = 0.0, 0.0
    for p, w in want.items():
        diff = (got[p].detach() - w.detach()).abs()
        sure = w.grad.abs() >= ADAM_NOISE_GRAD
        param_err = max(param_err, torch.where(sure, diff, 0.0).max().item()
                        / max(1.0, w.detach().abs().max().item()))
        flip_err = max(flip_err, diff.max().item())
    log(f"{label}: loss {got_loss:.6f} against {want_loss:.6f} "
        f"({loss_err:.3e}, tol {STEP_LOSS_ATOL}); gradients scaled {grad_err:.3e} "
        f"(tol {GRAD_ATOL}); parameters after Adam scaled {param_err:.3e} where |g| >= "
        f"{ADAM_NOISE_GRAD} (tol {GRAD_ATOL}), at most {flip_err:.3e} (tol {2 * lr})")
    check(np.isfinite(got_loss) and loss_err <= STEP_LOSS_ATOL
          and grad_err <= GRAD_ATOL and param_err <= GRAD_ATOL and flip_err <= 2 * lr,
          f"{label}: disagree")
    return dict(loss=got_loss, loss_err=loss_err, grad_scaled_err=grad_err,
                param_scaled_err=param_err, param_max_err=flip_err)


def _with_grad(t: torch.Tensor) -> torch.Tensor:
    """A detached copy of a leaf that carries a copy of its gradient."""
    out = t.detach().clone()
    out.grad = t.grad.clone()
    return out


def _fresh(init, dev):
    return create_train_state(tree_map(lambda t: t.to(dev, copy=True), init),
                              adam(LEARNING_RATE))


def _parallel_tp(dev, mesh, g, params) -> dict:
    """tensor_parallel on the one-rank axis at xl: the Megatron-split
    generator against ``apply_weight_generator``, and ``tp_message_passing``
    against the main path (the ``cuda`` backend over the SortPlan): values,
    the gradients of ``Σ out · R``, ms and peak memory."""
    config = train_config()
    wg_cfg = config.weight_generator
    te, wg = params["text_encoder"], params["weight_generators"][0]
    chars, lens = (torch.as_tensor(a, device=dev) for a in g.arrays[4:6])
    text = apply_text_encoder(te, chars, lens)
    blocks = shard_generator_params(wg, wg_cfg, mesh, axis="edge")
    got = tp_generate_weights(mesh, wg_cfg, blocks, text, axis="edge")
    want = apply_weight_generator(wg_cfg, wg, text)
    gen_err = max((got[n] - want[n]).abs().max().item() for n in want)
    gen_ms = cuda_ms(lambda: tp_generate_weights(mesh, wg_cfg, blocks, text, axis="edge"),
                     iters=5, warmup=1)
    log(f"parallel tp_generate_weights: max_abs_err {gen_err:.3e} against "
        f"apply_weight_generator (tol {PARALLEL_ATOL}), {gen_ms:.3f} ms")
    check(gen_err <= PARALLEL_ATOL, "parallel: tp_generate_weights disagrees")
    src, dst, rel, mask = (torch.as_tensor(a, device=dev) for a in g.arrays[:4])
    plan = g.sort_plan.to(dev)
    rgen = torch.Generator().manual_seed(1)
    h = torch.randn(XL_N, WIDTH, generator=rgen).to(dev)
    r = torch.randn(XL_N, WIDTH, generator=rgen).to(dev)
    inputs = [h] + [want[n].detach() for n in ("W_msg", "W_self", "bias")]
    ref, ref_grads = _grad_run(lambda h, wm, ws, b: relational_message_passing(
        h, src, dst, rel, wm, ws, b, num_nodes=XL_N, edge_mask=mask, backend="cuda",
        rel_sorted=True, group_padded=True, sort_plan=plan), inputs, r)

    def tp_mp(h, wm, ws, b):
        return tp_message_passing(mesh, h, src, dst, rel,
                                  {"W_msg": wm, "W_self": ws, "bias": b}, XL_N,
                                  edge_mask=mask, axis="edge")

    torch.cuda.reset_peak_memory_stats(dev)
    out, grads = _grad_run(tp_mp, inputs, r)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    err = (out - ref).abs().max().item()
    grad_errs = {n: scaled_err(a, b) for n, a, b in
                 zip(("h", "W_msg", "W_self", "bias"), grads, ref_grads)}
    del out, grads, ref, ref_grads
    ms = cuda_ms(lambda: _grad_run(tp_mp, inputs, r), iters=3, warmup=1)
    log(f"parallel tp_message_passing vs the main path: max_abs_err {err:.3e}, gradient "
        f"scaled errors " + ", ".join(f"{n} {e:.3e}" for n, e in grad_errs.items())
        + f" (tol {PARALLEL_ATOL}); {ms:.3f} ms per forward + backward, peak {peak:.2f} GB")
    check(err <= PARALLEL_ATOL and max(grad_errs.values()) <= PARALLEL_ATOL,
          "parallel: tp_message_passing disagrees with the main path")
    torch.cuda.empty_cache()
    return dict(generate=dict(max_abs_err=gen_err, ms=gen_ms),
                message_passing=dict(max_abs_err=err, grad_scaled_err=grad_errs, ms=ms,
                                     peak_memory_gb=peak))


def _parallel_pipeline(dev, mesh, feats_np, g) -> dict:
    """The pipeline at S = 1 over PIPE_MICRO xl microbatches (the xl graph
    with other features): ``pipelined_forward`` against ``apply_hypergnn``
    per microbatch, and ``make_pipelined_train_step`` against the
    sequential step on the same negatives; the backend ``auto`` picks for
    the microbatch layout (JAX's pipeline passes no plan), ms."""
    config = train_config("auto")
    backend = resolve_backend("auto", XL_N, g.char_ids.shape[0], g.src.shape[0], WIDTH,
                              rel_sorted=True, group_padded=False, has_sort_plan=False)
    init = init_hypergnn(config, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    feats = torch.as_tensor(np.stack([feats_np] + [
        rng.standard_normal(feats_np.shape).astype(np.float32)
        for _ in range(PIPE_MICRO - 1)]), device=dev)
    arrays = [torch.as_tensor(np.stack([a] * PIPE_MICRO), device=dev) for a in g.arrays]
    params = tree_map(lambda t: t.to(dev), init)
    with torch.no_grad():
        out = pipelined_forward(mesh, config, params, feats, *arrays, axis="edge")
        err = max((out[m] - apply_hypergnn(config, params, feats[m], *(a[m] for a in arrays))
                   ).abs().max().item() for m in range(PIPE_MICRO))
        fwd_ms = cuda_ms(lambda: pipelined_forward(mesh, config, params, feats, *arrays,
                                                   axis="edge"), iters=2, warmup=1)
    log(f"parallel pipelined_forward (S=1, {PIPE_MICRO} xl microbatches, auto picks "
        f"{backend!r}): max_abs_err {err:.3e} against apply_hypergnn per microbatch (tol "
        f"{PARALLEL_ATOL}), {fwd_ms:.3f} ms")
    check(err <= PARALLEL_ATOL, "parallel: pipelined_forward disagrees")
    del out
    gen = torch.Generator(device=dev).manual_seed(6)
    neg = torch.randint(0, XL_N, arrays[0].shape, generator=gen, device=dev,
                        dtype=arrays[0].dtype)
    pipe, ref = _fresh(init, dev), _fresh(init, dev)
    step = make_pipelined_train_step(mesh, config, adam(LEARNING_RATE), axis="edge")
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, loss = step(pipe.params, pipe.opt_state, feats, *arrays, gen, neg_dst=neg)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ref.opt_state.zero_grad(set_to_none=True)
    ref_loss = torch.stack([
        link_prediction_loss(apply_hypergnn(config, ref.params, feats[m],
                                            *(a[m] for a in arrays)),
                             arrays[0][m], arrays[1][m], neg[m], edge_mask=arrays[3][m])
        for m in range(PIPE_MICRO)]).mean()
    ref_loss.backward()
    ref.opt_state.step()
    res = adam_step_errors("parallel make_pipelined_train_step vs the sequential step",
                           loss, pipe.params, ref_loss, ref.params)
    step_ms = _events_ms(lambda: step(pipe.params, pipe.opt_state, feats, *arrays, gen,
                                      neg_dst=neg), 2)
    log(f"parallel pipelined train step: {step_ms:.3f} ms (CUDA events), peak {peak:.2f} GB")
    torch.cuda.empty_cache()
    return dict(backend=backend, forward=dict(max_abs_err=err, ms=fwd_ms),
                train_step=dict(res, ms=step_ms, peak_memory_gb=peak))


def composed_layouts(g, feats_np, k: int) -> dict:
    """The composed step's host layouts of the xl graph for k ranks, both
    relation-sorted and group-padded per shard: halo and the dense v1."""
    out = {}
    for name, halo_mode in (("halo", True), ("dense_v1", False)):
        t0 = time.perf_counter()
        out[name] = prepare_composed_inputs(g, feats_np, k, halo=halo_mode,
                                            rel_sort_local=True, group_pad=256)
        log(f"composed layout {name} k={k}: prepare_composed_inputs "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the host, cap "
            f"{out[name].src.shape[0] // k}, halo width {out[name].halo_width}")
    return out


def composed_step(mesh, config, inputs, contrib: str, *, local_roll: bool, axis="edge"):
    """A composed step over ``inputs`` and its keyword arrays (the rank's
    blocks): the kernel contributions with the shard's plan, grouped with
    its group sizes, dense without either."""
    halo_mode = inputs.src_halo is not None
    step = make_composed_train_step(
        mesh, config, adam(LEARNING_RATE), inputs.nodes_per_shard, axis=axis,
        num_nodes=inputs.num_nodes, halo_width=inputs.halo_width if halo_mode else None,
        neg_mode="local_roll" if local_roll else "uniform_global", contrib=contrib,
        agg_sorted=contrib not in ("grouped", "dense"))
    return step


def composed_kwargs(kw: dict, contrib: str) -> dict:
    kernel = contrib not in ("grouped", "dense")
    return {key: v for key, v in kw.items()
            if not ((key in ("agg_plan", "kernel_plan") and not kernel)
                    or (key == "rel_group_sizes" and contrib != "grouped"))}


def _parallel_composed(dev, mesh, feats_np, g) -> tuple:
    """The composed step at k = 1 on the xl layouts, halo with local_roll
    and the dense v1 with uniform_global, each contribution backend: the
    uniform forms against the single-process ``make_train_step`` (the cuda
    backend over the layout's SortPlan) on the same negatives, the local
    forms against each other; the cuda contribution's launches per step
    against the count from the code and no run-table launch; ms per step
    and peak memory."""
    config = train_config()
    init = _scale_one(init_hypergnn(config, torch.Generator().manual_seed(8)))
    layouts = composed_layouts(g, feats_np, 1)
    out = {}
    for mode, inputs in layouts.items():
        local_roll = mode == "halo"
        arrays, kw = local_inputs(inputs, mesh, "edge", dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        cap = arrays[1].shape[0]
        neg = 12_345 if local_roll else torch.randint(
            0, XL_N, (cap,), generator=gen, device=dev, dtype=arrays[1].dtype)
        ref = None
        if not local_roll:
            host = [np.asarray(a) for a in (inputs.src, inputs.dst, inputs.rel_ids,
                                            inputs.edge_mask)]
            plan = build_sort_plan(*host, XL_N, inputs.char_ids.shape[0]).to(dev)
            ref = _fresh(init, dev)
            _, _, ref_loss = make_train_step(config)(
                ref.params, ref.opt_state, *arrays, gen, neg_dst=neg, sort_plan=plan)
        first = None
        for contrib in COMPOSED_CONTRIBS:
            label = f"parallel composed {mode} contrib={contrib}"
            step = composed_step(mesh, config, inputs, contrib, local_roll=local_roll)
            ckw = composed_kwargs(kw, contrib)
            state = _fresh(init, dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _, _, loss = step(state.params, state.opt_state, *arrays, gen, neg=neg, **ckw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            if ref is not None:
                res = adam_step_errors(f"{label} vs make_train_step", loss, state.params,
                                       ref_loss, ref.params)
            elif first is None:
                # A copy: the timed steps below go on updating the parameters.
                first = (loss, tree_map(_with_grad, state.params))
                res = dict(loss=float(loss))
            else:
                res = adam_step_errors(f"{label} vs contrib={COMPOSED_CONTRIBS[0]}",
                                       loss, state.params, *first)
            with profiling.tally() as counts:
                ms = _events_ms(lambda: step(state.params, state.opt_state, *arrays, gen, neg=neg,
                                             **ckw), COMPOSED_TIMED)
            launches = kernel_launches(counts)
            per_step = {n: c // COMPOSED_TIMED for n, c in launches.items()}
            tables = counts.get("kernel.run_table", 0)
            if contrib in ("pallas", "pallas_packed"):
                log(f"{label}: launches per step {per_step} (expected {COMPOSED_LAUNCHES}), "
                    f"run_table launches {tables}")
                check(per_step == COMPOSED_LAUNCHES and tables == 0,
                      f"{label}: launches differ from the code's count")
            log(f"{label}: {ms:.3f} ms per step (CUDA events, {COMPOSED_TIMED} steps), "
                f"peak {peak:.2f} GB")
            if (mode, contrib) == ("halo", "pallas"):
                res["profile"] = profile_device(label, lambda: step(
                    state.params, state.opt_state, *arrays, gen, neg=neg, **ckw), rows=10)
            out[f"{mode}/{contrib}"] = dict(res, ms=ms, peak_memory_gb=peak,
                                            launches=launches, run_table_launches=tables)
            del state
            torch.cuda.empty_cache()
    return out, layouts


def _shard_stream_sums(dev, g, feats_np, k: int = 4) -> dict:
    """Kernel 1 alone on the reductions of the composed step's first shard
    at k ranks (the xl halo layout, group-padded per shard), one launch per
    stream as the step makes it: the aggregation over the shard's nodes,
    the dst and src gathers' cotangents over its [local ++ halo] rows, and
    dbias; and kernel 7 over that cotangent pair in one launch (on no path,
    as in the JAX package). Each call against its plain version (the f32
    gate, scaled), twice the same bits, every empty segment exactly +0.0;
    CUDA-event ms beside the segments and how many are empty, the bytes
    bound, the kernel's share of it (and the kernel alone by torch.profiler,
    since the wrapper's host work can outlast so short a call), and
    torch.segment_reduce's and the plain version's ms on the same rows and
    bounds. The dst cotangent sums the aggregation's rows over a table whose
    halo rows are all empty segments: the kernel alone must take under 10x
    the aggregation's (a check of the structure, not of speed, that fails
    where a group walks the empty run one segment at a time)."""
    inputs = prepare_composed_inputs(g, feats_np, k, halo=True, rel_sort_local=True,
                                     group_pad=256)
    cap, npp = inputs.src.shape[0] // k, inputs.nodes_per_shard
    rows = npp + k * inputs.halo_width
    gen = torch.Generator().manual_seed(13)
    x, x2 = (torch.randn(cap, WIDTH, generator=gen).to(dev) for _ in range(2))
    src_sp, dst_sp = inputs.kernel_src_splits[0], inputs.kernel_dst_splits[0]

    def measure(name, fn, plain_fn, library_fn, streams, n) -> dict:
        """``streams``: the host splits of each output of ``fn``."""
        got, again = fn(), fn()
        plain = plain_fn()
        torch.cuda.synchronize()
        if torch.is_tensor(got):
            got, again, plain = (got,), (again,), (plain,)
        empty, err, summed = 0, 0.0, 0
        for out, twice, want, splits in zip(got, again, plain, streams):
            idx = np.flatnonzero(np.diff(splits[: n + 1]) == 0)
            zeros = out[torch.as_tensor(idx, device=dev)]
            check(torch.equal(out, twice), f"{name} on the composed shard: two runs differ")
            check(not zeros.any() and not zeros.signbit().any(),
                  f"{name} on the composed shard: an empty segment is not +0.0")
            empty, err = empty + len(idx), max(err, scaled_err(out, want))
            summed += int(splits[n] - splits[0])
        check(err <= KERNEL_ATOL, f"{name} on the composed shard disagrees with its plain version")
        outs = len(streams)
        b_ms, b_by = bound((summed * WIDTH + outs * ((n + 1) + n * WIDTH)) * 4, summed * WIDTH)
        r = dict(ms=cuda_ms(fn, iters=10, warmup=2), bound_ms=b_ms, bound_by=b_by,
                 plain_ms=cuda_ms(plain_fn, iters=10, warmup=2),
                 library_ms=cuda_ms(library_fn, iters=10, warmup=2),
                 kernel_ms=kernel_ms(fn, "csr_segment_sum_kernel", calls=10),
                 max_abs_err=err, rows=cap, segments=n, empty_segments=empty)
        r["share_of_bound"] = b_ms / r["ms"]
        log(f"{name} on the composed k={k} shard 0: {r['ms']:.4f} ms (kernel alone "
            f"{r['kernel_ms']:.4f}) over {cap} rows, {n} segments, {empty} empty | bound "
            f"{b_ms:.4f} ({b_by}), {r['share_of_bound']:.1%} of it | torch.segment_reduce "
            f"{r['library_ms']:.4f} | plain {r['plain_ms']:.4f} | scaled err {err:.3e}")
        return r

    out = {}
    for name, (splits, n) in {
        "aggregation": (dst_sp, npp),
        "dst_cotangent": (dst_sp, rows),
        "src_cotangent": (src_sp, rows),
        "dbias": (inputs.kernel_rel_splits[0], inputs.char_ids.shape[0]),
    }.items():
        sp = torch.as_tensor(splits, device=dev)
        offsets = sp[: n + 1].long()
        out[name] = measure(
            f"kernel 1 {name}", functools.partial(kernels.csr_segment_sum, x, sp, n),
            functools.partial(kernels.csr_segment_sum_plain, x, sp, n),
            functools.partial(torch.segment_reduce, x, "sum", offsets=offsets, unsafe=True),
            [splits], n)
    sa, sb = (torch.as_tensor(sp, device=dev) for sp in (src_sp, dst_sp))
    off_a, off_b = sa[: rows + 1].long(), sb[: rows + 1].long()
    out["kernel_7"] = measure(
        "kernel 7 src + dst cotangents",
        functools.partial(kernels.dual_sorted_segment_sum, x, x2, rows, sa, sb),
        functools.partial(kernels.dual_sorted_segment_sum_plain, x, x2, rows, sa, sb),
        lambda: (torch.segment_reduce(x, "sum", offsets=off_a, unsafe=True),
                 torch.segment_reduce(x2, "sum", offsets=off_b, unsafe=True)),
        [src_sp, dst_sp], rows)
    ratio = out["dst_cotangent"]["kernel_ms"] / out["aggregation"]["kernel_ms"]
    log(f"kernel 1 on the composed k={k} shard 0: dst cotangent / aggregation, kernel alone, "
        f"{ratio:.2f}x")
    check(ratio < 10, f"kernel 1 on the composed shard: the dst cotangent takes {ratio:.1f}x "
          "the aggregation's time: empty segments are walked, not zeroed in parallel")
    return out


def _parallel_composed_tp(dev, layouts) -> dict:
    """The 2D composed step on a (1, 1) ("edge", "model") mesh against the
    1D composed step on the same halo layout and rotation (grouped)."""
    config = train_config()
    init = _scale_one(init_hypergnn(config, torch.Generator().manual_seed(8)))
    mesh2 = make_mesh((1, 1), ("edge", "model"), device_type=dev.type)
    inputs = layouts["halo"]
    arrays, kw = local_inputs(inputs, mesh2, "edge", dev)
    ckw = composed_kwargs(kw, "grouped")
    ckw.pop("agg_plan", None)
    gen = torch.Generator(device=dev).manual_seed(10)
    one_d = _fresh(init, dev)
    step1 = composed_step(mesh2, config, inputs, "grouped", local_roll=True)
    _, _, ref_loss = step1(one_d.params, one_d.opt_state, *arrays, gen, neg=777, **ckw)
    two_d = create_train_state(shard_composed_tp_params(
        tree_map(lambda t: t.to(dev, copy=True), init), config, mesh2), adam(LEARNING_RATE))
    step2 = make_composed_tp_train_step(mesh2, config, adam(LEARNING_RATE),
                                        inputs.nodes_per_shard, halo_width=inputs.halo_width,
                                        contrib="grouped")
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, loss = step2(two_d.params, two_d.opt_state, *arrays, gen, neg=777, **ckw)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    res = adam_step_errors("parallel composed_tp (1, 1) vs the 1D composed step", loss,
                           two_d.params, ref_loss, one_d.params)
    ms = _events_ms(lambda: step2(two_d.params, two_d.opt_state, *arrays, gen, neg=777,
                                  **ckw), 2)
    log(f"parallel composed_tp: {ms:.3f} ms per step (CUDA events), peak {peak:.2f} GB")
    torch.cuda.empty_cache()
    return dict(res, ms=ms, peak_memory_gb=peak)


def _parallel_sharded(dev, mesh, feats_np, g) -> dict:
    """``make_train_step`` (the main path: roll negatives through the
    SortPlan) on DTensor parameters and graph arrays against the same step
    on plain tensors, from the same parameters and shift."""
    config = train_config()
    init = init_hypergnn(config, torch.Generator().manual_seed(11))
    feats = torch.as_tensor(feats_np, device=dev)
    arrays = [torch.as_tensor(a, device=dev) for a in g.arrays]
    plan = g.sort_plan.to(dev)
    shift = torch.tensor(4_321, device=dev)
    step = make_train_step(config, neg_mode="roll")
    gen = torch.Generator(device=dev).manual_seed(12)
    ref = _fresh(init, dev)
    _, _, ref_loss = step(ref.params, ref.opt_state, feats, *arrays, gen, neg_dst=shift,
                          sort_plan=plan)
    sharded = create_train_state(
        shard_params(tree_map(lambda t: t.to(dev, copy=True), init), config, mesh),
        adam(LEARNING_RATE))
    dt_arrays = shard_graph_arrays(arrays, mesh)
    _, _, loss = step(sharded.params, sharded.opt_state, feats, *dt_arrays, gen,
                      neg_dst=shift, sort_plan=plan)
    whole = tree_map(lambda t: t.full_tensor().detach(), sharded.params)
    for (_, w), (_, t) in zip(named_leaves(whole), named_leaves(sharded.params)):
        w.grad = t.grad.full_tensor()
    res = adam_step_errors("parallel sharded make_train_step vs plain", loss, whole,
                           ref_loss, ref.params)
    placements = sorted({str(t.placements) for _, t in named_leaves(sharded.params)})
    ms = _events_ms(lambda: step(sharded.params, sharded.opt_state, feats, *dt_arrays, gen,
                                 neg_dst=shift, sort_plan=plan), 2)
    log(f"parallel sharded step: placements kept {placements}; {ms:.3f} ms (CUDA events)")
    torch.cuda.empty_cache()
    return dict(res, placements=placements, ms=ms)


def phase_parallel(dev, mb) -> dict:
    """``parallel/`` on a one-rank NCCL process group over the card
    (``make_mesh((1,), ("edge",))``), at xl. Slices A and B: the four forms
    of message passing against the main path and ``dense``,
    relation-sharded generation bit for bit against single-rank generation,
    a DP step against the single-process step. Slices C and D: the
    tensor-parallel generator and message passing, the pipeline at S = 1,
    the composed step in every contribution backend (its kernels' launches
    counted), the 2D composed step on a (1, 1) mesh and the sharded
    ``make_train_step``, each against its single-process counterpart. The
    distributed minibatch trainer on the xxl graph ``mb`` (``mb_graph``'s,
    shared with the minibatch phase) and its bench-size parity. Then the
    halo plans for larger meshes on the host."""
    import torch.distributed as dist

    t_start = time.perf_counter()
    feats_np, g = xl_graph()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1,), ("edge",), device_type=dev.type)
            log(f"parallel: {dist.get_backend()} process group of {dist.get_world_size()} "
                f"rank, mesh {mesh.mesh_dim_names} on {mesh.device_type}")
            config = train_config()
            params = tree_map(lambda t: t.to(dev), _scale_one(
                init_hypergnn(config, torch.Generator().manual_seed(0))))
            chars, lens = (torch.as_tensor(a, device=dev) for a in g.arrays[4:6])
            te, wg = params["text_encoder"], params["weight_generators"][0]
            single = apply_weight_generator(config.weight_generator, wg,
                                            apply_text_encoder(te, chars, lens))
            torch.cuda.reset_peak_memory_stats(dev)
            banks = relation_sharded_generate(mesh, config.weight_generator, te, wg,
                                              chars, lens, axis="edge")
            gen_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            bitwise = all(torch.equal(banks[k], single[k]) for k in single)
            gen_ms = cuda_ms(lambda: relation_sharded_generate(
                mesh, config.weight_generator, te, wg, chars, lens, axis="edge"),
                iters=5, warmup=1)
            log(f"parallel relation_sharded_generate: banks {tuple(banks['W_msg'].shape)} "
                f"bit for bit equal to single-rank generation: {bitwise}; {gen_ms:.3f} ms, "
                f"peak memory {gen_peak_gb:.2f} GB")
            check(bitwise, "parallel: relation-sharded banks differ from single-rank ones")
            rgen = torch.Generator().manual_seed(1)
            h = torch.randn(XL_N, WIDTH, generator=rgen).to(dev)
            r = torch.randn(XL_N, WIDTH, generator=rgen).to(dev)
            banks = {k: v.detach() for k, v in banks.items()}
            out = dict(relation_sharded=dict(bitwise=bitwise, ms=gen_ms,
                                             peak_memory_gb=gen_peak_gb))
            out.update(_parallel_forms(dev, mesh, g, h, banks, r))
            del h, r, banks
            torch.cuda.empty_cache()
            out["data_parallel"] = _parallel_dp(dev, mesh, feats_np, g)
            # Slices C and D.
            out["tensor_parallel"] = _parallel_tp(dev, mesh, g, params)
            out["pipeline"] = _parallel_pipeline(dev, mesh, feats_np, g)
            out["composed"], layouts = _parallel_composed(dev, mesh, feats_np, g)
            out["composed"]["shard_streams_k4"] = _shard_stream_sums(dev, g, feats_np)
            out["composed_tp"] = _parallel_composed_tp(dev, layouts)
            out["sharded_step"] = _parallel_sharded(dev, mesh, feats_np, g)
            out["distributed_minibatch"] = dict(parity=_dist_minibatch_parity(dev, mesh),
                                                xxl=_dist_minibatch_xxl(dev, mesh, mb))
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["plans"] = _plan_numbers(g)
    out["seconds"] = time.perf_counter() - t_start
    log(f"parallel: phase in {out['seconds']:.1f} s")
    return out


def _dist_minibatch_parity(dev, mesh) -> dict:
    """At the bench size (N=1k, E=10k, U=50), one step of the distributed
    minibatch step on the (1,) mesh, in ``dense`` and in ``grouped``,
    against ``MinibatchTrainer.device_step`` on the same batch, negatives
    and initial weights: the Adam-step gate."""
    ei, etexts, feats = mb_graph(BENCH_N, BENCH_E, BENCH_U)
    config, spec = mb_config(), MinibatchSpec(**MB_SPEC)
    init = init_hypergnn(config, torch.Generator().manual_seed(0))
    single = MinibatchTrainer(config, adam(LEARNING_RATE), ei, etexts, feats, spec,
                              device=dev)
    trainer = DistributedMinibatchTrainer(mesh, config, adam(LEARNING_RATE), ei, etexts,
                                          feats, spec, cap_multiple=MB_CAP_MULTIPLE,
                                          device=dev)
    batch = single.sample_batch(np.random.default_rng(3))
    sharded = trainer.shard_batch(batch)
    neg = torch.as_tensor(np.random.default_rng(4).integers(
        0, batch[0].shape[0], spec.batch_size).astype(np.int32), device=dev)
    ref = _fresh(init, dev)
    _, _, ref_loss = single.device_step(ref.params, ref.opt_state, single.to_device(batch),
                                        neg_dst=neg)
    tensors = trainer.to_device(sharded)
    out = dict(reference_backend=_mb_backend(config, batch))
    for contrib in ("dense", "grouped"):
        step = make_composed_minibatch_step(mesh, config, adam(LEARNING_RATE),
                                            sharded[0].nodes_per_shard, contrib=contrib)
        state = _fresh(init, dev)
        _, _, loss = step(state.params, state.opt_state, *tensors[:10],
                          rel_group_sizes=tensors[10], neg_dst=neg)
        out[contrib] = adam_step_errors(
            f"distributed minibatch k=1 contrib={contrib} vs MinibatchTrainer.device_step "
            f"(bench size)", loss, state.params, ref_loss, ref.params)
        del state
    del ref
    torch.cuda.empty_cache()
    return out


def dist_minibatch_steps(label, trainer, state, rng_np, gen, dev, timed: int) -> list:
    """1 warm-up and ``timed`` steps of a ``DistributedMinibatchTrainer``,
    each split into host sampling, the partition and ladder
    (``shard_batch``), the copies of the rank's blocks to the card, and the
    device step (CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    k = trainer.num_shards
    steps = []
    for i in range(1 + timed):
        t0 = time.perf_counter()
        batch = trainer.sample_batch(rng_np)
        t1 = time.perf_counter()
        sharded = trainer.shard_batch(batch)
        t2 = time.perf_counter()
        tensors = trainer.to_device(sharded)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        start.record()
        _, _, loss = trainer.device_step(state.params, state.opt_state, tensors, gen)
        stop.record()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        inputs = sharded[0]
        steps.append(dict(
            loss=loss.item(), sample_ms=(t1 - t0) * 1e3, shard_ms=(t2 - t1) * 1e3,
            h2d_ms=(t3 - t2) * 1e3, device_ms=start.elapsed_time(stop),
            step_wall_ms=(t4 - t3) * 1e3,
            contrib=trainer._pick_contrib(k * inputs.nodes_per_shard,
                                          inputs.char_ids.shape[0]),
            nodes=batch[1].num_nodes, nodes_padded=inputs.feats.shape[0],
            nodes_per_shard=inputs.nodes_per_shard, edges=batch[1].num_edges,
            edge_rows=sharded[2].shape[0], relations_padded=inputs.char_ids.shape[0],
            buckets=len(trainer._dist_steps)))
        s = steps[-1]
        log(f"{label} step {i}{' (warm-up)' if i == 0 else ''}: loss {s['loss']:.6f}; "
            f"host sampling {s['sample_ms']:.1f} ms, partition + ladder {s['shard_ms']:.1f} ms, "
            f"host-to-device {s['h2d_ms']:.2f} ms, device step {s['device_ms']:.2f} ms (CUDA "
            f"events; wall {s['step_wall_ms']:.2f}); contrib {s['contrib']}; nodes "
            f"{s['nodes']:,} of {s['nodes_padded']:,}, edges {s['edges']:,} in "
            f"{s['edge_rows']:,} rows; {s['buckets']} bucket(s)")
    return steps


def medians(steps: list) -> dict:
    return {f"median_{key}": float(np.median([s[key] for s in steps]))
            for key in ("sample_ms", "shard_ms", "h2d_ms", "device_ms", "step_wall_ms")}


def _dist_minibatch_xxl(dev, mesh, mb) -> dict:
    """BASELINE.json config #4 through ``DistributedMinibatchTrainer`` on the
    (1,) mesh at benchmarks/minibatch_xxl.py's shapes (cap_multiple 8192):
    1 warm-up and MB_TIMED timed steps split by stage, peak memory, the
    busy share of one profiled device step, and no kernel launch (the
    minibatch step runs ``dense`` or ``grouped``, as JAX's)."""
    ei, etexts, feats = mb
    config = mb_config()
    t0 = time.perf_counter()
    trainer = DistributedMinibatchTrainer(mesh, config, adam(LEARNING_RATE), ei, etexts,
                                          feats, MinibatchSpec(**MB_SPEC),
                                          cap_multiple=MB_CAP_MULTIPLE, device=dev)
    build_s = time.perf_counter() - t0
    state = create_train_state(
        tree_map(lambda t: t.to(dev),
                 init_hypergnn(config, torch.Generator().manual_seed(0))),
        adam(LEARNING_RATE))
    rng_np, gen = np.random.default_rng(1), torch.Generator(device=dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats(dev)
    with profiling.tally() as counts:
        steps = dist_minibatch_steps("distributed minibatch k=1", trainer, state, rng_np, gen,
                                     dev, MB_TIMED)
    launches = kernel_launches(counts)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    med = medians(steps[1:])
    check(all(np.isfinite(s["loss"]) for s in steps),
          "distributed minibatch: a loss is not finite")
    check(all(s["contrib"] == "grouped" for s in steps),
          "distributed minibatch: _pick_contrib did not pick grouped at xxl, as JAX's does")
    check(not any(launches.values()), f"distributed minibatch: kernels launched: {launches}")
    tensors = trainer.to_device(trainer.sample_batch_sharded(rng_np))
    profile = profile_device("one distributed minibatch device step (k=1)", lambda: (
        trainer.device_step(state.params, state.opt_state, tensors, gen)))
    busy = profile["device_ms"] / med["median_device_ms"]
    log(f"distributed minibatch k=1: trainer built in {build_s:.2f} s; medians over "
        f"{MB_TIMED} steps: sampling {med['median_sample_ms']:.1f} ms, partition + ladder "
        f"{med['median_shard_ms']:.1f} ms, host-to-device {med['median_h2d_ms']:.2f} ms, device "
        f"step {med['median_device_ms']:.2f} ms; peak {peak_gb:.2f} GB; busy "
        f"{100 * busy:.1f}%; kernel launches {launches}")
    del state, tensors
    torch.cuda.empty_cache()
    return dict(build_s=build_s, steps=steps, **med, peak_memory_gb=peak_gb,
                device_busy_share=busy, launches=launches, profile=profile)


def phase_experiments(dev) -> dict:
    """The experiment scripts on the card, their lines sent to stderr:
    ``train_linkpred`` on wn18rr-zeroshot at scale 1.0 (EXP_STEPS steps,
    evaluating every EXP_EVAL_EVERY), ``sweep_zeroshot.run_one`` with K=8,
    the cosine schedule and best-on-valid selection, and the port side of
    ``parity_zeroshot`` at scale 0.1, one seed each: ms/step, MRR and
    zero-shot MRR as readouts, no kernel launch in the models (``grouped``)
    and kernel 1 once a step in the K = 1 losses' backward."""
    t_start = time.perf_counter()
    out = {}
    with profiling.tally() as counts:
        with contextlib.redirect_stdout(sys.stderr):
            r = train_linkpred.run(train_linkpred.parse_args([
                "--dataset", "wn18rr-zeroshot", "--scale", str(EXP_SCALE),
                "--steps", str(EXP_STEPS), "--eval-every", str(EXP_EVAL_EVERY),
                "--device", str(dev)]))
        out["train_linkpred"] = dict(
            steps=r["steps"], ms_per_step=r["train_s"] * 1e3 / r["steps"], eval_s=r["eval_s"],
            final_loss=r["final_loss"], mrr=r["metrics"]["mrr"],
            zero_shot_mrr=r["metrics"].get("zero_shot_mrr"))
        kg = wn18rr_zero_shot_like(seed=0, scale=EXP_SCALE)
        config = HyperGNNConfig(text_dim=TEXT_DIM, node_feat_dim=kg.node_features.shape[1],
                                hidden_dim=WIDTH, num_layers=LAYERS, rel_sorted=True)
        t0 = time.perf_counter()
        row = sweep_zeroshot.run_one(kg, config, EXP_SWEEP_K, EXP_STEPS, LEARNING_RATE, 0,
                                     lr_schedule="cosine", eval_every=EXP_EVAL_EVERY, device=dev)
        out["sweep_zeroshot"] = dict(
            num_negatives=EXP_SWEEP_K, steps=EXP_STEPS, wall_s=time.perf_counter() - t0,
            train_s=row["train_s"], ms_per_step=row["train_s"] * 1e3 / EXP_STEPS,
            final_loss=row["final_loss"], mrr=row["mrr"], zero_shot_mrr=row.get("zero_shot_mrr"),
            sel_mrr=row.get("sel_mrr"), sel_zero_shot_mrr=row.get("sel_zero_shot_mrr"),
            best_step=row.get("best_step"))
        t0 = time.perf_counter()
        row = parity_zeroshot.run_port(wn18rr_zero_shot_like(seed=0, scale=EXP_PARITY_SCALE),
                                       EXP_STEPS, LEARNING_RATE, 0, 1, device=dev)
        out["parity_zeroshot"] = dict(
            scale=EXP_PARITY_SCALE, steps=EXP_STEPS, wall_s=time.perf_counter() - t0,
            train_s=row["train_s"], ms_per_step=row["train_s"] * 1e3 / EXP_STEPS,
            final_loss=row["final_loss"], mrr=row["mrr"], zero_shot_mrr=row.get("zero_shot_mrr"))
    out["launches"] = kernel_launches(counts)
    out["seconds"] = time.perf_counter() - t_start
    for name in ("train_linkpred", "sweep_zeroshot", "parity_zeroshot"):
        e = out[name]
        log(f"experiments {name}: {e['ms_per_step']:.2f} ms/step, final loss "
            f"{e['final_loss']:.4f}, MRR {e['mrr']:.4f}, zero-shot MRR {e['zero_shot_mrr']}")
        check(np.isfinite(e["final_loss"]) and 0.0 < e["mrr"] <= 1.0
              and e["zero_shot_mrr"] is not None,
              f"experiments {name}: a loss is not finite or a metric is missing")
    # No kernel in the models; kernel 1 once a step in the loss's backward
    # of train_linkpred and the parity run (one tail a positive), and the
    # gather kernel twice there (the loss's rows, the permute of its
    # streams); none in the sweep's K = 8 loss.
    want = dict({name: 0 for name in KERNELS}, csr_segment_sum=2 * EXP_STEPS,
                gather_rows=4 * EXP_STEPS)
    check(out["launches"] == want, f"experiments: launches {out['launches']} != {want}")
    log(f"experiments: phase in {out['seconds']:.1f} s (train_linkpred's ms/step without "
        "its evaluations; the sweep's and the parity run's from their rows' train_s, "
        "0.1 s resolution, the sweep's with its two valid evaluations)")
    return out


def main() -> int:
    t_start = time.perf_counter()
    dev = phase_device()
    native = phase_native()
    phase_build()
    g = _kernel_graph()
    measured = phase_kernels(dev, g)
    forms = phase_kernel_forms(dev, g)
    served = phase_serving(dev)
    trained = phase_training(dev)
    # xl-d128 after xl: the kernels line keeps xl's launches.
    xl_d128 = phase_training(dev, 128)
    trained["parity"] = phase_training_parity(dev)
    # The speed mode's path: the xl and xl-d128 steps in bf16 and in one
    # TF32 pass, the speed-mode forward and the bench-size parity.
    speed = {f"{label} d={width}": phase_training(dev, width, mode)
             for label, mode in (("bf16", SPEED), ("precision=default", ONE_PASS))
             for width in (WIDTH, 128)}
    speed["forward"] = phase_speed_forward(dev)
    speed["parity"] = phase_speed_parity(dev)
    two_stream = {d: phase_two_stream(dev, g, d) for d in (64, 128)}
    grouped = phase_grouped(dev)
    dense_chunked = phase_dense_chunked(dev)
    linkpred = phase_linkpred(dev)
    t0 = time.perf_counter()
    mb = mb_graph(MB_N, MB_E, MB_U)
    minibatch = dict(parity=phase_minibatch_parity(dev),
                     xxl=phase_minibatch(dev, mb, time.perf_counter() - t0))
    parallel = phase_parallel(dev, mb)
    del mb
    experiments = phase_experiments(dev)
    if FAILURES:
        log(f"chip_smoke.py: {len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    keys = ("max_abs_err", "dw_scaled_err", "f64_err", "plain_f64_err",
            "f64_scaled_err", "plain_f64_scaled_err", "tol", "ms", "ms_plan_table",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "cuda_core_bound_ms",
            "library_ms", "bmm_ms", "err_vs_exact", "device_launches_per_call",
            "kernel_2_bf16_ms", "host_ms")

    def numbers(r):
        out = {key: r[key] for key in keys if key in r}
        if "dbias" in r:
            out["dbias"] = numbers(r["dbias"])
        return out

    # launches: kernels 1-3 over the timed training steps, kernels 5 and 6
    # in the d=64 two-stream layer (their path); kernel 7 is on no path, as
    # in the JAX package. A form's launches: kernels 5 and 6's in the d=64
    # two-stream layer in that form; the others' over the timed xl steps of
    # the mode that runs the form (bf16: speed mode; tf32:
    # precision="default"; fast: f32, where no caller asks for it, as in the
    # JAX package).
    f32_layer = two_stream[64]["f32"]["launches"]
    path_launches = dict(trained["launches"],
                         edge_transform_sorted=f32_layer["edge_transform_sorted"],
                         segment_outer=f32_layer["segment_outer"])
    step_runs = {"bf16": speed[f"bf16 d={WIDTH}"],
                 "tf32": speed[f"precision=default d={WIDTH}"], "fast": trained}

    def form_launches(name, form):
        if name in ("edge_transform_sorted", "segment_outer"):
            n = two_stream[64][form]["launches_per_form"][name][form]
            return dict(launches=n, launches_per_two_stream_layer=n)
        n = step_runs[form]["launches_per_form"][name][form]
        return dict(launches=n, launches_per_training_step=n // TRAIN_STEPS)

    line = {"kernels": [
        dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=path_launches[name],
            launches_per_training_step=trained["launches"][name] // TRAIN_STEPS,
            launches_per_forward=served["launches"][name] // REQUESTS,
            launches_per_two_stream_layer=f32_layer[name],
            launches_per_grouped_step=grouped["launches"][name],
            launches_per_composed_step=(
                parallel["composed"]["halo/pallas"]["launches"][name] // COMPOSED_TIMED),
            **numbers(measured[(name, 64)]), d128=numbers(measured[(name, 128)]),
        )
        for name, k in KERNELS.items()
    ] + [
        dict(
            name=f"{name}[{form}]", route="cuda", source=KERNELS[name]["source"],
            replaces=replaces, **form_launches(name, form),
            **numbers(forms[(name, form, 64)]), d128=numbers(forms[(name, form, 128)]),
            **({"d_in64_d_out192": numbers(forms[(name, form, 192)])}
               if (name, form, 192) in forms else {}),
        )
        for (name, form), replaces in FORM_REPLACES.items()
    ]}
    # Kernels 1 and 7 on the composed step's k=4 shard (the parallel phase).
    shard = parallel["composed"]["shard_streams_k4"]
    for entry in line["kernels"]:
        if entry["name"] == "csr_segment_sum":
            entry["composed_shard_k4"] = {n: numbers(r) for n, r in shard.items()
                                          if n != "kernel_7"}
        elif entry["name"] == "dual_sorted_segment_sum":
            entry["composed_shard_k4"] = numbers(shard["kernel_7"])
    print(json.dumps({"serving": served["latencies"], "profile": served["profile"]}))
    print(json.dumps({"training": trained, "training_xl_d128": xl_d128}))
    print(json.dumps({"speed_mode": speed}))
    print(json.dumps({"two_stream": two_stream, "grouped": grouped,
                      "dense_chunked": dense_chunked}))
    print(json.dumps({"native": native, "encode_stages": served["encode_stages"],
                      "linkpred": linkpred, "minibatch": minibatch}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"experiments": experiments}))
    log(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
