"""Rank bodies of the port's distributed minibatch tests, run on k gloo
ranks by ``torch_parallel_ranks.spawn("torch_parallel_ranks_mb:<body>",
...)``. Imports no JAX: the test file computes the JAX package's results
and hands the inputs over as an ``.npz``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.training.minibatch import (
    DistributedMinibatchTrainer,
    MinibatchSpec,
    MinibatchTrainer,
    make_composed_minibatch_step,
)
from graph_hypernetwork_forge_tpu_torch.training.train import adam, create_train_state
from torch_parallel_ranks import _case, _t, _unflatten
from torch_parallel_ranks_cd import _dump, _error

# The sharded batch's arrays after ``inputs``, by name.
BATCH_FIELDS = ("feats", "src", "dst", "rel", "mask", "chars", "lens", "pos_src", "pos_dst",
                "pos_mask", "rel_group_sizes")
SEED_BATCH = 11


def _graph(c: dict):
    return c["ei"], [str(t) for t in c["texts"]], c["feats"]


def _config(c: dict) -> HyperGNNConfig:
    text_dim, feat, hidden, layers = (int(x) for x in c["dims"])
    return HyperGNNConfig(text_dim=text_dim, node_feat_dim=feat, hidden_dim=hidden,
                          num_layers=layers)


def _spec(c: dict, **kw) -> MinibatchSpec:
    batch, f1, f2, bucket = (int(x) for x in c["spec"])
    return MinibatchSpec(**{**dict(batch_size=batch, fanouts=(f1, f2),
                                   node_bucket_multiple=bucket), **kw})


def _state(c: dict, name: str, lr: float):
    return create_train_state(params_from_jax(_unflatten(_case(c, name))), adam(lr))


def _dump_step(res: dict, prefix: str, loss, params) -> None:
    res[f"{prefix}/loss"] = np.array([float(loss)])
    _dump(res, f"{prefix}/param", params)
    _dump(res, f"{prefix}/grad", params, grad=True)


def distributed_minibatch(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("edge",), device_type="cpu")
    c = _case(inputs, "step")
    lr = float(c["lr"])
    config, spec = _config(c), _spec(c)
    args = (config, adam(lr), *_graph(c))
    trainer = DistributedMinibatchTrainer(mesh, *args, spec, device="cpu")
    sharded = trainer.sample_batch_sharded(np.random.default_rng(SEED_BATCH))
    res = {"batch/nodes_per_shard": np.int64(sharded[0].nodes_per_shard)}
    for name, a in zip(BATCH_FIELDS, sharded[1:]):
        res[f"batch/{name}"] = np.asarray(a)
    tensors = trainer.to_device(sharded)
    neg = _t(c["neg"])
    npp = sharded[0].nodes_per_shard

    # The step itself, JAX's negatives, in both contributions.
    for contrib in ("dense", "grouped"):
        step = make_composed_minibatch_step(mesh, config, adam(lr), npp, contrib=contrib)
        state = _state(c, "params", lr)
        _, _, loss = step(state.params, state.opt_state, *tensors[:10],
                          rel_group_sizes=tensors[10], neg_dst=neg)
        _dump_step(res, contrib, loss, state.params)

    # The trainer's step and the single-card trainer's on the same batch:
    # the same negatives handed in, then the same generator's draw.
    single = MinibatchTrainer(*args, spec, device="cpu")
    batch = single.to_device(single.sample_batch(np.random.default_rng(SEED_BATCH)))
    for prefix, tr, data in (("single", single, batch), ("trainer", trainer, tensors)):
        state = _state(c, "params", lr)
        _, _, loss = tr.device_step(state.params, state.opt_state, data, neg_dst=neg)
        _dump_step(res, prefix, loss, state.params)
        state = _state(c, "params", lr)
        _, _, loss = tr.device_step(state.params, state.opt_state, data,
                                    torch.Generator().manual_seed(4))
        res[f"{prefix}/gen_loss"] = np.array([float(loss)])

    # Ten steps of the trainer on another graph (JAX's k=2 case).
    t = _case(inputs, "train")
    trainer = DistributedMinibatchTrainer(mesh, _config(t), adam(float(t["lr"])),
                                          *_graph(t), _spec(t), device="cpu")
    state = _state(t, "params", float(t["lr"]))
    params, opt_state = state.params, state.opt_state
    rng_np, gen = np.random.default_rng(0), torch.Generator().manual_seed(1)
    losses = []
    for _ in range(10):
        params, opt_state, loss = trainer.step(params, opt_state, rng_np, gen)
        losses.append(float(loss))
    res["train/losses"] = np.array(losses)
    res["train/buckets"] = np.int64(len(trainer._dist_steps))

    # The refusals.
    odd = 30 if k == 4 else 31
    res["err/batch_size"] = np.array(_error(lambda: DistributedMinibatchTrainer(
        mesh, *args, _spec(c, batch_size=odd), device="cpu")))
    res["err/node_bucket"] = np.array(_error(lambda: DistributedMinibatchTrainer(
        mesh, *args, _spec(c, node_bucket_multiple=128 * k + 1), device="cpu")))
    step = make_composed_minibatch_step(mesh, config, adam(lr), npp, contrib="grouped")
    state = _state(c, "params", lr)
    res["err/grouped_no_sizes"] = np.array(_error(lambda: step(
        state.params, state.opt_state, *tensors[:10], neg_dst=neg)))
    res["err/cuda"] = np.array(_error(lambda: make_composed_minibatch_step(
        mesh, config, adam(lr), npp, contrib="cuda")))
    res["err/no_negatives"] = np.array(_error(lambda: make_composed_minibatch_step(
        mesh, config, adam(lr), npp)(state.params, state.opt_state, *tensors[:10])))
    return res
