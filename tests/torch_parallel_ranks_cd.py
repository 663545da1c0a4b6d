"""Rank bodies of the port's ``parallel/`` slices C and D tests (tensor
parallelism, the pipeline, the composed steps, the sharded train step),
run on k gloo ranks by ``torch_parallel_ranks.spawn("torch_parallel_ranks_cd:
<body>", ...)``. Imports no JAX: the test files compute the JAX package's
results and hand the inputs over as an ``.npz``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from graph_hypernetwork_forge_tpu_torch.convert import (
    params_from_jax,
    weight_generator_from_jax,
)
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import WeightGeneratorConfig
from graph_hypernetwork_forge_tpu_torch.parallel import collectives as coll
from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
    composed_forward,
    local_inputs,
    make_composed_train_step,
    prepare_composed_inputs,
)
from graph_hypernetwork_forge_tpu_torch.parallel.composed_tp import (
    composed_tp_param_specs,
    make_composed_tp_train_step,
    shard_composed_tp_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh
from graph_hypernetwork_forge_tpu_torch.parallel.pipeline import (
    make_pipelined_train_step,
    pipelined_forward,
    stack_layer_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import (
    hypergnn_param_shardings,
    shard_graph_arrays,
    shard_params,
)
from graph_hypernetwork_forge_tpu_torch.parallel.tensor_parallel import (
    bank_shard_bytes,
    shard_generator_params,
    tp_generate_weights,
    tp_head_specs,
    tp_message_passing,
    tp_param_specs,
)
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    create_train_state,
    make_train_step,
)
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves, tree_map
from torch_parallel_ranks import _case, _leaf, _placement_names, _t, _unflatten

LR = 1e-2


def _leaves(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def _dump(res: dict, prefix: str, tree, grad: bool = False) -> None:
    for path, t in named_leaves(tree):
        res[f"{prefix}/{path}"] = (t.grad if grad else t.detach()).numpy()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _graph(c: dict):
    """The port's encoding of a case's raw edges (texts ``relation kind i``),
    the same arrays as the JAX package's."""
    texts = [f"relation kind {i}" for i in c["ridx"]]
    return encode_graph(c["ei"], texts, int(c["n"]))


def _config(c: dict, **kw) -> HyperGNNConfig:
    text_dim, feat, hidden, layers = (int(x) for x in c["dims"])
    return HyperGNNConfig(text_dim=text_dim, node_feat_dim=feat, hidden_dim=hidden,
                          num_layers=layers, dropout=float(c["dropout"]), **kw)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def tp(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("model",), device_type="cpu")
    me = coll.axis_index(mesh, "model")
    res = {}
    for case in ("gen", "mp"):
        c = _case(inputs, case)
        text_dim, d, hidden = (int(x) for x in c["dims"])
        cfg = WeightGeneratorConfig(text_dim=text_dim, d_in=d, d_out=d, hidden_dim=hidden)
        whole = weight_generator_from_jax(_unflatten(_case(c, "params")))
        blocks = _leaves(shard_generator_params(whole, cfg, mesh))
        text = _leaf(c["text"])
        out = tp_generate_weights(mesh, cfg, blocks, text)
        rows = slice(me * d // k, (me + 1) * d // k)
        if case == "gen":
            loss = sum((out[n] * _t(c[f"r_{n}"][:, rows])).sum() for n in ("W_msg", "W_self"))
            (loss + (out["bias"] * _t(c["r_bias"])).sum()).backward()
            for n, v in out.items():
                res[f"gen/out/{n}"] = v.detach().numpy()
            _dump(res, "gen/grad", blocks, grad=True)
            _dump(res, "gen/block", blocks)
            res["gen/dtext"] = text.grad.numpy()
            res["gen/bank_bytes"] = np.int64(bank_shard_bytes(out))
            res["gen/w3_bytes"] = np.int64(blocks["heads"]["W_msg"][-1]["w"].numel() * 4)
            for path, pl in named_leaves(tp_param_specs(cfg, mesh)):
                res[f"gen/placement/{path}"] = np.array(_placement_names(pl))
            continue
        h = _leaf(c["h"])
        w = {n: _leaf(v.detach().numpy()) for n, v in out.items()}
        got = tp_message_passing(mesh, h, _t(c["src"]), _t(c["dst"]), _t(c["rel"]), w,
                                 h.shape[0])
        (got * _t(c["r"])).sum().backward()
        res["mp/out"] = got.detach().numpy()
        res["mp/dh"] = h.grad.numpy()
        for n, v in w.items():
            res[f"mp/d{n}"] = v.grad.numpy()
    res["err/hidden3"] = np.array(_error(lambda: tp_head_specs(
        WeightGeneratorConfig(text_dim=8, d_in=8, d_out=8, num_hidden=3), mesh)))
    odd = WeightGeneratorConfig(text_dim=8, d_in=k + 1, d_out=4, hidden_dim=2 * k)
    res["err/divide"] = np.array(_error(lambda: shard_generator_params({}, odd, mesh)))
    return res


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def pipeline(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("pipe",), device_type="cpu")
    one = make_mesh((1, k), ("pipe", "data"), device_type="cpu")
    batch = [_t(inputs[f"mb/{i}"]) for i in range(7)]
    res = {}
    c4 = _case(inputs, "p4")
    config = _config(c4)
    p4 = params_from_jax(_unflatten(_case(c4, "params")))

    params = _leaves(p4)
    out = pipelined_forward(mesh, config, params, *batch)
    res["fwd4"] = out.detach().numpy()
    out.square().sum().backward()
    _dump(res, "grad", params, grad=True)
    for path, t in named_leaves(dict(zip(("gens", "norms"), stack_layer_params(p4)))):
        res[f"stacked/{path}"] = t.numpy()

    state = create_train_state(p4, adam(LR))
    step = make_pipelined_train_step(mesh, config, adam(LR))
    _, _, loss = step(state.params, state.opt_state, *batch, torch.Generator(),
                      neg_dst=_t(inputs["neg"]))
    res["step/loss"] = loss.numpy()
    _dump(res, "step/param", state.params)

    with torch.no_grad():
        for name in ("p8", "remat", "eval_dropout"):
            c = _case(inputs, name)
            res[name] = pipelined_forward(
                mesh, _config(c, remat=bool(c["remat"])),
                params_from_jax(_unflatten(_case(c, "params"))), *batch).numpy()
        # Dropout masks depend on (microbatch, global layer) only: the same
        # generator gives the same output over k stages and over one.
        drop = _config(_case(inputs, "eval_dropout"))
        pd = params_from_jax(_unflatten(_case(_case(inputs, "eval_dropout"), "params")))
        for name, m in (("stages", mesh), ("one_stage", one)):
            res[f"dropout/{name}"] = pipelined_forward(
                m, drop, pd, *batch, train=True, gen=torch.Generator().manual_seed(5)).numpy()
    # Remat recomputes each layer with the masks drawn for its forward.
    for remat in (False, True):
        leaves = _leaves(pd)
        out = pipelined_forward(mesh, dataclasses.replace(drop, remat=remat), leaves, *batch,
                                train=True, gen=torch.Generator().manual_seed(7))
        out.square().sum().backward()
        _dump(res, f"remat_dropout/{remat}", leaves, grad=True)
    for seed in (10, 11):
        state = create_train_state(pd, adam(LR))
        step = make_pipelined_train_step(mesh, drop, adam(LR))
        _, _, loss = step(state.params, state.opt_state, *batch,
                          torch.Generator().manual_seed(seed))
        res[f"dropout/loss{seed}"] = loss.numpy()
    bad = dataclasses.replace(config, num_layers=k + 1)
    res["err/indivisible"] = np.array(_error(
        lambda: pipelined_forward(mesh, bad, p4, *batch)))
    return res


# ---------------------------------------------------------------------------
# The composed step
# ---------------------------------------------------------------------------


def _composed_run(c: dict, mesh, k: int, *, halo: bool, neg, contrib: str = "dense",
                  steps: int = 1, gen_seed: int = 0, **prep) -> dict:
    """One composed step (or ``steps``) from the case's JAX parameters: the
    loss and the parameters after Adam."""
    config = _config(c)
    inputs = prepare_composed_inputs(_graph(c), c["feats"], k, halo=halo, **prep)
    arrays, kw = local_inputs(inputs, mesh)
    kernel = contrib in ("pallas", "pallas_packed", "cuda")
    agg_sorted = kernel or bool(c.get("agg_sorted", 0))
    if not agg_sorted:
        kw.pop("agg_plan", None)
    if not kernel:
        kw.pop("kernel_plan", None)
    sched = inputs.sched_round_perms if prep.get("scheduled") else None
    step = make_composed_train_step(
        mesh, config, adam(LR), inputs.nodes_per_shard, num_nodes=inputs.num_nodes,
        halo_width=inputs.halo_width if halo else None, contrib=contrib,
        agg_sorted=agg_sorted, scheduled_rounds=sched,
    )
    state = create_train_state(params_from_jax(_unflatten(_case(c, "params"))), adam(LR))
    gen = torch.Generator().manual_seed(gen_seed)
    losses = []
    for _ in range(steps):
        _, _, loss = step(state.params, state.opt_state, *arrays, gen, neg=neg, **kw)
        losses.append(float(loss))
    return dict(loss=np.array(losses), params=state.params)


def _dump_step(res: dict, prefix: str, params) -> None:
    """The parameters after the step and the gradients it took."""
    _dump(res, f"{prefix}/param", params)
    _dump(res, f"{prefix}/grad", params, grad=True)


def _shift(c: dict, mesh):
    return int(c["shifts"][coll.axis_index(mesh, "edge")]) if "shifts" in c else None


def _neg_block(c: dict, mesh):
    return coll.local_block(_t(c["neg"]), mesh, "edge") if "neg" in c else None


def composed(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("edge",), device_type="cpu")
    res = {}
    c = _case(inputs, "fwd")
    with torch.no_grad():
        inputs_fwd = prepare_composed_inputs(_graph(c), c["feats"], k, halo=False)
        res["fwd/rows"] = composed_forward(
            mesh, _config(c), params_from_jax(_unflatten(_case(c, "params"))),
            inputs_fwd).numpy()
    runs = {
        "dense": dict(halo=False),
        "halo": dict(halo=True),
        "scheduled": dict(halo=True, scheduled=True),
    }
    for name, kw in runs.items():
        c = _case(inputs, name)
        neg = _neg_block(c, mesh) if name == "dense" else _shift(c, mesh)
        out = _composed_run(c, mesh, k, neg=neg, **kw)
        res[f"{name}/loss"] = out["loss"]
        _dump_step(res, name, out["params"])
    c = _case(inputs, "dropout")
    for seed in (1, 2):
        out = _composed_run(c, mesh, k, halo=False, neg=None, gen_seed=seed)
        res[f"dropout/loss{seed}"] = out["loss"]
        _dump(res, f"dropout/param{seed}", out["params"])
    out = _composed_run(_case(inputs, "train"), mesh, k, halo=False, neg=None, steps=12)
    res["train/losses"] = out["loss"]
    config = _config(_case(inputs, "dense"))
    for name, kw in (
        ("local_roll_dense", dict(neg_mode="local_roll")),
        ("unknown_neg", dict(neg_mode="nope")),
        ("unknown_contrib", dict(contrib="nope", halo_width=8)),
        ("kernel_unsorted", dict(contrib="pallas", halo_width=8)),
        ("kernel_dense_v1", dict(contrib="cuda", agg_sorted=True)),
    ):
        res[f"err/{name}"] = np.array(_error(
            lambda kw=kw: make_composed_train_step(mesh, config, adam(LR), 8, **kw)))
    return res


def composed_kernels(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("edge",), device_type="cpu")
    res = {}
    c = _case(inputs, "grouped")
    out = _composed_run(c, mesh, k, halo=True, neg=_shift(c, mesh), contrib="grouped",
                        rel_sort_local=True)
    res["grouped/loss"] = out["loss"]
    _dump_step(res, "grouped", out["params"])
    c = _case(inputs, "agg")
    out = _composed_run(c, mesh, k, halo=True, neg=_shift(c, mesh))
    res["agg/loss"] = out["loss"]
    _dump_step(res, "agg", out["params"])
    c = _case(inputs, "kernel")
    for contrib in ("pallas_packed", "pallas", "cuda", "grouped"):
        out = _composed_run(c, mesh, k, halo=True, neg=_shift(c, mesh), contrib=contrib,
                            rel_sort_local=True, group_pad=256)
        res[f"kernel/{contrib}/loss"] = out["loss"]
        _dump_step(res, f"kernel/{contrib}", out["params"])
    return res


# ---------------------------------------------------------------------------
# The 2D composed step
# ---------------------------------------------------------------------------


def composed_tp(inputs: dict) -> dict:
    k = dist.get_world_size()
    k_e, k_m = k // 2, 2
    mesh = make_mesh((k_e, k_m), ("edge", "model"), device_type="cpu")
    res = {"coordinate": np.array(mesh.get_coordinate())}
    for name in ("grouped", "dense", "dropout"):
        c = _case(inputs, name)
        config = _config(c)
        contrib = "grouped" if name == "grouped" else "dense"
        inputs_h = prepare_composed_inputs(_graph(c), c["feats"], k_e, halo=True,
                                           rel_sort_local=contrib == "grouped")
        arrays, kw = local_inputs(inputs_h, mesh)
        kw.pop("agg_plan")
        if contrib == "dense":
            kw.pop("rel_group_sizes", None)
        shift = _shift(c, mesh)
        whole = params_from_jax(_unflatten(_case(c, "params")))
        me_e = coll.axis_index(mesh, "edge")
        for dims, params, make in (
            ("1d", whole, lambda: make_composed_train_step(
                mesh, config, adam(LR), inputs_h.nodes_per_shard,
                halo_width=inputs_h.halo_width, contrib=contrib)),
            ("2d", shard_composed_tp_params(whole, config, mesh), lambda: (
                make_composed_tp_train_step(
                    mesh, config, adam(LR), inputs_h.nodes_per_shard,
                    halo_width=inputs_h.halo_width, contrib=contrib))),
        ):
            state = create_train_state(params, adam(LR))
            # Generators seeded by the edge index: the coordinated draw.
            gen = torch.Generator().manual_seed(100 + me_e)
            _, _, loss = make()(state.params, state.opt_state, *arrays, gen, neg=shift,
                                **kw)
            res[f"{name}/{dims}/loss"] = loss.numpy()
            _dump_step(res, f"{name}/{dims}", state.params)
    shard = shard_composed_tp_params(whole, config, mesh)
    for n in ("W_msg", "W_self"):
        res[f"bank_bytes/{n}"] = np.int64(
            shard["weight_generators"][0]["heads"][n][-1]["w"].numel() * 4)
    for path, pl in named_leaves(composed_tp_param_specs(config, mesh)):
        res[f"placement/{path}"] = np.array(_placement_names(pl))
    res["err/no_halo"] = np.array(_error(lambda: make_composed_tp_train_step(
        mesh, config, adam(LR), 8, halo_width=None)))
    res["err/contrib"] = np.array(_error(lambda: make_composed_tp_train_step(
        mesh, config, adam(LR), 8, halo_width=2, contrib="pallas")))
    return res


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def sharded_step(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k // 2, 2) if k == 4 else (k,), device_type="cpu")
    c = _case(inputs, "step")
    config = _config(c)
    graph = _graph(c)
    params = shard_params(params_from_jax(_unflatten(_case(c, "params"))), config, mesh)
    state = create_train_state(params, adam(1e-3))
    arrays = shard_graph_arrays(graph.arrays, mesh)
    step = make_train_step(config)
    res = {}
    _, _, loss = step(state.params, state.opt_state, _t(c["feats"]), *arrays,
                      torch.Generator(), neg_dst=_t(c["neg"]))
    res["loss"] = loss.numpy()
    placements = dict(named_leaves(hypergnn_param_shardings(config, mesh)))
    for path, t in named_leaves(state.params):
        # Copies: the speed-mode step below updates the shards in place.
        res[f"step/param/{path}"] = t.full_tensor().detach().numpy().copy()
        res[f"step/grad/{path}"] = t.grad.full_tensor().numpy().copy()
        res[f"local/{path}"] = t.to_local().detach().numpy().copy()
        res[f"placement/{path}"] = np.array(_placement_names(t.placements))
        res[f"want_placement/{path}"] = np.array(_placement_names(placements[path]))
    # The speed mode under the same sharded step (__graft_entry__.py:112-120).
    bf = make_train_step(dataclasses.replace(config, compute_dtype="bfloat16"))
    _, _, res["bf16_loss"] = bf(state.params, state.opt_state, _t(c["feats"]), *arrays,
                                torch.Generator().manual_seed(2))
    res["bf16_loss"] = res["bf16_loss"].numpy()
    return res
