"""Rank bodies of the port's ``parallel/`` tests, run on k gloo ranks.

The test files compute the JAX package's results on the conftest's virtual
CPU devices in the pytest process. They hand the inputs to :func:`spawn`
as an ``.npz``; it starts k processes, which meet through a file in the
test's temporary directory (no port, so parallel test workers cannot
clash), run one body of :data:`BODIES` over every case of the file, and
write each rank's outputs to an ``.npz`` that the tests compare. The
children import this module, so it imports no JAX and nothing of the
conftest.
"""

from __future__ import annotations

import importlib
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from graph_hypernetwork_forge_tpu_torch.convert import (
    params_from_jax,
    text_encoder_from_jax,
    weight_generator_from_jax,
)
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.models.text_encoder import apply_text_encoder
from graph_hypernetwork_forge_tpu_torch.models.weight_generator import (
    WeightGeneratorConfig,
    apply_weight_generator,
)
from graph_hypernetwork_forge_tpu_torch.parallel import collectives as coll
from graph_hypernetwork_forge_tpu_torch.parallel.data_parallel import make_data_parallel_step
from graph_hypernetwork_forge_tpu_torch.parallel.edge_partition import (
    edge_partitioned_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.parallel.halo import (
    build_halo_plan,
    build_scheduled_halo_plan,
    halo_message_passing,
    scheduled_halo_message_passing,
)
from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh, mesh_axis_size
from graph_hypernetwork_forge_tpu_torch.parallel.node_partition import (
    node_partitioned_message_passing,
    partition_edges_by_dst,
)
from graph_hypernetwork_forge_tpu_torch.parallel.relation_sharding import (
    relation_sharded_generate,
)
from graph_hypernetwork_forge_tpu_torch.parallel.sharding import (
    hypergnn_param_shardings,
    replicate,
    shard_graph_arrays,
    shard_params,
)
from graph_hypernetwork_forge_tpu_torch.training.train import adam, create_train_state
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves, tree_map

SPAWN_TIMEOUT_S = 240


def spawn(body: str, world: int, workdir: Path, inputs: dict) -> list[dict]:
    """Run ``BODIES[body]`` (or ``"module:function"``) on ``world`` gloo
    ranks over ``inputs`` (numpy arrays by name); return each rank's
    outputs, in rank order."""
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    procs = mp.start_processes(
        _entry, args=(world, str(workdir), body), nprocs=world, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{body} on {world} ranks ran over {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as f:
            outs.append(dict(f))
    return outs


def _entry(rank: int, world: int, workdir: str, body: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world,
    )
    try:
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inputs = dict(f)
        out = _body(body)(inputs)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _body(name: str):
    """``BODIES[name]``, or ``module:function`` of another rank-body module
    on the test path."""
    if ":" not in name:
        return BODIES[name]
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf(a) -> torch.Tensor:
    return _t(a).requires_grad_(True)


def _case(inputs: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + "/")}


def _unflatten(flat: dict) -> dict:
    """A nested tree of numpy arrays from ``named_leaves`` paths (digits are
    list indices)."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, last = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(tree)


# ---------------------------------------------------------------------------
# Collectives and the four forms of message passing
# ---------------------------------------------------------------------------


def _grads_out(out: torch.Tensor, leaves: dict) -> dict:
    res = {"out": out.detach().numpy()}
    for name, t in leaves.items():
        res[f"d{name}"] = t.grad.numpy()
    return res


def _collective(fn, c: dict, mesh, rows_in: int, replicated: bool) -> dict:
    x = _leaf(coll.local_block(_t(c["x"][:rows_in]), mesh, "edge").numpy())
    out = fn(x)
    if replicated:
        r = _t(c["r"][: out.shape[0]])
    else:
        r = coll.local_block(_t(c["r"][: out.shape[0] * mesh.size()]), mesh, "edge")
    (out * r).sum().backward()
    return {"out": out.detach().numpy(), "dx": x.grad.numpy()}


def _passing_collectives(inputs: dict, mesh, k: int) -> dict:
    c = _case(inputs, "coll")
    me = coll.axis_index(mesh, "edge")
    res = {}
    cases = {
        "psum": (lambda x: coll.psum(x, mesh, "edge"), 2 * k, True),
        "all_gather": (lambda x: coll.all_gather(x, mesh, "edge"), 2 * k, True),
        "all_to_all": (lambda x: coll.all_to_all(x, mesh, "edge"), 2 * k * k, False),
        "ppermute_ring": (lambda x: coll.ppermute(
            x, mesh, "edge", [(i, (i + 1) % k) for i in range(k)]), 2 * k, False),
        "ppermute_one_pair": (lambda x: coll.ppermute(x, mesh, "edge", [(0, 1)]), 2 * k,
                              False),
    }
    for name, (fn, rows, replicated) in cases.items():
        for key, v in _collective(fn, c, mesh, rows, replicated).items():
            res[f"{name}/{key}"] = v
    # copy: a replicated weight in per-rank products of the rank's rows.
    w = _leaf(c["w"])
    x = coll.local_block(_t(c["x"][: 2 * k]), mesh, "edge")
    out = x @ coll.copy(w, mesh, "edge")
    (out * _t(c["rw"][2 * me:][:2])).sum().backward()
    res["copy/out"], res["copy/dw"] = out.detach().numpy(), w.grad.numpy()
    return res


def _weights(c: dict) -> dict:
    return {"wm": _leaf(c["wm"]), "ws": _leaf(c["ws"]), "b": _leaf(c["b"])}


def _edge(c: dict, mesh, masked: bool) -> dict:
    h, w = _leaf(c["h"]), _weights(c)
    blk = lambda a: coll.local_block(_t(a), mesh, "edge")  # noqa: E731
    out = edge_partitioned_message_passing(
        mesh, h, blk(c["src"]), blk(c["dst"]), blk(c["rel"]), w["wm"], w["ws"], w["b"],
        edge_mask=blk(c["mask"]) if masked else None,
    )
    (out * _t(c["r"][: out.shape[0]])).sum().backward()
    return _grads_out(out, dict(h=h, **w))


def _padded_rows(c: dict, n_pad: int, mesh, rows=None) -> torch.Tensor:
    h = np.zeros((n_pad, c["h"].shape[1]), np.float32)
    h[: c["h"].shape[0]] = c["h"] if rows is None else c["h"][rows]
    return _leaf(coll.local_block(_t(h), mesh, "edge").numpy())


def _local_loss(out: torch.Tensor, c: dict, mesh) -> None:
    n_pad = out.shape[0] * mesh.size()
    r = coll.local_block(_t(c["r"][:n_pad]), mesh, "edge")
    (out * r).sum().backward()


def _node(c: dict, mesh, k: int) -> dict:
    p_src, p_dst, p_rel, p_mask, npp = partition_edges_by_dst(
        c["src"], c["dst"], c["rel"], c["mask"], c["h"].shape[0], k
    )
    h, w = _padded_rows(c, npp * k, mesh), _weights(c)
    blk = lambda a: coll.local_block(_t(a), mesh, "edge")  # noqa: E731
    out = node_partitioned_message_passing(
        mesh, h, blk(p_src), blk(p_dst), blk(p_rel), w["wm"], w["ws"], w["b"],
        blk(p_mask), npp,
    )
    _local_loss(out, c, mesh)
    return _grads_out(out, dict(h=h, **w))


def _halo(c: dict, mesh, k: int) -> dict:
    plan = build_halo_plan(c["src"], c["dst"], c["rel"], c["mask"], c["h"].shape[0], k)
    h = _padded_rows(c, plan.nodes_per_shard * k, mesh, c.get("rows"))
    w = _weights(c)
    out = halo_message_passing(
        mesh, h, [coll.local_block(_t(a), mesh, "edge") for a in plan.edge_arrays],
        coll.local_block(_t(plan.send_idx), mesh, "edge"), w["wm"], w["ws"], w["b"],
        plan.nodes_per_shard, plan.halo_width,
    )
    _local_loss(out, c, mesh)
    return _grads_out(out, dict(h=h, **w))


def _scheduled(c: dict, mesh, k: int) -> dict:
    plan = build_scheduled_halo_plan(
        c["src"], c["dst"], c["rel"], c["mask"], c["h"].shape[0], k
    )
    h, w = _padded_rows(c, plan.nodes_per_shard * k, mesh), _weights(c)
    out = scheduled_halo_message_passing(mesh, h, plan, w["wm"], w["ws"], w["b"])
    _local_loss(out, c, mesh)
    return dict(_grads_out(out, dict(h=h, **w)), rounds=np.int64(plan.num_rounds))


PASSING_CASES = {
    "edge": lambda c, mesh, k: _edge(c, mesh, masked=False),
    "edge_masked": lambda c, mesh, k: _edge(c, mesh, masked=True),
    "node": _node,
    "halo": _halo,
    "halo_isolated": _halo,
    "halo_relabeled": _halo,
    "scheduled": _scheduled,
    "scheduled_local": _scheduled,
}


def passing(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("edge",), device_type="cpu")
    res = {f"coll/{key}": v for key, v in _passing_collectives(inputs, mesh, k).items()}
    for name, fn in PASSING_CASES.items():
        for key, v in fn(_case(inputs, name), mesh, k).items():
            res[f"{name}/{key}"] = v
    return res


# ---------------------------------------------------------------------------
# Meshes, placements, DTensors and relation sharding
# ---------------------------------------------------------------------------


def _placement_names(placements) -> str:
    return ",".join(str(p) for p in placements)


def sharding(inputs: dict) -> dict:
    k = dist.get_world_size()
    res = {}
    default = make_mesh(device_type="cpu")
    res["default_mesh"] = np.array([",".join(default.mesh_dim_names), str(default.size())])
    mesh = make_mesh((2, 2) if k == 4 else (2,), device_type="cpu")
    res["mesh_names"] = np.array(list(mesh.mesh_dim_names))
    res["coordinate"] = np.array(mesh.get_coordinate())
    res["axis_sizes"] = np.array([mesh_axis_size(mesh, a) for a in ("edge", "model", "data")])

    config = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16, num_layers=2)
    params = params_from_jax(_unflatten(_case(inputs, "params")))
    placements = dict(named_leaves(hypergnn_param_shardings(config, mesh)))
    for path, t in named_leaves(shard_params(params, config, mesh)):
        res[f"param/{path}"] = t.to_local().numpy()
        res[f"placement/{path}"] = np.array(_placement_names(placements[path]))
    graph = [inputs[f"graph/{i}"] for i in range(6)]
    for i, t in enumerate(shard_graph_arrays(graph, mesh)):
        res[f"graph/{i}"] = t.to_local().numpy()
        res[f"graph_placement/{i}"] = np.array(_placement_names(t.placements))
    for path, t in named_leaves(replicate({"a": _t(inputs["graph/4"])}, mesh)):
        res[f"replicated/{path}"] = t.to_local().numpy()
        res[f"replicated_placement/{path}"] = np.array(_placement_names(t.placements))

    # Relation sharding on a 1-axis "model" mesh, against the same rank's
    # generation of every row at once.
    model = make_mesh((k,), ("model",), device_type="cpu")
    wg_cfg = WeightGeneratorConfig(text_dim=16, d_in=8, d_out=8, hidden_dim=32)
    te = tree_map(lambda t: t.requires_grad_(True),
                  text_encoder_from_jax(_unflatten(_case(inputs, "te"))))
    wg = tree_map(lambda t: t.requires_grad_(True),
                  weight_generator_from_jax(_unflatten(_case(inputs, "wg"))))
    chars, lens = _t(inputs["rel/chars"]), _t(inputs["rel/lens"])
    banks = relation_sharded_generate(
        model, wg_cfg, te, wg, coll.local_block(chars, model, "model"),
        coll.local_block(lens, model, "model"),
    )
    whole = apply_weight_generator(wg_cfg, wg, apply_text_encoder(te, chars, lens))
    for name in banks:
        res[f"banks/{name}"] = banks[name].detach().numpy()
        res[f"single/{name}"] = whole[name].detach().numpy()
    sum((banks[n] * _t(inputs[f"rel/r_{n}"])).sum() for n in banks).backward()
    for path, t in named_leaves({"te": te, "wg": wg}):
        res[f"grad/{path}"] = t.grad.numpy()
    return res


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------


def data_parallel(inputs: dict) -> dict:
    k = dist.get_world_size()
    mesh = make_mesh((k,), ("data",), device_type="cpu")
    blk = lambda a: coll.local_block(_t(a), mesh, "data")  # noqa: E731
    batch = [blk(inputs[f"batch/{i}"]) for i in range(7)]
    res = {}
    for name, dropout, neg in (("parity", 0.0, blk(inputs["neg"])), ("dropout", 0.1, None)):
        config = HyperGNNConfig(text_dim=16, node_feat_dim=8, hidden_dim=16,
                                num_layers=2, dropout=dropout)
        optimizer = adam(1e-2)
        state = create_train_state(params_from_jax(_unflatten(_case(inputs, "params"))),
                                   optimizer)
        step = make_data_parallel_step(mesh, config, optimizer)
        gen = torch.Generator().manual_seed(100 + dist.get_rank())
        params, _, loss = step(state.params, state.opt_state, *batch, gen, neg=neg)
        res[f"{name}/loss"] = loss.numpy()
        for path, t in named_leaves(params):
            res[f"{name}/param/{path}"] = t.detach().numpy()
    return res


BODIES = {"passing": passing, "sharding": sharding, "data_parallel": data_parallel}
