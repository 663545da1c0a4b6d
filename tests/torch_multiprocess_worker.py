"""One rank of the port's composed training across processes, with a host
drop and a resume from a checkpoint: the twin of
``tests/multiprocess_composed_worker.py``.

Started once per rank by ``tests/test_torch_multiprocess.py``; the ranks
meet through a ``file://`` path over gloo. It runs the composed step
(relation sharding, halo node partition, local scoring, Adam;
``parallel/composed.py``) for 6 steps, step s taking this rank's rotation
``shifts[s, rank]`` (the JAX run's draws, handed in), so a resumed run
replays the same trajectory. Imports no JAX.

Modes:

- ``train``: all 6 steps; rank 0 checkpoints after step 2 (the port's
  ``training/checkpoint.py``);
- ``crash``: as ``train``, but rank 1 exits with code 7 at the start of
  step 3, the host drop; the other ranks fail in the next collective or
  are killed by the parent;
- ``resume``: restore the latest checkpoint, run steps 3-5.

Each rank writes ``out_<rank>_<mode>.npz``: the step losses and the final
parameters by path.

Usage: python torch_multiprocess_worker.py <workdir> <world> <rank> <mode>
"""

import os
import sys
from datetime import timedelta

STEPS = 6
CRASH_STEP = 3
COLLECTIVE_TIMEOUT_S = 20


def main() -> int:
    workdir, world, rank, mode = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    tests = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(tests), tests]

    import numpy as np
    import torch
    import torch.distributed as dist

    from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
    from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
    from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
    from graph_hypernetwork_forge_tpu_torch.parallel.composed import (
        local_inputs,
        make_composed_train_step,
        prepare_composed_inputs,
    )
    from graph_hypernetwork_forge_tpu_torch.parallel.mesh import make_mesh
    from graph_hypernetwork_forge_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from graph_hypernetwork_forge_tpu_torch.training.train import adam, create_train_state
    from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves
    from torch_parallel_ranks import _case, _unflatten

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, f'rendezvous_{mode}')}",
        rank=rank, world_size=world, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        c = dict(f)
    mesh = make_mesh((world,), ("edge",), device_type="cpu")
    text_dim, feat, hidden, layers = (int(x) for x in c["dims"])
    config = HyperGNNConfig(text_dim=text_dim, node_feat_dim=feat, hidden_dim=hidden,
                            num_layers=layers)
    graph = encode_graph(c["ei"], [f"relation kind {i}" for i in c["ridx"]], int(c["n"]))
    inputs = prepare_composed_inputs(graph, c["feats"], world, halo=True)
    arrays, kw = local_inputs(inputs, mesh)
    kw.pop("agg_plan")
    lr = float(c["lr"])
    step = make_composed_train_step(mesh, config, adam(lr), inputs.nodes_per_shard,
                                    num_nodes=inputs.num_nodes, halo_width=inputs.halo_width)
    state = create_train_state(params_from_jax(_unflatten(_case(c, "params"))), adam(lr))
    params, opt_state = state.params, state.opt_state
    ckpt_dir = os.path.join(workdir, "ckpt_train" if mode == "train" else "ckpt")
    start = 0
    if mode == "resume":
        start = restore_checkpoint(latest_checkpoint(ckpt_dir), params, opt_state)["step"]
    gen = torch.Generator().manual_seed(0)  # unused: the rotations are handed in
    losses = []
    for s in range(start, STEPS):
        if mode == "crash" and s == CRASH_STEP and rank == 1:
            os._exit(7)  # the host drop, mid-training, before the collective
        params, opt_state, loss = step(params, opt_state, *arrays, gen,
                                       neg=int(c["shifts"][s, rank]), **kw)
        losses.append(float(loss))
        if s == CRASH_STEP - 1 and rank == 0 and mode in ("train", "crash"):
            save_checkpoint(ckpt_dir, params, opt_state, CRASH_STEP, wait=True)
    out = {"losses": np.asarray(losses)}
    out.update({f"param/{p}": t.detach().numpy() for p, t in named_leaves(params)})
    np.savez(os.path.join(workdir, f"out_{rank}_{mode}.npz"), **out)
    dist.destroy_process_group()
    print(f"rank {rank} mode={mode}: losses {losses}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
