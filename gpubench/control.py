#!/usr/bin/env python3
"""The control and the planted faults of a cell's correctness check.

    python3 gpubench/control.py --workload <cell> --seeds <n>[,<n>...]

For each seed it builds the cell's inputs as ``run.py`` does, at the cell's
own size, and puts in the program's place:

- ``control``: the plain reference computed one precision below the
  configuration's (each product's inputs rounded to TF32);
- training, ``half_batch``: the reference scoring only the first half of
  the edges and taking the mean over them;
- training, ``f32_vs_f64`` and ``kink``: not faults but witnesses, the
  f32 reference against the reference in float64 (how far rounding alone
  moves each number on that seed), and the f32 reference with all its
  hinges within ``KINK_BAND`` of 0 taken to the other side of the kink
  (what the rounding of a positive on the hinge's kink moves);
- serving, ``answer_altered``: the reference's answer with the first
  head's best tail replaced by its eleventh.

It prints one JSON line a seed with the numbers each gives against the
f32 reference (``compare.py``). The benchmark's own runs never run this:
its readings set the upper end of each limit in ``limits/<cell>.json``.
A state left unchanged reads 1 on ``change_gap_med`` by its definition
and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import compare, graphs, run  # noqa: E402
from gpubench.drivers import serve, train  # noqa: E402
from gpubench.reference import hypergnn as ref  # noqa: E402


def program_view(out: dict) -> dict:
    """A reference run's readings in the form the program's are read."""
    return dict(losses=out["losses"],
                grad_norms={k: float(g.norm()) for k, g in out["first_grad"].items()},
                change_norms={k: float(c.norm()) for k, c in out["change"].items()})


def train_readings(cell, seed: int, device) -> dict:
    model = cell.config["model"]
    feats_np, ei, etexts = graphs.draw(cell.config["graph"], seed, model["node_feat_dim"])
    graph = ref.Graph(ei, etexts, feats_np.shape[0], device)
    weights = ref.draw_params(model, seed, device)
    feed = train.Feed(seed, graph.layout_rows, feats_np.shape[0],
                      cell.mix["neg_mode"] == "roll", device)
    checked = [feed() for _ in range(cell.mix["checked_steps"])]

    def steps(precision="f32", wide=False, **kwargs):
        w = {k: v.double() for k, v in weights.items()} if wide else weights
        f = feats_np.astype("float64") if wide else feats_np
        return train.reference_steps(ref.Reference(model, precision), cell, w, f, graph,
                                     checked, **kwargs)

    want = steps()
    others = train.flipped_runs(steps, want)

    def numbers(got, want=want, others=others):
        out = compare.train_numbers(program_view(got), want, others)
        return dict(out, near_kink=[len(rows) for rows in got["near_kink"]])

    return {"control": numbers(steps("tf32")),
            "half_batch": numbers(steps(keep=0.5)),
            "f32_vs_f64": numbers(want, steps(wide=True), ()),
            "kink": numbers(others[-1] if others else want, want, ())}


def serve_readings(cell, seed: int, device) -> dict:
    model, mix = cell.config["model"], cell.mix
    feats_np, ei, etexts = graphs.draw(cell.config["graph"], seed, model["node_feat_dim"])
    client = serve.Client(seed, ei, etexts, feats_np.shape[0], mix)
    client.warm(lambda *_: None)
    weights = ref.draw_params(model, seed, device)
    feats = torch.as_tensor(feats_np, device=device)
    k = mix["top_k"]
    control, altered = [], []
    with torch.no_grad():
        for i in range(mix["checked_requests"]):
            req = client.draw(i)
            want = serve.reference_answer(ref.Reference(model), weights, feats, client, req)
            got = serve.reference_answer(ref.Reference(model, "tf32"), weights, feats, client, req)
            scores, ids = got.topk(k, dim=1)
            control.append(compare.serve_numbers(scores, ids, want))
            scores, ids = want.topk(k, dim=1)
            ids[0, 0] = want.topk(k + 1, dim=1).indices[0, k]
            altered.append(compare.serve_numbers(scores, ids, want))
    return {"control": compare.worst(control), "answer_altered": compare.worst(altered)}


READINGS = {"train": train_readings, "serve": serve_readings}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = run.load_cell(run.manifest(), args.workload)
    if not torch.cuda.is_available():
        run.fail("the control runs on a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = READINGS[cell.mix["driver"]](cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
