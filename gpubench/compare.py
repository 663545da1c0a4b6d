"""The numbers that decide ``correct``: the program's readings against the
plain reference's (``reference/hypergnn.py``), each held to its limit.

Training, over the first steps of the object the window then drives:

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap_med``: the first step's gradient, as the optimizer holds it,
  by the median leaf: a leaf's gap is the gap between its two norms, over
  the larger of the reference's norm of that leaf and of the median leaf.
- ``change_gap_med``: the parameters' change after the checked steps, by
  the median leaf, measured the same way, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (Adam moves
  leaves with a gradient at round-off by their rounding alone).
- ``grad_gap_worst``, ``change_gap_worst``: the same two by the worst
  leaf. A positive whose hinge ``margin - pos + neg`` lies within rounding
  of 0 enters the loss on one side of rounding and not on the other, and
  moves the worst leaf by far more than rounding does elsewhere, and
  every later step with it.

Where the reference has such hinges, it is run again with each set of them
taken to the other side (``flip``), and each training number is the
smallest of the program's against any of the runs.

Serving, over a sample of the requests the window completed:

- ``score_err``: the largest gap between a returned score and the
  reference's score of the same head and tail.
- ``rank_gap``: the largest amount by which the reference's score of the
  tail returned at rank j lies below the reference's j-th best score.

Both serving numbers are taken over the larger of 1 and the head's largest
top-10 reference score.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

Checks = List[Tuple[str, float, float]]
GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: Sequence[str]):
    """Each leaf's gap between its two norms, over the larger of the
    reference's norm of the leaf and of the median leaf."""
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys}


def _against(prog: dict, want: dict):
    """The training numbers of ``prog`` against one reference run, and the
    worst leaf of each worst-leaf gap."""
    numbers = dict(loss_gap=max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])))
    g_ref = {k: float(g.norm()) for k, g in want["first_grad"].items()}
    c_ref = {k: float(c.norm()) for k, c in want["change"].items()}
    median_g = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= GRAD_FLOOR * median_g]
    gaps = dict(grad=_leaf_gaps(prog["grad_norms"], g_ref, list(g_ref)),
                change=_leaf_gaps(prog["change_norms"], c_ref, moved))
    leaves = {}
    for name, by_leaf in gaps.items():
        leaf = max(by_leaf, key=by_leaf.get)
        numbers[f"{name}_gap_med"] = statistics.median(by_leaf.values())
        numbers[f"{name}_gap_worst"] = by_leaf[leaf]
        leaves[f"{name}_gap_worst"] = leaf
    return numbers, leaves


def train_numbers(prog: dict, ref: dict, others: Sequence[dict] = (),
                  beside: dict | None = None) -> Dict[str, float]:
    """``prog``: ``losses`` and the leaves' ``grad_norms`` and
    ``change_norms`` (floats); ``ref``: :func:`reference.hypergnn.train_steps`'s
    output, and ``others`` the same with hinges near the kink taken to
    their other side. Each number is the smallest against any of the runs.
    ``beside``, when given, gets the worst leaf of each worst-leaf gap."""
    runs = [_against(prog, want) for want in [ref, *others]]
    numbers = {k: min(r[k] for r, _ in runs) for k in runs[0][0]}
    if beside is not None:
        for k in runs[0][1]:
            beside[k] = min(runs, key=lambda r: r[0][k])[1][k]
    return numbers


def serve_numbers(scores: torch.Tensor, ids: torch.Tensor, ref_scores: torch.Tensor) -> Dict[str, float]:
    """One request: the returned ``[H, K]`` scores and tails in rank order,
    and the reference's ``[H, N]`` scores of every tail."""
    ids = ids.to(ref_scores.device).long()
    scores = scores.to(ref_scores.device)
    ref_at = ref_scores.gather(1, ids)
    ref_top = ref_scores.topk(ids.shape[1], dim=1).values
    scale = ref_top.abs().amax(1).clamp(min=1.0)
    return dict(score_err=float(((scores - ref_at).abs().amax(1) / scale).max()),
                rank_gap=float(((ref_top - ref_at).amax(1) / scale).max()))


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Checks]:
    """Each number beside its limit, and whether every one is within it."""
    checks = [(k, numbers[k], float(limits[k])) for k in limits]
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks), checks
