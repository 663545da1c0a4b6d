"""Link-prediction evaluation: MRR and Hits@K, zero-shot relations included.

The counterpart of the JAX package's ``training/evaluate.py``. For each
test edge (s → t), ``score(s, t)`` is ranked against ``score(s, v)`` for
every candidate tail v, known true tails optionally filtered out, with ties
counted optimistically-average: rank = 1 + #better + #ties/2.

Test pairs are scored in chunks, so the peak device memory is one
``[chunk, N]`` score matrix whatever the number of pairs, and the filtered
protocol's exclusions come from a host-side CSR of the known edges by
source. The JAX package pads each chunk's exclusion list to a power of two
to bound its compiled shapes; the port runs eagerly and needs no padding.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from graph_hypernetwork_forge_tpu_torch.device import resolve_device


def _csr_by_src(filter_edges: np.ndarray, num_nodes: int):
    """CSR (ptr, tails) of known edges keyed by source node."""
    src = np.asarray(filter_edges[0], dtype=np.int64)
    dst = np.asarray(filter_edges[1], dtype=np.int64)
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=num_nodes)
    ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, dst[order]


def _chunk_filter_pairs(ptr, tails, chunk_src):
    """(rows, cols) int64 of the known (pair-row, tail) entries of one chunk:
    for chunk pair i with source s, one (i, tail) entry per known edge
    (s → tail)."""
    starts = ptr[chunk_src]
    lens = (ptr[chunk_src + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    rows = np.repeat(np.arange(len(chunk_src), dtype=np.int64), lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
    cols = tails[np.repeat(starts, lens) + offs]
    return rows, cols


@torch.no_grad()
def _chunk_ranks(
    embs: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    rows: Optional[torch.Tensor],
    cols: Optional[torch.Tensor],
    num_nodes: int,
) -> torch.Tensor:
    """Filtered ranks (float64) of one chunk of (src → dst) pairs against
    the first ``num_nodes`` nodes as candidates.

    ``rows/cols`` list the (pair, tail) entries to exclude (None: none).
    The target's own score is restored after the exclusion, so a target
    that is itself a known edge keeps its place and its ties.
    """
    scores = (embs[src] @ embs.T)[:, :num_nodes]  # [C, N]
    true_score = scores.gather(1, dst[:, None])  # [C, 1]
    if rows is not None:
        scores[rows, cols] = -torch.inf
    scores[torch.arange(scores.shape[0], device=scores.device), dst] = true_score[:, 0]
    better = (scores > true_score).sum(dim=1)
    ties = (scores == true_score).sum(dim=1) - 1  # the target itself
    return 1.0 + better.double() + 0.5 * ties.clamp(min=0).double()


def evaluate_link_prediction(
    embs,
    eval_src: np.ndarray,
    eval_dst: np.ndarray,
    *,
    ks: tuple = (1, 3, 10),
    filter_edges: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    chunk_size: int = 1024,
    device=None,
) -> Dict[str, float]:
    """MRR and Hits@K of (src → dst) test pairs over all-node candidates.

    Args:
        embs: ``[N, d]`` node embeddings: a tensor (scored on its device) or
            an array (moved to ``device``; None is the CUDA card).
        eval_src, eval_dst: ``[B]`` test pairs.
        filter_edges: optional ``[2, E_known]`` known-true edges to exclude
            from the candidate sets (the "filtered" protocol).
        num_nodes: the candidates are nodes ``[0, num_nodes)`` (default:
            every row of ``embs``).
        chunk_size: pairs scored at once; the peak device memory is
            ``chunk_size × N`` floats whatever B.

    The scores are f32 products with TF32 off (``resolve_device``), as the
    JAX package's ``precision="highest"``.
    """
    if isinstance(embs, torch.Tensor):
        dev = resolve_device(embs.device)
        embs = embs.detach().float()
    else:
        dev = resolve_device(device)
        embs = torch.as_tensor(np.asarray(embs), dtype=torch.float32, device=dev)
    n = int(embs.shape[0] if num_nodes is None else num_nodes)
    if n > embs.shape[0]:
        raise ValueError(f"num_nodes={n} exceeds the {embs.shape[0]} embeddings")
    eval_src = np.asarray(eval_src, dtype=np.int64)
    eval_dst = np.asarray(eval_dst, dtype=np.int64)
    b = len(eval_src)

    ptr = tails = None
    if filter_edges is not None:
        ptr, tails = _csr_by_src(np.asarray(filter_edges), n)

    ranks = np.empty(b, dtype=np.float64)
    for lo in range(0, b, chunk_size):
        hi = min(lo + chunk_size, b)
        rows = cols = None
        if ptr is not None:
            r, c = _chunk_filter_pairs(ptr, tails, eval_src[lo:hi])
            rows, cols = torch.as_tensor(r, device=dev), torch.as_tensor(c, device=dev)
        ranks[lo:hi] = _chunk_ranks(
            embs,
            torch.as_tensor(eval_src[lo:hi], device=dev),
            torch.as_tensor(eval_dst[lo:hi], device=dev),
            rows, cols, n,
        ).cpu().numpy()

    out = {"mrr": float(np.mean(1.0 / ranks))}
    for k in ks:
        out[f"hits@{k}"] = float(np.mean(ranks <= k))
    return out
