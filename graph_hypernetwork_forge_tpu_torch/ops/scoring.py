"""Link-prediction scoring (the port of ``graph_hypernetwork_forge_tpu/ops/
scoring.py``).

- :func:`score_pairs`: ``[B, d] × [B, d] → [B]`` (or ``[d] → scalar``).
- :func:`score_candidate_sets`: per-query candidate lists ``[B, K]``.
- :func:`score_all_tails`: every node as tail, ``[B, N]``, one matmul.

Float32 products run in full float32: the device set-up turns TF32 off.
"""

from __future__ import annotations

import torch


def score_pairs(head: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """Dot-product score; ``[d] → scalar`` or ``[B, d] → [B]``."""
    return (head * tail).sum(dim=-1)


def score_candidate_sets(
    embs: torch.Tensor, src: torch.Tensor, candidates: torch.Tensor
) -> torch.Tensor:
    """Scores of each candidate tail per query: ``[B, K]``.

    Args:
        embs: ``[N, d]`` node embeddings.
        src: ``[B]`` query head indices.
        candidates: ``[B, K]`` candidate tail indices per query.
    """
    return torch.einsum("bd,bkd->bk", embs[src], embs[candidates])


def score_all_tails(embs: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Scores against every node as tail: ``[B, N]``."""
    return torch.matmul(embs[src], embs.T)
