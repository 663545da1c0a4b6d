"""Bucket rules for the padded host arrays.

The same rules as the JAX package (``graph_hypernetwork_forge_tpu/utils/
shapes.py``), so both packages pad a graph to the same shapes: edge counts
to buckets, relation counts and text lengths to multiples of 8.
"""

from __future__ import annotations


def round_up_to_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= max(x, 1)."""
    x = max(int(x), 1)
    return ((x + m - 1) // m) * m


def pad_bucket_edges(e: int) -> int:
    """Multiples of 64 up to 1024, powers of two up to 1M, multiples of 1M above."""
    if e <= 1024:
        return round_up_to_multiple(e, 64)
    if e <= 1 << 20:
        out = 1024
        while out < e:
            out *= 2
        return out
    return round_up_to_multiple(e, 1 << 20)


def pad_bucket_relations(u: int) -> int:
    """Bucket a unique-relation count to a multiple of 8."""
    return round_up_to_multiple(u, 8)


def pad_bucket_textlen(length: int) -> int:
    """Bucket a max-text-length to a multiple of 8."""
    return round_up_to_multiple(length, 8)
