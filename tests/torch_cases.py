"""Inputs for the kernel tests of the PyTorch port, made with numpy from a
seed. Imports no JAX, so the card tests can use them where JAX is absent."""

import numpy as np

from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph

# The parity gate: f32 atol 3e-5 per layer (CLAUDE.md:50-61).
ATOL = 3e-5


def assert_scaled_close(got, want, err_msg=""):
    """The gradient gate: atol 3e-5 after dividing both by
    ``max(1, max|want|)`` (tests/test_pallas_kernels.py:447-451), since a
    gradient or a segment sum adds many per-edge terms."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(
        np.asarray(got) / scale, want / scale, rtol=0, atol=ATOL, err_msg=err_msg
    )


def segment_case(seed, e, n, d, skew):
    """Sorted ids with empty segments (a hot node, gaps, an empty tail):
    ``(x [e, d] f32, ids [e] int32, splits [n + 1] int32)``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - 3, e)  # the last 3 segments stay empty
    if skew:
        ids = np.where(rng.random(e) < 0.4, 1, ids)  # long segment 1
    ids = np.sort(ids).astype(np.int32)
    splits = np.searchsorted(ids, np.arange(n + 1), side="left").astype(np.int32)
    x = rng.standard_normal((e, d)).astype(np.float32)
    return x, ids, splits


def edge_case(seed, d, tail_cut, d_out=None):
    """Group-padded relation-sorted rows whose bank has relations with no
    rows, cut to a length that is not a multiple of 256 when ``tail_cut``:
    ``(x_src, x_dst, rel, w_msg, w_self, bias)``, the banks ``[U, d, d_out]``
    (``d_out`` defaults to ``d``)."""
    rng = np.random.default_rng(seed)
    n, e, u = 40, 600, 6
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    texts = [f"relation kind {i}" for i in range(u)]
    etexts = [texts[i] for i in rng.integers(0, u, e)]
    graph = encode_graph(ei, etexts, n, sort_by_relation=True, group_pad=256)
    rel = graph.rel_ids[: graph.rel_ids.shape[0] - tail_cut]
    e_rows = rel.shape[0]
    u_pad = graph.char_ids.shape[0]  # 8: relations 6 and 7 have no rows
    d_out = d if d_out is None else d_out
    xs = rng.standard_normal((e_rows, d)).astype(np.float32)
    xd = rng.standard_normal((e_rows, d)).astype(np.float32)
    wm = (rng.standard_normal((u_pad, d, d_out)) / np.sqrt(d)).astype(np.float32)
    ws = (rng.standard_normal((u_pad, d, d_out)) / np.sqrt(d)).astype(np.float32)
    b = rng.standard_normal((u_pad, d_out)).astype(np.float32)
    return xs, xd, rel, wm, ws, b


def run_case(seed, d_in, d_out, tail_cut):
    """Group-padded relation-sorted rows whose relations span several
    256-row tiles (5, 4, 9 and 1 tiles, then an empty relation and a 3-tile
    one), so kernel 3 walks full and ragged runs of tiles; the bank has 8
    relations, 4, 6 and 7 without rows, and the last ``tail_cut`` rows are
    cut: ``(x_src, x_dst, rel, w_msg, w_self, bias)``, the banks
    ``[8, d_in, d_out]``."""
    rng = np.random.default_rng(seed)
    counts = [1100, 1024, 2300, 10, 0, 600]
    rel = np.concatenate(
        [np.full(-(-n // 256) * 256, u, dtype=np.int32) for u, n in enumerate(counts)]
    )
    rel = rel[: rel.shape[0] - tail_cut]
    e_rows, u_pad = rel.shape[0], 8
    xs = rng.standard_normal((e_rows, d_in)).astype(np.float32)
    xd = rng.standard_normal((e_rows, d_in)).astype(np.float32)
    wm = (rng.standard_normal((u_pad, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    ws = (rng.standard_normal((u_pad, d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = rng.standard_normal((u_pad, d_out)).astype(np.float32)
    return xs, xd, rel, wm, ws, b
