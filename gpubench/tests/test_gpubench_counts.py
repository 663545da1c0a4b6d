"""The benchmark's arithmetic against values worked out by hand."""

import pytest

from gpubench import counts, port

XL = {"text_dim": 64, "char_emb_dim": 32, "node_feat_dim": 64, "hidden_dim": 64,
      "num_layers": 2, "compute_dtype": "float32"}
# The xl layout of the repo's seed-0 graph (PERF.md's kernel table): rows,
# nodes, relations held, padded relations.
XL_ROWS, XL_N, XL_U, XL_U_PAD = 1_031_680, 50_000, 237, 240


def test_xl_step_model_flops():
    d, e, layers = 64, 1_000_000, 2
    edges = 12 * d * d * e * layers                      # 98,304,000,000
    per_text = 3 * (64 * 128 + 128 * 128) + 128 * (d * d + d * d + d)
    gens = 3 * 2 * XL_U * per_text * layers              # 3,215,130,624
    proj = 4 * XL_N * 64 * d                             # 819,200,000
    assert edges + gens + proj == 102_338_330_624
    assert counts.model_flops(XL, XL_N, e, XL_U) == edges + gens + proj


@pytest.mark.parametrize("got, want", [
    (lambda: counts.csr_segment_sum_ms(XL_ROWS, XL_N, 64), 0.0827),
    (lambda: counts.csr_segment_sum_ms(XL_ROWS, XL_U_PAD, 64), 0.0789),
    (lambda: counts.edge_transform_ms(XL_ROWS, XL_U, 64), 0.2389),
    (lambda: counts.edge_transform_bwd_ms(XL_ROWS, XL_U, XL_U_PAD, 64), 0.3989),
])
def test_xl_kernel_bounds_match_the_kernel_table(got, want):
    assert got() == pytest.approx(want, abs=5e-5)


def test_kernel_one_bound_by_hand():
    nbytes = (XL_ROWS * 64 + XL_N + 1 + XL_N * 64) * 4    # 277,110,084 bytes
    assert counts.csr_segment_sum_ms(XL_ROWS, XL_N, 64) == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("neg_mode, node_sums", [("roll", 8), ("uniform", 6)])
def test_step_launch_table(neg_mode, node_sums):
    shapes = dict(rows=XL_ROWS, num_nodes=XL_N, num_rel_pad=XL_U_PAD, visited_rel=XL_U)
    table = counts.train_step_kernels(XL, shapes, neg_mode)
    assert len(table["csr_segment_sum_kernel"]) == node_sums + 2
    assert len(table["edge_transform_kernel"]) == len(table["edge_transform_bwd_kernel"]) == 2
    if neg_mode == "roll":
        assert sum(sum(v) for v in table.values()) == pytest.approx(2.095, abs=2e-3)


def test_port_kernel_names_are_read_from_the_sources():
    names = counts.port_kernel_names(port.CSRC)
    assert {"csr_segment_sum_kernel", "edge_transform_kernel", "edge_transform_bwd_kernel",
            "segment_outer_kernel", "run_table_kernel"} <= names
    assert all(n.isidentifier() for n in names)
