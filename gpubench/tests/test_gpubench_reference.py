"""The plain reference against the port's CPU path at a tiny size.

Only this file imports both sides: ``gpubench/reference`` imports nothing
of the port. The card test runs the same comparison through the harness's
drivers on the card (marked ``cuda``; it skips without one)."""

import time

import numpy as np
import pytest
import torch
from conftest import TINY_GRAPHS, TINY_MODEL, tiny_cell
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import apply_hypergnn, init_hypergnn

from gpubench import graphs, port
from gpubench.drivers import serve, train
from gpubench.reference import hypergnn as ref

SEED = 2_147_483_659


def _graph(config="fb15k237"):
    return graphs.draw(TINY_GRAPHS[config], SEED, TINY_MODEL["node_feat_dim"])


def test_encode_and_layout_match_the_port():
    feats, ei, texts = _graph()
    enc = port.encode(TINY_MODEL, ei, texts, feats.shape[0])
    g = ref.Graph(ei, texts, feats.shape[0], "cpu")
    unique, rel = ref.dedup(texts)
    assert list(enc.unique_texts) == unique
    ids, lengths = ref.tokenize(unique)
    assert np.array_equal(enc.char_ids[:len(unique), :ids.shape[1]], ids)
    assert not enc.char_ids[:len(unique), ids.shape[1]:].any()
    assert np.array_equal(enc.text_lengths[:len(unique)], lengths)
    assert enc.src.shape[0] == g.layout_rows
    assert np.array_equal(enc.src[g.rows], ei[0]) and np.array_equal(enc.dst[g.rows], ei[1])
    assert np.array_equal(enc.rel_ids[g.rows], rel)
    assert enc.edge_mask[g.rows].all() and enc.edge_mask.sum() == ei.shape[1]


def test_forward_matches_the_port_layer_by_layer():
    feats, ei, texts = _graph("xl")
    weights = ref.draw_params(TINY_MODEL, SEED, "cpu")
    enc = port.encode(TINY_MODEL, ei, texts, feats.shape[0])
    got = apply_hypergnn(port.config(TINY_MODEL), port.nest(weights), torch.as_tensor(feats),
                         *(torch.as_tensor(a) for a in enc.arrays), return_all_layers=True,
                         sort_plan=enc.sort_plan.to("cpu"))
    want = ref.Reference(TINY_MODEL).forward(weights, torch.as_tensor(feats),
                                             ref.Graph(ei, texts, feats.shape[0], "cpu"))
    assert len(got) == len(want) == TINY_MODEL["num_layers"]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_param_tree_has_the_ports_keys_and_shapes():
    weights = ref.draw_params(TINY_MODEL, SEED, "cpu")
    init = init_hypergnn(port.config(TINY_MODEL), torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in port.named_leaves(init)}
    assert {k: tuple(v.shape) for k, v in weights.items()} == want
    again = ref.draw_params(TINY_MODEL, SEED, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in weights)


@pytest.mark.parametrize("name", ["xl.train-roll", "fb15k237.train-uniform"])
def test_training_steps_match_the_port(name, cpu):
    out = train.run(tiny_cell(name), SEED, 0.2, False, cpu, time.perf_counter())
    assert out.correct, out.checks
    assert out.e2e["train_edges_per_s"] > 0 and out.attempted > 3


def test_serving_matches_the_port(cpu):
    out = serve.run(tiny_cell("fb15k237.serve-zeroshot"), SEED, 0.2, False, cpu,
                    time.perf_counter())
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted > 0 and out.e2e["serve_p95_ms"] > 0


@pytest.mark.parametrize("value, want", [
    (1.0 + 2.0**-12, 1.0), (1.0 + 2.0**-11, 1.0), (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),
    (-(1.0 + 3 * 2.0**-12), -(1.0 + 2.0**-10)), (3.0, 3.0)])
def test_round_tf32_keeps_ten_mantissa_bits_to_nearest_even(value, want):
    assert ref.round_tf32(torch.tensor([value])).item() == want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xl.train-roll", "fb15k237.train-uniform",
                                  "fb15k237.serve-zeroshot"])
def test_the_port_on_the_card_matches_the_reference(name, card):
    driver = {"train": train, "serve": serve}[tiny_cell(name).mix["driver"]]
    out = driver.run(tiny_cell(name), SEED, 0.5, False, card, time.perf_counter())
    assert out.correct, out.checks
