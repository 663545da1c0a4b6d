"""The correctness check fails what it should, at a tiny size on the CPU.

Each fault test drives a whole run of a cell's driver, past the harness's
look for a card, with the timed path broken underneath, and sees
``correct`` come out false under the cell's committed limits. The control
tests put the reference, one precision below the configuration's, in the
program's place. The cells run on one card, so no exchange between cards
can be left out."""

import time

import pytest
import torch
from conftest import tiny_cell

from gpubench import compare, control, port
from gpubench.drivers import serve, train

SEED = 3_000_000_007
TRAIN_CELLS = ["xl.train-roll", "fb15k237.train-uniform"]


def _run(name, cpu):
    cell = tiny_cell(name)
    driver = {"train": train, "serve": serve}[cell.mix["driver"]]
    return driver.run(cell, SEED, 0.2, False, cpu, time.perf_counter())


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged_fails(name, cpu, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = _run(name, cpu)
    assert not out.correct and dict((k, v) for k, v, _ in out.checks)["change_gap_med"] == 1.0


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_the_batch_left_out_fails(name, cpu, monkeypatch):
    def halved(loss):
        def wrapped(*args, edge_mask=None, **kwargs):
            mask = edge_mask.clone()
            mask[mask.shape[0] // 2:] = 0
            return loss(*args, edge_mask=mask, **kwargs)
        return wrapped

    for fn in ("link_prediction_loss", "link_prediction_loss_sorted"):
        monkeypatch.setattr(port.train, fn, halved(getattr(port.train, fn)))
    assert not _run(name, cpu).correct


def test_an_altered_answer_fails(cpu, monkeypatch):
    score_all_tails = port.scoring.score_all_tails

    def altered(embs, heads):
        scores = score_all_tails(embs, heads)
        scores[0, scores[0].argmax()] = float("-inf")
        return scores

    monkeypatch.setattr(port.scoring, "score_all_tails", altered)
    out = _run("fb15k237.serve-zeroshot", cpu)
    assert not out.correct


def test_sound_runs_pass(cpu):
    for name in TRAIN_CELLS + ["fb15k237.serve-zeroshot"]:
        out = _run(name, cpu)
        assert out.correct, (name, out.checks)


@pytest.mark.parametrize("name", TRAIN_CELLS + ["fb15k237.serve-zeroshot"])
def test_the_control_fails(name, cpu):
    cell = tiny_cell(name)
    readings = control.READINGS[cell.mix["driver"]](cell, SEED, cpu)
    for witness in ("f32_vs_f64", "kink"):
        readings.pop(witness, None)
    for fault, numbers in readings.items():
        assert not compare.held(numbers, cell.limits)[0], (fault, numbers)


def _reference_run(cell, cpu, **kwargs):
    from gpubench import graphs
    from gpubench.reference import hypergnn as ref

    model = cell.config["model"]
    feats, ei, texts = graphs.draw(cell.config["graph"], SEED, model["node_feat_dim"])
    graph = ref.Graph(ei, texts, feats.shape[0], cpu)
    feed = train.Feed(SEED, graph.layout_rows, feats.shape[0], True, cpu)
    checked = [feed() for _ in range(3)]
    return train.reference_steps(ref.Reference(model), cell, ref.draw_params(model, SEED, cpu),
                                 feats, graph, checked, **kwargs)


def test_a_gradient_wrong_in_a_few_leaves_fails(cpu):
    cell = tiny_cell("xl.train-roll")
    want = _reference_run(cell, cpu)
    prog = control.program_view(want)
    for leaf in sorted(prog["grad_norms"])[:3]:
        prog["grad_norms"][leaf] *= 1.01
    numbers = compare.train_numbers(prog, want)
    assert numbers["grad_gap_med"] == 0.0
    assert not compare.held(numbers, cell.limits)[0]


def test_the_worst_leaf_is_read_against_the_nearer_side_of_the_kink(cpu):
    cell = tiny_cell("xl.train-roll")
    want = _reference_run(cell, cpu)
    flip = frozenset({(1, 0), (1, 1), (2, 2)})
    program = control.program_view(_reference_run(cell, cpu, flip=flip))
    assert compare.train_numbers(program, want)["grad_gap_worst"] > 1e-5
    want["near_kink"] = [[0, 1], [2], []]
    others = train.flipped_runs(lambda **kw: _reference_run(cell, cpu, **kw), want)
    assert len(others) == 7
    numbers = compare.train_numbers(program, want, others)
    assert numbers["grad_gap_worst"] < 1e-6 and numbers["change_gap_worst"] < 1e-6
