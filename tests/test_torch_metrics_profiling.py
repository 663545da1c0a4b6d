"""The port's metrics writers and profiling hooks: the writers record what
the JAX package's record, and the profiler hooks run on the CPU (a trace
file is written, a phase waits for its result)."""

import json
import os

import pytest
import torch

from graph_hypernetwork_forge_tpu.utils import metrics as jm
from graph_hypernetwork_forge_tpu_torch.utils import metrics as pm
from graph_hypernetwork_forge_tpu_torch.utils.profiling import (
    RANGE_PREFIX,
    PhaseTimer,
    device_trace,
    span,
)

_STEPS = [(0, dict(loss=1.5, edges_per_s=100.0)), (1, dict(loss=1.2, edges_per_s=120.0)),
          (4, dict(loss=0.25))]


def _log(mod, path):
    w = mod.JsonlWriter(path)
    logger = mod.MetricsLogger([w])
    for step, m in _STEPS:
        logger.log(step, **m)
    w.close()
    with open(path) as fh:
        lines = [json.loads(line) for line in fh.read().strip().splitlines()]
    return logger.history.history, lines


def test_history_and_jsonl_match_jax(tmp_path):
    got_hist, got_lines = _log(pm, os.path.join(tmp_path, "port.jsonl"))
    want_hist, want_lines = _log(jm, os.path.join(tmp_path, "jax.jsonl"))
    assert got_hist == want_hist
    assert len(got_lines) == len(want_lines) == len(_STEPS)
    for g, w in zip(got_lines, want_lines):
        g.pop("ts"), w.pop("ts")
        assert g == w


def test_stdout_writer_matches_jax(capsys):
    for mod in (pm, jm):
        w = mod.StdoutWriter(every=2)
        for step, m in _STEPS:
            w.write(step, m)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and out[0] == "[step 0] loss=1.5 edges_per_s=100"


def test_phase_timer_accumulates_and_waits_for_its_result():
    timer = PhaseTimer()
    with timer.phase("fwd") as slot:
        slot["out"] = {"a": [torch.ones(8, 8) * 2]}
    with timer.phase("fwd", block_on=torch.zeros(2)):
        pass
    with timer.phase("bwd"):
        pass
    assert timer.counts == {"fwd": 2, "bwd": 1}
    assert timer.totals["fwd"] > 0
    assert set(timer.summary()) == {"fwd", "bwd"}
    assert "fwd" in timer.report()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, device):
    if device is None and torch.cuda.is_available():
        pytest.skip("checks the CPU lane")
    with device_trace(str(tmp_path), device=device) as prof:
        with span("region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == RANGE_PREFIX + "region" for e in events)
    assert any(e.key == RANGE_PREFIX + "region" for e in prof.key_averages())
