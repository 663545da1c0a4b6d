"""BENCHMARK.json against the benchmark's contract, every name resolved to
its file, and the run's imports."""

import json
import re
import subprocess
import sys
import textwrap

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "graph_hypernetwork_forge_tpu"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1].startswith("gpubench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               and m["source"] in SOURCES for m in metrics)


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"] == f"gpubench/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_cells_resolve_to_their_files():
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for path in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert (ROOT / "gpubench" / path).is_file()
        driver = json.loads((ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "gpubench" / "drivers" / f"{driver['driver']}.py").is_file()


def test_metrics_resolve_and_are_reported_where_they_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpubench" / "layer_metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= e2e[m["moves"]] & cells
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in ws and name != "setup_s" for name, ws in e2e.items())
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "xl.train-roll",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    if "needs 1 CUDA card" not in proc.stderr:
        pytest.skip("a CUDA card is present")
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_dry_run_of_every_mix_loads_nothing_of_jax():
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(ROOT / 'gpubench' / 'tests')!r})
        import torch
        from conftest import tiny_cell
        from gpubench.drivers import serve, train
        from gpubench import run
        for name in ("xl.train-roll", "fb15k237.train-uniform", "fb15k237.serve-zeroshot"):
            cell = tiny_cell(name)
            driver = {{"train": train, "serve": serve}}[cell.mix["driver"]]
            out = driver.run(cell, 3000000001, 0.1, False, torch.device("cpu"), time.perf_counter())
            assert out.correct, out.checks
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "graph_hypernetwork_forge_tpu_torch" in top and "gpubench" in top
    assert not top & FORBIDDEN
