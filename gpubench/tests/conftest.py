"""Tiny cells for the benchmark's CPU tests: the cells' own traffic mixes
and correctness limits, over a small model and graph."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = {"text_dim": 16, "char_emb_dim": 8, "node_feat_dim": 16, "hidden_dim": 16,
              "num_layers": 2, "dropout": 0.0, "precision": "highest",
              "compute_dtype": "float32", "group_pad": 256}
TINY_GRAPHS = {
    "xl": {"generator": "uniform", "num_nodes": 300, "num_edges": 3000, "num_relations": 7},
    "fb15k237": {"generator": "synthetic_kg", "num_nodes": 300, "num_edges": 3000,
                 "num_relations": 7, "split": "train"},
}
SMALL = {"query_heads": 32, "warm_requests": 1, "checked_requests": 4, "profiled_requests": 1}


def tiny_cell(name: str) -> SimpleNamespace:
    """The cell ``name`` of BENCHMARK.json at a tiny size: its mix and its
    limits as committed, a small model and graph of its generator."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {c["name"]: c for c in bench["workloads"]}[name]
    config = json.loads((ROOT / "gpubench" / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").read_text())
    if mix["driver"] == "serve":
        mix.update(SMALL)
    limits = json.loads((ROOT / "gpubench" / "limits" / f"{name}.json").read_text())
    config = dict(config, model=TINY_MODEL, graph=TINY_GRAPHS[w["config"]])
    return SimpleNamespace(name=name, chips=w["chips"], config=config, mix=mix, limits=limits)


@pytest.fixture
def cpu():
    return torch.device("cpu")
