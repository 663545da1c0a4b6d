"""The system under test: the PyTorch and CUDA port, and nothing else of the
repo. The benchmark reaches the program only through the names here, and
reads back only its outputs, its optimizer state and its kernel names."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict

import torch

import graph_hypernetwork_forge_tpu_torch as package
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNN, HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves

# By module path: the packages' own names ``train`` and ``scoring`` are not
# these modules.
scoring = importlib.import_module("graph_hypernetwork_forge_tpu_torch.ops.scoring")
train = importlib.import_module("graph_hypernetwork_forge_tpu_torch.training.train")

CSRC = Path(package.__file__).resolve().parent / "csrc"

__all__ = ["CSRC", "HyperGNN", "config", "encode", "named_leaves", "nest", "scoring", "train"]


def config(model: dict) -> HyperGNNConfig:
    """The port's configuration of a benchmark model: the kernel backend on
    the relation-sorted, group-padded layout."""
    return HyperGNNConfig(
        text_dim=model["text_dim"], node_feat_dim=model["node_feat_dim"],
        hidden_dim=model["hidden_dim"], num_layers=model["num_layers"],
        dropout=model["dropout"], char_emb_dim=model["char_emb_dim"], backend="cuda",
        precision=model["precision"], rel_sorted=True, group_padded=True,
        compute_dtype=model["compute_dtype"])


def encode(model: dict, edge_index, edge_texts, num_nodes: int):
    return encode_graph(edge_index, edge_texts, num_nodes, sort_by_relation=True,
                        with_sort_plan=True, group_pad=model["group_pad"])


def nest(flat: Dict[str, torch.Tensor]):
    """A parameter tree with the port's keys from ``{"a.0.b": leaf}``: a
    numeric key is a list index."""
    tree: dict = {}
    for path, leaf in flat.items():
        node, keys = tree, path.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
