"""The share of the traced training steps that the port replayed from its
CUDA graph of the step: its ``train_step_graph_replays`` counter over the
entries of its ``train_step`` span, in percent. None where the port never
replayed a step while recording (a program without the graph included)."""

from gpubench.layer_metrics._program import per_entry


def read(ctx):
    share = per_entry("train_step_graph_replays", "train_step")
    return None if share is None else 100.0 * share
