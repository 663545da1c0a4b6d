"""Training: objectives and the full-graph train step."""

from graph_hypernetwork_forge_tpu_torch.training.objectives import (
    link_prediction_loss,
    link_prediction_loss_sorted,
    margin_ranking_loss,
    multi_negative_loss,
)
from graph_hypernetwork_forge_tpu_torch.training.train import (
    TrainState,
    adam,
    create_train_state,
    make_multi_step,
    make_train_step,
    train,
)

__all__ = [
    "TrainState",
    "adam",
    "create_train_state",
    "link_prediction_loss",
    "link_prediction_loss_sorted",
    "make_multi_step",
    "make_train_step",
    "margin_ranking_loss",
    "multi_negative_loss",
    "train",
]
