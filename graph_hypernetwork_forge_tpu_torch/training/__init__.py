"""Training: objectives, the full-graph and minibatch train steps,
evaluation and checkpointing."""

from graph_hypernetwork_forge_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from graph_hypernetwork_forge_tpu_torch.training.evaluate import evaluate_link_prediction
from graph_hypernetwork_forge_tpu_torch.training.minibatch import (
    DistributedMinibatchTrainer,
    MinibatchSpec,
    MinibatchTrainer,
    make_composed_minibatch_step,
)
from graph_hypernetwork_forge_tpu_torch.training.objectives import (
    link_prediction_loss,
    link_prediction_loss_sorted,
    margin_ranking_loss,
    multi_negative_loss,
)
from graph_hypernetwork_forge_tpu_torch.training.train import (
    TrainState,
    adam,
    adamw,
    create_train_state,
    make_multi_step,
    make_train_step,
    train,
    warmup_cosine_decay_schedule,
)

__all__ = [
    "DistributedMinibatchTrainer",
    "MinibatchSpec",
    "MinibatchTrainer",
    "TrainState",
    "adam",
    "adamw",
    "create_train_state",
    "evaluate_link_prediction",
    "latest_checkpoint",
    "link_prediction_loss",
    "link_prediction_loss_sorted",
    "make_composed_minibatch_step",
    "make_multi_step",
    "make_train_step",
    "margin_ranking_loss",
    "multi_negative_loss",
    "restore_checkpoint",
    "save_checkpoint",
    "train",
    "wait_for_checkpoints",
    "warmup_cosine_decay_schedule",
]
