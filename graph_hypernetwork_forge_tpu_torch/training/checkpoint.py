"""Checkpoint and resume, with asynchronous saves.

The counterpart of the JAX package's ``training/checkpoint.py`` (Orbax):
``{params, opt_state, step}`` is saved to ``directory/step_<N>``, the
optimizer state as the ``torch.optim`` state dict, with ``torch.save``.

:func:`save_checkpoint` copies every tensor to the host before it returns,
then a background thread writes the copy, so training overlaps the write.
The copy is what makes that safe: ``torch.optim.Adam`` updates parameters
and moments in place, where JAX arrays are immutable, so the next step
would otherwise change what the writer reads. The writer fills a
temporary directory and renames it into place, so a save cut short never
shows as a checkpoint. :func:`wait_for_checkpoints` is the barrier; it runs
before a restore, before :func:`latest_checkpoint` and at interpreter exit.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import os
import shutil
import threading
import uuid
from typing import Any, List, Optional

import torch

from graph_hypernetwork_forge_tpu_torch.utils.initializers import named_leaves

_FILE = "checkpoint.pt"
_LOCK = threading.Lock()
_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING: List[concurrent.futures.Future] = []


def _writer() -> concurrent.futures.ThreadPoolExecutor:
    global _WRITER
    with _LOCK:
        if _WRITER is None:
            _WRITER = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ghf-checkpoint"
            )
            atexit.register(wait_for_checkpoints)
        return _WRITER


def wait_for_checkpoints() -> None:
    """Block until every save in flight has committed; raise the first
    error a save met."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for future in pending:
        future.result()


def _host_copy(tree):
    """The tree with every tensor copied to host memory (a new tensor,
    never a view of the live one)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _commit(ckpt: dict, directory: str, path: str) -> None:
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(ckpt, f)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.exists(path):  # an overwrite, as Orbax's force=True
            old = tmp + ".old"
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(
    directory: str,
    params: Any,
    opt_state: Optional[torch.optim.Optimizer] = None,
    step: int = 0,
    *,
    wait: bool = False,
) -> str:
    """Save ``{params, opt_state, step}`` to ``directory/step_<N>``.

    Returns once every tensor is copied to the host; the write runs on a
    background thread and commits the directory by a rename. Pass
    ``wait=True`` (or call :func:`wait_for_checkpoints`) to block until the
    checkpoint is on disk.
    """
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    ckpt = {"params": _host_copy(params), "step": int(step)}
    if opt_state is not None:
        ckpt["opt_state"] = _host_copy(opt_state.state_dict())
    os.makedirs(directory, exist_ok=True)
    future = _writer().submit(_commit, ckpt, directory, path)
    with _LOCK:
        _PENDING.append(future)
    if wait:
        wait_for_checkpoints()
    return path


def restore_checkpoint(
    path: str,
    params_like: Any,
    opt_state_like: Optional[torch.optim.Optimizer] = None,
) -> dict:
    """Restore a checkpoint saved by :func:`save_checkpoint`, in place.

    ``params_like`` is a parameter tree of the saved structure (e.g. a
    fresh ``init_hypergnn``): its tensors take the saved values, on their
    own devices. ``opt_state_like``, an optimizer over those tensors (e.g.
    ``create_train_state(...).opt_state``), takes the saved state dict.
    Returns ``{"params", "step"[, "opt_state"]}``. Saves in flight are
    awaited first.
    """
    wait_for_checkpoints()
    ckpt = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    saved = dict(named_leaves(ckpt["params"]))
    target = dict(named_leaves(params_like))
    if saved.keys() != target.keys():
        raise ValueError(
            f"checkpoint leaves {sorted(saved)} differ from the target's {sorted(target)}"
        )
    for name, t in target.items():
        if t.shape != saved[name].shape:
            raise ValueError(f"{name}: saved shape {tuple(saved[name].shape)} "
                             f"!= target shape {tuple(t.shape)}")
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(saved[name])
    out = {"params": params_like, "step": ckpt["step"]}
    if opt_state_like is not None:
        opt_state_like.load_state_dict(ckpt["opt_state"])
        out["opt_state"] = opt_state_like
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the highest-step checkpoint under ``directory``, or None.

    Only committed checkpoints are seen: a save writes a hidden temporary
    directory and renames it to ``step_<N>`` when done, so what a process
    that died mid-save leaves behind is never returned.
    """
    wait_for_checkpoints()
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])
