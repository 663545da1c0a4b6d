"""Checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch


def require_inference(kernel: str, *tensors: torch.Tensor) -> None:
    """Refuse inputs that want a gradient at a raw launch, which records
    nothing for autograd: gradients go through the differentiable entry
    points, whose autograd Functions launch with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} is a forward-only launch and would drop the gradient; "
            "call the differentiable entry points instead "
            "(ops.segment.sorted_segment_sum / sorted_segment_sum_by_plan / "
            "take_rows_pair, ops.cuda.edge_transform_sorted_combined), or "
            "run under torch.inference_mode() or torch.no_grad()."
        )


def require_cuda(kernel: str, device: torch.device, *named) -> None:
    """Every ``(name, tensor, dtype)`` lies on ``device``, has ``dtype`` and
    is contiguous."""
    for name, t, dtype in named:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def raise_on_error(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(
            f"{kernel}: launch failed with CUDA error {code} "
            f"({torch.cuda.get_device_name()})"
        )


def vec16(*tensors: torch.Tensor, widths: tuple[int, ...]) -> int:
    """1 when a kernel may move 16 bytes at a time: every row width is a
    multiple of 4 floats and every tensor starts 16-byte aligned; else 0."""
    return int(
        all(w % 4 == 0 for w in widths) and all(t.data_ptr() % 16 == 0 for t in tensors)
    )
