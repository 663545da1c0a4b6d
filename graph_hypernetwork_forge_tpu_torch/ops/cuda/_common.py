"""Checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from graph_hypernetwork_forge_tpu_torch.utils import profiling

# The data types the kernels take: float32 and bfloat16, the speed mode's
# storage type.
F32_BF16 = (torch.float32, torch.bfloat16)

# The forms a kernel is launched in: "f32" (f32 data; the matrix kernels in
# 3xTF32 on the tensor cores), "tf32" (f32 data, the matrix kernels in one
# TF32 pass, precision="default"), "bf16" (bf16 data, f32 sums) and "fast"
# (the sums of kernels 1 and 7 over f32 rows in mode="fast": each value
# rounded to bf16 as it is read, then summed in f32). The gather kernel,
# which moves bytes of any type, has forms of its own: the bytes a lane
# moves at a time (``ops/cuda/gather_rows.py``).
FORMS = ("f32", "tf32", "bf16", "fast")


def count_launch(kernel: str, form: str | None = None) -> None:
    """One launch of wrapper ``kernel``'s kernel in ``form``: the counter
    ``kernel.<kernel>.<form>`` of ``utils/profiling.py`` (``kernel.<kernel>``
    for a kernel of one form, the run table's), counted while recording."""
    profiling.count(f"kernel.{kernel}" if form is None else f"kernel.{kernel}.{form}", 1)


def tf32_passes(precision) -> int:
    """TF32 passes of a matrix kernel's f32 products: 3 (the 3xTF32 split,
    f32-class) for ``"highest"`` and ``"high"``, 1 for ``"default"`` or
    ``None`` (the Hopper form of the TPU's one bf16 pass)."""
    if precision in ("highest", "high"):
        return 3
    if precision in ("default", None):
        return 1
    raise ValueError(f"unknown precision {precision!r}")


def matrix_form(dtype: torch.dtype, precision) -> str:
    """The form a matrix kernel runs in for ``dtype`` data at ``precision``;
    bf16 operands take one bf16 pass whatever the precision, as in JAX."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "f32" if tf32_passes(precision) == 3 else "tf32"


def sum_form(dtype: torch.dtype, mode: str) -> str:
    """The form a segment-sum kernel runs in for rows of ``dtype`` in
    ``mode`` ("exact" or "fast"); on bf16 rows the mode changes nothing,
    as in JAX."""
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if dtype == torch.bfloat16:
        return "bf16"
    return "f32" if mode == "exact" else "fast"


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
    """Every ``(name, tensor, dtypes)`` lies on ``device``, has one of
    ``dtypes`` (a dtype or a tuple of them) and is contiguous."""
    for name, t, dtypes in named:
        allowed = dtypes if isinstance(dtypes, tuple) else (dtypes,)
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype not in allowed:
            want = " or ".join(str(d) for d in allowed)
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def require_same_dtype(kernel: str, **data: torch.Tensor) -> torch.dtype:
    """All data operands of one launch share one dtype; returns it."""
    dtypes = {name: t.dtype for name, t in data.items()}
    if len(set(dtypes.values())) > 1:
        raise TypeError(f"{kernel}: data operands differ in dtype: {dtypes}")
    return next(iter(dtypes.values()))


# Ticket counters of the kernels' ordered last-arriver reductions (kernels
# 3 and 6's dW, kernels 1 and 7's segments that cross row blocks), one
# buffer per (device, stream); see run_counters.
_COUNTERS: dict = {}


def run_counters(device: torch.device, n: int, stream=None) -> torch.Tensor:
    """At least ``n`` int32 ticket counters for an ordered last-arriver
    reduction (``csrc/run_reduce.cuh``: kernels 3 and 6's dW, kernels 1 and
    7's segments that cross row blocks) on the current stream of ``device``.

    One buffer is kept per device and stream, zeroed once when it is made,
    and each launch leaves every counter it used at zero again, so the
    launches that follow on the stream find it ready. A fresh zeroed buffer
    per call would cost a fill launch on every call; one per stream keeps
    launches on two streams, which may run at once, apart.
    """
    if stream is None:
        stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        # Stream-ordered: a larger buffer is zeroed after the launches that
        # still use the old one.
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """The tensor's data pointer; null for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def raise_on_error(kernel: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(
            f"{kernel}: launch failed with CUDA error {code} "
            f"({torch.cuda.get_device_name()})"
        )


def vec16(*tensors: torch.Tensor, widths: tuple[int, ...],
          dtype: torch.dtype = torch.float32) -> int:
    """1 when a kernel may move 16 bytes at a time: every row width is a
    multiple of 16 bytes of ``dtype`` (4 floats, 8 bf16) and every tensor
    starts 16-byte aligned; else 0."""
    per16 = 16 // dtype.itemsize
    return int(
        all(w % per16 == 0 for w in widths)
        and all(t.data_ptr() % 16 == 0 for t in tensors)
    )
