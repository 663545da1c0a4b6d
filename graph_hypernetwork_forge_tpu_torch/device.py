"""Device selection for the port's entry points.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise; the CPU is used only when a caller asks for it by name.
Choosing a CUDA device also turns TF32 off for matmuls and cuDNN, so
float32 products run in full float32: the port's form of the JAX
package's ``precision="highest"`` rule.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
