"""Explicit devices and the float32 policy.

The port never picks a device on its own: callers name one, and a CUDA
device that is not there is an error, not a quiet fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """'cpu' | 'cuda' | 'cuda:N' | torch.device -> torch.device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def pin_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32 (no TF32), for
    the whole process, as otto_tpu's tests pin theirs. The port is held to
    the reference's cosine / euclidean features, which TF32 would move in
    the third digit; entry points that compare against it call this once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
