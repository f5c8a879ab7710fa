"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def require_cuda(device) -> torch.device:
    """Resolve `device`; raise if a CUDA device is asked for and none is
    present (there is no silent CPU run). On a CUDA device, turn TF32 off
    for matmuls and convolutions: the mean shift's |c|^2+|p|^2-2cp
    expansion and the tracer's codebook argmax need full float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was requested but no CUDA device is present")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
