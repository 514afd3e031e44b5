"""Device selection: CUDA unless the caller asks for the CPU, never silently."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device the port runs on.

    ``None`` means ``cuda``; with no CUDA device that raises instead of
    carrying on on the CPU.  An explicit ``"cpu"`` is honoured (the tests
    pass it).  Also pins the float32 matmul and cuDNN paths to full fp32
    (no TF32), so float32 results are comparable with the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
