"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor | None) -> None:
    """Raises when autograd would need a gradient through ``kernel``.

    The SSD-scan and grouped-GEMM kernels have no backward yet (flash
    attention has one, as an autograd.Function): their outputs are fresh
    tensors filled outside autograd, so a gradient would silently skip them.
    Their wrappers call this for a tensor off the CPU, before they launch: under
    ``torch.no_grad()`` or ``torch.inference_mode()``, or with inputs that do
    not require grad, it passes.  CPU tensors take the plain versions, which
    differentiate."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the CUDA kernel has no "
            f"backward; call it under torch.no_grad() or "
            f"torch.inference_mode(), or on CPU tensors (the plain version)")
