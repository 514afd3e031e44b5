"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor | None) -> None:
    """Raises when autograd would need a gradient through ``kernel``.

    The two SSD-scan kernels called alone have no backward (flash
    attention, the whole SSD scan and the grouped GEMM have one, as
    autograd.Functions): their outputs are fresh
    tensors filled outside autograd, so a gradient would silently skip them.
    Their wrappers call this for a tensor off the CPU, before they launch: under
    ``torch.no_grad()`` or ``torch.inference_mode()``, or with inputs that do
    not require grad, it passes.  CPU tensors take the plain versions, which
    differentiate."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the CUDA kernel has no "
            f"backward; call it under torch.no_grad() or "
            f"torch.inference_mode(), or on CPU tensors (the plain version)")


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd would need a gradient through a call on these."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def batched(*tensors: torch.Tensor | None) -> bool:
    """Whether a call is under ``torch.func.vmap`` (a batched tensor reports
    ``requires_grad`` False and has no data pointer: the call must go
    through an autograd.Function whose vmap rule folds the member dim)."""
    return any(t is not None and torch._C._functorch.is_batchedtensor(t)
               for t in tensors)


def fold_members(t: torch.Tensor | None, dim: int | None, m: int
                 ) -> torch.Tensor | None:
    """For a vmap rule: the member dim ``dim`` of an input moved to the
    front and folded into its batch dim (an input without one, ``dim``
    None, is repeated for each of the ``m`` members)."""
    if t is None:
        return None
    t = t.unsqueeze(0).expand(m, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(m * t.shape[1], *t.shape[2:])


def unfold_members(t: torch.Tensor, m: int) -> torch.Tensor:
    """The inverse of :func:`fold_members` for an output: (M, B, ...)."""
    return t.reshape(m, t.shape[0] // m, *t.shape[1:])
