"""PyTorch port of the repro workload (serving path), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
of it and nothing of ``jax``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
