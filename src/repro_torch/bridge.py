"""Parameters between the JAX package's pytree and the port's tensors.

The JAX side hands over its parameter pytree after ``jax.device_get``:
nested dicts and lists of numpy arrays.  The port keeps the same nesting
(stacked segments keep their leading layer axis), so the path strings of
``repro.checkpoint.ckpt`` (``segments/[0]/attn/wq``, …) name the same
leaves on both sides.  This module imports no jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

SEP = "/"


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """numpy pytree → the same nesting of tensors on ``device`` (exact)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(params: Any) -> Any:
    """The port's parameters → the same nesting of numpy arrays (exact)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def flatten(params: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves keyed by checkpoint path strings: dict keys as they are,
    list indices as ``[i]``, joined by ``/``."""
    if isinstance(params, dict):
        items = [(str(k), v) for k, v in params.items()]
    elif isinstance(params, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(params)]
    else:
        return {prefix: params}
    flat: dict[str, Any] = {}
    for key, value in items:
        flat.update(flatten(value, f"{prefix}{SEP}{key}" if prefix else key))
    return flat
