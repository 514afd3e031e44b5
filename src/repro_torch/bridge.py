"""Parameters and train states between the JAX package's pytree and the
port's tensors.

The JAX side hands over its parameter pytree (or its whole train state,
``{"params", "opt": {"m", "v", "master", "count"}, "step"}``) after
``jax.device_get``: nested dicts and lists of numpy arrays.  The port keeps
the same nesting (stacked segments keep their leading layer axis), so the
path strings of ``repro.checkpoint.ckpt`` (``segments/[0]/attn/wq``, …) name
the same leaves on both sides, and the port's checkpoints use them too.
This module imports no jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map

SEP = "/"


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """numpy pytree → the same nesting of tensors on ``device`` (exact).
    The tree may be the parameters or a whole train state, ``{"params",
    "opt": {"m", "v", "master", "count"}, "step"}``, 0-d leaves included."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device),
                    tree)


def params_to_numpy(params: Any) -> Any:
    """The port's parameters (or train state) → the same nesting of numpy
    arrays (exact)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


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
