"""Checkpoints of a train state (port of ``repro.checkpoint.ckpt``).

The format is the reference's, byte for byte, so each package restores the
other's checkpoints:

* a step directory ``step_<N:08d>/`` written as ``step_<N>.tmp`` and then
  renamed, so that a crash during a save never leaves a broken latest
  checkpoint;
* one ``.npy`` file a leaf, ``leaf_<i:05d>.npy`` in the sorted order of the
  leaves' path strings (``params/segments/[0]/attn/wq``, the naming of
  :func:`repro_torch.bridge.flatten`), and ``manifest.json`` mapping each
  path to its file, shape and dtype;
* ``keep`` bounds the checkpoints kept (the oldest are pruned after a save).

numpy has no bfloat16, so a bf16 leaf is stored widened to float32 (exact;
the reference casts it back to the target's dtype on restore, as this
module does).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.tree import tree_map


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(state: Any, directory: str | Path, step: int, keep: int = 3) -> Path:
    """Atomically persist a tree of tensors under ``directory/step_<N>/``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flatten(state).items())):
        arr = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    for old in all_steps(directory)[:-keep] if keep else []:
        shutil.rmtree(directory / f"step_{old:08d}", ignore_errors=True)
    return final


def all_steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str | Path) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(target: Any, directory: str | Path, step: int | None = None,
            device: str | torch.device | None = None) -> Any:
    """A new tree in the structure of ``target`` (a tree of tensors) with
    each leaf loaded from the checkpoint, in the target leaf's dtype, on
    ``device`` (default: the target leaf's device).  ``step`` None takes the
    latest checkpoint."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    cdir = directory / f"step_{step:08d}"
    manifest = json.loads((cdir / "manifest.json").read_text())

    flat_target = flatten(target)
    missing = set(flat_target) - set(manifest["leaves"])
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
    loaded: dict[str, torch.Tensor] = {}
    for key, want in flat_target.items():
        arr = np.load(cdir / manifest["leaves"][key]["file"])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != target {tuple(want.shape)}")
        loaded[key] = torch.from_numpy(arr).to(
            device=want.device if device is None else device, dtype=want.dtype)
    keys = iter(flat_target)
    return tree_map(lambda _: loaded[next(keys)], target)
