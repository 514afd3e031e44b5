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

A state of DTensors (one process a device, :mod:`repro_torch.train.step`)
is saved as the same full arrays: every rank gathers each leaf (over the
data-parallel axes and ``model``), rank 0 writes, and all ranks wait at a
barrier after the rename, so no rank reads or prunes a half-written step.
:func:`restore` places each leaf by its placements, so a run saved on one
(data, model) mesh resumes on another, or on one device.
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
import torch.distributed as dist

from repro_torch.bridge import flatten
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding as shd
from repro_torch.tree import tree_map


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(state: Any, directory: str | Path, step: int, keep: int = 3) -> Path:
    """Atomically persist a tree of tensors under ``directory/step_<N>/``.
    A tree of DTensors is gathered leaf by leaf on every rank (all ranks
    call this), written by rank 0, and the ranks meet at a barrier after
    the rename."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    sharded = shd.is_distributed(state)
    writer = not sharded or dist.get_rank() == 0
    tmp = directory / f"step_{step:08d}.tmp"
    if writer:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flatten(state).items())):
        arr = _to_numpy(shd.full(leaf))
        if not writer:
            continue
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in all_steps(directory)[:-keep] if keep else []:
            shutil.rmtree(directory / f"step_{old:08d}", ignore_errors=True)
    if sharded:
        dist.barrier()
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
            device: str | torch.device | None = None, shardings: Any = None
            ) -> Any:
    """A new tree in the structure of ``target`` (a tree of tensors) with
    each leaf loaded from the checkpoint, in the target leaf's dtype, on
    ``device`` (default: the target leaf's device).  ``step`` None takes the
    latest checkpoint.  With ``shardings`` (a tree of
    :class:`~repro_torch.distributed.sharding.Spec` in ``target``'s
    nesting, e.g. ``state_shardings``), each leaf is placed as a DTensor by
    its spec on the ambient mesh: every rank reads the full array and keeps
    its slice, so a run resumes on any (data, model) mesh."""
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
    specs = (dict(zip(flat_target, shd.spec_leaves(shardings)))
             if shardings is not None else {})
    mesh = mesh_ctx.get_mesh()
    if specs and mesh is None:
        raise ValueError("restoring onto shardings needs an ambient mesh (set_mesh)")
    loaded: dict[str, torch.Tensor] = {}
    for key, want in flat_target.items():
        arr = np.load(cdir / manifest["leaves"][key]["file"])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != target {tuple(want.shape)}")
        leaf = torch.from_numpy(arr).to(
            device=shd.local(want).device if device is None else device,
            dtype=want.dtype)
        loaded[key] = shd.distribute(leaf, specs[key], mesh) if specs else leaf
    keys = iter(flat_target)
    return tree_map(lambda _: loaded[next(keys)], target)

