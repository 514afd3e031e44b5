"""Input/output file staging (paper §5 ``infiles``/``outfiles``/
``substitute`` and the §6 NetLogo study pattern).

Per workflow instance:
* every ``infiles`` entry is staged into the instance's working
  directory; files whose content matches a ``substitute`` rule are
  rewritten with the instance's values (the paper varies XML elements of
  the NetLogo input this way); identical files are hard-linked instead
  of copied ("input files that were exactly the same ... were placed in
  a NFS directory, so only a single copy of each was made");
* ``${...}`` interpolation applies to the file *names* as well, so
  per-instance output paths like ``result_${args:size}.txt`` resolve;
* ``outfiles`` declares which artifacts to collect after the run.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Mapping

from .interpolate import interpolate, substitute_content


def stage_instance(
    workdir: str | Path,
    instance_id: str,
    infiles: Mapping[str, str],
    combo: Mapping[str, Any],
    substitute: Mapping[str, Any] | None = None,
    source_root: str | Path = ".",
) -> Path:
    """Materialize one instance's working directory; returns its path."""
    inst_dir = Path(workdir) / instance_id
    inst_dir.mkdir(parents=True, exist_ok=True)
    source_root = Path(source_root)

    # per-instance substitute values: pick this combo's value per rule
    rules: dict[str, Any] = {}
    for pattern in (substitute or {}):
        key = f"substitute:{pattern}"
        if key in combo:
            rules[pattern] = combo[key]

    for _, raw_name in sorted(infiles.items()):
        name = interpolate(raw_name, combo)
        src = source_root / name
        dst = inst_dir / Path(name).name
        if not src.exists():
            raise FileNotFoundError(f"infile {src} missing")
        content = src.read_text()
        rewritten = substitute_content(content, rules) if rules else content
        if rewritten == content:
            # unchanged input: hard-link the shared copy (NFS pattern)
            if dst.exists():
                dst.unlink()
            try:
                os.link(src, dst)
            except OSError:
                shutil.copy2(src, dst)
        else:
            dst.write_text(rewritten)
    return inst_dir


def collect_outputs(
    inst_dir: str | Path,
    outfiles: Mapping[str, str],
    combo: Mapping[str, Any],
    dest_root: str | Path,
) -> dict[str, Path]:
    """Copy declared outputs into the provenance area; returns name→path."""
    inst_dir = Path(inst_dir)
    dest_root = Path(dest_root)
    dest_root.mkdir(parents=True, exist_ok=True)
    collected: dict[str, Path] = {}
    for key, raw_name in outfiles.items():
        name = interpolate(raw_name, combo)
        src = inst_dir / Path(name).name
        if src.exists():
            dst = dest_root / Path(name).name
            shutil.copy2(src, dst)
            collected[key] = dst
    return collected
