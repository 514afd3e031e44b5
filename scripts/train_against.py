#!/usr/bin/env python3
"""Times ``launch.train`` of this tree beside another tree's, on one CUDA
card, in turns.

    python3 scripts/train_against.py OTHER_SRC [--arch A ...] [--pairs N]

Run from the repository root.  ``OTHER_SRC`` is another tree's ``src``
directory (e.g. the parent commit unpacked under ``build/`` by ``git
archive``).  For each ``--arch`` (default gemma3-1b and hubert-xlarge, the
two training paths with the most host time a step), N pairs (default 2) of
``repro_torch.launch.train.main`` at full width on (4, 2048) batches, 2
warm-up and 5 timed steps, each in a fresh process with one tree's
``src`` on its path, the order alternating from pair to pair (this,
other, other, this, ...).  Prints one JSON line a run (each step's seconds,
the timed steps' median) and one a model with both trees' medians, each
line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARMUP, TIMED = 2, 5
RUN = ("import json, sys; from repro_torch.launch import train; "
       "out = train.main(sys.argv[1:]); print(json.dumps(out['step_seconds']))")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def run(src: Path, arch: str) -> list[float]:
    """One training process with ``src`` on its path: each step's seconds."""
    argv = ["--arch", arch, "--batch", "4", "--seq", "2048",
            "--steps", str(WARMUP + TIMED), "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = subprocess.run([sys.executable, "-c", RUN, *argv], env=env, check=True,
                         capture_output=True, text=True, cwd=src.parent)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--arch", nargs="+", default=["gemma3-1b", "hubert-xlarge"])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    trees = {"this": ROOT / "src", "other": args.other_src.resolve()}
    name = card()
    for arch in args.arch:
        medians: dict[str, list[float]] = {"this": [], "other": []}
        for pair in range(args.pairs):
            for tree in (("this", "other") if pair % 2 == 0 else ("other", "this")):
                steps = run(trees[tree], arch)
                median = sorted(steps[WARMUP:])[TIMED // 2]
                medians[tree].append(median)
                print(json.dumps({"arch": arch, "tree": tree, "pair": pair,
                                  "step_seconds": steps, "median_ms": median * 1e3,
                                  "nvidia_smi": name}), flush=True)
        print(json.dumps({"arch": arch, "this_ms": [m * 1e3 for m in medians["this"]],
                          "other_ms": [m * 1e3 for m in medians["other"]],
                          "nvidia_smi": name}), flush=True)


if __name__ == "__main__":
    main()
