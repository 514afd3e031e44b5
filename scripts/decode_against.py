#!/usr/bin/env python3
"""Times decode of this tree beside another tree's, on one CUDA card, in
turns.

    python3 scripts/decode_against.py OTHER_SRC [--arch A ...] [--pairs N]

Run from the repository root.  ``OTHER_SRC`` is another tree's ``src``
directory (e.g. the parent commit unpacked under ``build/`` by ``git
archive``).  For each ``--arch`` (default gemma3-1b and olmoe-1b-7b), N
pairs (default 2) of runs, each in a fresh process with one tree's ``src``
on its path, the order alternating from pair to pair (this, other, other,
this, ...).  A run makes the serving tree (seed 0, full width and depth)
and times, on 4 slots and a cache of 1024 positions:

* ``ServeEngine``: 4 requests of one prompt token and TICKS new tokens,
  after as many for warm-up (the engine the tree's users run: in a tree
  that captures the step, the captured graph);
* the eager step: TICKS ticks of ``make_serve_step`` on a second cache,
  each token uploaded and its argmax read back, after 2 for warm-up.

Prints one JSON line a run (decode tokens/s of both, ms a tick) and one a
model with both trees' medians, each line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TICKS = 32
RUN = """
import json, sys, time
import numpy as np
import torch
from repro_torch.configs import get
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine, make_serve_step

arch, ticks = sys.argv[1], int(sys.argv[2])
cfg = get(arch)
dev = torch.device("cuda")
model = Model(cfg, dev)
params = model.init(seed=0, serving=True)
engine = ServeEngine(cfg, params, slots=4, max_len=1024, device=dev)
out = {}
for timed in (False, True):
    for rid in range(4):
        engine.submit(Request(rid=rid, prompt=[rid + 1], max_new=ticks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    out["engine_tokens_per_s"] = 4 * ticks / (time.perf_counter() - t0)
step = make_serve_step(cfg)
cache = model.init_cache(4, 1024)
tokens = np.arange(1, 5).reshape(4, 1)
with torch.inference_mode():
    for tick in range(2 + ticks):
        if tick == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        logits, cache = step(engine.params, cache, torch.from_numpy(tokens).to(dev))
        tokens = logits.argmax(dim=-1, keepdim=True).cpu().numpy()
seconds = time.perf_counter() - t0
out["eager_tokens_per_s"] = 4 * ticks / seconds
out["eager_tick_ms"] = seconds / ticks * 1e3
print(json.dumps(out))
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def run(src: Path, arch: str) -> dict:
    """One process with ``src`` on its path: its rates."""
    env = {**os.environ, "PYTHONPATH": str(src)}
    out = subprocess.run([sys.executable, "-c", RUN, arch, str(TICKS)], env=env,
                         check=True, capture_output=True, text=True, cwd=src.parent)
    return json.loads(out.stdout.strip().splitlines()[-1])


def median(values: list[float]) -> float:
    return sorted(values)[len(values) // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--arch", nargs="+", default=["gemma3-1b", "olmoe-1b-7b"])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    trees = {"this": ROOT / "src", "other": args.other_src.resolve()}
    name = card()
    for arch in args.arch:
        runs: dict[str, list[dict]] = {"this": [], "other": []}
        for pair in range(args.pairs):
            for tree in (("this", "other") if pair % 2 == 0 else ("other", "this")):
                out = run(trees[tree], arch)
                runs[tree].append(out)
                print(json.dumps({"arch": arch, "tree": tree, "pair": pair, **out,
                                  "nvidia_smi": name}), flush=True)
        print(json.dumps({"arch": arch, "ticks": TICKS, **{
            f"{tree}_{key}": median([r[key] for r in runs[tree]])
            for tree in runs for key in runs[tree][0]}, "nvidia_smi": name}), flush=True)


if __name__ == "__main__":
    main()
