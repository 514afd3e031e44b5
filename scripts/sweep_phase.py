#!/usr/bin/env python3
"""``chip_smoke.py``'s sweep phase alone, on one CUDA card: the port's
PaPaS driver on a study of gemma3-1b smoke training runs as one gang, one
dispatch a task and on two threads, then ``python -m
repro_torch.launch.sweep`` with jax, yaml and the reference blocked on an
olmoe-1b-7b gang, a study over the 8 token-input architectures as 8 gangs
and one dispatch a task, one real-size hymba-1.5b ``launch.train`` as a
shell task, and the SSD kernels' (16, 8) instance against its plain
versions (``chip_smoke.sweep_path``).

    python3 scripts/sweep_phase.py

Run from the repository root.  Builds the kernels first (``_build.build``),
then prints the environment, build and sweep phases as JSON lines, each
with the card's name and power limit; any failed gate raises.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> None:
    dev = resolve_device()
    card = cs.nvidia_smi()
    cs.emit("environment", nvidia_smi=card, torch=torch.__version__,
            cuda=torch.version.cuda, python=sys.version.split()[0])
    cs.emit("build", seconds=_build.build())
    cs.emit("done", kernels=cs.sweep_path(dev, card))


if __name__ == "__main__":
    main()
