"""Serving driver of the port: continuous decoding over a slot pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --requests 8 --slots 4 --max-new 16 [--smoke] [--device cpu]

``--arch`` takes any ported id: gemma3-1b, mamba2-780m, olmoe-1b-7b (MoE,
the grouped-GEMM kernel), qwen2-moe-a2.7b, hymba-1.5b (attention and SSM
heads in every layer: the flash-attention and SSD-scan kernels),
internvl2-26b (a VLM backbone: the engine decodes tokens; patch
embeddings reach only ``forward``), ...  The weights are made straight in
the compute dtype (``Model.init(serving=True)``), so internvl2-26b's 19.9 B
parameters take 39.8 GB and qwen2-moe-a2.7b runs at full depth on one
card.  hubert-xlarge is encoder-only: there is nothing to decode, and the
command exits saying so.  hymba-1.5b's ``--smoke`` config (SSD state 8)
has no SSD kernel on the card, whose state dims are multiples of 16: run
it with ``--device cpu``.

Full width unless ``--smoke``; on ``cuda`` unless ``--device cpu``.
Runs under the PaPaS engine like any program, e.g. a study with
``command: python -m repro_torch.launch.serve --arch ${args:arch}``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get, get_smoke
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if not cfg.has_decode():
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    model = Model(cfg, args.device)
    params = model.init(args.seed, serving=True)
    engine = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                         device=model.device)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(2, 6)).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    done = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s on {args.slots} slots, "
          f"{model.device})")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.prompt} -> {r.generated[:8]}...")
    return done


if __name__ == "__main__":
    main()
