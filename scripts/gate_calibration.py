#!/usr/bin/env python3
"""Measures what two of chip_smoke.py's gates rest on, on one CUDA card.

    python3 scripts/gate_calibration.py rounding   # internvl2-26b, ~30 s
    python3 scripts/gate_calibration.py learning   # hubert-xlarge, ~40 s

Run from the repository root; each prints one JSON line a measurement.

``rounding``: internvl2-26b at full width and depth, from the serving init,
on one (1, 2048) batch of 256 patch embeddings and 1792 tokens (drawn as
chip_smoke's check draws its own).  The logits of the forward with the flash-attention
kernel and of the same forward with the plain attention, both bf16, beside
(a) the same plain forward computed in fp32 from the same weights, (b) the
plain forward with its patch embeddings moved by about one bf16 step
(x (1 + 2**-7)), and (c) the kernel-vs-plain difference at cuts of 6, 12,
24 and 48 layers.  Each difference as max and mean |Δ| over the logits'
std, and the positions whose argmax agrees.  If the kernel and the plain
forward are equally far from fp32, and moving the input by one bf16 step
moves the logits as far as the kernel does, the difference is rounding
amplified by the model, not the kernel.

``learning``: hubert-xlarge at full width and depth, 8 AdamW steps on one
repeated (4, 2048) batch, as chip_smoke's ``train_checks``: the data
stream's batch (frames and labels drawn independently), and the same batch
with its frames drawn about their labels' centroids
(``chip_smoke.clustered_frames``), each at learning rates 1e-3, 3e-4 and
1e-4; the losses, the gradient norms and the last loss over the first.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def difference(got: torch.Tensor, want: torch.Tensor, spread: float) -> dict:
    diff = (got - want).abs()
    return {"max_rel_to_std": diff.max().item() / spread,
            "mean_rel_to_std": diff.mean().item() / spread,
            "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum())}


def cut_params(params: dict, layers: int) -> dict:
    """The first ``layers`` layers of a one-segment tree, as views."""
    def first(node):
        return {k: first(v) for k, v in node.items()} if isinstance(node, dict) else node[:layers]
    return {**params, "segments": [first(params["segments"][0])]}


def rounding(dev, card) -> None:
    from repro_torch.configs import get
    from repro_torch.models import Model, synthetic_batch
    cfg = get("internvl2-26b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    model = Model(cfg, dev)
    params = model.init(seed=0, serving=True)
    one = cs.model_inputs(synthetic_batch(cfg, 1, cs.PREFILL_SEQ, gen, dev))
    moved = {**one, "patch_embeds": (one["patch_embeds"].float()
                                     * (1 + 2 ** -7)).to(torch.bfloat16)}
    with torch.inference_mode():
        kernel = model.forward(params, one)[0].float()
        with cs.plain_kernels():
            plain = model.forward(params, one)[0].float()
            plain_moved = model.forward(params, moved)[0].float()
            exact = Model(dataclasses.replace(cfg, compute_dtype="float32"), dev).forward(
                params, one)[0].float()
    spread = plain.std().item()
    cs.emit("rounding", arch=cfg.name, layers=cfg.n_layers, seq=cs.PREFILL_SEQ,
            patches=int(one["patch_embeds"].shape[1]), logit_std=spread,
            fp32_logit_std=exact.std().item(),
            kernel_vs_plain=difference(kernel, plain, spread),
            kernel_vs_fp32=difference(kernel, exact, exact.std().item()),
            plain_vs_fp32=difference(plain, exact, exact.std().item()),
            plain_vs_input_moved=difference(plain_moved, plain, spread),
            moved_elements=int((moved["patch_embeds"] != one["patch_embeds"]).sum()),
            patch_elements=one["patch_embeds"].numel(), nvidia_smi=card)
    del kernel, plain, plain_moved, exact
    for layers in (6, 12, 24, 48):
        cut = Model(cs.cut_depth(cfg, layers), dev)
        part = cut_params(params, layers)
        with torch.inference_mode():
            kernel = cut.forward(part, one)[0].float()
            with cs.plain_kernels():
                plain = cut.forward(part, one)[0].float()
        cs.emit("rounding_by_depth", arch=cfg.name, layers=layers,
                logit_std=plain.std().item(),
                kernel_vs_plain=difference(kernel, plain, plain.std().item()),
                nvidia_smi=card)


def learning(dev, card) -> None:
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_stream
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get("hubert-xlarge")
    stream = {k: torch.from_numpy(v).to(dev) for k, v in
              make_stream(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0).batch_at(0).items()}
    for frames, lr in (("stream", 1e-3), ("stream", 3e-4), ("stream", 1e-4),
                       ("clustered", 1e-3), ("clustered", 3e-4), ("clustered", 1e-4)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        batch = cs.clustered_frames(stream, gen) if frames == "clustered" else stream
        opt = AdamW(schedule=cosine_schedule(lr, 1, cs.LEARN_STEPS), weight_decay=0.0)
        state = init_train_state(cfg, opt, gen)
        step = make_train_step(cfg, opt)
        losses, norms = [], []
        for _ in range(cs.LEARN_STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        cs.emit("learning", arch=cfg.name, frames=frames, lr=lr, losses=losses,
                grad_norms=norms, last_over_first=losses[-1] / losses[0],
                bound_last_over_first=cs.LEARN_DROP, nvidia_smi=card)
        del state, step
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gate_calibration: no CUDA device")
    parts = sys.argv[1:] or ["rounding", "learning"]
    if not set(parts) <= {"rounding", "learning"}:
        raise SystemExit(f"unknown part(s) {parts}: rounding, learning")
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    dev, card = resolve_device(), cs.nvidia_smi()
    cs.emit("build", seconds=_build.build(), nvidia_smi=card)
    for part in parts:
        {"rounding": rounding, "learning": learning}[part](dev, card)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
