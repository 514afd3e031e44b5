"""Gang training: a study's members trained together in one batched pass
(port of ``repro.train.ensemble``, the paper's job batching on one device).

``train_members``  — one run per member, one after another (the paper's
                     one-job-per-task baseline).
``train_ensemble`` — all members at once: their parameters and optimizer
                     states stacked on a leading member axis of every leaf,
                     each step one forward and backward over all members
                     (every layer under ``torch.func.vmap`` inside its
                     checkpoint; the kernels' vmap rules fold the members
                     into their batch, so a step launches each kernel as
                     often for M members as for one) and one AdamW update
                     under ``torch.func.vmap``, so each member keeps its
                     own gradient clipping, learning rate and decay test.

Members are combo dicts from the study engine, e.g.
``{"args:lr": 3e-4, "args:seed": 1, "args:arch": "gemma3-1b", ...}``; the
shape-affecting keys (arch, steps, batch, seq) must agree.  The public
functions take the smoke config of ``arch``, as the reference does;
:func:`train_gang` under them takes any :class:`ArchConfig`, the members'
initial parameters and their tokens.  Parameters and tokens come from a
``torch.Generator`` seeded by each member's seed (``jax.random`` cannot be
reproduced).  Every ported layer kind batches, MoE and hymba's hybrid
layers included: each member adds its own MoE aux losses to its loss, as
the reference's vmapped ``loss_fn`` does, and a hybrid layer runs its
attention and SSD kernels, each under its own vmap rule, inside one
checkpoint.  The gang takes token batches only, as the reference's does
(``repro.train.ensemble`` draws tokens): a config whose input mode is
``embeds`` or ``mixed`` (hubert-xlarge, internvl2-26b) is refused.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import AdamW, cosine_schedule, value_and_grad
from repro_torch.tree import tree_map


def _arg(m: dict[str, Any], key: str, default: Any) -> Any:
    for k in (key, f"args:{key}"):
        if k in m:
            return m[k]
    return default


def _uniform(members: Sequence[dict], key: str, default: Any) -> Any:
    vals = {repr(_arg(m, key, default)) for m in members}
    if len(vals) != 1:
        raise ValueError(
            f"gang members must share {key!r} (shape-affecting); got {vals}. "
            f"Use mesh-slice / one-per-task for heterogeneous studies.")
    return _arg(members[0], key, default)


def _common(members: Sequence[dict]) -> dict[str, Any]:
    steps = int(_uniform(members, "steps", 20))
    return {"arch": _uniform(members, "arch", "gemma3-1b"), "steps": steps,
            "batch": int(_uniform(members, "batch", 4)),
            "seq": int(_uniform(members, "seq", 64)),
            "warmup": max(1, steps // 10),
            "lrs": [float(_arg(m, "lr", 1e-3)) for m in members],
            "seeds": [int(_arg(m, "seed", 0)) for m in members]}


def stack_members(trees: Sequence[Any]) -> Any:
    """Per-member pytrees of tensors → one pytree whose leaves carry a
    leading member axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def _require_tokens(cfg: ArchConfig) -> None:
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name}: the gang trains on token batches only (rolled tokens "
            f"as labels, as the reference's gang draws them); input mode "
            f"{cfg.input_mode!r} needs batches of embeddings it does not make")


def init_members(cfg: ArchConfig, seeds: Sequence[int], steps: int, batch: int,
                 seq: int, device: torch.device | str
                 ) -> tuple[Any, torch.Tensor]:
    """Each member's initial parameters and tokens from a generator seeded
    by its seed: (stacked parameters, tokens (M, steps, batch, seq))."""
    _require_tokens(cfg)
    params, tokens = [], []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params.append(init_params(cfg, gen))
        tokens.append(torch.randint(0, cfg.vocab_size, (steps, batch, seq),
                                    generator=gen, device=device))
    return stack_members(params), torch.stack(tokens)


def train_gang(cfg: ArchConfig, params: Any, tokens: torch.Tensor,
               lrs: Sequence[float], *, warmup: int) -> torch.Tensor:
    """Trains M members together: ``params`` stacked (a leading member axis
    on every leaf, updated in place), ``tokens`` (M, steps, batch, seq), one
    lr each on a unit-base cosine schedule over the steps.  Each step's
    labels are its tokens rolled by one, as in the reference.  Returns the
    losses (steps, M), each taken before its step's update."""
    _require_tokens(cfg)
    m, steps = tokens.shape[:2]
    if len(lrs) != m:
        raise ValueError(f"{len(lrs)} learning rates for {m} members")
    base = cosine_schedule(1.0, warmup, steps)
    opt = AdamW(schedule=base)
    state = opt.init(params)
    state["count"] = torch.zeros((m,), dtype=torch.int32, device=tokens.device)
    lr = torch.tensor(lrs, dtype=torch.float32, device=tokens.device)

    def gang_loss(p, batch):
        # the sum's gradient is each member's own: members share nothing
        loss, _ = loss_fn(cfg, p, batch, members=True)
        return loss.sum(), {"loss": loss}

    def member_update(grads, opt_state, p, lr_m):
        # the member's lr scales the unit-base schedule
        scaled = AdamW(schedule=lambda c: lr_m * base(c))
        _, new_state, _ = scaled.update(grads, opt_state, p)
        return new_state["count"]

    update = torch.func.vmap(member_update)
    losses = []
    for i in range(steps):
        toks = tokens[:, i]
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
        (_, aux), grads = value_and_grad(gang_loss, params, batch)
        state["count"] = update(grads, state, params, lr)
        losses.append(aux["loss"])
    return torch.stack(losses)


def _run(members: Sequence[dict], device, gang: bool) -> list[float]:
    common = _common(members)
    dev = resolve_device(device)
    cfg = get_smoke(common["arch"])
    groups = ([range(len(members))] if gang
              else [[i] for i in range(len(members))])
    out = []
    for idx in groups:
        params, tokens = init_members(
            cfg, [common["seeds"][i] for i in idx], common["steps"],
            common["batch"], common["seq"], dev)
        losses = train_gang(cfg, params, tokens, [common["lrs"][i] for i in idx],
                            warmup=common["warmup"])
        out += [float(x) for x in losses[-1]]
    return out


def train_members(members: Sequence[dict], *,
                  device: str | torch.device | None = None) -> list[float]:
    """One run per member (baseline): each member's last loss."""
    return _run(members, device, gang=False)


def train_ensemble(members: Sequence[dict], *,
                   device: str | torch.device | None = None) -> list[float]:
    """All members in one batched run (the gang): each member's last loss."""
    return _run(members, device, gang=True)
