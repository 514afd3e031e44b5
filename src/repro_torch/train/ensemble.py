"""Gang training: a study's members trained together in one batched pass
(port of ``repro.train.ensemble``, the paper's job batching on one device).

``train_members``  — one run per member, one after another (the paper's
                     one-job-per-task baseline), each member loaded into
                     the first one's buffers, so one capture serves all.
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

The reference compiles each run whole; here a run is a :class:`Gang`,
whose step is captured as a CUDA graph on the card and replayed.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.capture import CapturedStep
from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.optim.adamw import AdamW, cosine_schedule, value_and_grad
from repro_torch.tree import tree_leaves, tree_map


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


#: the member keys that shape a run, with their defaults: one gang's
#: members share them
SHAPE_KEYS = (("arch", "gemma3-1b"), ("steps", 20), ("batch", 4), ("seq", 64))


def shape_key(member: dict[str, Any]) -> tuple[str, ...]:
    """The values of :data:`SHAPE_KEYS` ``member`` runs with: members with
    the same key stack into one gang."""
    return tuple(repr(_arg(member, key, default)) for key, default in SHAPE_KEYS)


def _common(members: Sequence[dict]) -> dict[str, Any]:
    arch, steps, batch, seq = (_uniform(members, key, default)
                               for key, default in SHAPE_KEYS)
    steps = int(steps)
    return {"arch": arch, "steps": steps, "batch": int(batch), "seq": int(seq),
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


class Gang(CapturedStep):
    """M members trained together, one batched step at a time: ``params``
    stacked (a leading member axis on every leaf, updated in
    place), their AdamW state, ``tokens`` (M, steps, batch, seq) and one lr
    each on a unit-base cosine schedule over the steps.  Each step takes
    its tokens through :attr:`index`, a 0-d int64 on the device that the
    step advances in place, labels them with the tokens rolled by one, as
    in the reference, and writes each member's loss, taken before the
    update, into row ``index`` of :attr:`losses` (steps, M).

    The reference compiles the whole gang as one program
    (``jax.jit(jax.vmap(train_one))``); here the step is a
    :class:`repro_torch.capture.CapturedStep`: on a card the first
    :meth:`step` runs eagerly, the warm-up, and every later one replays
    one captured CUDA graph.  :meth:`load` puts other members' parameters
    and tokens into the same buffers and resets the optimizer state, so
    one capture serves a run of members one after another."""

    def __init__(self, cfg: ArchConfig, params: Any, tokens: torch.Tensor,
                 lrs: Sequence[float], *, warmup: int) -> None:
        _require_tokens(cfg)
        m, steps = tokens.shape[:2]
        if len(lrs) != m:
            raise ValueError(f"{len(lrs)} learning rates for {m} members")
        dev = tokens.device
        super().__init__(dev)
        self.cfg, self.params, self.tokens = cfg, params, tokens
        base = cosine_schedule(1.0, warmup, steps)
        self.opt_state = AdamW(schedule=base).init(params)
        self.opt_state["count"] = torch.zeros((m,), dtype=torch.int32, device=dev)
        self.lr = torch.tensor(lrs, dtype=torch.float32, device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses = torch.zeros((steps, m), dtype=torch.float32, device=dev)
        self.steps_run = 0

        def member_update(grads, opt_state, p, lr_m):
            # the member's lr scales the unit-base schedule
            scaled = AdamW(schedule=lambda c: lr_m * base(c))
            return scaled.update(grads, opt_state, p)[2]

        self._update = torch.func.vmap(member_update)

    def _loss(self, p, batch):
        # the sum's gradient is each member's own: members share nothing
        loss, _ = loss_fn(self.cfg, p, batch, members=True)
        return loss.sum(), {"loss": loss}

    def _eager_step(self) -> None:
        toks = self.tokens.index_select(1, self.index.view(1)).squeeze(1)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
        (_, aux), grads = value_and_grad(self._loss, self.params, batch)
        self._update(grads, self.opt_state, self.params, self.lr)
        self.losses.index_copy_(0, self.index.view(1), aux["loss"][None])
        self.index.add_(1)

    def step(self) -> None:
        """One step of every member: eager on the CPU and at the first step
        on a card, a replay of the captured step after it."""
        if self.steps_run == self.losses.shape[0]:
            raise ValueError(f"the gang has run its {self.steps_run} steps")
        self.steps_run += 1
        self._run_step()

    def run(self) -> torch.Tensor:
        """The steps not run yet; returns :attr:`losses`."""
        while self.steps_run < self.losses.shape[0]:
            self.step()
        return self.losses

    @torch.no_grad()
    def load(self, params: Any, tokens: torch.Tensor, lrs: Sequence[float]) -> None:
        """Other members of the same shapes into the buffers, from step 0:
        their parameters, tokens and lrs copied in, the optimizer state as
        ``AdamW.init`` makes it, the index and losses zeroed."""
        for dst, src in zip(tree_leaves(self.params), tree_leaves(params)):
            dst.copy_(src)
        self.tokens.copy_(tokens)
        self.lr.copy_(torch.tensor(lrs, dtype=torch.float32))
        for key in ("m", "v"):
            for leaf in tree_leaves(self.opt_state[key]):
                leaf.zero_()
        for dst, src in zip(tree_leaves(self.opt_state["master"]), tree_leaves(params)):
            dst.copy_(src)
        for t in (self.opt_state["count"], self.index, self.losses):
            t.zero_()
        self.steps_run = 0


def train_gang(cfg: ArchConfig, params: Any, tokens: torch.Tensor,
               lrs: Sequence[float], *, warmup: int) -> torch.Tensor:
    """Trains M members together (:class:`Gang`): ``params`` stacked (a
    leading member axis on every leaf, updated in place), ``tokens`` (M,
    steps, batch, seq), one lr each on a unit-base cosine schedule over the
    steps.  Returns the losses (steps, M), each taken before its step's
    update."""
    return Gang(cfg, params, tokens, lrs, warmup=warmup).run()


def _run(members: Sequence[dict], device, gang: bool) -> list[float]:
    common = _common(members)
    dev = resolve_device(device)
    cfg = get_smoke(common["arch"])
    groups = ([range(len(members))] if gang
              else [[i] for i in range(len(members))])
    out = []
    run = None
    for idx in groups:
        params, tokens = init_members(
            cfg, [common["seeds"][i] for i in idx], common["steps"],
            common["batch"], common["seq"], dev)
        lrs = [common["lrs"][i] for i in idx]
        if run is None:
            run = Gang(cfg, params, tokens, lrs, warmup=common["warmup"])
        else:
            # one member after another on the first one's buffers (and, on
            # a card, its captured step)
            run.load(params, tokens, lrs)
        out += [float(x) for x in run.run()[-1]]
    return out


def train_members(members: Sequence[dict], *,
                  device: str | torch.device | None = None) -> list[float]:
    """One run per member (baseline): each member's last loss."""
    return _run(members, device, gang=False)


def train_ensemble(members: Sequence[dict], *,
                   device: str | torch.device | None = None) -> list[float]:
    """All members in one batched run (the gang): each member's last loss."""
    return _run(members, device, gang=True)
