"""The decode step as the serving engine captures it on the card: a step
that replays.  A CUDA graph replays the kernels its capture recorded, with
their arguments, on the same buffers; so the step must read its position
on the device, build nothing from host data and keep every cache leaf's
storage.  Held here on the CPU, on the smoke configs of the serving archs
(a swa ring in gemma3-1b and h2o-danube-1.8b, hymba-1.5b's ``hyb_l``
ring, mamba2's and hymba's conv and SSM states, both MoE configs):

* the step's aten ops, with their non-tensor arguments and their tensors'
  dtypes and shapes, are the same at two positions (one past the ring's
  length where the config has one), and hold no tensor made from host
  data (``aten.lift_fresh``), no ``.item()`` (``aten._local_scalar_dense``)
  and no ``aten.nonzero``;
* after a step every cache leaf has its storage, and ``pos`` is the same
  0-d int32 tensor, one higher;
* the step's logits still match the JAX ``decode_step`` on bridged weights
  (fp32, 1e-4 as ``test_torch_model.py``'s decode test), past the ring.

On a card the graphed engine is held against the eager step
(``tests/test_torch_cuda.py``, marked ``cuda``)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_map as pytree_map  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402

from repro_torch import bridge, kernels  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import decode_step, promote_conv  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, make_serve_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import assert_close  # noqa: E402

ARCHS = ["gemma3-1b", "mamba2-780m", "olmoe-1b-7b", "qwen2-moe-a2.7b",
         "hymba-1.5b", "internvl2-26b", "h2o-danube-1.8b"]
#: ops that read a device value on the host, or make a tensor from host data
FORBIDDEN = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")
BATCH, MAX_LEN = 2, 24          # the smoke window of 16 is a ring of 16


def _ring(cfg) -> int:
    """The ring's length where the config has one (swa or hyb_l), else 0."""
    if any(kind in ("swa", "hyb_l") for kind, _ in cfg.segments()) and cfg.window:
        return min(cfg.window, MAX_LEN)
    return 0


def _sig(x):
    return ("T", x.dtype, tuple(x.shape)) if isinstance(x, torch.Tensor) else x


class _Trace(TorchDispatchMode):
    """Each aten op: its name, and its arguments with every tensor as its
    (dtype, shape) and every other value as it is.  Nothing is recorded
    while ``paused``."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops.append((str(func), pytree_map(_sig, args), pytree_map(_sig, kwargs)))
        return func(*args, **kwargs)


def _model(arch, dtype="float32"):
    cfg = get_smoke(arch, compute_dtype=dtype)
    model = Model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _traced_step(cfg, params, cache, token, monkeypatch):
    """The step's trace.  A grouped GEMM is one launch on the card, whose
    host arguments are its operands' shapes (the kernel reads the group
    sizes on the device): it is recorded as that, while its plain version,
    which reads the group sizes on the host to skip empty experts, runs
    unrecorded."""
    from repro_torch.kernels import moe_gmm
    plain = moe_gmm.grouped_matmul
    trace = _Trace()

    def launch(x, w, group_sizes):
        trace.ops.append(("grouped_matmul kernel", _sig(x), _sig(w), _sig(group_sizes)))
        trace.paused = True
        try:
            return plain(x, w, group_sizes)
        finally:
            trace.paused = False

    monkeypatch.setattr(moe_gmm, "grouped_matmul", launch)
    with torch.inference_mode(), trace:
        decode_step(cfg, params, cache, token)
    monkeypatch.setattr(moe_gmm, "grouped_matmul", plain)
    return trace.ops


@pytest.mark.parametrize("arch", ARCHS)
def test_step_is_the_same_at_every_position(arch, monkeypatch):
    cfg, model, params = _model(arch, "bfloat16")
    cache = model.init_cache(BATCH, MAX_LEN)
    promote_conv(cfg, cache)
    token = torch.tensor([[3], [5]])
    first = _traced_step(cfg, params, cache, token, monkeypatch)
    later = (_ring(cfg) or MAX_LEN // 2) + 3      # past the ring, where there is one
    cache["pos"].fill_(later)
    second = _traced_step(cfg, params, cache, token, monkeypatch)
    moe_layers = sum(n for kind, n in cfg.segments() if kind == "moe")
    assert sum(op[0] == "grouped_matmul kernel" for op in first) == 3 * moe_layers
    bad = sorted({op[0] for op in first + second
                  if op[0].split(".")[:2] in [f.split(".") for f in FORBIDDEN]})
    assert not bad, bad
    assert len(first) == len(second)
    for i, (a, b) in enumerate(zip(first, second)):
        assert a == b, f"op {i} differs between positions 0 and {later}: {a} / {b}"
    assert int(cache["pos"]) == later + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_step_keeps_every_cache_leaf(arch):
    cfg, model, params = _model(arch)
    cache = model.init_cache(BATCH, MAX_LEN)
    promote_conv(cfg, cache)
    pos = cache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int32 and int(pos) == 0
    leaves = tree_leaves(cache)
    storages = [leaf.untyped_storage().data_ptr() for leaf in leaves]
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for t in range(_ring(cfg) + 2):
            token = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1)))
            _, out = decode_step(cfg, params, cache, token)
            assert out["pos"] is pos and int(pos) == t + 1
            assert [leaf.untyped_storage().data_ptr() for leaf in tree_leaves(out)
                    ] == storages


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_jax_past_the_ring(arch):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke(arch, compute_dtype="float32")
    params = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    steps = (_ring(cfg) or 8) + 4
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (BATCH, steps))
    jc = jm.init_cache(BATCH, MAX_LEN, dtype=jax.numpy.float32)
    jstep = jax.jit(jm.decode_step)
    cache = Model(cfg, device="cpu").init_cache(BATCH, MAX_LEN, dtype="float32")
    promote_conv(cfg, cache)
    for t in range(steps):
        want, jc = jstep(jp, jc, jax.numpy.asarray(toks[:, t:t + 1], jax.numpy.int32))
        with torch.inference_mode():
            got, cache = decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]))
        assert_close(got, want, 1e-4)
        assert int(cache["pos"]) == int(jc["pos"]) == t + 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b"])
def test_cpu_engine_is_eager_and_keeps_the_logits(arch):
    """On the CPU the engine captures nothing; its logits are the eager
    step's on the same feed."""
    cfg, _, params = _model(arch)
    engine = ServeEngine(cfg, params, slots=2, max_len=MAX_LEN, device="cpu")
    assert engine.graph is None and engine.replay_launches == {}
    engine.submit(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    engine.submit(Request(rid=1, prompt=[4], max_new=4))
    fed = []
    engine_step = engine.graphed._serve

    def feed(params, cache, token):
        fed.append(token.clone())
        return engine_step(params, cache, token)

    engine.graphed._serve = feed
    step = make_serve_step(cfg)
    cache = Model(cfg, device="cpu").init_cache(2, MAX_LEN)
    while engine.queue or any(engine.active):
        engine.step()
        with torch.inference_mode():
            want, cache = step(engine.params, cache, fed[-1])
        torch.testing.assert_close(engine.logits, want, atol=0, rtol=0)
    assert int(engine.cache["pos"]) == int(cache["pos"]) == len(fed)


def test_launch_counters_add_and_reset():
    """The registry of the wrappers' counters: a replay's counts added,
    all set to 0."""
    from repro_torch.kernels import moe_gmm
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}
    kernels.add_launches({"grouped_matmul": 48, "flash_attention": 2})
    assert moe_gmm.launches == 48
    assert kernels.launch_counts()["flash_attention"] == 2
    kernels.reset_launches()
    assert moe_gmm.launches == 0
