"""The port's ServeEngine against the JAX ServeEngine: same bridged
weights, same requests (gemma3, mamba2, olmoe, qwen2-moe, hymba and the
internvl2 backbone smoke, fp32) → the same greedy tokens.  Both engines
keep a slot's cache when a new request takes the slot (for mamba2 and
hymba: its conv and SSM state), so the tokens match only if the port
keeps it too.  hubert is encoder-only: both engines refuse to decode, and
``launch.serve`` exits as the reference's does."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
import torch_parity  # noqa: E402,F401  (thread count)


def _requests(vocab, n, cls):
    rng = np.random.default_rng(5)
    return [cls(rid=i, prompt=rng.integers(0, vocab, rng.integers(2, 6)).tolist(),
                max_new=6) for i in range(n)]


ARCHS = ["gemma3-1b", "mamba2-780m", "olmoe-1b-7b", "qwen2-moe-a2.7b",
         "hymba-1.5b", "internvl2-26b", "hubert-xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(arch):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    cfg = get_smoke(arch, compute_dtype="float32")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.device_get(jparams), "cpu")

    if not cfg.has_decode():
        # encoder-only: the reference's engine fails at its first step, the
        # port's when it makes its cache
        jeng = JServeEngine(jcfg, jparams, slots=3, max_len=32)
        jeng.submit(JRequest(rid=0, prompt=[1, 2], max_new=2))
        with pytest.raises(ValueError, match="encoder-only"):
            jeng.run()
        with pytest.raises(ValueError, match="encoder-only"):
            ServeEngine(cfg, params, slots=3, max_len=32, device="cpu")
        return
    jeng = JServeEngine(jcfg, jparams, slots=3, max_len=32)
    teng = ServeEngine(cfg, params, slots=3, max_len=32, device="cpu")
    for r in _requests(cfg.vocab_size, 7, JRequest):
        jeng.submit(r)
    for r in _requests(cfg.vocab_size, 7, Request):
        teng.submit(r)
    jdone = {r.rid: r.generated for r in jeng.run()}
    tdone = {r.rid: r.generated for r in teng.run()}
    assert sorted(tdone) == list(range(7))
    assert all(len(g) == 6 for g in tdone.values())
    assert tdone == jdone


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    if arch == "hubert-xlarge":
        # as the reference's launch.serve: nothing to decode
        with pytest.raises(SystemExit, match="encoder-only"):
            serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
        return
    done = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
