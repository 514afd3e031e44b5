"""The port's data stream and checkpoints against the JAX package's, on the
CPU: the same batches from (seed, step, host), exactly; checkpoints written
by either package restored by the other, exactly, with the same bytes on
disk; atomic step directories, pruning and resume; the whole train state
across ``repro_torch.bridge`` both ways."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train.step import init_train_state as jinit_train_state  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.pipeline import SyntheticStream, make_stream  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402

torch.set_num_threads(1)   # the suite runs under 6 xdist workers


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
@pytest.mark.parametrize("seed,step,n_hosts,host_id", [
    (0, 0, 1, 0), (5, 2, 1, 0), (7, 123, 2, 1), (1, 9, 4, 3)])
def test_batches_are_the_reference_batches(arch, seed, step, n_hosts, host_id):
    kw = dict(global_batch=8, seq_len=16, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    want = JStream(jget_smoke(arch), **kw).batch_at(step)
    got = SyntheticStream(get_smoke(arch), **kw).batch_at(step)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_stream_is_deterministic_and_stateless():
    cfg = get_smoke("deepseek-7b")
    s1 = SyntheticStream(cfg, global_batch=4, seq_len=8, seed=5)
    s2 = SyntheticStream(cfg, global_batch=4, seq_len=8, seed=5, start_step=2)
    np.testing.assert_array_equal(s1.batch_at(2)["tokens"], next(iter(s2))["tokens"])


def test_host_sharding_partitions_the_batch():
    cfg = get_smoke("deepseek-7b")
    a = SyntheticStream(cfg, global_batch=4, seq_len=8, n_hosts=2, host_id=0)
    b = SyntheticStream(cfg, global_batch=4, seq_len=8, n_hosts=2, host_id=1)
    assert a.local_batch == b.local_batch == 2
    assert not np.array_equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        SyntheticStream(cfg, global_batch=3, seq_len=8, n_hosts=2)


def test_make_stream_reads_the_process_group(monkeypatch):
    cfg = get_smoke("gemma3-1b")
    assert (make_stream(cfg, 4, 8).n_hosts, make_stream(cfg, 4, 8).host_id) == (1, 0)
    monkeypatch.setattr(pipeline, "_hosts", lambda: (2, 1))
    s = make_stream(cfg, 4, 8, seed=3, start_step=7)
    assert (s.n_hosts, s.host_id, s.local_batch, s.start_step) == (2, 1, 2, 7)


def _state_pair(arch="gemma3-1b"):
    """A JAX train state (numpy) and the port's copy of it."""
    jcfg = jget_smoke(arch)
    opt = JAdamW(schedule=jcosine(1e-3, 2, 10))
    jstate = jax.device_get(jinit_train_state(jcfg, opt, jax.random.PRNGKey(4)))
    # non-trivial optimizer leaves and step
    jstate["opt"]["m"] = jax.tree.map(lambda x: x * 0.5 + 0.25, jstate["opt"]["m"])
    jstate["opt"]["count"] = np.asarray(3, np.int32)
    jstate["step"] = np.asarray(3, np.int32)
    return jstate, bridge.params_from_numpy(jstate, "cpu")


def _assert_same(tstate, jstate):
    got = bridge.flatten(bridge.params_to_numpy(tstate))
    want = bridge.flatten(jax.device_get(jstate))
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_bridge_carries_a_whole_train_state_both_ways():
    jstate, tstate = _state_pair("olmoe-1b-7b")
    assert set(tstate) == {"params", "opt", "step"}
    assert set(tstate["opt"]) == {"m", "v", "master", "count"}
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    _assert_same(tstate, jstate)
    back = bridge.params_from_numpy(bridge.params_to_numpy(tstate), "cpu")
    _assert_same(back, jstate)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _state_pair()
    ckpt.save(tstate, tmp_path, 3)
    target = jax.tree.map(jnp.zeros_like, jstate)
    _assert_same(tstate, jckpt.restore(target, tmp_path))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _state_pair("mamba2-780m")
    jckpt.save(jax.tree.map(jnp.asarray, jstate), tmp_path, 3)
    target = jax.tree.map(torch.zeros_like, tstate)
    restored = ckpt.restore(target, tmp_path)
    _assert_same(restored, jstate)
    # same nesting and key order as the target
    assert list(bridge.flatten(restored)) == list(bridge.flatten(target))


def test_both_packages_write_the_same_bytes(tmp_path):
    jstate, tstate = _state_pair()
    jdir = jckpt.save(jax.tree.map(jnp.asarray, jstate), tmp_path / "jax", 3)
    tdir = ckpt.save(tstate, tmp_path / "torch", 3)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_save_is_atomic_prunes_and_finds_the_latest(tmp_path):
    _, tstate = _state_pair()
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tstate, tmp_path)
    (tmp_path / "step_00000009.tmp").mkdir()        # a save cut short
    for step in (1, 2, 3, 4):
        ckpt.save(tstate, tmp_path, step, keep=2)
    assert ckpt.all_steps(tmp_path) == [3, 4] == jckpt.all_steps(tmp_path)
    assert ckpt.latest_step(tmp_path) == 4
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["step"] == 4
    assert manifest["leaves"]["opt/count"]["dtype"] == "int32"


def test_restore_refuses_a_mismatched_target(tmp_path):
    _, tstate = _state_pair()
    ckpt.save(tstate, tmp_path, 1)
    bad = bridge.params_from_numpy(bridge.params_to_numpy(tstate), "cpu")
    bad["params"]["embed"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="embed"):
        ckpt.restore(bad, tmp_path)
    bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(bad, tmp_path)


def test_bf16_leaves_are_stored_widened_and_restored(tmp_path):
    state = {"w": torch.randn(4, 4).to(torch.bfloat16), "n": torch.tensor(2)}
    ckpt.save(state, tmp_path, 1)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "float32"
    back = ckpt.restore(state, tmp_path)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], state["w"])


def test_port_train_state_round_trips(tmp_path):
    cfg = get_smoke("gemma3-1b")
    opt = AdamW(schedule=cosine_schedule(1e-3, 2, 10))
    gen = torch.Generator()
    gen.manual_seed(0)
    state = init_train_state(cfg, opt, gen)
    ckpt.save(state, tmp_path, 0)
    gen.manual_seed(1)
    other = init_train_state(cfg, opt, gen)
    back = ckpt.restore(other, tmp_path, step=0, device="cpu")
    for key, t in bridge.flatten(state).items():
        assert torch.equal(bridge.flatten(back)[key], t), key
