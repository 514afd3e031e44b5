"""The CUDA flash-attention kernel against its plain version, on the card.

Marked ``cuda``: skipped where there is no card.  Run on a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Tolerance 2e-2 in bf16, as the reference's kernel tests.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under 6 xdist workers

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(dev, b, s, hq, hkv, d, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("s,hq,hkv,d", [
    (128, 4, 4, 32), (130, 4, 2, 128), (64, 8, 1, 80), (200, 4, 1, 128),
    (1, 2, 1, 256), (257, 4, 1, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0),
                                           (False, 48)])
def test_kernel_matches_plain(dev, s, hq, hkv, d, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 2, s, hq, hkv, d)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 1, 16, 2, 1, 48)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(dev, 1, 16, 2, 1, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


def test_forward_on_card_matches_cpu(dev):
    """Small gemma3 config: the card's forward (kernel on every layer) and
    the CPU's (the reference's branches) on the same weights, bf16."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    cfg = get_smoke("gemma3-1b")
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 40))
    want = cpu.forward(params, {"tokens": toks}).float()
    before = fa.launches
    got = Model(cfg, dev).forward(bridge.params_from_numpy(
        bridge.params_to_numpy(params), dev), {"tokens": toks.to(dev)})
    assert fa.launches == before + cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want, atol=5e-2, rtol=5e-2)
