"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped where there is no card.  Run on a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Tolerances in bf16, as the reference's kernel tests: 2e-2 for flash
attention and the grouped matmul (its dx too; its dw within 2e-2 of each
expert's largest |element|), 5e-2 for the SSD scan.  The flash-attention
backward (no Pallas counterpart) is held against its plain backward at 2e-2
of each row's largest |element| plus 1e-3, the gate of ``chip_smoke.py``;
the SSD backward kernels (no Pallas counterpart either) against theirs at
5e-2 of each (batch, head) slab's largest |element|, the SSD gate.
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
    (1, 2, 1, 256), (257, 4, 1, 256), (72, 4, 4, 16), (1000, 25, 5, 64),
    (1000, 4, 1, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0),
                                           (False, 48), (True, 16)])
def test_kernel_matches_plain(dev, s, hq, hkv, d, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 2, s, hq, hkv, d)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_kernel_is_deterministic(dev):
    """No atomics and no split over keys: two launches on the same inputs
    give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    for d, window in ((256, 512), (128, 0), (64, 16)):
        q, k, v = _qkv(dev, 2, 1000, 8, 2, d)
        first = fa.flash_attention(q, k, v, window=window)
        second = fa.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


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


def _ssd(dev, b, s, h, p, g, n, init, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale
    x = normal(b, s, h, p, scale=0.5).to(torch.bfloat16)
    la = -torch.nn.functional.softplus(normal(b, s, h, scale=1.0)) * 0.3
    bm = normal(b, s, g, n, scale=0.3).to(torch.bfloat16)
    cm = normal(b, s, g, n, scale=0.3).to(torch.bfloat16)
    h0 = normal(b, h, p, n, scale=0.2) if init else None
    return x, la, bm, cm, h0


@pytest.mark.parametrize("s,chunk", [(64, 64), (512, 256), (100, 256),
                                     (192, 64), (48, 16)])
@pytest.mark.parametrize("h,p,g,n", [(4, 64, 1, 128), (6, 64, 2, 64),
                                     (4, 64, 4, 16), (2, 16, 1, 16)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernels_match_plain(dev, s, chunk, h, p, g, n, init):
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0 = _ssd(dev, 2, s, h, p, g, n, init)
    before = (kssd.state_launches, kssd.scan_launches)
    y, final = kssd.ssd_scan(x, la, bm, cm, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert (kssd.state_launches, kssd.scan_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert y.dtype == final.dtype == torch.bfloat16
    want_y, want_final = kssd.ssd_scan_plain(x, la, bm, cm, chunk=chunk,
                                             initial_state=h0)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final.float(), want_final.float(), atol=5e-2,
                               rtol=5e-2)
    prev, final_again = kssd.chunk_state(x, la, bm, chunk=chunk,
                                         initial_state=h0)
    want_prev, _ = kssd.chunk_state_plain(x, la, bm, min(chunk, s), h0)
    torch.testing.assert_close(prev, want_prev, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final_again, final, atol=0, rtol=0)


@pytest.mark.parametrize("s,chunk", [(480, 96), (480, 160), (300, 100)])
@pytest.mark.parametrize("h,p,g,n", [(4, 64, 1, 128), (6, 64, 2, 64),
                                     (4, 64, 4, 16), (2, 16, 1, 16)])
def test_ssd_kernels_match_plain_ragged_chunks(dev, s, chunk, h, p, g, n):
    """Q not a multiple of 64 over several chunks: each chunk's last row
    tile is partial, and the hand-off runs along them."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0 = _ssd(dev, 2, s, h, p, g, n, True, seed=3)
    y, final = kssd.ssd_scan(x, la, bm, cm, chunk=chunk, initial_state=h0)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    want_y, want_final = kssd.ssd_scan_plain(x, la, bm, cm, chunk=chunk,
                                             initial_state=h0)
    want_prev, _ = kssd.chunk_state_plain(x, la, bm, chunk, h0)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final.float(), want_final.float(), atol=5e-2,
                               rtol=5e-2)
    torch.testing.assert_close(prev, want_prev, atol=5e-2, rtol=5e-2)


def test_ssd_hand_off_along_256_chunks(dev):
    """The chained hand-off under stress: 96 (batch, head) chains of 256
    chunks each, 24,576 blocks waiting on one another; it must finish and
    agree with the plain version."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, _ = _ssd(dev, 2, 16384, 48, 64, 1, 128, False, seed=4)
    y, final = kssd.ssd_scan(x, la, bm, cm, chunk=64)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=64)
    torch.cuda.synchronize()
    want_prev, want_final = kssd.chunk_state_plain(x, la, bm, 64)
    torch.testing.assert_close(prev, want_prev, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(final.float(), want_final.float(), atol=5e-2,
                               rtol=5e-2)
    want_y = kssd.chunk_scan_plain(x, la, bm, cm, want_prev, 64)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("s,chunk,h,p,g,n,init", [
    (2048, 256, 48, 64, 1, 128, False), (2048, 256, 50, 64, 1, 16, False),
    (1024, 256, 16, 64, 4, 64, True), (480, 96, 4, 16, 1, 16, True)])
def test_ssd_kernels_are_deterministic(dev, s, chunk, h, p, g, n, init):
    """No atomics in any sum and each state handed on once: two calls on
    the same inputs give the same bits."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0 = _ssd(dev, 2, s, h, p, g, n, init, seed=5)
    first = kssd.chunk_state(x, la, bm, chunk=chunk, initial_state=h0)
    second = kssd.chunk_state(x, la, bm, chunk=chunk, initial_state=h0)
    y1 = kssd.chunk_scan(x, la, bm, cm, first[0], chunk=chunk)
    y2 = kssd.chunk_scan(x, la, bm, cm, first[0], chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(y1, y2)


def test_ssd_kernels_read_strided_b_and_c(dev):
    """B and C as views into one wider (B, S, channels) tensor, the way the
    Mamba2 block hands them over: read in place, same result."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, _ = _ssd(dev, 2, 128, 4, 64, 1, 128, False)
    wide = torch.cat([torch.zeros(2, 128, 64, device=dev, dtype=torch.bfloat16),
                      bm.flatten(2), cm.flatten(2)], dim=-1)
    bv = wide[..., 64:192].reshape(2, 128, 1, 128)
    cv = wide[..., 192:].reshape(2, 128, 1, 128)
    assert not bv.is_contiguous()
    got = kssd.ssd_scan(x, la, bv, cv, chunk=64)
    want = kssd.ssd_scan(x, la, bm, cm, chunk=64)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=0, rtol=0)


def test_ssd_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, _ = _ssd(dev, 1, 64, 2, 64, 1, 128, False)
    with pytest.raises(TypeError, match="bfloat16"):
        kssd.ssd_scan(x.float(), la, bm, cm, chunk=64)
    with pytest.raises(TypeError, match="float32"):
        kssd.ssd_scan(x, la.to(torch.bfloat16), bm, cm, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        kssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), la, bm, cm,
                      chunk=64)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        kssd.ssd_scan(x[:, :48], la[:, :48], bm[:, :48], cm[:, :48], chunk=32)
    with pytest.raises(ValueError, match="not supported"):
        kssd.ssd_scan(x[..., :32].contiguous(), la, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="chunk 512"):
        big = _ssd(dev, 1, 512, 2, 64, 1, 128, False)
        kssd.ssd_scan(*big[:4], chunk=512)


def test_mamba2_forward_on_card_matches_cpu(dev):
    """Small mamba2 config: the card's forward (the SSD kernels on every
    layer) against the CPU's (their plain version), on the same weights."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.models import Model
    cfg = get_smoke("mamba2-780m", use_kernels=True)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 3 * cfg.ssm_chunk))
    want = cpu.forward(params, {"tokens": toks}).float()
    before = (kssd.state_launches, kssd.scan_launches)
    got = Model(cfg, dev).forward(bridge.params_from_numpy(
        bridge.params_to_numpy(params), dev), {"tokens": toks.to(dev)})
    assert (kssd.state_launches, kssd.scan_launches) == (
        before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    torch.testing.assert_close(got.float().cpu(), want, atol=5e-2, rtol=5e-2)


def _gmm_sizes(dev, t, e, kind, seed=0):
    """Group sizes (int32, on the card) summing to t."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sizes = torch.zeros(e, dtype=torch.int32, device=dev)
    if kind == "one":
        sizes[e - 1] = t
    elif kind == "first-empty-last":     # the first and the last group empty
        sizes[1] = t // 3
        sizes[e - 2] += t - t // 3
    else:
        cuts = torch.randint(0, t + 1, (e - 1,), generator=gen, device=dev).sort().values
        sizes = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), t)]
                          ).diff().to(torch.int32)
    return sizes


def _gmm_inputs(dev, t, d, f, e, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    return x, w


GMM_SHAPES = [
    (1, 64, 32, 8),          # one row
    (37, 64, 32, 8),         # smoke widths
    (300, 128, 136, 5),      # f past one column tile, ragged
    (1000, 2048, 1024, 64),  # olmoe widths, most groups short
    (777, 2048, 1408, 60),   # qwen2-moe widths
    (513, 1024, 2048, 16),   # a down projection
    (96, 40, 24, 3),         # d and f not multiples of the tiles
    (300, 1000, 1024, 8),    # a K tail inside the expert (d % 64 = 40)
    (300, 256, 200, 8),      # an N tail (f % 256 = 200, a box across f)
    (65, 128, 256, 4),       # one row past a 64-row warpgroup's half
    (600, 128, 256, 512),    # 512 experts: most empty, many of one row
    (32, 2048, 1024, 64),    # olmoe decode: 4 tokens x top-8
]
GMM_KINDS = ["random", "one", "first-empty-last"]


@pytest.mark.parametrize("t,d,f,e", GMM_SHAPES)
@pytest.mark.parametrize("kind", GMM_KINDS)
def test_gmm_kernel_matches_plain(dev, t, d, f, e, kind):
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, t, d, f, e)
    sizes = _gmm_sizes(dev, t, e, kind)
    before = moe_gmm.launches
    out = moe_gmm.grouped_matmul(x, w, sizes)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (t, f)
    want = moe_gmm.grouped_matmul_plain(x, w, sizes)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


def _slab_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over experts of max |got - want| less 2e-2 of the expert's
    largest |want|; <= 0 passes (an empty expert's slab must be exact)."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax((1, 2)) - 2e-2 * w.abs().amax((1, 2))).max().item()


@pytest.mark.parametrize("t,d,f,e", GMM_SHAPES)
@pytest.mark.parametrize("kind", GMM_KINDS)
def test_gmm_backward_kernels_match_plain(dev, t, d, f, e, kind):
    """dx at the forward's tolerance; dw within 2e-2 of each expert's
    largest |plain|, every element written (the buffer starts as NaN), an
    empty expert's slab exactly zero."""
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, t, d, f, e)
    dy = _gmm_inputs(dev, t, f, 8, 1, seed=1)[0]
    sizes = _gmm_sizes(dev, t, e, kind)
    before = (moe_gmm.dx_launches, moe_gmm.dw_launches)
    dx = moe_gmm.grouped_matmul_dx(dy, w, sizes)
    dw = moe_gmm.grouped_matmul_dw(x, dy, sizes, out=torch.full(
        (e, d, f), float("nan"), dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    assert (moe_gmm.dx_launches, moe_gmm.dw_launches) == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert dx.shape == (t, d) and dw.shape == (e, d, f)
    torch.testing.assert_close(dx.float(), moe_gmm.grouped_matmul_dx_plain(
        dy, w, sizes).float(), atol=2e-2, rtol=2e-2)
    assert bool(torch.isfinite(dw).all())
    assert _slab_err(dw, moe_gmm.grouped_matmul_dw_plain(x, dy, sizes)) <= 0
    assert bool((dw[sizes == 0] == 0).all())


def test_gmm_backward_kernels_are_deterministic(dev):
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, 4096, 1024, 2048, 64)
    dy = _gmm_inputs(dev, 4096, 2048, 8, 1, seed=1)[0]
    sizes = _gmm_sizes(dev, 4096, 64, "random")
    for _ in range(2):
        got = (moe_gmm.grouped_matmul_dx(dy, w, sizes),
               moe_gmm.grouped_matmul_dw(x, dy, sizes))
        if _ == 0:
            first = got
    for a, b in zip(first, got):
        assert torch.equal(a, b)


def _skewed_sizes(dev, t, e, seed=0):
    """Group sizes summing to t: one expert (e // 3) holds half of the rows,
    the others split the rest at random cuts (ragged, off 64-row steps)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    half = t // 2
    cuts = torch.randint(0, t - half + 1, (e - 2,), generator=gen, device=dev).sort().values
    rest = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), t - half)]).diff()
    return torch.cat([rest[:e // 3], rest.new_full((1,), half), rest[e // 3:]]
                     ).to(torch.int32)


@pytest.mark.parametrize("t,d,f,e", [
    (4099, 2048, 1024, 64),   # olmoe gate/up widths
    (4099, 1024, 2048, 64),   # olmoe down
    (2051, 1408, 2048, 60),   # qwen2-moe down: dw's 11 d-tiles, an odd pair
])
def test_gmm_backward_kernels_with_skewed_groups(dev, t, d, f, e):
    """One expert holding half of T (its K several times the others'), the
    rest ragged: dx and dw against the plain versions (dw into a NaN-filled
    buffer, an empty expert's slab exactly zero), and a second run gives
    the same bits."""
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, t, d, f, e)
    dy = _gmm_inputs(dev, t, f, 8, 1, seed=1)[0]
    sizes = _skewed_sizes(dev, t, e)
    assert int(sizes.sum()) == t and int(sizes.max()) == t // 2
    runs = []
    for _ in range(2):
        runs.append((moe_gmm.grouped_matmul_dx(dy, w, sizes),
                     moe_gmm.grouped_matmul_dw(x, dy, sizes, out=torch.full(
                         (e, d, f), float("nan"), dtype=torch.bfloat16, device=dev))))
    torch.cuda.synchronize()
    dx, dw = runs[0]
    torch.testing.assert_close(dx.float(), moe_gmm.grouped_matmul_dx_plain(
        dy, w, sizes).float(), atol=2e-2, rtol=2e-2)
    assert bool(torch.isfinite(dw).all())
    assert _slab_err(dw, moe_gmm.grouped_matmul_dw_plain(x, dy, sizes)) <= 0
    assert bool((dw[sizes == 0] == 0).all())
    assert torch.equal(runs[1][0], dx) and torch.equal(runs[1][1], dw)


def test_grouped_matmul_gives_the_gradient_under_grad(dev):
    """An input that requires grad sends the call through GroupedMatmul:
    one forward launch, one dx and one dw launch in the backward, and the
    plain versions' gradient (dw in w's dtype)."""
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, 1000, 256, 192, 16)
    dy = _gmm_inputs(dev, 1000, 192, 8, 1, seed=1)[0]
    sizes = _gmm_sizes(dev, 1000, 16, "first-empty-last")
    x.requires_grad_(True)
    w.requires_grad_(True)
    before = (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches)
    y = moe_gmm.grouped_matmul(x, w, sizes)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches) == tuple(
        c + 1 for c in before)
    assert dw.dtype == w.dtype and y.requires_grad
    torch.testing.assert_close(dx.float(), moe_gmm.grouped_matmul_dx_plain(
        dy, w.detach(), sizes).float(), atol=2e-2, rtol=2e-2)
    assert _slab_err(dw, moe_gmm.grouped_matmul_dw_plain(x.detach(), dy, sizes)) <= 0


def test_gmm_vmap_rule_folds_members_into_the_expert_axis(dev):
    """Under torch.func.vmap over 3 members the grouped GEMM launches each
    kernel once, forward and backward, and each member's output and
    gradients have the bits of that member alone."""
    from repro_torch.kernels import moe_gmm
    m, t, d, f, e = 3, 700, 256, 128, 8
    xs, ws, dys, ss = [], [], [], []
    for i in range(m):
        x, w = _gmm_inputs(dev, t, d, f, e, seed=i)
        xs.append(x)
        ws.append(w)
        dys.append(_gmm_inputs(dev, t, f, 8, 1, seed=10 + i)[0])
        ss.append(_gmm_sizes(dev, t, e, "random", seed=i))
    x, w = torch.stack(xs).requires_grad_(), torch.stack(ws).requires_grad_()
    sizes, dy = torch.stack(ss), torch.stack(dys)
    before = (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches)
    y = torch.func.vmap(moe_gmm.grouped_matmul)(x, w, sizes)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    assert (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches) == tuple(
        c + 1 for c in before)
    for i in range(m):
        xi, wi = xs[i].clone().requires_grad_(), ws[i].clone().requires_grad_()
        yi = moe_gmm.grouped_matmul(xi, wi, ss[i])
        assert torch.equal(y[i], yi)
        for got, want in zip((gx[i], gw[i]), torch.autograd.grad(yi, (xi, wi), dys[i])):
            assert torch.equal(got, want)


def test_gmm_vmap_rule_folds_a_gang_into_the_most_experts(dev):
    """A gang of 8 members x 64 experts folds into 512 groups, the most the
    kernels take: one launch of each kernel, forward and backward, and each
    member's output and gradients have the bits of that member alone."""
    from repro_torch.kernels import moe_gmm
    m, t, d, f, e = 8, 300, 256, 128, 64
    assert m * e == moe_gmm.MAX_EXPERTS
    xs, ws, dys, ss = [], [], [], []
    for i in range(m):
        x, w = _gmm_inputs(dev, t, d, f, e, seed=i)
        xs.append(x)
        ws.append(w)
        dys.append(_gmm_inputs(dev, t, f, 8, 1, seed=20 + i)[0])
        ss.append(_gmm_sizes(dev, t, e, "random", seed=i))
    x, w = torch.stack(xs).requires_grad_(), torch.stack(ws).requires_grad_()
    sizes, dy = torch.stack(ss), torch.stack(dys)
    before = (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches)
    y = torch.func.vmap(moe_gmm.grouped_matmul)(x, w, sizes)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    assert (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches) == tuple(
        c + 1 for c in before)
    for i in range(m):
        xi, wi = xs[i].clone().requires_grad_(), ws[i].clone().requires_grad_()
        yi = moe_gmm.grouped_matmul(xi, wi, ss[i])
        assert torch.equal(y[i], yi)
        for got, want in zip((gx[i], gw[i]), torch.autograd.grad(yi, (xi, wi), dys[i])):
            assert torch.equal(got, want)


def test_gmm_kernel_is_deterministic(dev):
    """No split-K and no atomics: two calls on the same inputs give the
    same bits, also when a persistent block walks many tiles."""
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, 4096, 1024, 2048, 64)
    sizes = _gmm_sizes(dev, 4096, 64, "random")
    first = moe_gmm.grouped_matmul(x, w, sizes)
    second = moe_gmm.grouped_matmul(x, w, sizes)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_gmm_kernel_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels import moe_gmm
    x, w = _gmm_inputs(dev, 64, 64, 32, 4)
    sizes = _gmm_sizes(dev, 64, 4, "random")
    with pytest.raises(TypeError, match="bfloat16"):
        moe_gmm.grouped_matmul(x.float(), w.float(), sizes)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul(x.t().contiguous().t(), w, sizes)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2), sizes)
    with pytest.raises(ValueError, match="multiples of 8"):
        x12, w12 = _gmm_inputs(dev, 64, 12, 32, 4)
        moe_gmm.grouped_matmul(x12, w12, sizes)
    with pytest.raises(TypeError, match="int32"):
        moe_gmm.grouped_matmul(x, w, sizes.long())
    with pytest.raises(ValueError, match="on cpu"):
        moe_gmm.grouped_matmul(x, w, sizes.cpu())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_moe_forward_on_card_matches_cpu(dev, arch, dispatch):
    """Small MoE configs: the card's forward (the grouped GEMM for every
    expert product, flash attention at head dim 16) against the CPU's
    (their plain versions), on the same weights, bf16."""
    from repro_torch import bridge
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import moe_gmm
    from repro_torch.models import Model
    cfg = get_smoke(arch, moe_dispatch=dispatch)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 40))
    want = cpu.forward(params, {"tokens": toks}).float()
    before = moe_gmm.launches
    got = Model(cfg, dev).forward(bridge.params_from_numpy(
        bridge.params_to_numpy(params), dev), {"tokens": toks.to(dev)})
    assert moe_gmm.launches == before + 3 * cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want, atol=5e-2, rtol=5e-2)


def _grad_calls(dev):
    """name -> (launch count, a call of the wrapper on card tensors, the
    inputs that can require grad)."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, _ = _ssd(dev, 1, 128, 2, 64, 1, 128, False)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=64)
    return {
        "ssd_chunk_state": (lambda: kssd.state_launches,
                            lambda: kssd.chunk_state(x, la, bm, chunk=64),
                            (x, la, bm)),
        "ssd_chunk_scan": (lambda: kssd.scan_launches,
                           lambda: kssd.chunk_scan(x, la, bm, cm, prev, chunk=64),
                           (x, la, bm, cm, prev)),
    }


@pytest.mark.parametrize("name", ["ssd_chunk_state", "ssd_chunk_scan"])
def test_kernels_refuse_a_gradient_they_cannot_give(dev, name):
    """An input that requires grad under grad mode is refused before the
    launch; under no_grad and inference_mode the kernel runs."""
    count, call, inputs = _grad_calls(dev)[name]
    for t in inputs:
        t.requires_grad_(True)
        before = count()
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        assert count() == before
        for mode in (torch.no_grad, torch.inference_mode):
            with mode():
                out = call()
            assert count() == before + 1
            before = count()
            assert not (out[0] if isinstance(out, tuple) else out).requires_grad
        t.requires_grad_(False)
    torch.cuda.synchronize()


def _grad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows (the last dim) of max |got - want| less the allowed
    2e-2 · max |want row| + 1e-3; <= 0 passes."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1) - 2e-2 * w.abs().amax(-1) - 1e-3).max().item()


@pytest.mark.parametrize("s,hq,hkv,d", [
    (128, 4, 4, 32), (130, 4, 2, 128), (64, 8, 1, 80), (200, 4, 1, 128),
    (1, 2, 1, 256), (257, 4, 1, 256), (72, 4, 4, 16), (300, 10, 5, 64),
    (1000, 4, 1, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0),
                                           (False, 48), (True, 16)])
def test_backward_kernel_matches_plain(dev, s, hq, hkv, d, causal, window):
    """The forward's LSE against logsumexp of the plain scores; the backward
    kernels against the plain backward on the same O, LSE and dO."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 2, s, hq, hkv, d)
    do = _qkv(dev, 2, s, hq, hkv, d, seed=1)[0]
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(
        lse, fa.flash_attention_lse_plain(q, k, causal=causal, window=window),
        atol=1e-3, rtol=1e-4)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _grad_err(a, b) <= 0, name


def test_backward_kernel_rows_that_saw_no_key(dev):
    """Rows whose LSE is -inf (the forward's mark for a row that saw no key)
    get a zero dQ and add nothing to dK and dV, as in the plain backward."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 2, 300, 4, 2, 128)
    do = _qkv(dev, 2, 300, 4, 2, 128, seed=1)[0]
    out, lse = fa.flash_attention_with_lse(q, k, v, window=64)
    lse[:, :, 5:70] = float("-inf")
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, window=64)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, window=64)
    assert bool((got[0][:, 5:70] == 0).all())
    for a, b in zip(got, want):
        assert _grad_err(a, b) <= 0


def test_backward_kernel_is_deterministic(dev):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, 2, 1000, 8, 2, 256)
    do = _qkv(dev, 2, 1000, 8, 2, 256, seed=1)[0]
    out, lse = fa.flash_attention_with_lse(q, k, v, window=512)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, window=512)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do, window=512)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (1, 4096, 4, 1, 256, True, 0),     # the dQ hand-off: 64 key tiles add to the last
    (1, 4096, 4, 2, 128, True, 0),     # ... 32 key tiles of 128 rows
    (2, 512, 8, 1, 128, True, 0),      # a GQA group of 8 heads
    (2, 300, 8, 1, 256, True, 96),     # ... at D 256, with a window
    (2, 1000, 4, 2, 80, True, 0),      # S no multiple of a tile
    (2, 1000, 4, 1, 256, False, 200),
    (2, 72, 4, 1, 256, True, 0),
    (2, 72, 8, 1, 64, False, 0),
    (2, 256, 64, 64, 64, True, 0),     # 128 (b, head) pairs: more than a section
])
def test_backward_kernel_hand_off_and_tiles_match_plain(dev, b, s, hq, hkv, d, causal,
                                                        window):
    """The backward against the plain backward where its design is tested:
    long chains of key tiles adding to one query tile's dQ, a GQA group in
    one block or split over several, sequences that end inside a tile, and
    more (batch, head) pairs than one section of blocks."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, b, s, hq, hkv, d)
    do = _qkv(dev, b, s, hq, hkv, d, seed=1)[0]
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _grad_err(a, w) <= 0, name


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (4, 2048, 4, 1, 256, 0),   # gemma3-1b's global layer: chains of 32 key tiles
    (2, 1000, 8, 2, 80, 0),    # D 80, padded to 128 in shared memory
])
def test_backward_kernel_is_deterministic_where_dq_is_handed_off(dev, b, s, hq, hkv, d,
                                                                 window):
    """dQ's parts are added in ascending key-tile order: three calls give the
    same bytes."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(dev, b, s, hq, hkv, d)
    do = _qkv(dev, b, s, hq, hkv, d, seed=1)[0]
    out, lse = fa.flash_attention_with_lse(q, k, v, window=window)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    for _ in range(2):
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=window)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_flash_attention_gives_the_gradient_under_grad(dev):
    """Under grad mode the wrapper goes through the autograd.Function: one
    forward launch, and one backward launch when the gradient is taken; the
    gradients are the plain backward's."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (t.requires_grad_(True) for t in _qkv(dev, 2, 300, 4, 1, 256))
    do = _qkv(dev, 2, 300, 4, 1, 256, seed=1)[0]
    fwd, bwd = fa.launches, fa.bwd_launches
    out = fa.flash_attention(q, k, v, window=128)
    assert out.requires_grad and fa.launches == fwd + 1
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert fa.bwd_launches == bwd + 1
    with torch.no_grad():
        lse = fa.flash_attention_lse_plain(q, k, window=128)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, window=128)
    for a, b in zip(grads, want):
        assert _grad_err(a, b) <= 0


def test_gemma3_trains_on_card_through_the_backward_kernel(dev):
    """launch.train on the card at smoke size: every attention of a step
    goes through the kernels (2 forward launches a layer with the full
    remat, 1 backward), and the loss is finite."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    cfg = get_smoke("gemma3-1b")
    fa.launches = fa.bwd_launches = 0
    out = train.main(["--arch", "gemma3-1b", "--smoke", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--log-every", "1"])
    torch.cuda.synchronize()
    assert out["steps_run"] == 2 and out["loss"] == out["loss"]
    assert (fa.launches, fa.bwd_launches) == (4 * cfg.n_layers, 2 * cfg.n_layers)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_moe_trains_on_card_through_the_gmm_backward_kernels(dev, arch):
    """launch.train on a smoke MoE config: finite losses, and a step's
    launches 6 forward grouped GEMMs a layer (3 and 3 recomputed by the full
    remat), 3 dx and 3 dw."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch import train
    cfg = get_smoke(arch)
    moe_gmm.launches = moe_gmm.dx_launches = moe_gmm.dw_launches = 0
    out = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                      "--seq", "32", "--log-every", "1"])
    torch.cuda.synchronize()
    assert out["steps_run"] == 2 and out["loss"] == out["loss"]
    n = cfg.n_layers
    assert (moe_gmm.launches, moe_gmm.dx_launches, moe_gmm.dw_launches) == (
        12 * n, 6 * n, 6 * n)


def test_mamba2_trains_on_card_through_the_ssd_backward_kernels(dev):
    """launch.train of the smoke mamba2 on the card: each layer's SSD runs
    the forward kernels twice (the full remat) and the backward kernels
    once a step, and the loss is finite."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train
    cfg = get_smoke("mamba2-780m")
    kssd.state_launches = kssd.scan_launches = 0
    kssd.state_bwd_launches = kssd.scan_bwd_launches = 0
    out = train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                      "--batch", "2", "--seq", "32", "--log-every", "1"])
    torch.cuda.synchronize()
    assert out["steps_run"] == 2 and out["loss"] == out["loss"]
    n = 2 * cfg.n_layers
    assert (kssd.state_launches, kssd.scan_launches, kssd.state_bwd_launches,
            kssd.scan_bwd_launches) == (2 * n, 2 * n, n, n)


def _slab_over(got: torch.Tensor, want: torch.Tensor, keep: tuple[int, ...],
               tol: float = 5e-2) -> float:
    """max over slabs (one index of the ``keep`` dims: a (batch, head)) of
    max |got - want| less tol · max |want|; <= 0 passes."""
    g, w = got.float(), want.float()
    rest = [d for d in range(g.dim()) if d not in keep]
    return ((g - w).abs().amax(rest) - tol * w.abs().amax(rest)).max().item()


#: the dims of a (batch, head) slab of each backward output (dB and dC: a
#: (batch, group))
_BWD_KEEP = {"gnext": (0, 1), "dinit": (0, 1), "dT": (0, 1), "dx": (0, 2),
             "dlog_a": (0, 2), "dB": (0, 2), "dC": (0, 2)}


def _ssd_bwd_case(dev, b, s, h, p, g, n, chunk, init, seed=6):
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0 = _ssd(dev, b, s, h, p, g, n, init, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
    dfinal = (torch.randn((b, h, p, n), generator=gen, device=dev)
              if init else None)
    prev, _ = kssd.chunk_state(x, la, bm, chunk=chunk, initial_state=h0)
    return x, la, bm, cm, h0, dy, dfinal, prev


def _slices_summed(out):
    """The scan backward's outputs with dB's and dC's slices added."""
    dx, dla, db, dc = out
    return dx, dla, db.sum(3), dc.sum(3)


@pytest.mark.parametrize("h,p,g,n", [(4, 64, 1, 128), (6, 64, 2, 64),
                                     (4, 64, 4, 16), (2, 16, 1, 16)])
@pytest.mark.parametrize("s,chunk,init", [(512, 256, False), (480, 96, True),
                                          (64, 64, True)])
def test_ssd_backward_kernels_match_plain(dev, h, p, g, n, s, chunk, init):
    """Each backward kernel against its plain version on the same inputs
    (the scan kernel on the plain state pass's outputs), every output
    within 5e-2 of its (batch, head) slab's largest |plain|; then the whole
    gradient of ``ssd_scan`` under autograd against ``ssd_scan_bwd_plain``."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0, dy, dfinal, prev = _ssd_bwd_case(dev, 2, s, h, p, g, n,
                                                        chunk, init)
    q = min(chunk, s)
    before = (kssd.scan_bwd_launches, kssd.state_bwd_launches)
    got = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk, dfinal=dfinal)
    want = kssd.chunk_state_bwd_plain(dy, la, cm, prev, q, dfinal)
    for name, a, w in zip(("gnext", "dinit", "dT"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert _slab_over(a, w, _BWD_KEEP[name]) <= 0, name
    got = kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, want[0], want[2], chunk=chunk)
    want = kssd.chunk_scan_bwd_plain(x, la, bm, cm, prev, dy, want[0], want[2], q)
    torch.cuda.synchronize()
    assert (kssd.scan_bwd_launches, kssd.state_bwd_launches) == (before[0] + 1,
                                                                 before[1] + 1)
    assert got[0].dtype == torch.bfloat16 and got[2].shape[:3] == (2, s, g)
    for name, a, w in zip(("dx", "dlog_a", "dB", "dC"), _slices_summed(got),
                          _slices_summed(want)):
        assert a.shape == w.shape, name
        assert _slab_over(a, w, _BWD_KEEP[name]) <= 0, name
    # the whole gradient through the autograd.Function
    ins = [t.clone().requires_grad_() for t in (x, la, bm, cm)] + (
        [h0.clone().requires_grad_()] if init else [])
    y, final = kssd.ssd_scan(*ins[:4], chunk=chunk,
                             initial_state=ins[4] if init else None)
    outs, cots = (y, final) if init else (y,), (dy, dfinal.to(final.dtype)) if init else (dy,)
    grads = torch.autograd.grad(outs, ins, cots)
    want = kssd.ssd_scan_bwd_plain(x, la, bm, cm, prev, dy, q, dfinal.to(final.dtype) if init else None,
                                   h0)
    for name, a, w, keep in zip(("dx", "dlog_a", "dB", "dC", "dinit"), grads, want,
                                ((0, 2), (0, 2), (0, 2), (0, 2), (0, 1))):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert _slab_over(a, w, keep) <= 0, name


@pytest.mark.parametrize("s,chunk,h,p,g,n,init", [
    (2048, 256, 48, 64, 1, 128, True), (2048, 256, 50, 64, 1, 16, False),
    (480, 96, 4, 16, 1, 16, True)])
def test_ssd_backward_kernels_are_deterministic(dev, s, chunk, h, p, g, n, init):
    """No atomics in any sum and each G handed on once: two calls give the
    same bits."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0, dy, dfinal, prev = _ssd_bwd_case(dev, 2, s, h, p, g, n,
                                                        chunk, init, seed=8)
    runs = []
    for _ in range(2):
        state = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=chunk, dfinal=dfinal)
        runs.append(state + kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, state[0],
                                                state[2], chunk=chunk))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_ssd_backward_hand_off_along_256_chunks(dev):
    """The reverse hand-off under stress: 96 chains of 256 chunks."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0, dy, dfinal, prev = _ssd_bwd_case(dev, 2, 16384, 48, 64, 1,
                                                        128, 64, False, seed=9)
    want = kssd.chunk_state_bwd_plain(dy, la, cm, prev, 64)
    got = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=64)
    torch.cuda.synchronize()
    for name, a, w in zip(("gnext", "dinit", "dT"), got, want):
        assert _slab_over(a, w, _BWD_KEEP[name]) <= 0, name


@pytest.mark.parametrize("h,g,slices", [(6, 2, 1), (26, 1, 13), (24, 2, 1)])
def test_ssd_backward_sums_db_and_dc_over_a_groups_heads(dev, h, g, slices):
    """dB and dC leave the scan's backward summed over each block's heads
    (``slices`` per group); added up they are the plain sum over the
    group's heads."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, bm, cm, h0, dy, dfinal, prev = _ssd_bwd_case(dev, 2, 512, h, 64, g, 64,
                                                        256, False, seed=10)
    gnext, _, d_total = kssd.chunk_state_bwd_plain(dy, la, cm, prev, 256)
    got = kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total)
    want = kssd.chunk_scan_bwd_plain(x, la, bm, cm, prev, dy, gnext, d_total, 256)
    torch.cuda.synchronize()
    assert got[2].shape == got[3].shape == (2, 512, g, slices, 64)
    for name, a, w in zip(("dB", "dC"), _slices_summed(got)[2:], _slices_summed(want)[2:]):
        assert _slab_over(a, w, _BWD_KEEP[name]) <= 0, name


def test_ssd_backward_of_a_gang_equals_each_member_alone(dev):
    """Under torch.func.vmap over two members the SSD backward launches
    each kernel once, and every member's gradients have the same bits as
    that member's alone (the heads a block walks do not depend on the
    batch, and the slices are added elementwise)."""
    from repro_torch.kernels import ssd_scan as kssd
    m = 2
    cases = [_ssd(dev, 2, 512, 48, 64, 1, 128, True, seed=40 + i) for i in range(m)]
    ins = [torch.stack(t).requires_grad_() for t in list(zip(*cases))]
    dy = torch.stack([_qkv(dev, 2, 512, 48, 1, 64, seed=50 + i)[0] for i in range(m)])
    before = (kssd.state_bwd_launches, kssd.scan_bwd_launches)
    y, _ = torch.func.vmap(lambda x, la, b, c, h0: kssd.ssd_scan(
        x, la, b, c, chunk=256, initial_state=h0))(*ins)
    grads = torch.autograd.grad(y, ins, dy)
    assert (kssd.state_bwd_launches, kssd.scan_bwd_launches) == (before[0] + 1,
                                                                 before[1] + 1)
    for i in range(m):
        mine = [t[i].detach().requires_grad_() for t in ins]
        wy, _ = kssd.ssd_scan(*mine[:4], chunk=256, initial_state=mine[4])
        for g_, w_ in zip(grads, torch.autograd.grad(wy, mine, dy[i])):
            assert torch.equal(g_[i], w_)


def test_vmap_rules_launch_once_for_all_members(dev):
    """Under torch.func.vmap over 3 members, flash attention and the SSD
    scan launch each kernel once, forward and backward, and agree with a
    loop over the members."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as kssd
    m = 3
    q, k, v = (torch.stack(t) for t in zip(*[_qkv(dev, 2, 200, 4, 1, 128, seed=i)
                                            for i in range(m)]))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    do = torch.stack([_qkv(dev, 2, 200, 4, 1, 128, seed=10 + i)[0] for i in range(m)])
    before = (fa.launches, fa.bwd_launches)
    out = torch.func.vmap(lambda a, b, c: fa.flash_attention(a, b, c, window=64))(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    for i in range(m):
        mine = [t[i].detach().requires_grad_() for t in (q, k, v)]
        want = fa.flash_attention(*mine, window=64)
        torch.testing.assert_close(out[i], want, atol=2e-2, rtol=2e-2)
        for g_, w_ in zip(grads, torch.autograd.grad(want, mine, do[i])):
            assert _grad_err(g_[i], w_) <= 0

    cases = [_ssd(dev, 2, 512, 4, 64, 1, 128, True, seed=20 + i) for i in range(m)]
    ins = [torch.stack(t).requires_grad_() for t in list(zip(*cases))[:4]]
    dy = torch.stack([_qkv(dev, 2, 512, 4, 1, 64, seed=30 + i)[0] for i in range(m)])
    counts = lambda: (kssd.state_launches, kssd.scan_launches,
                      kssd.state_bwd_launches, kssd.scan_bwd_launches)
    before = counts()
    y, _ = torch.func.vmap(lambda *a: kssd.ssd_scan(*a, chunk=256))(*ins)
    grads = torch.autograd.grad(y, ins, dy)
    assert counts() == tuple(c + 1 for c in before)
    for i in range(m):
        mine = [t[i].detach().requires_grad_() for t in ins]
        wy, _ = kssd.ssd_scan(*mine, chunk=256)
        assert _slab_over(y[i], wy, (0, 2)) <= 0
        for g_, w_ in zip(grads, torch.autograd.grad(wy, mine, dy[i])):
            assert _slab_over(g_[i], w_, (0, 2)) <= 0
