"""The kernel wrappers' contract where there is no card.

* A tensor off the CPU that requires grad while grad mode is on is
  refused before any launch by the two SSD-scan kernels' wrappers called
  alone (they have no backward of their own); under ``no_grad`` or
  ``inference_mode``, or without ``requires_grad``, the wrapper goes on to
  its checks.  Flash attention, the whole SSD scan and the grouped GEMM
  have a backward: under grad (or, for the grouped GEMM, under vmap)
  their wrappers go through their ``autograd.Function`` instead of any
  guard.  Meta tensors
  stand in for a card's: they reach the same branch and fail later, at the
  device check, never at a launch.
* CPU tensors still take the plain versions, which differentiate.
* Each ``bind`` declares the C entry points of its CUDA source as the
  source defines them (read from the source: no compiler needed).
"""
import ctypes
import re
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402

GRAD_ERROR = "requires grad"


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


def _calls(grad: bool):
    """name -> a call of one wrapper on meta tensors; ``grad`` marks one
    input as requiring grad."""
    def fa_call():
        q = _meta(1, 64, 2, 64, grad=grad)
        k = _meta(1, 64, 1, 64)
        return fa.flash_attention(q, k, k)

    def gmm_call():
        x = _meta(64, 64)
        w = _meta(4, 64, 32, grad=grad)
        return moe_gmm.grouped_matmul(x, w, _meta(4, dtype=torch.int32))

    def state_call():
        x = _meta(1, 64, 2, 64)
        la = _meta(1, 64, 2, dtype=torch.float32, grad=grad)
        b = _meta(1, 64, 1, 128)
        return kssd.chunk_state(x, la, b, chunk=64)

    def scan_call():
        x = _meta(1, 64, 2, 64)
        la = _meta(1, 64, 2, dtype=torch.float32)
        b = _meta(1, 64, 1, 128, grad=grad)
        prev = _meta(1, 2, 1, 64, 128, dtype=torch.float32)
        return kssd.chunk_scan(x, la, b, b, prev, chunk=64)

    return {"flash_attention": fa_call, "grouped_matmul": gmm_call,
            "ssd_chunk_state": state_call, "ssd_chunk_scan": scan_call}


@pytest.fixture
def meta_is_card(monkeypatch):
    """The SSD wrappers ask ``_on_card`` first: a meta tensor passes as a
    card's, so that the guard after it is reached."""
    monkeypatch.setattr(kssd, "_on_card", lambda x: True)


WRAPPERS = sorted(_calls(False))
#: the wrappers whose kernels have no backward, so refuse a gradient
GUARDED = [name for name in WRAPPERS if name not in ("flash_attention", "grouped_matmul")]


@pytest.mark.parametrize("name", GUARDED)
def test_guard_refuses_grad_before_any_launch(meta_is_card, monkeypatch, name):
    def no_launch(*a, **k):
        raise AssertionError("a kernel was built or launched")

    monkeypatch.setattr(_build, "library", no_launch)
    with pytest.raises(RuntimeError, match=GRAD_ERROR) as err:
        _calls(True)[name]()
    assert name in str(err.value)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no input needs grad"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_guard_lets_calls_without_grad_through(meta_is_card, mode, name):
    """Past the guard, the meta tensors fail at the device check (not a
    card), never at the guard."""
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no input needs grad": torch.enable_grad}[mode]
    with ctx(), pytest.raises((ValueError, RuntimeError)) as err:
        _calls(mode != "no input needs grad")[name]()
    assert GRAD_ERROR not in str(err.value)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_under_grad_reaches_its_autograd_function(monkeypatch, which):
    """An input that requires grad under grad mode sends the call through
    ``FlashAttention`` (forward saving the LSE for the backward kernels),
    which fails at the device check on a meta tensor: no guard, no build,
    no launch."""
    def no_launch(*a, **k):
        raise AssertionError("a kernel was built or launched")

    entered = []
    forward = fa.FlashAttention.forward

    def spy(*args):   # the setup_context form: forward takes no ctx
        entered.append(args[3:])
        return forward(*args)

    monkeypatch.setattr(_build, "library", no_launch)
    monkeypatch.setattr(fa.FlashAttention, "forward", staticmethod(spy))
    q, k, v = _meta(1, 64, 2, 64), _meta(1, 64, 1, 64), _meta(1, 64, 1, 64)
    {"q": q, "k": k, "v": v}[which].requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel for device meta") as err:
        fa.flash_attention(q, k, v, causal=True, window=16)
    assert GRAD_ERROR not in str(err.value)
    assert entered == [(True, 16)]
    # without grad the same call never enters it
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(q, k, v)
    assert len(entered) == 1


@pytest.mark.parametrize("how", ["x requires grad", "w requires grad", "batched"])
def test_grouped_matmul_under_grad_or_vmap_reaches_its_autograd_function(monkeypatch,
                                                                         how):
    """A grad-requiring or a batched call of ``grouped_matmul`` goes through
    ``GroupedMatmul`` (its vmap rule folds two members into the expert axis
    first), past no guard, and fails at the device check on a meta tensor:
    no build, no launch."""
    def no_launch(*a, **k):
        raise AssertionError("a kernel was built or launched")

    entered = []
    forward = moe_gmm.GroupedMatmul.forward

    def spy(*args):
        entered.append([tuple(a.shape) for a in args])
        return forward(*args)

    monkeypatch.setattr(_build, "library", no_launch)
    monkeypatch.setattr(moe_gmm.GroupedMatmul, "forward", staticmethod(spy))
    m = 2 if how == "batched" else 1
    lead = (m,) if how == "batched" else ()
    x = _meta(*lead, 64, 64, grad=how == "x requires grad")
    w = _meta(*lead, 4, 64, 32, grad=how == "w requires grad")
    gs = _meta(*lead, 4, dtype=torch.int32)
    call = torch.func.vmap(moe_gmm.grouped_matmul) if lead else moe_gmm.grouped_matmul
    with pytest.raises(ValueError, match="no kernel for device meta") as err:
        call(x, w, gs)
    assert GRAD_ERROR not in str(err.value)
    assert entered == [[(m * 64, 64), (m * 4, 64, 32), (m * 4,)]]
    # without grad the same unbatched call never enters it
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        moe_gmm.grouped_matmul(_meta(64, 64), _meta(4, 64, 32),
                               _meta(4, dtype=torch.int32))
    assert len(entered) == 1


@pytest.mark.parametrize("which", ["x", "log_a", "b_mat", "c_mat", "initial_state"])
def test_ssd_scan_under_grad_reaches_its_autograd_function(meta_is_card, monkeypatch,
                                                           which):
    """An input of ``ssd_scan`` that requires grad under grad mode sends the
    call through ``SSDScan`` (whose forward launches the two forward
    kernels and saves what the backward kernels read), past no guard; on a
    meta tensor it stops at the first launch, before any build."""
    def no_launch(*a, **k):
        raise AssertionError("a kernel was built or launched")

    class Reached(Exception):
        pass

    def at_launch(*args):
        raise Reached

    entered = []
    forward = kssd.SSDScan.forward

    def spy(*args):
        entered.append(args[5])
        return forward(*args)

    monkeypatch.setattr(_build, "library", no_launch)
    monkeypatch.setattr(kssd, "_state_launch", at_launch)
    monkeypatch.setattr(kssd.SSDScan, "forward", staticmethod(spy))
    ins = {"x": _meta(1, 64, 2, 64), "log_a": _meta(1, 64, 2, dtype=torch.float32),
           "b_mat": _meta(1, 64, 1, 128), "c_mat": _meta(1, 64, 1, 128),
           "initial_state": _meta(1, 2, 64, 128, dtype=torch.float32)}
    ins[which].requires_grad_(True)
    with pytest.raises(Reached):
        kssd.ssd_scan(*(ins[k] for k in ("x", "log_a", "b_mat", "c_mat")),
                      chunk=64, initial_state=ins["initial_state"])
    assert entered == [64]
    # without grad the same call never enters it: chunk_state's own launch
    with torch.no_grad(), pytest.raises(Reached):
        kssd.ssd_scan(ins["x"], ins["log_a"], ins["b_mat"], ins["c_mat"], chunk=64)
    assert len(entered) == 1


def test_cpu_tensors_still_differentiate():
    """The plain versions on the CPU carry the gradient, as the reference's
    default path does."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 2, 16, generator=gen, requires_grad=True)
    k = torch.randn(1, 16, 1, 16, generator=gen, requires_grad=True)
    fa.flash_attention(q, k, k).sum().backward()
    x = torch.randn(8, 16, generator=gen, requires_grad=True)
    w = torch.randn(2, 16, 8, generator=gen, requires_grad=True)
    moe_gmm.grouped_matmul(x, w, torch.tensor([3, 5], dtype=torch.int32)).sum().backward()
    xs = torch.randn(1, 32, 2, 16, generator=gen, requires_grad=True)
    la = -torch.rand(1, 32, 2, generator=gen)
    bm = torch.randn(1, 32, 1, 16, generator=gen, requires_grad=True)
    y, final = kssd.ssd_scan(xs, la, bm, bm, chunk=16)
    (y.sum() + final.sum()).backward()
    for t in (q, k, x, w, xs, bm):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert t.grad.abs().sum() > 0


_C_TYPES = {"int": ctypes.c_int}


def _c_entry_points(source: str) -> dict[str, list]:
    """The ctypes argtypes of every function in the source's extern "C"
    block: pointers (and the stream) as c_void_p, ints as c_int."""
    text = (_build.CSRC / source).read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        types_ = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1])
            types_.append(ctypes.c_void_p if "*" in decl else _C_TYPES[decl])
        out[name] = types_
    return out


@pytest.mark.parametrize("module,source,names", [
    (fa, "flash_attention.cu", ["flash_attention_bwd", "flash_attention_fwd"]),
    (moe_gmm, "moe_gmm.cu", ["grouped_matmul", "grouped_matmul_dw",
                             "grouped_matmul_dx"]),
    (kssd, "ssd_scan.cu", ["ssd_chunk_scan", "ssd_chunk_scan_bwd",
                           "ssd_chunk_state", "ssd_chunk_state_bwd"])])
def test_bind_declares_the_c_entry_points_of_the_source(module, source, names):
    entries = _c_entry_points(source)
    assert sorted(entries) == names
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in entries})
    assert module.bind(lib) is lib
    for name, argtypes in entries.items():
        assert list(getattr(lib, name).argtypes) == argtypes, name
        assert getattr(lib, name).restype is ctypes.c_int
