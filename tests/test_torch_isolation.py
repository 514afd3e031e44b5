"""The port stands alone: no jax, no ``repro`` and no PyYAML import, no CPU
fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under 6 xdist workers

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "yaml"), f"{path}: imports {name}"


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def test_imports_without_triton_or_cuda():
    """Every module of the port imports with no triton, no PyYAML and no
    card, and importing it loads neither jax nor the reference package."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT_FILES if p.suffix == ".py" and "src" in p.parts]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        "sys.modules['triton'] = None\n"          # importing triton fails
        "sys.modules['yaml'] = None\n"            # and so does PyYAML's
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')\n"
        "       or m.split('.')[0] == 'yaml' and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_resolve_device_raises_without_cuda():
    code = ("from repro_torch.device import resolve_device\n"
            "import torch\n"
            "assert resolve_device('cpu') == torch.device('cpu')\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "try:\n"
            "    resolve_device()\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n")
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("raised no CUDA device")


def test_model_entry_points_need_cuda_unless_cpu_is_asked():
    code = ("from repro_torch.configs import get_smoke\n"
            "from repro_torch.models import Model\n"
            "Model(get_smoke('gemma3-1b'), device='cpu')\n"
            "try:\n"
            "    Model(get_smoke('gemma3-1b'))\n"
            "except RuntimeError:\n"
            "    print('raised')\n")
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """The wrapper sends a non-CPU tensor to the kernel checks, never to the
    plain version (a meta tensor stands in for a card's here)."""
    from repro_torch.kernels import flash_attention as fa

    def boom(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", boom)
    q = torch.empty(1, 8, 2, 32, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])


def test_cuda_tensor_never_reaches_the_plain_grouped_matmul(monkeypatch):
    """The same for the grouped GEMM's wrapper."""
    from repro_torch.kernels import moe_gmm

    def boom(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(moe_gmm, "grouped_matmul_plain", boom)
    x = torch.empty(16, 32, device="meta", dtype=torch.bfloat16)
    w = torch.empty(4, 32, 16, device="meta", dtype=torch.bfloat16)
    sizes = torch.empty(4, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device"):
        moe_gmm.grouped_matmul(x, w, sizes)
