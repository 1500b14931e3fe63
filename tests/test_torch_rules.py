"""Rules of the PyTorch port: it stands alone and runs where it is asked.

``src/repro_torch`` and ``chip_smoke.py`` run on a machine with no JAX, so
they import neither ``jax`` nor anything of the JAX package ``repro`` (not
even its stdlib-only modules); the port's modules compute attention and the
expert GEMMs with its own kernels, never with a library's fused operator
(the yardsticks live in ``chip_smoke.py`` only); and the entry points run
on CUDA unless told otherwise, raising where there is none.
"""
import ast
import json
import os
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve, train

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_rule_catches_forbidden_imports(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                 "from repro_torch.models import build_model\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == \
        ["jax.numpy", "repro.core"]


MODULE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
# a library's attention or batched GEMM (with torch.compile and cuDNN):
# yardsticks only
LIBRARY_OPS = ("scaled_dot_product_attention", "bmm", "baddbmm")


def _library_calls(path: Path):
    """Attributes of the library calls (``F.scaled_dot_product_attention``,
    ``torch.bmm`` / ``x.bmm``, ``torch.compile``) and any mention of cuDNN."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        name = node.attr if isinstance(node, ast.Attribute) else \
            node.id if isinstance(node, ast.Name) else None
        if name is None:
            continue
        if name in LIBRARY_OPS or "cudnn" in name.lower() or (
                name == "compile" and isinstance(node.value, ast.Name)
                and node.value.id == "torch"):
            yield name


@pytest.mark.parametrize("path", MODULE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_calls_no_library_kernel(path):
    assert list(_library_calls(path)) == [], f"{path.name} calls a library"


def test_library_rule_catches_library_calls(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import torch\nimport torch.nn.functional as F\n"
                 "y = F.scaled_dot_product_attention(q, k, v)\n"
                 "z = torch.bmm(a, b) + a.bmm(b)\n"
                 "g = torch.compile(fn)\n"
                 "torch.backends.cudnn.allow_tf32 = True\n"
                 "r = re.compile('x')\n")
    assert sorted(_library_calls(f)) == sorted(
        ["scaled_dot_product_attention", "bmm", "bmm", "compile", "cudnn"])


def test_serve_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--new-tokens", "2"])


def test_serve_entry_point_runs_on_cpu_when_asked(capsys):
    assert serve.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3"]) == 0
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_entry_point_serves_moe_on_cpu_when_asked(capsys):
    assert serve.main(["--arch", "deepseek-v3-16b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3"]) == 0
    assert "deepseek-v3-16b-reduced device=cpu generated (2, 3) tokens" in \
        capsys.readouterr().out


def test_serve_entry_point_serves_rwkv_on_cpu_when_asked(capsys):
    assert serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "3"]) == 0
    assert "rwkv6-3b-reduced device=cpu generated (2, 3) tokens" in \
        capsys.readouterr().out


def test_train_entry_point_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the check needs a host without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "llama3.1-8b", "--reduced", "--steps", "2",
                    "--checkpoint-dir", str(tmp_path)])


def test_train_entry_point_runs_on_cpu_when_asked(tmp_path, capsys):
    """The settings of tests/test_integration.py's first trainer test: the
    loss falls by at least 0.2 in 30 steps."""
    out = tmp_path / "metrics.json"
    assert train.main(["--arch", "llama3.1-8b", "--reduced", "--steps", "30",
                       "--lr", "3e-3", "--device", "cpu", "--global-batch",
                       "8", "--seq-len", "64", "--checkpoint-every", "15",
                       "--checkpoint-dir", str(tmp_path / "ck"),
                       "--metrics-out", str(out)]) == 0
    assert "arch=llama3.1-8b-reduced device=cpu step 29" in \
        capsys.readouterr().out
    log = json.loads(out.read_text())
    assert log[-1]["loss"] < log[0]["loss"] - 0.2
    assert sorted(os.listdir(tmp_path / "ck")) == \
        ["LATEST", "step_00000015", "step_00000030"]


def test_train_entry_point_cuts_depth_and_runs_the_hook(tmp_path, capsys):
    assert train.main(["--arch", "qwen3-4b", "--reduced", "--layers", "2",
                       "--steps", "4", "--device", "cpu", "--global-batch",
                       "2", "--seq-len", "16", "--checkpoint-every", "0",
                       "--checkpoint-dir", str(tmp_path), "--use-case",
                       "gpu-red"]) == 0
    out = capsys.readouterr().out
    assert "lit-silicon[gpu-red]: converged caps" in out
