"""The port stands alone: no jax, no reference package, the card by default.

* an AST scan of every module of ``src/repro_torch`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or of ``repro`` (as distinct
  from ``repro_torch``);
* a subprocess imports the port's serving entry point with ``jax`` made
  unimportable;
* entry points default to the card and raise on a machine without one
  instead of running on the CPU.
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both packages are importable side by side)
import pytest
import torch

import repro  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.launch.serving import ContinuousEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".", 1)[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_sources_exist():
    assert (PORT / "codegen" / "csrc" / "contract.cu").is_file()
    assert (PORT / "codegen" / "csrc" / "grouped.cu").is_file()
    assert (PORT / "codegen" / "csrc" / "baselines.cu").is_file()
    for module in ("codegen/fused_gen.py", "models/moe.py",
                   "codegen/epilogue.py", "core/autotune.py",
                   "kernels/_baselines.py", "kernels/matmul/matmul.py",
                   "kernels/matmul/ops.py", "kernels/matmul/ref.py",
                   "kernels/fused_dense_act/fused_dense_act.py",
                   "kernels/fused_dense_act/ops.py",
                   "kernels/fused_dense_act/ref.py",
                   "kernels/fused_rnz/fused_rnz.py",
                   "kernels/fused_rnz/ops.py", "kernels/fused_rnz/ref.py",
                   "configs/kimi_k2_1t_a32b.py",
                   "configs/llama4_maverick_400b_a17b.py"):
        assert PORT / module in SOURCES, module
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(SOURCES) > 20


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_imports_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.launch.serve, repro_torch.ops\n"
        "import repro_torch.codegen.build, repro_torch.codegen.fused_gen\n"
        "import repro_torch.models.moe\n"
        "from repro_torch.configs import get_config\n"
        "get_config('kimi-k2-1t-a32b'), get_config('llama4-maverick-400b-a17b')\n"
        "assert 'repro' not in sys.modules, 'reference package imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fused_ops_and_kernels_import_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch import ops\n"
        "from repro_torch.codegen import Epilogue\n"
        "from repro_torch.core.autotune import choose_matmul_blocks\n"
        "from repro_torch.kernels.matmul.ops import matmul\n"
        "from repro_torch.kernels.fused_dense_act.ops import "
        "fused_dense_act\n"
        "from repro_torch.kernels.fused_rnz.ops import weighted_matmul\n"
        "x, v = torch.ones(4, 4), torch.ones(4)\n"
        "ops.dense_act(x, x, v, v, v), ops.weighted_dense(x, x, v)\n"
        "matmul(x, x), fused_dense_act(x, x, v, v, v)\n"
        "weighted_matmul(x, x, v), choose_matmul_blocks(4, 4, 4)\n"
        "assert 'repro' not in sys.modules, 'reference package imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")


def test_engine_default_device_raises_without_card():
    _require_no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(get_config("qwen3-8b").smoke())


def test_serve_cli_default_device_raises_without_card():
    _require_no_card()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--requests", "1"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and also from a directory that holds nothing else of the repo."""
    _require_no_card()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout
