"""The port and chip_smoke.py stand alone: no JAX, no acezero_tpu, no PIL,
no other image library, no ninja and no torch.utils.cpp_extension, both by
an AST scan of every import and by importing them with those modules
blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "acezero_tpu", "PIL", "cv2", "imageio", "torchvision", "ninja",
             "torch.utils.cpp_extension")
FILES = sorted((ROOT / "acezero_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted({n for n in _imports(path) if _forbidden(n)})
    assert not bad, f"{path} imports {bad}"


def test_files_found():
    assert len(FILES) > 20
    assert (ROOT / "acezero_tpu_torch" / "ops" / "csrc" / "fused_head_fwd.cu").exists()
    assert {ROOT / "acezero_tpu_torch" / "parallel" / n for n in ("__init__.py", "mesh.py")} <= set(FILES)


_BLOCKER = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("blocked: " + name)
        return None
for f in FORBIDDEN:
    sys.modules.pop(f, None)
sys.meta_path.insert(0, Block())
import importlib, pkgutil
import acezero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(acezero_tpu_torch.__path__, "acezero_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
print("imported", len(names) + 1)
"""


def test_import_with_forbidden_modules_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKER.format(forbidden=FORBIDDEN)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
