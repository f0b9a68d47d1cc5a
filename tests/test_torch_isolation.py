"""The port, chip_smoke.py and the numpy TIFF writer it imports
(scripts/tiff_encode.py) stand alone: no JAX, no acezero_tpu, no PIL,
no other image library, no ninja and no torch.utils.cpp_extension, both by
an AST scan of every import and by importing them with those modules
blocked; and no file of the port names the JAX package's canvas pass
(native/canvas.cpp, its library libacezero_canvas) or builds a path into
native/: the port keeps its own copy (data/csrc/canvas.cpp)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "acezero_tpu", "PIL", "cv2", "imageio", "torchvision", "ninja",
             "torch.utils.cpp_extension")
# chip_smoke.py and the numpy TIFF writer it imports from scripts/
SMOKE = [ROOT / "chip_smoke.py", ROOT / "scripts" / "tiff_encode.py"]
FILES = sorted((ROOT / "acezero_tpu_torch").rglob("*.py")) + SMOKE
# every source file of the port, whatever its language, and SMOKE
SOURCES = sorted(p for p in (ROOT / "acezero_tpu_torch").rglob("*")
                 if p.is_file() and p.suffix in (".py", ".cpp", ".cu", ".cuh", ".h")) + SMOKE
JAX_NATIVE_NAMES = ("native/canvas.cpp", "libacezero_canvas")


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


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_use_of_the_jax_packages_native_pass(path):
    text = path.read_text()
    assert not [n for n in JAX_NATIVE_NAMES if n in text], f"{path} names the JAX package's canvas pass"
    if path.suffix == ".py":  # nor a path built from a "native" directory name
        consts = {node.value for node in ast.walk(ast.parse(text)) if isinstance(node, ast.Constant)
                  and isinstance(node.value, str)}
        assert not [c for c in consts if c == "native" or c.startswith("native/")], f"{path} names native/"


def test_files_found():
    assert len(FILES) > 20
    assert (ROOT / "acezero_tpu_torch" / "ops" / "csrc" / "fused_head_fwd.cu").exists()
    assert {ROOT / "acezero_tpu_torch" / "parallel" / n for n in ("__init__.py", "mesh.py")} <= set(FILES)
    assert ROOT / "acezero_tpu_torch" / "data" / "csrc" / "canvas.cpp" in SOURCES
    assert all(p.exists() for p in SMOKE)


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
sys.path.insert(0, {scripts!r})
import tempfile, numpy, tiff_encode
with tempfile.TemporaryDirectory() as tmp:  # the writer of phase formats, as it runs there
    chip_smoke.write_format_frame(numpy, chip_smoke.Path(tmp) / "f.tif", numpy.zeros((4, 5, 3), numpy.uint8), "planar")
print("imported", len(names) + 2)
"""


def test_import_with_forbidden_modules_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKER.format(forbidden=FORBIDDEN, scripts=str(ROOT / "scripts"))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "imported" in out.stdout
