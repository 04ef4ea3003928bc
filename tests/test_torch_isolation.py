"""The PyTorch port and chip_smoke.py stand alone: no module of theirs
imports JAX, its libraries, ml_dtypes or anything of the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "google_nerf_tpu",
          "ml_dtypes")
FILES = sorted((ROOT / "google_nerf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_the_port_has_files_to_check():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
