"""The PyTorch port, its entry points (chip_smoke.py, bench_torch.py,
train_torch.py, test_torch.py, train_scannet_torch.py,
train_debug_torch.py, depth_test_torch.py, depth_eval_scannet_torch.py,
depth_train_torch.py, depth_eval_torch.py, depth_shape_torch.py) and
every module of google_nerf_tpu_torch/ (the depth trainer's losses,
normals, optim, data and trainer, scannet_tools, the SPVCNN and voxelnet
refiners among them) stand alone: no module of theirs imports JAX,
its libraries, ml_dtypes, anything of the JAX package, or the JAX-free
root scripts opt.py, train.py, test.py, bench.py and the depth_*.py CLIs
(the port keeps its own copies); nor an image or vision library (cv2,
imageio, PIL, matplotlib, torchvision): the port decodes, colours and
writes its images itself and writes its networks out by hand.  The .sens
decoder is the port's own C++ (csrc/sens_decode.cpp, built into
build/kernels/): nothing of the port reaches the JAX package's native/
directory or its library."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "google_nerf_tpu",
          "ml_dtypes", "opt", "train", "test", "bench", "depth_test",
          "depth_eval_scannet", "depth_eval", "depth_train", "depth_shape")
IMAGE_LIBRARIES = ("cv2", "imageio", "PIL", "matplotlib", "torchvision")
ENTRY_POINTS = ("chip_smoke.py", "bench_torch.py", "train_torch.py",
                "test_torch.py", "train_scannet_torch.py",
                "train_debug_torch.py", "depth_test_torch.py",
                "depth_eval_scannet_torch.py", "depth_train_torch.py",
                "depth_eval_torch.py", "depth_shape_torch.py")
FILES = sorted((ROOT / "google_nerf_tpu_torch").rglob("*.py")) + [
    ROOT / f for f in ENTRY_POINTS]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED
           or m.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{path.name} imports {bad}"


def test_the_port_has_files_to_check():
    assert len(FILES) > 10 and all((ROOT / f).exists() for f in ENTRY_POINTS)


def test_the_sens_decoder_is_the_ports_own():
    from google_nerf_tpu_torch.ops.cuda import _build
    port = ROOT / "google_nerf_tpu_torch"
    assert _build._source("sens_decode") == port / "csrc" / "sens_decode.cpp"
    assert _build.library_path("sens_decode").parent == \
        ROOT / "build" / "kernels"
    for path in FILES + sorted((port / "csrc").iterdir()):
        text = path.read_text()
        assert "libsens_decode" not in text and '"native"' not in text \
            and "native/" not in text, f"{path.name} reaches native/"
