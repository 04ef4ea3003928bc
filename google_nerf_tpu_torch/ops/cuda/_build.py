"""Build the port's native sources into shared libraries and load them.

Each csrc/<name>.cu compiles with nvcc for sm_90a into its own library,
build/kernels/lib<name>_<key>.so, where <key> hashes the source and the
flags; the compiler's log (ptxas register and spill report) sits beside
it as lib<name>_<key>.log.  The host C sources (csrc/<name>.c, the image
codec) compile the same way with the host C compiler (`cc`, or $CC), and
the host C++ sources (csrc/<name>.cpp, the .sens zlib decoder) with the
host C++ compiler (`g++`, or $CXX), linked to zlib and pthreads.  A
library of the same key is reused; each build writes a temporary file
and renames it, so processes that race to build one library are safe.
The sources have a plain C interface, loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
CC_FLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
FLAGS = {".cu": NVCC_FLAGS, ".c": CC_FLAGS, ".cpp": CXX_FLAGS}
_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()    # threads of one process build once


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no host C compiler (cc): the port's image "
                           "codec builds from csrc/image_codec.c with it")
    return cc


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++): the port's .sens "
                           "decoder builds from csrc/sens_decode.cpp with it")
    return cxx


def _source(name: str) -> Path:
    for suffix in FLAGS:
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no source csrc/{name}.cu, .c or .cpp")


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    if src.suffix == ".c":
        return [_cc(), *CC_FLAGS, "-o", str(out), str(src), "-lm"]
    return [_cxx(), *CXX_FLAGS, "-o", str(out), str(src), "-lz", "-lpthread"]


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's (or .c's, or .cpp's) library of the current
    source and flags lives (built or not)."""
    src = _source(name)
    flags = FLAGS[src.suffix]
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(*names: str) -> list[Path]:
    """Compile csrc/<name>.cu (nvcc), csrc/<name>.c (cc) or
    csrc/<name>.cpp (g++) for each name not built yet, all compilers
    started together; returns the libraries' paths in the order given.
    Raises with the compiler's errors if any build fails."""
    libs = [library_path(n) for n in names]
    runs = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        src = _source(name)
        proc = subprocess.Popen(_command(src, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        runs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in runs:
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed on {src}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, declare) -> ctypes.CDLL:
    """csrc/<name>'s library, built if needed and loaded once per
    process; declare(lib) sets its functions' argtypes and restypes."""
    with _load_lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build(name)[0]))
            declare(lib)
            _loaded[name] = lib
    return _loaded[name]
