"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build happens at first use, into ``build/kernels/`` beside the package (a
directory git ignores), and the library name carries a hash of every file
under ``csrc/`` and of the compiler flags, so an edited source or header
rebuilds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# headers are included by relative path from csrc/, so no -I is needed
BUILD_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]
LINK_FLAGS = ["-ldl"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": nvcc's -Xptxas -v report}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_digest(name: str, csrc_dir: Path = CSRC_DIR) -> str:
    """Hash of what the build of ``csrc/<name>.cu`` reads: the name, every
    file under ``csrc_dir`` (path and bytes, in sorted order) and the flags."""
    h = hashlib.sha256(name.encode())
    for f in sorted(p for p in csrc_dir.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(csrc_dir)).encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(BUILD_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named by its digest."""
    return BUILD_DIR / f"lib{name}_{build_digest(name, csrc_dir)}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per build digest) and load it."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = library_path(name)
    info = {"seconds": 0.0, "ptxas": "", "path": str(lib_path)}
    if not lib_path.exists():
        nvcc = find_nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *BUILD_FLAGS, "-o", tmp, str(src), *LINK_FLAGS]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        info["ptxas"] = proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    BUILD_INFO[name] = info
    return lib
