"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<digest>.so`` at the
repository root (git-ignored) on first use and loaded with ``ctypes``;
the digest covers the source and the flags, so an edited source is
rebuilt and never confused with an old library. Nothing here runs at
import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Loaded libraries by kernel name: one dlopen per process.
_LIBS: "dict[str, ctypes.CDLL]" = {}


def sources() -> "list[str]":
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels can only be built where the CUDA "
            "toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: "list[str] | None" = None,
              ptxas_verbose: bool = False) -> "dict[str, str]":
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns each compiled
    source's compiler output (``-Xptxas -v`` register and spill report
    when ``ptxas_verbose``); raises if any compile fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.is_file() and not ptxas_verbose:
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS,
               *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is not yet."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
