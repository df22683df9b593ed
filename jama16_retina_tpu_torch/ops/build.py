"""Build and load the port's CUDA kernels and its host-side C code.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<digest>.so`` at the
repository root (git-ignored) on first use and loaded with ``ctypes``;
the digest covers the source and the flags, so an edited source is
rebuilt and never confused with an old library. Each ``csrc/<name>.c``
(host code: the image codec) is built the same way by the host C
compiler (``$CC``, else ``cc``, else ``gcc``) with ``HOST_CFLAGS``: no
``-ffast-math`` and no ``-march=native``, and ``-ffp-contract=off`` so its
few float32 loops round every product and sum as numpy does; every
machine computes the same bytes. Its digest also covers the compiler's
path and ``--version``, so a library that another compiler built (on
another machine, say) is never loaded. There is no fallback: a
missing compiler raises. Libraries load with ``ctypes.CDLL``, so a call
into one releases Python's interpreter lock. Nothing here runs at import
time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
HOST_CFLAGS = ("-O2", "-std=c11", "-ffp-contract=off", "-shared", "-fPIC")

# Loaded libraries by kernel name: one dlopen per process.
_LIBS: "dict[str, ctypes.CDLL]" = {}
# The host stage's threads may ask for the codec at once: one builds it.
_LOAD_LOCK = threading.Lock()


def sources() -> "list[str]":
    """Names of every source in ``csrc/``: CUDA kernels and host C."""
    return sorted(p.stem for p in (*CSRC.glob("*.cu"), *CSRC.glob("*.c")))


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or, for host code, ``csrc/<name>.c``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.is_file() else CSRC / f"{name}.c"


def _is_host(name: str) -> bool:
    return source_path(name).suffix == ".c"


def _find_host_cc() -> "str | None":
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        if cand:
            found = shutil.which(cand)
            if found is not None:
                return found
    return None


def host_cc() -> str:
    """The host C compiler: ``$CC``, else ``cc``, else ``gcc``."""
    found = _find_host_cc()
    if found is not None:
        return found
    raise RuntimeError(
        "no host C compiler found ($CC, cc or gcc on PATH): the port's "
        "image codec (ops/csrc/image_codec.c) is built from source at "
        "first use and has no fallback")


@functools.lru_cache(maxsize=None)
def _compiler_id(path: str) -> bytes:
    """The compiler's path and ``--version`` report, for the digest."""
    out = subprocess.run([path, "--version"], capture_output=True,
                         check=True).stdout
    return path.encode() + b"\0" + out


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
    src = source_path(name)
    flags = HOST_CFLAGS if _is_host(name) else NVCC_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    cc = _find_host_cc() if _is_host(name) else None
    if cc is not None:
        # With no compiler the name matches no library: building raises.
        digest.update(_compiler_id(cc))
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: "list[str] | None" = None,
              ptxas_verbose: bool = False) -> "dict[str, str]":
    """Compile the named sources (all by default) that are not built yet,
    one compiler per source, all started together: ``nvcc`` for a
    ``.cu``, the host C compiler for a ``.c``. Returns each compiled
    source's compiler output (``-Xptxas -v`` register and spill report
    of a kernel when ``ptxas_verbose``); raises if any compile fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names
            if not library_path(n).is_file()
            or (ptxas_verbose and not _is_host(n))]
    kernels = [n for n in todo if not _is_host(n)]
    compiler = nvcc() if kernels else None
    cc = host_cc() if len(kernels) < len(todo) else None
    procs = {}
    for name in todo:
        target = library_path(name)
        # Unique per process and thread: concurrent builds (xdist
        # workers, reader processes) each write their own file and
        # os.replace it into place.
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        if _is_host(name):
            cmd = [cc, *HOST_CFLAGS, "-o", str(tmp), str(source_path(name))]
        else:
            cmd = [compiler, *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if ptxas_verbose else ()),
                   "-o", str(tmp), str(source_path(name))]
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
        raise RuntimeError("compile failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if it is not yet."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = library_path(name)
                if not path.is_file():
                    build_all([name])
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
