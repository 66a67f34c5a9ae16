"""Build the CUDA kernels from the repo's sources at first use.

``nvcc`` compiles ``kernels/csrc/*.cu`` into a shared library with a plain
C interface, which ``ctypes`` loads (no ninja, no PyTorch headers, so the
build takes seconds).  The library lands in ``kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and the flags,
so an edit rebuilds.  A failed build raises; nothing gives way to the
plain versions on CUDA.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -O3 for sm_90a (keep the "a": wgmma/setmaxnreg exist only there); never
# --use_fast_math, which would reassociate the Kahan error terms away
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from kernels/csrc at first use")


def build_key() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{build_key()}.so"


def nvcc_command(out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def build() -> tuple[Path, str]:
    """Compile the library if its keyed file is missing.  Returns the path
    and the compiler's report (``-Xptxas=-v``: registers, shared memory and
    spills per kernel), also kept beside the library as ``.log``."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp, nvcc_path()), capture_output=True,
                          text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every exported
    function's argument and result types declared."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.repro_moments.argtypes = [i32, i32, i32, i32, p, p, p, i64, i64, i32,
                                  i32, p, p, p, p]
    lib.repro_moments.restype = i32
    lib.repro_report.argtypes = [i32, i32, p, p, p, p, i64, i64, i32, i32, p,
                                 p, p]
    lib.repro_report.restype = i32
    lib.repro_error_string.argtypes = [i32]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib
