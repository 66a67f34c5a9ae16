"""Build the CUDA kernels from the repo's sources at first use.

``nvcc`` compiles each ``kernels/csrc/*.cu`` into an object, all sources at
once in parallel, and links them into a shared library with a plain C
interface, which ``ctypes`` loads (no ninja, no PyTorch headers, so the
build takes seconds).  The library lands in ``kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources, the shared
headers and the flags, so an edit rebuilds.  A failed build raises;
nothing gives way to the plain versions on CUDA.
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
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -O3 for sm_90a (keep the "a": wgmma/setmaxnreg exist only there); never
# --use_fast_math, which would reassociate the Kahan error terms away
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas=-v", "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{build_key()}.so"


def compile_command(src: Path, obj: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path,
                 nvcc: str = "nvcc") -> list[str]:
    return [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
            "-o", str(out), *map(str, objs)]


# called with the library's path after each build that ran nvcc
# (``repro_torch.analysis.CompileCounter`` appends here)
BUILD_OBSERVERS: list = []


def build() -> tuple[Path, str]:
    """Compile the library if its keyed file is missing: one ``nvcc -c``
    per source, all started together, then one link.  Returns the path and
    the compiler's report (``-Xptxas=-v``: registers, shared memory and
    spills per kernel), also kept beside the library as ``.log``."""
    lib = library_path()
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen(compile_command(src, obj, nvcc),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    outs = [p.communicate()[0] for p in procs]
    report = "".join(outs)
    failed = [(src.name, p.returncode, out)
              for src, p, out in zip(sources(), procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{out}" for name, rc, out in failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(link_command(objs, tmp, nvcc), capture_output=True,
                          text=True)
    report += proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{report}")
    log.write_text(report)
    os.replace(tmp, lib)
    for observe in list(BUILD_OBSERVERS):
        observe(lib)
    return lib, report


def load(path) -> ctypes.CDLL:
    """Load a kernel library and declare its exported functions' argument
    and result types (a library built from an earlier checkout may lack
    the newer ones)."""
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        # the domain map's shift and scale come last: a library built
        # before them ignores the two
        "repro_moments": ([i32, i32, i32, i32, p, p, p, i64, i64, i32, i32,
                           p, p, p, p, p, p], i32),
        "repro_moments_ring": ([i32, i32, i32, p, p, p, i64, i64, i32, i32,
                                i32, i32, p, p, p, p, p, p], i32),
        "repro_ring_smem_bytes": ([i32, i32, i32, i32, i32, i32], i64),
        "repro_report": ([i32, i32, p, p, p, p, i64, i64, i32, i32, p, p, p],
                         i32),
        "repro_solve_small": ([i32, i32, i32, p, i64, i64, i64, p, i64, i64,
                               i64, ctypes.c_double, p, p, p, p], i32),
        "repro_error_string": ([i32], ctypes.c_char_p),
    }
    for name, (args, res) in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib


_LIBRARY_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load(build()[0])


def library() -> ctypes.CDLL:
    """The loaded kernel library of this checkout, built on first use.
    Threads that ask at once wait for one build (``lru_cache`` alone
    would let each of them run nvcc on the same files)."""
    with _LIBRARY_LOCK:
        return _library()
