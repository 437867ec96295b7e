"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into a shared library, at first use, and loaded
with ``ctypes``; all sources are compiled in parallel (one ``nvcc`` process
each, started together).  Nothing is built when the package is imported.  A
build failure raises: no caller falls back to a plain implementation.

The libraries go to ``<checkout>/build/polarcode_and_ldpc_tpu_torch/``
(override with the ``POLAR_LDPC_TORCH_BUILD_DIR`` environment variable).
They are rebuilt when a source is newer than its library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("sc_decode", "bp_decode", "scl_decode", "fastnode")
# headers a source includes: it is rebuilt when one of them is newer, too
HEADERS = {"scl_decode": ("scl_device.cuh", "fastnode_device.cuh"),
           "fastnode": ("fastnode_device.cuh",)}

# -fmad=false: no multiply-add contraction, so every float operation rounds
# exactly as the same operation does in the plain PyTorch version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("POLAR_LDPC_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "polarcode_and_ldpc_tpu_torch"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_all(verbose: bool = False) -> float:
    """Compile every stale source, all in parallel; returns build seconds."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    stale = []
    for name in SOURCES:
        src, lib = _CSRC / f"{name}.cu", out_dir / f"lib{name}.so"
        newest = max(f.stat().st_mtime for f in
                     (src, *(_CSRC / h for h in HEADERS.get(name, ()))))
        if not lib.exists() or lib.stat().st_mtime < newest:
            stale.append((name, src, lib))
    if not stale:
        return 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, src, lib in stale:
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(log)
        tmp.replace(lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if code != 0:
        lib.pl_error_string.restype = ctypes.c_char_p
        lib.pl_error_string.argtypes = [ctypes.c_int]
        msg = lib.pl_error_string(code).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} (code {code})")
