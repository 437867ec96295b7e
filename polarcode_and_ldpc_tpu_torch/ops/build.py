"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into a shared library, at first use, and loaded
with ``ctypes``; all sources are compiled in parallel (one ``nvcc`` process
each, started together).  Nothing is built when the package is imported.  A
build failure raises: no caller falls back to a plain implementation.

The libraries go to ``<checkout>/build/polarcode_and_ldpc_tpu_torch/``
(override with the ``POLAR_LDPC_TORCH_BUILD_DIR`` environment variable).
They are rebuilt when a source is newer than its library.

A variant is one source built with extra flags into a library of its own
name (``VARIANTS``): ``scl_decode_profile`` is ``scl_decode.cu`` (the chunk
step, K3), ``scl_body_profile`` is ``scl_body.cu`` (the chunk body, K5),
``scl_last_profile`` is ``scl_last.cu`` (the last chunk, K4) and
``scl_mega_profile`` is ``scl_mega.cu`` (the one-launch decode, K6), each with
the stage profile of the list kernels (``-DSCL_PROFILE``, see
``csrc/scl_device.cuh``); ``sc_decode_profile`` is ``sc_decode.cu`` (K1)
with its stage profile (``-DSC_PROFILE``).  Variants are built only when asked for, by
``build_all(variants=...)`` or ``load(<variant>)``; the normal libraries are
the same with or without them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
# the list kernels are four sources over one header (scl_kernels.cuh), so that
# their builds run side by side, and their XL-list instances (64 < L <= 256)
# three sources more, built beside them
SOURCES = ("sc_decode", "bp_decode", "scl_decode", "scl_body", "scl_last", "scl_mega",
           "scl_decode_xl", "scl_body_xl", "scl_last_xl", "fastnode", "sublane_roll")
_SCL_HEADERS = ("scl_kernels.cuh", "scl_device.cuh", "fastnode_device.cuh")
# headers a source includes: it is rebuilt when one of them is newer, too
HEADERS = {"scl_decode": _SCL_HEADERS, "scl_body": _SCL_HEADERS, "scl_last": _SCL_HEADERS,
           "scl_mega": _SCL_HEADERS, "scl_decode_xl": _SCL_HEADERS, "scl_body_xl": _SCL_HEADERS,
           "scl_last_xl": _SCL_HEADERS, "fastnode": ("fastnode_device.cuh",)}
# variant library -> (source, extra nvcc flags)
VARIANTS = {"scl_decode_profile": ("scl_decode", ("-DSCL_PROFILE",)),
            "scl_body_profile": ("scl_body", ("-DSCL_PROFILE",)),
            "scl_last_profile": ("scl_last", ("-DSCL_PROFILE",)),
            "scl_mega_profile": ("scl_mega", ("-DSCL_PROFILE",)),
            "sc_decode_profile": ("sc_decode", ("-DSC_PROFILE",))}

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


def build_all(verbose: bool = False, variants: tuple = ()) -> float:
    """Compile every stale source and the named ``variants``, all in
    parallel; returns build seconds."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    stale = []
    for name in (*SOURCES, *variants):
        source, flags = VARIANTS.get(name, (name, ()))
        src, lib = _CSRC / f"{source}.cu", out_dir / f"lib{name}.so"
        newest = max(f.stat().st_mtime for f in
                     (src, *(_CSRC / h for h in HEADERS.get(source, ()))))
        if not lib.exists() or lib.stat().st_mtime < newest:
            stale.append((name, src, lib, flags))
    if not stale:
        return 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, src, lib, flags in stale:
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *flags, *(["-Xptxas", "-v"] if verbose else []),
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
    """The loaded library of ``csrc/<name>.cu`` (or of the variant
    ``name``), built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all(variants=(name,) if name in VARIANTS else ())
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


def launch_on(index: int, fn, *args) -> int:
    """``fn(*args, stream)``: a C launcher called on PyTorch's current stream
    of CUDA device ``index``, with that device current (no device switch
    when it already is)."""
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
