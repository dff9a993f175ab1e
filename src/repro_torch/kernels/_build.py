"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object —
one ``nvcc`` per source, all started together — and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
(PyTorch's ``cpp_extension.load`` would compile PyTorch's headers into every
build, which takes minutes; a plain C interface takes seconds.)

The build happens at first use, into ``kernels/build/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a checkout of
the repository alone builds it.  Nothing is built at import time.

Each C entry point returns a ``cudaError_t``; :func:`check` raises when it is
not 0.  Pointers and the stream go through ``ctypes.c_void_p`` (a bare int
would be cut to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C entry points and their argument types (pointers, ints, floats, 64-bit
#: ints, stream)
SIGNATURES = {
    "repro_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P, _I, _I, _P],
    "repro_grouped_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _F, _I, _I, _I, _P],
    "repro_flash_attention_bwd": [*[_P] * 11, *[_I] * 9, _F, _F, _I, _P],
    "repro_flash_attention_bwd_geometry": [*[_I] * 8, _P],
    "repro_rwkv6_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "repro_rglru_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_rwkv6_scan_bwd": [*[_P] * 16, *[_I] * 6, _P],
    "repro_rwkv6_scan_bwd_geometry": [*[_I] * 5, _P],
    "repro_rglru_scan_bwd": [*[_P] * 9, *[_I] * 8, _P],
    "repro_rglru_scan_bwd_geometry": [*[_I] * 5, _P],
    "repro_matmul_grad": [_P, _I, _L, _P, _I, _L, _P, _P, *[_I] * 12, _P],
    "repro_grouped_matmul_grad": [_P, _I, _L, _L, _P, _I, _L, _L, _P, *[_I] * 13, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: compiler output of the build this process made (ptxas register/spill lines)
build_log = ""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log
    out = BUILD_DIR / f"librepro_torch_{_key()}.so"
    if out.exists():
        return out
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs, procs = [], []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [compiler, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        lib_tmp = tmp / out.name
        link = subprocess.run([compiler, "-shared", *ARCH_FLAGS, *map(str, objs), "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(lib_tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use.

    Raises RuntimeError when no CUDA device is present or nvcc is missing:
    asking for a kernel never falls back to a plain version."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
