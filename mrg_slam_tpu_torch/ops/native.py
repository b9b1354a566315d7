"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. All sources compile at once,
one nvcc process each, at the first kernel call of the process; the
libraries go to `mrg_slam_tpu_torch/_build/` under a name that hashes the
sources and flags, so an edit rebuilds and an unchanged tree reuses them.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the entry points: pointers (and the stream) as c_void_p,
# or ctypes would pass them as 32-bit ints
_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
SIGNATURES = {
    "mrg_nn": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    "mrg_radius_count": (_P, _P, _I, _I, _I, _D, _F, _I, _P, _P, _P),
    "mrg_radius_count_scratch": (_I, _I, _I, _I, _P),
    "mrg_radius_moments": (_P, _P, _I, _I, _I, _F, _P, _P, _P, _P),
    "mrg_empty": (_P,),
    "mrg_lm_linearize": (_P,) * 9 + (_I,) * 3 + (_P,) * 3,
    "mrg_lm_assemble": (_P,) * 7 + (_I,) * 7 + (_P,) * 9,
    "mrg_lm_trial": (_P,) * 14 + (_I,) * 5 + (_F,) + (_P,) * 11,
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "mrg_slam_tpu_torch are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; name -> CDLL."""
    global build_seconds
    if _libs:
        return _libs
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = _digest()
    sources = sorted(CSRC.glob("*.cu"))
    outs = {s.stem: BUILD_DIR / f"lib{s.stem}-{tag}.so" for s in sources}
    procs = []
    try:
        nvcc = None
        for s in sources:
            if outs[s.stem].exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = outs[s.stem].with_suffix(f".{os.getpid()}.tmp")
            procs.append((s, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for s, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
            (BUILD_DIR / f"{s.stem}-{tag}.log").write_text(log)
            os.replace(tmp, outs[s.stem])
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, path in outs.items():
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in SIGNATURES.items():
            if hasattr(lib, symbol):
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _libs[name] = lib
    build_seconds = time.perf_counter() - t0
    return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check_cuda_f32(*tensors: torch.Tensor) -> None:
    """Kernel inputs: contiguous float32 on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel input on {t.device}, expected one "
                             "CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel input is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")


def mask_ptr(device: torch.device, batch: int, lanes: int,
             mask: Optional[torch.Tensor]) -> Optional[int]:
    """Device pointer of a (batch, lanes) bool mask; None (a null pointer:
    every lane) for None."""
    if mask is None:
        return None
    if mask.device != device or mask.dtype != torch.bool \
            or mask.shape != (batch, lanes) or not mask.is_contiguous():
        raise ValueError(f"expected a contiguous bool mask {(batch, lanes)} "
                         f"on {device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    return mask.data_ptr()


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
