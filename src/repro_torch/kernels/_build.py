"""Build and load the hand-written CUDA kernels, and the helpers their
wrappers share (input checks, the launch, true division).

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``<repo>/build/repro_torch/``, keyed by a
hash of the sources and flags, so an unchanged checkout builds once.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of every exported function: (restype, argtypes).  Launchers
#: return the cudaError_t of their launch (0 = success).
SIGNATURES = {
    # xs, pre_xs, pan, pre_pan, out, H, W, B, radius, stream (raw inputs,
    # each with its prestage.PreOps)
    "pansharpen_f32": (_I, (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # raw, pre, out, H, W, radius, dr, dc, levels, vmin, span, stream
    "glcm_features_f32": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P)),
    # raw, pre, out, H, W, B, hs, hr2, n_iter, stream
    "meanshift_f32": (_I, (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P)),
    # q, k, v, out, BHq, BHkv, Sq, Skv, D, causal, scale, stream
    "flash_attention_f32": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)),
    "flash_attention_bf16": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)),
    # x, dt, cum, B, C, y, states, cells, group, L, P, N, stream
    "ssd_intra_chunk_f32": (_I, (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "repro_cuda_error_string": (ctypes.c_char_p, (_I,)),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the repro_torch CUDA "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built: one
    ``nvcc -c`` per source, all running at once, then one link.  The
    compilers' report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, cmd, proc in jobs:  # wait for every compiler, failed or not
        log.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{log[-1][-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *(str(obj) for obj, _, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed (rc={proc.returncode}): {' '.join(cmd)}\n"
                              f"{proc.stderr[-4000:]}")
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp.replace(out)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _lib = lib
        return _lib


def true_div(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as a correctly rounded float division, as the kernels
    compute it.  For a Python-number divisor PyTorch's CUDA path multiplies
    by the reciprocal instead, one ulp away; a 0-dim tensor on ``t``'s
    device keeps the true division on every device.  The divisor is made by
    a fill on that device (no host-to-device copy, which a CUDA-graph
    capture refuses), holding the same float32 value."""
    return t / torch.full((), divisor, dtype=t.dtype, device=t.device)


def require(kernel: str, name: str, t, ndim: int, dtype: torch.dtype = torch.float32) -> None:
    """Reject what a launcher does not take: it reads contiguous CUDA memory
    of one dtype (float32 unless ``dtype`` says otherwise) and a fixed rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call launcher ``symbol`` on ``device``'s current stream and raise on
    a nonzero ``cudaError_t`` (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}: {msg})")
