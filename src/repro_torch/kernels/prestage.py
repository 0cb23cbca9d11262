"""The fused pointwise pre-stage of B1–B3: op lists, their plain version and
their encoding for the kernels' prologue.

A pointwise filter (``Convert``, ``BandMath`` built from ops, ``ndvi``)
states its transform as a tuple of ops.  The plan layer concatenates the
ops of a single-consumer chain and hands them to the consuming kernel,
whose prologue (``csrc/prestage.cuh``) applies them to each raw sample as
it is loaded, so the chain's intermediates never reach device memory.  The
vocabulary covers every pointwise filter the repo builds:

====================  ==================================================
``("cast_f32",)``     to float32
``("sub", c)``        ``x - c``
``("div", c)``        ``x / c``, a true division (``__fdiv_rn``)
``("mul", c)``        ``x * c``
``("add", c)``        ``x + c``
``("clip", lo, hi)``  ``clamp(x, lo, hi)`` (NaN stays NaN)
``("cast", dtype)``   to a torch dtype, truncating toward zero as ``.to()``
``("band", i)``       band ``i``, keeping the band axis
``("ndiff", r, n, e)`` ``(x_n - x_r) / max(x_n + x_r, e)``, one band
====================  ==================================================

Constants are float32 values (Python floats that float32 holds exactly),
rounded as the unfused PyTorch path rounds its Python scalars: float32 of
the double, with differences such as ``i1 - i0`` taken in double first.
:func:`apply_plain` is the plain version, one torch op per op; every
filter that returns an op list computes its ``generate`` with it, so fused
and unfused plans agree bit for bit.  Counterpart of the reference's
``pointwise_fn`` callables, which a CUDA kernel cannot run.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import true_div

#: the most ops a fused chain may hold: the plan walk stops folding a chain
#: where the next node's ops would pass it (two ``Convert``s are 14)
MAX_OPS = 16
#: the most bands the prologue keeps per sample (in registers)
MAX_BANDS = 8

#: op codes of ``csrc/prestage.cuh``
_CODES = {"cast_f32": 0, "sub": 1, "div": 2, "mul": 3, "add": 4, "clip": 5,
          "trunc": 6, "band": 7, "ndiff": 8}
_KINDS = ("cast_f32", "sub", "div", "mul", "add", "clip", "cast", "band", "ndiff")
#: raw dtypes the prologue loads (any other is cast to float32 first, which
#: is what every op list's leading ``cast_f32`` does)
_DTYPES = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}

Ops = Tuple[tuple, ...]


def f32(c) -> float:
    """A Python constant as the float32 value the unfused path computes with."""
    return float(np.float32(c))


def apply_plain(ops: Sequence[tuple], t: torch.Tensor) -> torch.Tensor:
    """The op list in plain PyTorch, one op at a time (HWC tensors)."""
    for op in ops:
        kind = op[0]
        if kind == "cast_f32":
            t = t.to(torch.float32)
        elif kind == "sub":
            t = t - op[1]
        elif kind == "div":
            t = true_div(t, op[1])
        elif kind == "mul":
            t = t * op[1]
        elif kind == "add":
            t = t + op[1]
        elif kind == "clip":
            t = torch.clamp(t, op[1], op[2])
        elif kind == "cast":
            t = t.to(op[1])
        elif kind == "band":
            t = t[..., op[1] : op[1] + 1]
        elif kind == "ndiff":
            r, n = t[..., op[1]], t[..., op[2]]
            t = ((n - r) / torch.clamp(n + r, min=op[3]))[..., None]
        else:
            raise ValueError(f"unknown pre-stage op {op!r}")
    return t


def out_bands(ops: Sequence[tuple], bands: int) -> int:
    """Bands of ``apply_plain(ops, x)`` for an input of ``bands`` bands."""
    for op in ops:
        if op[0] in ("band", "ndiff"):
            bands = 1
    return bands


def kernel_safe(ops: Sequence[tuple]) -> bool:
    """Whether the kernels' prologue computes ``ops`` exactly as
    :func:`apply_plain` does.  It computes in float32 throughout, so the
    list must open with ``cast_f32`` (a float64 input would otherwise stay
    float64 in PyTorch), cast only to float32 or to an integer dtype, and
    clip into an integer dtype's range just before casting to it (PyTorch's
    out-of-range float-to-integer casts wrap).  Chains that are not safe
    stay unfused."""
    if not ops or ops[0] != ("cast_f32",) or len(ops) > MAX_OPS:
        return False
    for k, op in enumerate(ops):
        if op[0] not in _KINDS:
            return False
        if op[0] == "cast":
            dt = op[1]
            if dt == torch.float32:
                continue
            if dt.is_floating_point or dt.is_complex or dt == torch.bool:
                return False
            info = torch.iinfo(dt)
            prev = ops[k - 1]
            if prev[0] != "clip" or prev[1] < info.min or prev[2] > info.max:
                return False
    return True


class PreOps(ctypes.Structure):
    """``prestage::Ops`` of ``csrc/prestage.cuh``: the encoded op list with
    the raw input's dtype, bands per pixel and the bands to load."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("dtype", ctypes.c_int),
        ("stride", ctypes.c_int),
        ("nload", ctypes.c_int),
        ("code", ctypes.c_int * MAX_OPS),
        ("i0", ctypes.c_int * MAX_OPS),
        ("i1", ctypes.c_int * MAX_OPS),
        ("a", ctypes.c_float * MAX_OPS),
        ("b", ctypes.c_float * MAX_OPS),
    ]


def raw_input(kernel: str, t: torch.Tensor) -> torch.Tensor:
    """The raw tensor a prologue reads: uint8, int32 and float32 as they
    are, any other dtype cast to float32 (the op lists' leading
    ``cast_f32``, or the cast the plain versions make), contiguous."""
    if t.dtype not in _DTYPES:
        if t.is_complex():
            raise TypeError(f"{kernel}: cannot read {t.dtype}")
        t = t.to(torch.float32)
    return t.contiguous()


def encode(kernel: str, ops: Sequence[tuple], raw: torch.Tensor, need: int) -> PreOps:
    """Encode ``ops`` for a prologue reading ``raw`` (H, W[, bands]) whose
    kernel uses the first ``need`` bands of the chain's output."""
    ops = tuple(ops)
    if ops and not kernel_safe(ops):
        raise ValueError(f"{kernel}: the pre-stage ops {ops} are not kernel-safe")
    stride = raw.shape[2] if raw.dim() == 3 else 1
    selects = any(op[0] in ("band", "ndiff") for op in ops)
    # elementwise chains map band j to band j: only the bands used are read
    nload = stride if selects else min(stride, need)
    if nload > MAX_BANDS:
        raise ValueError(f"{kernel}: the pre-stage reads {nload} bands, at most {MAX_BANDS}")
    for op in ops:
        if op[0] == "band" and not 0 <= op[1] < stride:
            raise ValueError(f"{kernel}: band {op[1]} of a {stride}-band input")
        if op[0] == "ndiff" and not (0 <= op[1] < stride and 0 <= op[2] < stride):
            raise ValueError(f"{kernel}: ndiff bands {op[1:3]} of a {stride}-band input")
    p = PreOps()
    p.dtype = _DTYPES[raw.dtype]
    p.stride = stride
    p.nload = nload
    n = 0
    for op in ops:
        kind = op[0]
        if kind == "cast":
            if op[1] == torch.float32:
                continue  # the prologue computes in float32 already
            kind = "trunc"
        p.code[n] = _CODES[kind]
        if kind in ("sub", "div", "mul", "add"):
            p.a[n] = op[1]
        elif kind == "clip":
            p.a[n], p.b[n] = op[1], op[2]
        elif kind == "band":
            p.i0[n] = op[1]
        elif kind == "ndiff":
            p.i0[n], p.i1[n], p.a[n] = op[1], op[2], op[3]
        n += 1
    p.n = n
    return p
