"""The soft LNAV decode's bit loop on the card (csrc/navbits_loop.cu).

`bit_loops_cuda` runs each channel's decision-directed phase loop over its
bit sums, forward then backward, in float64: models/navbits.py `_loop`
twice, as `coherent_bits` runs it, one thread block a channel. It replaces
no TPU kernel (the JAX package has no soft decode); models/navbits.py
`soft_bits` launches it on a CUDA receiver and runs `_loop` in its place on
the CPU. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


class _LoopArgs(ctypes.Structure):
    """The kernel's arguments (LoopArgs in csrc/navbits_loop.cu)."""
    _fields_ = [("sums", ctypes.c_void_p), ("sums_stride", ctypes.c_longlong),
                ("nb", ctypes.c_void_p), ("start", ctypes.c_void_p),
                ("bits", ctypes.c_void_p), ("bits_stride", ctypes.c_longlong),
                ("ends", ctypes.c_void_p), ("n_chan", ctypes.c_int),
                ("nb_max", ctypes.c_int), ("k1", ctypes.c_double),
                ("k2", ctypes.c_double)]


def _bind(lib: ctypes.CDLL) -> None:
    lib.navbits_loop_launch.argtypes = [ctypes.POINTER(_LoopArgs),
                                        ctypes.c_void_p]
    lib.navbits_loop_launch.restype = ctypes.c_int
    lib.navbits_loop_error_string.argtypes = [ctypes.c_int]
    lib.navbits_loop_error_string.restype = ctypes.c_char_p


def bit_loops_cuda(sums: torch.Tensor, nb: torch.Tensor, start: torch.Tensor,
                   bits: torch.Tensor, k1: float, k2: float) -> torch.Tensor:
    """One launch on the current stream (one "navbits_loop" in
    `_build.launch_counts()`): channel c's loop over its first nb[c] bit
    sums sums [C, NB, 2] (re, im; contiguous float64) from start [C, 2]
    (phase [rad], rate [rad a bit], contiguous float64) with gains k1, k2,
    writing the backward pass's +/-1 decisions into bits [C, >= NB] (int8,
    rows contiguous; a view into a larger tensor will do). Returns [C, 4]
    float64: the (phase, rate) the forward and the backward pass ended at,
    as `_loop` returns them. nb [C] int32 may stay on the card: a count
    above NB is taken as NB. Raises on a CPU tensor, on another shape,
    type or layout, and on a refused launch."""
    dev = sums.device
    if dev.type != "cuda":
        raise ValueError(f"bit_loops_cuda needs CUDA tensors, got {dev}")
    if (sums.dtype != torch.float64 or sums.dim() != 3 or sums.shape[2] != 2
            or not sums.is_contiguous()):
        raise ValueError(f"sums: need contiguous float64 [C, NB, 2], got "
                         f"{sums.dtype} {list(sums.shape)}")
    c, n_bits = int(sums.shape[0]), int(sums.shape[1])
    for name, t, dtype, shape in (("nb", nb, torch.int32, (c,)),
                                  ("start", start, torch.float64, (c, 2))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: need contiguous {dtype} {list(shape)} "
                             f"on {dev}, got {t.dtype} {list(t.shape)} on "
                             f"{t.device}")
    if (bits.device != dev or bits.dtype != torch.int8 or bits.dim() != 2
            or bits.shape[0] != c or bits.shape[1] < n_bits
            or bits.stride(1) != 1):
        raise ValueError(f"bits: need int8 [{c}, >= {n_bits}] rows "
                         f"contiguous on {dev}, got {bits.dtype} "
                         f"{list(bits.shape)} strides {bits.stride()}")
    ends = torch.empty((c, 4), dtype=torch.float64, device=dev)
    args = _LoopArgs(sums.data_ptr(), n_bits, nb.data_ptr(),
                     start.data_ptr(), bits.data_ptr(), bits.stride(0),
                     ends.data_ptr(), c, n_bits, float(k1), float(k2))
    lib = _build.load("navbits_loop", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.navbits_loop_launch(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.navbits_loop_error_string(rc).decode()
        raise RuntimeError(f"navbits_loop kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    _build.count_launch("navbits_loop")
    return ends
