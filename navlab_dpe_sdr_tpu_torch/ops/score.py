"""Manifold scoring: a streaming argmax (port of K1) and the full score
surface of a block (port of K2).

`score_argmax` is the contract of the JAX package's `_score_axis_argmax`
without a mesh (navlab_dpe_sdr_tpu/ops/dpe_real.py:1171): for each block n,
score every grid point of one manifold against block n's score windows
(`_score_chunk`, :876) and keep (max, first index at the max) over the grid
(`_local_argmax_scan`, :1023) — plus, when weighted, the score-weighted sums
of the offsets. The [N, G] surface is never materialized whole.

On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/score_argmax.cu` (the port of ops/pallas_score.py `_chunk_kernel`);
on a CPU tensor it runs `score_argmax_plain`, the same arithmetic in plain
PyTorch. There is no fallback between the two.

`score_surface` returns the whole [N, G] surface instead (the per-block
step's `score_manifolds_mag`, navlab_dpe_sdr_tpu/ops/dpe_real.py:751, whose
TPU kernel is pallas_score.py `_score_kernel`): the same file's second
kernel on a CUDA tensor, `score_surface_plain` on a CPU tensor. Both kernels
evaluate a point with one device function, so their scores are those of
`score_points`, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

INTERP_MODES = ("quadratic", "linear")
PLAIN_CHUNK = 16384     # grid points per step of the plain streaming scan


def score_points(win_mag, los_enu, centers, coefs, r0, o3, o1,
                 interp: str, l_power: int):
    """Scores [N, G'] of the grid points o3 [G', 3], o1 [G'] (plain PyTorch).

    win_mag [N, C, W]; los_enu [N, C, 3]; centers/coefs [N, C]; r0 [N, C]
    for the position manifold or None for the velocity manifold. The f32
    operations and their order are those of the kernel (csrc/
    score_argmax.cu), and the semantics those of the JAX `_score_chunk`.
    """
    if interp not in INTERP_MODES:
        raise NotImplementedError(
            f"interp={interp!r} is not ported (ROADMAP Queue 1 item 5)")
    x, y, z = o3[:, 0], o3[:, 1], o3[:, 2]                 # [G']
    l0, l1, l2 = (los_enu[..., j:j + 1] for j in range(3))  # [N, C, 1]
    u = l0 * x + l1 * y + l2 * z                          # [N, C, G']
    if r0 is not None:
        d2 = x * x + y * y + z * z
        rng = -u + (d2 - u * u) / (2.0 * r0[..., None])
    else:
        rng = -u
    idx = centers[..., None] + coefs[..., None] * (rng + o1)
    w = win_mag.shape[-1]
    if interp == "quadratic":
        k0 = torch.round(idx).clamp(1.0, w - 2.0)         # half to even
        d = idx - k0
        k = k0.long()
        dd = d * d
        vals = (0.5 * (dd - d) * torch.gather(win_mag, 2, k - 1)
                + (1.0 - dd) * torch.gather(win_mag, 2, k)
                + 0.5 * (dd + d) * torch.gather(win_mag, 2, k + 1))
    else:
        kf = torch.floor(idx)
        vals = torch.zeros_like(idx)
        for kk in (kf, kf + 1.0):
            inside = (kk >= 0.0) & (kk <= w - 1.0)
            wt = torch.clamp(1.0 - torch.abs(idx - kk), min=0.0)
            tap = torch.gather(win_mag, 2, kk.clamp(0.0, w - 1.0).long())
            vals = vals + torch.where(inside, wt * tap, 0.0)
    vp = vals
    for _ in range(l_power - 1):
        vp = vp * vals
    acc = vp[:, 0]
    for c in range(1, vp.shape[1]):
        acc = acc + vp[:, c]
    return acc


def score_argmax_plain(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp: str = "quadratic", l_power: int = 1,
                       weighted: bool = False, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch `score_argmax`: a scan over grid chunks carrying the
    running best (strict `>` across chunks, first occurrence inside one —
    the global first-index rule). Weighted sums accumulate in float64."""
    n = win_mag.shape[0]
    g = off3.shape[0]
    dev = win_mag.device
    best = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    arg = torch.zeros((n,), dtype=torch.int64, device=dev)
    wsum4 = torch.zeros((n, 4), dtype=torch.float64, device=dev)
    wtot = torch.zeros((n,), dtype=torch.float64, device=dev)
    for g0 in range(0, g, chunk):
        o3 = off3[g0:g0 + chunk]
        o1 = off1[g0:g0 + chunk]
        s = score_points(win_mag, los_enu, centers, coefs, r0, o3, o1,
                         interp, l_power)                  # [N, chunk]
        if weighted:
            sd = s.double()
            o4 = torch.cat([o3, o1[:, None]], dim=1).double()
            wsum4 = wsum4 + sd @ o4
            wtot = wtot + sd.sum(dim=1)
        ca = torch.argmax(s, dim=1)                        # first occurrence
        cb = torch.gather(s, 1, ca[:, None])[:, 0]
        take = cb > best
        best = torch.where(take, cb, best)
        arg = torch.where(take, ca + g0, arg)
    out = (best, arg.to(torch.int32))
    if weighted:
        out = out + (wsum4.float(), wtot.float())
    return out


def score_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                 interp: str = "quadratic", l_power: int = 1,
                 weighted: bool = False):
    """(best [N] f32, arg [N] int32) (+ (wsum4 [N, 4], wtot [N]) when
    weighted) of one manifold over the whole grid off3 [G, 3], off1 [G].

    CPU tensors -> `score_argmax_plain`; CUDA tensors -> the kernel, or an
    exception."""
    if interp not in INTERP_MODES:
        raise NotImplementedError(
            f"interp={interp!r} is not ported (ROADMAP Queue 1 item 5)")
    if int(l_power) < 1:
        raise ValueError(f"l_power must be >= 1, got {l_power}")
    dev = win_mag.device
    if dev.type == "cpu":
        return score_argmax_plain(win_mag, los_enu, centers, coefs, r0,
                                  off3, off1, interp, l_power, weighted)
    if dev.type != "cuda":
        raise ValueError(f"score_argmax runs on cpu or cuda, not {dev}")
    return _score_argmax_cuda(win_mag, los_enu, centers, coefs, r0, off3,
                              off1, interp, int(l_power), weighted)


def score_surface_plain(win_mag, los_enu, centers, coefs, r0, off3, off1,
                        interp: str = "quadratic", l_power: int = 1,
                        chunk: int = PLAIN_CHUNK):
    """Plain PyTorch `score_surface`: `score_points` over grid chunks."""
    return torch.cat([score_points(win_mag, los_enu, centers, coefs, r0,
                                   off3[g0:g0 + chunk], off1[g0:g0 + chunk],
                                   interp, l_power)
                      for g0 in range(0, off3.shape[0], chunk)], dim=1)


def score_surface(win_mag, los_enu, centers, coefs, r0, off3, off1,
                  interp: str = "quadratic", l_power: int = 1):
    """Scores [N, G] f32 of every grid point off3 [G, 3], off1 [G] for
    every block (K2's contract; the per-block step calls it at N = 1).

    CPU tensors -> `score_surface_plain`; CUDA tensors -> the kernel, or an
    exception."""
    if interp not in INTERP_MODES:
        raise NotImplementedError(
            f"interp={interp!r} is not ported (ROADMAP Queue 1 item 5)")
    if int(l_power) < 1:
        raise ValueError(f"l_power must be >= 1, got {l_power}")
    dev = win_mag.device
    if dev.type == "cpu":
        return score_surface_plain(win_mag, los_enu, centers, coefs, r0,
                                   off3, off1, interp, l_power)
    if dev.type != "cuda":
        raise ValueError(f"score_surface runs on cpu or cuda, not {dev}")
    ops, (n, c, w, g) = _operands(win_mag, los_enu, centers, coefs, r0, off3,
                                  off1, "score_surface")
    out = torch.empty((n, g), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.score_surface_launch(
            *(None if t is None else t.data_ptr() for t in ops), n, c, w, g,
            int(interp == "linear"), int(l_power), out.data_ptr(), stream)
    if rc != 0:
        msg = lib.score_argmax_error_string(rc).decode()
        raise RuntimeError(f"score_surface kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    _build.count_launch("score_surface")
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("score_argmax")
    if lib.score_argmax_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.score_argmax_launch.argtypes = ([p] * 7 + [i] * 7 + [p] * 7
                                            + [p])
        lib.score_argmax_launch.restype = ctypes.c_int
        lib.score_surface_launch.argtypes = [p] * 7 + [i] * 6 + [p, p]
        lib.score_surface_launch.restype = ctypes.c_int
        lib.score_argmax_tile.argtypes = []
        lib.score_argmax_tile.restype = ctypes.c_int
        lib.score_argmax_error_string.argtypes = [i]
        lib.score_argmax_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t, dev, shape, name):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.contiguous()


def _operands(win_mag, los_enu, centers, coefs, r0, off3, off1, name):
    """Checked, contiguous kernel operands and (N, C, W, G)."""
    dev = win_mag.device
    n, c, w = win_mag.shape
    g = off3.shape[0]
    if not 0 < n <= 65535 or not 0 < g < 2 ** 31 - 1024:
        raise ValueError(f"{name}: N={n}, G={g} out of the kernel's range")
    if c * (w + 6) * 4 > 48 * 1024:
        raise ValueError(f"{name}: C={c} x W={w} windows exceed the "
                         f"kernel's 48 KB of shared memory")
    ops = [_operand(win_mag, dev, (n, c, w), "win_mag"),
           _operand(los_enu, dev, (n, c, 3), "los_enu"),
           _operand(centers, dev, (n, c), "centers"),
           _operand(coefs, dev, (n, c), "coefs"),
           None if r0 is None else _operand(r0, dev, (n, c), "r0"),
           _operand(off3, dev, (g, 3), "off3"),
           _operand(off1, dev, (g,), "off1")]
    return ops, (n, c, w, g)


def _score_argmax_cuda(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp, l_power, weighted):
    dev = win_mag.device
    ops, (n, c, w, g) = _operands(win_mag, los_enu, centers, coefs, r0, off3,
                                  off1, "score_argmax")
    lib = _lib()
    tiles = -(-g // lib.score_argmax_tile())
    f32 = dict(dtype=torch.float32, device=dev)
    part_best = torch.empty((n, tiles), **f32)
    part_arg = torch.empty((n, tiles), dtype=torch.int32, device=dev)
    best = torch.empty((n,), **f32)
    arg = torch.empty((n,), dtype=torch.int32, device=dev)
    if weighted:
        part_w = torch.empty((n, tiles, 5), dtype=torch.float64, device=dev)
        wsum4 = torch.empty((n, 4), **f32)
        wtot = torch.empty((n,), **f32)
    else:
        part_w = wsum4 = wtot = None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.score_argmax_launch(
            *(ptr(t) for t in ops), n, c, w, g,
            int(interp == "linear"), l_power, int(weighted),
            ptr(part_best), ptr(part_arg), ptr(part_w),
            ptr(best), ptr(arg), ptr(wsum4), ptr(wtot), stream)
    if rc != 0:
        msg = lib.score_argmax_error_string(rc).decode()
        raise RuntimeError(f"score_argmax kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    _build.count_launch("score_argmax")
    out = (best, arg)
    if weighted:
        out = out + (wsum4, wtot)
    return out
