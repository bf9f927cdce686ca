"""Manifold scoring: a streaming argmax (port of K1), per block or of the
scores summed over blocks, and the full score surface of a block (port of
K2).

`score_argmax` is the contract of the JAX package's `_score_axis_argmax`
without a mesh (navlab_dpe_sdr_tpu/ops/dpe_real.py:1171): for each block n,
score every grid point of one manifold against block n's score windows
(`_score_chunk`, :876) and keep (max, first index at the max) over the grid
(`_local_argmax_scan`, :1023) — plus, when weighted, the score-weighted sums
of the offsets. The [N, G] surface is never materialized whole. With
`block_sum=True` it is the contract of `_score_axis_accumulate` (:1191) and
`score_joint_argmax` (:1506): the scores of all N blocks (or epochs) are
summed per grid point, in float32 and in ascending n, before the running
(max, first index) and the weighted sums; the results are scalars.

On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/score_argmax.cu` (the port of ops/pallas_score.py `_chunk_kernel`);
on a CPU tensor it runs `score_argmax_plain`, the same arithmetic in plain
PyTorch. There is no fallback between the two. The kernel's launches are
counted under "score_argmax" per block and "score_argmax_sum" block-summed.

On a product grid (`grid_factors`: the clock axis varies fastest, the
spatial offsets are constant over runs of its L values) the caller may
pass the grid's factors, and the argmax modes' kernel then forms each
spatial point's range term once per (block, channel) and reuses it across
the clock axis. Each score still comes from the same f32 operands in the
same order, so the results are those of the per-point kernel, bit for bit.
Such launches are counted under "score_argmax_factored" and
"score_argmax_sum_factored". Where the factors cannot serve (the weighted
modes, sinc, an L that the kernel's clock step CLOCK_STEP does not divide)
the per-point kernel runs.

`score_surface` returns the whole [N, G] surface instead (the per-block
step's `score_manifolds_mag`, navlab_dpe_sdr_tpu/ops/dpe_real.py:751, whose
TPU kernel is pallas_score.py `_score_kernel`), and `score_surface_argmax`
the surface with its (max, first index at the max): the same kernel in its
surface mode on a CUDA tensor, `score_surface_plain` on a CPU tensor. Every
mode evaluates a point with one device function, so the scores are those of
`score_points`, bit for bit.

The quadratic interpolation is the 3-tap Lagrange value about
k = clip(round(idx), 1, W-2) written as a_k + d (b_k + d c_k) with d = idx - k
and per-tap coefficients a_k = win[k], b_k = (win[k+1] - win[k-1]) / 2,
c_k = (win[k+1] + win[k-1]) / 2 - win[k]; the curvature term multiplies by
1 / (2 r0). Both are formed once per (block, channel), on the card while the
windows are staged, and leave a point-channel 4 operations and one 16-byte
read where the weight form has 11 and three.

`interp="sinc"` is sum_k win[k] sinc(idx - k) over the whole window, no
clamp (the JAX `_interp_weights`). The kernel takes one sine per
point-channel, sin(pi (idx - k)) = (-1)^k sin(pi idx), and two taps over
one approximate reciprocal; `torch.sinc` takes a sine and a division per
tap. They round differently, so for sinc alone kernel and plain version
agree to rtol 1e-5 on scores, not to the bit.

`ceil_rows`, `even_rows` and `pick_first` split rows among a mesh's ranks
and combine their (max, first index); they live here, so that the ops layer
reaches parallel/ only through the mesh object a caller passes in.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

INTERP_MODES = ("quadratic", "linear", "sinc")    # csrc/score_argmax.cu: 0, 1, 2
PLAIN_CHUNK = 16384     # grid points per step of the plain streaming scan
CLOCK_STEP = 5          # csrc/score_argmax.cu kClockStep: the factored kernel's
                        # clock values a thread, which must divide L


class GridFactors(NamedTuple):
    """The factors of a product grid off3 [G, 3], off1 [G]: off3[g] =
    o3u[g // L] and off1[g] = o1u[g % L], L = o1u.shape[0]."""
    o3u: torch.Tensor      # [G / L, 3] the spatial points
    o1u: torch.Tensor      # [L] the clock values
    fits: bool             # CLOCK_STEP divides L: the factored kernel takes it


def grid_factors(off3: torch.Tensor, off1: torch.Tensor):
    """The GridFactors of off3 [G, 3], off1 [G] where they are a product
    grid whose clock axis varies fastest: off3 constant (to the bit) over
    aligned runs of L > 1 rows, and off1 the same L values, to the bit,
    repeated G / L times. None otherwise. A few reductions over the
    tensors on their own device and two reads of a count or a flag: run it
    once per grid, not per call."""
    g = off3.shape[0]
    if g < 2 or tuple(off3.shape) != (g, 3) or tuple(off1.shape) != (g,):
        return None
    b3 = off3.contiguous().view(torch.int32)
    b1 = off1.contiguous().view(torch.int32)
    moved = (b3 != b3[:1]).any(dim=1).to(torch.uint8)
    run = int(torch.argmax(moved)) or g     # the first row unlike row 0
    if run < 2 or g % run:
        return None
    r3, r1 = b3.view(g // run, run, 3), b1.view(g // run, run)
    if not bool(((r3 == r3[:, :1]).all() & (r1 == b1[:run]).all()).item()):
        return None
    return GridFactors(off3[::run].contiguous(), off1[:run].contiguous(),
                       run % CLOCK_STEP == 0)


def factor_rows(factors, lo: int, hi: int):
    """The factors of rows [lo, hi) of a product grid: those of the runs
    they hold when they start and end on run boundaries, else None."""
    if factors is None:
        return None
    run = factors.o1u.shape[0]
    if lo % run or hi % run or hi <= lo:
        return None
    return factors._replace(o3u=factors.o3u[lo // run:hi // run])


def score_points(win_mag, los_enu, centers, coefs, r0, o3, o1,
                 interp: str, l_power: int):
    """Scores [N, G'] of the grid points o3 [G', 3], o1 [G'] (plain PyTorch).

    win_mag [N, C, W]; los_enu [N, C, 3]; centers/coefs [N, C]; r0 [N, C]
    for the position manifold or None for the velocity manifold. The f32
    operations and their order are those of the kernel (csrc/
    score_argmax.cu), and the semantics those of the JAX `_score_chunk`.
    """
    if interp not in INTERP_MODES:
        raise ValueError(f"interp={interp!r}: one of {INTERP_MODES}")
    x, y, z = o3[:, 0], o3[:, 1], o3[:, 2]                 # [G']
    l0, l1, l2 = (los_enu[..., j:j + 1] for j in range(3))  # [N, C, 1]
    u = l0 * x + l1 * y + l2 * z                          # [N, C, G']
    if r0 is not None:
        d2 = x * x + y * y + z * z
        rng = -u + (d2 - u * u) * (1.0 / (2.0 * r0))[..., None]
    else:
        rng = -u
    idx = centers[..., None] + coefs[..., None] * (rng + o1)
    w = win_mag.shape[-1]
    if interp == "quadratic":
        k0 = torch.round(idx).clamp(1.0, w - 2.0)         # half to even
        d = idx - k0
        k = k0.long()
        wm, wp = win_mag[..., :-2], win_mag[..., 2:]
        cb = F.pad(0.5 * (wp - wm), (1, 1))                # per-tap slope
        cc = F.pad(0.5 * (wp + wm) - win_mag[..., 1:-1], (1, 1))  # curvature
        vals = (torch.gather(win_mag, 2, k)
                + d * (torch.gather(cb, 2, k) + d * torch.gather(cc, 2, k)))
    elif interp == "sinc":
        k = torch.arange(w, dtype=idx.dtype, device=idx.device)
        vals = (torch.sinc(idx[..., None] - k) * win_mag[:, :, None, :]).sum(-1)
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
                       weighted: bool = False, chunk: int | None = None,
                       block_sum: bool = False):
    """Plain PyTorch `score_argmax`: a scan over grid chunks carrying the
    running best (strict `>` across chunks, first occurrence inside one —
    the global first-index rule). Weighted sums accumulate in float64.
    block_sum: the blocks' scores are added, one after the other from n = 0
    up (the kernel's order), before the reduction; outputs are scalars."""
    if chunk is None:       # sinc holds a [N, C, chunk, W] weight tensor
        chunk = PLAIN_CHUNK // 8 if interp == "sinc" else PLAIN_CHUNK
    return streaming_best(
        lambda o3, o1: score_points(win_mag, los_enu, centers, coefs, r0, o3,
                                    o1, interp, l_power),
        off3, off1, win_mag.shape[0], chunk, weighted, block_sum)


def ceil_rows(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each part when part r holds rows r*ceil(n/parts) on
    (the last parts may be short or empty)."""
    per = -(-n // parts)
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(parts)]


def even_rows(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of `parts` contiguous parts whose sizes differ by at
    most one (the first n % parts are the longer)."""
    out, lo = [], 0
    for r in range(parts):
        hi = lo + n // parts + (r < n % parts)
        out.append((lo, hi))
        lo = hi
    return out


def pick_first(bests: torch.Tensor, args: torch.Tensor):
    """(best, arg) over the rank axis 0 of gathered [nd, ...] bests and
    their global indices: the highest best, the lowest rank among equal
    ones (torch.argmax returns the first maximal index). With rows split by
    `ceil_rows`, that is the single scorer's first occurrence."""
    sel = torch.argmax(bests, dim=0, keepdim=True)
    return (torch.gather(bests, 0, sel)[0], torch.gather(args, 0, sel)[0])


def streaming_best(scores, off3, off1, n: int, chunk: int,
                   weighted: bool = False, block_sum: bool = False):
    """The running (max, first index) over grid chunks of `scores(o3, o1)`
    -> [n, chunk'] f32 (the reduction of `score_argmax_plain`; also of the
    mesh's channel-split scorer, ops/dpe_real.py). With weighted, the
    score-weighted offset sums in float64; with block_sum the n rows are
    added in ascending order first and the results are scalars."""
    rows = 1 if block_sum else n
    g = off3.shape[0]
    dev = off3.device
    best = torch.full((rows,), float("-inf"), dtype=torch.float32,
                      device=dev)
    arg = torch.zeros((rows,), dtype=torch.int64, device=dev)
    wsum4 = torch.zeros((rows, 4), dtype=torch.float64, device=dev)
    wtot = torch.zeros((rows,), dtype=torch.float64, device=dev)
    for g0 in range(0, g, chunk):
        o3 = off3[g0:g0 + chunk]
        o1 = off1[g0:g0 + chunk]
        s = scores(o3, o1)                                 # [n, chunk]
        if block_sum:
            tot = s[0]
            for i in range(1, s.shape[0]):
                tot = tot + s[i]
            s = tot[None]
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
    return tuple(t[0] for t in out) if block_sum else out


def score_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                 interp: str = "quadratic", l_power: int = 1,
                 weighted: bool = False, block_sum: bool = False,
                 factors: GridFactors | None = None):
    """(best [N] f32, arg [N] int32) (+ (wsum4 [N, 4], wtot [N]) when
    weighted) of one manifold over the whole grid off3 [G, 3], off1 [G].
    block_sum=True: the same of S(g) = sum_n score(n, g), as scalars
    (best [], arg [], wsum4 [4], wtot []): noncoherent integration over
    blocks, or the joint surface of many epochs. factors: the grid's
    `grid_factors` (or None); they change how the kernel computes, never
    what.

    CPU tensors -> `score_argmax_plain`; CUDA tensors -> the kernel, or an
    exception."""
    dev = _check_call(win_mag, interp, l_power, "score_argmax")
    if factors is not None:
        run = factors.o1u.shape[0]
        g = off3.shape[0]
        if run < 1 or g % run or tuple(factors.o3u.shape) != (g // run, 3):
            raise ValueError(f"factors ({tuple(factors.o3u.shape)}, "
                             f"({run},)) do not factor a grid of {g} points")
    if dev.type == "cpu":
        return score_argmax_plain(win_mag, los_enu, centers, coefs, r0,
                                  off3, off1, interp, l_power, weighted,
                                  block_sum=block_sum)
    mode = MODE_WEIGHTED if weighted else MODE_ARGMAX
    if block_sum:
        mode = MODE_SUM_WEIGHTED if weighted else MODE_SUM_ARGMAX
    name = "score_argmax_sum" if block_sum else "score_argmax"
    if (factors is not None and factors.fits and not weighted
            and interp != "sinc"):
        if factors.o3u.device != dev or factors.o1u.device != dev:
            raise ValueError(f"factors on {factors.o3u.device}, the call "
                             f"on {dev}")
        name += "_factored"
    else:
        factors = None
    res = _launch(name, mode, win_mag, los_enu, centers, coefs, r0, off3,
                  off1, interp, int(l_power), factors)[1:]
    return tuple(t[0] for t in res) if block_sum else res


def score_surface_plain(win_mag, los_enu, centers, coefs, r0, off3, off1,
                        interp: str = "quadratic", l_power: int = 1,
                        chunk: int = PLAIN_CHUNK):
    """Plain PyTorch `score_surface`: `score_points` over grid chunks."""
    return torch.cat([score_points(win_mag, los_enu, centers, coefs, r0,
                                   off3[g0:g0 + chunk], off1[g0:g0 + chunk],
                                   interp, l_power)
                      for g0 in range(0, off3.shape[0], chunk)], dim=1)


def score_surface_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                         interp: str = "quadratic", l_power: int = 1):
    """(scores [N, G] f32, best [N] f32, arg [N] int32): every grid point's
    score for every block, with the maximum and the first index at it (K2's
    contract; the per-block step calls it at N = 1).

    CPU tensors -> `score_surface_plain` and a first-occurrence argmax;
    CUDA tensors -> the kernel, which reduces while it writes, or an
    exception."""
    dev = _check_call(win_mag, interp, l_power, "score_surface")
    if dev.type == "cpu":
        s = score_surface_plain(win_mag, los_enu, centers, coefs, r0, off3,
                                off1, interp, l_power)
        arg = torch.argmax(s, dim=1)                       # first occurrence
        return s, torch.gather(s, 1, arg[:, None])[:, 0], arg.to(torch.int32)
    return _launch("score_surface", MODE_SURFACE, win_mag, los_enu, centers,
                   coefs, r0, off3, off1, interp, int(l_power))


def score_surface(win_mag, los_enu, centers, coefs, r0, off3, off1,
                  interp: str = "quadratic", l_power: int = 1):
    """Scores [N, G] f32 of every grid point off3 [G, 3], off1 [G] for
    every block: `score_surface_argmax` without its reduction's results."""
    return score_surface_argmax(win_mag, los_enu, centers, coefs, r0, off3,
                                off1, interp, l_power)[0]


def _check_call(win_mag, interp, l_power, name) -> torch.device:
    if interp not in INTERP_MODES:
        raise ValueError(f"interp={interp!r}: one of {INTERP_MODES}")
    if int(l_power) < 1:
        raise ValueError(f"l_power must be >= 1, got {l_power}")
    dev = win_mag.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


# csrc/score_argmax.cu; the last two reduce the scores summed over blocks
MODE_ARGMAX, MODE_WEIGHTED, MODE_SURFACE = 0, 1, 2
MODE_SUM_ARGMAX, MODE_SUM_WEIGHTED = 3, 4

# Per (device, stream): the kernel's reduction scratch, an int64 tensor of
# zeros (packed maxima [cap] u64, then tickets [cap] u32). Each launch leaves
# it zero for the next one on the same stream; it is dropped when a launch
# is refused. Threads (a fleet's receivers) take and replace entries under
# _scratch_lock; launches that share an entry are ordered by their stream.
_scratch: dict[tuple[int, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()
_sm_count: dict[int, int] = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_launch.argtypes = [p] * 9 + [i] * 18 + [p] * 9
    lib.score_launch.restype = ctypes.c_int
    lib.score_tiles.argtypes = [i] * 8
    lib.score_tiles.restype = ctypes.c_int
    lib.score_shared_bytes.argtypes = [i] * 4
    lib.score_shared_bytes.restype = ctypes.c_longlong
    lib.score_max_shared.argtypes = []
    lib.score_max_shared.restype = ctypes.c_int
    lib.score_error_string.argtypes = [i]
    lib.score_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return _build.load("score_argmax", _bind)


@functools.lru_cache(maxsize=None)
def _shared_memory(c, w, interp_code, weighted) -> tuple[int, int]:
    """(bytes one block's staged windows need, the kernel's limit): the
    kernel's own numbers, asked once per shape."""
    lib = _lib()
    return (lib.score_shared_bytes(c, w, interp_code, weighted),
            lib.score_max_shared())


def _operand(t, dev, shape, name, contiguous=False):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.contiguous() if contiguous else t


def _launch(name, mode, win_mag, los_enu, centers, coefs, r0, off3, off1,
            interp, l_power, factors=None):
    """Check the operands, launch the kernel once on the current stream and
    return (surface or None, best, arg[, wsum4, wtot]), each with one entry
    per output slot: per block, or one in the block-summed modes. The
    windows and the grid offsets must be contiguous (copied if not); the
    per-channel parameters are read by their strides, so slices of a packed
    parameter tensor go in as they are. factors (contiguous, on the
    windows' device: `grid_factors`) select the factored kernel."""
    dev = win_mag.device
    n, c, w = win_mag.shape
    g = off3.shape[0]
    if not 0 < n <= 65535 or not 0 < g < 2 ** 31 - 1024:
        raise ValueError(f"{name}: N={n}, G={g} out of the kernel's range")
    icode = INTERP_MODES.index(interp)
    weighted = int(mode in (MODE_WEIGHTED, MODE_SUM_WEIGHTED))
    slots = 1 if mode in (MODE_SUM_ARGMAX, MODE_SUM_WEIGHTED) else n
    lib = _lib()
    need, limit = _shared_memory(c, w, icode, weighted)
    if need > limit:
        raise ValueError(
            f"{name}: C={c} x W={w} windows exceed the kernel's "
            f"{limit // 1024} KB of shared memory")
    win_mag = _operand(win_mag, dev, (n, c, w), "win_mag", contiguous=True)
    los_enu = _operand(los_enu, dev, (n, c, 3), "los_enu")
    centers = _operand(centers, dev, (n, c), "centers")
    coefs = _operand(coefs, dev, (n, c), "coefs")
    if r0 is not None:
        r0 = _operand(r0, dev, (n, c), "r0")
    off3 = _operand(off3, dev, (g, 3), "off3", contiguous=True)
    off1 = _operand(off1, dev, (g,), "off1", contiguous=True)
    o3u, o1u = (None, None) if factors is None else factors[:2]
    run = 0 if o1u is None else o1u.shape[0]
    strides = (*los_enu.stride(), *centers.stride(), *coefs.stride(),
               *(r0.stride() if r0 is not None else (0, 0)))

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((2, slots), **f32)
    best, arg = out[0], out[1].view(torch.int32)
    surface = torch.empty((n, g), **f32) if mode == MODE_SURFACE else None
    part_w = wsum = None
    if weighted:
        aligned = int(off3.data_ptr() % 16 == 0 and off1.data_ptr() % 16 == 0)
        tiles = lib.score_tiles(n, c, w, g, icode, mode, aligned, sms)
        part_w = torch.empty((slots, tiles, 5), dtype=torch.float64,
                             device=dev)
        wsum = torch.empty(5 * slots, **f32)    # wsum4 [slots, 4], wtot [slots]

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        stream = torch.cuda.current_stream(idx).cuda_stream
        key = (idx, stream)
        with _scratch_lock:
            scratch = _scratch.get(key)
            if scratch is None or scratch.numel() < 2 * slots:
                scratch = _scratch[key] = torch.zeros(
                    2 * max(slots, 64), dtype=torch.int64, device=dev)
        return key, lib.score_launch(
            ptr(win_mag), ptr(los_enu), ptr(centers), ptr(coefs), ptr(r0),
            ptr(off3), ptr(off1), ptr(o3u), ptr(o1u), run, *strides, n, c,
            w, g,
            icode, l_power, mode, sms, ptr(surface),
            scratch.data_ptr(),
            scratch.data_ptr() + 4 * scratch.numel(), ptr(part_w),
            ptr(best), ptr(arg), ptr(wsum),
            None if wsum is None else wsum.data_ptr() + 16 * slots, stream)

    if torch.cuda.current_device() == idx:
        key, rc = launch()
    else:                       # the launch goes to the current device
        with torch.cuda.device(idx):
            key, rc = launch()
    if rc != 0:
        with _scratch_lock:
            _scratch.pop(key, None)
        msg = lib.score_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    _build.count_launch(name)
    res = (surface, best, arg)
    if weighted:
        res += (wsum[:4 * slots].view(slots, 4), wsum[4 * slots:])
    return res
