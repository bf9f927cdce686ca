"""The tracking correlator (K3) and the closed-loop chunk tracker (K4).

`correlate_window` is one 1 ms window of E/P/L segment sums for all
channels — the contract of the JAX `correlate_window_pallas`
(navlab_dpe_sdr_tpu/ops/pallas_track.py:119) and of `_correlate_step` at
m = 1 with direct chip lookups (ops/tracking.py:387). On a CPU tensor it
runs `correlate_window_plain`; on a CUDA tensor it launches the
hand-written kernel `csrc/track_chunk.cu`. There is no fallback between
the two. `correlate_window_plain(..., m)` is also the m-period window of
coherent tracking (m + 2 segments), and `correlate_windows_cuda` is K3's
windows mode: W consecutive 1 ms windows of open-loop correlation in one
launch (ops/tracking.track_open_loop).

`track_chunk_cuda` launches K4, the same file's persistent kernel that runs
a whole chunk of closed-loop steps in one launch: a cluster of thread
blocks per channel, a ring of sample windows staged ahead in shared memory,
K3's body on the correlating warps, the loop update on three warps by
function, and the lock/C-N0/log half of the tail on a warp of its own;
ops/tracking.track_chunk packs the state for it and holds it to
`track_chunk_plain`. Coherent windows (m = 2..10 code periods a window)
and the batch_k schedule run in the same file's second K4 kernel, whose
ring holds one code period a slot.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..constants import F_CA, L_CA

from . import _build

TWO_PI = float(np.float32(2.0 * np.pi))
F_CA32 = float(np.float32(F_CA))
L_CA32 = float(np.float32(L_CA))

N_STATE_F = 16       # float state fields per channel (tracking.FLOAT_FIELDS)
N_STATE_I = 5        # int32 state fields per channel (tracking.INT_FIELDS)
N_LOG_F = 16         # float log rows per step at m = 1 (tracking.LOG_F_ROWS)
N_LOG_I = 3          # int32 log rows per step: cp, ncp, lock
MAX_COH_MS = 10      # code periods a coherent window holds, at most
KERNEL_THREADS = 1280  # correlating threads per channel (track_threads())
N_CLOCKS = 6          # clock64() sums per channel (track_clock_words())
CLOCK_NAMES = ("wait for samples", "correlate + warp reduce", "step barrier",
               "on-path tail", "off-path tail (with staging)", "step loop")


@functools.lru_cache(maxsize=8)
def window_times(s: int, fs: float, device) -> torch.Tensor:
    """[S] f32 sample times k/fs, formed in float64 and rounded once
    (ops/tracking.py:695 as written; compiled by XLA inside the scan it
    becomes f32(k) * f32(1/fs), one ulp off in ~15 % of the samples).
    Cached per (S, fs, device): callers only read it."""
    return torch.from_numpy((np.arange(s) / fs).astype(np.float32)).to(device)


def n_log_f(m: int) -> int:
    """Float log rows per update of an m-period window: 14, then the m + 1
    nav-bit signs."""
    return 15 + int(m)


def correlate_window_plain(raw_re, raw_im, rc, dfc, ri, fi, code_table,
                           time_idc, fs: float, m: int = 1):
    """Plain PyTorch K3: sums [C, 3 tap (E, P, L), m + 2 seg, 2 (re, im)]
    f32 and ncp [C] int32 of one window of m code periods raw_re/raw_im
    [S] f32, per-channel rc/dfc/ri/fi [C] f32, code_table [C, 1023] f32,
    time_idc [S] f32.

    The f32 operations are those of the JAX `_correlate_step(m)` (gather
    replicas at the mid-window phase rc + dfc m/2 ms, the m + 1 segment
    boundaries k L_CA at the true fc), and those of the kernels in the
    kernels' order, sums included."""
    c = code_table.shape[0]
    s = raw_re.shape[0]
    n_seg = int(m) + 2
    ang = TWO_PI * (fi[:, None] * time_idc[None, :] + ri[:, None])
    wc, ws = torch.cos(ang), torch.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    base = time_idc * F_CA32
    rc_mid = rc + dfc * float(np.float32(m * 0.5e-3))
    taps = []
    for phase in (rc_mid + 0.5, rc_mid, rc_mid - 0.5):
        idx = torch.remainder(torch.floor(base[None, :] + phase[:, None]),
                              L_CA32).long()
        taps.append(torch.gather(code_table, 1, idx))
    repl = torch.stack(taps, dim=2)                         # [C, S, 3]

    fc = F_CA32 + dfc
    ratio = torch.full_like(fc, float(np.float32(fs))) / fc
    cols = torch.arange(s, dtype=torch.float32, device=raw_re.device)
    seg = torch.zeros((c, s), dtype=torch.long, device=raw_re.device)
    for k in range(1, n_seg):
        bk = (float(np.float32(k * L_CA)) - rc) * ratio
        seg = seg + (cols[None, :] >= bk[:, None]).long()
    segm = (seg[:, :, None]
            == torch.arange(n_seg, device=raw_re.device)).float()
    w = (repl[:, :, :, None] * segm[:, :, None, :]).reshape(c, s, 3 * n_seg)
    bb = torch.stack([bb_re, bb_im], dim=1)                 # [C, 2, S]
    prod = bb[:, :, None, :] * w.transpose(1, 2)[:, None]   # [C, 2, 3n, S]
    sums = _kernel_order_sum(prod).reshape(c, 2, 3, n_seg).permute(0, 2, 3, 1)
    ncp = torch.floor((float(np.float32(s / fs)) * fc + rc)
                      * float(np.float32(1.0 / L_CA))).to(torch.int32)
    return sums.contiguous(), ncp


def _kernel_order_sum(prod):
    """Sum over the last axis in the kernel's order: each of KERNEL_THREADS
    threads adds every KERNEL_THREADS-th term in turn, a warp-shuffle tree
    reduces each warp, then the warps are added in turn. The products are
    exact (chips are +/-1, segments 0/1), so the sums, and the closed loop
    they drive, match the kernel's bit for bit where the elementwise
    functions do."""
    s = prod.shape[-1]
    pad = (-s) % KERNEL_THREADS
    p = torch.nn.functional.pad(prod, (0, pad))
    p = p.reshape(p.shape[:-1] + (-1, KERNEL_THREADS))
    acc = p[..., 0, :]
    for r in range(1, p.shape[-2]):
        acc = acc + p[..., r, :]
    acc = acc.reshape(acc.shape[:-1] + (KERNEL_THREADS // 32, 32))
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    acc = acc[..., 0]
    tot = acc[..., 0]
    for wi in range(1, acc.shape[-1]):
        tot = tot + acc[..., wi]
    return tot


def correlate_window(raw, rc, dfc, ri, fi, code_table, fs: float):
    """E/P/L segment sums [C, 3, 3, 2] of one window raw [S, 2] (int16 or
    f32 I/Q) for the channel phases rc/dfc/ri/fi [C] f32.

    CPU tensors -> `correlate_window_plain`; CUDA tensors -> the K3 kernel,
    or an exception."""
    dev = raw.device
    s = raw.shape[0]
    if dev.type == "cpu":
        r = raw.float()
        return correlate_window_plain(r[:, 0], r[:, 1], rc, dfc, ri, fi,
                                      code_table, window_times(s, fs, dev),
                                      fs)[0]
    if dev.type != "cuda":
        raise ValueError(f"correlate_window runs on cpu or cuda, not {dev}")
    c = code_table.shape[0]
    raw = _raw_operand(raw, 2)
    phases = torch.stack([_f32(x, dev, (c,), n) for x, n in
                          ((rc, "rc"), (dfc, "dfc"), (ri, "ri"),
                           (fi, "fi"))], dim=1).contiguous()
    table = _f32(code_table, dev, (c, int(L_CA)), "code_table")
    time_idc = window_times(s, fs, dev)
    out = torch.empty((c, 3, 3, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    _check_samples(lib, s, raw)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_ = lib.correlate_window_launch(
            raw.data_ptr(), int(raw.dtype == torch.int16), time_idc.data_ptr(),
            table.data_ptr(), phases.data_ptr(), c, s, 0,
            float(np.float32(fs)), out.data_ptr(), stream)
    _raise_on(lib, rc_, "correlate_window")
    _build.count_launch("correlate_window")
    return out


def correlate_windows_cuda(raw, rc, dfc, ri, fi, code_table, fs: float):
    """K3's windows mode: E/P/L [W, C, 3 (E, P, L), 2 (re, im)] of W
    consecutive 1 ms windows raw [W, S, 2] (int16 or f32 on the card), in
    one launch. Window w correlates at the phases of the f32 recurrence
    rc_{w+1} = mod(rc_w + dfc T_MS, L_CA), ri_{w+1} = mod(ri_w + fi T_MS, 1)
    from rc/ri [C] (iterated in the kernel, as the plain version does), at
    the rates dfc/fi [C]; its segment sums are combined over the nav-bit
    hypotheses with a zero prompt carry (ops/tracking.track_open_loop)."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"correlate_windows_cuda needs a CUDA tensor, "
                         f"got {dev}")
    n_win, s = int(raw.shape[0]), int(raw.shape[1])
    c = code_table.shape[0]
    raw = _raw_operand(raw, 3)
    phases = torch.stack([_f32(x, dev, (c,), n) for x, n in
                          ((rc, "rc"), (dfc, "dfc"), (ri, "ri"),
                           (fi, "fi"))], dim=1).contiguous()
    table = _f32(code_table, dev, (c, int(L_CA)), "code_table")
    time_idc = window_times(s, fs, dev)
    out = torch.empty((n_win, c, 3, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    _check_samples(lib, s, raw)
    if n_win < 1:
        raise ValueError("correlate_windows: no windows")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_ = lib.correlate_window_launch(
            raw.data_ptr(), int(raw.dtype == torch.int16), time_idc.data_ptr(),
            table.data_ptr(), phases.data_ptr(), c, s, n_win,
            float(np.float32(fs)), out.data_ptr(), stream)
    _raise_on(lib, rc_, "correlate_windows")
    _build.count_launch("correlate_windows")
    return out


class TrackParams(ctypes.Structure):
    """The kernel's per-configuration scalars (csrc/track_chunk.cu)."""
    _fields_ = ([(n, ctypes.c_float) for n in (
        "fs", "win_s", "inv_lca", "t_up", "fcaid", "lpf", "one_m_lpf",
        "snr_den", "fll_norm")]
        + [("carr", ctypes.c_float * 5), ("code", ctypes.c_float * 5)]
        + [(n, ctypes.c_int) for n in ("boxcar", "fll", "carr_h2", "code_h2",
                                       "loss_th", "lock_th")]
        + [("half_win", ctypes.c_float), ("m", ctypes.c_int),
           ("batch_k", ctypes.c_int)])


def launch_name(params: TrackParams) -> str:
    """The launch-count key of a K4 configuration: "track_chunk" (m = 1),
    "track_chunk_coherent" (m > 1) or "track_chunk_batched" (batch_k > 1)."""
    if params.m > 1:
        return "track_chunk_coherent"
    return "track_chunk_batched" if params.batch_k > 1 else "track_chunk"


def track_chunk_cuda(stf, sti, rings, raw, code_table, fs: float,
                     params: TrackParams, clocks=None):
    """Launch K4 over raw [steps, S, 2] (int16 or f32) on the card.

    stf [C, 16] f32, sti [C, 5] int32, rings [C, 2, 20] f32: the packed
    carry (ops/tracking.pack_state). Returns the new carry and the packed
    logs (stf', sti', rings', logf [steps, 15 + m, C] f32, logi
    [steps, 3, C] int32); the inputs are not modified. A window holds
    params.m code periods (S / m samples each); params.batch_k > 1 is the
    batch_k schedule (steps a multiple of it). `clocks`, an int64
    [C, N_CLOCKS] CUDA tensor, asks the m = 1 kernel for its clock64() sums
    per channel (CLOCK_NAMES); the path never passes it."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"track_chunk_cuda needs a CUDA tensor, got {dev}")
    steps, s = int(raw.shape[0]), int(raw.shape[1])
    m, kb = int(params.m), int(params.batch_k)
    c = code_table.shape[0]
    raw = _raw_operand(raw, 3)
    table = _f32(code_table, dev, (c, int(L_CA)), "code_table")
    stf = _f32(stf, dev, (c, N_STATE_F), "state (float)")
    rings = _f32(rings, dev, (c, 2, rings.shape[2]), "state (rings)")
    if sti.device != dev or sti.dtype != torch.int32 or tuple(sti.shape) != (
            c, N_STATE_I):
        raise ValueError(f"state (int): need int32 [{c}, {N_STATE_I}] on "
                         f"{dev}, got {sti.dtype} {tuple(sti.shape)} on "
                         f"{sti.device}")
    sti = sti.contiguous()
    if rings.shape[2] != 20:
        raise ValueError(f"C/N0 rings hold 20 samples, got {rings.shape[2]}")
    if not 1 <= m <= MAX_COH_MS or s % m or kb < 1 or (m > 1 and kb > 1) \
            or steps % kb:
        raise ValueError(f"K4 takes windows of m = 1..{MAX_COH_MS} whole "
                         f"periods, or batch_k > 1 at m = 1 over a multiple "
                         f"of batch_k steps; got m={m}, S={s}, "
                         f"batch_k={kb}, steps={steps}")
    if clocks is not None and (m > 1 or kb > 1):
        raise ValueError("clocks: the m = 1 kernel's only")
    time_idc = window_times(s, fs, dev)
    stf_out = torch.empty_like(stf)
    sti_out = torch.empty_like(sti)
    rings_out = torch.empty_like(rings)
    logf = torch.empty((steps, n_log_f(m), c), dtype=torch.float32,
                       device=dev)
    logi = torch.empty((steps, N_LOG_I, c), dtype=torch.int32, device=dev)
    lib = _lib()
    i16 = int(raw.dtype == torch.int16)
    if m > 1 or kb > 1:
        if lib.track_window_depth(s // m, i16) < m:
            raise ValueError(f"a window of {m} periods of {s // m} "
                             f"{raw.dtype} samples exceeds the kernel's ring "
                             f"(shared memory)")
    else:
        _check_samples(lib, s, raw)
    if clocks is not None and (
            clocks.device != dev or clocks.dtype != torch.int64
            or tuple(clocks.shape) != (c, lib.track_clock_words())
            or not clocks.is_contiguous()):
        raise ValueError(f"clocks: need contiguous int64 "
                         f"[{c}, {lib.track_clock_words()}] on {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc_ = lib.track_chunk_launch(
            raw.data_ptr(), i16, time_idc.data_ptr(),
            table.data_ptr(), stf.data_ptr(), sti.data_ptr(),
            rings.data_ptr(), stf_out.data_ptr(), sti_out.data_ptr(),
            rings_out.data_ptr(), logf.data_ptr(), logi.data_ptr(), c, s,
            steps, params, None if clocks is None else clocks.data_ptr(),
            stream)
    _raise_on(lib, rc_, "track_chunk")
    _build.count_launch(launch_name(params))
    return stf_out, sti_out, rings_out, logf, logi


def _lib() -> ctypes.CDLL:
    lib = _build.load("track_chunk")
    if lib.track_chunk_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.correlate_window_launch.argtypes = [p, i, p, p, p, i, i, i, f, p,
                                                p]
        lib.correlate_window_launch.restype = i
        lib.track_chunk_launch.argtypes = ([p, i] + [p] * 10 + [i, i, i]
                                           + [TrackParams, p, p])
        lib.track_chunk_launch.restype = i
        for fn, args in ((lib.track_max_samples, [i]),
                         (lib.track_ring_depth, [i, i]),
                         (lib.track_window_depth, [i, i]),
                         (lib.track_params_size, []), (lib.track_threads, []),
                         (lib.track_cluster, []),
                         (lib.track_clock_words, [])):
            fn.argtypes, fn.restype = args, i
        lib.track_error_string.argtypes = [i]
        lib.track_error_string.restype = ctypes.c_char_p
        if lib.track_params_size() != ctypes.sizeof(TrackParams):
            raise RuntimeError("TrackParams layout differs between the "
                               "kernel and its binding")
        if lib.track_clock_words() != N_CLOCKS:
            raise RuntimeError("clock buffer layout differs between the "
                               "kernel and its binding")
        if lib.track_threads() != KERNEL_THREADS:
            # the plain sums follow the kernel's thread count
            # (_kernel_order_sum)
            raise RuntimeError(f"kernel sums over {lib.track_threads()} "
                               f"threads per channel, plain sum order "
                               f"assumes {KERNEL_THREADS}")
    return lib


def kernel_design() -> dict:
    """What the built kernel is: correlating threads and thread blocks per
    channel, the sample windows in flight at the 2.5 MHz int16 window, and
    the code periods the coherent/batched kernel's ring holds."""
    lib = _lib()
    return {"threads": lib.track_threads(), "cluster": lib.track_cluster(),
            "ring_depth_int16_2500": lib.track_ring_depth(2500, 1),
            "period_slots_int16_2500": lib.track_window_depth(2500, 1),
            "period_slots_f32_2500": lib.track_window_depth(2500, 0)}


def _check_samples(lib, s: int, raw) -> None:
    most = lib.track_max_samples(int(raw.dtype == torch.int16))
    if s > most:
        raise ValueError(f"window of {s} {raw.dtype} samples exceeds the "
                         f"kernel's {most} (shared memory)")


def _raise_on(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.track_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {code})")


def _raw_operand(raw, ndim: int):
    """Contiguous int16/f32 [..., S, 2] whose I/Q pairs are 4-byte aligned
    (the kernel copies whole pairs; a view at an odd int16 offset is
    copied once). Windows that are not 16-byte aligned are no obstacle:
    the kernel stages them with 4-byte copies."""
    if raw.dtype not in (torch.int16, torch.float32) or raw.dim() != ndim \
            or raw.shape[-1] != 2:
        raise ValueError(f"raw samples: need int16 or float32 [..., S, 2], "
                         f"got {raw.dtype} {tuple(raw.shape)}")
    raw = raw.contiguous()
    return raw.clone() if raw.data_ptr() % 4 else raw


def _f32(t, dev, shape, name):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{name}: need float32 on {dev}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.contiguous()
