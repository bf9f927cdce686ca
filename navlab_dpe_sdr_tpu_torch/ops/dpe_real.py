"""Real-arithmetic windowed DPE engine on torch tensors.

Port of navlab_dpe_sdr_tpu/ops/dpe_real.py: the windowed correlator
(ops/correlate.py, K5 on the card: per-code-period folds, the nav-bit tail
fold and its exact boundary arc, lag windows, the windowed carrier DFT),
then manifold scoring with a streaming argmax (ops/score.py), batched over
N blocks in one call, per block (`dpe_batch_blocks`) or integrated over
the batch (`dpe_scan_integrate`), and the multi-epoch joint argmax of the
survey solve (`score_joint_argmax`).

Differences from the JAX module, all in form, not in result: those of the
correlator (ops/correlate.py), and under a mesh (parallel/mesh.py: `mesh=`
on `batch_correlate`, `dpe_device_step_real`, `score_manifolds_mag`,
`dpe_batch_blocks`, `dpe_scan_integrate` and `score_joint_argmax`) each
rank correlates its share of the blocks (over 'grid') and of the channels
(over 'chan'), scores its rows of the grid, and one all-gather per step
combines what JAX's shard_map collectives combine (`_score_axis_sharded`,
`_constrain_chan`, `_constrain_block_axis`); every rank ends with the
whole results.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# SLIVER_LIMIT is also read from this module by its callers
from .correlate import (SLIVER_LIMIT, RealBlockOut, RealBlockOutC,
                        windowed_correlate)
from .dpe import CARR_WIN, CODE_WIN, ManifoldParams
from .score import (INTERP_MODES, ceil_rows, even_rows, pick_first,
                    score_argmax, score_surface, score_surface_argmax,
                    streaming_best)


def score_manifolds_mag(code_mag, carr_mag, params: ManifoldParams, d_enu,
                        dt_m, dv_enu, dtdot, l_power: int = 1,
                        interp: str = "quadratic", mesh=None):
    """(pos_scores [G], pos_arg, vel_scores [G], vel_arg) of one block's
    magnitude windows code_mag/carr_mag [C, W] (the JAX
    `score_manifolds_mag`): each surface and its first-occurrence argmax
    from one `score_surface_argmax` call (K2).

    With a mesh, K2 scores this rank's grid rows, and one all-gather over
    'grid' brings every rank's rows, best and index: the whole [G]
    surfaces (as JAX's host fetch of a sharded array) and the (max, first
    index) combined across ranks."""
    los = params.los_enu[None]
    pos_args = (code_mag[None], los, params.pos_center[None],
                params.pos_coef[None], params.r0[None])
    vel_args = (carr_mag[None], los, params.vel_center[None],
                params.vel_coef[None], None)
    if mesh is None:
        pos, _, pos_arg = score_surface_argmax(
            *pos_args, d_enu, dt_m, interp=interp, l_power=l_power)
        vel, _, vel_arg = score_surface_argmax(
            *vel_args, dv_enu, dtdot, interp=interp, l_power=l_power)
        return pos[0], pos_arg[0], vel[0], vel_arg[0]
    f32 = dict(dtype=torch.float32, device=code_mag.device)
    parts, rows = [], []
    for args, off3, off1 in ((pos_args, d_enu, dt_m),
                             (vel_args, dv_enu, dtdot)):
        rows.append(ceil_rows(off3.shape[0], mesh.shape["grid"]))
        lo, hi = mesh.grid_rows(off3.shape[0])
        if hi > lo:
            surf, best, arg = score_surface_argmax(
                *args, off3[lo:hi], off1[lo:hi], interp=interp,
                l_power=l_power)
            surf, best, arg = surf[0], best[0], arg[0] + lo
        else:
            surf = torch.zeros((0,), **f32)
            best = torch.tensor(float("-inf"), **f32)
            arg = torch.zeros((), dtype=torch.int32, device=f32["device"])
        most = rows[-1][0][1]                   # rank 0 holds the most
        parts += [F.pad(surf, (0, most - surf.shape[0])),
                  torch.stack([best, arg.view(torch.float32)])]
    gathered = mesh.all_gather(torch.cat(parts), "grid")      # [nd, K]
    out, col = [], 0
    for rws in rows:
        most = rws[0][1]
        surf = torch.cat([gathered[r, col:col + hi - lo]
                          for r, (lo, hi) in enumerate(rws)])
        _, arg = pick_first(gathered[:, col + most], gathered[
            :, col + most + 1].contiguous().view(torch.int32))
        out += [surf, arg]
        col += most + 2
    return tuple(out)


def dpe_device_step_real(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                         time_idc, pos_start, vel_start,
                         params: ManifoldParams, d_enu, dt_m, dv_enu, dtdot,
                         carr_fftpts: int, period: int, n_periods: int,
                         l_power: int = 1, interp: str = "quadratic",
                         code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                         mesh=None):
    """One block's fused DPE step (the JAX `dpe_device_step_real`):
    `windowed_correlate` at N = 1, then both score surfaces.

    raw_re/raw_im [S] int16 (the I and Q of an [S, 2] block) or f32;
    rc_mid/fi/ri [C] f32; idx_next/pos_start/
    vel_start [C] int. Returns (pos_scores [G], pos_arg, vel_scores [G],
    vel_arg, flip_used [C], code_mag [C, code_win], carr_mag [C, carr_win]).

    With a mesh (parallel/mesh.py `sharded_dpe_step_real`): each 'chan'
    rank correlates its channel shard, the windows are gathered over
    'chan', and `score_manifolds_mag` scores this rank's grid rows; the
    results are the whole ones on every rank."""
    c = chips.shape[0]
    cs, _ = _channels(mesh, c)
    out = windowed_correlate(
        raw_re[None], raw_im[None], chips[cs], rc_mid[None, cs],
        idx_next[None, cs], fi[None, cs], ri[None, cs], time_idc,
        pos_start[None, cs], vel_start[None, cs], carr_fftpts, period,
        n_periods, code_win=code_win, carr_win=carr_win)
    if mesh is not None:
        out = gather_chan_out(mesh, out, c)
    code_mag, carr_mag = out.code_mag[0], out.carr_mag[0]
    pos, pos_arg, vel, vel_arg = score_manifolds_mag(
        code_mag, carr_mag, params, d_enu, dt_m, dv_enu, dtdot,
        l_power=l_power, interp=interp, mesh=mesh)
    return (pos, pos_arg, vel, vel_arg, out.flip_used[0], code_mag,
            carr_mag)


# ---------------------------------------------------------------------------
# Batched multi-block dispatch (deferred feedback)
# ---------------------------------------------------------------------------

FPK_ROWS = 11  # rc_mid, fi, ri, los_e, los_n, los_u, r0, pos_c, pos_k, vel_c, vel_k
IPK_ROWS = 3   # idx_next, pos_start, vel_start
START_ROW = FPK_ROWS + IPK_ROWS
PK_ROWS = START_ROW + 1  # + start row: ONE upload per batch.
# The int rows ride as float32 (all values < 2^24, exact).


def pack_params(fpk, ipk, start: int) -> np.ndarray:
    """[N,11,C] f64/f32 + [N,3,C] int + scalar start -> [N, 15, C] f32."""
    n, _, c = fpk.shape
    pk = np.empty((n, PK_ROWS, c), np.float32)
    pk[:, :FPK_ROWS] = fpk
    pk[:, FPK_ROWS:START_ROW] = ipk
    pk[:, START_ROW] = np.float32(start)
    return pk


def unpack_params(pk):
    """pk [N, 15, C] f32 tensor -> (fpk [N,11,C], ipk [N,3,C]), two views:
    the int rows stay float32 (integers held exactly), as K5 reads them,
    and the plain correlator and the FFT engine cast them themselves. The
    start row is read on the host, from the packed numpy array, so slicing
    the capture never waits on the device."""
    return pk[:, :FPK_ROWS], pk[:, FPK_ROWS:START_ROW]


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; to a CUDA device as an
    asynchronous copy from pinned memory on the current stream."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:   # a memmap window of a capture file
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batch_correlate(raw_all_i16, start: int, fpk, ipk, chips, time_idc,
                    carr_fftpts: int, period: int, n_periods: int,
                    n_blocks: int, code_win: int = CODE_WIN,
                    carr_win: int = CARR_WIN, complex_out: bool = False,
                    mesh=None):
    """Slice n_blocks from the device capture [B, S, 2] and correlate them
    (JAX `_batch_correlate`).

    With a mesh, the 'grid' ranks split the blocks (`even_rows`) and each
    correlates its part, over its channel shard when the channels split
    over 'chan'; the parts are gathered over 'grid' (JAX
    `_constrain_block_axis`, then `_constrain_replicated`), so every rank
    returns all n_blocks, for its channels."""
    if start < 0 or start + n_blocks > raw_all_i16.shape[0]:
        raise ValueError(f"capture holds {raw_all_i16.shape[0]} blocks; "
                         f"requested {start}..{start + n_blocks}")
    lo, hi = (0, n_blocks) if mesh is None else mesh.block_rows(n_blocks)
    cs, _ = _channels(mesh, chips.shape[0])
    part = None
    if hi > lo:
        raw = raw_all_i16[start + lo:start + hi]             # [n, S, 2]
        fp, ip = fpk[lo:hi, :, cs], ipk[lo:hi, :, cs]
        # views all: K5 reads the int16 pairs and the parameter rows as
        # they lie
        part = windowed_correlate(
            raw[..., 0], raw[..., 1], chips[cs], fp[:, 0],
            ip[:, 0], fp[:, 1], fp[:, 2], time_idc, ip[:, 1], ip[:, 2],
            carr_fftpts, period, n_periods, code_win=code_win,
            carr_win=carr_win, complex_out=complex_out)
    if mesh is None:
        return part
    kind = RealBlockOutC if complex_out else RealBlockOut
    widths = ([code_win, code_win, carr_win, carr_win, 1] if complex_out
              else [code_win, carr_win, 1])
    if part is None:
        packed = torch.zeros((0, cs.stop - cs.start, sum(widths)),
                             dtype=torch.float32, device=raw_all_i16.device)
    else:
        packed = _pack_out(part)
    rows = even_rows(n_blocks, mesh.shape["grid"])
    return _unpack_out(kind, mesh.gather_rows(packed, rows), widths)


def _channels(mesh, c: int):
    """(this rank's slice of C channels, whether they split over 'chan')."""
    if mesh is None:
        return slice(None), False
    return mesh.chan_rows(c), mesh.chan_split(c)


def _pack_out(out) -> torch.Tensor:
    """The fields of a RealBlockOut(C) as one float32 [M, C, K] tensor (the
    windows, then the flips as 0/1): one collective carries them all."""
    cols = [f[..., None].float() if f.dim() == 2 else f for f in out]
    return torch.cat(cols, dim=-1)


def _unpack_out(kind, packed, widths):
    parts = torch.split(packed, widths, dim=-1)
    return kind(*parts[:-1], parts[-1][..., 0] != 0)


def gather_chan_out(mesh, out, c: int):
    """A RealBlockOut(C) of this rank's channel shard -> all C channels
    (gathered over 'chan'); `out` itself when the channels do not split."""
    if not mesh.chan_split(c):
        return out
    widths = [f.shape[-1] if f.dim() == 3 else 1 for f in out]
    return _unpack_out(type(out), mesh.gather_chan(_pack_out(out), c),
                       widths)


def coherent_sum(outc: RealBlockOutC) -> RealBlockOut:
    """Coherent sum over each group's K blocks with data-aided nav-bit
    alignment (JAX `_coherent_sum`, ops/dpe_real.py:1327).

    Fields of outc are [G, K, C, W] ([G, K, C] for flip_used). Each block
    is aligned against the RUNNING sum by the sign of the central taps'
    dot product (first block: +1). Returns magnitudes [G, C, W] and the
    group's last-block flips [G, C]."""
    mc = outc.code_re.shape[-1] // 2
    mv = outc.carr_re.shape[-1] // 2
    sl_c = slice(mc - 1, mc + 2)
    sl_v = slice(mv - 1, mv + 2)
    a_cre = torch.zeros_like(outc.code_re[:, 0])
    a_cim = torch.zeros_like(a_cre)
    a_vre = torch.zeros_like(outc.carr_re[:, 0])
    a_vim = torch.zeros_like(a_vre)
    for k in range(outc.code_re.shape[1]):
        cre, cim = outc.code_re[:, k], outc.code_im[:, k]
        vre, vim = outc.carr_re[:, k], outc.carr_im[:, k]
        dot = ((cre[..., sl_c] * a_cre[..., sl_c]
                + cim[..., sl_c] * a_cim[..., sl_c]).sum(-1)
               + (vre[..., sl_v] * a_vre[..., sl_v]
                  + vim[..., sl_v] * a_vim[..., sl_v]).sum(-1))   # [G, C]
        sgn = torch.where(dot >= 0.0, 1.0, -1.0)[..., None]
        a_cre = a_cre + sgn * cre
        a_cim = a_cim + sgn * cim
        a_vre = a_vre + sgn * vre
        a_vim = a_vim + sgn * vim
    return RealBlockOut(code_mag=torch.sqrt(a_cre ** 2 + a_cim ** 2),
                        carr_mag=torch.sqrt(a_vre ** 2 + a_vim ** 2),
                        flip_used=outc.flip_used[:, -1])


WMEAN_COLS = 8  # pos weighted-mean offsets [4] + vel weighted-mean [4]


def weighted_cols(pres, vres):
    """[..., 8] score-weighted-mean offsets sum(w*offset)/sum(w) per
    manifold from (best, arg, wsum4, wtot) results."""
    pmean = pres[2] / pres[3][..., None].clamp_min(1e-30)
    vmean = vres[2] / vres[3][..., None].clamp_min(1e-30)
    return torch.cat([pmean, vmean], dim=-1)


def pack_rows(out: RealBlockOut, pa, pb, va, vb, return_windows: bool,
              wmean=None):
    """One float32 row per block so the host needs a single fetch.

    Argmax indices are BITCAST into the f32 lanes (`unpack_row_indices` on
    the host): float32 holds integers exactly only to 2^24.
    Layout: [head 4][flips C][wmean 8, only when weighted][windows]."""
    n = pa.shape[0]
    head = torch.stack([pa.to(torch.int32).view(torch.float32), pb,
                        va.to(torch.int32).view(torch.float32), vb], dim=1)
    parts = [head, out.flip_used.float()]
    if wmean is not None:
        parts.append(wmean)
    if return_windows:
        parts += [out.code_mag.reshape(n, -1), out.carr_mag.reshape(n, -1)]
    return torch.cat(parts, dim=1)


def unpack_row_indices(rows: np.ndarray) -> tuple:
    """Host-side decode of the bitcast argmax indices in packed rows:
    (pos_idx [N] int, vel_idx [N] int)."""
    r = np.ascontiguousarray(rows[:, 0], dtype=np.float32)
    pas = r.view(np.int32).astype(np.int64)
    r = np.ascontiguousarray(rows[:, 2], dtype=np.float32)
    vas = r.view(np.int32).astype(np.int64)
    return pas, vas


# The chan-split scorer holds one [N, k] surface chunk at a time, summed in
# place over 'chan': the dense grid's whole surfaces (2 x 75^4 = 63.3 M
# points at N = 16, float32) would be 4.05 GB / n_grid per rank.
SURFACE_CHUNK_BYTES = 1 << 28


def _score_rows(mesh, win_mag, los_enu, centers, coefs, r0, off3, off1,
                interp: str, l_power: int, weighted: bool, block_sum: bool,
                split: bool):
    """One manifold scored over this rank's grid rows (JAX
    `_local_argmax_scan` inside `_score_axis_sharded`): (best, arg as a
    global index[, wsum4, wtot]) for `Mesh.best_over_grid`.

    Without a channel split, K1 (`score_argmax`) on the rows. With one
    (win_mag etc. hold this rank's channels), K1's streaming argmax cannot
    take a partial channel sum: the rows are scored in chunks with the
    kernel's surface mode (K2, `score_surface`, [N, k]), each chunk summed
    over 'chan' (`Mesh.sum`, an all-reduce), and the block sum, the (max,
    first index) and the weighted sums taken on that sum (`streaming_best`),
    as JAX does in XLA after its psum over 'chan'. The partial channel sums
    change the float order against the single device."""
    lo, hi = mesh.grid_rows(off3.shape[0])
    o3, o1 = off3[lo:hi], off1[lo:hi]
    n = win_mag.shape[0]
    if split:
        res = streaming_best(
            lambda a, b: mesh.sum(score_surface(
                win_mag, los_enu, centers, coefs, r0, a, b, interp,
                l_power), "chan"),
            o3, o1, n, max(1, SURFACE_CHUNK_BYTES // (4 * n)), weighted,
            block_sum)
    elif hi > lo:
        res = score_argmax(win_mag, los_enu, centers, coefs, r0, o3, o1,
                           interp=interp, l_power=l_power, weighted=weighted,
                           block_sum=block_sum)
    else:                       # no rows here: nothing to launch
        res = streaming_best(None, o3, o1, n, 1, weighted, block_sum)
    return (res[0], res[1] + lo) + tuple(res[2:])


def _score_both(mesh, out, fpk, d_enu, dt_m, dv_enu, dtdot, interp,
                l_power, weighted, block_sum, split=False):
    """(pos result, vel result) of the windows `out` with the packed
    parameters fpk [N, 11, C] (this rank's channels when `split`): two K1
    calls, or on a mesh each rank's rows and one combine over 'grid'."""
    los_enu = fpk[:, 3:6].transpose(1, 2)                   # [N, C, 3]
    pos = (out.code_mag, los_enu, fpk[:, 7], fpk[:, 8], fpk[:, 6], d_enu,
           dt_m)
    vel = (out.carr_mag, los_enu, fpk[:, 9], fpk[:, 10], None, dv_enu,
           dtdot)
    if mesh is None:
        return tuple(score_argmax(*a, interp=interp, l_power=l_power,
                                  weighted=weighted, block_sum=block_sum)
                     for a in (pos, vel))
    return mesh.best_over_grid([
        _score_rows(mesh, *a, interp, l_power, weighted, block_sum, split)
        for a in (pos, vel)])


def dpe_batch_blocks(raw_all_i16, pk: np.ndarray, chips, time_idc,
                     d_enu, dt_m, dv_enu, dtdot, carr_fftpts: int,
                     period: int, n_periods: int, n_blocks: int,
                     l_power: int = 1, interp: str = "quadratic",
                     return_windows: bool = True,
                     code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                     group_k: int = 1, use_argmax: bool = True, mesh=None):
    """Block-batched fused DPE (JAX `dpe_batch_blocks`).

    raw_all_i16: device-resident int16 capture [B, S, 2]; pk: host packed
    parameters [N, 15, C] (pack_params), uploaded here in one copy; chips,
    time_idc and the grid tensors live on the capture's device. Correlates
    all n_blocks, optionally sums each group of group_k blocks coherently
    (one row per group, referenced to its last block), scores both
    manifolds (two `score_argmax` calls) and returns one packed f32 row
    per block or group (pack_rows).

    mesh: a parallel/mesh.Mesh; block-sharded correlation over 'grid' (and
    channels over 'chan'), the coherent sums on every rank, each rank's
    grid rows scored, (max, first index) and weighted sums combined over
    'grid', the flips and windows gathered over 'chan': every rank returns
    the same rows, those of the single-device call (the correlator's
    windows do not depend on which blocks share its call), but for the
    order of the channel sum when the channels split."""
    if group_k > 1 and n_blocks % group_k:
        raise ValueError(f"n_blocks {n_blocks} % group_k {group_k} != 0")
    start = int(pk[0, START_ROW, 0])
    fpk, ipk = unpack_params(to_device(pk, raw_all_i16.device))
    corr = functools.partial(
        batch_correlate, raw_all_i16, start, fpk, ipk, chips, time_idc,
        carr_fftpts, period, n_periods, n_blocks, code_win, carr_win,
        mesh=mesh)
    if group_k > 1:
        g = n_blocks // group_k
        outc = corr(complex_out=True)
        out = coherent_sum(RealBlockOutC(
            *(x.reshape((g, group_k) + x.shape[1:]) for x in outc)))
        fpk = fpk[group_k - 1::group_k]                     # [G, 11, C]
    else:
        out = corr()
    c = chips.shape[0]
    cs, split = _channels(mesh, c)
    weighted = not use_argmax
    pres, vres = _score_both(mesh, out, fpk[..., cs], d_enu, dt_m, dv_enu,
                             dtdot, interp, l_power, weighted, False, split)
    if mesh is not None:
        out = gather_chan_out(mesh, out, c)
    wmean = weighted_cols(pres, vres) if weighted else None
    return pack_rows(out, pres[1], pres[0], vres[1], vres[0],
                     return_windows, wmean=wmean)


def dpe_scan_integrate(raw_all_i16, pk: np.ndarray, chips, time_idc,
                       d_enu, dt_m, dv_enu, dtdot, carr_fftpts: int,
                       period: int, n_periods: int, n_blocks: int,
                       l_power: int = 1, interp: str = "quadratic",
                       code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                       coherent: bool = False, return_windows: bool = False,
                       use_argmax: bool = True, mesh=None):
    """Multi-block score integration in one dispatch (JAX
    `dpe_scan_integrate`): one argmax per batch of n_blocks.

    Noncoherent: the score surfaces of all blocks are summed per grid point
    inside the scorer (`score_argmax(block_sum=True)`; no [N, G] surface
    exists). Coherent: the complex windows are summed over the batch with
    data-aided nav-bit alignment (`coherent_sum`) and scored once, with the
    last block's geometry. Returns (head, flips [N, C] bool[, code_mag
    [C, Wc], carr_mag [C, Wv]]): head [4] f32 is (pos argmax bitcast, pos
    peak, vel argmax bitcast, vel peak), 12 long with the weighted-mean
    offsets of the integrated surfaces when use_argmax is False; with
    return_windows the windows summed over the batch. mesh: as in
    `dpe_batch_blocks`, with the block-summed scorer on each rank's rows."""
    start = int(pk[0, START_ROW, 0])
    fpk, ipk = unpack_params(to_device(pk, raw_all_i16.device))
    out = batch_correlate(raw_all_i16, start, fpk, ipk, chips, time_idc,
                          carr_fftpts, period, n_periods, n_blocks, code_win,
                          carr_win, complex_out=coherent, mesh=mesh)
    flips = out.flip_used
    if coherent:
        out = coherent_sum(RealBlockOutC(*(x[None] for x in out)))
        fpk = fpk[-1:]
    c = chips.shape[0]
    cs, split = _channels(mesh, c)
    weighted = not use_argmax
    pres, vres = _score_both(mesh, out, fpk[..., cs], d_enu, dt_m, dv_enu,
                             dtdot, interp, l_power, weighted, True, split)
    if mesh is not None:
        flips = mesh.gather_chan(flips, c)
        if return_windows:
            out = gather_chan_out(mesh, out, c)
    # the indices are bitcast, never value-converted: a dense manifold has
    # more points than float32 counts exactly
    head = torch.stack([pres[1].view(torch.float32), pres[0],
                        vres[1].view(torch.float32), vres[0]])
    if weighted:
        head = torch.cat([head, weighted_cols(pres, vres)])
    if return_windows:
        return head, flips, out.code_mag.sum(dim=0), out.carr_mag.sum(dim=0)
    return head, flips


def score_joint_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp: str = "quadratic", l_power: int = 1,
                       has_r0: bool = True, mesh=None):
    """Multi-epoch joint (max, argmax): one candidate state scored against
    many epochs' integrated windows, each with its own geometry (JAX
    `score_joint_argmax`). The epoch axis is the scorer's block axis:
    win_mag [B, C, W], los_enu [B, C, 3], centers/coefs/r0 [B, C]; off3
    [G, 3], off1 [G] are displacements from one common reference state.
    Returns scalars (best f32, arg int32). With a mesh, each rank scores
    its grid rows (and its channels, when they split over 'chan') and the
    results are combined over 'grid'."""
    r0 = r0 if has_r0 else None
    if mesh is None:
        return score_argmax(win_mag, los_enu, centers, coefs, r0, off3,
                            off1, interp=interp, l_power=l_power,
                            block_sum=True)
    cs, split = _channels(mesh, win_mag.shape[1])
    res = _score_rows(mesh, win_mag[:, cs], los_enu[:, cs], centers[:, cs],
                      coefs[:, cs], None if r0 is None else r0[:, cs], off3,
                      off1, interp, l_power, False, True, split)
    return mesh.best_over_grid([res])[0]
