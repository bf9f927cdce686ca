"""Port correlator vs the JAX reference: replicas, windowed correlation,
coherent grouping and the packed-row contract, on the same numpy inputs.

Both sides are float32 on the CPU and differ only in the order of sums, so
windows agree within 1e-4 of each channel's window maximum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_code
from navlab_dpe_sdr_tpu.ops import dpe as jdpe
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu_torch.ops import correlate as tcorr
from navlab_dpe_sdr_tpu_torch.ops import dpe as tdpe
from navlab_dpe_sdr_tpu_torch.ops import dpe_real as treal
from navlab_dpe_sdr_tpu_torch.ops import score as tscore

torch.set_num_threads(2)

FS = 2.5e6
S = 50000
PERIOD = 2500
FPTS = 8 * (1 << 16)
PRNS = [9, 6, 17, 23]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_window_constants_match():
    assert (tdpe.CODE_WIN, tdpe.CARR_WIN) == (jdpe.CODE_WIN, jdpe.CARR_WIN)
    rng = np.random.default_rng(0)
    d, t = rng.standard_normal((50, 3)) * 80, rng.standard_normal(50) * 90
    v, td = rng.standard_normal((50, 3)) * 5, rng.standard_normal(50) * 2
    assert (tdpe.auto_windows(d, t, v, td, FS, FPTS)
            == jdpe.auto_windows(d, t, v, td, FS, FPTS))


def test_period_replicas_bit_identical():
    chips = np.stack([ca_code(p) for p in PRNS + [1, 31]]).astype(np.float32)
    rc = np.array([0.0, np.nextafter(np.float32(5.0), np.float32(0.0)),
                   5.0, 511.5, np.nextafter(np.float32(700.0), np.float32(800.0)),
                   1022.999], np.float32)
    ref = np.asarray(jreal._period_replicas(jnp.asarray(chips),
                                            jnp.asarray(rc), PERIOD))
    out = tcorr.period_replicas(_t(chips), _t(rc), PERIOD).numpy()
    np.testing.assert_array_equal(out, ref)
    # a leading block axis gathers the same rows
    out2 = tcorr.period_replicas(_t(chips), _t(np.stack([rc, rc[::-1]])),
                                 PERIOD).numpy()
    np.testing.assert_array_equal(out2[0], ref)


def _windowed_inputs(n_blocks=3, code_win=tdpe.CODE_WIN,
                     carr_win=tdpe.CARR_WIN, period=PERIOD):
    """test_windowed_matches_direct's inputs (4 PRNs, nav-bit boundary at
    0 / mid-period / exact period multiple / S), one noise seed per block,
    the windows centred for code_win / carr_win; 20 periods of `period`
    samples (a front end of `period` kHz), FPTS bins at the main path's
    period and 8 x the next power of two of the block at another."""
    fs, s = period * 1e3, 20 * period
    fpts = FPTS if period == PERIOD else 8 * (1 << s.bit_length())
    rcs = [400.25, 250.0, 12.7, 900.9]
    fis = [1500.0, -2200.0, 300.0, -40.0]
    idx_next = np.array([0, 13 * period + period // 2, 13 * period, s],
                        np.int32)
    fcs = [F_CA + fi * F_CA / F_L1 for fi in fis]
    sigs = [sum(synth_simple(p, fs, s, rc=rc, ri=0.3, fc=fc, fi=fi,
                             cn0_dbhz=50.0,
                             bits=np.where(np.arange(60) < 26, 1.0, -1.0),
                             seed=i + 10 * b)
                for i, (p, rc, fc, fi) in enumerate(zip(PRNS, rcs, fcs, fis))
                ).astype(np.complex64) for b in range(n_blocks)]
    c = len(PRNS)
    rc_mid = np.array([np.mod(rc + (fc - F_CA) * 0.01, L_CA)
                       for rc, fc in zip(rcs, fcs)], np.float32)
    return dict(
        raw_re=np.stack([s.real for s in sigs]).astype(np.float32),
        raw_im=np.stack([s.imag for s in sigs]).astype(np.float32),
        chips=np.stack([ca_code(p) for p in PRNS]).astype(np.float32),
        rc_mid=rc_mid, idx_next=idx_next, fi=np.asarray(fis, np.float32),
        ri=np.full(c, 0.3, np.float32),
        time_idc=(np.arange(s) / fs).astype(np.float32),
        pos_start=np.full(c, s // 2 - code_win // 2, np.int32),
        vel_start=np.full(c, fpts // 2 - carr_win // 2, np.int32),
        fpts=fpts)


@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("code_win,carr_win,n_blocks", [
    (tdpe.CODE_WIN, tdpe.CARR_WIN, 3),      # the defaults
    (12, 36, 3),                            # the main path's auto_windows
    (12, 36, 1)])                           # the per-block step's N
def test_windowed_correlate_matches_jax(complex_out, code_win, carr_win,
                                        n_blocks):
    """The dispatcher on CPU tensors (windowed_correlate_plain) against the
    JAX windowed_correlate, block by block."""
    a = _windowed_inputs(n_blocks, code_win, carr_win)
    n = a["raw_re"].shape[0]
    ref = [jreal.windowed_correlate(
        jnp.asarray(a["raw_re"][b]), jnp.asarray(a["raw_im"][b]),
        jnp.asarray(a["chips"]), None, jnp.asarray(a["rc_mid"]),
        jnp.asarray(a["idx_next"]), jnp.asarray(a["fi"]),
        jnp.asarray(a["ri"]), jnp.asarray(a["time_idc"]),
        jnp.asarray(a["pos_start"]), jnp.asarray(a["vel_start"]),
        FPTS, PERIOD, S // PERIOD, code_win=code_win, carr_win=carr_win,
        complex_out=complex_out)
        for b in range(n)]

    def per_block(x):
        return _t(np.tile(x, (n, 1)))

    out = treal.windowed_correlate(
        _t(a["raw_re"]), _t(a["raw_im"]), _t(a["chips"]),
        per_block(a["rc_mid"]), per_block(a["idx_next"]),
        per_block(a["fi"]), per_block(a["ri"]), _t(a["time_idc"]),
        per_block(a["pos_start"]), per_block(a["vel_start"]),
        FPTS, PERIOD, S // PERIOD, code_win, carr_win,
        complex_out=complex_out)
    assert type(out).__name__ == type(ref[0]).__name__
    # idx_next == 0 is a degenerate tie (flip and no-flip windows are
    # sign-equal up to the boundary arc), so the two forms may break it
    # differently: values and flips are compared on the other channels
    nondeg = a["idx_next"] > 0
    for name in out._fields:
        want = np.stack([np.asarray(getattr(r, name)) for r in ref])
        got = getattr(out, name).numpy()
        assert got.shape == want.shape, name
        if name == "flip_used":
            np.testing.assert_array_equal(got[:, nondeg], want[:, nondeg])
            continue
        scale = np.abs(want).max(axis=-1, keepdims=True)
        err = (np.abs(got - want) / scale)[:, nondeg]
        assert err.max() < 1e-4, (name, err.max())
    if complex_out:
        code_o = np.hypot(out.code_re.numpy(), out.code_im.numpy())
        code_r = np.stack([np.hypot(np.asarray(r.code_re),
                                    np.asarray(r.code_im)) for r in ref])
    else:
        code_o = out.code_mag.numpy()
        code_r = np.stack([np.asarray(r.code_mag) for r in ref])
    np.testing.assert_array_equal(np.argmax(code_o, -1),
                                  np.argmax(code_r, -1))


@pytest.mark.parametrize("complex_out", [False, True])
def test_plain_correlator_is_batch_invariant(complex_out):
    """On the CPU a block's windows and flip are the same bits whether it
    is correlated alone, in a share of the batch or in the whole batch, and
    a channel's over a subset of the channels (a mesh rank's block and
    channel shares). The samples are int16 I/Q views, as a dispatch passes
    them."""
    a = _windowed_inputs(n_blocks=6, code_win=12, carr_win=36)
    raw = np.stack([a["raw_re"], a["raw_im"]], -1)
    raw = _t(np.clip(np.round(raw), -32768, 32767).astype(np.int16))
    n, c = raw.shape[0], len(PRNS)
    per = {k: _t(np.tile(a[k], (n, 1))) for k in (
        "rc_mid", "idx_next", "fi", "ri", "pos_start", "vel_start")}
    # a code phase of its own for each block
    per["rc_mid"] += _t(np.linspace(0.0, 3.0, n, dtype=np.float32))[:, None]

    def corr(lo, hi, cs=slice(None)):
        p = {k: v[lo:hi, cs] for k, v in per.items()}
        return treal.windowed_correlate(
            raw[lo:hi, :, 0], raw[lo:hi, :, 1], _t(a["chips"])[cs],
            p["rc_mid"], p["idx_next"], p["fi"], p["ri"], _t(a["time_idc"]),
            p["pos_start"], p["vel_start"], FPTS, PERIOD, S // PERIOD, 12, 36,
            complex_out=complex_out)

    whole = corr(0, n)
    for parts in (2, 3, 6):
        shares = [corr(lo, hi) for lo, hi in tscore.even_rows(n, parts)]
        for name, f in zip(whole._fields, zip(*shares)):
            assert torch.equal(torch.cat(f), getattr(whole, name)), (parts,
                                                                      name)
    sub = corr(0, n, slice(1, 3))
    for name in whole._fields:
        assert torch.equal(getattr(sub, name), getattr(whole, name)[:, 1:3]), \
            name


def _cluster_correlate(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                       time_idc, pos_start, vel_start, fpts, period,
                       n_periods, code_win, carr_win, complex_out, ranks):
    """K5's function (float32 [N, S] samples, [N, C] parameters) computed
    as csrc/windowed_correlate.cu decomposes it over a cluster of `ranks`
    thread blocks per (block, channel), in float32 on the CPU: rank r folds
    its own taus [r P0 / R, (r + 1) P0 / R) over the periods and forms its
    lag, lag-0 and block-mean partials; those are added in rank order;
    rank r correlates its rows [r s1 / R, (r + 1) s1 / R) of the 256-way
    split into partials z, which are added in rank order; each bin of a
    36-bin pass, and each code window, is finished by the one rank that
    owns it. Returns what windowed_correlate returns."""
    n, s = raw_re.shape
    p0, p_n = period, n_periods
    s0_n = tcorr.S0_SPLIT
    s1_n = -(-s // s0_n)

    def split(r, m):
        return r * m // ranks

    def owned(m):             # rank r's items [split(r), split(r + 1))
        return [range(split(r, m), split(r + 1, m)) for r in range(ranks)]

    two_pi = tcorr._TWO_PI
    idx_next, pos_start, vel_start = (x.long() for x in (idx_next, pos_start,
                                                         vel_start))
    repl = tcorr.period_replicas(chips, rc_mid, p0)              # [N, C, P0]
    t0 = time_idc[0]
    dt_s = (time_idc[s - 1] - t0) * np.float32(1.0 / (s - 1))
    ang_a = (two_pi * fi)[..., None] * (time_idc[::p0][:p_n] - t0)
    ca, sa = torch.cos(ang_a), torch.sin(ang_a)                  # [N, C, P]
    ang_b = two_pi * (fi[..., None] * time_idc[:p0] + ri[..., None])
    cb, sb = torch.cos(ang_b), torch.sin(ang_b)                  # [N, C, P0]
    raw_p, raw_ip = raw_re.reshape(n, p_n, p0), raw_im.reshape(n, p_n, p0)
    p_b = torch.div(idx_next, p0, rounding_mode="floor")
    r_off = idx_next - p_b * p0
    tail = (torch.arange(p_n) > p_b[..., None]).float()
    p_bc = p_b.clamp(0, p_n - 1)
    valid = (p_b >= 0) & (p_b < p_n)
    ca_b = torch.gather(ca, 2, p_bc[..., None])
    sa_b = torch.gather(sa, 2, p_bc[..., None])
    m0 = pos_start - s // 2
    shifts = torch.cat([torch.remainder(m0[..., None] + torch.arange(
        code_win), p0), torch.zeros_like(m0)[..., None]], -1)  # lag 0 last
    # ---- code phase: rank r's taus, then the ranks' partials in rank order
    lag = mean_re = mean_im = 0.0
    for taus in owned(p0):
        tau = torch.tensor(list(taus), dtype=torch.long)
        rp, ip = raw_p[..., tau], raw_ip[..., tau]               # [N, P, t]
        w = torch.stack([ca, sa, ca * tail, sa * tail], 2)       # [N,C,4,P]
        fr = torch.einsum("nckp,npt->nckt", w, rp)
        fq = torch.einsum("nckp,npt->nckt", w, ip)
        rs_re, rs_im = fr[:, :, 0] + fq[:, :, 1], fq[:, :, 0] - fr[:, :, 1]
        ts_re, ts_im = fr[:, :, 2] + fq[:, :, 3], fq[:, :, 2] - fr[:, :, 3]
        bidx = torch.arange(n)[:, None]
        b_re, b_im = rp[bidx, p_bc], ip[bidx, p_bc]              # [N, C, t]
        gate = valid[..., None] & (tau >= r_off[..., None])
        ts_re = torch.where(gate, ts_re + (ca_b * b_re + sa_b * b_im), ts_re)
        ts_im = torch.where(gate, ts_im + (ca_b * b_im - sa_b * b_re), ts_im)
        c_b, s_b = cb[..., tau], sb[..., tau]
        folds = torch.stack([rs_re * c_b + rs_im * s_b,
                             rs_im * c_b - rs_re * s_b,
                             ts_re * c_b + ts_im * s_b,
                             ts_im * c_b - ts_re * s_b], 2)      # [N,C,4,t]
        rows = torch.gather(repl[:, :, None, :].expand(-1, -1, code_win + 1,
                                                       -1), 3,
                            torch.remainder(tau - shifts[..., None], p0))
        lag = lag + torch.einsum("ncwt,nckt->ncwk", rows, folds)
        mean_re = mean_re + rp.sum((1, 2))
        mean_im = mean_im + ip.sum((1, 2))
    mean_re, mean_im = mean_re * np.float32(1.0 / s), mean_im * np.float32(
        1.0 / s)
    c0nf_re, c0nf_im = lag[..., code_win, 0], lag[..., code_win, 1]
    c0fl_re = c0nf_re - 2.0 * lag[..., code_win, 2]
    c0fl_im = c0nf_im - 2.0 * lag[..., code_win, 3]
    use_flip = (c0fl_re * c0fl_re + c0fl_im * c0fl_im) > (
        c0nf_re * c0nf_re + c0nf_im * c0nf_im)
    # the code windows, rank r's w = r, r + R, ...: the boundary arc, the flip
    mine = [range(r, code_win, ranks) for r in range(ranks)]
    assert sorted(w for ws in mine for w in ws) == list(range(code_win))
    sliver = tcorr.SLIVER_LIMIT
    sl_start = (idx_next - sliver // 2).clamp(0, s - sliver)
    pos = sl_start[..., None] + torch.arange(sliver)             # [N, C, SL]
    sl_re = torch.gather(raw_re, 1, pos.reshape(n, -1)).reshape(pos.shape)
    sl_im = torch.gather(raw_im, 1, pos.reshape(n, -1)).reshape(pos.shape)
    ang = two_pi * (fi[..., None] * (t0 + pos.float() * dt_s) + ri[..., None])
    wc, ws = torch.cos(ang), torch.sin(ang)
    wiped_re, wiped_im = sl_re * wc + sl_im * ws, sl_im * wc - sl_re * ws
    m_w = m0[..., None] + torch.arange(code_win)                 # [N, C, W]
    delta = ((pos[:, :, None] >= (idx_next[..., None] + m_w)[..., None])
             .float() - (pos >= idx_next[..., None])[:, :, None].float())
    r_arc = torch.gather(repl[:, :, None].expand(-1, -1, code_win, -1), 3,
                         torch.remainder(pos[:, :, None] - m_w[..., None], p0))
    ct_re = lag[..., :code_win, 2] + (delta * wiped_re[:, :, None]
                                      * r_arc).sum(-1)
    ct_im = lag[..., :code_win, 3] + (delta * wiped_im[:, :, None]
                                      * r_arc).sum(-1)
    flip = use_flip[..., None]
    w_re = torch.where(flip, lag[..., :code_win, 0] - 2.0 * ct_re,
                       lag[..., :code_win, 0])
    w_im = torch.where(flip, lag[..., :code_win, 1] - 2.0 * ct_im,
                       lag[..., :code_win, 1])
    # ---- carrier phase: rank r's rows; z over the ranks in rank order
    sign = torch.where(flip & (torch.arange(s) >= idx_next[..., None]),
                       -1.0, 1.0)
    r_s = repl.repeat(1, 1, p_n) * sign                          # [N, C, S]
    pad = (0, s1_n * s0_n - s)
    y_re = torch.nn.functional.pad((raw_re[:, None] - mean_re[:, None, None])
                                   * r_s, pad).reshape(n, -1, s1_n, s0_n)
    y_im = torch.nn.functional.pad((raw_im[:, None] - mean_im[:, None, None])
                                   * r_s, pad).reshape(n, -1, s1_n, s0_n)
    a_cos, a_sin, b_cos, b_sin = tcorr._dft_twiddles_mixed(
        vel_start, fi, ri, dt_s, fpts, s1_n, s0_n, carr_win, t0=t0)
    z_re = z_im = 0.0
    for rows in owned(s1_n):
        sl = slice(rows.start, rows.stop)
        z_re = z_re + (a_cos[..., sl] @ y_re[:, :, sl]
                       + a_sin[..., sl] @ y_im[:, :, sl])
        z_im = z_im + (a_cos[..., sl] @ y_im[:, :, sl]
                       - a_sin[..., sl] @ y_re[:, :, sl])
    # each bin of a pass is finished by one rank: the s0 twiddles, the sum
    bins = []
    for w0 in range(0, carr_win, 36):
        wn = min(36, carr_win - w0)
        bins += [w0 + b for r in owned(wn) for b in r]
    assert bins == list(range(carr_win))
    x_re = (z_re * b_cos + z_im * b_sin).sum(-1)
    x_im = (z_im * b_cos - z_re * b_sin).sum(-1)
    if complex_out:
        return tcorr.RealBlockOutC(w_re, w_im, x_re, x_im, use_flip)
    return tcorr.RealBlockOut(torch.sqrt(w_re * w_re + w_im * w_im),
                              torch.sqrt(x_re * x_re + x_im * x_im), use_flip)


_JAX_AT = {}


def _jax_windowed(a, period, code_win, carr_win, complex_out):
    """The JAX windowed_correlate of each block of `a`, stacked (kept per
    shape: the cluster cases share it)."""
    key = (period, code_win, carr_win, complex_out)
    if key not in _JAX_AT:
        s = 20 * period
        ref = [jreal.windowed_correlate(
            jnp.asarray(a["raw_re"][b]), jnp.asarray(a["raw_im"][b]),
            jnp.asarray(a["chips"]), None, jnp.asarray(a["rc_mid"]),
            jnp.asarray(a["idx_next"]), jnp.asarray(a["fi"]),
            jnp.asarray(a["ri"]), jnp.asarray(a["time_idc"]),
            jnp.asarray(a["pos_start"]), jnp.asarray(a["vel_start"]),
            a["fpts"], period, s // period, code_win=code_win,
            carr_win=carr_win, complex_out=complex_out)
            for b in range(a["raw_re"].shape[0])]
        _JAX_AT[key] = {name: np.stack([np.asarray(getattr(r, name))
                                        for r in ref])
                        for name in ref[0]._fields}
    return _JAX_AT[key]


@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("ranks", [1, 4, 8, 16])
@pytest.mark.parametrize("period", [PERIOD, 1023])
def test_cluster_decomposition_matches_plain_and_jax(period, ranks,
                                                     complex_out):
    """The K5 kernel's split over a cluster of R thread blocks, rehearsed
    on the CPU (`_cluster_correlate`: per-rank tau folds, rows and bins,
    partials added in rank order) at the main path's period and an odd one
    (1023: unequal tau ranges), against windowed_correlate_plain (windows
    within 1e-5 of each channel's window maximum, flips and code argmaxes
    equal, as the kernel is held on the card) and against the JAX
    windowed_correlate (test_windowed_correlate_matches_jax's tolerance).
    A nav-bit boundary at sample 0 is a degenerate tie and is left out.
    This checks the algebra of the split (R changes the order of the lag,
    mean and z partial sums), not the kernel: only the `cuda` tests of
    tests/test_torch_kernels.py reach that."""
    code_win, carr_win = 12, 36
    a = _windowed_inputs(2, code_win, carr_win, period=period)
    n, s = a["raw_re"].shape
    args = [_t(a["raw_re"]), _t(a["raw_im"]), _t(a["chips"])] + [
        _t(np.tile(a[k], (n, 1))) for k in ("rc_mid", "idx_next", "fi", "ri")
    ] + [_t(a["time_idc"])] + [_t(np.tile(a[k], (n, 1)))
                               for k in ("pos_start", "vel_start")]
    shape = (a["fpts"], period, s // period, code_win, carr_win, complex_out)
    got = _cluster_correlate(*args, *shape, ranks)
    plain = tcorr.windowed_correlate_plain(*args, *shape)
    ref = _jax_windowed(a, period, code_win, carr_win, complex_out)
    keep = a["idx_next"] > 0

    def code_argmax(o):
        mag = o["code_mag"] if "code_mag" in o else np.hypot(o["code_re"],
                                                             o["code_im"])
        return np.argmax(mag, -1)[:, keep]

    g = {k: getattr(got, k).numpy() for k in got._fields}
    for want, tol in (({k: getattr(plain, k).numpy() for k in plain._fields},
                       1e-5), (ref, 1e-4)):
        for name in got._fields:
            assert g[name].shape == want[name].shape, name
            if name == "flip_used":
                np.testing.assert_array_equal(g[name][:, keep],
                                              want[name][:, keep])
                continue
            scale = np.abs(want[name]).max(axis=-1, keepdims=True)
            err = (np.abs(g[name] - want[name]) / scale)[:, keep]
            assert err.max() < tol, (name, tol, err.max())
        np.testing.assert_array_equal(code_argmax(g), code_argmax(want))


@pytest.mark.parametrize("group_k", [2, 5])
def test_coherent_sum_matches_jax(group_k):
    import jax

    rng = np.random.default_rng(group_k)
    g, c, wc, wv = 3, 5, 8, 24
    f = {k: rng.standard_normal((g, group_k, c, w)).astype(np.float32)
         for k, w in (("code_re", wc), ("code_im", wc),
                      ("carr_re", wv), ("carr_im", wv))}
    # a common signal with per-block nav-bit signs, so alignment matters
    sign = np.where(rng.random((g, group_k, c, 1)) < 0.5, -1.0, 1.0)
    for k in f:
        f[k] = (f[k] + 6.0 * sign).astype(np.float32)
    flips = rng.random((g, group_k, c)) < 0.5
    ref = jax.vmap(jreal._coherent_sum)(jreal.RealBlockOutC(
        *(jnp.asarray(f[k]) for k in ("code_re", "code_im", "carr_re",
                                      "carr_im")), jnp.asarray(flips)))
    out = treal.coherent_sum(treal.RealBlockOutC(
        *(_t(f[k]) for k in ("code_re", "code_im", "carr_re", "carr_im")),
        _t(flips)))
    np.testing.assert_allclose(out.code_mag.numpy(),
                               np.asarray(ref.code_mag)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(out.carr_mag.numpy(),
                               np.asarray(ref.carr_mag)[:, 0], rtol=1e-6)
    np.testing.assert_array_equal(out.flip_used.numpy(),
                                  np.asarray(ref.flip_used)[:, -1])


def test_packed_rows_match_jax_and_keep_indices_above_2e24():
    rng = np.random.default_rng(3)
    n, c = 4, 5
    pa = np.array([0, 7, 2 ** 24 + 1, 31_640_624], np.int32)
    va = np.array([3, 2 ** 24 + 3, 5, 1], np.int32)
    pb, vb = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    flips = rng.random((n, c)) < 0.5
    wm = rng.standard_normal((n, 8)).astype(np.float32)
    mags = (rng.random((n, c, 8)).astype(np.float32),
            rng.random((n, c, 24)).astype(np.float32))
    ref = np.asarray(jreal._pack_rows(
        jreal.RealBlockOut(jnp.asarray(mags[0]), jnp.asarray(mags[1]),
                           jnp.asarray(flips)),
        jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(va), jnp.asarray(vb),
        True, wmean=jnp.asarray(wm)))
    rows = treal.pack_rows(
        treal.RealBlockOut(_t(mags[0]), _t(mags[1]), _t(flips)),
        _t(pa), _t(pb), _t(va), _t(vb), True, wmean=_t(wm)).numpy()
    np.testing.assert_array_equal(rows.view(np.int32), ref.view(np.int32))
    pas, vas = treal.unpack_row_indices(rows)
    np.testing.assert_array_equal(pas, pa)
    np.testing.assert_array_equal(vas, va)


def test_pack_params_roundtrip():
    rng = np.random.default_rng(5)
    fpk = rng.standard_normal((3, treal.FPK_ROWS, 4))
    ipk = rng.integers(0, 2 ** 20, (3, treal.IPK_ROWS, 4)).astype(np.int32)
    pk = treal.pack_params(fpk, ipk, 1234)
    np.testing.assert_array_equal(pk, jreal.pack_params(fpk, ipk, 1234))
    f, i = treal.unpack_params(_t(pk))
    np.testing.assert_array_equal(f.numpy(), fpk.astype(np.float32))
    np.testing.assert_array_equal(i.numpy(), ipk)
    assert int(pk[0, treal.START_ROW, 0]) == 1234
