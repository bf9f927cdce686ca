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
                     carr_win=tdpe.CARR_WIN):
    """test_windowed_matches_direct's inputs (4 PRNs, nav-bit boundary at
    0 / mid-period / exact period multiple / S), one noise seed per block,
    the windows centred for code_win / carr_win."""
    rcs = [400.25, 250.0, 12.7, 900.9]
    fis = [1500.0, -2200.0, 300.0, -40.0]
    idx_next = np.array([0, 13 * PERIOD + PERIOD // 2, 13 * PERIOD, S],
                        np.int32)
    fcs = [F_CA + fi * F_CA / F_L1 for fi in fis]
    sigs = [sum(synth_simple(p, FS, S, rc=rc, ri=0.3, fc=fc, fi=fi,
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
        time_idc=(np.arange(S) / FS).astype(np.float32),
        pos_start=np.full(c, S // 2 - code_win // 2, np.int32),
        vel_start=np.full(c, FPTS // 2 - carr_win // 2, np.int32))


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
