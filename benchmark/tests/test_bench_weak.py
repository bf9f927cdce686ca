"""The weak-signal cold start (`weak27.coldstart`) on the CPU: its plain
references against the port on seeded captures, the cell through whole
runs at a tiny size, runs whose timed path is broken underneath (`correct`
must come out false), its controls, and its readers on a checkout without
the program's new spans.

The tiny copy cuts the weak configuration to what the CPU runs in
seconds: a 0.6 s capture at 40 dB-Hz (a 40 ms deep search finds every
satellite there), two 160 ms chunks of 8 ms updates, a fix of 4 blocks,
the ephemerides known (the capture holds no navigation message)."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import capture, check, check_weak
from benchmark.harness import main as hm
from benchmark.harness.check import within
from benchmark.harness.trace import LayerContext
from benchmark.reference import acquisition as ref_acq
from benchmark.reference import coherent_tracker as coh
from benchmark.reference import tracker as ref_trk

NAME = "weak27.coldstart"
SEED = 2**31 + 977
FS = 2.5e6
FCAID = 1.023e6 / 1575.42e6


@pytest.fixture
def weak(tiny, cell, known_ephemerides):
    """The tiny copy's weak cell, cut as the module's docstring says."""
    root, _ = tiny
    conf = root / "benchmark/configs/l1ca8_weak27.json"
    d = json.loads(conf.read_text())
    d["scenario"]["cn0_dbhz"] = 40.0
    d["acquisition"]["deep_ms"] = 40
    d["dpe"]["blocks_per_fix"] = 4
    conf.write_text(json.dumps(d))
    wl = root / "benchmark/workloads" / f"{NAME}.json"
    d = json.loads(wl.read_text())
    d.update(first_ms=320, step_ms=160, most_ms=320, chunk_ms=160,
             warmup_starts=0, judged_starts=1)
    wl.write_text(json.dumps(d))
    return cell(NAME)


@pytest.mark.parametrize("trace", [0, 1])
def test_weak_cell_runs_and_is_correct(weak, trace):
    r = hm.run_cell(weak, SEED, 0.3, bool(trace), "cpu")
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:
        # no device records on the CPU: the host spans' metrics read
        assert set(r["metrics"]) == {"deep_search_ms_per_start.ttff",
                                     "integrated_fix_ms_per_start.ttff"}
    else:
        assert set(r["metrics"]) == {"ttff_s", "setup_s"}


def _doppler_bin_moved(monkeypatch):
    """The deep search's magnitudes moved one Doppler bin up where they
    are produced."""
    from navlab_dpe_sdr_tpu_torch.ops import acquisition
    orig = acquisition._deep_coarse

    def moved(*a, **kw):
        return torch.roll(orig(*a, **kw), 1, dims=1)
    monkeypatch.setattr(acquisition, "_deep_coarse", moved)


def _window_sign_flipped(monkeypatch):
    """Each tracking chunk's first coherent window handed to the tracker
    with its samples' sign flipped."""
    from navlab_dpe_sdr_tpu_torch.ops import tracking
    orig = tracking.track_chunk_packed

    def flipped(state, raw, *a, **kw):
        raw = raw.clone()
        raw[0] = -raw[0]
        return orig(state, raw, *a, **kw)
    monkeypatch.setattr(tracking, "track_chunk_packed", flipped)


def _block_left_out(monkeypatch):
    """The block-summed scorer sums the fix's blocks but the last."""
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real
    orig = dpe_real.score_argmax

    def short(win, los, center, coef, r0, *a, **kw):
        if kw.get("block_sum") and win.shape[0] > 1:
            win, los, center, coef = win[:-1], los[:-1], center[:-1], \
                coef[:-1]
            r0 = None if r0 is None else r0[:-1]
        return orig(win, los, center, coef, r0, *a, **kw)
    monkeypatch.setattr(dpe_real, "score_argmax", short)


FAULTS = {"doppler_bin_moved": _doppler_bin_moved,
          "window_sign_flipped": _window_sign_flipped,
          "block_left_out": _block_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_weak_path_is_not_correct(weak, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = hm.run_cell(weak, SEED, 0.2, False, "cpu")
    assert not r["correct"], r["check"]


def test_each_weak_control_fails_a_number(weak):
    """The reference in the program's place a step down: every control
    fails a number (on the CPU TF32 does not exist; the card's run checks
    it)."""
    r = hm.run_cell(weak, SEED, 0.2, False, "cpu", control=True)
    assert r["correct"], r["check"]
    for var, c in r["control"].items():
        if var == "tf32":
            continue
        failed = {k for k, v in c.items() if v["value"] is not None
                  and not within(v)}
        assert failed, (var, c)


# -- the references against the port ------------------------------------------

CONFIG = {
    "name": "weak_ref_test",
    "scenario": {"n_sats": 8, "tow0": 345720.0, "lat": 40.112,
                 "lon": -88.228, "alt": 200.0, "cn0_dbhz": 34.0,
                 "fs": FS, "nav_data": True, "min_elev_deg": 15.0,
                 "sigma": 32.0, "block_s": 0.02, "seconds": 0.3},
    "grid": {"style": "spread"},
    "receiver": {"ekf_mode": "alpha", "ekf_alpha": 0.3},
}


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    old = capture.CACHE_DIR
    capture.CACHE_DIR = tmp_path_factory.mktemp("cache")
    yield capture.load(CONFIG, 4321, torch.device("cpu"))
    capture.CACHE_DIR = old


def _complex(cap, n):
    iq = cap.raw.reshape(-1, 2)[:n].numpy().astype(np.float64)
    return iq[:, 0] + 1j * iq[:, 1]


def test_deep_search_matches_the_plain_search(cap, monkeypatch):
    """2 PRNs, 80 ms, 9 Dopplers about the first one's: the port's search
    picks the reference's code phase, Doppler and fine bin (the power of
    every segment's spectrum about the coarse Doppler), and its z is
    within 1e-4 of the reference's: the port's float32 wipe-off and FFTs
    against float64 leave ~1e-6 in the magnitudes, and z, a ratio of
    differences of ~2500 of them, carries ~1e-5."""
    from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
    from navlab_dpe_sdr_tpu_torch.ops import acquisition

    prns = list(cap.hand.prn_list[:2])
    n_coh, deep_ms = 10, 80
    dop = np.round(cap.hand.fi[0] / 50.0) * 50.0 + np.arange(-4, 5) * 50.0
    x = _complex(cap, int(deep_ms * 1e-3 * FS))
    got = {}
    orig = acquisition._deep_coarse

    def keep(*a, **kw):
        got["mags"] = orig(*a, **kw)
        return got["mags"]
    monkeypatch.setattr(acquisition, "_deep_coarse", keep)
    res = acquisition.acquire_deep(x.astype(np.complex64), prns, FS,
                                   FCAID, n_coh_ms=n_coh,
                                   dopplers=dop, device="cpu")
    chips = ca_table(prns)
    ref = ref_acq.deep_search(x, chips, FS, dop, n_coh, "cpu").numpy()
    mags = got["mags"].numpy()
    bin_hz = ref_acq.fine_layout(FS, n_coh, dop)[2]
    for i, r in enumerate(res):
        cr, dr, zr = ref_acq.peak(ref[i], FS)
        cp, dp, zp = ref_acq.peak(mags[i], FS)
        assert (cp, dp) == (cr, dr)
        assert abs(zp - zr) / zr < 1e-4
        assert r.rc == 1023 - cp / FS * 1.023e6
        k, power = ref_acq.fine_power(x, chips[i], r.rc,
                                      1.023e6 + FCAID * dop[dp], dop[dp], FS,
                                      n_coh, dop, "cpu")
        assert int(round(r.fi / bin_hz)) == int(k[np.argmax(power)])


def test_coherent_chunk_matches_the_plain_tracker(cap):
    """One 200 ms chunk of 8 ms updates (25) from the truth: the port's
    tracker on the CPU and the reference give the same bits, state and
    log: the same float32 operations in the same order."""
    from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
    from navlab_dpe_sdr_tpu_torch.ops import tracking

    m, steps = 8, 25
    h = cap.hand
    table = torch.from_numpy(ca_table(h.prn_list).astype(np.float32))
    st = tracking.init_state(rc=h.rc, ri=h.ri, fc=h.fc, fi=h.fi,
                             device="cpu")
    raw = cap.raw.reshape(-1, 2)[:steps * m * 2500].reshape(
        steps, m * 2500, 2)
    fcaid = FCAID
    out, logf, logi = tracking.track_chunk_packed(
        st, raw, table, FS, fcaid, tracking.cadence_loops(m), coh_ms=m)
    ref_st = ref_trk.state_from_numpy(tracking.state_to_numpy(st), "cpu")
    r_out, r_logf, r_logi = coh.track_chunk(ref_st, raw, table, FS, fcaid,
                                            coh.cadence_loops(m), m)
    assert coh.cadence_loops(m) == tuple(tracking.cadence_loops(m))
    np.testing.assert_array_equal(logf.numpy(), r_logf.numpy())
    np.testing.assert_array_equal(logi.numpy(), r_logi.numpy())
    for k, v in tracking.state_to_numpy(out).items():
        np.testing.assert_array_equal(v, getattr(r_out, k).numpy())


def test_integrated_fix_matches_the_plain_fix(cap):
    """A 4-block noncoherent fix on the spread grid from the truth: the
    reference's summed best equals the port's within 1e-6 (float32 sums of
    8 channels and 4 blocks in another order), at the port's cells the
    reference's own score lies within 1e-6 of its best, and the fix and
    state agree within 1e-6 m (the same float64 algebra)."""
    from benchmark.harness import program
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    R = check.Reference(CONFIG, cap, torch.device("cpu"))
    rx = program.dpe_receiver(CONFIG, cap, "cpu")
    rec = {"sample0": 0, "n": 4, "pre": program.snapshot(rx),
           "eph": cap.eph, "start": cap.hand}
    got = {}
    orig = dpe_real.dpe_scan_integrate

    def keep(*a, **kw):
        out = orig(*a, **kw)
        got["head"] = out[0]
        return out
    rx_fix = None
    try:
        dpe_real.dpe_scan_integrate = keep
        rx_fix = rx.run_integrated(1, 4)[-1]
    finally:
        dpe_real.dpe_scan_integrate = orig
    pa, va = dpe_real.unpack_row_indices(got["head"].numpy()[None, :])
    ref = check_weak.reference_fix(R, rec, judged=(int(pa[0]), int(va[0])))
    for m, b in enumerate((rx_fix.pos_score, rx_fix.vel_score)):
        top = float(ref["best"][m])
        assert abs(b - top) / top < 1e-6
        assert (top - float(ref["at"][m])) / top < 1e-6
    assert np.abs(ref["fixes"][0][:4] - rx_fix.x_ecef[:4]).max() < 1e-6
    assert check.state_gap_m(program.snapshot(rx), ref["states"][0]) < 1e-6


# -- the readers --------------------------------------------------------------

READERS = ["deep_search_ms_per_start.ttff", "deep_search_roofline_pct.ttff",
           "coherent_tracker_ms_per_start.ttff",
           "integrated_fix_ms_per_start.ttff",
           "scorer_sum_roofline_pct.ttff"]


def _ctx(events=(), counts=None, work=None):
    return LayerContext(10.0, 1.0, list(events),
                        {"scalar.acquire": [(1.0, 2.0)]},
                        counts or {"starts": 2}, work or {})


@pytest.mark.parametrize("name", READERS)
def test_weak_readers_give_none_without_spans_or_records(cell, name,
                                                          monkeypatch):
    """A checkout without the program's new spans (an empty recorder), no
    device records: every reader gives None and raises nothing."""
    from navlab_dpe_sdr_tpu_torch import tracing
    tracing.clear()
    reader = cell(NAME).reader(name)
    assert reader.read(_ctx(counts={"starts": 2,
                                    "clock_offset_us": 0.0})) is None


def test_deep_search_roofline_reads_the_records_inside_its_spans(cell):
    """Device records that start inside the program's deep-search spans,
    placed by the traffic driver's clock offset, are the search's device
    time."""
    from benchmark.harness.roofline import least_s
    from navlab_dpe_sdr_tpu_torch import tracing

    tracing.clear()
    with tracing.recording():
        with tracing.span("scalar.acquire.deep"):
            pass
    (sp,) = tracing.spans("scalar.acquire.deep")
    off = 5e6
    a, b = sp.t0 * 1e6 + off, sp.t1 * 1e6 + off
    events = [("before", a - 50.0, a - 10.0), ("fft", a, a + 30.0),
              ("after", b + 1.0, b + 9.0)]
    ctx = LayerContext(10.0, 1.0, events, {"h": [(sp.t0, sp.t1)]},
                       {"starts": 1, "clock_offset_us": off},
                       {"deep": (1e9, 1e6)})
    got = cell(NAME).reader("deep_search_roofline_pct.ttff").read(ctx)
    tracing.clear()
    assert got == pytest.approx(100.0 * least_s(1e9, 1e6) / 30e-6)
