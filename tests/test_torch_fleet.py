"""The port's ReceiverFleet (models/fleet.py) against the JAX package's, on
the CPU, at tests/test_fleet.py's sizes.

Two receivers over the same 0.8 s capture, the second started 7 ms later:
acquisition, parallel tracking, seeded ephemerides, alignment. The offsets
must be equal; the tracking logs hold the free-running limits of
tests/test_torch_scalar.py (the compiled JAX scan decides ~1 sample per
window differently: cp and lock equal, rc within 1e-3 chips, fi within
1 Hz, |prompt| within 2 % of peak), and the nav solutions the limits that
rc difference allows (position within 5 m, receive time within 20 ns).
A parallel run of the port's fleet equals the same run with parallel=False
to the bit (logs, offsets, DPE fixes), and run_dpe trims to whole
dispatches as the JAX fleet does. The live two-radio flow contract of
tests/test_fleet.py:50 runs on the port.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models import fleet as jfleet
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu_torch.models import fleet as tfleet
from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_scalar import _check_logs  # noqa: E402

torch.set_num_threads(2)

FS = 2.5e6
SHIFT = int(0.007 * FS)


@pytest.fixture(scope="module")
def capture():
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 40  # 0.8 s
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def _fleet(pkg, capture, parallel=True):
    """acquire -> track(400) -> seeded ephemerides -> align, as
    tests/test_fleet.py; (fleet, offsets)."""
    samples, hand, arr = capture
    rfs = [SampleFile(samples=samples.copy(), fs=FS),
           SampleFile(samples=samples[SHIFT:].copy(), fs=FS)]
    kw = dict(device="cpu") if pkg is tfleet else {}
    fleet = pkg.ReceiverFleet(rfs, hand.prn_list, **kw)
    fleet.acquire()
    fleet.track(400, parallel=parallel)
    for rx, cp_shift in zip(fleet.receivers, (0.0, -7.0)):
        ephs = {}
        for e in arr.ephs:
            e2 = copy.deepcopy(e)
            e2.cp_timestamp += cp_shift
            ephs[e2.prn] = e2
        rx.set_ephemerides(ephs)
    return fleet, fleet.align()


@pytest.fixture(scope="module")
def fleets(capture):
    return {"jax": _fleet(jfleet, capture),
            "port": _fleet(tfleet, capture),
            "port sequential": _fleet(tfleet, capture, parallel=False)}


def test_fleet_tracks_and_aligns_as_jax(fleets):
    (jf, joff), (tf, toff) = fleets["jax"], fleets["port"]
    np.testing.assert_array_equal(toff, joff)
    assert abs(int(toff[0]) - 7) <= 1 and toff[1] <= 1
    for jrx, trx in zip(jf.receivers, tf.receivers):
        assert trx.mcount == jrx.mcount and trx._m_samp == jrx._m_samp
        _check_logs(jrx, trx)
    for js, ts in zip(jf.nav_solutions(), tf.nav_solutions()):
        assert abs(ts[0] - js[0]) < 2e-8 and abs(ts[1] - js[1]) < 2e-8
        assert np.linalg.norm(np.ravel(ts[2])[:3]
                              - np.ravel(js[2])[:3]) < 5.0
    t_after = [s[0] for s in tf.nav_solutions()]
    assert abs(t_after[0] - t_after[1]) < 1.5e-3


def test_parallel_fleet_equals_sequential_bitwise(fleets):
    (pf, poff), (sf, soff) = fleets["port"], fleets["port sequential"]
    np.testing.assert_array_equal(poff, soff)
    for a, b in zip(pf.receivers, sf.receivers):
        assert a._m_samp == b._m_samp
        for prn in a.prn_list:
            for k in ("rc", "fi", "iP", "qP", "cp", "lock"):
                np.testing.assert_array_equal(a.channels[prn].col(k),
                                              b.channels[prn].col(k))
            np.testing.assert_array_equal(a.channels[prn].cp_sign,
                                          b.channels[prn].cp_sign)


def test_run_dpe_trims_and_parallel_equals_sequential(fleets, tmp_path):
    """Batched fleet DPE: 10 blocks at lookahead 4 run as two whole
    dispatches in both packages, with a checkpoint per dispatch; the port's
    parallel and sequential runs give the same fixes to the bit."""
    grid = uniform_grid(n=5, pos_spacing=15.0, vel_spacing=1.0)
    runs = {}
    for name, parallel in (("jax", True), ("port", True),
                           ("port sequential", False)):
        fleet = fleets[name][0]
        kw = {} if name == "jax" else dict(config=DPEConfig())
        ck = tmp_path / name.replace(" ", "_")
        ck.mkdir()
        runs[name] = fleet.run_dpe(10, grid=grid, lookahead=4,
                                   parallel=parallel, checkpoint_every=4,
                                   checkpoint_dir=str(ck), **kw)
        for d, label in zip(runs[name], fleet.labels):
            assert len(d.fixes) == 8 and d.mc == 8
            assert np.load(ck / f"{label}_X.npy").shape == (8, 8)
    for a, b in zip(runs["port"], runs["port sequential"]):
        for fa, fb in zip(a.fixes, b.fixes):
            assert np.array_equal(fa.x_ecef, fb.x_ecef)
            assert (fa.pos_score, fa.vel_score) == (fb.pos_score,
                                                    fb.vel_score)
        np.testing.assert_array_equal(np.stack(a.flip_log),
                                      np.stack(b.flip_log))


def test_live_fleet_two_radios_shared_clock():
    """The port's fleet over two wall-clock-paced SimulatedRadios on one
    MultiSource clock (the JAX test_live_fleet_two_radios_shared_clock):
    alignment, fix agreement within grid noise, complete delivery
    accounting; no wall-clock budget (CI hosts contend)."""
    from navlab_dpe_sdr_tpu_torch.io.frontend import (MultiSource,
                                                      RadioSyncConfig,
                                                      SimulatedRadio)
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario as mk
    from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid

    sim, hand, arr = mk(nav_data=True)
    n = 50000 * 95  # 1.9 s
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)

    srcs = [
        SimulatedRadio(samples.copy(), fs=FS, block_samples=2500),
        SimulatedRadio(samples.copy(), fs=FS, block_samples=2500,
                       start_byte=SHIFT * 4),
    ]
    multi = MultiSource(srcs, RadioSyncConfig(setup_time_s=0.05))
    fleet = tfleet.ReceiverFleet.from_live(multi, hand.prn_list, fs=FS,
                                           max_seconds=2.0, timeout_s=60.0,
                                           device="cpu")
    try:
        fleet.acquire()
        fleet.track(1400, parallel=True)
        fleet.mark_phase("track")
        for rx, cp_shift in zip(fleet.receivers, (-1000.0, -1007.0)):
            ephs = {}
            for e in arr.ephs:
                e2 = copy.deepcopy(e)
                e2.cp_timestamp += cp_shift
                ephs[e2.prn] = e2
            rx.set_ephemerides(ephs)

        offsets = fleet.align()
        assert abs(int(offsets[0]) - 7) <= 1, offsets
        assert offsets[1] <= 1

        dpes = fleet.run_dpe(5, grid=spread_grid(), parallel=True)
        fleet.mark_phase("dpe")
        meds = [np.median(np.stack([f.x_ecef[:3] for f in d.fixes]), 0)
                for d in dpes]
        spread = float(np.linalg.norm(meds[1] - meds[0]))
        assert spread < 25.0, spread                  # grid-noise class
        for d in dpes:
            assert d.device == torch.device("cpu")
            err = np.linalg.norm(
                np.asarray(d.fixes[-1].x_ecef[:3]) - hand.x_ecef[:3])
            assert err < 40.0, err

        stats = fleet.live_stats()
        assert all(s["delivered_s"] > 0.5 for s in stats), stats
        assert all(s["lag_max_s"] >= 0.0 for s in stats)
        assert all(set(s["phases"]) == {"track", "dpe"} for s in stats)
    finally:
        multi.close()


def test_fleet_defaults_to_cuda_and_never_to_cpu(capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    samples, hand, _ = capture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.ReceiverFleet([SampleFile(samples=samples, fs=FS)],
                             hand.prn_list)


def test_shared_counters_survive_threads():
    """A fleet's receivers launch from threads of their own, and every
    launch adds one to the shared launch counter (a read-modify-write, kept
    under a lock). 16 threads on a shortened switch interval; a lost update
    would show in the count."""
    import threading

    from navlab_dpe_sdr_tpu_torch.ops import _build

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launch_counts()
        n_threads, n = 16, 2000

        def work():
            for _ in range(n):
                _build.count_launch("track_chunk")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert _build.launch_counts()["track_chunk"] == n_threads * n
    finally:
        sys.setswitchinterval(old)
        _build.reset_launch_counts()
