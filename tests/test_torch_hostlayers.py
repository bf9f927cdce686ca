"""The port's own host layers (constants, io/*, libgnss/*, models/ekf,
models/grid, runtime/{nativelib,flow}) against the JAX package's
modules of the same names.

They are copies of float64 numpy and plain host code, so the tolerance
is 0: the same seeded inputs go through both and the results must be
`np.array_equal`.
One parametrised case per copied module, then a handoff file written by
each package and read by the other, and the JAX package's scenario objects
carried into the port's classes by their plain fields.
"""

import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

REF = "navlab_dpe_sdr_tpu"
PORT = "navlab_dpe_sdr_tpu_torch"
FS = 2.5e6


def both(name):
    """(the JAX package's module, the port's copy)."""
    return (importlib.import_module(f"{REF}.{name}"),
            importlib.import_module(f"{PORT}.{name}"))


def same(a, b):
    """Bit-equal: arrays, scalars, and tuples/lists/dicts of them."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def scenarios(**kw):
    """make_scenario of both packages: ((sim, hand, arr), (sim, hand, arr))."""
    ref, port = both("io.scenario")
    return ref.make_scenario(**kw), port.make_scenario(**kw)


def eph_fields(arr, dtype=None):
    """{field: per-satellite values}; `dtype` float where a handoff file
    lies between (it carries IODE, IODC and the week number as floats)."""
    names = [f.name for f in dataclasses.fields(arr.ephs[0])]
    return {n: np.array([getattr(e, n) for e in arr.ephs], dtype)
            for n in names}


def hand_fields(h):
    return {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}


def case_constants():
    ref, port = both("constants")
    names = sorted(n for n in vars(ref) if n.isupper() or n == "OEDot")
    assert len(names) >= 10
    assert names == sorted(n for n in vars(port)
                           if n.isupper() or n == "OEDot")
    for n in names:
        same(getattr(ref, n), getattr(port, n))


def case_cacode():
    ref, port = both("libgnss.cacode")
    same(ref.ca_table(range(1, 33)), port.ca_table(range(1, 33)))
    same(ref.ca_bits(17), port.ca_bits(17))
    assert ref.first_chips_octal(5) == port.first_chips_octal(5)
    same(ref.sampled_code(9, FS, 2500, code_phase=311.25),
         port.sampled_code(9, FS, 2500, code_phase=311.25))


def case_ephemeris():
    """The records themselves (nominal constellation -> EphArray) and the
    subframe bit helpers."""
    (_, _, a), (_, _, b) = scenarios()
    same(eph_fields(a), eph_fields(b))
    for n in ("sqrt_A", "M_0", "t_oe", "tow_timestamp", "cp_timestamp"):
        same(getattr(a, n), getattr(b, n))
    ref, port = both("libgnss.ephemeris")
    assert ref.ALL_FIELDS == port.ALL_FIELDS
    same(ref.PARITY_MAT, port.PARITY_MAT)
    bits = np.random.default_rng(3).integers(0, 2, 30) * 2 - 1
    assert ref.check_word_parity(bits, 1, 0) == port.check_word_parity(
        bits, 1, 0)
    same(ref.word_data_bits(bits, 1), port.word_data_bits(bits, 1))


def case_satpos():
    (_, _, a), (_, _, b) = scenarios()
    ref, port = both("libgnss.satpos")
    t = 345720.0 + np.random.default_rng(4).random(len(a)) * 30.0
    same(ref.sat_clock_correction(a, t), port.sat_clock_correction(b, t))
    same(ref.sat_state(a, t, 1e-5, 1e-11), port.sat_state(b, t, 1e-5, 1e-11))
    same(ref.sat_state_at_transmit(a, t), port.sat_state_at_transmit(b, t))
    same(ref.sat_state(a.ephs[2], 345777.5), port.sat_state(b.ephs[2],
                                                            345777.5))
    same(ref.correct_week_crossover(t - 400000.0),
         port.correct_week_crossover(t - 400000.0))


def case_frames():
    ref, port = both("libgnss.frames")
    rng = np.random.default_rng(5)
    ecef = ref.lla_to_ecef(40.112, -88.228, 200.0)
    same(ecef, port.lla_to_ecef(40.112, -88.228, 200.0))
    pts = ecef[:, None] + rng.standard_normal((3, 6)) * 1e4
    pv = np.concatenate([pts[:, 0], [12.0], rng.standard_normal(3), [0.1]])
    pvs = rng.standard_normal((8, 6)) * 1e7
    tg = 345700.0 + rng.random(6)
    d = rng.standard_normal((3, 5)) * 50.0
    for fn, args in (("ecef_to_lla", (pts,)), ("ecef_to_lla", (ecef, False)),
                     ("ecef_to_eci", (pv, 345700.0, 345700.07)),
                     ("eci_to_ecef", (pv, 345700.0, 345700.07)),
                     ("ecef_to_eci_batch", (pvs, tg, 345700.5)),
                     ("ecef_to_enu_matrix", (ecef,)),
                     ("ecef_to_enu", (ecef, pts[:, 1])),
                     ("enu_to_ecef", (ecef, d)),
                     ("enu_to_elaz", (d,))):
        same(getattr(ref, fn)(*args), getattr(port, fn)(*args))


def case_iono():
    ref, port = both("libgnss.iono")
    alpha = [1.1e-8, 7.5e-9, -6.0e-8, -6.0e-8]
    beta = [9.0e4, 1.6e4, -1.3e5, -6.6e4]
    rng = np.random.default_rng(6)
    for el, az in zip(rng.random(5) * 1.4 + 0.1, rng.random(5) * 6.28):
        args = (alpha, beta, 40.1, -88.2, el, az, 345720.0)
        same(ref.klobuchar_delay(*args), port.klobuchar_delay(*args))
        same(ref.klobuchar_delay_m(*args), port.klobuchar_delay_m(*args))


def case_tropo():
    ref, port = both("libgnss.tropo")
    el = np.random.default_rng(7).random(9) * 1.5 + 0.05
    same(ref.tropo_delay_m(el), port.tropo_delay_m(el))


def case_naveng():
    """PVT on the seeded scenario's geometry: observables at the handoff
    epoch, the same through both."""
    (_, ha, a), (_, hb, b) = scenarios()
    ref, port = both("libgnss.naveng")
    same(ref.transmit_times(ha.cp, ha.rc, a),
         port.transmit_times(hb.cp, hb.rc, b))
    same(ref.satellite_positions(ha.cp, ha.rc, a, t_c=ha.rx_time),
         port.satellite_positions(hb.cp, hb.rc, b, t_c=hb.rx_time))
    kw = dict(rx_time0=ha.rx_time)
    sol_a = ref.calculate_nav_soln(ha.cp, ha.rc, ha.fi, a, **kw)
    sol_b = port.calculate_nav_soln(hb.cp, hb.rc, hb.fi, b, **kw)
    same(sol_a, sol_b)
    assert np.linalg.norm(sol_b[2][:3] - hb.x_ecef[:3]) < 5.0
    kw.update(ion_alpha=[1.1e-8, 7.5e-9, -6.0e-8, -6.0e-8],
              ion_beta=[9.0e4, 1.6e4, -1.3e5, -6.6e4], tropo=True)
    same(ref.calculate_nav_soln(ha.cp, ha.rc, ha.fi, a, **kw),
         port.calculate_nav_soln(hb.cp, hb.rc, hb.fi, b, **kw))
    same(ref.gdop(sol_a[3], sol_a[4]), port.gdop(sol_b[3], sol_b[4]))


def case_satcache():
    (_, ha, a), (_, hb, b) = scenarios()
    ref, port = both("libgnss.satcache")
    ca = ref.SatStateCache(a, ha.rx_time, horizon_s=6.0)
    cb = port.SatStateCache(b, hb.rx_time, horizon_s=6.0)
    rng = np.random.default_rng(8)
    for t0 in (0.3, 5.1, 14.7):           # the last one extends the horizon
        t = ha.rx_time + t0 + rng.random(len(a)) * 0.07
        same(ca.state_at(t), cb.state_at(t))
    same(ca.times, cb.times)
    same(ca.states, cb.states)


def case_ekf():
    ref, port = both("models.ekf")
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal(8) * 10.0
    zs = rng.standard_normal((12, 8)) * 5.0
    for mode in ("passthrough", "alpha", "full"):
        ea = ref.NavEKF(x0, T=0.02, mode=mode, alpha=0.3)
        eb = port.NavEKF(x0, T=0.02, mode=mode, alpha=0.3)
        for z in zs:
            same(ea.time_update(), eb.time_update())
            r = None if mode != "full" else np.diag(np.abs(z) + 1.0)
            same(ea.measurement_update(z, r), eb.measurement_update(z, r))
        same(ea.P, eb.P)
        same(ea.Q, eb.Q)
        if mode == "full":
            same(ea.rts_smooth(), eb.rts_smooth())


def case_grid():
    ref, port = both("models.grid")
    for make, kw in (("spread_grid", {}), ("spread_grid", dict(scale=0.5)),
                     ("uniform_grid", dict(n=5)),
                     ("uniform_grid", dict(n=4, pos_spacing=2.0)),
                     ("arthur_grid", dict(n=9)),
                     ("exponential_grid", dict(n=9)),
                     ("make_grid", dict(style="uniform", n=3))):
        ga, gb = getattr(ref, make)(**kw), getattr(port, make)(**kw)
        same(hand_fields(ga), hand_fields(gb))
        assert (ga.n_pos, ga.n_vel) == (gb.n_pos, gb.n_vel)
        assert port.check_grid_size(gb) is gb
    assert ref.MAX_GRID_POINTS == port.MAX_GRID_POINTS
    # over the cap: a grid of stride-0 views, no memory behind it
    n = port.MAX_GRID_POINTS // 2 + 1
    z3, z1 = np.broadcast_to(np.zeros(3), (n, 3)), np.broadcast_to(0.0, (n,))
    for mod in (ref, port):
        with pytest.raises(ValueError, match="cap is"):
            mod.check_grid_size(mod.Grid(z3, z1, z3, z1))


def case_lnav():
    (_, _, a), (_, _, b) = scenarios()
    ref, port = both("libgnss.lnav")
    for ea, eb in zip(a.ephs[:3], b.ephs[:3]):
        same(ref.encode_stream(ea, 413994.0, 10),
             port.encode_stream(eb, 413994.0, 10))
    same(ref.subframe_source_bits(a.ephs[0], 2, 414000.0),
         port.subframe_source_bits(b.ephs[0], 2, 414000.0))


def case_dataparser():
    """lnav encode -> dataparser decode, every decoded field equal."""
    (_, _, a), (_, _, b) = scenarios()
    lnav_ref, lnav_port = both("libgnss.lnav")
    ref, port = both("libgnss.dataparser")
    sa = np.kron(1 - 2 * lnav_ref.encode_stream(a.ephs[1], 413994.0, 15),
                 np.ones(20))
    sb = np.kron(1 - 2 * lnav_port.encode_stream(b.ephs[1], 413994.0, 15),
                 np.ones(20))
    same(ref.find_subframe_starts(sa[800:]),
         port.find_subframe_starts(sb[800:]))
    da, oka = ref.parse_ephemerides(sa[800:], cp_offset=3.0,
                                    prn=a.ephs[1].prn)
    db, okb = port.parse_ephemerides(sb[800:], cp_offset=3.0,
                                     prn=b.ephs[1].prn)
    assert oka == okb == 50 and da.complete and db.complete
    same(dataclasses.asdict(da), dataclasses.asdict(db))
    assert abs(db.sqrt_A - b.ephs[1].sqrt_A) < 1e-5


def case_scenario():
    (_, ha, a), (_, hb, b) = scenarios(n_sats=6, cn0_dbhz=45.0, seed=11)
    same(hand_fields(ha), hand_fields(hb))
    same(eph_fields(a), eph_fields(b))
    ref, port = both("io.scenario")
    ea, eb = ref.nominal_constellation(), port.nominal_constellation()
    assert len(ea) == len(eb) > 20
    for x, y in zip(ea, eb):
        same(dataclasses.asdict(x), dataclasses.asdict(y))


def case_synth():
    """A 0.1 s capture of the seeded scenario, sample for sample, with and
    without navigation data and from a later start sample."""
    ref, port = both("io.synth")
    for kw in (dict(nav_data=True), dict(nav_data=False, cn0_dbhz=40.0)):
        (sa, _, _), (sb, _, _) = scenarios(**kw)
        n = int(0.1 * FS)
        same(sa.generate(n), sb.generate(n))
        iq_a, tr_a = sa.generate(5000, start_sample=1_234_567,
                                 return_truth=True)
        iq_b, tr_b = sb.generate(5000, start_sample=1_234_567,
                                 return_truth=True)
        same(iq_a, iq_b)
        for ca, cb in zip(tr_a.channels, tr_b.channels):
            same(dataclasses.asdict(ca), dataclasses.asdict(cb))
    same(ref.white_noise_iq16(4096, seed=5), port.white_noise_iq16(4096,
                                                                   seed=5))
    same(ref.synth_simple(7, FS, 5000, rc=100.5),
         port.synth_simple(7, FS, 5000, rc=100.5))
    ref.release_workspace()
    port.release_workspace()


def case_rawfile(tmp_path):
    ref, port = both("io.rawfile")
    assert ref.DTYPE_IQ16 == port.DTYPE_IQ16
    rng = np.random.default_rng(12)
    iq = (rng.standard_normal(60000) + 1j * rng.standard_normal(60000)) * 90
    pa, pb = str(tmp_path / "a.dat"), str(tmp_path / "b.dat")
    ref.write_iq16(pa, iq)
    port.write_iq16(pb, iq)
    same(np.fromfile(pa, np.int16), np.fromfile(pb, np.int16))
    # each reads the other's file
    fa, fb = ref.SampleFile(pb, fs=FS), port.SampleFile(pa, fs=FS)
    assert fa.n_samples == fb.n_samples == 60000
    for f in (fa, fb):
        f.set_block(0.002, 0.004)
    for n in ("S", "N", "S_skip", "carr_fftpts", "fcaid"):
        assert getattr(fa, n) == getattr(fb, n), n
    for n in ("time_idc", "code_idc", "code_fftidc", "carr_fftidc"):
        same(getattr(fa, n), getattr(fb, n))
    same(fa.read_block(), fb.read_block())
    fa.skip_gap(), fb.skip_gap()
    same(fa.read_block_raw(), fb.read_block_raw())
    for f in (fa, fb):
        f.set_block(0.001)
        f.seek_bytes(4 * 12345)
    same(fa.read_chunk_raw(7), fb.read_chunk_raw(7))
    assert fa.bytes_read == fb.bytes_read == 4 * (12345 + 7 * 2500)
    mem = port.SampleFile(samples=np.fromfile(pa, port.DTYPE_IQ16), fs=FS)
    mem.seek(12345, whence=0)
    mem.set_block(0.001)
    fb.seek(12345, whence=0)
    same(mem.read_chunk_raw(3), fb.read_chunk_raw(3))


def case_handoff(tmp_path):
    """write_handoff / read_handoff of one package; the cross-reading is
    test_handoff_file_crosses_between_the_packages."""
    (_, ha, _), (_, hb, _) = scenarios()
    ref, port = both("io.handoff")
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    ref.write_handoff(pa, ha)
    port.write_handoff(pb, hb)
    assert open(pa).read() == open(pb).read()
    same(hand_fields(ref.read_handoff(pa)), hand_fields(port.read_handoff(pb)))


def _iq(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-2048, 2048, (n, 2)).astype(np.int16)


def case_frontend(tmp_path):
    """tests/test_frontend.py's contracts, in both packages side by side:
    the rotating recorder (file names from one fixed clock, contents), the
    simulated radio (content, EOF, loop, pacing, file-backed start byte),
    open_source's file / sim / tcp / soapy variants, the record pump,
    MultiSource lockstep delivery, and LiveSampleFile's chunk reads and
    phase marks."""
    import os
    import time

    ref, port = both("io.frontend")
    data = _iq(500 * 12)
    names = []
    for mod in (ref, port):
        d = tmp_path / f"rec_{mod.__name__.split('.')[0]}"
        rec = mod.RotatingRecorder(str(d), fs=1e6, usrp_index=3,
                                   rotate_s=0.002,
                                   clock=lambda: time.gmtime(86400))
        with rec:
            for k in range(12):
                rec.write(data[k * 500:(k + 1) * 500])
        names.append([os.path.basename(f) for f in rec.files])
        back = np.concatenate([np.fromfile(f, np.int16).reshape(-1, 2)
                               for f in rec.files])
        same(back, data)
    assert names[0] == names[1] and len(names[1]) == 3
    assert names[1][0] == "19700102_000000_usrp3_1000KHz.dat"

    data = _iq(4000)
    for kw in (dict(), dict(loop=True)):
        srcs = [m.SimulatedRadio(data, fs=1e6, block_samples=1500,
                                 realtime=False, **kw) for m in (ref, port)]
        for _ in range(4):
            same(*(s.next_block() for s in srcs))
    t0 = time.perf_counter()
    src = port.SimulatedRadio(data, fs=100e3, block_samples=1000)
    for _ in range(4):
        assert src.next_block() is not None
    assert time.perf_counter() - t0 >= 0.75 * 4 * 1000 / 100e3
    path = tmp_path / "cap.dat"
    data.tofile(path)
    same(*(m.SimulatedRadio(str(path), fs=1e6, block_samples=1000,
                            realtime=False, start_byte=4000).next_block()
           for m in (ref, port)))

    for m in (ref, port):
        with m.open_source(str(path), fs=1e6, block_samples=1000) as src:
            assert isinstance(src, m.FileSource)
            same(src.next_block(), data[:1000])
        with m.open_source(f"sim://{path}", fs=1e6,
                           block_samples=1000) as src:
            assert isinstance(src, m.SimulatedRadio)
            same(src.next_block(), data[:1000])
        net = importlib.import_module(
            m.__name__.replace("frontend", "netsource"))
        srv = net.FileReplayServer(str(path))
        with m.open_source(f"tcp://127.0.0.1:{srv.port}", fs=1e6,
                           block_samples=1000) as src:
            assert type(src).__module__.startswith(
                m.__name__.split(".")[0])
            same(np.asarray(src.next_block()), data[:1000])
        srv.join()
        with pytest.raises(RuntimeError, match="SoapySDR"):
            m.open_source("soapy://driver=rtlsdr", fs=1e6,
                          block_samples=1000)

    pumped = []
    for m in (ref, port):
        src = m.SimulatedRadio(_iq(20000, seed=3), fs=1e6, block_samples=2000,
                               realtime=False, loop=True)
        rec = m.RotatingRecorder(str(tmp_path / f"pump_{len(pumped)}"),
                                 fs=1e6, rotate_s=0.004)
        with src, rec:
            n = m.record(src, rec, seconds=0.016)
        pumped.append((n, len(rec.files), b"".join(
            open(f, "rb").read() for f in rec.files)))
    assert pumped[0] == pumped[1] and pumped[1][:2] == (8, 4)

    got = []
    for m in (ref, port):
        multi = m.MultiSource(
            [m.SimulatedRadio(data, fs=1e6, block_samples=1000,
                              realtime=False, start_byte=b)
             for b in (0, 400)], m.RadioSyncConfig(setup_time_s=0.0))
        with multi:
            got.append([multi.next_blocks() for _ in range(4)])
    assert got[0][-1] is None and got[1][-1] is None
    same(got[0][:3], got[1][:3])

    raw = importlib.import_module(f"{PORT}.io.rawfile")
    s16 = np.zeros(25000 * 8, raw.DTYPE_IQ16)
    s16["i"] = _iq(25000 * 8, seed=4)[:, 0]
    chunks, snaps = [], []
    for m in (ref, port):
        rf = m.LiveSampleFile(
            m.SimulatedRadio(s16.copy(), fs=2.5e6, block_samples=2500,
                             realtime=False),
            fs=2.5e6, max_seconds=0.2, timeout_s=10.0, miss_budget_s=0.005)
        try:
            chunks.append(rf.read_chunk_raw(10))
            rf.phase_mark("p1")
            assert rf.lag_misses == 0 and rf.lag_max_s == 0.0
            time.sleep(0.05)
            chunks.append(rf.read_block_raw())
            snaps.append(rf.phase_mark("p2"))
            assert set(rf.phases) == {"p1", "p2"}
        finally:
            rf.close()
    same(chunks[0], chunks[2])
    same(chunks[1], chunks[3])
    assert all(s["lag_misses"] >= 1 for s in snaps)
    assert issubclass(port.LiveSampleFile, raw.SampleFile)


def case_netsource(tmp_path):
    """The pure-Python TCP reader over each package's file replay server,
    and the paced server's rate (tests/test_runtime.py:223)."""
    import socket
    import time

    ref, port = both("io.netsource")
    data = _iq(3000, seed=6)
    path = tmp_path / "cap.dat"
    data.tofile(path)
    got = []
    for m in (ref, port):
        srv = m.FileReplayServer(str(path))
        with m.TcpSampleSource("127.0.0.1", srv.port, 1000,
                               timeout_s=5.0, start_byte=400) as src:
            got.append([src.next_block() for _ in range(3)])
        srv.join()
    assert got[0][-1] is None and got[1][-1] is None
    same(got[0][:2], got[1][:2])
    same(got[1][0], data[100:1100])

    fs = 500_000.0
    paced = tmp_path / "paced.bin"
    paced.write_bytes(b"\x11" * int(fs * 4 * 2))
    srv = port.PacedReplayServer(str(paced), fs=fs)
    n = 0
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", srv.port)) as c:
        c.settimeout(2.0)
        while time.perf_counter() - t0 < 0.4:
            n += len(c.recv(65536))
    rate = n / (time.perf_counter() - t0)
    assert 0.75 * fs * 4 < rate < 1.25 * fs * 4, rate


def case_runtime_nativelib(tmp_path):
    """tests/test_runtime.py's native cases in both packages: the sample
    stream (blocks, EOF, start byte, a TCP socket with a skipped
    preamble), the async logger (CSV and binary) and the port logger
    (complex interleave). The port's library is built from its own copied
    sources into its own build directory."""
    import socket
    import threading

    ref, port = both("runtime.nativelib")
    assert port.library_path().parent == importlib.import_module(
        f"{PORT}.ops._build").build_dir()
    s = 1000
    data = np.arange(10 * s * 2, dtype=np.int16)
    path = tmp_path / "cap.dat"
    data.tofile(path)
    for start in (0, 3 * s * 4):
        got = []
        for m in (ref, port):
            with m.SampleStream(str(path), block_samples=s, n_buffers=4,
                                start_byte=start) as st:
                got.append([st.next_block() for _ in range(11 - start // (
                    s * 4))])
        assert got[0][-1] is None and got[1][-1] is None
        same(got[0][:-1], got[1][:-1])
    same(got[1][0], data[3 * s * 2:4 * s * 2].reshape(s, 2))

    rows = np.random.default_rng(0).standard_normal((50, 6))
    texts = []
    for m in (ref, port):
        for binary in (False, True):
            p = tmp_path / f"log_{m.__name__.split('.')[0]}_{binary}"
            with m.AsyncLogger(str(p), n_cols=6, depth=8,
                               binary=binary) as lg:
                for r in rows:
                    lg.write(r)
            texts.append(p.read_bytes())
        p = tmp_path / f"port_{m.__name__.split('.')[0]}.csv"
        state = {"v": np.array([1 + 2j, 3 - 4j])}
        with m.PortLogger(str(p), lambda: state["v"]) as pl:
            pl.step()
            state["v"] = np.array([5 + 6j, 7 + 8j])
            pl.step()
        texts.append(p.read_bytes())
    assert texts[:3] == texts[3:]
    np.testing.assert_allclose(np.loadtxt(tmp_path / "log_navlab_dpe_sdr_"
                                          "tpu_torch_False", delimiter=","),
                               rows, rtol=1e-10)
    same(np.frombuffer(texts[4], np.float64).reshape(50, 6), rows)
    same(np.loadtxt(tmp_path / "port_navlab_dpe_sdr_tpu_torch.csv",
                    delimiter=","), np.array([[1., 2, 3, -4], [5, 6, 7, 8]]))

    blocks = (np.arange(4 * 250 * 2, dtype=np.int16).reshape(4, 250, 2))
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"\x55" * 24 + blocks.tobytes())
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with port.SampleStream(f"tcp://127.0.0.1:{srv.getsockname()[1]}",
                           block_samples=250, start_byte=24,
                           timeout_s=5.0) as st:
        for k in range(4):
            same(st.next_block(), blocks[k])
        assert st.next_block() is None
    t.join(timeout=2.0)
    assert not t.is_alive()
    srv.close()


RINEX_HEADER = (
    "     2.10           NAVIGATION DATA                         RINEX VERSION / TYPE\n"
    "    0.1118D-07  0.2235D-07 -0.5960D-07 -0.1192D-06          ION ALPHA           \n"
    "    0.1167D+06  0.1802D+06 -0.1311D+06 -0.4588D+06          ION BETA            \n"
    "    0.133226763247D-14 0.107469588780D-12   233472     1860 DELTA-UTC: A0,A1,T,W\n"
    "    18                                                      LEAP SECONDS        \n"
    "                                                            END OF HEADER       \n")


def write_rinex_nav(path, ephs, toe_shifts=(0.0,)):
    """A RINEX 2.10 navigation file: the header of
    tests/test_orbits_nav.py:102-114 and one record per ephemeris and shift
    of t_oc/t_oe (seconds), every value in a D19.12 field."""
    import datetime

    def d19(v):
        return f"{float(v):19.12E}".replace("E", "D")

    lines = [RINEX_HEADER]
    for shift in toe_shifts:
        for e in ephs:
            t = (datetime.datetime(1980, 1, 6) + datetime.timedelta(
                weeks=int(e.weeknumber), seconds=float(e.t_oc) + shift))
            sec = t.second + t.microsecond * 1e-6
            lines.append(
                f"{e.prn:2d} {t.year % 100:02d} {t.month:2d} {t.day:2d} "
                f"{t.hour:2d} {t.minute:2d}{sec:5.1f}"
                + "".join(map(d19, (e.a_f0, e.a_f1, e.a_f2))) + "\n")
            rows = ((e.IODE, e.C_rs, e.delta_n, e.M_0),
                    (e.C_uc, e.e, e.C_us, e.sqrt_A),
                    (e.t_oe + shift, e.C_ic, e.OMEGA_0, e.C_is),
                    (e.i_0, e.C_rc, e.omega, e.OMEGADOT),
                    (e.IDOT, 1.0, e.weeknumber, 0.0),
                    (e.accuracy, e.health, e.T_GD, e.IODC),
                    (e.t_oc + shift, 4.0, 0.0, 0.0))
            lines += ["   " + "".join(map(d19, r)) + "\n" for r in rows]
    pathlib.Path(path).write_text("".join(lines))


def case_rinex(tmp_path):
    """A RINEX 2.10 file written from the scenario's ephemerides (two
    issues per PRN, 2 h apart): header, records, closest-toe selection and
    the per-PRN load of both packages equal, and equal to the scenario's
    ephemerides to the D19.12 fields' 13 digits."""
    (_, _, arr), _ = scenarios()
    path = tmp_path / "scen.18n"
    write_rinex_nav(path, arr.ephs, toe_shifts=(0.0, 7200.0))
    ref, port = both("libgnss.rinex")
    ha, hb = ref.read_header(str(path)), port.read_header(str(path))
    same(dataclasses.asdict(ha), dataclasses.asdict(hb))
    np.testing.assert_allclose(hb.ion_beta, [0.1167e6, 0.1802e6, -0.1311e6,
                                             -0.4588e6])
    assert hb.leap_seconds == 18 and hb.delta_utc[2:] == (233472, 1860)
    ta, tb = ref.parse_rinex_nav(str(path)), port.parse_rinex_nav(str(path))
    assert sorted(ta) == sorted(tb) == sorted(arr.prn.tolist())
    for prn in ta:
        assert len(ta[prn]) == len(tb[prn]) == 2
        for a, b in zip(ta[prn], tb[prn]):
            same(dataclasses.asdict(a), dataclasses.asdict(b))
        same(dataclasses.asdict(ref.select_ephemeris(ta[prn], 352000.0)),
             dataclasses.asdict(port.select_ephemeris(tb[prn], 352000.0)))
        assert port.select_ephemeris(tb[prn], 352000.0).t_oe == 352800.0
    for tow in (None, 352000.0):
        la = ref.load_ephemerides(str(path), arr.prn, tow)
        lb = port.load_ephemerides(str(path), arr.prn, tow)
        same({k: dataclasses.asdict(v) for k, v in la.items()},
             {k: dataclasses.asdict(v) for k, v in lb.items()})
    for e in arr.ephs:
        got = tb[e.prn][0]
        for f in port.Ephemeris.__dataclass_fields__:
            if f in ("tow_timestamp", "cp_timestamp", "complete"):
                continue
            np.testing.assert_allclose(getattr(got, f), getattr(e, f),
                                       rtol=1e-12, atol=0, err_msg=f)
    with pytest.raises(KeyError):
        port.load_ephemerides(str(path), [32])


def case_filters():
    """tests/test_aux.py's filter cases (running average, integrators,
    low-pass, streaming FIR, the vectorized ring) through both packages on
    the same seeded streams: every output bit-equal."""
    ref, port = both("libgnss.filters")
    rng = np.random.default_rng(10)
    xs = rng.standard_normal(40)
    for name, args in (("RunningAverageFilter", (4, 1.0)),
                       ("BoxcarIntegrator", (0.5,)),
                       ("BilinearIntegrator", (0.5, 0.25)),
                       ("LowPassFilter", (0.25,))):
        fa, fb = getattr(ref, name)(*args), getattr(port, name)(*args)
        same([fa.update(x) for x in xs], [fb.update(x) for x in xs])
        fa.reset(k=0.1) if name != "RunningAverageFilter" else fa.reset(N=3)
        fb.reset(k=0.1) if name != "RunningAverageFilter" else fb.reset(N=3)
        same([fa.update(x) for x in xs[:9]], [fb.update(x) for x in xs[:9]])
    b = ref.design_lowpass_fir(11, fs=10.0, f_cut=2.0)
    same(b, port.design_lowpass_fir(11, fs=10.0, f_cut=2.0))
    sig = rng.standard_normal(100)
    fa, fb = ref.FIRfilter(b), port.FIRfilter(b)
    for lo, hi in ((0, 30), (30, 55), (55, 100)):
        same(fa.update(sig[lo:hi]), fb.update(sig[lo:hi]))
    same(fa.b, fb.b)
    sa = ref.running_average_init(3, average=0.0, shape=(2,))
    sb = port.running_average_init(3, average=0.0, shape=(2,))
    for x in rng.standard_normal((6, 2)):
        sa, ya = ref.running_average_update(sa, x)
        sb, yb = port.running_average_update(sb, x)
        same(ya, yb)
        same(tuple(sa), tuple(sb))
    for fn in ("boxcar_update", "bilinear_update", "lowpass_update"):
        same(getattr(ref, fn)(xs[:5], xs[5:10], 0.3),
             getattr(port, fn)(xs[:5], xs[5:10], 0.3))


class _Clock:
    """A stand-in for the time module: perf_counter moves only when a step
    says so, so two FlowRunners see the same iteration times."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def case_runtime_flow(monkeypatch):
    """tests/test_runtime.py's flow-runner cases (stats and cap, watchdog,
    end of stream) and the rest of the contract (warm-up grace, real-time
    misses, source_fn, stop) through both packages on one scripted clock:
    stats, summaries and errors equal; the port's first_s is iteration 1's
    time."""
    ref, port = both("runtime.flow")
    dts = [0.5, 0.001, 0.003, 0.025, 0.002, 0.04, 0.001]

    def drive(m, **kw):
        clock = _Clock()
        monkeypatch.setattr(m, "time", clock)
        calls = []
        eof_after = kw.pop("eof_after", 99)

        def step(*blk):
            calls.append(blk)
            if len(calls) > eof_after:
                raise EOFError
            clock.t += dts[len(calls) - 1]
            return len(calls)

        n = kw.pop("n", None)
        stop_at = kw.pop("stop_at", None)
        runner = m.FlowRunner(step, **kw)
        got = []

        def on_result(r):
            got.append(r)
            if r == stop_at:
                runner.stop()

        try:
            stats = runner.run(n, on_result=on_result)
            err = None
        except m.WatchdogError as e:
            stats, err = runner.stats, str(e)
        return (stats, err, runner.realtime_misses, got, calls)

    cases = (dict(watchdog_s=1.0, max_iterations=5, n=100),
             dict(watchdog_s=0.01),                      # fires at once
             dict(watchdog_s=0.01, warmup_iterations=1, n=6),
             dict(watchdog_s=None, eof_after=3),
             dict(watchdog_s=None, realtime_budget_s=0.02, n=7),
             dict(watchdog_s=None, stop_at=4),
             dict(watchdog_s=None, source=[7, 8, None]),
             dict(watchdog_s=None, source=[7, 8]))      # then EOFError
    for kw in cases:
        outs = []
        for m in (ref, port):
            kw2 = dict(kw)
            if "source" in kw2:           # a fresh source for each package
                items = iter(kw2.pop("source"))

                def source_fn(items=items):
                    for x in items:
                        return x
                    raise EOFError

                kw2["source_fn"] = source_fn
            outs.append(drive(m, **kw2))
        (sa, ea, ma, ga, ca), (sb, eb, mb, gb, cb) = outs
        assert (ea is None) == (eb is None)
        if ea is not None:
            assert ea == eb and "watchdog" in eb
        assert (sa.n, sa.total_s, sa.min_s, sorted(sa.top_max)) == (
            sb.n, sb.total_s, sb.min_s, sorted(sb.top_max)), kw
        assert sa.summary() == sb.summary()
        assert (ma, ga, ca) == (mb, gb, cb)
        assert sb.first_s == (dts[0] if sb.n else None)
    assert [o[0].n for o in [drive(port, **dict(c)) for c in (
        dict(watchdog_s=1.0, max_iterations=5, n=100),
        dict(watchdog_s=None, eof_after=3))]] == [5, 3]
    assert issubclass(port.WatchdogError, RuntimeError)


def _seeded_fixes(n=6):
    """Fix-like records (mc, rx_time_a, x_ecef) around the scenario's truth,
    made from a seed."""
    import types

    (_, hand, _), _ = scenarios()
    rng = np.random.default_rng(11)
    return [types.SimpleNamespace(
        mc=i + 1, rx_time=hand.rx_time + 0.02 * (i + 1),
        rx_time_a=hand.rx_time + 0.02 * (i + 1) - 1e-7 * i,
        x_ecef=hand.x_ecef + rng.standard_normal(8) * [5, 5, 5, 1, .3, .3,
                                                       .3, .01],
        pos_score=1e6, vel_score=1e6) for i in range(n)]


def case_printer(tmp_path):
    """The nav CSV: header, rows and the GPS -> UTC conversion of both
    packages byte-equal (FixWriter, write_fix, gps_to_utc)."""
    ref, port = both("io.printer")
    fixes = _seeded_fixes()
    texts = []
    for m in (ref, port):
        path = tmp_path / f"{m.__name__}.csv"
        with m.FixWriter(str(path), weekno=2008) as w:
            for f in fixes:
                w.write(f)
        texts.append(path.read_bytes())
    assert texts[0] == texts[1] and texts[1].count(b"\n") == len(fixes) + 1
    for tow in (0.0, 345720.02, 604799.999999):
        assert ref.gps_to_utc(2008, tow) == port.gps_to_utc(2008, tow)
    assert (ref.GPS_EPOCH, ref.GPS_UTC_LEAP_S) == (port.GPS_EPOCH,
                                                  port.GPS_UTC_LEAP_S)


def case_mapplot(tmp_path):
    """The HTML track of both packages byte-equal, from LLA points, ECEF
    states and fixes."""
    ref, port = both("io.mapplot")
    fixes = _seeded_fixes()
    pages = []
    for m in (ref, port):
        for kind, kw in (("lla", dict(lla_points=[(40.1, -88.2, 200.0),
                                                  (40.2, -88.3)])),
                         ("ecef", dict(ecef_points=[f.x_ecef for f in fixes],
                                       title="t", zoom=12))):
            path = tmp_path / f"{m.__name__}_{kind}.html"
            m.write_track_html(str(path), **kw)
            pages.append(path.read_bytes())
        path = tmp_path / f"{m.__name__}_fixes.html"
        m.write_fixes_html(str(path), fixes, color="#ff0000")
        pages.append(path.read_bytes())
    assert pages[:3] == pages[3:]
    assert b"-88.2" in pages[0]


CASES = {
    "constants": case_constants, "io.handoff": case_handoff,
    "io.rawfile": case_rawfile, "io.scenario": case_scenario,
    "io.synth": case_synth, "libgnss.cacode": case_cacode,
    "libgnss.dataparser": case_dataparser,
    "libgnss.ephemeris": case_ephemeris, "libgnss.frames": case_frames,
    "libgnss.iono": case_iono, "libgnss.lnav": case_lnav,
    "libgnss.naveng": case_naveng, "libgnss.satcache": case_satcache,
    "libgnss.satpos": case_satpos, "libgnss.tropo": case_tropo,
    "models.ekf": case_ekf, "models.grid": case_grid,
    "io.frontend": case_frontend, "io.netsource": case_netsource,
    "runtime.nativelib": case_runtime_nativelib,
    "libgnss.rinex": case_rinex, "libgnss.filters": case_filters,
    "runtime.flow": case_runtime_flow,
    "io.printer": case_printer, "io.mapplot": case_mapplot,
}


@pytest.mark.parametrize("module", sorted(CASES))
def test_host_layer_copy_is_bit_equal(module, request):
    case = CASES[module]
    code = case.__code__
    case(*(request.getfixturevalue(a)
           for a in code.co_varnames[:code.co_argcount]))


def test_every_copied_module_has_a_case():
    """The list above is the list of host modules the port holds."""
    import pkgutil

    import navlab_dpe_sdr_tpu_torch as port

    held = sorted(
        m.name[len(PORT) + 1:] for m in pkgutil.walk_packages(
            port.__path__, PORT + ".")
        if not m.ispkg and m.name.split(".")[1] in ("constants", "io",
                                                    "libgnss", "runtime")
        or m.name in (f"{PORT}.models.ekf", f"{PORT}.models.grid"))
    assert held == sorted(CASES)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_handoff_file_crosses_between_the_packages(writer, reader, tmp_path):
    """A handoff written by either package reads in the other with every
    field equal, and rebuilds the same ephemerides there."""
    w = importlib.import_module(f"{writer}.io.handoff")
    r = importlib.import_module(f"{reader}.io.handoff")
    _, hand, arr = importlib.import_module(
        f"{writer}.io.scenario").make_scenario()
    path = str(tmp_path / "handoff.csv")
    w.write_handoff(path, hand)
    got = r.read_handoff(path)
    assert type(got).__module__ == f"{reader}.io.handoff"
    same(hand_fields(got), hand_fields(hand))
    same(eph_fields(got.eph_array(), float), eph_fields(arr, float))


def test_port_receiver_takes_either_packages_scenario():
    """The JAX package's Handoff/EphArray/Grid/SampleFile objects are taken
    by their fields: a port receiver built from them prepares the same
    first block as one built from the port's own."""
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEReceiver

    preps = []
    for pkg in (REF, PORT):
        _, hand, arr = importlib.import_module(
            f"{pkg}.io.scenario").make_scenario()
        raw = importlib.import_module(f"{pkg}.io.rawfile")
        grid = importlib.import_module(f"{pkg}.models.grid").uniform_grid(n=3)
        rf = raw.SampleFile(samples=np.zeros(100000, raw.DTYPE_IQ16), fs=FS)
        rx = DPEReceiver(rf, hand, grid=grid, eph=arr, device="cpu")
        preps.append(rx._prepare_batch(1)[0])
    for a, b in zip(*preps):
        same(a, b)
