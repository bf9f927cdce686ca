"""The port's command line (navlab_dpe_sdr_tpu_torch/cli.py) against the JAX
package's, both `main`s called in this process with `--device cpu`, on the
1.2 s `synth` capture of tests/test_cli.py:24-32.

Tolerances, each the one the port's module tests hold the same function to:
- acquire: found flags, rc, fc and fi equal, ri within 1e-6 cycles, peak
  metrics within rtol 1e-4 (tests/test_torch_acquisition.py); deep search:
  found and rc equal, fi within one fine-frequency bin
  (tests/test_torch_coherent.py);
- dpe fixes: within 1e-6 m (tests/test_torch_dpe.py), and the `--out` CSV
  rows equal as text. Per block on the spread grid, the 4th block's
  position surface holds a float32 tie: two grid points whose scores are
  within one ulp (6e-8 relative), the JAX package's a hair apart, the
  port's equal. Fixes are equal up to the block where the runs part, that
  block must be such a tie in both packages' own surfaces (each scores the
  other's argmax within 1e-6 of its max), and the runs meet again within
  one unit of the CSV's last digit (1e-3 m) by the last block;
- survey: x_ecef within one fine-lattice step per axis, the peaks within
  rtol 1e-5 (tests/test_torch_integrate.py, the Queue 3 tie), n_batches
  equal;
- mc and sens: printed rows, shift file, summary and ladder CSV equal,
  XECEF logs within 2e-6 m (tests/test_torch_montecarlo.py);
- live: the live receiver's fixes within 1e-6 m; record: file bytes equal;
  fleet: the same found flags and decode-failed messages.
The CLIs' receivers are recorded as they are built, so fixes are compared
in float64 and not only as printed."""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import navlab_dpe_sdr_tpu.cli as jcli
import navlab_dpe_sdr_tpu.models.dpe as jdpe
import navlab_dpe_sdr_tpu.ops.acquisition as jacq
import navlab_dpe_sdr_tpu_torch.cli as tcli
import navlab_dpe_sdr_tpu_torch.models.dpe as tdpe
import navlab_dpe_sdr_tpu_torch.ops.acquisition as tacq
from navlab_dpe_sdr_tpu_torch.io.handoff import read_handoff

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PRNS = "2,7,6,12,31,30,13,26"


def run(cli, *argv):
    """cli.main(["--device", "cpu", *argv]) in this process; its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", *argv])
    return out.getvalue()


@pytest.fixture(scope="module")
def tiny_capture(tmp_path_factory):
    """The port's `synth` capture and handoff (1.2 s, 47 dB-Hz); the JAX
    CLI's `synth` writes the same bytes."""
    d = tmp_path_factory.mktemp("cli")
    paths = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        cap, hand = d / f"cap_{name}.dat", d / f"hand_{name}.csv"
        run(cli, "synth", "--out", str(cap), "--handoff", str(hand),
            "--seconds", "1.2", "--cn0", "47")
        paths[name] = (cap, hand)
    (jc, jh), (tc, th) = paths["jax"], paths["port"]
    assert jc.read_bytes() == tc.read_bytes()
    assert jh.read_text() == th.read_text()
    return tc, th


@pytest.fixture
def receivers(monkeypatch):
    """{'jax': [...], 'port': [...]}: every DPEReceiver either CLI builds."""
    made = {"jax": [], "port": []}
    for name, mod in (("jax", jdpe), ("port", tdpe)):
        base = mod.DPEReceiver

        class Recorded(base):
            def __init__(self, *a, _made=made[name], **kw):
                super().__init__(*a, **kw)
                _made.append(self)

        monkeypatch.setattr(mod, "DPEReceiver", Recorded)
    return made


def assert_same_fixes(jfixes, tfixes, atol=1e-6):
    assert len(tfixes) == len(jfixes) > 0
    for fj, ft in zip(jfixes, tfixes):
        assert fj.mc == ft.mc
        assert isinstance(ft.x_ecef, np.ndarray)
        assert ft.x_ecef.dtype == np.float64 and ft.x_ecef.shape == (8,)
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=atol)


@pytest.mark.parametrize("noncoherent", [False, True])
def test_cli_acquire_matches_jax(tiny_capture, monkeypatch, noncoherent):
    cap, _ = tiny_capture
    got = {}
    for name, mod in (("jax", jacq), ("port", tacq)):
        inner = mod.acquire

        def spy(*a, _inner=inner, _name=name, **kw):
            got[_name] = _inner(*a, **kw)
            return got[_name]

        monkeypatch.setattr(mod, "acquire", spy)
    flag = ["--noncoherent"] if noncoherent else []
    outs = [run(cli, "acquire", str(cap), "--prns", PRNS, *flag)
            for cli in (jcli, tcli)]
    ref, out = got["jax"], got["port"]
    assert [r.prn for r in out] == [r.prn for r in ref]
    for a, b in zip(ref, out):
        assert a.found == b.found, a.prn
        assert b.rc == a.rc and b.fi == a.fi and b.fc == a.fc, a.prn
        assert abs(b.ri - a.ri) < 1e-6, a.prn
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-4)
        np.testing.assert_allclose(b.cppr, a.cppr, rtol=1e-4)
    assert sum(r.found for r in out) >= 4
    assert [ln.split()[:2] for ln in outs[0].splitlines()[1:]] == [
        ln.split()[:2] for ln in outs[1].splitlines()[1:]]


def test_cli_deep_acquire_and_engines(tiny_capture, monkeypatch):
    """`--deep-ms 100` goes to the JAX CLI's acquire_real(n_coh_ms=) and to
    the port's acquire_deep; `--engine real` raises the receiver's
    refusal, `auto` is `fft`."""
    import navlab_dpe_sdr_tpu.ops.acquisition_real as jreal

    cap, _ = tiny_capture
    got = {}
    for name, mod, fn in (("jax", jreal, "acquire_real"),
                          ("port", tacq, "acquire_deep")):
        inner = getattr(mod, fn)

        def spy(*a, _inner=inner, _name=name, **kw):
            got[_name] = _inner(*a, **kw)
            return got[_name]

        monkeypatch.setattr(mod, fn, spy)
    for cli in (jcli, tcli):
        run(cli, "acquire", str(cap), "--prns", "2,7", "--deep-ms", "100",
            "--coh-ms", "10")
    bin_hz = 2.5e6 / (8 * (1 << (25000).bit_length()))
    for a, b in zip(got["jax"], got["port"]):
        assert a.found and b.found and b.rc == a.rc
        assert abs(b.fi - a.fi) <= bin_hz * 1.001
    with pytest.raises(NotImplementedError, match="Not to port"):
        run(tcli, "acquire", str(cap), "--prns", "2", "--engine", "real")
    assert "True" in run(tcli, "acquire", str(cap), "--prns", "2",
                         "--engine", "auto")


def surfaces(d, mc):
    return np.load(pathlib.Path(d) / f"scores_{mc:06d}.npz")


def test_cli_dpe_per_block_native_io_matches_jax(tiny_capture, receivers,
                                                 tmp_path):
    """20 per-block steps fed by the native sample streamer, fixes to the
    nav CSV and the async X_ECEF log, score surfaces dumped, a profiler
    trace: see the module docstring for the tie on the 4th block."""
    cap, hand = tiny_capture
    outs, csvs = [], []
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = tmp_path / name
        d.mkdir()
        extra = ["--profile-dir", str(d / "prof")] if cli is tcli else []
        outs.append(run(cli, "dpe", str(cap), "--handoff", str(hand),
                        "--blocks", "20", "--out", str(d / "fixes.csv"),
                        "--native-io", "--xecef-log", str(d / "x.csv"),
                        "--set", f"dump_scores_to={d}", "--watchdog", "600",
                        *extra))
        x = np.loadtxt(d / "x.csv", delimiter=",")
        assert x.shape == (20, 9)
        csvs.append((d / "fixes.csv").read_text().splitlines())
        assert len(csvs[-1]) == 21
    assert "final fix" in outs[1] and "first iteration:" in outs[1]
    assert (tmp_path / "port" / "prof" / "trace.json").stat().st_size > 0
    (jrx,), (trx,) = receivers["jax"], receivers["port"]
    assert len(trx.fixes) == len(jrx.fixes) == 20
    part = next((k for k, (fj, ft) in enumerate(zip(jrx.fixes, trx.fixes))
                 if np.abs(ft.x_ecef - fj.x_ecef).max() > 1e-6), None)
    if part is not None:
        mc = jrx.fixes[part].mc
        tied = 0
        for m in ("pos", "vel"):
            sj = surfaces(tmp_path / "jax", mc)[m].ravel()
            st = surfaces(tmp_path / "port", mc)[m].ravel()
            aj, at = int(sj.argmax()), int(st.argmax())
            if aj != at:
                tied += 1
                assert sj[at] >= sj[aj] - 1e-6 * abs(sj[aj]), (mc, m)
                assert st[aj] >= st[at] - 1e-6 * abs(st[at]), (mc, m)
        assert tied, f"block {mc}: fixes part without a tie"
        np.testing.assert_allclose(trx.fixes[-1].x_ecef, jrx.fixes[-1].x_ecef,
                                   rtol=0, atol=1e-3)
    else:
        part = 20
    if part:
        assert_same_fixes(jrx.fixes[:part], trx.fixes[:part])
    assert csvs[0][:part + 1] == csvs[1][:part + 1]


def test_cli_dpe_profile_trace_written_when_a_step_raises(
        tiny_capture, monkeypatch, tmp_path):
    """`--profile-dir`: the profiler stops and its trace is written also
    when the run dies, which is when a trace matters most."""
    cap, hand = tiny_capture
    step = tdpe.DPEReceiver.step
    calls = []

    def failing(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step 2 fails")
        return step(self, *a, **kw)

    monkeypatch.setattr(tdpe.DPEReceiver, "step", failing)
    with pytest.raises(RuntimeError, match="step 2 fails"):
        run(tcli, "dpe", str(cap), "--handoff", str(hand), "--blocks", "3",
            "--watchdog", "600", "--profile-dir", str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("mode", [
    ["--batched"],
    ["--batched", "--lookahead", "10", "--group-k", "5",
     "--pipeline-depth", "2"],
    ["--integrate", "4"]], ids=["batched", "grouped_pipelined", "integrate"])
def test_cli_dpe_batch_modes_match_jax(tiny_capture, receivers, tmp_path,
                                       mode):
    """The batched and integrated modes: fixes reach the nav CSV as float64
    numpy states, every fix equal to the JAX CLI's, the CSVs equal."""
    cap, hand = tiny_capture
    texts = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.csv"
        run(cli, "dpe", str(cap), "--handoff", str(hand), "--blocks", "20",
            "--out", str(out), *mode)
        texts.append(out.read_text())
    (jrx,), (trx,) = receivers["jax"], receivers["port"]
    assert_same_fixes(jrx.fixes, trx.fixes)
    assert texts[0] == texts[1]
    assert texts[1].count("\n") == len(trx.fixes) + 1


def test_cli_dpe_config_and_set_overrides(tiny_capture, receivers, tmp_path):
    """--config JSON then --set, unknown keys ignored: the receivers of both
    CLIs get the same DPEConfig and give the same fixes."""
    cap, hand = tiny_capture
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"interp": "linear", "l_power": 2,
                               "not_a_field": 1}))
    for cli in (jcli, tcli):
        run(cli, "dpe", str(cap), "--handoff", str(hand), "--blocks", "3",
            "--config", str(cfg), "--set", "engine=real", "--set",
            "ekf_mode=alpha", "--set", "ekf_alpha=0.5", "--watchdog", "600")
    (jrx,), (trx,) = receivers["jax"], receivers["port"]
    jc, tc = dataclasses.asdict(jrx.cfg), dataclasses.asdict(trx.cfg)
    assert jc == tc
    assert (tc["interp"], tc["l_power"], tc["ekf_mode"], tc["ekf_alpha"]) \
        == ("linear", 2, "alpha", 0.5)
    assert_same_fixes(jrx.fixes, trx.fixes)


def test_cli_survey_matches_jax(tiny_capture, receivers, tmp_path):
    cap, hand = tiny_capture
    payloads = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.json"
        text = run(cli, "survey", str(cap), "--handoff", str(hand),
                   "--blocks", "48", "--batch", "8", "--fine-n", "15",
                   "--json", str(out))
        assert "sigma ENU+clk" in text
        payloads.append(json.loads(out.read_text()))
    jp, tp = payloads
    assert sorted(tp) == sorted(jp)
    assert tp["n_batches"] == jp["n_batches"] == 6
    assert tp["n_blocks"] == jp["n_blocks"] == 48
    assert tp["t_ref"] == jp["t_ref"]
    np.testing.assert_allclose(tp["x_ecef"][:4], jp["x_ecef"][:4], rtol=0,
                               atol=0.25 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(tp["x_ecef"][4:], jp["x_ecef"][4:], rtol=0,
                               atol=0.02 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(tp["pos_score"], jp["pos_score"], rtol=1e-5)
    assert all(s > 0 for s in tp["sigma_pos"])
    (jrx,), (trx,) = receivers["jax"], receivers["port"]
    assert_same_fixes(jrx.fixes, trx.fixes)


def test_cli_track_rinex_fill(tiny_capture, tmp_path):
    """`track --rinex`: 1 s decodes no LNAV, so every PRN's ephemeris comes
    from a RINEX file written from the scenario; both CLIs' handoffs carry
    the RINEX records."""
    from test_torch_hostlayers import write_rinex_nav

    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.libgnss import rinex

    cap, _ = tiny_capture
    _, _, arr = make_scenario()
    nav = tmp_path / "scen.18n"
    write_rinex_nav(nav, arr.ephs)
    hands = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        h = tmp_path / f"{name}.csv"
        text = run(cli, "track", str(cap), "--prns", PRNS, "--seconds", "1",
                   "--rinex", str(nav), "--handoff", str(h))
        assert f"filling ephemerides for [{PRNS.replace(',', ', ')}]" in text
        hands.append(read_handoff(str(h)))
    want = rinex.load_ephemerides(str(nav), [int(p) for p in PRNS.split(",")])
    for h in hands:
        for e in h.eph_array().ephs:
            for f in ("sqrt_A", "M_0", "t_oe", "OMEGA_0", "a_f0", "IODE"):
                assert getattr(e, f) == getattr(want[e.prn], f), (e.prn, f)


@pytest.mark.parametrize("mode", ["spacings", "perturbation"])
def test_cli_mc_matches_jax(tiny_capture, tmp_path, mode):
    """`mc --spacings` and the perturbation runs with `--out-dir`: the same
    printed rows and summary, and the files of tests/test_torch_montecarlo.py
    with its limits (shift file and summary equal, XECEF logs within
    2e-6 m)."""
    cap, hand = tiny_capture
    argv = {"spacings": ["--spacings", "10,20", "--grid-n", "5",
                         "--grid-style", "uniform", "--blocks", "8"],
            "perturbation": ["--runs", "2", "--blocks", "6", "--grid",
                             "uniform", "--bottom", "30", "--span", "10",
                             "--seed", "3"]}[mode]
    texts = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        extra = (["--out-dir", str(tmp_path / name)]
                 if mode == "perturbation" else [])
        texts.append(run(cli, "mc", str(cap), "--handoff", str(hand), *argv,
                         *extra).replace(str(tmp_path / name), "OUT"))
    assert texts[1] == texts[0]
    if mode == "spacings":
        assert texts[1].count(" ok") == 2
        return
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert (td / "shifts.csv").read_text() == (jd / "shifts.csv").read_text()
    assert json.loads((td / "summary.json").read_text()) == json.loads(
        (jd / "summary.json").read_text())
    for idx in range(2):
        a = np.loadtxt(jd / f"run{idx:03d}_XFile.csv", delimiter=",")
        b = np.loadtxt(td / f"run{idx:03d}_XFile.csv", delimiter=",")
        assert a.shape == b.shape == (6, 9)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


def test_cli_sens_matches_jax(tmp_path):
    """A one-level ladder: the printed result and the CSV equal, as
    tests/test_torch_montecarlo.py holds cn0_sweep."""
    texts, csvs = [], []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.csv"
        texts.append(run(cli, "sens", "--levels", "45", "--blocks", "8",
                         "--k", "4", "--grid", "uniform", "--out", str(out)
                         ).replace(str(out), "OUT"))
        csvs.append(out.read_text())
    assert texts[1] == texts[0] and "HELD" in texts[1]
    assert csvs[1] == csvs[0] and csvs[1].count("\n") == 2


def test_cli_record_sim_source_matches_jax(tiny_capture, tmp_path):
    """`record sim://`: 0.04 s in 0.02 s files, as tests/test_frontend.py
    runs the JAX CLI; the same files, named by the same pattern from the
    wall clock, with equal bytes."""
    import re

    cap, _ = tiny_capture
    files = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / name
        text = run(cli, "record", f"sim://{cap}", "--out-dir", str(out),
                   "--seconds", "0.04", "--rotate-s", "0.02")
        assert "recorded 2 blocks" in text and "fell behind the radio" in text
        paths = [ln.strip() for ln in text.splitlines()
                 if ln.startswith("  ")]
        assert sorted(paths) == sorted(str(p) for p in out.iterdir())
        for p in paths:
            assert re.fullmatch(r"\d{8}_\d{6}_usrp0_2500KHz(_\d+)?\.dat",
                                os.path.basename(p))
        files.append([pathlib.Path(p).read_bytes() for p in paths])
    assert len(files[1]) == len(files[0]) == 2
    assert files[1] == files[0]
    assert all(len(b) == 50000 * 4 for b in files[1])
    assert b"".join(files[1]) == cap.read_bytes()[:2 * 50000 * 4]


@pytest.mark.parametrize("source,lookahead", [("tcp", 10), ("sim", 1)])
def test_cli_live_matches_jax(tiny_capture, receivers, tmp_path, source,
                              lookahead):
    """`live` over the paced TCP server (batched) and the simulated radio
    (per block): the run record has the JAX CLI's keys and the port's
    device, every block arrives, and the live receiver's fixes equal the
    JAX CLI's within 1e-6 m. Real-time misses on a shared CPU are not
    held (tests/test_frontend.py)."""
    cap, hand = tiny_capture
    recs = []
    for name, cli in (("jax", jcli), ("port", tcli)):
        out = tmp_path / f"{name}.json"
        run(cli, "live", str(cap), "--handoff", str(hand), "--lookahead",
            str(lookahead), "--seconds", "0.8", "--grid", "uniform",
            "--grid-n", "7", "--watchdog", "60", "--source", source,
            "--json", str(out))
        recs.append(json.loads(out.read_text()))
    jr, tr = recs
    assert sorted(tr) == sorted([*jr, "device"]) and tr["device"] == "cpu"
    for k in ("source", "blocks", "iterations", "lookahead", "budget_ms",
              "signal_seconds"):
        assert tr[k] == jr[k], k
    assert tr["blocks"] == 40 and tr["iterations"] == 40 // lookahead
    assert tr["rt_misses"] <= tr["iterations"]
    # the live receiver is built first, its warm-up twin second
    (jrx, _), (trx, _) = receivers["jax"], receivers["port"]
    assert len(trx.fixes) == 40
    assert_same_fixes(jrx.fixes, trx.fixes)


@pytest.mark.parametrize("live", [False, True], ids=["offline", "live"])
def test_cli_fleet_decode_failed_matches_jax(tiny_capture, tmp_path, live):
    """`fleet` on the 1.2 s capture, offline and on two simulated radios
    with `--live --offsets-ms 0,7` (the warm-up included): 0.5 s decodes no
    ephemeris, so both CLIs stop at the decode-failed branch with the same
    found flags and messages; live, the stats JSON has the JAX CLI's
    sources and phases, and each radio delivered the tracked signal."""
    import re

    cap, _ = tiny_capture
    texts, stats = [], []
    for name, cli in (("jax", jcli), ("port", tcli)):
        extra = (["--live", "--offsets-ms", "0,7", "--stats-out",
                  str(tmp_path / f"{name}.json")] if live else [])
        text = run(cli, "fleet", str(cap), "--prns", "2,7", "--seconds",
                   "0.5", *extra)
        assert "skipping alignment/DPE" in text
        texts.append([re.sub(r"rc=.*", "", ln) for ln in text.splitlines()
                      if not re.match(r"(pipeline warmup|live stats)", ln)])
        if live:
            stats.append(json.loads((tmp_path / f"{name}.json").read_text()))
    assert texts[1] == texts[0]
    assert sum("found=True" in ln for ln in texts[1]) == 2 * (1 + live)
    if live:
        js, ts = stats
        assert ts["decode_failed"] is js["decode_failed"] is True
        assert [(s["label"], sorted(s["phases"])) for s in ts["sources"]] \
            == [(s["label"], sorted(s["phases"])) for s in js["sources"]]
        # what a paced radio delivered before it closed is wall-clock time
        assert all(s["delivered_s"] >= 0.5 for s in ts["sources"])


def test_cli_bench_and_mesh_refuse_by_roadmap_item(tiny_capture, tmp_path):
    """`bench` exits naming ROADMAP item 6. `--mesh grid=8` in a lone
    process exits naming how to start the ranks; `--mesh grid=1` runs a
    one-rank mesh: the same CSV as the run without it, and no process
    group left behind."""
    import torch.distributed as dist

    cap, hand = tiny_capture
    with pytest.raises(SystemExit, match="item 6"):
        run(tcli, "bench")
    for sub in ("dpe", "survey"):
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 8"):
            run(tcli, sub, str(cap), "--handoff", str(hand), "--mesh",
                "grid=8")
    csv = {}
    for mesh in ((), ("--mesh", "grid=1")):
        csv[mesh] = tmp_path / f"fixes{len(mesh)}.csv"
        out = run(tcli, "dpe", str(cap), "--handoff", str(hand), "--blocks",
                  "10", "--batched", "--lookahead", "5", "--out",
                  str(csv[mesh]), *mesh)
        assert ("mesh: {'chan': 1, 'grid': 1} over 1 rank(s)" in out) \
            == bool(mesh)
        assert not dist.is_initialized()
    assert csv[()].read_text() == csv[("--mesh", "grid=1")].read_text()


def test_cli_without_device_never_runs_on_the_cpu(tiny_capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    cap, _ = tiny_capture
    for argv in (["acquire", str(cap), "--prns", "2"],
                 ["synth", "--out", os.devnull]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    with pytest.raises(SystemExit):
        tcli.main(["--device", "auto", "acquire", str(cap)])


def _options(cli, *argv):
    """Option strings in `cli`'s --help for argv (a subcommand or none)."""
    import re

    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        cli.main([*argv, "--help"])
    found = re.findall(r"^  (-{1,2}[a-z][\w-]*)(?:[ A-Z_.\[\]{},]*, "
                       r"(--[a-z][\w-]*))?", out.getvalue(), re.M)
    return {o for pair in found for o in pair if o}


def test_cli_help_lists_the_same_subcommands_and_arguments():
    """The same 13 subcommands with the same options as the JAX CLI; the
    top level differs only by --cpu-devices (not ported)."""
    subs = ["synth", "acquire", "track", "dpe", "survey", "vt", "fleet",
            "mc", "sens", "console", "live", "record", "bench"]
    top_j, top_t = _options(jcli), _options(tcli)
    assert top_j - top_t == {"--cpu-devices"}
    assert "--device" in top_t
    assert set(tcli.build_parser()._subparsers._group_actions[0].choices) \
        == set(subs)
    for sub in subs:
        assert _options(jcli, sub) == _options(tcli, sub), sub


def test_python_m_runs_the_cli(tiny_capture):
    cap, _ = tiny_capture
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "navlab_dpe_sdr_tpu_torch", "--device", "cpu",
         "acquire", str(cap), "--prns", "2,7,6,12"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-800:]
    assert "True" in res.stdout and "rc[chips]" in res.stdout
