"""The port's flow console (navlab_dpe_sdr_tpu_torch/console.py): the cases
of tests/test_cli.py:80-220 and tests/test_aux.py:52 on the port's Console
with device="cpu", and the JAX package's Console side by side where a flow
runs: the same commands print the same text, and a flow's fixes equal the
JAX flow's within 1e-6 m (tests/test_torch_dpe.py's tolerance)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import navlab_dpe_sdr_tpu.console as jconsole
import navlab_dpe_sdr_tpu_torch.cli as tcli
import navlab_dpe_sdr_tpu_torch.console as tconsole

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_capture(tmp_path_factory):
    """tests/test_cli.py's 1.2 s capture, from the port's `synth`."""
    d = tmp_path_factory.mktemp("console")
    cap, hand = d / "cap.dat", d / "hand.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["--device", "cpu", "synth", "--out", str(cap),
                   "--handoff", str(hand), "--seconds", "1.2", "--cn0", "47"])
    return cap, hand


def _console(mod=tconsole):
    out = io.StringIO()
    kw = dict(device="cpu") if mod is tconsole else {}
    return mod.Console(stdout=out, **kw), out


def test_console_dofile_matches_jax(tiny_capture, tmp_path):
    """newflow / setparam / startflow / status / quit from a dofile, in both
    consoles: the same transcript apart from the fixes, which agree within
    1e-6 m."""
    cap, hand = tiny_capture
    script = tmp_path / "s.dofile"
    script.write_text(
        f"newflow f {cap} {hand}\nsetparam f interp linear\n"
        f"startflow f 3\nstatus\nquit\n")
    consoles = []
    for mod in (jconsole, tconsole):
        c, out = _console(mod)
        assert c.onecmd(f"dofile {script}")       # quit ends the loop
        consoles.append((c, out.getvalue()))
    (jc, jtext), (tc, ttext) = consoles
    assert "final fix" in ttext and "failed" not in ttext
    strip = [ln for ln in ttext.splitlines()
             if not ln.startswith(("final fix", "3 iterations"))]
    assert strip == [ln for ln in jtext.splitlines()
                     if not ln.startswith(("final fix", "3 iterations"))]
    jrx, trx = jc.flows["f"].rx, tc.flows["f"].rx
    assert trx.device.type == "cpu" and len(trx.fixes) == len(jrx.fixes) == 3
    for fj, ft in zip(jrx.fixes, trx.fixes):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)


def test_cli_console_subcommand_passes_the_device(tiny_capture, monkeypatch):
    """`--device cpu console` reads commands from stdin and builds its
    flows' receivers on the CPU."""
    cap, hand = tiny_capture
    made = []
    real_build = tconsole._Flow.build

    def build(self):
        made.append(real_build(self))
        return made[-1]

    monkeypatch.setattr(tconsole._Flow, "build", build)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"newflow f {cap} {hand}\nstartflow f 2\nq\n"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(["--device", "cpu", "console"])
    assert "final fix" in out.getvalue()
    assert [rx.device.type for rx in made] == ["cpu"]


def test_console_prefix_abbrev_alias_history(tiny_capture):
    """Unique prefixes resolve, aliases, ambiguity, history: the port's
    console prints what the JAX console prints."""
    cap, hand = tiny_capture
    texts = []
    for mod in (jconsole, tconsole):
        c, out = _console(mod)
        c.onecmd(f"newf f1 {cap} {hand}")
        c.onecmd("setp f1 interp linear")
        c.onecmd("addal f1 primary")
        c.onecmd("setp primary l_power 2")
        c.onecmd("lsf")
        c.onecmd("s")
        c.precmd("lsf")
        c.onecmd("hist")
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    text = texts[1]
    assert "flow f1 created" in text
    assert "f1.interp = linear" in text
    assert "primary -> f1" in text
    assert "f1.l_power = 2" in text
    assert "aliases=primary" in text
    assert "ambiguous command 's'" in text
    assert text.splitlines()[-1].endswith("lsf")


def test_console_active_flow_and_delflow(tiny_capture):
    cap, hand = tiny_capture
    c, out = _console()
    c.onecmd(f"newflow a {cap} {hand}")
    c.onecmd(f"newflow b {cap} {hand}")
    c.onecmd("actflow b")
    c.onecmd("setparam interp linear")
    assert c.flows["b"].overrides["interp"] == "linear"
    assert "interp" not in c.flows["a"].overrides
    c.onecmd("delflow b")
    assert "b" not in c.flows
    assert c.active == "a"


def test_console_stopflow_midrun(tiny_capture):
    """A background startflow runs the receiver's steps on its own thread;
    stopflow stops it before its block budget and joins it."""
    cap, hand = tiny_capture
    c, out = _console()
    c.onecmd(f"newflow f {cap} {hand}")
    c.onecmd("setparam f interp linear")
    c.onecmd("startflow f 55 &")
    assert "flow f started" in out.getvalue()
    fl = c.flows["f"]
    c.onecmd("status f")
    c.onecmd("stopflow f")
    assert not fl.running
    assert fl.runner.stats.n < 55 and fl.error is None
    assert "stopped after" in out.getvalue()
    c.onecmd("stopflow f")
    assert "wasn't running" in out.getvalue()
    c.onecmd("quit")


def test_console_startflow_watchdog_default_and_fires(monkeypatch):
    """The 1.5 s per-block watchdog by default, `setparam watchdog` to set
    it (<= 0 disables); iteration 1 has grace, a later stall fails the
    flow."""
    import time

    class _SlowRx:
        def __init__(self):
            self.n = 0
            self.fixes = []

        def step(self):
            self.n += 1
            if self.n >= 2:
                time.sleep(0.06)

    monkeypatch.setattr(tconsole._Flow, "build", lambda self: _SlowRx())
    c, out = _console()
    c.onecmd("newflow f cap.dat hand.csv")
    c.onecmd("setparam f watchdog 0.02")
    c.onecmd("startflow f 10")
    assert "failed" in out.getvalue() and "watchdog" in out.getvalue()
    assert c.flows["f"].runner.stats.n == 2
    c.onecmd("newflow g cap.dat hand.csv")
    c.onecmd("startflow g 2")
    assert c.flows["g"].runner.watchdog_s == 1.5
    c.onecmd("newflow h cap.dat hand.csv")
    c.onecmd("setparam h watchdog 0")
    c.onecmd("startflow h 2")
    assert c.flows["h"].runner.watchdog_s is None


def test_console_tab_completion():
    c, _ = _console()
    c.flows = {"alpha": None, "beta": None}
    c.aliases = {"primary": "alpha"}
    assert "startflow " in c.completenames("start")
    assert c.complete_startflow("al", "", 0, 0) == ["alpha "]
    assert set(c.complete_stopflow("", "", 0, 0)) == {
        "alpha ", "beta ", "primary "}
    assert "engine " in c.complete_setparam("eng", "", 0, 0)
    assert "watchdog " in c.complete_setparam("watch", "", 0, 0)


def test_console_flow_commands(tmp_path):
    """tests/test_aux.py:52: newflow/setparam/status and a nested dofile,
    no flow started: the same transcript as the JAX console's."""
    script = tmp_path / "s.dofile"
    script.write_text("newflow f2 c2.dat h2.csv\nstatus f2\n")
    texts = []
    for mod in (jconsole, tconsole):
        con, out = _console(mod)
        con.onecmd("newflow f1 cap.dat hand.csv")
        con.onecmd("setparam f1 l_power 2")
        con.onecmd("setparam f1 interp linear")
        con.onecmd("status")
        con.onecmd(f"dofile {script}")
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "flow f1 created" in texts[1] and "l_power = 2" in texts[1]
    assert "'interp': 'linear'" in texts[1] and "f2" in texts[1]


def test_console_startflow_without_a_card_reports_no_cpu_run(tiny_capture):
    """The default device is cuda: without a card a flow fails to start and
    says why; it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    cap, hand = tiny_capture
    out = io.StringIO()
    c = tconsole.Console(stdout=out)
    c.onecmd(f"newflow f {cap} {hand}")
    c.onecmd("startflow f 2")
    assert "no CUDA device" in out.getvalue()
    assert c.flows["f"].rx is None and c.flows["f"].stats is None

