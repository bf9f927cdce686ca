"""The port's ('chan', 'grid') mesh (navlab_dpe_sdr_tpu_torch/parallel) on
gloo ranks on the CPU, held to the single-device port and to the JAX mesh
(tests/test_sharding.py, tests/test_multihost.py) on the same inputs.

The ranks are subprocesses (tests/torch_mesh_ranks.py: torch and the port
only, one thread each, at most 4 ranks) that meet through a file:// store
under tmp_path and read the captures this module writes once; each launch
has a deadline, after which its ranks are killed and the test fails.

Tolerances: without a channel split every rank's fixes equal the
single-device port's to the bit on the CPU (the grid slices score each
point with the same arithmetic, the combine keeps the first occurrence,
and the CPU correlates a rank's share of the blocks to the same bits as
the whole batch, as K5 does on the card: chip_smoke.py phase 25);
against the JAX mesh, fixes atol 1e-6 as in
the JAX tests. A channel split changes the order of the channel sum:
fixes atol 1e-6, weighted atol 1e-3, step argmaxes equal or a tie within
1e-6 of the peak, as JAX's tests hold its own chan split."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.handoff import read_handoff as jread_handoff
from navlab_dpe_sdr_tpu.io.handoff import write_handoff
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16
from navlab_dpe_sdr_tpu.io.rawfile import SampleFile as JSampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.libgnss import frames
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import spread_grid as jspread_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu.parallel import mesh as jmesh
from navlab_dpe_sdr_tpu_torch.io.handoff import read_handoff
from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
from navlab_dpe_sdr_tpu_torch.models import dpe as tmodel
from navlab_dpe_sdr_tpu_torch.parallel import launch
from navlab_dpe_sdr_tpu_torch.parallel import mesh as pmesh

REPO = pathlib.Path(__file__).resolve().parent.parent
RANKS = REPO / "tests" / "torch_mesh_ranks.py"
FS = 2.5e6
LAUNCH_S = 240          # a launch's deadline


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The captures, made once: 's8' (16 blocks of the 8-PRN scenario,
    its handoff 50 m off truth, as tests/test_sharding.py) and 's12' (8
    blocks of the 12-PRN scenario); <name>.npy samples, <name>.csv
    handoff, <name>.dat the raw file."""
    d = tmp_path_factory.mktemp("mesh_inputs")
    for name, n_blocks, kw, offset in (
            ("s8", 16, dict(nav_data=True), (30.0, -40.0, 15.0)),
            ("s12", 8, dict(n_sats=12, nav_data=True,
                            tow0=345600.0 + 120.0 + 3600.0,
                            min_elev_deg=10.0), None)):
        sim, hand, _ = make_scenario(**kw)
        n = 50000 * n_blocks
        iq = sim.generate(n)
        samples = np.empty(n, DTYPE_IQ16)
        samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
        samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
        if offset is not None:
            hand.x_ecef[0:3] = frames.enu_to_ecef(hand.x_ecef[0:3],
                                                  np.array(offset))
        np.save(d / f"{name}.npy", samples)
        samples.tofile(d / f"{name}.dat")
        write_handoff(str(d / f"{name}.csv"), hand)
    return d


def _ranks_module():
    sys.path.insert(0, str(RANKS.parent))
    try:
        import torch_mesh_ranks
    finally:
        sys.path.remove(str(RANKS.parent))
    return torch_mesh_ranks


def _launch(argv_of_rank, world, tmp):
    return _ranks_module().start_processes(argv_of_rank, world, tmp, LAUNCH_S)


def _mesh_run(tmp_path_factory, inputs, world, n_chan, cases):
    """Each rank's {case.key: array} of one gloo launch."""
    tmp = tmp_path_factory.mktemp(f"mesh_c{n_chan}_w{world}")
    return _ranks_module().run_ranks(tmp, world, n_chan, inputs, cases,
                                     LAUNCH_S)


@pytest.fixture(scope="module")
def grid4(tmp_path_factory, inputs):
    return _mesh_run(tmp_path_factory, inputs, 4, 1,
                     ["shapes", "batched", "per_block", "integrated",
                      "grouped", "survey", "fft", "tie"])


@pytest.fixture(scope="module")
def chan2_grid2(tmp_path_factory, inputs):
    return _mesh_run(tmp_path_factory, inputs, 4, 2,
                     ["shapes", "step_real", "weighted", "integrated", "fft",
                      "survey"])


@pytest.fixture(scope="module")
def chan4(tmp_path_factory, inputs):
    return _mesh_run(tmp_path_factory, inputs, 4, 4, ["chan12"])


@pytest.fixture(scope="module")
def single(inputs):
    """The single-device port on the same cases, one thread as the ranks."""
    ranks = _ranks_module()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cache = {}

        def get(name):
            if name not in cache:
                cache[name] = ranks.run_case(name, str(inputs), None)
            return cache[name]

        yield get
    finally:
        torch.set_num_threads(threads)


def _jax_rx(inputs, scenario, mesh_shape=None, **cfg):
    samples = np.load(inputs / f"{scenario}.npy")
    if mesh_shape is not None:
        n_chan, n_grid = mesh_shape
        cfg["mesh"] = jmesh.make_mesh(
            n_grid=n_grid, n_chan=n_chan,
            devices=jax.devices()[:n_chan * n_grid])
    return jmodel.DPEReceiver(JSampleFile(samples=samples, fs=FS),
                              jread_handoff(str(inputs / f"{scenario}.csv")),
                              grid=jspread_grid(),
                              config=jmodel.DPEConfig(**cfg))


def _fixes(rx):
    return np.stack([f.x_ecef for f in rx.fixes])


def _same_on_every_rank(runs, case):
    keys = [k for k in runs[0] if k.startswith(case + ".")]
    assert keys
    for k in keys:
        for r in runs[1:]:
            np.testing.assert_array_equal(r[k], runs[0][k], err_msg=k)


# -- shapes and slices --------------------------------------------------------


def test_row_partitions():
    assert pmesh.ceil_rows(390625, 4) == [(0, 97657), (97657, 195314),
                                          (195314, 292971), (292971, 390625)]
    assert pmesh.ceil_rows(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert pmesh.even_rows(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert pmesh.even_rows(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    for n in (1, 7, 390625):
        for parts in (1, 2, 3, 4, 8):
            for rows in (pmesh.ceil_rows(n, parts),
                         pmesh.even_rows(n, parts)):
                assert rows[0][0] == 0 and rows[-1][1] == n
                assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
            sizes = [hi - lo for lo, hi in pmesh.even_rows(n, parts)]
            assert max(sizes) - min(sizes) <= 1


def test_mesh_shapes_and_shard_grid(grid4, chan2_grid2):
    """Each rank's coordinates and share (JAX test_grid_axis_mesh_shapes,
    test_sharded_grid_placement): all ranks on 'grid' by default, and
    chan=2 x grid=2."""
    rows = pmesh.ceil_rows(390625, 4)
    for r, run in enumerate(grid4):
        np.testing.assert_array_equal(run["shapes.shape"], [1, 4])
        np.testing.assert_array_equal(run["shapes.coords"], [0, r])
        np.testing.assert_array_equal(run["shapes.grid_rows"], rows[r])
        np.testing.assert_array_equal(run["shapes.block_rows"],
                                      pmesh.even_rows(10, 4)[r])
        np.testing.assert_array_equal(run["shapes.chan_rows"], [0, 8])
    for r, run in enumerate(chan2_grid2):
        c, g = divmod(r, 2)
        np.testing.assert_array_equal(run["shapes.shape"], [2, 2])
        np.testing.assert_array_equal(run["shapes.coords"], [c, g])
        np.testing.assert_array_equal(run["shapes.grid_rows"],
                                      pmesh.ceil_rows(390625, 2)[g])
        np.testing.assert_array_equal(run["shapes.chan_rows"],
                                      [4 * c, 4 * c + 4])


def test_one_rank_mesh_in_process():
    """make_mesh at world size 1 with no group starts a group of its own and
    ends it on close; a larger mesh without a group raises naming how to
    start the ranks; shard_grid takes this rank's rows (all of them)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(n_grid=2, device="cpu")
    m = pmesh.make_mesh(device="cpu")
    try:
        assert m.shape == {"chan": 1, "grid": 1} and m.size == 1
        g = [torch.arange(12.0).reshape(4, 3), torch.arange(4.0),
             torch.zeros(5, 3), torch.zeros(5)]
        assert [t.shape[0] for t in pmesh.shard_grid(m, g)] == [4, 4, 5, 5]
        with pytest.raises(ValueError, match="world size"):
            pmesh.make_mesh(n_grid=2, device="cpu")
    finally:
        m.close()
    assert not torch.distributed.is_initialized()


def test_step_builders_at_world_size_one(single):
    """sharded_dpe_step_real, sharded_dpe_step and scoring_only_step with
    JAX's names and arguments: on a one-rank mesh in this process, each
    returns what the function it wraps returns without a mesh."""
    from navlab_dpe_sdr_tpu_torch.ops import dpe as tdpe_ops
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real as tdpe_real

    args, meta = _ranks_module().step_inputs()
    m = pmesh.make_mesh(device="cpu")
    try:
        got = pmesh.sharded_dpe_step_real(m, **meta)(*args)
        want = tdpe_real.dpe_device_step_real(*args, **meta)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        code_w, carr_w = (torch.complex(w, -0.5 * w) for w in got[5:7])
        sargs = (code_w, carr_w, args[10], *args[11:])
        for g, w in zip(pmesh.scoring_only_step(m)(*sargs),
                        tdpe_ops.score_manifolds(*sargs)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        raw = torch.complex(args[0], args[1])
        fft0 = torch.from_numpy(tdpe_ops.nominal_code_fft(
            args[2].numpy(), FS, raw.shape[0]))
        m_int = torch.zeros(8, dtype=torch.int32)
        fargs = (raw, fft0, m_int, args[3], *args[4:])
        fkw = dict(carr_fftpts=meta["carr_fftpts"], code_win=16,
                   carr_win=48)
        for g, w in zip(pmesh.sharded_dpe_step(m, **fkw)(*fargs),
                        tdpe_ops.dpe_device_step(*fargs, **fkw)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert m.collectives == 3
    finally:
        m.close()


# -- the sharded real step ----------------------------------------------------


def test_sharded_step_real_chan2_grid2(chan2_grid2, single):
    """chan=2 x grid=2 (JAX test_sharded_matches_single_device, its 8^4
    grid and seeded inputs, launch.example_inputs): surfaces, argmaxes,
    flips and windows against the single-device port and the JAX mesh
    step over the same (chan, grid) shape."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as ge
    from navlab_dpe_sdr_tpu.models.grid import uniform_grid

    _same_on_every_rank(chan2_grid2, "step_real")
    got = chan2_grid2[0]
    want = single("step_real")
    jargs, jmeta = ge._example_args(c=8, s=5000, grid=uniform_grid(
        n=8, pos_spacing=5.0, vel_spacing=0.5))
    m = jmesh.make_mesh(n_grid=2, n_chan=2, devices=jax.devices()[:4])
    with m:
        jout = [np.asarray(x) for x in jmesh.sharded_dpe_step_real(
            m, **jmeta)(*jargs)]
    for ref in (want, {f"out{i}": x for i, x in enumerate(jout)}):
        for i in (0, 2, 5, 6):       # surfaces and windows
            peak = np.abs(ref[f"out{i}"]).max()
            np.testing.assert_allclose(got[f"step_real.out{i}"],
                                       ref[f"out{i}"], rtol=0,
                                       atol=1e-6 * peak)
        np.testing.assert_array_equal(got["step_real.out4"], ref["out4"])
        for s, a in ((0, 1), (2, 3)):
            surf = got[f"step_real.out{s}"]
            ga, wa = int(got[f"step_real.out{a}"]), int(ref[f"out{a}"])
            assert ga == wa or abs(surf[ga] - surf[wa]) <= 1e-6 * abs(
                surf).max(), (a, ga, wa)


# -- the receiver on the mesh -------------------------------------------------


@pytest.mark.parametrize("case,run,kw", [
    ("batched", "run_batched", dict(n_blocks=10, lookahead=5)),
    ("per_block", "run", dict(n_blocks=4)),
    ("integrated", "run_integrated", dict(n_batches=2, blocks_per_fix=4)),
    ("grouped", "run_batched", dict(n_blocks=16, lookahead=8, group_k=4)),
    ("fft", "run", dict(n_blocks=3)),
])
def test_receiver_grid4_matches_single_and_jax(grid4, single, inputs, case,
                                               run, kw):
    """grid=4 at full shapes (25^4 spread grid, S = 50 000, C = 8): every
    rank's fixes equal the single-device port's to the bit (JAX
    test_receiver_mesh_batched_matches_single_full_shapes, _per_block_and_
    integrated, _grouped_batched_matches_single; the FFT engine's step)
    and the JAX mesh run's within 1e-6 m."""
    _same_on_every_rank(grid4, case)
    got = grid4[0][f"{case}.fixes"]
    np.testing.assert_array_equal(got, single(case)["fixes"])
    cfg = dict(engine="fft") if case == "fft" else {}
    jrx = _jax_rx(inputs, "s8", (1, 4), **cfg)
    getattr(jrx, run)(**kw)
    np.testing.assert_allclose(got, _fixes(jrx), rtol=0, atol=1e-6)
    if case == "batched":
        np.testing.assert_array_equal(grid4[0]["batched.flips"],
                                      single(case)["flips"])


def test_survey_joint_pass_grid4(grid4, single, inputs):
    """run_survey on grid=4: the joint passes (coarse grid and zoom
    lattices) score each rank's rows; the result equals the single-device
    port's to the bit, and the JAX mesh survey's within one fine-lattice
    step (the U/clock ridge, ROADMAP Queue 3)."""
    _same_on_every_rank(grid4, "survey")
    got, want = grid4[0], single("survey")
    np.testing.assert_array_equal(got["survey.x_ecef"], want["x_ecef"])
    np.testing.assert_array_equal(got["survey.peaks"], want["peaks"])
    jres = _jax_rx(inputs, "s8", (1, 4)).run_survey(2, blocks_per_fix=4,
                                                     fine_n=9)
    np.testing.assert_allclose(got["survey.x_ecef"][:4], jres.x_ecef[:4],
                               rtol=0, atol=0.25 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(got["survey.x_ecef"][4:], jres.x_ecef[4:],
                               rtol=0, atol=0.02 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(got["survey.peaks"],
                               [jres.pos_score, jres.vel_score], rtol=1e-5)


def test_tie_across_ranks_goes_to_the_lowest_rank(grid4, single):
    """A lattice laid out twice over 4 ranks: ranks 0-1 hold the first copy,
    ranks 2-3 the second, so the max is held twice, on two ranks; the
    combine keeps the lower rank's index, the single-device first
    occurrence."""
    _same_on_every_rank(grid4, "tie")
    want = single("tie")
    assert int(grid4[0]["tie.arg"]) == int(want["arg"]) < 4000
    assert grid4[0]["tie.best"] == want["best"]


def test_weighted_chan2_grid2(chan2_grid2, single, inputs):
    """The score-weighted mean (use_argmax=False) on chan=2 x grid=2: the
    weighted sums added over 'grid', the channel sums over 'chan' (JAX
    test_receiver_mesh_weighted_mean_matches_single): atol 1e-3 against
    the single-device port and the JAX mesh."""
    _same_on_every_rank(chan2_grid2, "weighted")
    got = chan2_grid2[0]["weighted.fixes"]
    np.testing.assert_allclose(got, single("weighted")["fixes"], rtol=0,
                               atol=1e-3)
    jrx = _jax_rx(inputs, "s8", (2, 2), use_argmax=False)
    jrx.run_batched(6, lookahead=3)
    np.testing.assert_allclose(got, _fixes(jrx), rtol=0, atol=1e-3)


@pytest.mark.parametrize("case,run,kw", [
    ("integrated", "run_integrated", dict(n_batches=2, blocks_per_fix=4)),
    ("fft", "run", dict(n_blocks=3)),
])
def test_receiver_chan2_grid2(chan2_grid2, single, inputs, case, run, kw):
    """The channel split on the integrated (block-summed surfaces summed
    over 'chan') and FFT-engine (cuFFT over the channel shard) paths:
    fixes within 1e-6 m of the single-device port and of the JAX mesh."""
    _same_on_every_rank(chan2_grid2, case)
    got = chan2_grid2[0][f"{case}.fixes"]
    np.testing.assert_allclose(got, single(case)["fixes"], rtol=0,
                               atol=1e-6)
    cfg = dict(engine="fft") if case == "fft" else {}
    jrx = _jax_rx(inputs, "s8", (2, 2), **cfg)
    getattr(jrx, run)(**kw)
    np.testing.assert_allclose(got, _fixes(jrx), rtol=0, atol=1e-6)


def test_survey_joint_pass_chan2_grid2(chan2_grid2, single):
    """The survey's joint passes with the channels split: each rank's
    channels' surfaces on its rows, summed over 'chan'; within one
    fine-lattice step of the single-device port (a float32 tie on the
    U/clock ridge may move the argmax by one), peaks rtol 1e-5."""
    _same_on_every_rank(chan2_grid2, "survey")
    got, want = chan2_grid2[0], single("survey")
    np.testing.assert_allclose(got["survey.x_ecef"][:4], want["x_ecef"][:4],
                               rtol=0, atol=0.25 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(got["survey.x_ecef"][4:], want["x_ecef"][4:],
                               rtol=0, atol=0.02 * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(got["survey.peaks"], want["peaks"],
                               rtol=1e-5)


def test_twelve_channels_on_chan4(chan4, single, inputs):
    """C = 12 on chan=4 (3 channels a rank; JAX
    test_twelve_channel_scenario_chan_mesh): fixes within 1e-6 m of the
    single-device port and of the JAX mesh."""
    _same_on_every_rank(chan4, "chan12")
    got = chan4[0]["chan12.fixes"]
    assert got.shape == (8, 8)
    np.testing.assert_allclose(got, single("chan12")["fixes"], rtol=0,
                               atol=1e-6)
    jrx = _jax_rx(inputs, "s12", (4, 1))
    jrx.run_batched(8, lookahead=4)
    np.testing.assert_allclose(got, _fixes(jrx), rtol=0, atol=1e-6)


def test_receiver_refuses_a_mesh_on_another_device(inputs):
    m = pmesh.make_mesh(device="cpu")
    try:
        m.device = torch.device("meta")
        with pytest.raises(ValueError, match="mesh's ranks run on"):
            tmodel.DPEReceiver(
                SampleFile(samples=np.load(inputs / "s8.npy"), fs=FS),
                read_handoff(str(inputs / "s8.csv")),
                config=tmodel.DPEConfig(mesh=m), device="cpu")
    finally:
        m.close()


# -- the launcher -------------------------------------------------------------


def test_launcher_two_processes_end_to_end(tmp_path, inputs):
    """parallel/launch.py as its users start it, two processes on gloo
    (JAX test_two_process_global_mesh_matches_single): both print the
    single-device port's final fix, and --bench-only its stats."""
    cap, hand = inputs / "s8.dat", inputs / "s8.csv"
    rx = tmodel.DPEReceiver(SampleFile(str(cap), fs=FS),
                            read_handoff(str(hand)), device="cpu")
    rx.run_batched(6)
    want = [float(v) for v in rx.fixes[-1].x_ecef[:3]]

    def argv(tail):
        return lambda r: [sys.executable, "-m",
                          "navlab_dpe_sdr_tpu_torch.parallel.launch",
                          "--coordinator", f"file://{tmp_path}/rdv",
                          "--num-processes", "2", "--process-id", str(r),
                          "--device", "cpu", *tail]

    logs = _launch(argv(["--capture", str(cap), "--handoff", str(hand),
                         "--blocks", "6", "--batched"]), 2, tmp_path)
    import json
    for r, text in enumerate(logs):
        line = [ln for ln in text.splitlines()
                if ln.startswith(f"[proc {r}] final fix ")][-1]
        assert json.loads(line.split("final fix ", 1)[1]) == want, text


def test_scaling_bench_without_and_with_a_mesh():
    """launch.scaling_bench's single-device path and its one-rank mesh
    path on the CPU (the grid points per second it reports are the CPU's,
    a shape check here)."""
    st = launch.scaling_bench(None, n_iters=1, n_blocks=2, n_chan_sig=2,
                              device="cpu")
    assert st["devices"] == 1 and st["device"] == "cpu"
    assert st["grid_points_per_s"] > 0 and st["sec_per_block"] > 0
    m = pmesh.make_mesh(device="cpu")
    try:
        st = launch.scaling_bench(m, n_iters=1, n_blocks=2, n_chan_sig=2)
        assert st["devices"] == 1 and m.collectives > 0
    finally:
        m.close()


def test_cli_under_torchrun_two_ranks(tmp_path, inputs):
    """`torchrun --standalone --nproc-per-node 2 -m navlab_dpe_sdr_tpu_torch
    dpe ... --mesh grid=2` on the CPU: each rank joins the launcher's
    group, the fixes equal the one-process run's, and only rank 0 writes
    the nav CSV and prints the final fix."""
    cap, hand = inputs / "s8.dat", inputs / "s8.csv"
    common = ["--device", "cpu", "dpe", str(cap), "--handoff", str(hand),
              "--blocks", "6", "--batched", "--lookahead", "3"]
    one = tmp_path / "one.csv"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "navlab_dpe_sdr_tpu_torch",
                          *common, "--out", str(one)], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=LAUNCH_S)
    assert res.returncode == 0, res.stderr[-3000:]
    two = tmp_path / "two.csv"
    logs = _launch(lambda r: [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "2", "-m", "navlab_dpe_sdr_tpu_torch", *common,
        "--out", str(two), "--mesh", "grid=2"], 1, tmp_path)
    assert two.read_text() == one.read_text()
    assert logs[0].count("final fix:") == 1, logs[0][-3000:]
    assert "mesh: {'chan': 1, 'grid': 2} over 2 rank(s)" in logs[0]
