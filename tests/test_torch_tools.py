"""The ported stage tools (tools/*_torch.py) on the CPU, at tiny sizes.

Each tool's `main` prints its JAX original's JSON keys (taken from the
original's source) plus `card`, "cpu" here; run without `--device cpu` on a
host without a card, each raises naming the missing CUDA device. The spread
grid is swapped for a 4^4 one and the bench's 50-block lookahead for 5, so
that a tool runs in seconds here; the capture is the bench's own
(`bench.bench_capture`), cached in a temporary directory (the dynamics
envelope synthesizes its three moving-receiver captures there; live_run
runs the `live` subcommand in a child interpreter on 0.8 s of it). No new
file of the port's bench or tools imports JAX or the JAX package.
"""

import ast
import importlib
import json
import pathlib
import re
import sys

import pytest
import torch

from navlab_dpe_sdr_tpu_torch import bench
from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
sys.path.insert(0, str(TOOLS))

# each tool's keys as its JAX original prints them
ORIGINAL_KEYS = {
    "stage_timing": [
        "variant", "warmup_s", "times_s", "ms_per_dispatch", "ms_per_block",
        "grid_points", "code_win", "carr_win", "n_blocks", "k", "check"],
    "perblock_decompose": [
        "n_blocks", "repeats", "stat", "e2e_depth1", "e2e_depth1_minmax",
        "e2e_depth2", "e2e_depth2_minmax", "e2e_depth4", "e2e_depth4_minmax",
        "host_prep", "drain_host", "dispatch", "corr", "scoring",
        "residual_depth4", "rtf_e2e_depth4", "rtf_dispatch_floor"],
    "host_residue": [
        "n_blocks", "dispatches", "wall_ms_per_dispatch", "dispatch_host_ms",
        "drain_ms", "other_ms", "rtf_segment"],
    "dense_bench": [
        "grid_points", "grid_axis_n", "sec_per_block", "grid_points_per_s",
        "grid_point_channel_evals_per_s", "realtime_factor", "backend",
        "device", "blocks_per_dispatch", "coherent_integration_k", "memory",
        "note"],
    "survey_bench": [
        "backend", "n_blocks", "n_batches", "signal_seconds", "wall_s",
        "survey_err_m", "survey_err_enu_m", "survey_clk_err_m",
        "survey_vel_err_ms", "per_batch_median_err_m", "per_batch_p95_err_m",
        "sigma_pos_enu_clk_m", "sigma_vel", "zoom_interp", "fine_spacing_m",
        "fine_n"],
    "soak": [
        "signal_minutes", "wall_s", "scalar_fix_first_last_m",
        "scalar_fix_median_m", "scalar_err_drift_m_per_min",
        "scalar_clk_drift_m_per_min", "dpe_fix_median_m",
        "dpe_err_drift_m_per_min", "rss_first_last_mb",
        "rss_growth_mb_per_min", "scalar_series", "dpe_series",
        "rss_series"],
    # the top level, a profile's and a cell's keys
    "dynamics_envelope": [
        "seconds", "lookahead", "hold_threshold_median_last5s_m",
        "profiles", "speed_mps", "clock_drift", "cells", "depth", "group_k",
        "median_m", "p95_m", "median_last5s_m", "held", "rtf", "n_fixes"],
    # live_run.py prints no dict of its own: the JAX CLI `live` record's
    # keys, those of LIVE_r03.json
    # a row's keys and the --all table's (grid_points_per_s, sec_per_block
    # and devices are scaling_bench's, held by the row tests below)
    "scaling_table": [
        "mesh", "chan", "grid", "n_chan_sig", "cores", "efficiency_vs_1dev",
        "grid_points_per_block", "grid_scale", "rows",
        "best_efficiency_per_devices", "metric", "methodology", "regimes"],
    "live_run": [
        "signal_seconds", "wall_seconds", "blocks", "iterations",
        "lookahead", "budget_ms", "avg_compute_ms", "max_compute_ms",
        "rt_misses", "watchdog_s", "margin_x", "server_behind_max_ms", "fs"],
}
# (tool, tiny argv, module constants to shrink); dense_bench twice: per
# block and integrated
CASES = [
    ("stage_timing", ["--n", "5", "--k", "1"], {}),
    ("perblock_decompose", ["--blocks", "5", "--repeats", "1"],
     {"LOOKAHEAD": 5, "STAGE_K": 1}),
    ("host_residue", ["10", "2"], {"LOOKAHEAD": 5}),
    ("dense_bench", ["--n", "3", "--blocks", "1", "--iters", "1"], {}),
    ("dense_bench", ["--n", "3", "--integrate", "2", "--iters", "1"], {}),
    ("survey_bench", ["--blocks", "4", "--batch", "2", "--fine-n", "3"], {}),
    ("soak", ["--minutes", "0.01"], {"CHUNK_S": 0.2}),
    ("dynamics_envelope", ["--seconds", "0.6"],
     {"LOOKAHEAD": 5, "SETTLE_S": 0.1, "LAST_S": 0.2}),
    # the rest is passed through to the `live` subcommand, as
    # tests/test_runtime.py drives the JAX CLI
    ("live_run", ["--seconds", "0.8", "--lookahead", "10", "--watchdog",
                  "60", "--grid", "uniform", "--grid-n", "7"], {}),
]


def _literal_keys(path: pathlib.Path) -> set:
    """String keys of every dict literal and `x["key"] =` in a source."""
    keys = set()
    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Dict):
            keys |= {k.value for k in n.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store) \
                and isinstance(n.slice, ast.Constant):
            keys.add(n.slice.value)
    return keys


@pytest.mark.parametrize("tool", sorted(ORIGINAL_KEYS))
def test_original_keys_are_the_originals(tool):
    """The key lists above are the JAX tools' own: literal keys of their
    sources, and perblock_decompose's f"e2e_depth{depth}" pair; live_run's
    are LIVE_r03.json's, all of them literal keys of the JAX CLI."""
    if tool == "live_run":
        keys = json.loads((REPO / "LIVE_r03.json").read_text())
        assert sorted(keys) == sorted(ORIGINAL_KEYS[tool])
        cli = _literal_keys(REPO / "navlab_dpe_sdr_tpu" / "cli.py")
        assert set(keys) <= cli, set(keys) - cli
        return
    path = TOOLS / f"{tool}.py"
    src = path.read_text()
    literal = _literal_keys(path)
    for key in ORIGINAL_KEYS[tool]:
        if re.fullmatch(r"e2e_depth\d(_minmax)?", key):
            assert re.sub(r"depth\d", "depth{depth}", key) in src, key
        else:
            assert key in literal, key


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """The bench capture's cache with 30 blocks, long enough for every
    case (each reads the first blocks it needs)."""
    d = str(tmp_path_factory.mktemp("fixtures"))
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "CACHE_DIR", d)
    try:
        bench.bench_capture(30)
    finally:
        mp.undo()
    return d


def _all_keys(out: dict, tool: str) -> set:
    """The keys of `out`; for dynamics_envelope also every profile's and
    every cell's."""
    keys = set(out)
    if tool == "dynamics_envelope":
        for prof in out["profiles"].values():
            keys |= set(prof)
            for cell in prof["cells"]:
                keys |= set(cell)
    return keys


def _tool(name):
    return importlib.import_module(f"{name}_torch")


@pytest.mark.parametrize("tool,argv,consts", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_tool_prints_original_keys_on_cpu(tool, argv, consts, cache_dir,
                                          monkeypatch, capsys):
    mod = _tool(tool)
    tiny = uniform_grid(n=4, pos_spacing=10.0, vel_spacing=1.0)
    monkeypatch.setattr(bench, "CACHE_DIR", cache_dir)
    for m in (mod, _tool("stage_timing")):
        if hasattr(m, "spread_grid"):
            monkeypatch.setattr(m, "spread_grid", lambda: tiny)
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    assert mod.main([*argv, "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines
    for line in lines:           # stage_timing: one line a variant
        out = json.loads(line)
        missing = set(ORIGINAL_KEYS[tool]) - _all_keys(out, tool)
        assert not missing, missing
        assert out["card"] == "cpu"
        if "backend" in out:
            assert out["backend"] == "cpu"
    if tool == "stage_timing":
        assert [json.loads(ln)["variant"] for ln in lines] == \
            ["full", "corr", "full_g5"]
        full, corr = (json.loads(ln) for ln in lines[:2])
        assert (full["code_win"], full["carr_win"]) == \
            (corr["code_win"], corr["carr_win"])     # the same correlation
        assert corr["grid_points"] == 256
        assert full["device_busy_ms"] is None        # not measured here
    if tool == "dense_bench":
        assert out["device"] == "cpu" and out["memory"] is None
    if tool == "soak":
        assert out["cuda_series"] is None
        assert len(out["scalar_series"]) == 3 and len(out["dpe_series"]) == 3
    if tool == "dynamics_envelope":
        assert sorted(out["profiles"]) == ["clock", "vehicle", "walk"]
        for prof in out["profiles"].values():
            assert [(c["depth"], c["group_k"]) for c in prof["cells"]] == \
                [(d, k) for d in (1, 2, 4) for k in (1, 5)]
            # 30 blocks; grouped cells trimmed to whole dispatches of 5 x 5
            assert [c["n_fixes"] for c in prof["cells"]] == [30, 5] * 3
        assert out["profiles"]["vehicle"]["speed_mps"] == 13.75
    if tool == "live_run":
        assert out["blocks"] == 40 and out["iterations"] == 4
        assert out["device"] == "cpu" and out["lookahead"] == 10


@pytest.mark.parametrize("tool", sorted(ORIGINAL_KEYS))
def test_tool_without_a_card_raises(tool):
    """(bench.main's refusal: tests/test_torch_bench.py)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool(tool).main([])


def test_bench_and_tools_import_no_jax():
    pat = re.compile(r"^\s*(from|import)\s+(navlab_dpe_sdr_tpu|jax|jaxlib)"
                     r"(\.|\s|$)", re.M)
    files = [REPO / "bench_torch.py",
             REPO / "navlab_dpe_sdr_tpu_torch" / "bench.py"]
    files += sorted(TOOLS.glob("*_torch.py"))
    assert len(files) == 12
    bad = [f.name for f in files if pat.search(f.read_text())]
    assert not bad, bad


ROW_KEYS = {"grid_points_per_s", "sec_per_block", "devices", "mesh",
            "n_chan_sig", "cores"}


@pytest.mark.parametrize("chan", [1, 2])
def test_scaling_table_two_ranks_on_cpu(chan, capsys):
    """`scaling_table_torch.py --device cpu --devices 2 --c 2 --iters 1`:
    two gloo ranks, each pinned to a core, print one row; with --chan 2
    the two ranks split the channels."""
    tool = _tool("scaling_table")
    assert tool.main(["--device", "cpu", "--devices", "2", "--c", "2",
                      "--iters", "1", "--chan", str(chan)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert ROW_KEYS <= set(row)
    assert row["devices"] == 2 and row["cores"] == 2
    assert row["mesh"] == {"chan": chan, "grid": 2 // chan}
    assert row["n_chan_sig"] == 2 and row["grid_points_per_s"] > 0


def test_scaling_table_all_writes_the_table(tmp_path, monkeypatch, capsys):
    """--all over 1 and 2 ranks and one grid scale: every row with its
    efficiency against one rank, the best efficiency per rank count."""
    tool = _tool("scaling_table")
    monkeypatch.setattr(tool, "GRID_SCALES", (1,))
    monkeypatch.setattr(tool, "RANK_COUNTS", (1, 2))
    out = tmp_path / "scaling.json"
    assert tool.main(["--device", "cpu", "--all", "--iters", "1",
                      "--out", str(out)]) == 0
    table = json.loads(out.read_text())
    (regime,) = table["regimes"]
    assert regime["grid_points_per_block"] == 2 * 390625
    rows = regime["rows"]
    assert [(r["devices"], r["mesh"]["chan"]) for r in rows] == \
        [(1, 1), (2, 1), (2, 2)]
    assert rows[0]["efficiency_vs_1dev"] == 1.0
    assert all(ROW_KEYS | {"efficiency_vs_1dev"} <= set(r) for r in rows)
    assert sorted(regime["best_efficiency_per_devices"]) == ["1", "2"]
    assert table["cpu"] and table["host_cores"] >= 2


def test_scaling_table_rank_failure_exits_with_its_stderr(capsys):
    """A rank that fails (no blocks to time) ends the measurement with a
    non-zero exit, its standard error on ours: no row is made up."""
    tool = _tool("scaling_table")
    with pytest.raises(SystemExit, match="2 ranks failed"):
        tool.measure(2, 1, 1, n_chan_sig=2, n_blocks=0)
    err = capsys.readouterr().err
    assert "rank 0 exited 1" in err and "rank 1 exited 1" in err
    assert "Traceback" in err and "IndexError" in err


def test_scaling_table_card_row_is_one_card_only():
    """--device cuda measures one card: more ranks or --all are refused
    before anything runs (no figure across cards)."""
    tool = _tool("scaling_table")
    for argv in (["--devices", "2"], ["--all"], ["--chan", "2"]):
        with pytest.raises(SystemExit):
            tool.main(["--device", "cuda", *argv])


@pytest.mark.cuda
def test_scaling_table_one_card_row(capsys):
    """On the card: the one-card row (mesh=None, then one NCCL rank), named
    by nvidia-smi, with no efficiency."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert _tool("scaling_table").main(["--iters", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ROW_KEYS <= set(row) and "efficiency_vs_1dev" not in row
    assert row["devices"] == 1 and row["mesh"] is None
    assert row["label"] == "one card" and row["card"] != "cpu"
    w1 = row["nccl_world_1"]
    assert w1["mesh"] == {"chan": 1, "grid": 1} and w1["backend"] == "nccl"
    assert w1["devices"] == 1 and w1["grid_points_per_s"] > 0
    assert w1["collectives"] > 0
