"""The port's bench (navlab_dpe_sdr_tpu_torch/bench.py) against bench.py
and the JAX receiver, and its correlator oracle against the JAX one, on the
CPU.

- bench.py's JSON keys, read from its source with `ast` (JAX is not run),
  are the port's `BENCH_PY_KEYS`; the parity block's are `_parity_block`'s
  plus `kernels`.
- The bench's capture is bench.py's, sample for sample.
- `bench.run` on a 30-block capture of the bench scenario with a 7^4
  grid (lookahead 5, group_k 5, one pass, 10 per-block blocks): every key,
  `card` "cpu", and the pass's fix errors equal, to 1e-6 m, those of the
  JAX receiver driven through the same warm-up, per-block and grouped
  `run_batched` calls (fixes are lattice offsets filtered in float64:
  equal argmaxes give fixes equal to 1e-6 m, tests/test_torch_dpe.py).
- `windowed_correlate_direct` against JAX's `_windowed_correlate_direct`
  on one block of the bench scenario: windows within 1e-5 of each
  channel's maximum, flips equal; against the port's plain
  `windowed_correlate`, bench.py's four parity relations.
- Without a card, `bench.main` raises naming the missing CUDA device.
"""

import ast
import copy
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.rawfile import SampleFile as JSampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario as j_make_scenario
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import uniform_grid as j_uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu_torch import bench
from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid
from navlab_dpe_sdr_tpu_torch.ops import correlate

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
LOOKAHEAD, GROUP_K, N_SHORT = 5, 5, 10
N_BLOCKS = 20                       # after the 2 * LOOKAHEAD warm-up blocks


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """30 blocks of the bench scenario from the bench's own capture path
    (cached in a temporary directory)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "CACHE_DIR", str(tmp_path_factory.mktemp("fixtures")))
    try:
        samples, hand, arr = bench.bench_capture(N_BLOCKS + 2 * LOOKAHEAD)
        again = bench.bench_capture(N_BLOCKS + 2 * LOOKAHEAD)[0]
    finally:
        mp.undo()
    np.testing.assert_array_equal(again, samples)        # read from the cache
    # bench.py's capture: synthesized in one piece
    sim, *_ = j_make_scenario(nav_data=True, cn0_dbhz=47.0)
    iq = sim.generate(samples.shape[0])
    np.testing.assert_array_equal(samples["i"], np.clip(np.round(iq.real),
                                                        -32768, 32767))
    np.testing.assert_array_equal(samples["q"], np.clip(np.round(iq.imag),
                                                        -32768, 32767))
    return samples, hand, arr


def _bench_py_json_keys():
    """(keys of the dict bench.py passes to json.dumps, keys of
    _parity_block's `out` outside its except handlers)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    dumps = [n for n in ast.walk(funcs["main"])
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
             == "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    assert len(dumps) == 1
    keys = [k.value for k in dumps[0].args[0].keys]
    par = funcs["_parity_block"]
    handled = {id(n) for h in ast.walk(par)
               if isinstance(h, ast.ExceptHandler) for n in ast.walk(h)}
    out = []
    for n in ast.walk(par):
        if isinstance(n, ast.Assign) and id(n) not in handled:
            t = n.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" \
                    and isinstance(n.value, ast.Dict):
                out += [k.value for k in n.value.keys]
            elif isinstance(t, ast.Subscript) and getattr(
                    t.value, "id", "") == "out":
                out.append(t.slice.value)
    return keys, out


def test_bench_keys_are_bench_py_keys():
    keys, parity = _bench_py_json_keys()
    assert list(bench.BENCH_PY_KEYS) == keys
    assert len(keys) == 19 and "parity" in keys and "ttff" in keys
    assert set(bench.PARITY_KEYS) == set(parity) | {"kernels"}
    assert "pallas_score_max_rel" in parity


def _jax_pass(samples, grid):
    """bench.py's timed pass on the JAX receiver: fix errors [m]."""
    _, hand, arr = j_make_scenario(nav_data=True, cn0_dbhz=47.0)
    rx = jmodel.DPEReceiver(
        JSampleFile(samples=samples.copy(), fs=bench.FS), copy.deepcopy(hand),
        grid=grid, eph=copy.deepcopy(arr),
        config=jmodel.DPEConfig(ekf_mode="alpha", ekf_alpha=0.3))
    raw = jnp.asarray(samples.view(np.int16).reshape(-1, bench.S, 2))
    pipe = dict(lookahead=LOOKAHEAD, raw_blocks_dev=raw, pipeline=True,
                pipeline_depth=4)
    warmup = 2 * LOOKAHEAD
    rx.run_batched(warmup, start_block=0, **pipe)
    n_warm = len(rx.fixes)
    rx.run_batched(N_SHORT, start_block=warmup, **pipe)
    rx.run_batched(N_BLOCKS - N_SHORT, start_block=warmup + N_SHORT,
                   group_k=GROUP_K, **pipe)
    return [float(np.linalg.norm(f.x_ecef[0:3] - hand.x_ecef[0:3]))
            for f in rx.fixes[n_warm:]]


def test_bench_run_on_cpu_matches_jax_receiver(capture, monkeypatch):
    """One pass of the bench on the CPU (NAVLAB_BENCH_REPEATS=1; 10
    per-block blocks, not 200, so that both segments run; the scalar
    segment over 20 ms chunks instead of 2000 ms ones, so that it runs
    here); TTFF is skipped by the bench's own rule (a capture under 36 s)."""
    samples, hand, arr = capture
    monkeypatch.setattr(bench, "TRACK_CHUNK_MS", 20)
    monkeypatch.setattr(bench, "N_SHORT", N_SHORT)
    monkeypatch.setenv("NAVLAB_BENCH_REPEATS", "1")
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    errors = []
    res = bench.run(samples, hand, arr, grid, N_BLOCKS, lookahead=LOOKAHEAD,
                    group_k=GROUP_K, device="cpu", errors_out=errors)
    assert set(bench.BENCH_PY_KEYS) <= set(res)
    assert res["card"] == "cpu" and res["device_count"] == 0
    assert res["metric"] == "dpe_real_time_factor"
    assert res["unit"] == "x_realtime_2.5MHz_8prn_25^4grid"
    assert res["signal_seconds"] == pytest.approx(N_BLOCKS * 0.02)
    assert res["coherent_group_k"] == GROUP_K and res["pipeline_depth"] == 4
    assert res["grouped_fix_rate_hz"] == pytest.approx(10.0)
    assert res["value"] > 0 and res["value_minmax"][0] == res["value"]
    assert res["protocol"]["passes"] == 1
    assert res["ttff"]["skipped"].startswith("capture shorter")
    assert res["scalar_track_rtf"] > 0
    assert len(res["scalar_track_rtf_minmax"]) == 2
    assert res["launches"] == {"passes": {}, "scalar": {}}   # no kernel here
    par = res["parity"]
    assert set(par) == set(bench.PARITY_KEYS)
    assert par["backend"] == "cpu" and par["kernels"] == "not run: cpu"
    assert par["corr_flip_equal"] and par["corr_argmax_equal"]
    assert par["corr_code_max_rel"] < 1e-5
    assert par["corr_carr_max_rel"] < 1e-5
    assert par["pallas_score_max_rel"] == 0.0                # plain vs plain

    (errs,) = errors
    assert len(errs) == N_SHORT + (N_BLOCKS - N_SHORT) // GROUP_K
    assert res["fix_median_m"] == pytest.approx(float(np.median(errs)))
    assert res["fix_median_m_grouped"] == pytest.approx(
        float(np.median(errs[N_SHORT:])))
    want = _jax_pass(samples, j_uniform_grid(n=7, pos_spacing=15.0,
                                             vel_spacing=1.0))
    np.testing.assert_allclose(errs, want, rtol=0, atol=1e-6)


def _block_args(samples, block):
    """Capture block `block` with the JAX receiver's prep of it: the JAX
    direct form's arguments, the port's (CPU tensors), the keywords and the
    channels' nav-bit boundary samples."""
    _, jhand, jarr = j_make_scenario(nav_data=True, cn0_dbhz=47.0)
    grid = j_uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    rx = jmodel.DPEReceiver(
        JSampleFile(samples=samples[:(block + 2) * bench.S].copy(),
                    fs=bench.FS),
        jhand, grid=grid, eph=jarr, config=jmodel.DPEConfig())
    for _ in range(block):
        rx._prepare_block()
    fpk, ipk, *_ = rx._prepare_block()
    raw = samples[block * bench.S:(block + 1) * bench.S]
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=rx.S // rx.period, code_win=rx.code_win,
              carr_win=rx.carr_win)
    jargs = (jnp.asarray(raw["i"].astype(np.float32)),
             jnp.asarray(raw["q"].astype(np.float32)), rx._chips_f32,
             rx._base0, jnp.asarray(fpk[0]), jnp.asarray(ipk[0]),
             jnp.asarray(fpk[1]), jnp.asarray(fpk[2]), rx._time_idc,
             jnp.asarray(ipk[1]), jnp.asarray(ipk[2]))
    cap = torch.from_numpy(raw.view(np.int16).reshape(1, bench.S, 2).copy())
    f = torch.from_numpy(fpk.astype(np.float32))
    i = torch.from_numpy(ipk.astype(np.float32))
    targs = (cap[..., 0], cap[..., 1],
             torch.from_numpy(np.array(rx._chips_f32)), f[0][None],
             i[0][None], f[1][None], f[2][None],
             torch.from_numpy(np.array(rx._time_idc)), i[1][None],
             i[2][None])
    return jargs, targs, kw, ipk[0]


@pytest.mark.parametrize("complex_out", [False, True])
def test_direct_correlator_matches_jax_direct(capture, complex_out):
    jargs, targs, kw, _ = _block_args(capture[0], 0)
    want = jreal._windowed_correlate_direct(*jargs, **kw,
                                            complex_out=complex_out)
    got = correlate.windowed_correlate_direct(*targs, **kw,
                                              complex_out=complex_out)
    np.testing.assert_array_equal(got.flip_used[0].numpy(),
                                  np.asarray(want.flip_used))
    for name in got._fields[:-1]:
        a = getattr(got, name)[0].double().numpy()
        b = np.asarray(getattr(want, name), np.float64)
        rel = np.abs(a - b) / np.abs(b).max(axis=1, keepdims=True)
        assert rel.max() < 1e-5, (name, rel.max())


def test_direct_correlator_holds_plain_to_bench_relations(capture):
    """bench.py's parity relations between the port's plain correlator and
    the direct form, on the first block and on one whose channels hold a
    nav-bit boundary inside the block (idx_next < S)."""
    for k in (0, 1):
        _, targs, kw, idx_next = _block_args(capture[0], k)
        fast = correlate.windowed_correlate(*targs, **kw)
        direct = correlate.windowed_correlate_direct(*targs, **kw)
        assert bench._rel(fast.code_mag, direct.code_mag) < 1e-5
        assert bench._rel(fast.carr_mag, direct.carr_mag) < 1e-5
        assert torch.equal(fast.flip_used, direct.flip_used)
        assert torch.equal(fast.code_mag.argmax(-1),
                           direct.code_mag.argmax(-1))
    assert (idx_next < bench.S).any()


def test_bench_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["30"])
