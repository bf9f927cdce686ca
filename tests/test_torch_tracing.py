"""The port's span recorder (navlab_dpe_sdr_tpu_torch/tracing.py) and the
spans of its three traced paths: the batched DPE receiver, the per-block
step and the cold start.

The recorder alone: when it records, the profiler's flag it reads, nesting,
threads, and its bound. Then each path once untraced and once under
`tracing.recording()`, on a 1.1 s capture of the scenario and a 5^4 grid on
the CPU: the untraced runs leave the recorder empty, the recorded ones name
each span the expected number of times in the expected order, and both give
the same bits.
"""

import contextlib
import copy
import sys
import threading
from collections import Counter, deque

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch import tracing
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid
from navlab_dpe_sdr_tpu_torch.models.scalar import LOG_FIELDS, ScalarReceiver

torch.set_num_threads(2)

FS = 2.5e6
SECONDS = 1.1
BLOCKS, LOOKAHEAD, GROUP_K = 20, 10, 5       # two dispatches
STEPS = 50
TRACK_MS, CHUNK_MS = 400, 200                # two tracking chunks


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("how", ["none", "recording", "profiler"])
def test_records_only_under_a_profiler_or_recording(how):
    ctx = {"none": contextlib.nullcontext(),
           "recording": tracing.recording(),
           "profiler": torch.profiler.profile(
               activities=[torch.profiler.ProfilerActivity.CPU])}[how]
    with ctx:
        with tracing.span("a"):
            pass
    with tracing.span("after"):
        pass
    got = [s.name for s in tracing.spans()]
    assert got == ([] if how == "none" else ["a"])
    assert tracing.dropped() == 0


@pytest.mark.parametrize("flag", ["module", "query"])
def test_profiler_flag_follows_a_running_profiler(flag):
    """The flag the recorder reads, and the profiler's own query that it
    falls back on where torch lacks the flag: false, true while a profiler
    runs, false again once it stops."""
    on = tracing.profiler_flag(
        torch.autograd.profiler if flag == "module" else object())
    seen = [on()]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        seen.append(on())
    seen.append(on())
    assert seen == [False, True, False]


def test_nested_spans_record_inner_first_within_outer():
    with tracing.recording():
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
            with tracing.span("inner"):
                pass
        with tracing.span("alone"):
            pass
    a, b, outer, alone = tracing.spans()
    assert [s.name for s in (a, b, outer, alone)] == [
        "inner", "inner", "outer", "alone"]
    assert outer.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= outer.t1 <= alone.t0
    assert [s.name for s in tracing.spans("inner")] == ["inner", "inner"]


def test_threads_recording_at_once_lose_no_record():
    """Eight threads nest spans at once, the interpreter switching threads
    every microsecond: every record is kept, each thread's in its order."""
    n_threads, n_each = 8, 300

    def work(i):
        for _ in range(n_each):
            with tracing.span(f"outer{i}"):
                with tracing.span(f"inner{i}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = tracing.spans()
    assert len(recs) == 2 * n_threads * n_each and tracing.dropped() == 0
    for i in range(n_threads):
        inner = tracing.spans(f"inner{i}")
        outer = tracing.spans(f"outer{i}")
        assert len(inner) == len(outer) == n_each
        for a, b in zip(inner, outer):
            assert b.t0 <= a.t0 <= a.t1 <= b.t1
        assert all(x.t1 <= y.t0 for x, y in zip(outer, outer[1:]))


def test_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_records", deque(maxlen=4))
    with tracing.recording():
        for k in range(10):
            with tracing.span(f"s{k}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s6", "s7", "s8", "s9"]
    assert tracing.dropped() == 6
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
    with tracing.recording():
        for k in range(3):
            with tracing.span(f"s{k}"):
                pass
    assert len(tracing.spans()) == 3 and tracing.dropped() == 0


# -- the receiver's paths ---------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    sim, hand, arr = make_scenario(nav_data=True)
    n = int(SECONDS * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    grid = uniform_grid(n=5, pos_spacing=15.0, vel_spacing=1.0)
    return samples, hand, arr, grid


def _dpe(capture, handoff=None, eph=None):
    samples, hand, arr, grid = capture
    return DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                       handoff or copy.deepcopy(hand), grid=grid,
                       eph=eph or copy.deepcopy(arr),
                       config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                       device="cpu")


def _batched(capture):
    rx = _dpe(capture)
    raw = torch.from_numpy(capture[0].view(np.int16).reshape(-1, 50000, 2))
    rx.run_batched(BLOCKS, lookahead=LOOKAHEAD, raw_blocks_dev=raw,
                   pipeline=True, group_k=GROUP_K, pipeline_depth=2)
    return rx


def _steps(capture):
    rx = _dpe(capture)
    rx.run(STEPS)
    return rx


def _cold_start(capture):
    """Acquire, track two chunks, the scenario's ephemerides anchored in
    the tracker's own code-period count (the scenario's anchors count 1000
    periods at sample 0), the handoff, a DPE receiver and its first fix."""
    samples, hand, arr, _ = capture
    rx = ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                        hand.prn_list, device="cpu")
    rx.acquire(verbose=False)
    rx.track(TRACK_MS, chunk_ms=CHUNK_MS)
    ephs = {}
    for e in arr.ephs:
        e = copy.deepcopy(e)
        e.cp_timestamp -= 1000.0
        ephs[e.prn] = e
    rx.set_ephemerides(ephs)
    drx = _dpe(capture, rx.save_handoff(""), rx.eph_array())
    drx.run(1)
    return rx, drx


def _fixes(rx):
    return (np.array([f.x_ecef for f in rx.fixes]),
            np.array([(f.pos_score, f.vel_score) for f in rx.fixes]),
            np.array(rx.flip_log))


def _run(capture, record: bool):
    """Each path from a fresh receiver, with the recorder emptied before
    it: ({path: results}, {path: the records it left})."""
    out, recs = {}, {}
    for path, run in (("batched", _batched), ("steps", _steps),
                      ("cold_start", _cold_start)):
        tracing.clear()
        with tracing.recording() if record else contextlib.nullcontext():
            got = run(capture)
        recs[path] = tracing.spans()
        if path == "cold_start":
            rx, drx = got
            out[path] = ({p: {k: rx.channels[p].col(k) for k in LOG_FIELDS}
                          for p in rx.prn_list},
                         {p: rx.channels[p].cp_sign for p in rx.prn_list},
                         _fixes(drx))
        else:
            out[path] = _fixes(got)
    tracing.clear()
    return out, recs


@pytest.fixture(scope="module")
def runs(capture):
    """(untraced, recorded) runs of every path."""
    return _run(capture, False), _run(capture, True)


def _counts(recs):
    return Counter(s.name for s in recs)


def _named(recs, name):
    return [s for s in recs if s.name == name]


def _in_order(*spans):
    """Each span ends before the next starts."""
    return all(a.t0 <= a.t1 <= b.t0 <= b.t1 for a, b in zip(spans, spans[1:]))


def test_untraced_paths_leave_the_recorder_empty(runs):
    (_, recs), _ = runs
    assert recs == {"batched": [], "steps": [], "cold_start": []}


def test_batched_run_records_each_dispatch_span_once(runs):
    _, (_, recs) = runs
    recs = recs["batched"]
    n = BLOCKS // LOOKAHEAD
    assert _counts(recs) == {
        "dpe.build.windows": 1, "dpe.build.upload": 1, "dpe.prepare": n,
        "dpe.dispatch.coherent_sum": n, "dpe.dispatch.score": n,
        "dpe.drain.wait": n, "dpe.drain.update": n}
    # a dispatch prepares, sums and scores in turn; a drain waits, then
    # updates
    for prep, csum, score in zip(_named(recs, "dpe.prepare"),
                                 _named(recs, "dpe.dispatch.coherent_sum"),
                                 _named(recs, "dpe.dispatch.score")):
        assert _in_order(prep, csum, score)
    for wait, update in zip(_named(recs, "dpe.drain.wait"),
                            _named(recs, "dpe.drain.update")):
        assert _in_order(wait, update)


def test_step_records_prep_device_and_update_once_a_step(runs):
    _, (_, recs) = runs
    recs = recs["steps"]
    assert _counts(recs) == {
        "dpe.build.windows": 1, "dpe.build.upload": 1,
        "dpe.step.prep": STEPS, "dpe.step.device": STEPS,
        "dpe.step.wait": STEPS, "dpe.step.update": STEPS}
    # the three phases follow one another, the wait inside the device's
    phases = [s for s in recs if s.name.startswith("dpe.step.")]
    for k in range(STEPS):
        prep, wait, device, update = phases[4 * k:4 * k + 4]
        assert (prep.name, wait.name, device.name, update.name) == (
            "dpe.step.prep", "dpe.step.wait", "dpe.step.device",
            "dpe.step.update")
        assert _in_order(prep, device, update)
        assert device.t0 <= wait.t0 <= wait.t1 <= device.t1


def test_cold_start_records_acquire_each_chunk_and_the_build(runs):
    _, (_, recs) = runs
    recs = recs["cold_start"]
    chunks = TRACK_MS // CHUNK_MS
    assert _counts(recs) == {
        "scalar.acquire.search": 1, "scalar.track.stage": chunks,
        "scalar.track.fetch": chunks, "scalar.track.unpack": chunks,
        "dpe.build.windows": 1, "dpe.build.upload": 1, "dpe.step.prep": 1,
        "dpe.step.device": 1, "dpe.step.wait": 1, "dpe.step.update": 1}
    # a chunk's log is fetched, then unpacked; the next chunk is staged
    # before this one's log is fetched
    stages, fetches, unpacks = (_named(recs, n) for n in (
        "scalar.track.stage", "scalar.track.fetch", "scalar.track.unpack"))
    for k in range(chunks):
        assert _in_order(stages[k], fetches[k], unpacks[k])
        if k + 1 < chunks:
            assert _in_order(stages[k + 1], fetches[k])
    (search,), (windows,), (upload,) = (_named(recs, n) for n in (
        "scalar.acquire.search", "dpe.build.windows", "dpe.build.upload"))
    assert _in_order(search, stages[0]) and _in_order(unpacks[-1], windows,
                                                       upload)


def test_recording_changes_no_result(runs):
    (quiet, _), (loud, _) = runs
    for path in ("batched", "steps"):
        for a, b in zip(quiet[path], loud[path]):
            np.testing.assert_array_equal(a, b)
    (logs_q, signs_q, fix_q), (logs_l, signs_l, fix_l) = (
        quiet["cold_start"], loud["cold_start"])
    for p in logs_q:
        for k in LOG_FIELDS:
            np.testing.assert_array_equal(logs_q[p][k], logs_l[p][k])
        np.testing.assert_array_equal(signs_q[p], signs_l[p])
    for a, b in zip(fix_q, fix_l):
        np.testing.assert_array_equal(a, b)
    assert len(quiet["batched"][0]) == BLOCKS // GROUP_K
    assert len(quiet["steps"][0]) == STEPS
