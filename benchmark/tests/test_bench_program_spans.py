"""The readers of the program's own spans (metrics/program_spans.py and the
metrics built on it), on a LayerContext and records of the program's
recorder made by hand: only the spans inside the window count, the
lead-ins' and those after it do not, and a reader gives None where a span
it reads is missing, where the recorder dropped records, or where the
program has no recorder. Beside them, the two cold-start metrics that read
the harness's own span of one call."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from collections import deque

import pytest

from benchmark.harness.main import load_module
from benchmark.harness.trace import LayerContext
from navlab_dpe_sdr_tpu_torch import tracing

BENCH = Path(__file__).resolve().parents[1]

# metric: (the count it divides by, the spans it adds up)
READS = {
    "fetch_wait_ms_per_block.rtf": ("blocks", ("dpe.drain.wait",)),
    "fetch_wait_ms_per_block.rtf_dense": ("blocks", ("dpe.drain.wait",)),
    "host_self_ms_per_block.rtf": ("blocks",
                                   ("dpe.prepare", "dpe.drain.update")),
    "host_self_ms_per_block.rtf_dense": ("blocks", ("dpe.prepare",
                                                    "dpe.drain.update")),
    "coherent_sum_ms_per_block.rtf": ("blocks",
                                      ("dpe.dispatch.coherent_sum",)),
    "score_call_ms_per_block.rtf": ("blocks", ("dpe.dispatch.score",)),
    "step_prep_ms_per_fix.latency": ("steps", ("dpe.step.prep",)),
    "step_device_ms_per_fix.latency": ("steps", ("dpe.step.device",)),
    "step_update_ms_per_fix.latency": ("steps", ("dpe.step.update",)),
    "track_host_ms_per_start.ttff": ("starts", ("scalar.track.stage",
                                                "scalar.track.unpack")),
}
# metrics new beside them that read the harness's own span of one call
HARNESS_READS = {"dpe_build_ms_per_start.ttff": "dpe.build",
                 "acquire_ms_per_start.ttff": "scalar.acquire"}
COUNT = 4


def reader(metric):
    return load_module(BENCH / "metrics" / f"{metric}.py", "metrics", metric)


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def record(names, seconds):
    with tracing.recording():
        for name in names:
            with tracing.span(name):
                time.sleep(seconds)


def window(names, count=COUNT, lead_in=True, after=True):
    """Records of `names`: once in a lead-in, twice in the window, once
    after it; the context whose harness spans bound the window."""
    if lead_in:
        record(names, 0.003)
    t0 = time.perf_counter()
    record(names, 0.001)
    record(names, 0.001)
    t1 = time.perf_counter()
    if after:
        record(names, 0.003)
    spans = {"harness.outer": [(t0, t1)],
             "harness.inner": [(t0 + 1e-4, t1 - 1e-4)]}
    return LayerContext(10.0, 1.0, [], spans, {"blocks": count,
                                              "steps": count,
                                              "starts": count}, {}), t0, t1


def expected_ms(names, t0, t1, count=COUNT):
    return 1e3 * sum(s.t1 - s.t0 for s in tracing.spans()
                     if s.name in names and t0 <= s.t0 and s.t1 <= t1) / count


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_counts_only_the_window(metric):
    count, names = READS[metric]
    ctx, t0, t1 = window(names)
    got = reader(metric).read(ctx)
    want = expected_ms(names, t0, t1)
    assert got == pytest.approx(want, rel=1e-12)
    # two windowed spans of >= 1 ms a name; the lead-in's and the later
    # ones (>= 3 ms each) are out
    everything = 1e3 * sum(s.t1 - s.t0 for s in tracing.spans()) / COUNT
    assert 2 * len(names) / COUNT <= got < everything - 6 * len(names) / COUNT
    assert len(tracing.spans()) == 4 * len(names)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_none_for_a_missing_span(metric):
    count, names = READS[metric]
    for left_out in names:
        tracing.clear()
        ctx, _, _ = window([n for n in names if n != left_out])
        assert reader(metric).read(ctx) is None
    tracing.clear()
    ctx, _, _ = window(names, lead_in=False, after=False)
    assert reader(metric).read(ctx) is not None
    ctx.counts[count] = 0
    assert reader(metric).read(ctx) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_none_when_records_were_dropped(metric, monkeypatch):
    _, names = READS[metric]
    monkeypatch.setattr(tracing, "_records",      # the lead-in falls out
                        deque(maxlen=2 * len(names)))
    ctx, _, _ = window(names, after=False)
    assert tracing.dropped() == len(names)
    assert reader(metric).read(ctx) is None


def test_readers_give_none_without_the_programs_recorder(monkeypatch):
    """An older checkout of the program has no `tracing` module."""
    import navlab_dpe_sdr_tpu_torch

    names = sorted({n for _, ns in READS.values() for n in ns})
    ctx, _, _ = window(names)
    monkeypatch.delattr(navlab_dpe_sdr_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "navlab_dpe_sdr_tpu_torch.tracing", None)
    for metric in READS:
        assert reader(metric).read(ctx) is None


def test_every_program_span_metric_is_read_here():
    """The table above is every metric whose reader reads the program's
    spans."""
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    found = set()
    for m in man["per_layer"]:
        body = sys.modules[reader(m["name"]).read.__module__].__file__
        if "program_spans" in Path(body).read_text():
            found.add(m["name"])
    assert found == set(READS)


@pytest.mark.parametrize("metric", sorted(HARNESS_READS))
def test_harness_span_reader_reads_the_windows_calls(metric):
    """The harness's spans of the window over its cold starts, in ms; None
    where the call never ran or no start completed. The program's own
    records do not count."""
    name = HARNESS_READS[metric]
    record([name], 0.002)
    ctx = LayerContext(10.0, 1.0, [], {name: [(1.0, 1.25), (2.0, 2.5)],
                                       "other": [(0.0, 3.0)]},
                       {"starts": 2}, {})
    assert reader(metric).read(ctx) == pytest.approx(375.0, rel=1e-12)
    ctx.counts["starts"] = 0
    assert reader(metric).read(ctx) is None
    ctx = LayerContext(10.0, 1.0, [], {"other": [(0.0, 3.0)]},
                       {"starts": 2}, {})
    assert reader(metric).read(ctx) is None
