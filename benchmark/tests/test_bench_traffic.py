"""Each traffic driver through a whole run at a tiny size on the CPU (the
harness's look for a card skipped), new cells from files alone, and runs
whose timed path is broken underneath: `correct` must come out false."""

import json
import shutil

import pytest
import torch

from benchmark.harness import main as hm
from benchmark.harness.check import within

CELLS = ["spread25.offline_k5", "dense75.offline_perblock",
         "spread25.live_1x", "spread25.coldstart"]


@pytest.fixture
def cell_of(cell, request):
    """cell(name), with the cold start's ephemerides known (its tiny
    capture holds no whole navigation message)."""
    def make(name):
        if "coldstart" in name:
            request.getfixturevalue("known_ephemerides")
        return cell(name)
    return make
SEED = 2**31 + 977


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(cell_of, name, trace):
    r = hm.run_cell(cell_of(name), SEED, 0.3, bool(trace), "cpu")
    assert r["correct"], r["check"]
    assert r["attempted"] > 0
    assert list(r)[-1] == "check"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["device"]["window_s"] > 0
        # no device records on the CPU: only the host spans' metrics read
        assert all(u in ("ms", "s") for u in
                   (v["unit"] for v in r["metrics"].values()))
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2


def test_a_new_cell_is_files_and_entries(tiny, cell, tmp_path):
    """A cell, a configuration and a metric added as new files and entries
    in a copy of the benchmark run with no other file changed."""
    root, man = tiny
    copy = tmp_path / "root"
    shutil.copytree(root, copy, ignore=shutil.ignore_patterns(".cache"))
    man = json.loads(json.dumps(man))
    conf = json.loads((copy / "benchmark/configs/l1ca8_spread25.json")
                      .read_text())
    conf["receiver"]["ekf_alpha"] = 0.5
    (copy / "benchmark/configs/l1ca8_alpha5.json").write_text(
        json.dumps(conf))
    man["configs"].append({"name": "l1ca8_alpha5", "source": "test",
                           "file": "benchmark/configs/l1ca8_alpha5.json",
                           "reduced": [], "why": "test"})
    wl = json.loads((copy / "benchmark/workloads/spread25.offline_k5.json")
                    .read_text())
    wl["group_k"] = 1
    (copy / "benchmark/workloads/alpha5.offline_perblock.json").write_text(
        json.dumps(wl))
    man["workloads"].append({"name": "alpha5.offline_perblock",
                             "config": "l1ca8_alpha5", "traffic": "offline",
                             "chips": 1, "why": "test"})
    (copy / "benchmark/metrics/passes.rtf.py").write_text(
        'WORKLOADS = ["alpha5.offline_perblock"]\n\n\n'
        'def read(ctx):\n    return ctx.counts["passes"]\n')
    man["per_layer"].append({"name": "passes.rtf", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "receiver", "moves": "rtf",
                             "workloads": ["alpha5.offline_perblock"]})
    for e in man["end_to_end"]:
        if e["name"] == "rtf":
            e["workloads"].append("alpha5.offline_perblock")
    c = hm.Cell("alpha5.offline_perblock", man, copy / "benchmark", copy)
    r = hm.run_cell(c, SEED, 0.2, False, "cpu")
    assert r["correct"] and "rtf" in r["metrics"]
    r = hm.run_cell(c, SEED, 0.2, True, "cpu")
    assert r["metrics"]["passes.rtf"]["value"] >= 1


def _unchanged_state(monkeypatch):
    """The measurement update returns the state it was given, unchanged."""
    from navlab_dpe_sdr_tpu_torch.models import ekf
    monkeypatch.setattr(ekf.NavEKF, "measurement_update",
                        lambda self, z, R=None: self.x)


def _unchanged_tracker(monkeypatch):
    """Each tracking chunk returns the tracker's state it was given."""
    from navlab_dpe_sdr_tpu_torch.ops import tracking
    orig = tracking.track_chunk_packed

    def stuck(state, *a, **kw):
        _, logf, logi = orig(state, *a, **kw)
        return state, logf, logi
    monkeypatch.setattr(tracking, "track_chunk_packed", stuck)


def _half_batch(monkeypatch):
    """The correlator computes the first half of the blocks and hands its
    windows to the second half as well."""
    from navlab_dpe_sdr_tpu_torch.ops import correlate, dpe_real
    orig = correlate.windowed_correlate

    def half(raw_re, raw_im, *a, **kw):
        n = raw_re.shape[0]
        if n < 2:
            return orig(raw_re, raw_im, *a, **kw)
        h = (n + 1) // 2
        args = [x[:h] if torch.is_tensor(x) and x.dim() == 2
                and x.shape[0] == n else x for x in a]
        out = orig(raw_re[:h], raw_im[:h], *args, **kw)
        return type(out)(*(torch.cat([f, f])[:n] for f in out))
    monkeypatch.setattr(dpe_real, "windowed_correlate", half)


def _altered_answer(monkeypatch):
    """The scorer's index is moved one grid point where it is produced."""
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real
    argmax, surface = dpe_real.score_argmax, dpe_real.score_surface_argmax

    def moved(*a, **kw):
        best, arg = argmax(*a, **kw)[:2]
        return (best, arg + 1)

    def moved_surface(*a, **kw):
        s, best, arg = surface(*a, **kw)
        return s, best, arg + 1
    monkeypatch.setattr(dpe_real, "score_argmax", moved)
    monkeypatch.setattr(dpe_real, "score_surface_argmax", moved_surface)


def _altered_acquisition(monkeypatch):
    """Acquisition's code phases moved by one chip where they are found."""
    from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
    orig = ScalarReceiver.acquire

    def moved(self, *a, **kw):
        out = orig(self, *a, **kw)
        self.state = self.state._replace(rc=self.state.rc + 1.0)
        return out
    monkeypatch.setattr(ScalarReceiver, "acquire", moved)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer,
          "unchanged_tracker": _unchanged_tracker,
          "altered_acquisition": _altered_acquisition}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(cell_of, monkeypatch, name,
                                            fault):
    if fault == "half_batch" and "offline" not in name:
        pytest.skip("a per-block step correlates one block: no batch to halve")
    if fault in ("unchanged_tracker", "altered_acquisition") and (
            "coldstart" not in name):
        pytest.skip("no tracker or acquisition on this cell's path")
    c = cell_of(name)
    FAULTS[fault](monkeypatch)
    r = hm.run_cell(c, SEED, 0.2, False, "cpu")
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cell_of, name):
    """The reference in the program's place a step down: every control
    fails a number (on the CPU TF32 does not exist; the card's test runs
    it)."""
    r = hm.run_cell(cell_of(name), SEED, 0.2, False, "cpu", control=True)
    assert r["correct"]
    for var, c in r["control"].items():
        if var == "tf32":
            continue
        assert any(not within(v) for v in c.values()), (var, c)
