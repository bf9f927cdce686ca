"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark (the
same files, with the capture cut to 0.6 s and the grids to 5^4 points),
and the card, decided inside a fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)          # several test workers share the host
TINY_SECONDS = 0.6
TINY_GRID = {"style": "uniform", "n": 5, "pos_spacing": 1.0,
             "vel_spacing": 0.1}


def tiny_root(dest: Path) -> Path:
    """A checkout-like directory holding BENCHMARK.json and benchmark/, cut
    to a size the CPU runs in seconds."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    man = json.loads((dest / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        p = dest / c["file"]
        d = json.loads(p.read_text())
        d["scenario"]["seconds"] = TINY_SECONDS
        d["grid"] = dict(TINY_GRID)
        p.write_text(json.dumps(d))
    blocks = int(round(TINY_SECONDS / 0.02))
    for w in man["workloads"]:
        p = dest / "benchmark" / "workloads" / f"{w['name']}.json"
        d = json.loads(p.read_text())
        if d["traffic"] == "offline":
            d.update(blocks=blocks, lookahead=10, warmup_passes=1,
                     judged_dispatches=2)
        elif d["traffic"] == "live":
            d.update(warmup_steps=2, judged_steps=4)
        elif d["traffic"] == "coldstart":
            d.update(first_ms=400, step_ms=200, most_ms=400, chunk_ms=200,
                     warmup_starts=0, judged_starts=1)
        p.write_text(json.dumps(d))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, manifest) of the tiny copy; its capture cache in it."""
    from benchmark.harness import capture

    root = tiny_root(tmp_path_factory.mktemp("bench"))
    old = capture.CACHE_DIR
    capture.CACHE_DIR = root / "benchmark" / ".cache"
    yield root, json.loads((root / "BENCHMARK.json").read_text())
    capture.CACHE_DIR = old


@pytest.fixture
def cell(tiny):
    """cell(name) -> the tiny copy's Cell of that name."""
    from benchmark.harness.main import Cell

    root, man = tiny

    def make(name, manifest=None):
        return Cell(name, manifest or man, root / "benchmark", root)
    return make


@pytest.fixture
def known_ephemerides(monkeypatch):
    """Cold starts on a capture too short to decode the navigation message:
    `ScalarReceiver.decode_ephemerides` hands every channel the scenario's
    broadcast ephemeris, anchored in the receiver's own code-period count
    (the scenario's anchors count 1000 periods at sample 0, the tracker 0)."""
    import copy

    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver

    _, _, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    by_prn = {}
    for e in arr.ephs:
        e = copy.deepcopy(e)
        e.cp_timestamp -= 1000.0
        by_prn[e.prn] = e

    def decode(self, verbose=True):
        self.set_ephemerides({p: copy.deepcopy(by_prn[p])
                              for p in self.prn_list})
        return list(self.prn_list)
    monkeypatch.setattr(ScalarReceiver, "decode_ephemerides", decode)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")
    return torch.device("cuda")
