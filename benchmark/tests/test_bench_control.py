"""The control of each cell at the cell's own size, on the card: the
reference put in the program's place in the precision below the one the
configuration states (`harness/check.py` CONTROLS: the correlator's
products in TF32; the host's state in float32), judged on the dispatches or
steps the run records, beside the program's own numbers. Each variant has
to fail at least one number and the program none. Prints one JSON line a
(cell, seed): the readings the limits in the workload files were set from.

    python -m pytest --noconftest -o addopts="" -m cuda -s \
        benchmark/tests/test_bench_control.py

(run from the root of a checkout on the chip; BENCH_CONTROL_SEEDS, a comma
list, replaces the three default seeds; BENCH_CONTROL_OUT names a file the
lines are added to as well).
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
OUT = os.environ.get("BENCH_CONTROL_OUT")
# a short window at the cell's own load: a run judges as many dispatches,
# steps or cold starts whatever its length
SECONDS = 10.0
SEEDS = [int(s) for s in os.environ.get(
    "BENCH_CONTROL_SEEDS", "2147483659,3000000077,4100000003").split(",")]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_control_fails_where_the_program_passes(card, name):
    from benchmark.harness.check import within
    from benchmark.harness.main import Cell, run_cell

    cell = Cell(name, MAN)
    runs = []
    for seed in SEEDS:
        r = run_cell(cell, seed, SECONDS, False, "cuda", control=True)
        line = json.dumps({
            "cell": name, "seed": seed, "card": r["device"]["kind"],
            "program": {k: v["value"] for k, v in r["check"].items()},
            "control": {var: {k: v["value"] for k, v in c.items()}
                        for var, c in r["control"].items()}})
        print(line, flush=True)
        if OUT:
            with open(OUT, "a") as f:
                f.write(line + "\n")
        runs.append(r)
    for r in runs:
        assert r["correct"], r["check"]
        for var, c in r["control"].items():
            assert any(not within(v) for v in c.values()), (var, c)
