"""Nothing the benchmark runs imports JAX or the JAX package; the reference
and the frozen copies import nothing of the program. Top-level module
names are compared whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "navlab_dpe_sdr_tpu"}
PROGRAM = "navlab_dpe_sdr_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "frozen"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in (BENCH / sub).rglob("*.py"):
        assert PROGRAM not in imported(path), path


def test_a_run_loads_no_jax():
    """Every module of the harness, the drivers and the port, imported in a
    fresh interpreter, loads none of JAX or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness.main, benchmark.harness.check\n"
        "import benchmark.traffic.offline, benchmark.traffic.live\n"
        "import navlab_dpe_sdr_tpu_torch.models.dpe\n"
        "import navlab_dpe_sdr_tpu_torch.models.scalar\n"
        "from benchmark.harness.main import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
