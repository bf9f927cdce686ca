"""One run of one cell: find its files by name, run its traffic, judge its
outputs, print the result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is `BENCHMARK.json`'s workload entry of that name, with its own
file `benchmark/workloads/<name>.json` (the traffic kind and its
parameters, the limits of the comparison); its configuration is the
configuration entry's `file`; its traffic driver is
`benchmark/traffic/<kind>.py`; its per-layer metrics are the `per_layer`
entries that list it, each read by `benchmark/metrics/<name>.py`. A new
cell, configuration, traffic mix or metric is new files and entries; no
file here changes.

The last line of standard output is the result's JSON object and nothing
else; comments go to standard error, whose last lines give each number
compared beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import capture as capture_mod
from .trace import DeviceWindow, Spans, Work

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "navlab_dpe_sdr_tpu")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the time.time() clock (Linux /proc), or
    now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_module(path: Path, package: str, name: str):
    """The module in file `path` as `benchmark.<package>.<name>`, so that
    its relative imports reach the harness whichever directory holds it."""
    importlib.import_module(f"benchmark.{package}")
    full = f"benchmark.{package}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell found by name: its manifest entries and files."""

    def __init__(self, name: str, manifest: dict, bench_dir: Path = BENCH_DIR,
                 root: Path = ROOT):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.workload = json.loads(
            (bench_dir / "workloads" / f"{name}.json").read_text())
        conf = {c["name"]: c for c in manifest["configs"]}[
            self.entry["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.config.setdefault("name", conf["name"])
        self.driver_path = (bench_dir / "traffic"
                            / f"{self.workload['traffic']}.py")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.bench_dir = bench_dir

    def driver(self):
        return load_module(self.driver_path, "traffic",
                           self.workload["traffic"])

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           "metrics", metric)


class Run:
    """What a traffic driver is handed: the cell, the seed and window,
    the device, the capture, the spans and the profiler, and the marks it
    sets (set-up done, window closed)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, control: bool = False):
        self.cell = cell
        self.control = control
        self.config, self.workload = cell.config, cell.workload
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.rng = np.random.default_rng(int(seed) % (1 << 64))
        self.spans = Spans(trace)
        self.work = Work()
        self.device_window = DeviceWindow(trace, self.device)
        self.setup_s = None
        self.memory_peak = 0
        self._capture = None
        self.log = log

    def capture(self):
        """The run's capture, made once (a first run in a checkout
        synthesizes its signal on every core)."""
        if self._capture is None:
            self._capture = capture_mod.load(self.config, self.seed,
                                             self.device, log=self.log)
        return self._capture

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup_done(self):
        self.setup_s = time.time() - self.t0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_seconds(self) -> float:
        if self.trace and self.workload.get("trace_seconds"):
            return min(self.seconds, float(self.workload["trace_seconds"]))
        return self.seconds

    def lead_ins(self) -> int:
        return int(self.workload.get("lead_ins", 2)) if self.trace else 0

    def window_closed(self):
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def free_device(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None,
             control: bool = False) -> dict:
    """Run the cell once and return the result object (the line printed);
    the harness's look for a chip is main()'s, not this. With control, the
    control is judged on the same recorded operations too, under the key
    `control` (the benchmark's runs never do this)."""
    run = Run(cell, seed, seconds, trace, device,
              t0 if t0 is not None else time.time(), control)
    out = cell.driver().run(run)
    limits = cell.workload["limits"]
    from .check import verdict
    correct, compared = verdict(out["numbers"], limits)
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        ctx, dev_extra, breakdown = run.device_window.reduce(
            run.spans, out["counts"], run.work)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None and np.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = run.setup_s
            else:
                value = out["end_to_end"].get(m["name"])
            if value is not None and np.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = run.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell.entry.get("chips", 1)),
        "memory_peak_bytes": run.memory_peak, **dev_extra}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = {k: verdict(v, limits)[1]
                             for k, v in out["control_numbers"].items()}
    result["check"] = compared
    return result


def main(argv=None) -> int:
    t0 = process_start()
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(args.workload, manifest)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no card: torch.cuda.is_available() "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
            f"device(s), the cell asks for {chips}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    found = forbidden_modules()
    if found:
        log(f"the process loaded {found} (JAX or the JAX package): no result")
        return 3
    log(f"correct: {result['correct']}")
    for name, v in result["check"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
