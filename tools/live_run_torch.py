"""Real-time paced run on the bench capture, on the port.

The port of tools/live_run.py. Writes the bench scenario's handoff, then
runs the port's `live` subcommand against the bench capture in a fresh
interpreter: a paced TCP server (or, with --source sim, the in-process
simulated radio) delivers samples at true 2.5 MHz wall-clock, and the
receiver must hold real time under the 1.5 s watchdog (RunLive,
sampleblock.cu:421-426).

    python3 tools/live_run_torch.py [--seconds 45] [--lookahead 50]
        [--capture FILE] [--json FILE] [--source tcp|sim]
        [--device cuda|cpu] [other arguments of `live`, passed through]

The capture defaults to the largest cached bench_torch_capture_*.dat of
the port bench (navlab_dpe_sdr_tpu_torch/bench.py) that holds the run;
without one it is built through bench.bench_capture. Prints the `live`
record as one JSON line with card added; the exit code is the child's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402


def _bench_capture(n_blocks: int) -> str | None:
    """The largest cached bench capture holding n_blocks blocks, or None."""
    if not os.path.isdir(bench.CACHE_DIR):
        return None
    caps = [os.path.join(bench.CACHE_DIR, f)
            for f in os.listdir(bench.CACHE_DIR)
            if f.startswith(bench.CACHE_PREFIX) and f.endswith(".dat")]
    caps = sorted((c for c in caps
                   if os.path.getsize(c) >= 4 * bench.S * n_blocks),
                  key=os.path.getsize)
    return caps[-1] if caps else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=45.0)
    p.add_argument("--lookahead", type=int, default=50)
    p.add_argument("--capture", default=None,
                   help="int16 I/Q capture; default: the largest cached "
                        "bench_torch_capture_*.dat that holds --seconds")
    p.add_argument("--json", default=None,
                   help="also write the record here")
    p.add_argument("--source", default="tcp", choices=["tcp", "sim"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    card = bench.card_name(dev)

    from navlab_dpe_sdr_tpu_torch.io.handoff import write_handoff
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario

    with tempfile.TemporaryDirectory(prefix="live_run_torch_") as tmp:
        if args.capture is None:
            n_blocks = math.ceil(round(args.seconds / bench.T, 6))
            args.capture = _bench_capture(n_blocks)
            if args.capture is None:
                samples, _, _ = bench.bench_capture(n_blocks)
                args.capture = _bench_capture(n_blocks)
                if args.capture is None:       # the cache is not writable
                    args.capture = os.path.join(tmp, "capture.dat")
                    samples.tofile(args.capture)
                del samples
            bench.log(f"capture: {args.capture}")
        if not os.path.exists(args.capture):
            raise SystemExit(f"capture missing: {args.capture}")
        _, hand, _ = make_scenario(nav_data=True, cn0_dbhz=47.0)
        hand_path = os.path.join(tmp, "live_handoff.csv")
        write_handoff(hand_path, hand)
        rec_path = os.path.join(tmp, "live.json")

        cmd = [sys.executable, "-m", "navlab_dpe_sdr_tpu_torch",
               "--device", args.device, "live", args.capture,
               "--handoff", hand_path, "--seconds", str(args.seconds),
               "--lookahead", str(args.lookahead),
               "--set", "ekf_mode=alpha", "--set", "ekf_alpha=0.3",
               "--source", args.source, "--json", rec_path, *rest]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                      if x])
        bench.log("+ " + " ".join(cmd))
        rc = subprocess.run(cmd, env=env).returncode
        if rc != 0:
            return rc
        with open(rec_path) as f:
            rec = json.load(f)
    rec["card"] = card
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
