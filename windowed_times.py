#!/usr/bin/env python3
"""K5's time at the main path's shapes, for any tree that holds the port,
and for variants of its cluster size:

    python3 windowed_times.py [--tree DIR] [--label NAME] [--clusters 4,8,16]
                              [--split]

On the first 50 blocks (1 s) of the seeded 8-PRN scenario with the
parameters the batched receiver prepares for them (chip_smoke.py phase
26's inputs, profile_dispatch.k5_inputs: int16 pairs, windows 12 / 36 from
auto_windows), it times the tree's `windowed_correlate` at N = 50, 8 and 1:
CUDA events around the wrapper (20 calls after a warm one) and the
kernel's own time per launch from torch.profiler (the kernel whose name
holds "windowed_", over 10 calls), each line with the card's name and
power limit.

--tree is the directory whose navlab_dpe_sdr_tpu_torch is imported (this
script's own by default), so a parent and a change are set side by side
by running this one script on each in turn, each in a process of its own.
--clusters builds variants of this script's own
ops/csrc/windowed_correlate.cu with the cluster size R (kCluster) patched
(above 8, the non-portable cluster size allowed as well), loads each in
place of the package's library in turn (the list, then the list
reversed), holds it to the plain version (windows within 1e-5 of each
channel's window maximum, flips and code argmaxes equal, at N = 50, 8, 1,
magnitude and complex, int16 and float32 samples) and across block splits
of 2 and 50, bit for bit, then times it. Lines also go to
chiprun_out/windowed_times.jsonl; the last line is a JSON object of the
times. --split adds, at each N, the kernel's clock64() split of a thread
block (ops/correlate.py CLOCK_NAMES: thousands of SM clocks, mean over
the blocks and ranks, and the slowest block's whole) from one more launch
with its clock buffer, whose windows must equal the unclocked launch's.
Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import sys

import numpy as np
import torch

# this script's own helpers, imported before --tree goes onto the path
from profile_dispatch import (N_BLOCKS, S, build_variant, card_line, cuda_ms,
                              k5_clock_split, k5_inputs, kernel_device_ms,
                              patched)

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "navlab_dpe_sdr_tpu_torch" / "ops" / "csrc" / "windowed_correlate.cu"
OUT = REPO / "chiprun_out" / "windowed_times.jsonl"
SHAPES = (N_BLOCKS, 8, 1)        # batched dispatch, integrated fix, per-block step
CLUSTER_LINE = "constexpr int kCluster = {};"
PORTABLE = 'static_assert(kCluster <= 8, "cluster size: portable");\n'
LAUNCH = "  cudaLaunchConfig_t cfg = {};\n"
NON_PORTABLE = ("  e = cudaFuncSetAttribute(kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                "  if (e != cudaSuccess) return e;\n")


def capture():
    """The first N_BLOCKS blocks of the seeded 8-PRN scenario (int16 I/Q),
    its truth handoff, ephemerides and the spread grid."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid

    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    iq = sim.generate(N_BLOCKS * S)
    samples = np.empty(N_BLOCKS * S, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr, spread_grid()


def cluster_variant(source: str, r: int) -> str:
    """The source with kCluster = r (and, above 8, the non-portable
    cluster size allowed at launch)."""
    own = next(k for k in range(1, 65) if CLUSTER_LINE.format(k) in source)
    patches = [(CLUSTER_LINE.format(own), CLUSTER_LINE.format(r))]
    if r > 8:
        patches += [(PORTABLE, ""), (LAUNCH, NON_PORTABLE + LAUNCH)]
    return patched(source, patches)


def check(correlate, score, args, kw) -> float:
    """The loaded kernel against the plain version and across block splits
    (raises on a difference); returns the worst window difference relative
    to its channel's window maximum."""
    worst = 0.0
    for n, dtype, cplx in itertools.product(SHAPES, ("int16", "float32"),
                                            (False, True)):
        a = args(0, n, dtype=dtype)
        keep = a[4] != 0           # a boundary at sample 0 is a tie
        got = correlate.windowed_correlate(*a, **kw, complex_out=cplx)
        want = correlate.windowed_correlate_plain(*a, **kw, complex_out=cplx)
        for name in got._fields[:-1]:
            g, w = getattr(got, name)[keep], getattr(want, name)[keep]
            worst = max(worst, float(((g - w).abs() / w.abs().amax(
                -1, keepdim=True)).max()))
        assert worst < 1e-5, (n, dtype, cplx, worst)
        assert torch.equal(got.flip_used[keep], want.flip_used[keep])
        mags = [torch.hypot(o.code_re, o.code_im) if cplx else o.code_mag
                for o in (got, want)]
        assert torch.equal(mags[0].argmax(-1)[keep], mags[1].argmax(-1)[keep])
    for dtype in ("int16", "float32"):
        whole = correlate.windowed_correlate(*args(0, N_BLOCKS, dtype=dtype),
                                             **kw)
        for parts in (2, N_BLOCKS):
            shares = [correlate.windowed_correlate(
                *args(lo, hi, dtype=dtype), **kw)
                for lo, hi in score.even_rows(N_BLOCKS, parts)]
            for name, f in zip(whole._fields, zip(*shares)):
                assert torch.equal(torch.cat(f), getattr(whole, name)), \
                    (dtype, parts, name)
    return worst


def times(correlate, args, kw, split: bool) -> dict:
    out = {}
    for n in SHAPES:
        a = args(0, n)

        def fn():
            return correlate.windowed_correlate(*a, **kw)

        out[f"N={n}"] = dict(ms=cuda_ms(fn, 20),
                             device_ms=kernel_device_ms(fn, 10, "windowed_"))
        if split:
            out[f"N={n}"]["kclocks"] = k5_clock_split(correlate, a, kw)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO),
                    help="directory holding the navlab_dpe_sdr_tpu_torch "
                         "to measure")
    ap.add_argument("--label", default="", help="name printed in the JSON")
    ap.add_argument("--clusters", default="",
                    help="cluster sizes to build and time, e.g. 4,8,16")
    ap.add_argument("--split", action="store_true",
                    help="also the kernel's clock64() split at each N")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("windowed_times: no CUDA device", file=sys.stderr)
        return 2
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import navlab_dpe_sdr_tpu_torch as pkg
    from navlab_dpe_sdr_tpu_torch.ops import _build, correlate, score
    assert pathlib.Path(pkg.__file__).resolve().is_relative_to(tree), \
        pkg.__file__

    card = card_line()
    print(f"{card}; the port of {tree}", flush=True)
    k5, kw, _ = k5_inputs(*capture(), torch.device("cuda"))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    result = dict(label=args.label, tree=str(tree), card=card, times={})

    def record(name, t, extra=""):
        result["times"][name] = t
        for shape, v in t.items():
            own = ("not measured" if v["device_ms"] is None
                   else f"{v['device_ms']:.4f} ms")
            print(f"K5 {name} {shape}: wrapper {v['ms']:.4f} ms, kernel's "
                  f"own {own}{extra} [{card}]", flush=True)
            if "kclocks" in v:
                print(f"K5 {name} {shape} clock split (thousands of SM "
                      f"clocks a block): " + ", ".join(
                          f"{k} {x:.3f}" for k, x in v["kclocks"].items()),
                      flush=True)
        with OUT.open("a") as f:
            f.write(json.dumps(dict(label=args.label, tree=str(tree),
                                    variant=name, card=card, times=t)) + "\n")

    if not args.clusters:
        record("as built", times(correlate, k5, kw, args.split))
    else:
        source = SRC.read_text()
        rs = [int(r) for r in args.clusters.split(",") if r]
        libs = {r: build_variant(cluster_variant(source, r),
                                 "windowed_correlate", f"R={r}") for r in rs}
        for turn, r in enumerate(rs + rs[::-1]):
            lib = ctypes.CDLL(str(libs[r]))
            correlate._bind(lib)
            with _build._lock:
                _build._libs["windowed_correlate"] = lib
            worst = check(correlate, score, k5, kw)
            record(f"R={lib.windowed_cluster()} (turn {turn + 1})",
                   times(correlate, k5, kw, args.split),
                   f"; against plain within {worst:.3e}, splits bit-equal")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
