#!/usr/bin/env python3
"""Where the coherent / batch_k tracking kernel's time goes, term by term,
and the same for K3's windows mode.

    python3 track_window_terms.py [--set NAME]

Builds variants of the K4 source (ops/csrc/track_chunk.cu) by text
patches, loads each in turn in place of the package's library, and times
the window kernel (`track_window_kernel`) at the shapes of chip_smoke.py
phases 14 and 15 on a seeded 2 s capture of the 8-PRN scenario from its
truth handoff: coherent m = 2, 8, 10 over 200 updates, m = 4 over 500 (the
coherent cold start's 2000 ms chunk), and batch_k = 4 over 2000 steps. For
each it prints the kernel's ms per chunk (CUDA events, 5 launches after a
warm one), us per update, and the clock64() split of an update (more
launches with the clock buffer; profile_dispatch.clock_parts), with the card's
name and power limit; the lines also go to chiprun_out/window_terms.jsonl.

The sets (--set): "design", the kernel's geometry (cluster size, threads a
block, samples side by side), each variant first held bit-equal to the
plain version on short runs (the verdict is printed); "tail" and
"monitor", one term of the kernel's tail taken out at a time; "windows",
K3's windows mode (correlate_windows_kernel): its lanes per (window,
channel) at 128, 256 and 512 and its phase recurrence by fmodf, each held
bit-equal to the plain version (whose sums follow the variant's lanes),
and the recurrence taken out, timed at 1, 20 and 40 windows x 8 channels
of 2500 int16 samples (wrapper and the kernel's own time). A variant that
takes out work computes other numbers, so only its time is read.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import threading

import numpy as np
import torch

from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu_torch.ops import _build, track, tracking

from profile_dispatch import (build_variant, card_line, clock_parts, cuda_ms,
                              kernel_device_ms, patched)

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "navlab_dpe_sdr_tpu_torch" / "ops" / "csrc" / "track_chunk.cu"
OUT = REPO / "chiprun_out" / "window_terms.jsonl"
FS = 2.5e6
FCAID = F_CA / F_L1
SEED_SECONDS = 2.0

# the source's own (kWinCluster, kWinBlockCorr, kWinUnroll)
_DESIGN = (8, 320, 2)
# name -> [(text, replacement)], applied to the source in order
SETS = {
    # the redesigned kernel's geometry: blocks per channel (its cluster),
    # correlating threads per block, samples a thread evaluates side by side
    "design": {
        f"cluster {c}, {b} threads a block, {u} side by side": (
            [(f"constexpr int kWinCluster = {_DESIGN[0]};",
              f"constexpr int kWinCluster = {c};")] * (c != _DESIGN[0])
            + [(f"constexpr int kWinBlockCorr = {_DESIGN[1]};",
                f"constexpr int kWinBlockCorr = {b};")] * (b != _DESIGN[1])
            + [(f"constexpr int kWinUnroll = {_DESIGN[2]};",
                f"constexpr int kWinUnroll = {u};")] * (u != _DESIGN[2]))
        for c, b, u in ((4, 320, 2), (4, 320, 4), (4, 640, 2), (8, 320, 2),
                        (8, 320, 4), (8, 640, 2))
    },
    # the redesigned kernel's tail, one term taken out at a time
    "tail": {
        "as built": [],
        "no segment search in the finish": [
            ("const int s_lo = seg_first(jj, m, w.rc, ratio, L.n);",
             "const int s_lo = jj * 100;"),
            ("const int s_hi = seg_first(jj + 1, m, w.rc, ratio, L.n);",
             "const int s_hi = jj * 100 + 100;")],
        "no polarity test": [
            ("if (lane < L.kbp) combine_window(s_sums + lane * n_seg * 6, m, own);",
             "if (lane < L.kbp) for (int i2 = 0; i2 < 6; ++i2) "
             "own[i2] = s_sums[lane * n_seg * 6 + i2];")],
        "no loop filters": [
            ("          const float di = carrier_step(carr, comb, p, dpi);",
             "          dpi = comb[0]; const float di = comb[1];"),
            ("          const float dc = code_step(code, comb, p, dpc);",
             "          dpc = comb[2]; const float dc = comb[3];")],
        "no log rows": [
            ("      monitor_pass(ph, kb,", "      if (kb < 0) monitor_pass(ph, kb,")],
    },
    # the redesigned kernel's logging tail (monitor_pass), one term out
    "monitor": {
        "as built": [],
        "no C/N0 ring sums": [
            ("const float z_mean = ring_mean_after(rg.z, z, w);",
             "const float z_mean = z[0];"),
            ("const float z_var = ring_mean_after(rg.v, vs, w);",
             "const float z_var = vs[0];")],
        "no lock-detector divisions": [
            ("    const bool in_lock = (li / kLockK) > lq;",
             "    const bool in_lock = (li * 0.6666667f) > lq;"),
            ("my_lockval = li / kLockK - lq;", "my_lockval = li * 0.6666667f - lq;")],
        "no prompt carry": [("pa[q] = term + 0.0f;", "pa[q] = carry;")],
        "no window phases": [
            ("const WinPhase wp = window_phase(kb, b0 + (lane < kbp ? lane : 0), rc0, "
             "ri0, dfc_c,\n                                   fi_c, p.t_up);",
             "const WinPhase wp = {rc0, ri0};")],
        "no log row": [("  if (lane < kbp) {\n    const float carrier",
                        "  if (lane < 0) {\n    const float carrier")],
    },
    # K3's windows mode (correlate_windows_kernel, the vector epoch's open
    # loop): its lanes per (window, channel), and its phase recurrence
    "windows": {
        "256 lanes (as built)": [],
        "128 lanes": [("constexpr int kWinsLanes = 256;",
                       "constexpr int kWinsLanes = 128;")],
        "512 lanes": [("constexpr int kWinsLanes = 256;",
                       "constexpr int kWinsLanes = 512;")],
        "the recurrence by fmodf": [
            ("    rc = floor_mod_near(rc + dfc * 1e-3f, kLca);\n"
             "    ri = floor_mod_near(ri + fi * 1e-3f, 1.0f);",
             "    rc = floor_mod(rc + dfc * 1e-3f, kLca);\n"
             "    ri = floor_mod(ri + fi * 1e-3f, 1.0f);")],
        "no recurrence": [("  for (int i = 0; i < w; ++i) {        // the "
                           "recurrence of the windows before",
                           "  for (int i = 0; i < 0; ++i) {")],
    },
}
# sets whose variants compute what the plain version computes: their logs
# and carry (the windows mode: its E/P/L) are held to it, bit for bit, on
# short runs; in "windows" all but "no recurrence"
CHECKED = {"design", "windows"}
WINDOWS = (1, 20, 40)      # windows a launch of K3's windows mode (C = 8)


def use_library(path: pathlib.Path) -> None:
    """Bind the variant (the plain sums follow its lane count) and put it
    where ops/track.py loads its library."""
    lib = ctypes.CDLL(str(path))
    lib.track_window_lanes.restype = ctypes.c_int
    lib.track_windows_lanes.restype = ctypes.c_int
    track.WINDOW_LANES = lib.track_window_lanes()
    track.WINDOWS_LANES = lib.track_windows_lanes()
    track._bind(lib)
    with _build._lock:
        _build._libs["track_chunk"] = lib


def capture(dev):
    """SEED_SECONDS of the 8-PRN scenario (int16 I/Q on the card), the
    truth-handoff state and the code table."""
    sim, hand, _ = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = int(SEED_SECONDS * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    flat = torch.from_numpy(samples.view(np.int16).copy()).to(dev)
    st0 = tracking.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi,
                              cp=hand.cp, device=dev)
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    return flat, st0, tab


def check_plain(flat, st0, tab) -> list:
    """The loaded variant against the plain version, bit for bit: m = 4 (40
    updates), m = 10 (20) and batch_k = 4 (200 steps). Returns the cases
    that differ."""
    bad = []
    for m, kb, n_upd in ((4, 1, 40), (10, 1, 20), (1, 4, 200)):
        raw = flat[:n_upd * m * 2500 * 2].view(n_upd, m * 2500, 2)
        loops = tracking.cadence_loops(m)
        sk, lfk, lik = tracking.track_chunk_packed(
            st0, raw, tab, FS, FCAID, loops, coh_ms=m, batch_k=kb)
        if kb > 1:
            sp, lfp, lip = tracking.track_chunk_batched_plain(
                st0, raw, tab, FS, FCAID, loops, kb)
        else:
            sp, lfp, lip = tracking.track_chunk_plain(st0, raw, tab, FS, FCAID,
                                                      loops, m)
        same = torch.equal(lfk, lfp) and torch.equal(lik, lip) and all(
            torch.equal(getattr(sk, f), getattr(sp, f))
            for f in tracking.TrackState._fields)
        if not same:
            bad.append(f"m={m} batch_k={kb}")
    return bad


def check_windows_plain(flat, st0, tab) -> list:
    """K3's windows mode of the loaded variant against the plain version,
    bit for bit, at each of WINDOWS. Returns the counts that differ."""
    bad = []
    for w in WINDOWS:
        raw = flat[:w * 2500 * 2].view(w, 2500, 2)
        ph = (st0.rc, st0.dfc, st0.ri, st0.fi)
        if not torch.equal(track.correlate_windows_cuda(raw, *ph, tab, FS),
                           tracking.track_open_loop_plain(*ph, raw, tab, FS)):
            bad.append(f"W={w}")
    return bad


def time_windows(flat, st0, tab):
    """{W: dict(ms, device_ms)} of K3's windows mode for the loaded
    library: CUDA events around the wrapper (100 calls) and the kernel's
    own time (torch.profiler, 20 calls)."""
    out = {}
    for w in WINDOWS:
        raw = flat[:w * 2500 * 2].view(w, 2500, 2)

        def kernel():
            return track.correlate_windows_cuda(raw, st0.rc, st0.dfc, st0.ri,
                                                st0.fi, tab, FS)

        out[f"W={w}"] = dict(ms=cuda_ms(kernel, 100), device_ms=kernel_device_ms(
            kernel, 20, "correlate_windows_kernel"))
    return out


CASES = [("m=2", 2, 1, 200), ("m=4", 4, 1, 500), ("m=8", 8, 1, 200),
         ("m=10", 10, 1, 200), ("batch_k=4", 1, 4, 2000)]


def time_cases(flat, st0, tab, checked: bool):
    """{case: dict(ms, us_update, split)} for the loaded library; `checked`
    holds the clocked launch's logs to the unclocked one's (a variant that
    takes out work may leave log rows unwritten)."""
    out = {}
    c = tab.shape[0]
    for name, m, kb, n_upd in CASES:
        raw = flat[:n_upd * m * 2500 * 2].view(n_upd, m * 2500, 2)
        loops = tracking.cadence_loops(m)

        def kernel(clocks=None):
            return tracking.track_chunk_packed(st0, raw, tab, FS, FCAID, loops,
                                               coh_ms=m, clocks=clocks,
                                               batch_k=kb)

        lf = kernel()[1] if checked else None
        ms = cuda_ms(kernel, 5)
        clocked, _, us = clock_parts(kernel, n_upd, c, raw.device, lf)
        out[name] = dict(ms=ms, us_update=ms / n_upd * 1e3, clocked_ms=clocked,
                         split_us=dict(zip(track.CLOCK_NAMES, us.tolist())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", default="design", choices=sorted(SETS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("track_window_terms: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    source = SRC.read_text()
    variants = {k: patched(source, v) for k, v in SETS[args.set].items()}
    libs, errors = {}, []

    def one(name):
        try:
            libs[name] = build_variant(variants[name], "track_chunk", name)
        except Exception as e:        # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(k,)) for k in variants]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    dev = torch.device("cuda")
    flat, st0, tab = capture(dev)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        for name in variants:
            use_library(libs[name])
            if args.set == "windows":
                bad = ([] if name == "no recurrence" else
                       check_windows_plain(flat, st0, tab))
                verdict = ("computes other phases" if name == "no recurrence"
                           else f"DIFFERS from the plain version at {bad}"
                           if bad else "bit-equal to the plain version")
                for case, r in time_windows(flat, st0, tab).items():
                    own = ("not measured" if r["device_ms"] is None
                           else f"{r['device_ms']:.5f} ms")
                    print(f"[windows] {name}: {case} x 8 channels: wrapper "
                          f"{r['ms']:.4f} ms, kernel's own {own}; {verdict} "
                          f"[{card}]", flush=True)
                    f.write(json.dumps(dict(set=args.set, variant=name,
                                            case=case, card=card, **r))
                            + "\n")
                continue
            if args.set in CHECKED:
                bad = check_plain(flat, st0, tab)
                print(f"[{args.set}] {name}: "
                      + (f"DIFFERS from the plain version in {bad}" if bad
                         else "bit-equal to the plain version (m=4, m=10, "
                         "batch_k=4)"), flush=True)
            for case, r in time_cases(flat, st0, tab,
                                      args.set in CHECKED).items():
                split = ", ".join(f"{k} {v:.3f}"
                                  for k, v in r["split_us"].items())
                print(f"[{args.set}] {name}: {case}: {r['ms']:.4f} ms a chunk, "
                      f"{r['us_update']:.3f} us an update; split (us an "
                      f"update): {split} [{card}]", flush=True)
                f.write(json.dumps(dict(set=args.set, variant=name, case=case,
                                        card=card, **r)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
