"""Long-run phase-bookkeeping drift and memory flatness, on the port.

The port of tools/soak.py. Minutes of the bench scenario's signal,
synthesized in CHUNK_S pieces as it goes (no capture file), through both
product loops:

  scalar: the closed-loop tracker (K4) on all 8 channels, chunk after
          chunk from the truth handoff's state; after each chunk a nav
          solution from the tracked (cp, rc, fi): a cp slip or an
          accumulating rc error shows as a fix or clock ramp;
  dpe:    grouped run_batched (group_k 5, lookahead 50) on the spread grid,
          the chunk's blocks uploaded per chunk; the median fix error a
          chunk;
  memory: the resident set size and torch.cuda.memory_allocated() each
          minute: flat series mean no leak in the chunked pipelines, on
          the host and on the device.

    python3 tools/soak_torch.py [--minutes 10] [--out FILE] [--device cuda|cpu]

Prints one JSON line: soak.py's keys, plus the device's allocated-memory
series (cuda_mb_first_last, cuda_growth_mb_per_min, cuda_series; null on
the CPU) and card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402
from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid  # noqa: E402

FS = 2.5e6
CHUNK_S = 2.0                      # synthesis + tracking chunk
GROUP_K = 5
LOOKAHEAD = 50


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def _slope(t, y) -> float:
    """Least-squares slope of y over t (0 for fewer than two points)."""
    return float(np.polyfit(t, y, 1)[0]) if len(t) > 1 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.io.synth import release_workspace
    from navlab_dpe_sdr_tpu_torch.libgnss import naveng
    from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.ops import tracking as trk

    card = bench.card_name(dev)
    bench.log(f"device {dev} [{card}]")
    sim, hand, eph = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n_chunk = int(round(CHUNK_S * FS))
    n_chunks = int(round(args.minutes * 60 / CHUNK_S))
    chunk_ms = int(round(CHUNK_S * 1e3))
    blocks = chunk_ms // 20
    log_every = max(1, int(60 / CHUNK_S))

    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    st = trk.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi,
                        cp=hand.cp, device=dev)
    donor = SampleFile(samples=np.zeros(0, DTYPE_IQ16), fs=FS)
    drx = DPEReceiver(donor, copy.deepcopy(hand), grid=spread_grid(),
                      eph=copy.deepcopy(eph),
                      config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                      device=dev)

    scalar_fix, dpe_fix, rss, cuda_mem = [], [], [], []
    t_wall0 = time.perf_counter()
    for ci in range(n_chunks):
        t_sig = ci * CHUNK_S
        iq = sim.generate(n_chunk, start_sample=ci * n_chunk)
        i16 = np.empty((chunk_ms, 2500, 2), np.int16)
        i16[..., 0] = np.clip(np.round(iq.real), -32768, 32767
                              ).reshape(chunk_ms, 2500)
        i16[..., 1] = np.clip(np.round(iq.imag), -32768, 32767
                              ).reshape(chunk_ms, 2500)

        # ---- scalar tracking ----
        st, lg = trk.track_chunk(st, torch.from_numpy(i16).to(dev), tab, FS,
                                 donor.fcaid)
        last = {k: getattr(lg, k)[-1].cpu().numpy().astype(np.float64)
                for k in ("rc", "fi", "fc", "cp", "ncp")}
        cp = last["cp"] + last["ncp"]                   # end of the chunk
        # propagate rc across the final window to the chunk's end
        rc_end = np.mod(last["rc"] + last["fc"] * 1e-3, 1023.0)
        try:
            _, _, x, *_ = naveng.calculate_nav_soln(
                cp, rc_end, last["fi"], eph,
                rx_time0=hand.rx_time + t_sig + CHUNK_S)
            x = np.asarray(x).ravel()
            err = float(np.linalg.norm(x[:3] - hand.x_ecef[:3]))
            clk = float(x[3])
        except (ValueError, np.linalg.LinAlgError) as e:
            err = clk = float("nan")
            bench.log(f"nav solve failed at {t_sig} s: {e}")
        scalar_fix.append((t_sig + CHUNK_S, err, clk))

        # ---- grouped DPE ----
        raw_dev = torch.from_numpy(i16.reshape(blocks, 50000, 2)).to(dev)
        drx.run_batched(blocks, lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                        start_block=0, pipeline=True, group_k=GROUP_K,
                        pipeline_depth=1)
        derr = [float(np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3]))
                for f in drx.fixes[-(blocks // GROUP_K):]]
        dpe_fix.append((t_sig + CHUNK_S, float(np.median(derr))))
        del raw_dev

        if ci % log_every == 0:
            rss.append((t_sig, _rss_mb()))
            if dev.type == "cuda":
                cuda_mem.append((t_sig, torch.cuda.memory_allocated(dev)
                                 / 2 ** 20))
            bench.log(f"t={t_sig:6.0f}s scalar {err:7.2f} m clk {clk:9.2f} "
                      f"| dpe {dpe_fix[-1][1]:6.2f} m | rss {rss[-1][1]:.0f} "
                      f"MB [{card}]")
    release_workspace()

    t = np.array([r[0] for r in scalar_fix])
    e = np.array([r[1] for r in scalar_fix])
    clk = np.array([r[2] for r in scalar_fix])
    ok = np.isfinite(e)
    de = np.array([r[1] for r in dpe_fix])
    rss_mb = [r[1] for r in rss]
    minutes = max(args.minutes, 1e-9)
    out = {
        "signal_minutes": args.minutes,
        "wall_s": time.perf_counter() - t_wall0,
        "scalar_fix_first_last_m": [float(e[ok][0]), float(e[ok][-1])],
        "scalar_fix_median_m": float(np.median(e[ok])),
        "scalar_err_drift_m_per_min": _slope(t[ok] / 60.0, e[ok]),
        "scalar_clk_drift_m_per_min": _slope(t[ok] / 60.0, clk[ok]),
        "dpe_fix_median_m": float(np.median(de)),
        "dpe_err_drift_m_per_min": _slope(t / 60.0, de),
        "rss_first_last_mb": [rss_mb[0], rss_mb[-1]],
        "rss_growth_mb_per_min": (rss_mb[-1] - rss_mb[0]) / minutes,
        "scalar_series": scalar_fix[::max(1, len(scalar_fix) // 100)],
        "dpe_series": dpe_fix[::max(1, len(dpe_fix) // 100)],
        "rss_series": rss,
        "cuda_mb_first_last": ([cuda_mem[0][1], cuda_mem[-1][1]]
                               if cuda_mem else None),
        "cuda_growth_mb_per_min": ((cuda_mem[-1][1] - cuda_mem[0][1])
                                   / minutes if cuda_mem else None),
        "cuda_series": cuda_mem or None,
        "card": card,
    }
    js = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    print(js, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
