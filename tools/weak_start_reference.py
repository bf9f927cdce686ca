"""The weak-signal cold start through the JAX package on the CPU: the
reference that chip_smoke.py holds the port's run on the card to.

    JAX_PLATFORMS=cpu python tools/weak_start_reference.py

Synthesizes 2 s of the seeded 8-PRN scenario at 27 dB-Hz (the C/N0 of
tests/test_acquisition.py:96) as int16 I/Q in 1 s pieces, runs
ScalarReceiver.acquire(deep_ms=400, n_coh_ms=10) and then
track(2000, coh_ms=8) with the CLI's coherent loop defaults (Bn_code 3 Hz,
Bn_carr 48/8 Hz, FLL 12/8 Hz), and writes tools/weak_start_reference.json:
the capture's SHA-256 and, per PRN, the deep search's found, rc, fi
(fi_acq) and cppm, and the track's final cp and per-update fi and lock.
The track runs op by op (jax.disable_jit): at this C/N0 the compiled scan
departs from its own op-by-op run within 100 updates
(tests/test_torch_coherent.py), while the op-by-op run is the arithmetic as
written, which the port follows. About 6 GB of memory for the search and
two minutes on one core.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import jax
import numpy as np

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu.ops.tracking import LoopConfig

FS = 2.5e6
CN0 = 27.0
SECONDS = 2.0
DEEP_MS, N_COH_MS, COH_MS, TRACK_MS = 400, 10, 8, 2000
OUT = pathlib.Path(__file__).with_suffix(".json")


def main():
    sim, hand, _ = make_scenario(nav_data=True, cn0_dbhz=CN0)
    n = int(SECONDS * FS)
    samples = np.empty(n, DTYPE_IQ16)
    for s0 in range(0, n, int(FS)):
        iq = sim.generate(min(int(FS), n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    loops = LoopConfig(order=2, bn_code=3.0, bn_carr=48.0 / COH_MS,
                       bn_carr_freq=12.0 / COH_MS)
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        loops=loops)
    res = rx.acquire(deep_ms=DEEP_MS, n_coh_ms=N_COH_MS, verbose=False)
    with jax.disable_jit():
        rx.track(TRACK_MS, coh_ms=COH_MS)
    prns = {}
    for r in res:
        ch = rx.channels[r.prn]
        prns[str(r.prn)] = dict(
            found=bool(r.found), rc=float(r.rc), fi_acq=float(r.fi),
            cppm=float(r.cppm), cp_end=int(ch.col("cp")[-1]),
            fi=[float(x) for x in ch.col("fi")],
            lock=[int(x) for x in ch.col("lock")])
    out = dict(cn0_dbhz=CN0, seconds=SECONDS, deep_ms=DEEP_MS,
               n_coh_ms=N_COH_MS, coh_ms=COH_MS, track_ms=TRACK_MS,
               sha256=hashlib.sha256(samples.tobytes()).hexdigest(),
               prns=prns)
    OUT.write_text(json.dumps(out) + "\n")
    print({k: (v["found"], v["rc"], v["fi"][-1], v["lock"][-1])
           for k, v in prns.items()})


if __name__ == "__main__":
    main()
