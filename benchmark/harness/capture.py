"""The cell's inputs: the scenario's capture and its truth handoff.

The scenario (satellites, receiver, signal) comes from the configuration,
through the benchmark's frozen copy of the scenario and synthesizer: the
same samples whatever the program does. Its noiseless signal depends only
on the configuration, so it is synthesized once per checkout, in 1 s
pieces spread over the host's cores, and kept as complex64 in the
benchmark's cache directory. Each run adds white noise drawn from its seed
on the device (sigma / sqrt(2) on each of I and Q, as the synthesizer adds
it) and quantizes the sum to int16: a new seed costs a second, not a
synthesis.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..frozen.io import handoff as frozen_handoff
from ..frozen.io import scenario as frozen_scenario

BENCH_DIR = Path(__file__).resolve().parent.parent
CACHE_DIR = BENCH_DIR / ".cache"          # fixed, inside the checkout
PIECE_S = 1.0                              # seconds a synthesis piece
NOISE_CHUNK = 1 << 24                      # samples a noise draw


def scenario_kwargs(config: dict) -> dict:
    s = config["scenario"]
    return dict(n_sats=s["n_sats"], tow0=s["tow0"], lat=s["lat"],
                lon=s["lon"], alt=s["alt"], cn0_dbhz=s["cn0_dbhz"],
                fs=s["fs"], nav_data=s["nav_data"],
                min_elev_deg=s["min_elev_deg"])


def make_scenario(config: dict):
    """(CaptureSimulator, truth Handoff, EphArray) of the frozen copy."""
    return frozen_scenario.make_scenario(**scenario_kwargs(config))


def _key(config: dict) -> str:
    """The cache name: the scenario, the length and the frozen sources."""
    h = hashlib.sha256(json.dumps(
        [scenario_kwargs(config), config["scenario"]["seconds"]],
        sort_keys=True).encode())
    for mod in ("io/synth.py", "io/scenario.py", "libgnss/satpos.py",
                "libgnss/lnav.py", "libgnss/cacode.py"):
        h.update((BENCH_DIR / "frozen" / mod).read_bytes())
    return h.hexdigest()[:16]


def _piece(args):
    config, start, n = args
    sim, _, _ = make_scenario(config)
    return start, sim.generate(n, start_sample=start, noise=False)


def noiseless(config: dict, workers: int | None = None, log=None):
    """The configuration's noiseless complex64 signal, synthesized on first
    use in this checkout and read from the cache after."""
    fs = config["scenario"]["fs"]
    n = int(round(config["scenario"]["seconds"] * fs))
    path = CACHE_DIR / f"signal_{_key(config)}.c64"
    if path.exists() and path.stat().st_size == 8 * n:
        return np.fromfile(path, np.complex64)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    piece = int(round(PIECE_S * fs))
    jobs = [(config, s, min(piece, n - s)) for s in range(0, n, piece)]
    workers = workers or min(len(jobs), os.cpu_count() or 1, 8)
    if log:
        log(f"synthesizing {n / fs:.1f} s of signal in {len(jobs)} pieces "
            f"on {workers} processes")
    out = np.empty(n, np.complex64)
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            for s, x in pool.imap_unordered(_piece, jobs):
                out[s:s + x.shape[0]] = x
    else:
        for job in jobs:
            s, x = _piece(job)
            out[s:s + x.shape[0]] = x
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    out.tofile(tmp)
    os.replace(tmp, path)
    return out


@dataclass
class Capture:
    raw: torch.Tensor          # int16 [blocks, S, 2] on the device
    host: np.ndarray           # the same samples, int16 [blocks, S, 2]
    hand: object               # the frozen truth Handoff at sample 0
    eph: object                # the frozen EphArray
    handoff_path: str          # the same handoff as a file (for the program)
    fs: float
    S: int                     # samples a block

    @property
    def blocks(self) -> int:
        return int(self.raw.shape[0])


def add_noise(signal: np.ndarray, seed: int, sigma: float, device,
              S: int) -> torch.Tensor:
    """signal + white noise of `sigma` (sigma / sqrt(2) a component) drawn
    from `seed` on the device, rounded to int16: [blocks, S, 2]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    n = signal.shape[0] // S * S
    out = torch.empty((n, 2), dtype=torch.int16, device=device)
    pairs = signal[:n].view(np.float32).reshape(n, 2)
    scale = float(np.float32(sigma / np.sqrt(2.0)))
    for a in range(0, n, NOISE_CHUNK):
        b = min(n, a + NOISE_CHUNK)
        x = torch.from_numpy(pairs[a:b]).to(device, copy=True)
        x += torch.randn(x.shape, generator=gen, device=device) * scale
        out[a:b] = torch.round(x).clamp_(-32768, 32767).to(torch.int16)
    return out.reshape(-1, S, 2)


def load(config: dict, seed: int, device, log=None) -> Capture:
    """The run's capture on `device` (and on the host), and the handoff."""
    fs = config["scenario"]["fs"]
    S = int(round(config["scenario"]["block_s"] * fs))
    signal = noiseless(config, log=log)
    _, hand, eph = make_scenario(config)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    hpath = CACHE_DIR / f"{config['name']}_handoff.csv"
    frozen_handoff.write_handoff(str(hpath), hand)
    raw = add_noise(signal, seed, config["scenario"]["sigma"], device, S)
    return Capture(raw=raw, host=raw.cpu().numpy(), hand=hand, eph=eph,
                   handoff_path=str(hpath), fs=fs, S=S)
