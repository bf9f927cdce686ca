"""The system under test, as the harness reaches it: the port's receiver
built from the cell's inputs, fresh copies of it, and snapshots of its
state. Only the traffic drivers and this module import the program."""

from __future__ import annotations

import copy

import numpy as np
import torch


def dpe_receiver(config: dict, cap, device):
    """A DPE receiver of the port at the truth handoff (sample 0), on the
    configuration's grid, over the capture held on the host."""
    from navlab_dpe_sdr_tpu_torch.io.handoff import read_handoff
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.models.grid import make_grid

    spec = dict(config["grid"])
    grid = make_grid(spec.pop("style"), **spec)
    rc = config["receiver"]
    samples = np.ascontiguousarray(cap.host).view(DTYPE_IQ16).reshape(-1)
    return DPEReceiver(
        SampleFile(samples=samples, fs=cap.fs), read_handoff(cap.handoff_path),
        grid=grid, config=DPEConfig(T=config["scenario"]["block_s"],
                                    ekf_mode=rc["ekf_mode"],
                                    ekf_alpha=rc["ekf_alpha"]),
        device=device)


def _seed_shared(obj, memo: dict, depth: int = 2) -> None:
    """Enter into the deepcopy memo what copies share: tensors, arrays of
    1 MB or more, and tuples of tensors, found in obj's attributes (and
    theirs, `depth` levels down)."""
    for v in vars(obj).values():
        if torch.is_tensor(v) or (isinstance(v, np.ndarray)
                                  and v.nbytes >= 1 << 20):
            memo[id(v)] = v
        elif isinstance(v, tuple) and v and all(torch.is_tensor(t)
                                                for t in v):
            memo[id(v)] = v
        elif depth > 0 and hasattr(v, "__dict__"):
            _seed_shared(v, memo, depth - 1)


def fresh(template):
    """A receiver in the template's state, sharing its device tensors and
    large read-only arrays (the grid, the capture) with it."""
    memo = {}
    _seed_shared(template, memo)
    return copy.deepcopy(template, memo)


STATE = ("rc", "ri", "fc", "fi", "cp")


def snapshot(r) -> dict:
    """The state a DPE receiver carries from block to block."""
    out = {k: np.array(getattr(r, k), dtype=np.float64) for k in STATE}
    out["x"] = np.array(r.ekf.x, dtype=np.float64)
    out["rx_time"] = float(r.rx_time)
    out["rx_time_a"] = float(r.rx_time_a)
    out["mc"] = int(r.mc)
    return out
