"""Explicit device selection: a requested device exists or the call raises."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """`torch.device` for `name` ("cpu", "cuda", "cuda:1", ...).

    Raises when a CUDA device is asked for and none is present: nothing
    moves to the CPU silently."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         f"(the port runs on 'cpu' or 'cuda')")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                           f"device is available")
    if dev.index is None:      # name the card, as tensors on it report
        return torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {str(dev)!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return dev
