"""The plain reference of a noncoherent integrated fix's scoring (PyTorch,
float32): the quadratic score surfaces of a fix's N blocks
(reference/device.py `scores`), summed over the blocks in block order,
and the (maximum, first index at it) of the sum over the whole grid.
Nothing here imports the program."""

from __future__ import annotations

import torch

from .device import scores


def summed(win_mag, los_enu, center, coef, r0, o3, o1):
    """Scores [G'] of the grid points o3 [G', 3], o1 [G'] summed over the
    N blocks of win_mag [N, C, W] (each block with its own geometry)."""
    s = scores(win_mag, los_enu, center, coef, r0, o3, o1)   # [N, G']
    acc = s[0]
    for k in range(1, s.shape[0]):
        acc = acc + s[k]
    return acc


def best_summed(win_mag, los_enu, center, coef, r0, off3, off1,
                chunk: int):
    """(maximum, first index at it) of `summed` over the whole grid off3
    [G, 3], off1 [G], chunk points at a time: 0-d tensors."""
    top = torch.tensor(float("-inf"), device=win_mag.device)
    arg = torch.tensor(0, dtype=torch.int64, device=win_mag.device)
    for g0 in range(0, off3.shape[0], chunk):
        s = summed(win_mag, los_enu, center, coef, r0, off3[g0:g0 + chunk],
                   off1[g0:g0 + chunk])
        ca = torch.argmax(s)
        if s[ca] > top:
            top, arg = s[ca], ca + g0
    return top, arg
