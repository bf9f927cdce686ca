"""`host_self_ms_per_block` (metrics/host_self_ms_per_block.py) in the
cells that report `rtf_dense`."""

from .host_self_ms_per_block import read  # noqa: F401

WORKLOADS = ["dense75.offline_perblock"]
