"""`fetch_wait_ms_per_block` (metrics/fetch_wait_ms_per_block.py) in the
cells that report `rtf`."""

from .fetch_wait_ms_per_block import read  # noqa: F401

WORKLOADS = ["spread25.offline_k5"]
