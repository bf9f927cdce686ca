"""`device_idle_pct` (metrics/device_idle_pct.py) in the cells that report
`rtf`."""

from .device_idle_pct import read  # noqa: F401

WORKLOADS = ["spread25.offline_k5"]
