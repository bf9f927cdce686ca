"""`device_idle_pct` (metrics/device_idle_pct.py) in the cells that report
`rtf_dense`."""

from .device_idle_pct import read  # noqa: F401

WORKLOADS = ["dense75.offline_perblock"]
