"""`device_idle_pct` (metrics/device_idle_pct.py) in the cells that report
`ttff_s`."""

from .device_idle_pct import read  # noqa: F401

WORKLOADS = ["spread25.coldstart"]
