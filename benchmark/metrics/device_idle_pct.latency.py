"""`device_idle_pct` (metrics/device_idle_pct.py) in the cells that report
`fix_latency_p95_ms`."""

from .device_idle_pct import read  # noqa: F401

WORKLOADS = ["spread25.live_1x"]
