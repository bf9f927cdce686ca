"""`scorer_roofline_pct` (metrics/scorer_roofline_pct.py) in the cells that
report `rtf`."""

from .scorer_roofline_pct import read  # noqa: F401

WORKLOADS = ["spread25.offline_k5"]
