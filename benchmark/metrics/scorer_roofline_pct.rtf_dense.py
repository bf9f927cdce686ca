"""`scorer_roofline_pct` (metrics/scorer_roofline_pct.py) in the cells that
report `rtf_dense`."""

from .scorer_roofline_pct import read  # noqa: F401

WORKLOADS = ["dense75.offline_perblock"]
