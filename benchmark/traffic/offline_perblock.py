"""Offline passes that score every block on its own (`group_k` 1): the
`offline` driver, under a traffic name of its own, so that one
configuration's grouped passes (`group_k` 5) and its per-block passes are
two traffic mixes. The mix's parameters are the cell's workload file.

Its judgement is harness/check.py `judge_dispatch` with the float32 ties
of the correlator's code phase and nav-bit flip taken as the program took
them (harness/ties.py)."""

from ..harness import check, ties
from ..harness.trace import patched
from . import offline


def run(ctx) -> dict:
    limits = ctx.workload["limits"]

    def judging(orig):
        def judge_dispatch(R, rec, group_k):
            k5 = rec["k5"]
            return ties.judge(lambda R_, r: orig(R_, r, group_k), R, rec,
                              (k5.code_mag, k5.carr_mag), limits, ctx.log)
        return judge_dispatch

    with patched(check, "judge_dispatch", judging):
        return offline.run(ctx)
