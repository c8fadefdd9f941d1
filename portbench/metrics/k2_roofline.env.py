"""K2's share (%) of its roofline in the env step: the least time of the
window's K2 launches of ``decision_interval`` steps (the larger of counted
operations at the fp32 peak and counted bytes at the HBM peak) over K2's
traced device time."""

from portbench.readings import K2, k2_launch, kernel, roofline


def read(r):
    seconds, launches = kernel(r, K2)
    bound, _which = k2_launch(r, int(r.mix["envs"]), r.run.interval)
    return roofline(bound, launches, seconds)
