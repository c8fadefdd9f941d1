"""K2's share (%) of its roofline on the replay: the least time of the
window's K2 launches (the larger of their counted operations at the fp32
peak and their counted bytes at the HBM peak; the operations bind) over
K2's traced device time."""

from portbench.readings import K2, k2_launch, kernel, roofline


def read(r):
    seconds, launches = kernel(r, K2)
    bound, _which = k2_launch(r, int(r.mix["worlds"]), int(r.mix["k_steps"]))
    return roofline(bound, launches, seconds)
