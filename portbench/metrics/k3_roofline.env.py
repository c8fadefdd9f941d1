"""K3's share (%) of its roofline for what these inputs need: every ray's
own work and the (ray, geom) pairs that contribute, counted by the frozen
plain arithmetic (``reference.vision.contributing_pairs``) on a seeded
sample of the traced window's worlds and poses, scaled to the batch,
against K3's rows and output, over K3's traced device time."""

from portbench.readings import K3, k3_launch, kernel, roofline


def read(r):
    seconds, launches = kernel(r, K3)
    share = r.run.pair_share() if launches else None
    if share is None:
        return None
    bound, _which = k3_launch(r, int(r.mix["envs"]), share)
    return roofline(bound, launches, seconds)
