"""The host's time per replay chunk: the median host milliseconds of the
traced window's ``flygym.replay.chunk`` spans (the control clone, the
target write and the K-step launch's enqueue). The median, not the mean:
once CUDA's launch queue is full the host waits inside a chunk at K2's
pace, which is the card's time and not the chunk's; the traced run's own
events fill it about two thirds into each episode. None where the program
keeps no spans."""

import statistics


def read(r):
    try:
        from flygym_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    chunks = spans().get("flygym.replay.chunk", {}).get("recorded", ())
    ms = [o.host_ms for o in chunks if o.host_ms is not None]
    return statistics.median(ms) if ms else None
