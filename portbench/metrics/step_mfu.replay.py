"""The whole replay step's share (%) of the card's fp32 peak: the counted
operations of every world-step the traced window completed over the
window's length at 67 TFLOP/s. It bounds K2's roofline share, and still
reads when a later change takes K2 off the path."""


def read(r):
    ops = r.config["counts"]["k2_ops_per_world_step"] * r.work["world_steps"]
    w = r.digest["window_s"]
    return 100.0 * ops / w / r.peak_fp32 if w > 0 else None
