"""The whole env step's share (%) of the card's fp32 peak: over the traced
window, the counted operations of every physics step (K2's count x
``decision_interval`` x envs per env step), and with vision what the
retina needs (K3's count for the contributing pairs, as
``k3_roofline.env`` counts it) and the blur's nonzero multiply-adds, over
the window's length at 67 TFLOP/s."""


def read(r):
    c = r.config["counts"]
    n, steps = int(r.mix["envs"]), r.work["env_steps"]
    per_step = c["k2_ops_per_world_step"] * r.run.interval * n
    if r.mix["vision"]:
        share = r.run.pair_share()
        if share is None:
            return None
        rays = c["k3_ray_ops_per_world"]
        per_step += n * (rays + (c["k3_ops_per_world_all_pairs"] - rays) * share)
        per_step += 2 * c["blur_nonzeros"] * 2 * n
    w = r.digest["window_s"]
    return 100.0 * per_step * steps / w / r.peak_fp32 if w > 0 else None
