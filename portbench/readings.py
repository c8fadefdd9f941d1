"""Arithmetic shared by the per-layer metrics' readers: a kernel's traced
time, the least time its work needs on the card, and the shares built on
them. Every function returns None where the trace holds nothing to read."""

import re

from portbench.counts import bound_s

__all__ = ["K2", "K3", "k2_launch", "k3_launch", "kernel", "roofline"]

K2 = "megastep_kernel"
K3 = "retina_kernel"


def _is(event: str, name: str) -> bool:
    return re.search(rf"(^|[\s:]){name}[<(]", event) is not None


def kernel(reading, name: str) -> tuple:
    """``(device seconds, launches)`` of the device events whose demangled
    name holds the kernel's function name ``name`` in the traced window
    (``(anonymous namespace)::megastep_kernel(float const*, ...)``)."""
    seconds = sum(s for n, s in reading.digest["op_seconds"].items() if _is(n, name))
    count = sum(c for n, c in reading.digest["op_counts"].items() if _is(n, name))
    return seconds, count


def k2_launch(reading, worlds: int, k_steps: int) -> tuple:
    """The least time of one K-step launch of K2 at ``worlds``: the
    plain version's operations (``counts.k2_ops_per_world_step``) against
    the bytes of its input rows (qpos, qvel, K ctrl, act, qacc) and output
    rows ((K-1) qpos, qpos, qvel, act, qacc, xpos, xquat, site_xpos, forces,
    sensors) each moved once."""
    c = reading.config["counts"]
    d = c["dims"]
    n_in = d["nq"] + d["nv"] + k_steps * d["nu"] + d["na"] + d["nv"]
    n_out = (k_steps * d["nq"] + 2 * d["nv"] + d["na"] + 7 * d["nbody"] + 3 * d["nsite"]
             + d["nu"] + 16 * d["nsensor"])
    return bound_s(c["k2_ops_per_world_step"] * k_steps * worlds, 4 * worlds * (n_in + n_out))


def k3_launch(reading, worlds: int, pair_share: float) -> tuple:
    """The least time of one K3 launch at ``worlds`` for what these inputs
    need: every ray's own work and the share ``pair_share`` of (ray, geom)
    pairs that contribute, against its rows, its output and its tables."""
    c = reading.config["counts"]
    rays = c["k3_ray_ops_per_world"]
    ops = worlds * (rays + (c["k3_ops_per_world_all_pairs"] - rays) * pair_share)
    floats = worlds * ((14 + 6 * c["k3_geoms"]) + 2 * c["k3_rays"] * 2) + c["k3_table_floats"]
    return bound_s(ops, 4 * floats)


def roofline(bound_per_launch: float, launches: int, seconds: float):
    """The share (%) of a kernel's traced time its launches' bound takes."""
    if not launches or seconds <= 0:
        return None
    return 100.0 * bound_per_launch * launches / seconds
