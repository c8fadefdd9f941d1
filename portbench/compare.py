"""The comparisons that decide ``correct``: gaps between what the timed
path produced and what the reference computes from the same inputs."""

import math

import torch

__all__ = ["STATE_FIELDS", "gap", "state_gap", "verdict"]

# Every field a step produces (``time`` is carried, ``ctrl`` is input).
STATE_FIELDS = ("qpos", "qvel", "act", "qacc", "xpos", "xquat", "site_xpos",
                "actuator_force", "contact_sensordata")


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want|; positions where both are NaN agree, a NaN
    on one side or another shape is an infinite gap."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    got, want = got.double(), want.to(got.device).double()
    d = (got - want).abs()
    both = torch.isnan(got) & torch.isnan(want)
    d = torch.where(both, torch.zeros_like(d), torch.nan_to_num(d, nan=math.inf))
    return float(d.max().item())


def state_gap(got, want, fields=STATE_FIELDS) -> float:
    """The largest gap over the fields of two States."""
    return max(gap(getattr(got, f), getattr(want, f)) for f in fields)


def verdict(checks: list) -> bool:
    """Every ``(name, value, limit)`` within its limit."""
    return all(value <= limit for _name, value, limit in checks)
