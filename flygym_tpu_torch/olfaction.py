"""Olfaction: odor intensities sampled at the antennae and maxillary palps.

Port of ``flygym_tpu/olfaction.py``, batch-first. Static odor sources with
per-dimension peak intensities; inverse-square (``peak / r^2``) or Gaussian
diffusion; four sensors (left/right antenna, left/right palp) give an
(n_dimensions, 4) observation per world. :meth:`OdorField.for_fly` builds
the field for a fly of a world the port compiled, and
:meth:`OdorField.for_compiled` from the tables that
``scripts/export_env_golden.py`` exports.
"""

from dataclasses import dataclass

import numpy as np
import torch

from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import PhysicsModel, State

__all__ = ["OdorField"]


@dataclass(frozen=True)
class OdorField:
    """Odor sources and fly-mounted sensors (numpy tables, float32).

    Args:
        source_pos: (n_sources, 3) positions in mm.
        peak_intensity: (n_sources, n_dim) per-dimension peak intensities.
        sensor_bodies: (4,) body indices: l/r antenna, l/r palp.
        sensor_offsets: (4, 3) sensor offsets in their body frames.
        diffusion: "inverse_square" or "gaussian".
        gaussian_scale: length scale (mm) of the Gaussian model.
    """

    source_pos: np.ndarray
    peak_intensity: np.ndarray
    sensor_bodies: np.ndarray
    sensor_offsets: np.ndarray
    diffusion: str = "inverse_square"
    gaussian_scale: float = 10.0

    def __post_init__(self):
        if self.diffusion not in ("inverse_square", "gaussian"):
            raise ValueError(f"Unknown diffusion model: {self.diffusion}")
        if self.peak_intensity.shape[0] != self.source_pos.shape[0]:
            raise ValueError(
                "peak_intensity must have one row per odor source "
                f"({self.source_pos.shape[0]}), got {self.peak_intensity.shape[0]}"
            )

    @classmethod
    def for_fly(cls, world, fly_name: str, source_pos, peak_intensity, *,
                diffusion: str = "inverse_square", gaussian_scale: float = 10.0) -> "OdorField":
        """Build for a fly of a compiled world (``world.compile()``) with the
        canonical 4 sensors: the antennae (funiculus segments) and the
        maxillary palps (offsets on the rostrum), as
        ``flygym_tpu/olfaction.py:47`` does."""
        ids = world.compiled.body_name2id
        ns = fly_name
        sensor_bodies = np.array([ids[f"{ns}/l_funiculus"], ids[f"{ns}/r_funiculus"],
                                  ids[f"{ns}/c_rostrum"], ids[f"{ns}/c_rostrum"]], np.int64)
        sensor_offsets = np.array([
            [0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0],
            [0.05, 0.1, -0.1],  # left maxillary palp, rostrum frame
            [0.05, -0.1, -0.1],  # right maxillary palp
        ], np.float32)
        source_pos = np.atleast_2d(np.asarray(source_pos, np.float32))
        peak_intensity = np.atleast_2d(np.asarray(peak_intensity, np.float32))
        if peak_intensity.shape[0] != source_pos.shape[0]:
            raise ValueError("peak_intensity must have one row per odor source "
                             f"({source_pos.shape[0]}), got {peak_intensity.shape[0]}")
        return cls(source_pos=source_pos, peak_intensity=peak_intensity,
                   sensor_bodies=sensor_bodies, sensor_offsets=sensor_offsets,
                   diffusion=diffusion, gaussian_scale=gaussian_scale)

    @classmethod
    def for_compiled(cls, compiled, **overrides) -> "OdorField":
        """The odor field of an exported env (``meta["env"]["odor"]``);
        ``overrides`` replace fields (e.g. ``diffusion``)."""
        if compiled.env is None or "odor" not in compiled.env:
            raise ValueError("the compiled model carries no odor tables (meta['env']['odor'])")
        tables = compiled.env["odor"]
        kw = dict(
            source_pos=np.atleast_2d(np.asarray(tables["source_pos"], np.float32)),
            peak_intensity=np.atleast_2d(np.asarray(tables["peak_intensity"], np.float32)),
            sensor_bodies=np.asarray(tables["sensor_bodies"], np.int64),
            sensor_offsets=np.asarray(tables["sensor_offsets"], np.float32),
            diffusion=tables.get("diffusion", "inverse_square"),
            gaussian_scale=float(tables.get("gaussian_scale", 10.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def n_dimensions(self) -> int:
        return self.peak_intensity.shape[1]

    def sensor_positions(self, state: State) -> torch.Tensor:
        """(B, 4, 3) world positions of the sensors."""
        dev = state.xpos.device
        bodies = torch.as_tensor(self.sensor_bodies, device=dev)
        offsets = torch.as_tensor(self.sensor_offsets, device=dev)
        return state.xpos[:, bodies] + quat_rotate(state.xquat[:, bodies], offsets)

    def sample(self, model: PhysicsModel, state: State) -> torch.Tensor:
        """Odor intensities at the sensors: (B, n_dimensions, 4)."""
        pos = self.sensor_positions(state)  # (B, 4, 3)
        src = torch.as_tensor(self.source_pos, device=pos.device)  # (s, 3)
        peak = torch.as_tensor(self.peak_intensity, device=pos.device)  # (s, d)
        diff = pos[:, None, :, :] - src[None, :, None, :]
        d2 = torch.sum(diff * diff, dim=-1)  # (B, s, 4)
        if self.diffusion == "inverse_square":
            atten = 1.0 / torch.clamp(d2, min=1e-4)
        else:
            atten = torch.exp(-d2 / (2.0 * self.gaussian_scale**2))
        return torch.einsum("sd,bsf->bdf", peak, atten)
