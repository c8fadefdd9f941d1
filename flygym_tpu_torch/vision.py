"""Compound-eye vision: a hexagonal ommatidia retina rendered by raycast.

Port of ``flygym_tpu/vision.py``. Each of the 721 ommatidia of an eye casts
one ray along its optical axis against the scene's capsules and the ground
plane; two spectral channels (pale, yellow) weight the ray's colour; an
optional Gaussian acceptance-cone blur mixes neighbours of the same type.
Output: (B, 2 eyes, n_omm, 2 channels) intensities in [0, 1].

- :func:`hex_lattice_directions` and :meth:`Retina.build` are the JAX
  package's numpy code, so the tables equal its tables exactly.
- :meth:`Retina.render` is the JAX package's jnp path, batch-first: the
  oracle of a flat world, a second renderer independent of the kernel's
  arithmetic, and the path of a heightfield world, whose terrain it
  raymarches (``flygym_tpu/vision.py:351-360``).
- :meth:`Retina.make_render_batched` is the path every caller takes. It
  chooses by :func:`~flygym_tpu_torch.ops.retina.retina_kernel_supported`,
  the JAX package's rule (``flygym_tpu/vision.py:228-246``), before any
  launch: on a flat world the retina kernel K3
  (:mod:`flygym_tpu_torch.ops.retina`) and then :meth:`apply_acceptance`;
  on a heightfield world, which JAX keeps off its kernel too,
  :meth:`Retina.render`.

:meth:`Retina.for_fly` builds the retina for a fly of a world the port
compiled, :meth:`Retina.for_compiled` from an exported world's eye bodies.
"""

from dataclasses import dataclass

import numpy as np
import torch

from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import PhysicsModel, State
from flygym_tpu_torch.render.raycast import (
    _BIG,
    _CHUNK,
    _capsule_segments,
    _ray_heightfield,
    _ray_plane,
    capsule_mask,
    raycast_scene,
)

__all__ = ["Retina", "hex_lattice_directions", "NUM_OMMATIDIA_PER_EYE"]

NUM_OMMATIDIA_PER_EYE = 721  # 15 hexagonal rings: 1 + 6 * (1 + 2 + ... + 15)


def hex_lattice_directions(n_rings: int = 15, cap_half_angle_deg: float = 135.0) -> np.ndarray:
    """Unit view directions of a hexagonal ommatidia lattice around +x:
    ring k at polar angle k/n_rings of the cap, with 6k ommatidia.

    Returns:
        (1 + 3 n (n+1), 3) float64 unit directions in the eye frame.
    """
    dirs = [np.array([1.0, 0.0, 0.0])]
    cap = np.deg2rad(cap_half_angle_deg)
    for ring in range(1, n_rings + 1):
        polar = cap * ring / n_rings
        n_in_ring = 6 * ring
        for i in range(n_in_ring):
            azim = 2 * np.pi * i / n_in_ring + (np.pi / n_in_ring) * (ring % 2)
            dirs.append(
                np.array(
                    [np.cos(polar), np.sin(polar) * np.cos(azim), np.sin(polar) * np.sin(azim)]
                )
            )
    return np.stack(dirs)


def _mix(W: torch.Tensor, intensities: torch.Tensor) -> torch.Tensor:
    """(2, n, n) blur on (..., n, 2) intensities: channel k through matrix k.
    A float32 product (TF32 is off, ``flygym_tpu_torch/__init__.py``)."""
    return torch.einsum("kon,...nk->...ok", W, intensities)


@dataclass(frozen=True)
class Retina:
    """Retina geometry and channel tables for both eyes (numpy, as built).

    The eyes look ±60 deg (``eye_yaw_deg``) outward from the head's +x axis.
    """

    left_eye_body: int
    right_eye_body: int
    directions_left: np.ndarray  # (n_omm, 3) in the eye body frame
    directions_right: np.ndarray
    channel_weights: np.ndarray  # (n_omm, 2, 3) rgb weights per channel type
    n_ommatidia: int
    # (2, n_omm, n_omm) per-channel acceptance-cone mixing matrices, or None.
    blur_weights: np.ndarray | None = None
    # Acceptance-cone half-angle (rad) for the soft-silhouette shading; 0 is
    # hard silhouettes.
    cone_half_rad: float = 0.0

    @classmethod
    def build(
        cls,
        model: PhysicsModel,
        left_eye_body: int,
        right_eye_body: int,
        *,
        n_rings: int = 15,
        eye_yaw_deg: float = 60.0,
        pale_fraction: float = 0.3,
        seed: int = 0,
        acceptance_fwhm_deg: float | None = None,
    ) -> "Retina":
        """Build the tables (``flygym_tpu/vision.py:107-188``).

        Args:
            acceptance_fwhm_deg: Gaussian acceptance-cone FWHM in degrees;
                None is the lattice's ring spacing (135 / n_rings), 0 turns
                the blur and the soft silhouettes off.
        """
        base = hex_lattice_directions(n_rings)
        if acceptance_fwhm_deg is None:
            acceptance_fwhm_deg = 135.0 / n_rings

        def yaw_rot(deg):
            a = np.deg2rad(deg)
            return np.array(
                [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]]
            )

        dirs_l = base @ yaw_rot(eye_yaw_deg).T
        dirs_r = base @ yaw_rot(-eye_yaw_deg).T

        # Spectral types 'pale' and 'yellow', ~30/70 at random from the seed.
        n = len(base)
        rng = np.random.default_rng(seed)
        is_pale = rng.random(n) < pale_fraction
        pale_w = np.array([0.05, 0.25, 0.70])
        yellow_w = np.array([0.30, 0.65, 0.05])
        weights = np.zeros((n, 2, 3))
        weights[:, 0] = np.where(is_pale[:, None], pale_w, 0.0)
        weights[:, 1] = np.where(~is_pale[:, None], yellow_w, 0.0)

        blur = None
        if acceptance_fwhm_deg > 0:
            # Gaussian over the inter-axis angle, cut at 1.5 FWHM, pooled
            # within one spectral type, rows normalised to 1.
            cosang = np.clip(base @ base.T, -1.0, 1.0)
            ang = np.degrees(np.arccos(cosang))
            sigma = acceptance_fwhm_deg / 2.3548
            w = np.exp(-0.5 * (ang / sigma) ** 2)
            w[ang > 1.5 * acceptance_fwhm_deg] = 0.0
            blur = np.zeros((2, n, n), np.float32)
            for k, ind in enumerate((is_pale, ~is_pale)):
                wk = w * ind[None, :]
                wk = wk / np.maximum(wk.sum(axis=1, keepdims=True), 1e-12)
                blur[k] = wk * ind[:, None]

        return cls(
            left_eye_body=left_eye_body,
            right_eye_body=right_eye_body,
            directions_left=dirs_l.astype(np.float32),
            directions_right=dirs_r.astype(np.float32),
            channel_weights=weights.astype(np.float32),
            n_ommatidia=n,
            blur_weights=blur,
            cone_half_rad=float(np.deg2rad(acceptance_fwhm_deg / 2.0)),
        )

    @classmethod
    def for_fly(cls, world, fly_name: str, **kwargs) -> "Retina":
        """Build for a fly of a compiled world (``world.compile()``) from its
        eye segments, as ``flygym_tpu/vision.py:206`` does."""
        ids = world.compiled.body_name2id
        return cls.build(world.compiled.model, left_eye_body=ids[f"{fly_name}/l_eye"],
                         right_eye_body=ids[f"{fly_name}/r_eye"], **kwargs)

    @classmethod
    def for_compiled(cls, compiled, fly_name: str | None = None, **kwargs) -> "Retina":
        """Build for the fly of an exported env (``meta["env"]`` of
        ``scripts/export_env_golden.py``), or for a fly whose exported maps
        carry ``eye_bodies`` (``scripts/export_taxis_golden.py``), from its
        eye bodies."""
        env = compiled.env
        if env is None:
            maps = compiled.flies.get(fly_name or compiled.fly_names[0], {})
            if "eye_bodies" not in maps:
                raise ValueError("the compiled model carries no env metadata (meta['env']) "
                                 "and no eye bodies for the fly")
            left, right = maps["eye_bodies"]
            return cls.build(compiled.model, left_eye_body=left, right_eye_body=right, **kwargs)
        if fly_name is not None and fly_name != env["fly"]:
            raise ValueError(f"the env's fly is {env['fly']!r}, not {fly_name!r}")
        left, right = env["eye_bodies"]
        return cls.build(compiled.model, left_eye_body=left, right_eye_body=right, **kwargs)

    def apply_acceptance(self, intensities: torch.Tensor) -> torch.Tensor:
        """Mix point samples over the acceptance cone: (..., n_omm, 2) →
        (..., n_omm, 2), one (n_omm, n_omm) product per channel; identity
        without ``blur_weights``."""
        if self.blur_weights is None:
            return intensities
        return _mix(self._blur_tensor(intensities.device), intensities)

    def _blur_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.blur_weights, dtype=torch.float32, device=device)

    def make_render_batched(self, model: PhysicsModel):
        """Batched render: (B,) State → (B, 2, n_omm, 2).

        On a flat world the retina kernel K3 for CUDA tensors (its plain
        version for CPU tensors), then the acceptance blur; the returned
        function carries the kernel as ``.kernel`` and the blur as
        ``.blur`` (identity without ``blur_weights``). On a heightfield
        world, which the kernel does not render, :meth:`render` (``.kernel``
        and ``.blur`` None). The choice is made here, from the model.
        """
        from flygym_tpu_torch.ops.retina import make_retina_kernel, retina_kernel_supported

        if not retina_kernel_supported(model):
            def render_terrain(state: State) -> torch.Tensor:
                return self.render(model, state)

            render_terrain.kernel = render_terrain.blur = None
            return render_terrain
        kern = make_retina_kernel(model, self)
        if self.blur_weights is None:
            blur = lambda x: x
        else:
            W = self._blur_tensor(model.device)
            blur = lambda x: _mix(W, x)

        def render_batched(state: State) -> torch.Tensor:
            return blur(kern(state))

        render_batched.kernel, render_batched.blur = kern, blur
        return render_batched

    # ------------------------------------------------------------------
    # The JAX package's jnp path, batch-first
    # ------------------------------------------------------------------

    def render(self, model: PhysicsModel, state: State) -> torch.Tensor:
        """Render both eyes of every world: (B, 2, n_omm, 2) in [0, 1].

        On CUDA tensors of a flat world, one launch of the retina kernel K3
        and the acceptance blur (:meth:`make_render_batched`); on the CPU,
        and on a heightfield, the JAX package's jnp path
        (``flygym_tpu/vision.py:248-288``)."""
        from flygym_tpu_torch.engine.kinematics import geom_poses
        from flygym_tpu_torch.ops.retina import retina_kernel_supported

        if state.xpos.device.type == "cuda" and retina_kernel_supported(model):
            return self.make_render_batched(model)(state)

        gpos, gquat = geom_poses(model, state.xpos, state.xquat)
        mask = capsule_mask(model)
        w = torch.tensor(self.channel_weights, device=gpos.device)
        outputs = []
        for body, dirs_local in (
            (self.left_eye_body, self.directions_left),
            (self.right_eye_body, self.directions_right),
        ):
            eye_pos = state.xpos[:, body]
            eye_quat = state.xquat[:, body]
            dirs = quat_rotate(
                eye_quat[:, None, :], torch.tensor(dirs_local, device=gpos.device)[None]
            )
            origins = eye_pos[:, None, :].expand(dirs.shape)
            t, geom_idx, normal = raycast_scene(model, gpos, gquat, origins, dirs, mask)
            if self.cone_half_rad > 0:
                rgb = self._shade_cone(model, geom_idx, normal, origins, dirs, gpos, gquat, mask)
            else:
                rgb = self._shade(model, t, geom_idx, normal, origins, dirs)
            outputs.append(torch.einsum("bnc,nkc->bnk", rgb, w))
        return self.apply_acceptance(torch.stack(outputs, dim=1))

    def _cone_coverage(self, model, gpos, gquat, origins, dirs, capsule_mask, t_bg):
        """Max analytic cone coverage over the capsule geoms per ray, and the
        rgb of the geom that has it (``flygym_tpu/vision.py:290-349``)."""
        p0, p1, radius = _capsule_segments(model, gpos, gquat)
        B, R = origins.shape[:2]
        tanh_ = float(np.tan(self.cone_half_rad))
        cov = origins.new_zeros((B, R))
        cov_rgb = origins.new_zeros((B, R, 3))
        ngeom = p0.shape[1]
        geom_rgb_all = model.geom_rgba[:, :3]
        for c0 in range(0, ngeom, _CHUNK):
            c1 = min(c0 + _CHUNK, ngeom)
            a0 = p0[:, None, c0:c1, :]
            ba = p1[:, None, c0:c1, :] - a0
            oa = origins[:, :, None, :] - a0
            d = dirs[:, :, None, :]
            e_q = torch.sum(ba * ba, dim=-1)
            b_q = torch.sum(d * ba, dim=-1)
            c_q = torch.sum(d * oa, dim=-1)
            f_q = torch.sum(ba * oa, dim=-1)
            denom = torch.clamp(e_q - b_q * b_q, min=1e-12)
            s = torch.clamp((f_q - b_q * c_q) / denom, 0.0, 1.0)
            tc = torch.clamp(b_q * s - c_q, min=1e-6)
            closest_ray = origins[:, :, None, :] + tc[..., None] * d
            closest_seg = a0 + s[..., None] * ba
            diff = closest_ray - closest_seg
            dperp = torch.sqrt(torch.sum(diff * diff, dim=-1))
            width = torch.clamp(tc * tanh_, min=1e-9)
            mu = (dperp - radius[c0:c1]) / width
            c_g = torch.clamp(0.5 - 0.5 * mu, 0.0, 1.0)
            zero = torch.zeros_like(c_g)
            c_g = torch.where(capsule_mask[c0:c1] > 0, c_g, zero)
            c_g = torch.where(tc < t_bg[..., None], c_g, zero)
            # Rays that start inside a geom (the eye sits in the head
            # capsule) see through it.
            s0 = torch.clamp(f_q / torch.clamp(e_q, min=1e-12), 0.0, 1.0)
            off = oa - s0[..., None] * ba
            d0sq = torch.sum(off * off, dim=-1)
            c_g = torch.where(d0sq > radius[c0:c1] ** 2, c_g, zero)
            c_best, c_arg = torch.max(c_g, dim=-1)
            better = c_best > cov
            cov = torch.where(better, c_best, cov)
            cov_rgb = torch.where(better[..., None], geom_rgb_all[c_arg + c0], cov_rgb)
        return cov, cov_rgb

    def _shade_cone(self, model, geom_idx, normal, origins, dirs, gpos, gquat, capsule_mask):
        """Nearest-geom colour mixed with the ground/sky background by the
        geom's cone coverage (``flygym_tpu/vision.py:351-392``); the
        background is the heightfield where the world has one."""
        if model.has_hfield:
            t_bg, n_bg = _ray_heightfield(model, origins, dirs)
        else:
            t_bg, _ = _ray_plane(origins, dirs, 0.0)
            n_bg = dirs.new_tensor([0.0, 0.0, 1.0]).expand(dirs.shape)
        bg_hit = t_bg < _BIG
        bg_p = origins + torch.where(bg_hit, t_bg, torch.zeros_like(t_bg))[..., None] * dirs
        checker = torch.remainder(torch.floor(bg_p[..., 0]) + torch.floor(bg_p[..., 1]), 2.0)
        ground_rgb = torch.where(
            checker[..., None] > 0.5, dirs.new_full((3,), 0.4), dirs.new_full((3,), 0.3)
        )
        sky_rgb = dirs.new_tensor([0.65, 0.75, 0.9])
        lam_bg = torch.abs(torch.sum(n_bg * (-dirs), dim=-1))
        bg_shade = torch.where(bg_hit, 0.5 + 0.5 * lam_bg, torch.ones_like(lam_bg))
        bg = torch.where(bg_hit[..., None], ground_rgb, sky_rgb) * bg_shade[..., None]

        cov, cov_rgb = self._cone_coverage(model, gpos, gquat, origins, dirs, capsule_mask, t_bg)
        is_geom = geom_idx >= 0
        geom_rgb = model.geom_rgba[torch.clamp(geom_idx, min=0), :3]
        lambert = torch.abs(torch.sum(normal * (-dirs), dim=-1))
        hit_shaded = geom_rgb * (0.5 + 0.5 * lambert)[..., None]
        geom_part = torch.where(is_geom[..., None], hit_shaded, 0.5 * cov_rgb)
        c = cov[..., None]
        return torch.clamp(c * geom_part + (1.0 - c) * bg, 0.0, 1.0)

    @staticmethod
    def _shade(model, t, geom_idx, normal, origins, dirs):
        """Geom albedo, checkered ground, bright sky, lambert-shaded
        (``flygym_tpu/vision.py:394-413``)."""
        hit_p = origins + t[..., None] * dirs
        geom_rgb = model.geom_rgba[torch.clamp(geom_idx, min=0), :3]
        checker = torch.remainder(torch.floor(hit_p[..., 0]) + torch.floor(hit_p[..., 1]), 2.0)
        ground_rgb = torch.where(
            checker[..., None] > 0.5, dirs.new_full((3,), 0.4), dirs.new_full((3,), 0.3)
        )
        sky_rgb = dirs.new_tensor([0.65, 0.75, 0.9])
        base = torch.where(
            (geom_idx >= 0)[..., None],
            geom_rgb,
            torch.where((geom_idx == -1)[..., None], ground_rgb, sky_rgb),
        )
        lambert = torch.abs(torch.sum(normal * (-dirs), dim=-1))
        shade = torch.where(geom_idx == -2, torch.ones_like(lambert), 0.5 + 0.5 * lambert)
        return torch.clamp(base * shade[..., None], 0.0, 1.0)
