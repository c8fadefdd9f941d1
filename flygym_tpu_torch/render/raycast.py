"""Raycast renderer of the capsule, mesh-SDF, plane and heightfield scene.

Port of ``flygym_tpu/render/raycast.py``, batch-first: geoms are (B, ngeom,
...), rays (B, R, 3), and one call of :func:`render_pixels` renders every
world of the batch, as the JAX package's ``vmap`` does
(``flygym_tpu/render/renderer.py:147-150``). The same nearest-hit pass
(:func:`raycast_scene`) serves the retina's heightfield path
(``flygym_tpu_torch/vision.py:Retina.render``).

The JAX package renders camera frames with plain ``jnp`` outside any Pallas
kernel, and so does this module with PyTorch operations on tensors, on the
card or on the CPU. Where the JAX CPU backend contracts a product feeding a
sum into one fused multiply-add and the result is amplified afterwards, the
port rounds the same way (:func:`~flygym_tpu_torch.engine.maths.fma32`):
the value-noise hash multiplies ``sin`` of its lattice argument by
43758.5453, so one ulp of the argument draws another random value.
"""

import math

import torch

from flygym_tpu_torch.engine.maths import (
    fma32,
    norm,
    powf,
    quat_conj,
    quat_rotate,
    quat_to_mat,
    sinf,
    sqrt_rn,
)
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["camera_rays", "capsule_mask", "default_lights", "raycast_scene", "render_pixels"]

_BIG = 1e30
_CHUNK = 8


def capsule_mask(model: PhysicsModel) -> torch.Tensor:
    """(ngeom,) 1.0 for the geoms rendered as capsules (capsules, spheres);
    planes and heightfields are drawn analytically."""
    return torch.tensor([1.0 if t in ("capsule", "sphere") else 0.0 for t in model.geom_types],
                        dtype=torch.float32, device=model.device)


def default_lights(device=None):
    """The default scene lighting: one shadow-casting directional sun
    (diffuse 0.50, white specular), so that ``lights=None`` and
    ``lights=default_lights()`` give the same image."""
    sun = torch.tensor([0.3, 0.2, 0.93], device=device)
    sun = sun / norm(sun)
    return (
        {
            "kind": "directional",
            "vec": -sun,  # the direction the light travels
            "color": torch.full((3,), 0.50, device=device),
            "specular": torch.ones(3, device=device),
            "cast_shadow": True,
            "falloff": 30.0,
        },
    )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) of a * b, as the JAX CPU backend reduces
    it: ``fma(a2, b2, fma(a1, b1, a0 b0))``."""
    a, b = torch.broadcast_tensors(a, b)
    return fma32(a[..., 2], b[..., 2], fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


class _Arith:
    """How a product feeding a sum rounds: ``fused`` as the JAX CPU backend
    rounds it under ``jit`` (one fused multiply-add; a sum of products as a
    chain of them), else each product rounded on its own, as JAX's eager
    operations round it. The JAX package's ``Renderer`` renders jitted, so
    the camera renderer is fused; its ``FlyEnv.render`` and the retina's
    jnp path run eagerly, and their ports are not."""

    def __init__(self, fused: bool):
        self.fused = fused

    def fma(self, a, b, c):
        """a * b + c."""
        return fma32(a, b, c) if self.fused else a * b + c

    def dot(self, a, b):
        """The sum of a * b over the last axis (3)."""
        return _dot(a, b) if self.fused else torch.sum(a * b, dim=-1)


_PLAIN, _FUSED = _Arith(False), _Arith(True)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace``'s float32 arithmetic: start (1 - s) + stop s with s =
    i / (num - 1), the last entry ``stop`` itself."""
    step = torch.arange(num - 1, dtype=torch.float32, device=start.device) / float(num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def _linspace_jit(start: torch.Tensor, stop: torch.Tensor, num: int, mode: str):
    """``jnp.linspace`` as XLA compiles it inside the jitted ``Renderer``:
    start (1 - i c) + i (stop c) with c = float32(1 / (num - 1)), the last
    entry ``stop``. ``mode`` is how the loop that makes it rounds, as read
    off the jitted program's results:

    - "rows": the frame's row loop, both products fused as
      fma(1 - i c, start, i (stop c)) with 1 - i c one fused multiply-add;
    - "columns": a column loop run at run time, fused as
      fma(i, stop c, start (1 - i c));
    - "folded": a column loop short enough that LLVM unrolls it and folds
      it to constants one operation at a time (up to 80 columns here).
    """
    i = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    c = torch.tensor(1.0 / (num - 1), dtype=torch.float32, device=start.device)
    step = stop * c
    if mode == "folded":
        out = start * (1 - i * c) + i * step
    else:
        s = fma32(-i, c.expand_as(i), torch.ones_like(i))
        if mode == "rows":
            out = fma32(s, start.expand_as(i), i * step)
        else:
            out = fma32(i, step.expand_as(i), start * s)
    return torch.cat([out, stop.reshape(1)])


# The widest column loop that XLA's CPU backend unrolls into constants.
_FOLDED_COLUMNS = 80


def camera_rays(height: int, width: int, fovy_deg: float, device=None,
                fused: bool = False) -> torch.Tensor:
    """Pixel ray directions in the camera frame (-z forward, y up): (H, W, 3)
    unit vectors. ``fused`` as the jitted ``Renderer`` rounds them; else as
    the eager ``camera_rays`` does."""
    fovy = torch.tensor(math.radians(fovy_deg), dtype=torch.float32)
    tan_y = torch.tan(fovy.double() / 2.0).float().to(device)
    tan_x = tan_y * (width / height)
    if fused:
        ys = _linspace_jit(tan_y, -tan_y, height, "rows")
        xs = _linspace_jit(-tan_x, tan_x, width,
                           "folded" if width <= _FOLDED_COLUMNS else "columns")
    else:
        ys = _linspace(tan_y, -tan_y, height)
        xs = _linspace(-tan_x, tan_x, width)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    dirs = torch.stack([xg, yg, -torch.ones_like(xg)], dim=-1)
    if fused:
        # The reduction's products pass through a shuffle: none is fused.
        sq = (dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1]) + dirs[..., 2] * dirs[..., 2]
        return dirs / sqrt_rn(sq)[..., None]
    return dirs / norm(dirs, keepdim=True)


def _ray_capsule(origin, direction, p0, p1, radius, ar: _Arith = _PLAIN):
    """Ray vs capsule (segment p0-p1, radius r), broadcasting over leading
    axes. Returns (t, hit): the entry distance (``_BIG`` when missed)."""
    ba = p1 - p0
    oa = origin - p0
    baba, bard, baoa = ar.dot(ba, ba), ar.dot(ba, direction), ar.dot(ba, oa)
    rdoa, oaoa = ar.dot(direction, oa), ar.dot(oa, oa)

    # The cylinder's quadratic; its discriminant cancels for grazing rays,
    # where the rounding of each product shows.
    a = ar.fma(-bard, bard, baba)
    b = ar.fma(baba, rdoa, -(baoa * bard))
    c = ar.fma(-(radius * radius), baba, ar.fma(baba, oaoa, -(baoa * baoa)))
    h = ar.fma(b, b, -(a * c))
    safe_a = torch.where(a.abs() < 1e-12, torch.full_like(a, 1e-12), a)
    t_cyl = (-b - torch.sqrt(torch.clamp(h, min=0.0))) / safe_a
    y = ar.fma(t_cyl, bard, baoa)
    cyl_hit = (h >= 0.0) & (y > 0.0) & (y < baba) & (t_cyl > 0.0)

    def sphere_t(center):
        oc = origin - center
        b_s = ar.dot(direction, oc)
        c_s = ar.fma(-radius, radius, ar.dot(oc, oc))
        h_s = ar.fma(b_s, b_s, -c_s)
        t_s = -b_s - torch.sqrt(torch.clamp(h_s, min=0.0))
        return torch.where((h_s >= 0.0) & (t_s > 0.0), t_s, torch.full_like(t_s, _BIG))

    t_caps = torch.minimum(sphere_t(p0), sphere_t(p1))
    t = torch.where(cyl_hit, t_cyl, t_caps)
    hit = t < _BIG
    return torch.where(hit, t, torch.full_like(t, _BIG)), hit


def _ray_plane(origin, direction, plane_z: float = 0.0):
    """Ray vs the horizontal plane z = plane_z. Returns (t, hit)."""
    dz = direction[..., 2]
    safe = torch.where(dz.abs() < 1e-12, torch.full_like(dz, 1e-12), dz)
    t = (plane_z - origin[..., 2]) / safe
    hit = (t > 0.0) & (dz.abs() > 1e-12)
    return torch.where(hit, t, torch.full_like(t, _BIG)), hit


def _ray_heightfield(model: PhysicsModel, origins, directions, n_march: int = 64,
                     n_bisect: int = 14, ar: _Arith = _PLAIN):
    """Ray vs the heightfield z = h(x, y): a march of ``n_march`` samples
    through the slab between the grid's lowest and highest heights, then
    ``n_bisect`` bisections of the first crossing.

    Returns (t, normal): hit distance (..., ``_BIG`` for a miss) and the
    surface normal at the hit (..., 3).
    """
    from flygym_tpu_torch.engine.contact import ground_height_normal

    hmax = torch.max(model.hfield_data) + 1e-4
    hmin = torch.min(model.hfield_data) - 1e-4
    oz = origins[..., 2]
    dz = directions[..., 2]
    tiny = torch.where(dz < 0, torch.full_like(dz, -1e-9), torch.full_like(dz, 1e-9))
    safe_dz = torch.where(dz.abs() < 1e-9, tiny, dz)
    t_top = (hmax - oz) / safe_dz
    t_bot = (hmin - oz) / safe_dz
    # The slab along the ray, forward only and capped at the fog distance
    # (near-horizontal rays inside the slab march this far).
    far = 80.0
    t0 = torch.clamp(torch.minimum(t_top, t_bot), 0.0, far)
    t1 = torch.clamp(torch.maximum(t_top, t_bot), 0.0, far)
    inside = (oz > hmin) & (oz < hmax)
    t1 = torch.where(inside & (dz.abs() < 1e-3), torch.full_like(t1, far), t1)
    valid = t1 > t0

    def f_of(t):
        # t: (..., M) samples; the signed height above the surface.
        p = ar.fma(t[..., :, None], directions[..., None, :], origins[..., None, :])
        h, _ = ground_height_normal(model, p[..., :2])
        return p[..., 2] - h

    fracs = _linspace(origins.new_zeros(()), origins.new_ones(()), n_march)
    ts = ar.fma((t1 - t0)[..., None], fracs, t0[..., None])
    below = f_of(ts) < 0.0
    any_hit = valid & below.any(dim=-1)
    first = below.to(torch.uint8).argmax(dim=-1)  # the first sample below (0 if none)
    lo_i = torch.clamp(first - 1, min=0)
    t_lo = torch.gather(ts, -1, lo_i[..., None])[..., 0]
    t_hi = torch.gather(ts, -1, first[..., None])[..., 0]
    for _ in range(n_bisect):
        t_mid = 0.5 * (t_lo + t_hi)
        up = f_of(t_mid[..., None])[..., 0] >= 0.0
        t_lo = torch.where(up, t_mid, t_lo)
        t_hi = torch.where(up, t_hi, t_mid)
    t = torch.where(any_hit, 0.5 * (t_lo + t_hi), torch.full_like(t_lo, _BIG))
    hit_xy = ar.fma(t[..., None], directions, origins)[..., :2]
    _, normal = ground_height_normal(model, hit_xy)
    return t, normal


def _capsule_segments(model: PhysicsModel, gpos, gquat, ar: _Arith = _PLAIN):
    """World capsule segments (p0, p1 (B, ngeom, 3), radius (ngeom,))."""
    z_axis = quat_rotate(gquat, gpos.new_tensor([0.0, 0.0, 1.0]))
    half = model.geom_size[:, 1, None]
    radius = model.geom_size[:, 0]
    return ar.fma(-half, z_axis, gpos), ar.fma(half, z_axis, gpos), radius


def _soft_shadow_capsules(p0, p1, radius, capsule_mask, origins, directions, k: float = 24.0,
                          max_t=None, ar: _Arith = _PLAIN):
    """Penumbra factor per shadow ray in [0, 1] (0 fully occluded): per geom
    the closest approach of the ray (t >= 0) to the capsule's surface,
    ``k * miss / t`` clamped, the minimum over the geoms swept in chunks of
    8. ``max_t`` (B, R), if given, bounds the search (a point light's
    distance), so that capsules beyond the light cast no shadow."""
    B, R = origins.shape[:2]
    pen = origins.new_ones((B, R))
    ngeom = p0.shape[1]
    for c0 in range(0, ngeom, _CHUNK):
        c1 = min(c0 + _CHUNK, ngeom)
        a0 = p0[:, None, c0:c1, :]
        ba = p1[:, None, c0:c1, :] - a0
        oa = origins[:, :, None, :] - a0
        d = directions[:, :, None, :]
        # Closest points of the ray (clamped below only) and the segment.
        a_q, e_q, b_q = ar.dot(d, d), ar.dot(ba, ba), ar.dot(d, ba)
        c_q, f_q = ar.dot(d, oa), ar.dot(ba, oa)
        denom = torch.clamp(ar.fma(a_q, e_q, -(b_q * b_q)), min=1e-12)
        s = torch.clamp(ar.fma(b_q, -c_q, f_q * a_q) / denom, 0.0, 1.0)
        t = torch.clamp(ar.fma(b_q, s, -c_q) / torch.clamp(a_q, min=1e-12), min=1e-6)
        gap = ar.fma(t[..., None], d, origins[:, :, None, :]) - ar.fma(s[..., None], ba, a0)
        miss = torch.sqrt(ar.dot(gap, gap)) - radius[c0:c1]
        # A floored t keeps a grazing ray from darkening its own surface and
        # reads as contact occlusion where a foot meets the ground.
        geom_pen = torch.clamp(k * miss / torch.clamp(t, min=0.2), 0.0, 1.0)
        one = torch.ones_like(geom_pen)
        geom_pen = torch.where(capsule_mask[c0:c1] > 0, geom_pen, one)
        if max_t is not None:
            geom_pen = torch.where(t > max_t[..., None], one, geom_pen)
        pen = torch.minimum(pen, torch.min(geom_pen, dim=-1).values)
    return pen


def _hash31(p: torch.Tensor, ar: _Arith = _FUSED) -> torch.Tensor:
    """3D → 1D lattice hash in [0, 1), the shader's sin hash. Fused, its
    argument is contracted as the JAX CPU backend contracts it under
    ``jit``, ``fma(z, 74.7, fma(x, 127.1, y * 311.7))``; plain, it is the
    left-to-right sum of JAX's eager operations."""
    if ar.fused:
        arg = fma32(p[..., 2], torch.full_like(p[..., 2], 74.7),
                    fma32(p[..., 0], torch.full_like(p[..., 0], 127.1), p[..., 1] * 311.7))
    else:
        arg = p[..., 0] * 127.1 + p[..., 1] * 311.7 + p[..., 2] * 74.7
    h = sinf(arg) * 43758.5453
    return h - torch.floor(h)


def _value_noise3(p: torch.Tensor, ar: _Arith = _FUSED) -> torch.Tensor:
    """Trilinear value noise on the unit lattice, in [0, 1)."""
    pi = torch.floor(p)
    pf = p - pi
    w = pf * pf * (3.0 - 2.0 * pf)  # smoothstep fade

    def corner(dx, dy, dz):
        return _hash31(pi + p.new_tensor([dx, dy, dz]), ar)

    def _lerp(a, b, w):
        return ar.fma(w, b - a, a)  # a + w (b - a)

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    nx00 = _lerp(corner(0, 0, 0), corner(1, 0, 0), wx)
    nx10 = _lerp(corner(0, 1, 0), corner(1, 1, 0), wx)
    nx01 = _lerp(corner(0, 0, 1), corner(1, 0, 1), wx)
    nx11 = _lerp(corner(0, 1, 1), corner(1, 1, 1), wx)
    nxy0 = _lerp(nx00, nx10, wy)
    nxy1 = _lerp(nx01, nx11, wy)
    return _lerp(nxy0, nxy1, wz)


def _nearest_capsule_hit(p0, p1, radius, capsule_mask, origins, directions, exclude=None,
                         ar: _Arith = _PLAIN):
    """Nearest capsule hit per ray: (t (B, R), geom index (B, R)), leaving
    out one geom per ray, ``exclude`` (B, R), where given (the second
    candidate of the mesh refinement).

    The geoms are swept in chunks of 8 with a running minimum, as the JAX
    package sweeps them: within a chunk the first minimum wins, across
    chunks only a strictly nearer one.
    """
    B, R = origins.shape[:2]
    t_geom = origins.new_full((B, R), _BIG)
    idx_geom = torch.zeros((B, R), dtype=torch.int64, device=origins.device)
    ngeom = p0.shape[1]
    for c0 in range(0, ngeom, _CHUNK):
        c1 = min(c0 + _CHUNK, ngeom)
        t_c, _ = _ray_capsule(
            origins[:, :, None, :],
            directions[:, :, None, :],
            p0[:, None, c0:c1, :],
            p1[:, None, c0:c1, :],
            radius[c0:c1],
            ar,
        )
        big = torch.full_like(t_c, _BIG)
        t_c = torch.where(capsule_mask[c0:c1] > 0, t_c, big)
        if exclude is not None:
            gids = torch.arange(c0, c1, device=origins.device)
            t_c = torch.where(gids == exclude[..., None], big, t_c)
        c_min, c_arg = torch.min(t_c, dim=-1)
        better = c_min < t_geom
        t_geom = torch.where(better, c_min, t_geom)
        idx_geom = torch.where(better, c_arg + c0, idx_geom)
    return t_geom, idx_geom


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, G, C) at per-ray indices idx (B, R): (B, R, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def raycast_scene(model: PhysicsModel, gpos, gquat, origins, directions, capsule_mask,
                  sdf_pack=None, fused: bool = False):
    """Nearest hit against the capsule geoms and the ground (the plane z = 0
    or the heightfield).

    Args:
        gpos/gquat: (B, ngeom, 3/4) world geom poses.
        origins/directions: (B, R, 3) rays.
        capsule_mask: (ngeom,) 1.0 for geoms rendered as capsules.
        sdf_pack: Mesh SDF tables (:func:`flygym_tpu_torch.render.sdf.
            build_sdf_pack`) or None. With them the two nearest capsule hits
            are candidates, and the body segments' mesh surfaces are sphere
            traced near them for the true silhouettes and normals.
        fused: Round products feeding sums as the JAX package's jitted
            renderer does (the camera); False as its eager operations do
            (the retina).

    Returns:
        t: (B, R) hit distance (``_BIG`` for sky).
        geom_idx: (B, R) nearest geom, -1 for the ground, -2 for sky.
        normal: (B, R, 3) surface normal at the hit.
    """
    ar = _FUSED if fused else _PLAIN
    p0, p1, radius = _capsule_segments(model, gpos, gquat, ar)
    t_geom, idx_geom = _nearest_capsule_hit(p0, p1, radius, capsule_mask, origins, directions,
                                            ar=ar)
    minus = lambda like, v: torch.full_like(like, v)

    mesh_hit = None
    if sdf_pack is not None:
        from flygym_tpu_torch.render.sdf import sdf_refine

        idx1 = torch.where(t_geom < _BIG, idx_geom, minus(idx_geom, -2))
        t2, idx2_raw = _nearest_capsule_hit(p0, p1, radius, capsule_mask, origins, directions,
                                            exclude=idx1, ar=ar)
        idx2 = torch.where(t2 < _BIG, idx2_raw, minus(idx2_raw, -2))
        t_mesh, idx_mesh, n_mesh, mesh_hit = sdf_refine(
            sdf_pack, model, gpos, gquat, origins, directions, [t_geom, t2], [idx1, idx2])
        # Candidates that carry an SDF defer to the mesh result; geoms
        # without one keep their capsule hit.
        refined = sdf_pack["base"][torch.clamp(idx1, min=0)] >= 0
        t_geom = torch.where(mesh_hit, t_mesh, torch.where(refined, minus(t_geom, _BIG), t_geom))
        idx_geom = torch.where(mesh_hit, idx_mesh, idx_geom)

    if model.has_hfield:
        t_plane, n_ground = _ray_heightfield(model, origins, directions, ar=ar)
    else:
        t_plane, _ = _ray_plane(origins, directions, 0.0)
        n_ground = origins.new_tensor([0.0, 0.0, 1.0]).expand(origins.shape)

    t = torch.minimum(t_geom, t_plane)
    geom_idx = torch.where(
        t_geom <= t_plane, idx_geom,
        torch.where(t_plane < _BIG, minus(idx_geom, -1), minus(idx_geom, -2)),
    )
    geom_idx = torch.where(t < _BIG, geom_idx, minus(geom_idx, -2))

    # Normals.
    hit_p = ar.fma(t[..., None], directions, origins)
    seg_a, seg_b = _gather_rows(p0, idx_geom), _gather_rows(p1, idx_geom)
    ba = seg_b - seg_a
    denom = torch.clamp(ar.dot(ba, ba), min=1e-12)
    s = torch.clamp(ar.dot(hit_p - seg_a, ba) / denom, 0.0, 1.0)
    n_caps = hit_p - ar.fma(s[..., None], ba, seg_a)
    n_caps = n_caps / torch.clamp(torch.sqrt(ar.dot(n_caps, n_caps))[..., None], min=1e-12)
    if mesh_hit is not None:
        n_caps = torch.where(mesh_hit[..., None], n_mesh, n_caps)
    normal = torch.where((geom_idx >= 0)[..., None], n_caps, n_ground)
    return t, geom_idx, normal


def _bilinear_wrap(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, 3) texture at wrapped UVs (...) → (..., 3)."""
    ht, wt = tex.shape[0], tex.shape[1]
    x = torch.remainder(u, 1.0) * wt - 0.5
    y = torch.remainder(v, 1.0) * ht - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = torch.remainder(x0.to(torch.int32), wt).long()
    xi1 = torch.remainder(xi0 + 1, wt)
    yi0 = torch.remainder(y0.to(torch.int32), ht).long()
    yi1 = torch.remainder(yi0 + 1, ht)
    cx0 = tex[yi0, xi0] * (1 - fx) + tex[yi0, xi1] * fx
    cx1 = tex[yi1, xi0] * (1 - fx) + tex[yi1, xi1] * fx
    return cx0 * (1 - fy) + cx1 * fy


def _light_vector(vec, like: torch.Tensor) -> torch.Tensor:
    """A light's vector, (3,) for every world or (B, 3) per world, as (B or
    1, 1, 3) on ``like``'s device."""
    vec = torch.as_tensor(vec, dtype=like.dtype, device=like.device)
    return vec.reshape(-1, 1, 3)


def _rgb(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).reshape(3)


def render_pixels(model: PhysicsModel, gpos, gquat, cam_pos, cam_quat, height: int, width: int,
                  fovy_deg: float, capsule_mask, checker_period: float = 1.0, sdf_pack=None,
                  ground_texture=None, ground_texture_period: float = 10.0, sky_texture=None,
                  lights=None, fused: bool = True):
    """Render an RGB frame of every world: (B, H, W, 3) floats in [0, 1].

    Args:
        gpos/gquat: (B, ngeom, 3/4) world geom poses.
        cam_pos/cam_quat: (B, 3) and (B, 4) camera poses (-z forward, y up).
        capsule_mask: (ngeom,) 1.0 for geoms rendered as capsules.
        sdf_pack: Mesh SDF tables for mesh fidelity, or None.
        ground_texture: (h, w, 3) image planar-mapped on the ground, one
            repeat per ``ground_texture_period`` mm, in place of the
            checkerboard; ``sky_texture`` an equirectangular sky dome.
        lights: A sequence of dicts: ``kind`` "directional" (``vec`` the
            direction of travel) or "point" (``vec`` its position, (3,) or
            (B, 3) per world, inverse-square falloff over ``falloff`` mm),
            ``color`` and optional ``specular`` RGB, ``cast_shadow``. None
            is :func:`default_lights`.
        fused: Round products feeding sums as the JAX package's jitted
            ``Renderer`` does; False as its eager ``FlyEnv.render`` does.

    Shading as the JAX package's (``flygym_tpu/render/raycast.py:429-644``):
    per light Lambert and Blinn-Phong with soft capsule shadows, a camera
    headlight fill, the material table's gradient textures and random
    markings from body-local value noise, a noise-tinted checkerboard
    ground (tinted by height on a heightfield) and distance fog.
    """
    B = gpos.shape[0]
    dirs_cam = camera_rays(height, width, fovy_deg, gpos.device, fused=fused).reshape(-1, 3)
    R = quat_to_mat(cam_quat)
    dirs = torch.matmul(dirs_cam, R.transpose(-1, -2))  # (B, P, 3)
    origins = cam_pos[:, None, :].expand(dirs.shape)

    ar = _FUSED if fused else _PLAIN
    t, geom_idx, normal = raycast_scene(model, gpos, gquat, origins, dirs, capsule_mask,
                                        sdf_pack=sdf_pack, fused=fused)
    hit_p = ar.fma(t[..., None], dirs, origins)
    is_geom = (geom_idx >= 0)[..., None]
    is_ground = (geom_idx == -1)[..., None]
    is_sky = (geom_idx == -2)[..., None]

    # Base colours from the material table (geom_rgba, geom_matprops,
    # geom_tex: flat and gradient textures with random markings).
    gi_safe = torch.clamp(geom_idx, min=0)
    geom_rgb = model.geom_rgba[gi_safe, :3]
    tex = model.geom_tex[gi_safe]  # (B, P, 11)
    builtin = tex[..., 0]
    local_p = quat_rotate(quat_conj(_gather_rows(gquat, gi_safe)),
                          hit_p - _gather_rows(gpos, gi_safe))
    # Gradient textures blend rgb1 → rgb2 along the geom's local z axis.
    halfspan = torch.clamp(model.geom_size[gi_safe, 1] + model.geom_size[gi_safe, 0], min=1e-6)
    t_grad = torch.clamp(0.5 + local_p[..., 2] / (2.0 * halfspan), 0.0, 1.0)[..., None]
    grad_rgb = tex[..., 1:4] * (1.0 - t_grad) + tex[..., 4:7] * t_grad
    geom_rgb = torch.where((builtin >= 2.0)[..., None], grad_rgb, geom_rgb)
    # Random markings: body-local value noise under the material's mark
    # probability blends toward the mark colour; the cuticle's speckle.
    mark_noise = (_value_noise3(local_p * 14.0, ar) + 0.5 * _value_noise3(local_p * 41.0, ar)) / 1.5
    textured = (builtin > 0.0).to(t.dtype)
    mark_w = torch.clamp((tex[..., 10] - mark_noise) / torch.clamp(tex[..., 10], min=1e-6),
                         0.0, 1.0) * textured
    geom_rgb = geom_rgb * (1.0 - mark_w[..., None]) + tex[..., 7:10] * mark_w[..., None]
    geom_rgb = geom_rgb * (1.0 - 0.18 * textured[..., None] * (0.5 - mark_noise)[..., None])

    if ground_texture is not None:
        ground_rgb = _bilinear_wrap(
            torch.as_tensor(ground_texture, dtype=t.dtype, device=t.device),
            hit_p[..., 0] / ground_texture_period, hit_p[..., 1] / ground_texture_period)
    else:
        checker = torch.remainder(torch.floor(hit_p[..., 0] / checker_period)
                                  + torch.floor(hit_p[..., 1] / checker_period), 2.0)
        ground_rgb = torch.where(checker[..., None] > 0.5, dirs.new_full((3,), 0.4),
                                 dirs.new_full((3,), 0.3))
        # A large-scale noise tint breaks up the checker's flatness.
        gnoise = _value_noise3(hit_p * hit_p.new_tensor([0.7, 0.7, 0.0]), ar)
        ground_rgb = ground_rgb * (0.9 + 0.2 * gnoise[..., None])
    if model.has_hfield:
        hmin = torch.min(model.hfield_data)
        zspan = torch.clamp(torch.max(model.hfield_data) - hmin, min=1e-6)
        rel_h = torch.clamp((hit_p[..., 2] - hmin) / zspan, 0.0, 1.0)[..., None]
        low_rgb = dirs.new_tensor([0.42, 0.36, 0.26])  # sandy
        high_rgb = dirs.new_tensor([0.45, 0.45, 0.47])  # rocky
        ground_rgb = ground_rgb * 0.35 + 0.65 * (low_rgb * (1 - rel_h) + high_rgb * rel_h)
    if sky_texture is not None:
        # Equirectangular dome: azimuth → u, elevation → v (clamped).
        az = torch.atan2(dirs[..., 1], dirs[..., 0])
        el = torch.asin(torch.clamp(dirs[..., 2], -1.0, 1.0))
        sky_rgb = _bilinear_wrap(
            torch.as_tensor(sky_texture, dtype=t.dtype, device=t.device),
            az / (2.0 * math.pi) + 0.5, torch.clamp(0.5 - el / math.pi, 0.0, 1.0 - 1e-6))
    else:
        sky_rgb = dirs.new_tensor([0.65, 0.75, 0.9]).expand(dirs.shape)
    base = torch.where(is_geom, geom_rgb, torch.where(is_ground, ground_rgb, sky_rgb))

    # Lighting: per light Lambert and Blinn-Phong with soft capsule shadows,
    # and a camera-headlight fill. Shadows sweep the capsules only.
    if lights is None:
        lights = default_lights(t.device)
    p0, p1, radius = _capsule_segments(model, gpos, gquat, ar)
    shadow_orig = ar.fma(torch.full_like(normal, 1e-2), normal, hit_p)  # 10 µm bias in a mm-scale scene
    # Per-geom specular strength and highlight exponent (shininess).
    matprops = model.geom_matprops[gi_safe]
    ks = torch.where(geom_idx >= 0, matprops[..., 0], torch.full_like(t, 0.06))
    spec_exp = torch.where(geom_idx >= 0, 4.0 + 128.0 * matprops[..., 1],
                           torch.full_like(t, 32.0))
    headlight = torch.abs(ar.dot(normal, -dirs))
    shade_rgb = (0.30 + 0.25 * headlight)[..., None].expand(hit_p.shape)
    spec_rgb = torch.zeros_like(hit_p)
    for li in lights:
        vec = _light_vector(li["vec"], t)
        if li["kind"] == "directional":
            l_dir = -vec / torch.clamp(norm(vec, keepdim=True), min=1e-9)
            l_dirs = l_dir.expand(hit_p.shape)
            atten = torch.ones_like(t)
            l_dist = None
        else:  # a point light
            to_l = vec - hit_p
            dist = torch.clamp(norm(to_l), min=1e-9)
            l_dirs = to_l / dist[..., None]
            q = dist / float(li.get("falloff", 30.0))
            atten = 1.0 / (1.0 + q * q)
            l_dist = dist
        if li.get("cast_shadow", True):
            penumbra = _soft_shadow_capsules(p0, p1, radius, capsule_mask, shadow_orig, l_dirs,
                                             max_t=l_dist, ar=ar)
            lit = 0.35 + 0.65 * penumbra  # never fully black in the umbra
        else:
            lit = torch.ones_like(t)
        color = _rgb(li["color"], t)
        spec_c = _rgb(li.get("specular", li["color"]), t)
        diffuse = torch.clamp(ar.dot(normal, l_dirs), min=0.0)
        shade_rgb = shade_rgb + color * (diffuse * lit * atten)[..., None]
        # Blinn-Phong: a wet-cuticle highlight on the fly, a sheen on the ground.
        half_v = l_dirs - dirs
        half_v = half_v / torch.clamp(norm(half_v, keepdim=True), min=1e-9)
        spec_dot = torch.clamp(ar.dot(normal, half_v), min=0.0)
        spec_rgb = spec_rgb + spec_c * (ks * powf(spec_dot, spec_exp) * lit * atten)[..., None]
    rgb = base * torch.where(is_sky, torch.ones_like(shade_rgb), shade_rgb)
    rgb = rgb + torch.where(is_sky, torch.zeros_like(spec_rgb), spec_rgb)

    # A distance fog on the ground, for depth.
    fog = torch.clamp(t / 60.0, 0.0, 1.0)[..., None]
    rgb = torch.where(is_ground, rgb * (1 - fog) + sky_rgb * fog, rgb)
    return torch.clamp(rgb, 0.0, 1.0).reshape(B, height, width, 3)
