"""Frozen copy of the plain retina, its tables and the acceptance blur.

Copied from ``flygym_tpu_torch/vision.py`` (the lattice, ``Retina.build``,
``_mix``) and ``flygym_tpu_torch/ops/retina.py`` (the tables the plain
version reads, ``pack_rows``, ``retina_plain``, ``contributing_pairs``), the
tables built here from the reference's own model (numpy). Nothing of the
port is imported.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.maths import quat_mul, quat_rotate, sqrt_rn

_BIG = 1e30
# Per world: 2 eyes x (pos 3 + quat 4), then G x (p0 3, p1 3).
_EYE_ROWS = 14



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
    """Retina geometry and channel tables for both eyes (numpy, as built)."""

    left_eye_body: int
    right_eye_body: int
    directions_left: np.ndarray
    directions_right: np.ndarray
    channel_weights: np.ndarray
    n_ommatidia: int
    blur_weights: np.ndarray | None = None
    cone_half_rad: float = 0.0



def build_retina(
    model,
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

    return Retina(
        left_eye_body=left_eye_body,
        right_eye_body=right_eye_body,
        directions_left=dirs_l.astype(np.float32),
        directions_right=dirs_r.astype(np.float32),
        channel_weights=weights.astype(np.float32),
        n_ommatidia=n,
        blur_weights=blur,
        cone_half_rad=float(np.deg2rad(acceptance_fwhm_deg / 2.0)),
    )


class RetinaTables:
    """What the plain version reads besides the per-world rows: the rendered
    geoms (capsules and spheres) with their radius and colour, the ray
    directions and channel weights in lattice order, the ground height and
    the shading branch."""

    def __init__(self, model, retina, device):
        self.vis_geoms = [g for g, t in enumerate(model.geom_types) if t in ("capsule", "sphere")]
        self.G = len(self.vis_geoms)
        self.R = int(retina.n_ommatidia)
        self.eye_bodies = (int(retina.left_eye_body), int(retina.right_eye_body))
        sel = np.asarray(self.vis_geoms, np.int64)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device).contiguous()
        self.radius = f32(model.geom_size[sel, 0])
        self.rgb = f32(model.geom_rgba[sel, :3])
        self.half = f32(model.geom_size[sel, 1])
        self.geom_body = torch.as_tensor(model.geom_body[sel]).to(device)
        self.geom_pos = f32(model.geom_pos[sel])
        self.geom_quat = f32(model.geom_quat[sel])
        self.dirs = f32(np.stack([retina.directions_left, retina.directions_right]))
        self.weights = f32(retina.channel_weights)
        self.ground_z = float(np.float32(model.ground_pos[2]))
        self.use_cone = float(retina.cone_half_rad) > 0.0
        self.tanh_cone = float(np.float32(np.tan(retina.cone_half_rad)))



def pack_rows(tables, xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
    """(B, 14 + 6G) kernel rows from (B, nbody, 3/4) body poses
    (``retina_pallas.py:449-463``)."""
    B = xpos.shape[0]
    rows = []
    for eb in tables.eye_bodies:
        rows += [xpos[:, eb], xquat[:, eb]]
    gb = tables.geom_body
    gpos = xpos[:, gb] + quat_rotate(xquat[:, gb], tables.geom_pos)
    gquat = quat_mul(xquat[:, gb], tables.geom_quat)
    # The z axis made on the device: a copy from the host (``new_tensor``)
    # waits for the card's queue to drain.
    zax = quat_rotate(gquat, torch.cat([xpos.new_zeros(2), xpos.new_ones(1)]))
    half = tables.half[None, :, None]
    p0 = gpos - half * zax
    p1 = gpos + half * zax
    rows.append(torch.cat([p0, p1], dim=-1).reshape(B, 6 * tables.G))
    return torch.cat(rows, dim=1).to(torch.float32).contiguous()


def retina_plain(tables, packed: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: (B, 14 + 6G) rows → (B, 2, R, 2).

    Rays run as (B, 2, R) tensors; the hoisted per-geom quantities are
    (B, 2, G) and broadcast over the rays; the geoms are swept in order, as
    the Pallas kernel unrolls them.
    """
    B, G = packed.shape[0], tables.G
    eye = packed[:, :_EYE_ROWS].reshape(B, 2, 7)
    col = lambda i: eye[:, :, i : i + 1]  # (B, 2, 1)
    opos = (col(0), col(1), col(2))
    w_, x_, y_, z_ = col(3), col(4), col(5), col(6)
    seg = packed[:, _EYE_ROWS:].reshape(B, 1, G, 6)  # broadcast over the eyes
    big = lambda like: torch.full_like(like, _BIG)
    zeros = torch.zeros_like

    # ---- hoisted per-geom quantities, (B, 2, G) ----
    ep = eye[:, :, None, 0:3]  # (B, 2, 1, 3)
    p0 = [seg[..., k].expand(B, 2, G) for k in range(3)]
    ba = [seg[..., 3 + k] - seg[..., k] for k in range(3)]
    ba = [b.expand(B, 2, G) for b in ba]
    oa = [ep[..., k] - seg[..., k] for k in range(3)]
    ob = [ep[..., k] - seg[..., 3 + k] for k in range(3)]
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    baba, baoa, oaoa, obob = dot(ba, ba), dot(ba, oa), dot(oa, oa), dot(ob, ob)
    r = tables.radius
    rr = r * r
    c_cyl = baba * oaoa - baoa * baoa - rr * baba
    c_s0 = oaoa - rr
    c_s1 = obob - rr
    s0g = torch.clamp(baoa / torch.clamp(baba, min=1e-12), 0.0, 1.0)
    d0sq = oaoa - 2.0 * s0g * baoa + s0g * s0g * baba
    outside = (d0sq > rr).to(torch.float32)
    ibaba = 1.0 / torch.clamp(baba, min=1e-12)

    # ---- rays in the world frame, (B, 2, R) ----
    dx, dy, dz = (tables.dirs[None, :, :, k] for k in range(3))
    tx = 2.0 * (y_ * dz - z_ * dy)
    ty = 2.0 * (z_ * dx - x_ * dz)
    tz = 2.0 * (x_ * dy - y_ * dx)
    rdx = dx + w_ * tx + (y_ * tz - z_ * ty)
    rdy = dy + w_ * ty + (z_ * tx - x_ * tz)
    rdz = dz + w_ * tz + (x_ * ty - y_ * tx)

    t_min = big(rdx)
    idx = torch.full_like(rdx, -2.0)
    w_p0 = [zeros(rdx) for _ in range(3)]
    w_ba = [zeros(rdx) for _ in range(3)]
    w_ibaba = torch.ones_like(rdx)
    cr, cg, cb = zeros(rdx), zeros(rdx), zeros(rdx)

    # Ground plane.
    oz = opos[2]
    tp = (tables.ground_z - oz) / torch.where(rdz.abs() < 1e-12, torch.full_like(rdz, 1e-12), rdz)
    hitp = (tp > 0.0) & (rdz.abs() > 1e-12)
    t_min = torch.where(hitp, tp, t_min)
    idx = torch.where(hitp, torch.full_like(idx, -1.0), idx)
    if tables.use_cone:
        t_bg = torch.where(hitp, tp, big(tp))
        hxb = opos[0] + tp * rdx
        hyb = opos[1] + tp * rdy
        chk_b = torch.remainder(torch.floor(hxb) + torch.floor(hyb), 2.0)
        bgc = torch.where(chk_b > 0.5, torch.full_like(chk_b, 0.4), torch.full_like(chk_b, 0.3))
        bg_shade = torch.where(hitp, 0.5 + 0.5 * rdz.abs(), torch.ones_like(rdz))
        bg_r = torch.where(hitp, bgc, torch.full_like(bgc, 0.65)) * bg_shade
        bg_g = torch.where(hitp, bgc, torch.full_like(bgc, 0.75)) * bg_shade
        bg_b = torch.where(hitp, bgc, torch.full_like(bgc, 0.9)) * bg_shade
        cov, cov_r, cov_g, cov_b = zeros(rdx), zeros(rdx), zeros(rdx), zeros(rdx)

    for g in range(G):
        at = lambda x: x[..., g : g + 1]  # (B, 2, 1)
        bax, bay, baz = (at(b) for b in ba)
        oax, oay, oaz = (at(o) for o in oa)
        g_baba, g_baoa = at(baba), at(baoa)
        bard = bax * rdx + bay * rdy + baz * rdz
        rdoa = oax * rdx + oay * rdy + oaz * rdz
        a_ = g_baba - bard * bard
        b_ = g_baba * rdoa - g_baoa * bard
        h_ = b_ * b_ - a_ * at(c_cyl)
        safe_a = torch.where(a_.abs() < 1e-12, torch.full_like(a_, 1e-12), a_)
        t_cyl = (-b_ - sqrt_rn(torch.clamp(h_, min=0.0))) / safe_a
        y_c = g_baoa + t_cyl * bard
        cyl_ok = (h_ >= 0.0) & (y_c > 0.0) & (y_c < g_baba) & (t_cyl > 0.0)
        # Endpoint spheres; d . (o - p0) is rdoa.
        b_s0 = rdoa
        h_s0 = b_s0 * b_s0 - at(c_s0)
        t_s0 = -b_s0 - sqrt_rn(torch.clamp(h_s0, min=0.0))
        t_s0 = torch.where((h_s0 >= 0.0) & (t_s0 > 0.0), t_s0, big(t_s0))
        b_s1 = at(ob[0]) * rdx + at(ob[1]) * rdy + at(ob[2]) * rdz
        h_s1 = b_s1 * b_s1 - at(c_s1)
        t_s1 = -b_s1 - sqrt_rn(torch.clamp(h_s1, min=0.0))
        t_s1 = torch.where((h_s1 >= 0.0) & (t_s1 > 0.0), t_s1, big(t_s1))
        t_g = torch.where(cyl_ok, t_cyl, torch.minimum(t_s0, t_s1))
        better = t_g < t_min
        t_min = torch.where(better, t_g, t_min)
        idx = torch.where(better, torch.full_like(idx, float(g)), idx)
        for k, (p, b) in enumerate(zip(p0, ba)):
            w_p0[k] = torch.where(better, at(p), w_p0[k])
            w_ba[k] = torch.where(better, at(b), w_ba[k])
        w_ibaba = torch.where(better, at(ibaba), w_ibaba)
        colr, colg, colb = (tables.rgb[g, k] for k in range(3))
        cr = torch.where(better, colr, cr)
        cg = torch.where(better, colg, cg)
        cb = torch.where(better, colb, cb)
        if tables.use_cone:
            # Ray-axis closest approach -> angular coverage of the cone.
            s_c = torch.clamp((g_baoa - bard * b_s0) / torch.clamp(a_, min=1e-12), 0.0, 1.0)
            tc = torch.clamp(bard * s_c - b_s0, min=1e-6)
            dxc = oax + tc * rdx - s_c * bax
            dyc = oay + tc * rdy - s_c * bay
            dzc = oaz + tc * rdz - s_c * baz
            dperp = sqrt_rn(dxc * dxc + dyc * dyc + dzc * dzc)
            width = torch.clamp(tc * tables.tanh_cone, min=1e-9)
            c_g2 = torch.clamp(0.5 - 0.5 * (dperp - r[g]) / width, 0.0, 1.0)
            c_g2 = c_g2 * at(outside)
            c_g2 = torch.where(tc < t_bg, c_g2, zeros(c_g2))
            bett = c_g2 > cov
            cov = torch.where(bett, c_g2, cov)
            cov_r = torch.where(bett, colr, cov_r)
            cov_g = torch.where(bett, colg, cov_g)
            cov_b = torch.where(bett, colb, cov_b)

    # ---- the winner's normal, from its carried segment ----
    hx = opos[0] + t_min * rdx
    hy = opos[1] + t_min * rdy
    hz = opos[2] + t_min * rdz
    s_ = ((hx - w_p0[0]) * w_ba[0] + (hy - w_p0[1]) * w_ba[1] + (hz - w_p0[2]) * w_ba[2]) * w_ibaba
    s_ = torch.clamp(s_, 0.0, 1.0)
    dx_ = hx - (w_p0[0] + s_ * w_ba[0])
    dy_ = hy - (w_p0[1] + s_ * w_ba[1])
    dz_ = hz - (w_p0[2] + s_ * w_ba[2])
    nrm = sqrt_rn(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    inv_n = 1.0 / torch.clamp(nrm, min=1e-12)
    is_geom = idx >= 0.0
    nx = torch.where(is_geom, dx_ * inv_n, zeros(dx_))
    ny = torch.where(is_geom, dy_ * inv_n, zeros(dy_))
    nz = torch.where(is_geom, dz_ * inv_n, torch.ones_like(dz_))
    lam = torch.abs(-(nx * rdx + ny * rdy + nz * rdz))
    if tables.use_cone:
        gshade = 0.5 + 0.5 * lam
        g_r = torch.where(is_geom, cr * gshade, 0.5 * cov_r)
        g_g = torch.where(is_geom, cg * gshade, 0.5 * cov_g)
        g_b = torch.where(is_geom, cb * gshade, 0.5 * cov_b)
        cr = torch.clamp(cov * g_r + (1.0 - cov) * bg_r, 0.0, 1.0)
        cg = torch.clamp(cov * g_g + (1.0 - cov) * bg_g, 0.0, 1.0)
        cb = torch.clamp(cov * g_b + (1.0 - cov) * bg_b, 0.0, 1.0)
    else:
        is_ground = idx == -1.0
        is_sky = idx == -2.0
        checker = torch.remainder(torch.floor(hx) + torch.floor(hy), 2.0)
        gcol = torch.where(checker > 0.5, torch.full_like(checker, 0.4), torch.full_like(checker, 0.3))
        sky = lambda v: torch.full_like(cr, v)
        cr = torch.where(is_ground, gcol, torch.where(is_sky, sky(0.65), cr))
        cg = torch.where(is_ground, gcol, torch.where(is_sky, sky(0.75), cg))
        cb = torch.where(is_ground, gcol, torch.where(is_sky, sky(0.9), cb))
        shade = torch.where(is_sky, torch.ones_like(lam), 0.5 + 0.5 * lam)
        cr = torch.clamp(cr * shade, 0.0, 1.0)
        cg = torch.clamp(cg * shade, 0.0, 1.0)
        cb = torch.clamp(cb * shade, 0.0, 1.0)

    # Channel weights: intensity_k = dot(rgb, w_k).
    wt = tables.weights  # (R, 2, 3)
    out = [cr * wt[:, k, 0] + cg * wt[:, k, 1] + cb * wt[:, k, 2] for k in range(2)]
    return torch.stack(out, dim=-1)


def contributing_pairs(tables, packed: torch.Tensor) -> torch.Tensor:
    """Which (world, eye, ray, geom) pairs K3's sweep needs: (B, 2, R, G)
    bool, True where the geom can change the ray's running state, a hit
    (t_g < 1e30) or, in the cone branch, a coverage c_g2 > 0, in
    :func:`retina_plain`'s arithmetic. The cull must keep every tile with
    such a ray (``tests/test_torch_retina_cull.py``); ``chip_smoke.py``
    counts K3's bound on these pairs alone."""
    B, G = packed.shape[0], tables.G
    eye = packed[:, :_EYE_ROWS].reshape(B, 2, 7)
    seg = packed[:, _EYE_ROWS:].reshape(B, 1, G, 6)
    ep = eye[:, :, None, 0:3]
    col = lambda x: x[:, :, None, :]  # (B, 2, G) -> (B, 2, 1, G), broadcast over rays
    ba = [col((seg[..., 3 + k] - seg[..., k]).expand(B, 2, G)) for k in range(3)]
    oa = [col(ep[..., k] - seg[..., k]) for k in range(3)]
    ob = [col(ep[..., k] - seg[..., 3 + k]) for k in range(3)]
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    baba, baoa, oaoa, obob = dot(ba, ba), dot(ba, oa), dot(oa, oa), dot(ob, ob)
    r = tables.radius
    rr = r * r
    c_cyl = baba * oaoa - baoa * baoa - rr * baba
    s0g = torch.clamp(baoa / torch.clamp(baba, min=1e-12), 0.0, 1.0)
    outside = (oaoa - 2.0 * s0g * baoa + s0g * s0g * baba > rr).to(torch.float32)
    w_, x_, y_, z_ = (eye[:, :, i : i + 1] for i in range(3, 7))
    dx, dy, dz = (tables.dirs[None, :, :, k] for k in range(3))
    tx, ty, tz = 2.0 * (y_ * dz - z_ * dy), 2.0 * (z_ * dx - x_ * dz), 2.0 * (x_ * dy - y_ * dx)
    rdx = dx + w_ * tx + (y_ * tz - z_ * ty)
    rdy = dy + w_ * ty + (z_ * tx - x_ * tz)
    rdz = dz + w_ * tz + (x_ * ty - y_ * tx)
    tp = (tables.ground_z - eye[:, :, 2:3]) / torch.where(rdz.abs() < 1e-12, torch.full_like(rdz, 1e-12), rdz)
    t_bg = torch.where((tp > 0.0) & (rdz.abs() > 1e-12), tp, torch.full_like(tp, 1e30))[..., None]
    rd = [v[..., None] for v in (rdx, rdy, rdz)]
    bard, rdoa, b_s1 = dot(ba, rd), dot(oa, rd), dot(ob, rd)
    a_ = baba - bard * bard
    b_ = baba * rdoa - baoa * bard
    h_ = b_ * b_ - a_ * c_cyl
    safe_a = torch.where(a_.abs() < 1e-12, torch.full_like(a_, 1e-12), a_)
    t_cyl = (-b_ - sqrt_rn(torch.clamp(h_, min=0.0))) / safe_a
    y_c = baoa + t_cyl * bard
    hit = (h_ >= 0.0) & (y_c > 0.0) & (y_c < baba) & (t_cyl > 0.0)
    for b_s, c_s in ((rdoa, oaoa - rr), (b_s1, obob - rr)):
        h_s = b_s * b_s - c_s
        hit |= (h_s >= 0.0) & (-b_s - sqrt_rn(torch.clamp(h_s, min=0.0)) > 0.0)
    if not tables.use_cone:
        return hit
    s_c = torch.clamp((baoa - bard * rdoa) / torch.clamp(a_, min=1e-12), 0.0, 1.0)
    tc = torch.clamp(bard * s_c - rdoa, min=1e-6)
    dc = [o + tc * v - s_c * b for o, v, b in zip(oa, rd, ba)]
    dperp = sqrt_rn(dot(dc, dc))
    width = torch.clamp(tc * tables.tanh_cone, min=1e-9)
    c_g2 = torch.clamp(0.5 - 0.5 * (dperp - r) / width, 0.0, 1.0) * outside
    return hit | ((tc < t_bg) & (c_g2 > 0.0))

