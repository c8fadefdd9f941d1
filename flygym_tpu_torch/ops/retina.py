"""The retina kernel K3: both eyes of every world in one launch.

Port of ``flygym_tpu/ops/retina_pallas.py:49-554``. Three parts:

- :func:`pack_rows`, the per-world inputs the kernel reads: eye poses and
  the world-frame segments of the G rendered geoms (capsules and spheres),
  plain tensor ops on ``xpos``/``xquat`` as the JAX package computes them
  outside ``pallas_call`` (:440-463).
- :func:`retina_plain`, the plain version: the Pallas kernel's body
  (:133-398) transcribed over (B, eye, ray) tensors, with the per-geom
  quantities hoisted per (world, eye), both shading branches, and every
  ``where``, clamp, ``1e-12`` guard and the 1e30 sentinel as they are.
- :func:`make_retina_kernel`, the wrapper of ``csrc/retina.cu``: for CPU
  tensors it runs :func:`retina_plain`; for CUDA tensors it launches K3 or
  raises. K3 shades each eye's rays in compact tiles of 32
  (:func:`ray_tiles`, kept in :class:`RetinaTables`) and sweeps, per tile,
  only the geoms whose bounding sphere its cone can reach; the outputs are
  the same bits as sweeping every geom.

``launches["retina"]`` counts kernel launches; only a launch adds to it
(the recorder's ``launches.retina``). A render's spans are
``flygym.retina.pack_rows`` and ``flygym.retina.launch``.
K3 has no gradient: given rows that require grad in grad mode, a launch
raises (``ops.refuse_grad``), as JAX's Pallas kernel, which has no VJP, does.

Not ported (TPU lane choices, see ROADMAP "Not to port"): the worlds-major
and ray-major layouts and the ``layout=`` argument.
"""

import numpy as np
import torch

from flygym_tpu_torch.engine.maths import quat_mul, quat_rotate, sqrt_rn
from flygym_tpu_torch.engine.model import PhysicsModel, State
from flygym_tpu_torch.ops import refuse_grad
from flygym_tpu_torch.utils.profiling import register_launches, span

__all__ = [
    "contributing_pairs",
    "kernel_shape",
    "keep_mask",
    "launch_build",
    "launch_retina",
    "launches",
    "make_retina_kernel",
    "pack_rows",
    "ray_tiles",
    "reset_launches",
    "retina_kernel_supported",
    "retina_plain",
    "RetinaTables",
    "TILE",
]

_BIG = 1e30
# Per world: 2 eyes x (pos 3 + quat 4), then G x (p0 3, p1 3).
_EYE_ROWS = 14
# Rays per tile: one warp of K3.
TILE = 32

launches = {"retina": 0}
register_launches(launches)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def retina_kernel_supported(model: PhysicsModel) -> bool:
    """The kernel shades a flat ground plane at ``model.ground_pos``;
    heightfield worlds are not supported."""
    return not model.has_hfield


def ray_tiles(dirs: np.ndarray, tile: int = TILE) -> tuple:
    """One eye's rays in compact tiles of ``tile`` slots: recursive
    bisection of the directions (float64) across their widest spread (the
    first principal axis), the first half a whole number of tiles, so that
    the last tile holds the remainder.

    Returns ``order`` (T * tile,) int64, the ray of each slot or -1 for a
    pad slot, and ``axis`` (T, 4) float32: each tile's unit axis (its rays'
    normalised mean, rounded to float32) and the largest angle from that
    float32 axis to one of its rays, rounded up to float32, so that the
    tile's cone holds every one of its rays.
    """
    d = np.asarray(dirs, np.float64)
    n_tiles = -(-len(d) // tile)

    def split(ids, nt):
        if nt == 1:
            return [ids]
        p = d[ids] - d[ids].mean(axis=0)
        u = np.linalg.svd(p, full_matrices=False)[2][0]
        u = u * np.sign(u[np.argmax(np.abs(u))])  # one sign on every machine
        ids = ids[np.argsort(p @ u, kind="stable")]
        left = nt // 2
        return split(ids[: left * tile], left) + split(ids[left * tile :], nt - left)

    order = np.full(n_tiles * tile, -1, np.int64)
    axis = np.zeros((n_tiles, 4), np.float32)
    for t, ids in enumerate(split(np.arange(len(d)), n_tiles)):
        order[t * tile : t * tile + len(ids)] = ids
        mean = d[ids].sum(axis=0)
        a = (mean / np.linalg.norm(mean)).astype(np.float32)
        a64 = a.astype(np.float64)
        half = np.arctan2(np.linalg.norm(np.cross(d[ids], a64), axis=1), d[ids] @ a64).max()
        h = np.float32(half)
        axis[t, :3] = a
        axis[t, 3] = h if h >= half else np.nextafter(h, np.float32(np.inf))
    return order, axis


class RetinaTables:
    """What the kernel reads besides the per-world rows, on the model's
    device: the rendered geoms and their radius and colour, ray directions
    and channel weights in lattice order (``dirs``, ``weights``: the plain
    version's), the ground height, and the shading branch. K3 reads the
    rays in tile order: ``ray_index`` (2, T * TILE) int32, the ommatidium of
    each slot (-1 for a pad), ``tile_dirs`` (2, T * TILE, 3) and
    ``tile_weights`` (2, T * TILE, 2, 3) in that order (zero in a pad), and
    ``tile_axis`` (2, T, 4), each tile's cone (:func:`ray_tiles`)."""

    def __init__(self, model: PhysicsModel, retina):
        device = model.device
        self.vis_geoms = [g for g, t in enumerate(model.geom_types) if t in ("capsule", "sphere")]
        self.G = len(self.vis_geoms)
        self.R = int(retina.n_ommatidia)
        self.eye_bodies = (int(retina.left_eye_body), int(retina.right_eye_body))
        sel = torch.tensor(self.vis_geoms, dtype=torch.int64, device=model.device)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
        self.radius = f32(model.geom_size[sel, 0])
        self.rgb = f32(model.geom_rgba[sel, :3])
        self.half = f32(model.geom_size[sel, 1])
        self.geom_body = model.geom_body[sel]
        self.geom_pos = f32(model.geom_pos[sel])
        self.geom_quat = f32(model.geom_quat[sel])
        dirs = np.stack([retina.directions_left, retina.directions_right])
        self.dirs = f32(dirs)
        self.weights = f32(retina.channel_weights)
        tiles = [ray_tiles(d) for d in dirs]
        order = np.stack([o for o, _ in tiles])
        pad = order < 0
        take = np.where(pad, 0, order)
        self.T = order.shape[1] // TILE
        self.ray_index = torch.as_tensor(order, dtype=torch.int32).to(device).contiguous()
        self.tile_dirs = f32(np.where(pad[..., None], 0.0, np.take_along_axis(dirs, take[..., None], 1)))
        self.tile_weights = f32(np.where(pad[..., None, None], 0.0, retina.channel_weights[take]))
        self.tile_axis = f32(np.stack([a for _, a in tiles]))
        self.ground_z = float(np.float32(model.ground_pos[2].item()))
        self.use_cone = float(retina.cone_half_rad) > 0.0
        self.tanh_cone = float(np.float32(np.tan(retina.cone_half_rad)))


def pack_rows(tables: RetinaTables, xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
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


def retina_plain(tables: RetinaTables, packed: torch.Tensor) -> torch.Tensor:
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


def contributing_pairs(tables: RetinaTables, packed: torch.Tensor) -> torch.Tensor:
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


def _raise_on_error(err: int) -> None:
    from flygym_tpu_torch.ops._build import load_library

    if err != 0:
        raise RuntimeError(f"retina launch failed: {load_library().cuda_error_string(err).decode()}")


def _check_rows(tables: RetinaTables, packed: torch.Tensor) -> None:
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise TypeError("the retina kernel takes contiguous float32 rows")
    if packed.shape[1] != _EYE_ROWS + 6 * tables.G:
        raise ValueError(f"rows of width {packed.shape[1]}, the model needs {_EYE_ROWS + 6 * tables.G}")
    if tables.dirs.device != packed.device:
        raise ValueError(f"the tables are on {tables.dirs.device}, the rows on {packed.device}")


def _launch(lib, entry: str, tables: RetinaTables, packed: torch.Tensor, *extra) -> torch.Tensor:
    refuse_grad("retina", packed)
    B = packed.shape[0]
    out = torch.empty((B, 2, tables.R, 2), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = getattr(lib, entry)(
            packed.data_ptr(), tables.ray_index.data_ptr(), tables.tile_dirs.data_ptr(),
            tables.tile_weights.data_ptr(), tables.tile_axis.data_ptr(),
            tables.radius.data_ptr(), tables.rgb.data_ptr(), out.data_ptr(), B, tables.R,
            tables.T, tables.G, tables.ground_z, tables.tanh_cone, int(tables.use_cone), *extra,
            torch.cuda.current_stream(packed.device).cuda_stream,
        )
    _raise_on_error(err)
    return out


def launch_retina(tables: RetinaTables, packed: torch.Tensor) -> torch.Tensor:
    """One K3 launch on CUDA rows (B, 14 + 6G) → (B, 2, R, 2), on the
    current stream; the library is built at the first launch."""
    from flygym_tpu_torch.ops._build import load_library

    _check_rows(tables, packed)
    if not packed.shape[0]:
        return packed.new_empty((0, 2, tables.R, 2))
    out = _launch(load_library(), "retina_f32", tables, packed)
    launches["retina"] += 1
    return out


def launch_build(tables: RetinaTables, packed: torch.Tensor, warps: int) -> torch.Tensor:
    """One launch of K3 built with ``warps`` warps per block
    (``_build.build_retina(warps=)``), as :func:`launch_retina` launches
    the shipped build: for timing the block shapes against each other. Not
    a launch of the path: ``launches`` does not count it."""
    from flygym_tpu_torch.ops._build import load_retina

    _check_rows(tables, packed)
    return _launch(load_retina(warps=warps), "retina_f32", tables, packed)


def keep_mask(tables: RetinaTables, packed: torch.Tensor) -> tuple:
    """K3's profile build (``-DRT_PROFILE``) on CUDA rows: its outputs and
    its cull's keep mask (B, 2, T, G) bool, True where a (world, eye, tile)
    sweeps the geom. Not a launch of the path: ``launches`` does not count
    it."""
    from flygym_tpu_torch.ops._build import load_retina

    _check_rows(tables, packed)
    keep = torch.zeros((packed.shape[0], 2, tables.T, tables.G), dtype=torch.uint8,
                       device=packed.device)
    out = _launch(load_retina(profile=True), "retina_profile_f32", tables, packed,
                  keep.data_ptr())
    return out, keep.bool()


def kernel_shape(tables: RetinaTables, warps: int | None = None) -> dict:
    """K3's launch on the current card, of the shipped build or of the
    build with ``warps`` warps per block: threads and dynamic shared bytes
    per block, blocks resident per SM."""
    import ctypes

    from flygym_tpu_torch.ops._build import load_library, load_retina

    lib = load_library() if warps is None else load_retina(warps=warps)
    shape = (ctypes.c_int * 3)()
    _raise_on_error(lib.retina_shape(int(tables.use_cone), tables.G, shape))
    return {"threads": shape[0], "shared_bytes": shape[1], "blocks_per_sm": shape[2]}


def make_retina_kernel(model: PhysicsModel, retina):
    """A batched retina render: (B,) State → (B, 2, n_omm, 2) point samples
    (before the acceptance blur).

    For CPU tensors it runs :func:`retina_plain`; for CUDA tensors it
    launches K3 once, or raises. The function carries its ``tables``.
    """
    if not retina_kernel_supported(model):
        raise NotImplementedError("the retina kernel does not render heightfield terrain")
    tables = RetinaTables(model, retina)

    def render_batched(state: State) -> torch.Tensor:
        with span("flygym.retina.pack_rows"):
            packed = pack_rows(tables, state.xpos, state.xquat)
        dev = packed.device
        with span("flygym.retina.launch"):
            if dev.type == "cpu":
                return retina_plain(tables, packed)
            if dev.type != "cuda":
                raise RuntimeError(f"the retina kernel runs on CUDA tensors, got {dev}")
            return launch_retina(tables, packed)

    render_batched.tables = tables
    return render_batched
