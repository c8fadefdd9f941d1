"""Ground contacts, adhesion and the primal Newton contact solver, batch-first.

Port of ``flygym_tpu/engine/contact.py`` (lines 116-175, 256-357, 441-753)
for ground rows on flat ground with condim 3:

1. Capsule-end vs ground-plane candidates from the static candidate table.
2. The ``ncon`` closest candidates go to the solver. They are chosen with a
   stable sort, which keeps the lower candidate index first among equal
   distances, as ``jax.lax.top_k`` does: at rest the left and right legs can
   give bit-equal distances, and ``torch.topk`` promises no order among ties.
3. Pyramidal friction rows per contact in the reference's row order
   (contact-major, ``_pyramid_rows``), MuJoCo impedance and reference
   accelerations, inverse weights precomputed at the neutral pose.
4. Adhesion as a generalised force along the inward normals, split over the
   body's active contacts.
5. Frozen-Hessian primal Newton: the Hessian is factored once per step by
   the tree-LDL factor op and every iteration solves with it
   (:mod:`flygym_tpu_torch.ops.ldl`: CUDA kernels on the card, the plain
   functions of :mod:`flygym_tpu_torch.engine.linalg` on the CPU), with the
   reference's bisection line search.

Pair rows, heightfields, PGS, ``solver_exact`` and condim other than 3 are
refused when a model is loaded.
"""

import torch

from flygym_tpu_torch.engine.actuation import clamp_ctrl
from flygym_tpu_torch.engine.maths import cross, norm, quat_rotate
from flygym_tpu_torch.engine.model import ActKind, PhysicsModel
from flygym_tpu_torch.ops import ldl

__all__ = ["contact_candidates", "select_contacts", "solve_contacts", "ContactInfo"]

_NROWS = 4  # pyramid rows per condim-3 contact


class ContactInfo:
    """Per-step selected-contact data passed to sensors and readouts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def contact_candidates(model: PhysicsModel, gpos, gquat):
    """Signed distances (B, ncand), positions and normals (B, ncand, 3) of
    every capsule-end vs ground candidate."""
    z_all = quat_rotate(gquat, gpos.new_tensor([0.0, 0.0, 1.0]))
    g = model.can_geom
    z_axis = z_all[:, g]
    radius = model.geom_size[g, 0]
    halflen = model.geom_size[g, 1]
    endpoint = gpos[:, g] + model.can_end[:, None] * halflen[:, None] * z_axis
    h = model.ground_pos[2]
    n = torch.zeros_like(endpoint)
    n[..., 2] = 1.0
    dist = (endpoint[..., 2] - h) * n[..., 2] - radius
    cpos = endpoint - (radius + 0.5 * dist)[..., None] * n
    return dist, cpos, n


def select_contacts(model: PhysicsModel, dist_all: torch.Tensor) -> torch.Tensor:
    """Indices (B, ncon) of the ``ncon`` closest candidates, closest first."""
    order = torch.sort(dist_all, dim=-1, stable=True).indices
    return order[:, : model.ncon]


def _impedance(solimp: torch.Tensor, pos_err: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp impedance d(r) as a function of constraint violation."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos_err) / torch.clamp(width, min=1e-12), 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(
        x < mid,
        a * torch.pow(x, power),
        1.0 - b * torch.pow(1.0 - x, power),
    )
    return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 0.9999)


def _contact_frames(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3) normals → (..., 3, 3) frames with rows [normal, t1, t2]."""
    ex = normal.new_tensor([1.0, 0.0, 0.0])
    ey = normal.new_tensor([0.0, 1.0, 0.0])
    # Seed with the axis least aligned with the normal.
    use_ey = torch.abs(normal[..., 0]) > 0.9
    seed = torch.where(use_ey[..., None], ey, ex)
    t1 = seed - torch.sum(seed * normal, dim=-1, keepdim=True) * normal
    t1 = t1 / torch.clamp(norm(t1, keepdim=True), min=1e-12)
    t2 = cross(normal, t1)
    return torch.stack([normal, t1, t2], dim=-2)


def _contact_jacobian(model: PhysicsModel, body, cpos, S, ref, frame, body2):
    """(B, K, 3, nv) contact-frame translational Jacobian at cpos on bodies.

    ``body2`` subtracts the second body's point Jacobian; on ground rows it
    is the world, whose subtree holds no DoF, so the subtraction adds zeros.
    """
    rel = cpos - ref[:, None]
    jpoint = S[:, None, :, 3:] + cross(S[:, None, :, :3], rel[:, :, None, :])
    affects = _affects(model, body, body2)  # (B, K, nv)
    return torch.einsum("bkud,bkvd->bkuv", frame, jpoint * affects[..., None])


def _affects(model: PhysicsModel, body, body2):
    """(B, K, nv) signed DoF participation: +1 if the DoF moves ``body``, -1
    if it moves ``body2``."""
    moves = model.body_subtree_mask[model.dof_body]  # (nv, nbody)
    return (moves[:, body] - moves[:, body2]).permute(1, 2, 0)


def _pyramid_rows(J, fric):
    """(B, K, 3, nv) rows [n, t1, t2] → (B, K, 4, nv) pyramid edges
    Jn ± mu J_t, per tangent (MuJoCo's pyramidal cone for condim 3)."""
    Jn = J[:, :, 0]
    mu = fric[..., 0, None]
    rows = []
    for Jd in (J[:, :, 1], J[:, :, 2]):
        rows.append(Jn + mu * Jd)
        rows.append(Jn - mu * Jd)
    return torch.stack(rows, dim=2)


def solve_contacts(model: PhysicsModel, Mh, qfrc_smooth, qvel, qacc_warm, xpos,
                   S, gpos, gquat, ctrl, ref):
    """Detect contacts, apply adhesion, solve the constraints.

    Args:
        Mh: (B, nv, nv) damping-augmented mass matrix.
        qfrc_smooth: (B, nv) smooth generalised forces without adhesion.
        qacc_warm: (B, nv) previous step's acceleration (active-set warm start).

    Returns:
        qacc: (B, nv) constrained acceleration.
        info: :class:`ContactInfo` for the sensors, or None without contacts.
    """
    if model.ncand == 0:
        L, d = ldl.tree_ldl_factor(model.ldl, Mh)
        return ldl.tree_ldl_solve(model.ldl, L, d, qfrc_smooth), None

    B, K, nv = Mh.shape[0], model.ncon, model.nv
    dist_all, cpos_all, normal_all = contact_candidates(model, gpos, gquat)
    sel = select_contacts(model, dist_all)
    dist = torch.gather(dist_all, 1, sel)
    sel3 = sel[..., None].expand(B, K, 3)
    cpos = torch.gather(cpos_all, 1, sel3)
    normal = torch.gather(normal_all, 1, sel3)
    margin = model.can_margin[sel]
    active = dist < margin

    frame = _contact_frames(normal)  # (B, K, 3, 3)
    body = model.can_body[sel]
    body2 = model.can_body2[sel]
    J = _contact_jacobian(model, body, cpos, S, ref, frame, body2)
    fric = model.can_friction[sel]
    mu = fric[..., 0]

    # Constraint dynamics parameters.
    solref = model.can_solref[sel]
    solimp = model.can_solimp[sel]
    pos_err = torch.clamp(dist - margin, max=0.0)
    imp = _impedance(solimp, pos_err)
    dmax = solimp[..., 1]
    tc, dr = solref[..., 0], solref[..., 1]
    b_gain = 2.0 / (dmax * tc)
    k_gain = 1.0 / (dmax * dmax * tc * tc * dr * dr)

    # ---- adhesion as an applied generalised force (MuJoCo semantics) ----
    adh_act = model.can_adh_act[sel]
    has_adh = adh_act >= 0
    adh_idx = torch.clamp(adh_act, min=0)
    on = has_adh & active
    adh_force = torch.zeros_like(dist)
    if model.nu:
        adh_total = torch.where(
            model.act_kind == ActKind.ADHESION,
            model.act_gain * clamp_ctrl(model, ctrl),
            torch.zeros_like(ctrl),
        )
        counts = ctrl.new_zeros((B, model.nu)).scatter_add(1, adh_idx, on.to(ctrl.dtype))
        adh_force = torch.where(
            on,
            torch.gather(adh_total, 1, adh_idx)
            / torch.clamp(torch.gather(counts, 1, adh_idx), min=1.0),
            torch.zeros_like(dist),
        )
    qfrc_adh = torch.einsum("bk,bkv->bv", -adh_force, J[:, :, 0, :])
    qfrc_total = qfrc_smooth + qfrc_adh

    # ---- pyramid rows and row data ----
    Jp = _pyramid_rows(J, fric).reshape(B, K * _NROWS, nv)
    vel_rows = (Jp @ qvel[..., None])[..., 0]
    rep = lambda x: torch.repeat_interleave(x, _NROWS, dim=1)
    pos_rows = rep(pos_err)
    imp_rows = rep(imp)
    aref = -rep(b_gain) * vel_rows - rep(k_gain) * imp_rows * pos_rows
    row_active = rep(active)
    invweight = model.can_invweight[sel].reshape(B, K * _NROWS)
    R = (1.0 - imp_rows) / imp_rows * invweight
    D = torch.where(row_active, 1.0 / torch.clamp(R, min=1e-12), torch.zeros_like(R))

    qacc, lam = _solve_primal_newton(model, Mh, Jp, D, aref, qfrc_total, qacc_warm)

    # Contact-frame constraint forces from the pyramid multipliers.
    lam_k = lam.reshape(B, K, _NROWS)
    fn = torch.sum(lam_k, dim=-1)
    ft1 = mu * (lam_k[..., 0] - lam_k[..., 1])
    ft2 = mu * (lam_k[..., 2] - lam_k[..., 3])
    f_con = torch.stack([fn, ft1, ft2], dim=-1) * active[..., None]
    f_world = torch.einsum("bkc,bkcd->bkd", f_con, frame)

    info = ContactInfo(
        sel=sel,
        dist=dist,
        pos=cpos,
        active=active,
        force_frame=f_con,
        force_world=f_world,
        frame=frame,
        sensor=model.can_sensor[sel],
        adh_act=adh_act,
        adh_force=adh_force,
        body=body,
    )
    return qacc, info


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-world dot product of (B, n) vectors."""
    return torch.sum(a * b, dim=-1)


def _solve_primal_newton(model: PhysicsModel, Mh, Jp, D, aref, qfrc, qacc_warm):
    """Warm-started primal Newton with one Hessian factorization per step.

    Cost: c(a) = ½ aᵀ Mh a − aᵀ qfrc + Σ_r ½ D_r jar_r² [jar_r < 0],
    jar = Jp a − aref. The active set at the warm start fixes the Hessian
    Mh + JpᵀWJp + 1e-9·I, factored once (one tree-LDL factor launch); each
    of the ``solver_iterations`` refinements solves with that factor (one
    solve launch each) and takes a near-exact line search step.
    """
    nv = model.nv
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    JpT = Jp.transpose(-1, -2)

    def jar_active(a):
        jar = mv(Jp, a) - aref
        act = (jar < 0.0).to(Jp.dtype) * (D > 0.0)
        return jar, act

    _, act_w = jar_active(qacc_warm)
    H = Mh + (JpT * (D * act_w)[:, None, :]) @ Jp
    H = H + 1e-9 * torch.eye(nv, dtype=Mh.dtype, device=Mh.device)
    L_fac, d_fac = ldl.tree_ldl_factor(model.ldl, H)

    a = qacc_warm
    for _ in range(max(model.solver_iterations, 1)):
        jar, act = jar_active(a)
        grad = mv(Mh, a) - qfrc + mv(JpT, D * act * jar)
        delta = -ldl.tree_ldl_solve(model.ldl, L_fac, d_fac, grad)

        Jd = mv(Jp, delta)
        Md = mv(Mh, delta)
        dMd = _bdot(delta, Md)
        gMd = _bdot(a, Md) - _bdot(qfrc, delta)
        alpha = _exact_linesearch(gMd, dMd, jar, Jd, D)
        a = a + alpha[:, None] * delta
    jar, act = jar_active(a)
    lam = torch.clamp(-D * act * jar, min=0.0)
    return a, lam


_LS_BISECT_ITERS = 8
_LS_ALPHA_MAX = 2.0


def _exact_linesearch(gMd, dMd, jar, Jd, D):
    """Minimiser α (B,) of φ(α) = c(a + α δ) along the Newton direction.

    φ'(α) = (gMd + α dMd) + Σ_r [jar_r + α Jd_r < 0] D_r (jar_r + α Jd_r) Jd_r
    is continuous, increasing and piecewise linear. Bisect the bracket
    [0, 2] eight times, then interpolate linearly in the last bracket
    (regula falsi). This is the reference's algorithm exactly: bisection
    feeds back only the sign of φ', so two implementations that differ by
    an ulp in φ' agree except within noise of the root
    (``flygym_tpu/engine/contact.py:714-724``).
    """
    pos_D = D > 0.0
    p = D * Jd
    zero = torch.zeros_like(gMd)
    dlo = gMd + torch.sum(torch.where((jar < 0.0) & pos_D, p * jar, 0.0), dim=-1)
    ja_m = jar + _LS_ALPHA_MAX * Jd
    dhi = (
        gMd
        + _LS_ALPHA_MAX * dMd
        + torch.sum(torch.where((ja_m < 0.0) & pos_D, p * ja_m, 0.0), dim=-1)
    )
    lo = zero
    hi = torch.full_like(gMd, _LS_ALPHA_MAX)
    for _ in range(_LS_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ja = jar + mid[:, None] * Jd
        d = gMd + mid * dMd + torch.sum(torch.where((ja < 0.0) & pos_D, p * ja, 0.0), dim=-1)
        neg = d < 0.0
        lo = torch.where(neg, mid, lo)
        dlo = torch.where(neg, d, dlo)
        hi = torch.where(neg, hi, mid)
        dhi = torch.where(neg, dhi, d)
    # Regula falsi on the final bracket; t clips to 1 when the root lies
    # beyond α_max.
    t = -dlo / torch.clamp(dhi - dlo, min=1e-12)
    alpha = lo + torch.clamp(t, 0.0, 1.0) * (hi - lo)
    return torch.where(dlo < 0.0, alpha, zero)
