"""Ground contacts, adhesion and the primal Newton contact solver, batch-first.

Port of ``flygym_tpu/engine/contact.py`` (lines 46-253, 256-357, 441-782):

1. Candidates from the static candidate table: capsule ends against a flat
   plane or a heightfield (:func:`ground_height_normal`), and capsule
   against capsule for fly-fly pair rows (:func:`segseg_closest`), whose
   Jacobian rows take +1 on the DoFs that move the first body and -1 on
   those that move the second.
2. The ``ncon`` closest candidates go to the solver. They are chosen with a
   stable sort, which keeps the lower candidate index first among equal
   distances, as ``jax.lax.top_k`` does: at rest the left and right legs can
   give bit-equal distances, and ``torch.topk`` promises no order among ties.
   With compressed pair rows (``pair_compress``) each group of pair rows
   that share a geom1 and face one opposing fly offers only its nearest
   member (the winner, picked in the step or pinned by the caller) to that
   choice; :func:`make_pair_winner_sampler` picks the same winners outside
   a step, from the cached pose, for the mega-step kernel.
3. Pyramidal friction rows per contact in the reference's row order
   (contact-major, ``_pyramid_rows``): the normal row alone at condim 1,
   then two rows per friction direction, sliding along t1 and t2 (condim
   3), torsion about the normal (condim 4) and rolling about t1 and t2
   (condim 6), the last three on the rotational Jacobian
   (``_contact_jacobian_ang``). The model's condim is the largest of its
   pairs (``compose/spec.py:786-799``), for every candidate. MuJoCo
   impedance and reference accelerations, inverse weights precomputed at
   the neutral pose.
4. Adhesion as a generalised force along the inward normals, split over the
   body's active contacts.
5. Primal Newton with the reference's bisection line search, or with
   ``solver_type == "pgs"`` projected Gauss-Seidel on the dual
   (:func:`_solve_dual_pgs`, the reference's verification fallback). By default
   the Hessian is factored once per step, at the warm start's active set,
   by the tree-LDL factor op, and every iteration solves with that factor
   (:mod:`flygym_tpu_torch.ops.ldl`: CUDA kernels on the card, the plain
   functions of :mod:`flygym_tpu_torch.engine.linalg` on the CPU). With
   ``solver_exact`` (MuJoCo's exact Newton, for parity studies) every
   iteration after the first re-factors it from the current active set.
   In differentiable mode (``model.differentiable``) the factor is made
   without autograd and every solve is the tree-LDL solve under autograd
   (:func:`~flygym_tpu_torch.ops.ldl.tree_ldl_solve_grad`), whose backward
   launches the solve kernel again on the same factor; PGS differentiates
   as it is.

``samples["winners"]`` counts calls of a winner sampler.
:func:`compute_candidate_invweight` and :func:`compute_actuator_acc0` run
once per model, when the port compiles a world.
"""

import functools

import torch

from flygym_tpu_torch.engine.actuation import clamp_ctrl
from flygym_tpu_torch.engine.maths import (
    cross, fma32, norm, powf, quat_mul, quat_rotate, sqrt_rn)
from flygym_tpu_torch.engine.model import ActKind, PhysicsModel
from flygym_tpu_torch.ops import ldl

__all__ = [
    "compute_actuator_acc0",
    "compute_candidate_invweight",
    "contact_candidates",
    "ground_height_normal",
    "make_pair_winner_sampler",
    "n_pyramid_rows",
    "pair_winners",
    "reset_samples",
    "samples",
    "segseg_closest",
    "select_contacts",
    "solve_contacts",
    "ContactInfo",
]

samples = {"winners": 0}


def reset_samples() -> None:
    samples["winners"] = 0


class ContactInfo:
    """Per-step selected-contact data passed to sensors and readouts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def ground_height_normal(model: PhysicsModel, xy: torch.Tensor):
    """Ground height (...) and unit normal (..., 3) under (..., 2) positions.

    Flat worlds give ``ground_pos`` z and (0, 0, 1). Heightfield worlds
    interpolate the grid bilinearly and take the normal from the cell
    gradient, in the JAX package's order of operations; the normal's length
    is ``sqrt`` of the sum of squares, rounded once, as ``jnp.linalg.norm``
    rounds it on the CPU.
    """
    if not model.has_hfield:
        h = model.ground_pos[2].expand(xy.shape[:-1])
        n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype, device=xy.device)
        n[..., 2] = 1.0
        return h, n
    data = model.hfield_data
    nr, nc = data.shape
    fx = (xy[..., 0] - model.hfield_xy0[0]) / model.hfield_cell[0]
    fy = (xy[..., 1] - model.hfield_xy0[1]) / model.hfield_cell[1]
    fx = torch.clamp(fx, 0.0, float(torch.tensor(nc - 1.001, dtype=torch.float32)))
    fy = torch.clamp(fy, 0.0, float(torch.tensor(nr - 1.001, dtype=torch.float32)))
    ix, iy = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - ix, fy - iy
    ix, iy = ix.long(), iy.long()
    h00, h01 = data[iy, ix], data[iy, ix + 1]
    h10, h11 = data[iy + 1, ix], data[iy + 1, ix + 1]
    h = h00 * (1 - tx) * (1 - ty) + h01 * tx * (1 - ty) + h10 * (1 - tx) * ty + h11 * tx * ty
    dh_dx = ((h01 - h00) * (1 - ty) + (h11 - h10) * ty) / model.hfield_cell[0]
    dh_dy = ((h10 - h00) * (1 - tx) + (h11 - h01) * tx) / model.hfield_cell[1]
    n = torch.stack([-dh_dx, -dh_dy, torch.ones_like(h)], dim=-1)
    length = sqrt_rn(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2])
    return h, n / length[..., None]


def candidate_endpoints(model: PhysicsModel, gpos, gquat):
    """(B, ncand, 3) world positions of the candidates' capsule ends."""
    # The z axis made on the device: a copy from the host, even of one
    # scalar, would wait for the card's queue to drain.
    ez = torch.cat([gpos.new_zeros(2), gpos.new_ones(1)])
    z_all = quat_rotate(gquat, ez)
    g = model.can_geom
    halflen = model.geom_size[g, 1]
    return gpos[:, g] + model.can_end[:, None] * halflen[:, None] * z_all[:, g]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis of (..., 3) vectors, summed in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def segseg_closest(p1, q1, p2, q2):
    """Closest points (c1, c2) between the segments [p1, q1] and [p2, q2]
    of (..., 3) endpoints: Ericson's clamped solution written without
    branches, safe for zero-length segments (spheres) and parallel ones
    (the JAX ``_segseg_closest``, ``contact.py:88-113``)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a, e = _dot(d1, d1), _dot(d2, d2)
    f, c, b = _dot(d2, r), _dot(d1, r), _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(
        denom > 1e-12,
        torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
        0.0,
    )
    t = torch.where(e > 1e-12, (b * s + f) / torch.clamp(e, min=1e-12), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(
        a > 1e-12, torch.clamp((b * t - c) / torch.clamp(a, min=1e-12), 0.0, 1.0), 0.0
    )
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2


def contact_candidates(model: PhysicsModel, gpos, gquat):
    """Signed distances (B, ncand), positions and normals (B, ncand, 3) of
    every candidate.

    The first ``ncand - ncand_pair`` rows are capsule ends against the
    ground, along the local ground normal. The last ``ncand_pair`` rows are
    capsule against capsule (fly-fly contacts): the closest points of the
    two axes, with the normal from geom2 toward geom1, or +z where the axes
    meet (the JAX ``contact_candidates``, ``contact.py:116-174``).
    """
    ng = model.ncand - model.ncand_pair
    endpoint = candidate_endpoints(model, gpos, gquat)[:, :ng]
    radius = model.geom_size[model.can_geom[:ng], 0]
    h, n = ground_height_normal(model, endpoint[..., :2])
    dist = (endpoint[..., 2] - h) * n[..., 2] - radius
    cpos = endpoint - (radius + 0.5 * dist)[..., None] * n
    if model.ncand_pair == 0:
        return dist, cpos, n

    ez = torch.cat([gpos.new_zeros(2), gpos.new_ones(1)])
    z_all = quat_rotate(gquat, ez)
    g1, g2 = model.can_geom[ng:], model.can_geom2[ng:]
    r1, r2 = model.geom_size[g1, 0], model.geom_size[g2, 0]
    h1, h2 = model.geom_size[g1, 1, None], model.geom_size[g2, 1, None]
    c1, c2 = segseg_closest(gpos[:, g1] - h1 * z_all[:, g1], gpos[:, g1] + h1 * z_all[:, g1],
                            gpos[:, g2] - h2 * z_all[:, g2], gpos[:, g2] + h2 * z_all[:, g2])
    d = c1 - c2
    dn = sqrt_rn(_dot(d, d))
    n_p = torch.where((dn > 1e-9)[..., None], d / torch.clamp(dn, min=1e-9)[..., None], ez)
    dist_p = dn - r1 - r2
    cpos_p = c1 - (r1 + 0.5 * dist_p)[..., None] * n_p
    return (torch.cat([dist, dist_p], dim=1), torch.cat([cpos, cpos_p], dim=1),
            torch.cat([n, n_p], dim=1))


@functools.lru_cache(maxsize=None)
def _group_table(pair_groups: tuple, device: torch.device):
    """Per compressed group its first pair row (n_groups,), and (n_groups,
    gmax) pair-row indices of its members with a +inf pad where a group is
    shorter than the longest, so that an argmin never picks a pad (the JAX
    sampler's gather table, ``contact.py:221-230``); made once per device."""
    gmax = max(size for _start, size in pair_groups)
    idx = torch.zeros((len(pair_groups), gmax), dtype=torch.int64)
    pad = torch.full((len(pair_groups), gmax), float("inf"))
    for i, (start, size) in enumerate(pair_groups):
        idx[i, :size] = start + torch.arange(size)
        pad[i, :size] = 0.0
    start = torch.tensor([start for start, _size in pair_groups], dtype=torch.int64)
    return start.to(device), idx.to(device), pad.to(device)


def _sum_sq_fma(d: torch.Tensor) -> torch.Tensor:
    """x0² + x1² + x2² over the last axis of (..., 3) float32 vectors, as
    XLA's CPU backend computes ``jnp.linalg.norm``'s sum: contracted into
    fused multiply-adds, fma(x2, x2, fma(x1, x1, x0 * x0))."""
    x0, x1, x2 = d.unbind(-1)
    return fma32(x2, x2, fma32(x1, x1, x0 * x0))


def pair_winners(model: PhysicsModel, pair_dist: torch.Tensor) -> torch.Tensor:
    """(B, n_groups) group-local index of each compressed group's nearest
    member, from the (B, ncand_pair) distances of the pair rows: the first
    of equal minima, as ``jnp.argmin`` and ``torch.argmin`` both take."""
    _start, idx, pad = _group_table(tuple(model.pair_groups), pair_dist.device)
    return torch.argmin(pair_dist[:, idx] + pad, dim=-1)


def make_pair_winner_sampler(model: PhysicsModel):
    """``sample(xpos, xquat) -> (B, n_groups)`` float32 group-local winner
    indices of the compressed pair groups, or None for a model without
    compressed pair rows (the JAX ``make_pair_winner_sampler``,
    ``contact.py:177-253``).

    The mega-step kernel solves one capsule-capsule row per group, whose
    geom2 is the group's nearest member at the batched body poses (B,
    nbody, 3/4) it is given: the state's cached pose, sampled once per
    launch of K steps. ``sample.distances(xpos, xquat)`` gives the (B,
    ncand_pair) distances the argmin runs over, rounded as the JAX
    sampler's: each geom's frame is ``xpos + quat_rotate(xquat, gpos)`` and
    ``quat_rotate(quat_mul(xquat, gquat), ez)``, the closest points of the
    two axes, then the norm of their difference (its sum as
    :func:`_sum_sq_fma`, its sqrt rounded once) minus both radii.
    """
    if not (model.pair_compress and model.ncand_pair):
        return None
    ng = model.ncand - model.ncand_pair
    g1, g2 = model.can_geom[ng:], model.can_geom2[ng:]
    r1, r2 = model.geom_size[g1, 0], model.geom_size[g2, 0]
    # Each capsule's axis ends once per geom, then gathered per pair row:
    # the same operations on the same values as per pair row, so the same bits.
    geoms, inv = torch.unique(torch.cat([g1, g2]), return_inverse=True)
    i1, i2 = inv[: len(g1)], inv[len(g1):]
    body, half = model.geom_body[geoms], model.geom_size[geoms, 1, None]
    gpos_l, gquat_l = model.geom_pos[geoms], model.geom_quat[geoms]

    def distances(xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        # The z axis made on the device: a copy from the host would wait
        # for the card's queue to drain.
        up = torch.cat([xpos.new_zeros(2), xpos.new_ones(1)])
        q = xquat[:, body]
        p = xpos[:, body] + quat_rotate(q, gpos_l)
        z = quat_rotate(quat_mul(q, gquat_l), up)
        lo, hi = p - half * z, p + half * z
        s1, s2 = segseg_closest(lo[:, i1], hi[:, i1], lo[:, i2], hi[:, i2])
        return sqrt_rn(_sum_sq_fma(s1 - s2)) - r1 - r2

    def sample(xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        samples["winners"] += 1
        return pair_winners(model, distances(xpos, xquat)).to(xpos.dtype)

    sample.distances = distances
    return sample


def select_contacts(model: PhysicsModel, dist_all: torch.Tensor) -> torch.Tensor:
    """Indices (B, ncon) of the ``ncon`` closest candidates, closest first."""
    order = torch.sort(dist_all, dim=-1, stable=True).indices
    return order[:, : model.ncon]


def _impedance(solimp: torch.Tensor, pos_err: torch.Tensor) -> torch.Tensor:
    """MuJoCo solimp impedance d(r) as a function of constraint violation;
    its pow is glibc's powf, as the JAX engine's on the CPU."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos_err) / torch.clamp(width, min=1e-12), 0.0, 1.0)
    a = 1.0 / powf(mid, power - 1.0)
    b = 1.0 / powf(1.0 - mid, power - 1.0)
    y = torch.where(
        x < mid,
        a * powf(x, power),
        1.0 - b * powf(1.0 - x, power),
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


def n_pyramid_rows(condim: int) -> int:
    """Pyramid rows per contact: 2 per friction direction (1 at condim 1)."""
    return max(1, 2 * (condim - 1))


def _contact_jacobian_ang(model: PhysicsModel, body, S, frame, body2):
    """(B, K, 3, nv) contact-frame rotational Jacobian: the DoFs' angular
    motion about the normal (torsion) and the tangents (rolling)."""
    affects = _affects(model, body, body2)  # (B, K, nv)
    return torch.einsum("bkud,bvd->bkuv", frame, S[..., :3]) * affects[:, :, None, :]


def _pyramid_rows(J, J_ang, fric, condim: int):
    """(B, K, 3, nv) rows [n, t1, t2] → (B, K, nrows, nv) pyramid edges
    Jn ± mu_i J_i per friction direction (MuJoCo's pyramidal cone): t1 and
    t2 with the sliding mu; at condim 4 the torsion about n with the
    torsional mu; at condim 6 the rolling about t1 and t2 with the rolling
    mu. Condim 1 is the normal row alone.

    Args:
        J_ang: (B, K, 3, nv) rotational rows [about n, t1, t2], or None
            below condim 4.
        fric: (B, K, 3) sliding, torsional and rolling coefficients.
    """
    Jn = J[:, :, 0]
    if condim == 1:
        return Jn[:, :, None, :]
    dirs = [(J[:, :, 1], fric[..., 0]), (J[:, :, 2], fric[..., 0])]
    if condim >= 4:
        dirs.append((J_ang[:, :, 0], fric[..., 1]))
    if condim == 6:
        dirs.append((J_ang[:, :, 1], fric[..., 2]))
        dirs.append((J_ang[:, :, 2], fric[..., 2]))
    rows = []
    for Jd, mu in dirs:
        rows.append(Jn + mu[..., None] * Jd)
        rows.append(Jn - mu[..., None] * Jd)
    return torch.stack(rows, dim=2)


def _neutral_dynamics(model: PhysicsModel):
    """Poses, motion subspace and mass matrix of one world at ``qpos0``."""
    from flygym_tpu_torch.engine import dynamics
    from flygym_tpu_torch.engine.kinematics import dof_subspace, kinematics_full

    qpos = model.qpos0[None]
    xpos, xquat, hinge_xaxis = kinematics_full(model, qpos)
    ref = xpos[:, model.ref_body]
    S = dof_subspace(model, xpos, hinge_xaxis, ref)
    I_body = dynamics.body_spatial_inertias(model, xpos, xquat, ref)
    return xpos, xquat, ref, S, dynamics.crba(model, I_body, S)


def compute_candidate_invweight(model: PhysicsModel) -> torch.Tensor:
    """Per-candidate pyramid-row inverse weights at the neutral pose,
    (ncand, rows per contact).

    Port of ``flygym_tpu/engine/contact.py:357``: every pyramid row of a
    contact shares one inverse weight ``2 (1 + mu0²) · body_invweight0``,
    where the body's translational invweight is the mean diagonal of
    J M0⁻¹ Jᵀ for a point at its CoM at qpos0 (MuJoCo's diagApprox; the
    world side of a ground row contributes zero). It runs once, when the
    port compiles a world, on the CPU in float32, as MuJoCo's compiler runs
    on the host; the Cholesky factor and solve are torch's, where the JAX
    package takes ``jax.scipy.linalg.cho_factor``. The two differ in the
    last bits (1.7e-5 relative at most over the committed worlds): the
    neutral-pose mass matrix here is not the jitted JAX program's to the
    bit, so its LAPACK route would not be either. Its first stages that part
    are the forward kinematics and ``quat_to_mat``; every stage after those
    is held to JAX's with ``fused=True`` (``tests/test_torch_neutral_dynamics.py``,
    ``ROADMAP.md`` queue 3 item 7).
    """
    xpos, xquat, ref, S, M = _neutral_dynamics(model)
    chol = torch.linalg.cholesky(M[0])
    K, nv = model.ncand, model.nv
    eye3 = torch.eye(3, dtype=M.dtype).expand(1, K, 3, 3)
    world = torch.zeros_like(model.can_body)[None]

    def body_weight(body):
        com = xpos[:, body] + quat_rotate(xquat[:, body], model.body_ipos[body])
        Jt = _contact_jacobian(model, body[None], com, S, ref, eye3, world).reshape(-1, nv)
        X = torch.cholesky_solve(Jt.T, chol)
        return torch.sum(Jt * X.T, dim=1).reshape(K, 3).mean(dim=1)

    w = body_weight(model.can_body) + body_weight(model.can_body2)
    mu0 = model.can_friction[:, 0]
    w_row = 2.0 * (1.0 + mu0 * mu0) * w
    nrows = n_pyramid_rows(model.condim)
    return torch.clamp(w_row, min=1e-12)[:, None] * torch.ones((1, nrows), dtype=M.dtype)


def compute_actuator_acc0(model: PhysicsModel) -> torch.Tensor:
    """|qacc| per unit actuator force at the neutral pose, per actuator (nu,).

    Port of ``flygym_tpu/engine/contact.py:405``: MuJoCo's compile-time
    ``acc0``, with which the muscle model scales its peak force
    (``force = scale / acc0`` when gainprm's force is negative). Like
    :func:`compute_candidate_invweight` it runs once, at compile time, on
    the CPU in float32, with torch's Cholesky factor and solve, and differs
    from JAX's in the last bits for the same reason (3.3e-7 relative at
    most).
    """
    _xpos, _xquat, _ref, _S, M = _neutral_dynamics(model)
    Mh = M[0] + model.timestep * torch.diag(model.dof_damping)
    chol = torch.linalg.cholesky(Mh)
    moments = torch.zeros((model.nu, model.nv), dtype=M.dtype)
    if model.nhinge:
        hs = torch.clamp(model.act_hinge, min=0)
        rows = torch.arange(model.nu)
        moments[rows, model.hinge_vadr[hs]] = (model.act_hinge >= 0).to(M.dtype)
    qacc = torch.cholesky_solve(moments.T, chol)  # (nv, nu)
    return torch.linalg.norm(qacc.T, dim=1)


def solve_contacts(model: PhysicsModel, Mh, qfrc_smooth, qvel, qacc_warm, xpos,
                   S, gpos, gquat, ctrl, ref, widx=None):
    """Detect contacts, apply adhesion, solve the constraints.

    Args:
        Mh: (B, nv, nv) damping-augmented mass matrix.
        qfrc_smooth: (B, nv) smooth generalised forces without adhesion.
        qacc_warm: (B, nv) previous step's acceleration (active-set warm start).
        widx: Optional (B, n_groups) pinned group-local winners of the
            compressed pair groups; None picks each group's nearest member
            from this step's distances.

    Returns:
        qacc: (B, nv) constrained acceleration.
        info: :class:`ContactInfo` for the sensors, or None without contacts.
    """
    if model.ncand == 0:
        L, d = _factor(model, Mh)
        return _solve(model, Mh, L, d, qfrc_smooth), None

    B, K, nv = Mh.shape[0], model.ncon, model.nv
    dist_all, cpos_all, normal_all = contact_candidates(model, gpos, gquat)
    if model.pair_compress and model.ncand_pair:
        # Each group offers its winner only; top-K runs over the ground rows
        # and the winners, in that order (``contact.py:494-517``).
        ng = model.ncand - model.ncand_pair
        if widx is None:
            widx = pair_winners(model, dist_all[:, ng:])
        start = _group_table(tuple(model.pair_groups), dist_all.device)[0]
        eff = torch.cat([torch.arange(ng, device=dist_all.device).expand(B, ng),
                         ng + start + widx.long()], dim=1)
        sel = torch.gather(eff, 1, select_contacts(model, torch.gather(dist_all, 1, eff)))
    else:
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
    J_ang = _contact_jacobian_ang(model, body, S, frame, body2) if model.condim > 3 else None
    fric = model.can_friction[sel]
    mu = fric[..., 0]
    nrows = n_pyramid_rows(model.condim)

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
    Jp = _pyramid_rows(J, J_ang, fric, model.condim).reshape(B, K * nrows, nv)
    vel_rows = (Jp @ qvel[..., None])[..., 0]
    rep = lambda x: torch.repeat_interleave(x, nrows, dim=1)
    pos_rows = rep(pos_err)
    imp_rows = rep(imp)
    aref = -rep(b_gain) * vel_rows - rep(k_gain) * imp_rows * pos_rows
    row_active = rep(active)
    invweight = model.can_invweight[sel].reshape(B, K * nrows)
    R = (1.0 - imp_rows) / imp_rows * invweight
    D = torch.where(row_active, 1.0 / torch.clamp(R, min=1e-12), torch.zeros_like(R))

    if model.solver_type == "pgs":
        qacc, lam = _solve_dual_pgs(model, Mh, Jp, D, aref, qfrc_total, row_active)
    else:
        qacc, lam = _solve_primal_newton(model, Mh, Jp, D, aref, qfrc_total, qacc_warm)

    # Contact-frame constraint forces from the pyramid multipliers; no
    # tangential force at condim 1.
    lam_k = lam.reshape(B, K, nrows)
    fn = torch.sum(lam_k, dim=-1)
    if model.condim >= 3:
        ft1 = mu * (lam_k[..., 0] - lam_k[..., 1])
        ft2 = mu * (lam_k[..., 2] - lam_k[..., 3])
    else:
        ft1 = ft2 = torch.zeros_like(fn)
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


def _factor(model: PhysicsModel, H):
    """The tree-LDL factor of H (the K1 op). In differentiable mode it is
    made without autograd: :func:`_solve` differentiates the solve in H."""
    return ldl.tree_ldl_factor(model.ldl, H.detach() if model.differentiable else H)


def _solve(model: PhysicsModel, H, L, d, b):
    """H⁻¹ b through H's factor (L, d) (the K1b op). In differentiable mode
    through :func:`~flygym_tpu_torch.ops.ldl.tree_ldl_solve_grad`, whose
    backward is K1b again on the same factor: the switch the JAX package
    makes to its plain tree LDL (``flygym_tpu/engine/contact.py:468-479``)."""
    if model.differentiable:
        return ldl.tree_ldl_solve_grad(model.ldl, H, L, d, b)
    return ldl.tree_ldl_solve(model.ldl, L, d, b)


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-world dot product of (B, n) vectors."""
    return torch.sum(a * b, dim=-1)


def _solve_primal_newton(model: PhysicsModel, Mh, Jp, D, aref, qfrc, qacc_warm):
    """Warm-started primal Newton (``flygym_tpu/engine/contact.py:640-703``).

    Cost: c(a) = ½ aᵀ Mh a − aᵀ qfrc + Σ_r ½ D_r jar_r² [jar_r < 0],
    jar = Jp a − aref. The active set at the warm start fixes the Hessian
    Mh + JpᵀWJp + 1e-9·I, factored once (one tree-LDL factor launch); each
    of the ``solver_iterations`` refinements solves with the factor (one
    solve launch each) and takes a near-exact line search step. With
    ``solver_exact`` each iteration after the first re-factors the Hessian
    from the current active set first: as many factor launches per step as
    solve launches.
    """
    nv = model.nv
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    JpT = Jp.transpose(-1, -2)
    eye = torch.eye(nv, dtype=Mh.dtype, device=Mh.device)

    def jar_active(a):
        jar = mv(Jp, a) - aref
        act = (jar < 0.0).to(Jp.dtype) * (D > 0.0)
        return jar, act

    def factor_at(act):
        H = Mh + (JpT * (D * act)[:, None, :]) @ Jp
        H = H + 1e-9 * eye
        return (H, *_factor(model, H))

    _, act_w = jar_active(qacc_warm)
    H_fac, L_fac, d_fac = factor_at(act_w)

    a = qacc_warm
    for it in range(max(model.solver_iterations, 1)):
        jar, act = jar_active(a)
        if model.solver_exact and it > 0:
            H_fac, L_fac, d_fac = factor_at(act)
        grad = mv(Mh, a) - qfrc + mv(JpT, D * act * jar)
        delta = -_solve(model, H_fac, L_fac, d_fac, grad)

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


def _solve_dual_pgs(model: PhysicsModel, Mh, Jp, D, aref, qfrc, row_active):
    """Projected Gauss-Seidel on the pyramidal dual, λ >= 0
    (``flygym_tpu/engine/contact.py:756-782``), the reference's verification
    fallback: a dense Cholesky of Mh (as JAX's ``cho_factor``, outside any
    kernel there too), then ``max(solver_iterations, 8)`` sweeps that update
    one row after the other, each a few small launches."""
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    chol = torch.linalg.cholesky(Mh)
    qacc_smooth = torch.cholesky_solve(qfrc[..., None], chol)[..., 0]
    X = torch.cholesky_solve(Jp.transpose(-1, -2), chol)  # (B, nv, nrows)
    A = Jp @ X
    R = torch.where(D > 0, 1.0 / torch.clamp(D, min=1e-12), torch.zeros_like(D))
    b0 = mv(Jp, qacc_smooth) - aref
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1) + R, min=1e-12)
    on = row_active.to(Jp.dtype)
    lam = torch.zeros_like(D)
    # Row r's update is a select, not a write into lam, so that autograd
    # can differentiate the sweeps (JAX's ``lam_c.at[r].set``); the values
    # are those of the in-place write.
    pick = torch.eye(Jp.shape[1], dtype=torch.bool, device=Jp.device)
    for _sweep in range(max(model.solver_iterations, 8)):
        for r in range(Jp.shape[1]):
            res = _bdot(A[:, r], lam) + R[:, r] * lam[:, r] + b0[:, r]
            new = torch.clamp(lam[:, r] - res / diag[:, r], min=0.0) * on[:, r]
            lam = torch.where(pick[r], new[:, None], lam)
    return qacc_smooth + mv(X, lam), lam
