"""Mega-step (K2): whole physics steps of one world in one CUDA thread block.

Port of ``flygym_tpu/ops/megastep.py``, the JAX package's main-path kernel.
Three parts:

- :class:`_Static`, the model snapshot the emitter reads (the JAX
  ``_Static``, ``megastep.py:715-888``), with each candidate's DoF path and
  signs. On a world with compressed pair rows (``pair_compress``) each
  group of pair rows that share a geom1 and face one opposing fly becomes
  one row (:func:`_pair_group_specs`).
- :func:`emit_step`, the plain version of K2: the JAX emitter
  (``emit_step``, ``_cand_geom``, the fused ``_contacts_impl``, the tree
  LDLᵀ and ``_emit_sensors``) over lists of (B,) tensors, op for op and in
  the same order, with the same trace-time folding of the model's zeros and
  ±1s. On a heightfield world each candidate's ground is the local plane
  [h, nx, ny, nz] of its input rows, with a contact frame (n, t1, t2) per
  candidate; on flat ground the frame is the world's axes. Fly-fly pair
  rows are capsule against capsule, with their own frame and both bodies'
  DoFs (the second's with sign -1); their cross-tree Hessian fill is
  dropped. A compressed row's geom2 is its group's winner, blended from
  the members with the winner's one-hot, and its signs on the opposing
  fly's DoFs are lane values. :func:`megastep_plain` packs a :class:`State`
  into those lists and chains K steps with one set of planes or winners.
- :func:`make_megastep`, the wrapper of the kernel in
  ``flygym_tpu_torch/csrc/megastep.cu``. The model's constants, its
  scratch layout (:func:`scratch_layout`: which rows live in the block's
  shared memory) and the transposed tables the block's ordered sums walk
  reach the kernel as a generated header (:func:`model_header`), built
  with the kernel by :mod:`flygym_tpu_torch.ops._build`.
  :func:`kernel_shape` reads the launch's shape from the card and
  :func:`profile_megastep` the profile build's phase counters. For a CPU
  tensor the wrapper runs :func:`megastep_plain`; for a CUDA tensor it
  launches K2 or raises.
  On a heightfield world it carries ``sample_planes`` (the plane sampler of
  :mod:`flygym_tpu_torch.engine.terrain`), on a world with compressed pair
  rows the same name samples the groups' winners
  (:func:`~flygym_tpu_torch.engine.contact.make_pair_winner_sampler`); it
  takes either as ``terrain_planes=``.

``launches["megastep"]`` counts kernel launches; only a launch adds to it.
K2 has no gradient, as JAX's Pallas kernel has no VJP: given a tensor that
requires grad in grad mode, the wrapper raises (``ops.refuse_grad``) where
its output would otherwise carry no graph.

Not ported (TPU devices, see ROADMAP "Not to port"): the VMEM estimators
and gates, the streamed emitter, H0-matvec mode, sublane packing, the
winners' expansion into mask rows. Not yet ported (K2 slice g): compressed
pair rows on a heightfield world and pair rows at a condim other than 3;
:func:`megastep_supported` refuses those models.
"""

import weakref

import numpy as np
import torch

from flygym_tpu_torch.engine.contact import make_pair_winner_sampler, n_pyramid_rows
# sin, cos and pow as glibc rounds them (engine/maths.py), like the JAX
# emitter on the CPU and K2's ms_sinf/ms_cosf/ms_powf.
from flygym_tpu_torch.engine.maths import cosf as _cosf
from flygym_tpu_torch.engine.maths import powf, sqrt_rn
from flygym_tpu_torch.engine.maths import sinf as _sinf
from flygym_tpu_torch.engine.model import ActKind, PhysicsModel, State
from flygym_tpu_torch.engine.terrain import make_plane_sampler
from flygym_tpu_torch.ops import refuse_grad

__all__ = [
    "emit_step",
    "launches",
    "kernel_shape",
    "make_megastep",
    "megastep_plain",
    "megastep_supported",
    "model_header",
    "profile_megastep",
    "reset_launches",
    "scratch_layout",
]

_EPS = 1e-9
# Bisection line-search schedule of the engine's _exact_linesearch.
_LS_BISECT_ITERS = 8
_LS_ALPHA_MAX = 2.0
_C_EPS = 1e-12

launches = {"megastep": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Lane-vector maths: 3-vectors and quaternions as tuples of (B,) tensors
# ---------------------------------------------------------------------------


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _quat_to_mat(q):
    w, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


# Constant-folded forms: the second operand is a tuple of Python floats, and
# only its nonzero terms are emitted (as the JAX emitter does at trace time).


def _comb(terms, z):
    out = None
    for v, k in terms:
        k = float(k)
        out = _acc(out, _mul_cf(0.0 if abs(k) < _C_EPS else k, v))
    return z if out is None else out


def _is_ident_quat(c):
    return (
        abs(float(c[0]) - 1.0) < _C_EPS
        and abs(float(c[1])) < _C_EPS
        and abs(float(c[2])) < _C_EPS
        and abs(float(c[3])) < _C_EPS
    )


def _qmul_c(a, c, z):
    """a ∘ c with c a constant quaternion."""
    if _is_ident_quat(c):
        return a
    aw, ax, ay, az = a
    cw, cx, cy, cz = (float(v) for v in c)
    return (
        _comb([(aw, cw), (ax, -cx), (ay, -cy), (az, -cz)], z),
        _comb([(aw, cx), (ax, cw), (ay, cz), (az, -cy)], z),
        _comb([(aw, cy), (ax, -cz), (ay, cw), (az, cx)], z),
        _comb([(aw, cz), (ax, cy), (ay, -cx), (az, cw)], z),
    )


def _cross_c(a, c, z):
    """a × c with c a constant 3-vector."""
    ax, ay, az = a
    cx, cy, cz = (float(v) for v in c)
    return (
        _comb([(ay, cz), (az, -cy)], z),
        _comb([(az, cx), (ax, -cz)], z),
        _comb([(ax, cy), (ay, -cx)], z),
    )


def _cross_cl(c, b, z):
    """c × b with c a constant 3-vector."""
    cx, cy, cz = (float(v) for v in c)
    return (
        _comb([(b[2], cy), (b[1], -cz)], z),
        _comb([(b[0], cz), (b[2], -cx)], z),
        _comb([(b[1], cx), (b[0], -cy)], z),
    )


def _div(x, c: float):
    """x / c rounded as a division. On CUDA tensors, torch computes
    ``x / python_float`` as x times the float's reciprocal, which rounds
    otherwise than the JAX emitter and K2 do."""
    return x / torch.full_like(x, c)


def _rdiv(c: float, x):
    """c / x rounded as a division: torch computes ``python_float / x`` as
    x's reciprocal times the float."""
    return torch.full_like(x, c) / x


def _mul_cf(coef, x):
    """coef·x, coef a Python float or a tensor, x a tensor or None (a
    structural zero). None for an exactly-zero product: 0·x and 1·x fold."""
    if x is None or coef is None:
        return None
    if isinstance(coef, float):
        if coef == 0.0:
            return None
        if coef == 1.0:
            return x
        if coef == -1.0:
            return -x
        return x * coef
    return coef * x


def _acc(out, term):
    if term is None:
        return out
    return term if out is None else out + term


def _qrot_c(q, c, z):
    """Rotate the constant 3-vector c by the quaternion q."""
    cx, cy, cz = (float(v) for v in c)
    if abs(cx) < _C_EPS and abs(cy) < _C_EPS and abs(cz) < _C_EPS:
        return (z, z, z)
    w, x, y, zc = q
    qv = (x, y, zc)
    t = _scale3(_cross_c(qv, (cx, cy, cz), z), 2.0)
    u = _cross(qv, t)
    out = []
    for comp, cv in zip(range(3), (cx, cy, cz)):
        val = w * t[comp] + u[comp]
        if abs(cv) >= _C_EPS:
            val = val + cv
        out.append(val)
    return tuple(out)


def _qmul_sp(a, b, z):
    """a ∘ b where b's components may be None (structural zeros)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b

    def comb(terms):
        out = None
        for u, v, s in terms:
            if v is None:
                continue
            t = u * v
            if out is None:
                out = -t if s < 0 else t
            else:
                out = out - t if s < 0 else out + t
        return z if out is None else out

    return (
        comb([(aw, bw, 1), (ax, bx, -1), (ay, by, -1), (az, bz, -1)]),
        comb([(aw, bx, 1), (ax, bw, 1), (ay, bz, 1), (az, by, -1)]),
        comb([(aw, by, 1), (ax, bz, -1), (ay, bw, 1), (az, bx, 1)]),
        comb([(aw, bz, 1), (ax, by, 1), (ay, bx, -1), (az, bw, 1)]),
    )


# ---------------------------------------------------------------------------
# Compressed pair groups
# ---------------------------------------------------------------------------


def _pair_group_specs(model: PhysicsModel):
    """Static spec per compressed pair group (the JAX ``_pair_group_specs``,
    ``megastep.py:82-217``), or ``([], None)`` without compressed rows.

    Each group is a contiguous run of capsule-capsule candidate rows that
    share one geom1 and face one opposing fly; it becomes one row whose
    geom2 is the group's winner, picked outside the step. Returns (specs,
    keep): ``keep`` selects the ground rows and each group's first row;
    ``specs[g]`` holds ``members`` ([(geom2, body2)]), the members'
    ``invw``, ``r2`` and ``h2``, ``dof_sign_spec`` ({DoF: "all" or the runs
    of member indices whose path holds it} over the members' DoF union),
    ``listed`` (the distinct runs, sorted) and ``dof_sign_idx`` (each
    run-listed DoF's index into ``listed``).

    Raises:
        ValueError: a group mixes geom1 or contact parameters, or a member
            shares a DoF with geom1 (one kinematic tree).
    """
    if not (model.pair_compress and model.ncand_pair):
        return [], None
    f = lambda x: x.detach().cpu().numpy()
    body_parent = f(model.body_parent)
    body_dofs = {b: [] for b in range(model.nbody)}
    for h, b in enumerate(f(model.hinge_body)):
        body_dofs[int(b)].append(int(f(model.hinge_vadr)[h]))
    for b, _qa, va in model.free_joints:
        body_dofs[int(b)] = list(range(int(va), int(va) + 6))

    def path_dofs(b):
        out = set()
        while b != 0:
            out.update(body_dofs[b])
            b = int(body_parent[b])
        return out

    can_geom, can_geom2 = f(model.can_geom), f(model.can_geom2)
    can_body, can_body2 = f(model.can_body), f(model.can_body2)
    friction, solref, solimp = f(model.can_friction), f(model.can_solref), f(model.can_solimp)
    margin, invweight, geom_size = f(model.can_margin), f(model.can_invweight), f(model.geom_size)
    ng = model.ncand - model.ncand_pair
    keep = list(range(ng))
    specs = []
    for start, size in model.pair_groups:
        rows = [ng + start + j for j in range(size)]
        r0 = rows[0]
        for r in rows[1:]:
            if int(can_geom[r]) != int(can_geom[r0]):
                raise ValueError("pair group mixes geom1")
            if not (np.array_equal(friction[r], friction[r0])
                    and np.array_equal(solref[r], solref[r0])
                    and np.array_equal(solimp[r], solimp[r0])
                    and margin[r] == margin[r0]):
                raise ValueError("pair group mixes contact params")
        members = [(int(can_geom2[r]), int(can_body2[r])) for r in rows]
        dof_members = {}
        for j, (_g2, b2) in enumerate(members):
            for d in path_dofs(b2):
                dof_members.setdefault(d, []).append(j)
        g1_path = path_dofs(int(can_body[r0]))
        dof_sign_spec = {}
        for d, js in sorted(dof_members.items()):
            if d in g1_path:
                raise ValueError("pair group geom2 shares DoFs with geom1 (same kinematic "
                                 "tree): compression assumes disjoint trees")
            if len(js) == size:
                dof_sign_spec[d] = "all"
                continue
            runs = []
            lo = prev = js[0]
            for j in js[1:]:
                if j == prev + 1:
                    prev = j
                    continue
                runs.append((lo, prev))
                lo = prev = j
            runs.append((lo, prev))
            dof_sign_spec[d] = tuple(runs)
        listed = sorted({sp for sp in dof_sign_spec.values() if sp != "all"})
        run_idx = {runs: k for k, runs in enumerate(listed)}
        specs.append(dict(
            row0=r0,
            members=members,
            invw=[float(invweight[r, 0]) for r in rows],
            r2=[float(geom_size[g2, 0]) for g2, _b2 in members],
            h2=[float(geom_size[g2, 1]) for g2, _b2 in members],
            dof_sign_spec=dof_sign_spec,
            listed=listed,
            dof_sign_idx={d: run_idx[sp] for d, sp in dof_sign_spec.items() if sp != "all"},
        ))
        keep.append(r0)
    return specs, np.asarray(keep, np.int64)


# ---------------------------------------------------------------------------
# Static model snapshot
# ---------------------------------------------------------------------------


class _Static:
    """What the emitter and the kernel's header need, as numpy arrays and
    Python structures (the JAX ``_Static``)."""

    def __init__(self, model: PhysicsModel):
        f = lambda x: x.detach().cpu().numpy()
        self.nbody = model.nbody
        self.nq, self.nv, self.nu, self.na = model.nq, model.nv, model.nu, model.na
        self.nhinge = model.nhinge
        self.nsite = model.nsite
        self.ncand = model.ncand
        self.condim = model.condim
        self.timestep = float(model.timestep)
        self.solver_iterations = int(model.solver_iterations)
        self.solver_exact = bool(model.solver_exact)
        self.ref_body = int(model.ref_body)
        self.gravity = f(model.gravity)

        self.body_parent = f(model.body_parent)
        self.body_pos = f(model.body_pos)
        self.body_quat = f(model.body_quat)
        self.body_ipos = f(model.body_ipos)
        self.body_iquat = f(model.body_iquat)
        self.body_mass = f(model.body_mass)
        self.body_inertia = f(model.body_inertia)

        # Topological order (parents before children), skipping world (0).
        order, depth = [], {0: 0}
        pending = list(range(1, self.nbody))
        while pending:
            nxt = [b for b in pending if int(self.body_parent[b]) in depth]
            for b in nxt:
                depth[b] = depth[int(self.body_parent[b])] + 1
                order.append(b)
            pending = [b for b in pending if b not in depth]
        self.topo = order

        self.hinge_body = f(model.hinge_body)
        self.hinge_slot = f(model.hinge_slot)
        self.hinge_axis = f(model.hinge_axis)
        self.hinge_qadr = f(model.hinge_qadr)
        self.hinge_vadr = f(model.hinge_vadr)
        self.hinge_stiffness = f(model.hinge_stiffness)
        self.hinge_springref = f(model.hinge_springref)

        self.dof_body = f(model.dof_body)
        self.dof_armature = f(model.dof_armature)
        self.dof_damping = f(model.dof_damping)
        self.dof_chains = [list(c) for c in model.dof_chains]
        self.free_joints = [tuple(int(x) for x in j) for j in model.free_joints]
        self.free_dof_axis = {}
        for _b, _qa, va in self.free_joints:
            for i in range(6):
                self.free_dof_axis[va + i] = i  # 0-2 translation, 3-5 rotation

        # Hinges per body (by slot) and DoFs per body.
        self.body_hinges = {b: [] for b in range(self.nbody)}
        for h in range(self.nhinge):
            self.body_hinges[int(self.hinge_body[h])].append(h)
        for b in self.body_hinges:
            self.body_hinges[b].sort(key=lambda h: int(self.hinge_slot[h]))
        self.body_dofs = {b: [] for b in range(self.nbody)}
        for h in range(self.nhinge):
            self.body_dofs[int(self.hinge_body[h])].append(int(self.hinge_vadr[h]))
        for b, _qa, va in self.free_joints:
            self.body_dofs[b] = list(range(va, va + 6))

        # Per-DoF root path (ancestors + self) and per-body affecting DoFs.
        self.dof_path = [self.dof_chains[d] + [d] for d in range(self.nv)]
        anc_bodies = {0: []}
        for b in order:
            anc_bodies[b] = anc_bodies[int(self.body_parent[b])] + [b]
        self.body_path_dofs = {
            b: [d for ab in anc_bodies[b] for d in self.body_dofs[ab]]
            for b in range(self.nbody)
        }

        # Tree-sparse matrix keys (ancestor_or_self, dof), and the
        # leaves→root elimination order.
        self.pair_keys = [(a_, d) for d in range(self.nv) for a_ in self.dof_path[d]]
        self.elim_order = sorted(range(self.nv), key=lambda d: -len(self.dof_chains[d]))

        self.geom_body = f(model.geom_body)
        self.geom_pos = f(model.geom_pos)
        self.geom_quat = f(model.geom_quat)
        self.geom_size = f(model.geom_size)
        self.site_body = f(model.site_body) if self.nsite else np.zeros(0, int)
        self.site_pos = f(model.site_pos) if self.nsite else np.zeros((0, 3))

        self.can_geom = f(model.can_geom)
        self.can_geom2 = f(model.can_geom2)
        self.ncand_pair = int(model.ncand_pair)
        self.ng_rows = self.ncand - self.ncand_pair
        self.can_end = f(model.can_end)
        self.can_friction = f(model.can_friction)
        self.can_solref = f(model.can_solref)
        self.can_solimp = f(model.can_solimp)
        self.can_margin = f(model.can_margin)
        self.can_adh_act = f(model.can_adh_act)
        self.can_sensor = f(model.can_sensor)
        self.can_invweight = f(model.can_invweight)
        self.ground_z = float(f(model.ground_pos)[2])
        self.has_hfield = bool(model.has_hfield)
        self.nsensor = model.nsensor_contact

        # Compressed pair rows: the candidate table keeps the ground rows
        # and one row per group (JAX ``megastep.py:837-861``).
        self.pair_comp_groups, self.pair_keep = _pair_group_specs(model)
        if self.pair_comp_groups:
            keep = self.pair_keep
            for name in ("can_geom", "can_geom2", "can_end", "can_friction", "can_solref",
                         "can_solimp", "can_margin", "can_adh_act", "can_sensor",
                         "can_invweight"):
                setattr(self, name, getattr(self, name)[keep])
            self.ncand_pair = len(self.pair_comp_groups)
            self.ncand = self.ng_rows + self.ncand_pair

        # Per candidate its DoF path and signs, in the JAX emitter's order
        # (``megastep.py:1675-1691``): the first body's path DoFs with +1,
        # then the second body's (pair rows) with -1; a DoF that moves both
        # nets 0 and leaves the path. ``cand_split[c]`` is where the second
        # body's DoFs start (the path's length on ground rows). A compressed
        # row's second part is its members' DoF union in DoF order, -1 on
        # the DoFs that move every member and otherwise the index of the
        # DoF's run into ``listed``: the emitter makes those signs from the
        # winner.
        self.cand_paths, self.cand_signs, self.cand_split = [], [], []
        for c in range(self.ncand):
            first = self.body_path_dofs[int(self.geom_body[int(self.can_geom[c])])]
            signs = dict.fromkeys(first, 1.0)
            if c >= self.ng_rows and self.pair_comp_groups:
                grp = self.pair_comp_groups[c - self.ng_rows]
                for d, spec in sorted(grp["dof_sign_spec"].items()):
                    signs[d] = -1.0 if spec == "all" else grp["dof_sign_idx"][d]
            elif c >= self.ng_rows:
                for d in self.body_path_dofs[int(self.geom_body[int(self.can_geom2[c])])]:
                    signs[d] = signs.get(d, 0.0) - 1.0
            path = [d for d, sgn in signs.items() if not (isinstance(sgn, float) and sgn == 0.0)]
            self.cand_paths.append(path)
            self.cand_signs.append([signs[d] for d in path])
            self.cand_split.append(sum(signs[d] != 0.0 for d in first))

        # Candidates grouped by adhesion actuator and by sensor slot.
        self.adh_groups = {}
        for c in range(self.ncand):
            a_ = int(self.can_adh_act[c])
            if a_ >= 0:
                self.adh_groups.setdefault(a_, []).append(c)
        self.sensor_groups = {s: [] for s in range(self.nsensor)}
        for c in range(self.ncand):
            s = int(self.can_sensor[c])
            if s >= 0:
                self.sensor_groups[s].append(c)

        self.act_kind = f(model.act_kind)
        self.act_hinge = f(model.act_hinge)
        self.act_gain = f(model.act_gain)
        self.act_kv = f(model.act_kv)
        self.act_ctrlrange = f(model.act_ctrlrange)
        self.act_ctrllimited = f(model.act_ctrllimited)
        self.act_forcerange = f(model.act_forcerange)
        self.act_forcelimited = f(model.act_forcelimited)
        self.act_actadr = f(model.act_actadr)
        self.act_dynprm = f(model.act_dynprm)
        self.act_muscleprm = f(model.act_muscleprm)
        self.act_lengthrange = f(model.act_lengthrange)
        self.act_acc0 = f(model.act_acc0)


def megastep_supported(model: PhysicsModel) -> bool:
    """Whether K2 covers ``model``: the feature half of the JAX gate
    (``megastep.py:934-989``) as far as the port goes — Newton (frozen or
    ``solver_exact``), no welds, condim 1, 3, 4 or 6 on ground rows (pair
    rows at condim 3 only; other condims run them on the engine step),
    every actuator kind with its
    activation states, worlds without contact candidates (a tethered fly:
    qacc is the tree solve of Mh against the forces), candidate paths that
    run down one chain of the tree per body, pair rows without sensors or
    adhesion, and compressed pair rows (:func:`_winner_paths_ok`) on flat
    ground only. Its sizes must fit K2: the walk tables' indices
    (``_pack16``: the Hessian entries and candidates below 2^15) and the
    first scratch slot in a block's shared memory (``scratch_layout`` moves
    the later slots to global memory where shared memory runs out). The
    fly at every preset passes: ``JointPreset.ALL_POSSIBLE`` (nv 210, 3,408
    Hessian entries) needs 103 KB of shared memory."""
    compressed = model.pair_compress and model.ncand_pair
    if (
        model.solver_type != "newton"
        or model.welds
        or (compressed and model.has_hfield)
        or model.condim not in (1, 3, 4, 6)
        or (model.ncand_pair and model.condim != 3)
    ):
        return False
    try:
        st = _Static(model)
    except ValueError:  # a compressed group breaks its invariants
        return False
    if len(st.pair_keys) >= 1 << 15 or st.ncand >= 1 << 15 or not _first_slot_fits(model):
        return False
    pairs = range(st.ng_rows, st.ncand)
    if any(int(st.can_sensor[c]) >= 0 or int(st.can_adh_act[c]) >= 0 for c in pairs):
        return False
    bodies = {int(st.geom_body[int(g)]) for g in st.can_geom}
    if compressed:
        return all(_path_on_chain(st, b) for b in bodies) and _winner_paths_ok(st)
    bodies |= {int(st.geom_body[int(st.can_geom2[c])]) for c in pairs}
    return all(_path_on_chain(st, b) for b in bodies) and all(_fill_by_part(st, c) for c in pairs)


def _first_slot_fits(model: PhysicsModel) -> bool:
    """The Newton loop's candidate rows, K2's first scratch slot, fit in a
    block's shared memory."""
    return scratch_layout(model)["n_shared"] > 0


def _path_on_chain(st: _Static, body: int) -> bool:
    """Every prefix of the body's DoF path is a DoF's root path, so the
    Hessian key of (path[i], path[j]), i <= j, is entry i of path[j]'s
    column."""
    path = st.body_path_dofs[body]
    return all(st.dof_path[d] == path[: j + 1] for j, d in enumerate(path))


def _winner_paths_ok(st: _Static) -> bool:
    """On each compressed row and for each member as the winner, the path
    the JAX emitter walks (geom1's path, then the DoF union in DoF order,
    where the DoFs that do not move the winner add exact zeros) is geom1's
    path at +1 then the winner's body path at -1, in that order, each on one
    chain of its own tree: so K2 walks geom1's and the winner's body paths,
    skips the other members' DoFs, and fills the Hessian within each part
    only (the two flies' trees share no DoF)."""
    for c, grp in zip(range(st.ng_rows, st.ncand), st.pair_comp_groups):
        split = st.cand_split[c]
        first, union = st.cand_paths[c][:split], st.cand_paths[c][split:]
        for _g2, b2 in grp["members"]:
            path = st.body_path_dofs[b2]
            moves = set(path)
            if set(first) & moves or not _path_on_chain(st, b2):
                return False
            if [d for d in union if d in moves] != path:
                return False
    return True


def _fill_by_part(st: _Static, c: int) -> bool:
    """On pair row ``c``, the signs are +1 on the first body's part of the
    path and -1 on the second's, and the emitter's Hessian fill keeps
    (path[i], path[j]), i <= j, exactly where both lie in the same part of the
    path (cross-tree fill-in is dropped, ``megastep.py:1774-1783``), and
    there path[i] is an ancestor-or-self of path[j], at depth
    len(dof_chains[path[i]]) of path[j]'s column."""
    path, split = st.cand_paths[c], st.cand_split[c]
    if st.cand_signs[c] != [1.0] * split + [-1.0] * (len(path) - split):
        return False
    for i, a_ in enumerate(path):
        for j in range(i, len(path)):
            b_ = path[j]
            kept = a_ == b_ or a_ in st.dof_chains[b_] or b_ in st.dof_chains[a_]
            if kept != ((i < split) == (j < split)):
                return False
            if kept and (a_ not in st.dof_path[b_]
                         or st.dof_path[b_].index(a_) != len(st.dof_chains[a_])):
                return False
    return True


# ---------------------------------------------------------------------------
# The plain version of K2: one physics step over lists of (B,) tensors
# ---------------------------------------------------------------------------


def emit_step(st: _Static, q, v, ctrl, act, warm, terrain=None, widx=None):
    """One physics step (the JAX ``emit_step``).

    Args:
        st: The static model snapshot.
        q, v, ctrl, act, warm: Lists of (B,) tensors (nq, nv, nu, na, nv).
        terrain: Per candidate the local ground plane (h, nx, ny, nz) as
            (B,) tensors on a heightfield world; None on flat ground.
        widx: Per compressed pair group its winner, a (B,) float tensor of
            group-local member indices; None without compressed rows.

    Returns:
        dict of lists of (B,) tensors: qpos, qvel, act, qacc, xpos (nbody
        3-tuples), xquat (nbody 4-tuples), site_xpos, actuator_force,
        sensordata (nsensor lists of 16).
    """
    z = torch.zeros_like(q[0])
    one = torch.ones_like(q[0])
    dt = st.timestep

    # ---------------- FK: parent → child over the tree ----------------
    xpos = [None] * st.nbody
    xquat = [None] * st.nbody
    xpos[0] = (z, z, z)
    xquat[0] = (one, z, z, z)
    hinge_xaxis = [None] * st.nhinge
    free_bodies = {b for b, _qa, _va in st.free_joints}
    free_qadr = {b: qa for b, qa, _va in st.free_joints}

    for b in st.topo:
        p = int(st.body_parent[b])
        if b in free_bodies:
            qa = free_qadr[b]
            xpos[b] = (q[qa], q[qa + 1], q[qa + 2])
            xquat[b] = (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6])
            continue
        cur = _qmul_c(xquat[p], st.body_quat[b], z)
        for h in st.body_hinges[b]:
            ax = st.hinge_axis[h]
            # The world hinge axis uses the rotation before the hinge.
            hinge_xaxis[h] = _qrot_c(cur, ax, z)
            half = 0.5 * q[int(st.hinge_qadr[h])]
            c_, s_ = _cosf(half), _sinf(half)
            hq = [c_, None, None, None]
            for j in range(3):
                aj = float(ax[j])
                if abs(aj) < _C_EPS:
                    continue
                hq[j + 1] = s_ if aj == 1.0 else (-s_ if aj == -1.0 else s_ * aj)
            cur = _qmul_sp(cur, hq, z)
        xquat[b] = cur
        bp = st.body_pos[b]
        if max(abs(float(x)) for x in bp) < _C_EPS:
            xpos[b] = xpos[p]
        else:
            xpos[b] = _add3(xpos[p], _qrot_c(xquat[p], bp, z))

    ref = xpos[st.ref_body]

    # ---------------- motion subspace S: (angular, linear) at ref ----------
    S = [None] * st.nv
    for h in range(st.nhinge):
        b = int(st.hinge_body[h])
        a_w = hinge_xaxis[h]
        S[int(st.hinge_vadr[h])] = (a_w, _cross(_sub3(xpos[b], ref), a_w))
    for b, _qa, va in st.free_joints:
        p_ = _sub3(xpos[b], ref)
        for i in range(3):
            e = [z, z, z]
            e[i] = one
            S[va + i] = ((z, z, z), tuple(e))
        for i in range(3):
            e = (one if i == 0 else z, one if i == 1 else z, one if i == 2 else z)
            S[va + 3 + i] = (e, _cross(p_, e))

    # ---------------- velocities and bias accelerations (topo) ------------
    zero6 = ((z, z, z), (z, z, z))

    def m6_add(a, b_):
        return (_add3(a[0], b_[0]), _add3(a[1], b_[1]))

    def m6_scale(a, s):
        return (_scale3(a[0], s), _scale3(a[1], s))

    def m6_cross(m, o):
        w_, v_ = m
        ow, ov = o
        return (_cross(w_, ow), _add3(_cross(w_, ov), _cross(v_, ow)))

    cvel = [zero6] * st.nbody
    cacc = [zero6] * st.nbody
    for b in st.topo:
        p = int(st.body_parent[b])
        vel = cvel[p]
        acc = cacc[p]
        if b in free_bodies:
            va = st.body_dofs[b][0]
            for i in range(6):
                vel = m6_add(vel, m6_scale(S[va + i], v[va + i]))
            vlin = (v[va], v[va + 1], v[va + 2])
            omg = (v[va + 3], v[va + 4], v[va + 5])
            acc = m6_add(acc, ((z, z, z), _cross(vlin, omg)))
        else:
            for d in st.body_dofs[b]:
                sd = m6_scale(S[d], v[d])
                acc = m6_add(acc, m6_cross(vel, sd))
                vel = m6_add(vel, sd)
        cvel[b] = vel
        cacc[b] = acc

    # ---------------- spatial inertias about ref, world axes --------------
    I_body = [None] * st.nbody
    for b in st.topo:
        R = _quat_to_mat(_qmul_c(xquat[b], st.body_iquat[b], z))
        I1, I2, I3 = (float(x) for x in st.body_inertia[b])
        Ibar = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(i, 3):
                Ibar[i][j] = (
                    R[i][0] * R[j][0] * I1
                    + R[i][1] * R[j][1] * I2
                    + R[i][2] * R[j][2] * I3
                )
                Ibar[j][i] = Ibar[i][j]
        m = float(st.body_mass[b])
        ip = st.body_ipos[b]
        if max(abs(float(x)) for x in ip) < _C_EPS:
            com = xpos[b]
        else:
            com = _add3(xpos[b], _qrot_c(xquat[b], ip, z))
        cx, cy, cz = _sub3(com, ref)
        c2 = cx * cx + cy * cy + cz * cz
        TL = [
            [
                Ibar[0][0] + m * (c2 - cx * cx),
                Ibar[0][1] - m * cx * cy,
                Ibar[0][2] - m * cx * cz,
            ],
            [None, Ibar[1][1] + m * (c2 - cy * cy), Ibar[1][2] - m * cy * cz],
            [None, None, Ibar[2][2] + m * (c2 - cz * cz)],
        ]
        TL[1][0], TL[2][0], TL[2][1] = TL[0][1], TL[0][2], TL[1][2]
        TR = [
            [z, -m * cz, m * cy],
            [m * cz, z, -m * cx],
            [-m * cy, m * cx, z],
        ]
        I_body[b] = (TL, TR, m)

    def I_mul(I, m6):
        """Spatial inertia times a motion vector → force vector (n, f)."""
        TL, TR, m_ = I
        w_, v_ = m6
        n = tuple(
            TL[i][0] * w_[0] + TL[i][1] * w_[1] + TL[i][2] * w_[2]
            + TR[i][0] * v_[0] + TR[i][1] * v_[1] + TR[i][2] * v_[2]
            for i in range(3)
        )
        f = tuple(
            TR[0][i] * w_[0] + TR[1][i] * w_[1] + TR[2][i] * w_[2] + m_ * v_[i]
            for i in range(3)
        )
        return (n, f)

    # ---------------- composite inertias (reverse topo) -------------------
    Icomp = [
        ([list(r) for r in I_body[b][0]], [list(r) for r in I_body[b][1]], I_body[b][2])
        if I_body[b]
        else None
        for b in range(st.nbody)
    ]
    for b in reversed(st.topo):
        p = int(st.body_parent[b])
        if p == 0:
            continue
        TLp, TRp, mp = Icomp[p]
        TLb, TRb, mb = Icomp[b]
        for i in range(3):
            for j in range(3):
                TLp[i][j] = TLp[i][j] + TLb[i][j]
                TRp[i][j] = TRp[i][j] + TRb[i][j]
        Icomp[p] = (TLp, TRp, mp + mb)

    # ---------------- CRBA: tree-sparse mass matrix ------------------------
    F = [I_mul(Icomp[int(st.dof_body[d])], S[d]) for d in range(st.nv)]

    def m6_dot(a, b_):
        return _dot3(a[0], b_[0]) + _dot3(a[1], b_[1])

    def m6_dot_free(a_, Fd):
        """S[a_]·F with the free joint's constant columns folded."""
        fa = st.free_dof_axis.get(a_)
        if fa is None:
            return m6_dot(S[a_], Fd)
        if fa < 3:
            return Fd[1][fa]
        return Fd[0][fa - 3] + _dot3(S[a_][1], Fd[1])

    Mh = {}
    for a_, d in st.pair_keys:
        val = m6_dot_free(a_, F[d])
        if a_ == d:
            val = val + float(st.dof_armature[d]) + dt * float(st.dof_damping[d])
        Mh[(a_, d)] = val

    # ---------------- RNEA bias (reverse-topo force accumulation) ---------
    g = tuple(float(x) for x in st.gravity)
    f_sub = [None] * st.nbody
    for b in st.topo:
        glin = tuple(
            cacc[b][1][k] - g[k] if abs(g[k]) >= _C_EPS else cacc[b][1][k]
            for k in range(3)
        )
        Ia = I_mul(I_body[b], (cacc[b][0], glin))
        n_, fl_ = I_mul(I_body[b], cvel[b])
        w_, v_ = cvel[b]
        fc = (_add3(_cross(w_, n_), _cross(v_, fl_)), _cross(w_, fl_))
        f_sub[b] = m6_add(Ia, fc)
    for b in reversed(st.topo):
        p = int(st.body_parent[b])
        if p != 0:
            f_sub[p] = m6_add(f_sub[p], f_sub[b])
    qfrc_bias = [m6_dot_free(d, f_sub[int(st.dof_body[d])]) for d in range(st.nv)]

    # ---------------- passive + actuator forces ---------------------------
    qfrc = [-float(st.dof_damping[d]) * v[d] - qfrc_bias[d] for d in range(st.nv)]
    for h in range(st.nhinge):
        k = float(st.hinge_stiffness[h])
        if k:
            d = int(st.hinge_vadr[h])
            qfrc[d] = qfrc[d] - k * (q[int(st.hinge_qadr[h])] - float(st.hinge_springref[h]))

    actuator_force = [z] * st.nu
    c_clamped = [None] * st.nu
    for u in range(st.nu):
        c_ = ctrl[u]
        if st.act_ctrllimited[u] > 0:
            c_ = torch.clamp(c_, float(st.act_ctrlrange[u, 0]), float(st.act_ctrlrange[u, 1]))
        c_clamped[u] = c_
        kind = int(st.act_kind[u])
        gain, kv = float(st.act_gain[u]), float(st.act_kv[u])
        h = int(st.act_hinge[u])
        qh = q[int(st.hinge_qadr[h])] if h >= 0 else z
        vh = v[int(st.hinge_vadr[h])] if h >= 0 else z
        adr = int(st.act_actadr[u])
        a_slot = act[adr] if adr >= 0 else z
        if kind == ActKind.MOTOR:
            force = gain * c_
        elif kind == ActKind.POSITION:
            force = gain * (c_ - qh) - kv * vh
        elif kind == ActKind.VELOCITY:
            force = gain * (c_ - vh)
        elif kind == ActKind.INTVELOCITY:
            force = gain * (a_slot - qh) - kv * vh
        elif kind == ActKind.DAMPER:
            force = -gain * c_ * vh
        elif kind == ActKind.CYLINDER:
            force = gain * a_slot
        elif kind == ActKind.MUSCLE:
            force = _muscle_force_lane(st, u, qh, vh, a_slot)
        else:  # adhesion: the readout is the commanded force; the solver applies it
            actuator_force[u] = gain * c_
            continue
        if st.act_forcelimited[u] > 0:
            force = torch.clamp(
                force, float(st.act_forcerange[u, 0]), float(st.act_forcerange[u, 1])
            )
        actuator_force[u] = force
        if h >= 0:
            d = int(st.hinge_vadr[h])
            qfrc[d] = qfrc[d] + force

    # ---------------- contacts --------------------------------------------
    qacc, cons = _contacts(st, v, c_clamped, warm, xpos, xquat, S, ref, Mh, qfrc, z, terrain,
                           widx)

    # ---------------- integrate -------------------------------------------
    v_new = [v[d] + dt * qacc[d] for d in range(st.nv)]
    q_new = list(q)
    for h in range(st.nhinge):
        qa, va = int(st.hinge_qadr[h]), int(st.hinge_vadr[h])
        q_new[qa] = q[qa] + dt * v_new[va]
    for b, qa, va in st.free_joints:
        for i in range(3):
            q_new[qa + i] = q[qa + i] + dt * v_new[va + i]
        om = (v_new[va + 3], v_new[va + 4], v_new[va + 5])
        ang = torch.sqrt(_dot3(om, om) + 1e-24) * dt
        scale = torch.where(
            ang > 1e-12,
            _sinf(0.5 * ang) / torch.clamp(_div(ang, dt), min=1e-12),
            0.5 * dt,
        )
        dq = (_cosf(0.5 * ang), om[0] * scale, om[1] * scale, om[2] * scale)
        nq_ = _qmul(dq, (q[qa + 3], q[qa + 4], q[qa + 5], q[qa + 6]))
        norm = torch.sqrt(nq_[0] ** 2 + nq_[1] ** 2 + nq_[2] ** 2 + nq_[3] ** 2)
        for i in range(4):
            q_new[qa + 3 + i] = nq_[i] / norm

    # ---------------- activation dynamics ------------------------------------
    # From the clamped controls and the activations at the start of the step.
    act_new = list(act)
    for u in range(st.nu):
        adr = int(st.act_actadr[u])
        if adr < 0:
            continue
        kind = int(st.act_kind[u])
        c_, a_ = c_clamped[u], act[adr]
        if kind == ActKind.INTVELOCITY:
            act_new[adr] = a_ + dt * c_
        elif kind == ActKind.CYLINDER:
            act_new[adr] = a_ + _div(dt * (c_ - a_), max(float(st.act_dynprm[u, 0]), _EPS))
        elif kind == ActKind.MUSCLE:
            cm = torch.clamp(c_, 0.0, 1.0)
            tau_act = max(float(st.act_dynprm[u, 0]), _EPS)
            tau_deact = max(float(st.act_dynprm[u, 1]), _EPS)
            s_ = 0.5 + 1.5 * a_
            tau = torch.where(cm > a_, tau_act * s_, _rdiv(tau_deact, s_))
            act_new[adr] = torch.clamp(a_ + dt * (cm - a_) / torch.clamp(tau, min=_EPS), 0.0, 1.0)

    # ---------------- sites + sensors --------------------------------------
    site_xpos = []
    for s in range(st.nsite):
        b = int(st.site_body[s])
        sp = st.site_pos[s]
        if max(abs(float(x)) for x in sp) < _C_EPS:
            site_xpos.append(xpos[b])
        else:
            site_xpos.append(_add3(xpos[b], _qrot_c(xquat[b], sp, z)))

    return dict(
        qpos=q_new,
        qvel=v_new,
        act=act_new,
        qacc=qacc,
        xpos=xpos,
        xquat=xquat,
        site_xpos=site_xpos,
        actuator_force=actuator_force,
        sensordata=_emit_sensors(st, cons, z, one),
    )


def _sq(x):
    return x * x


def _muscle_consts(st, u) -> dict:
    """The constants of muscle ``u``'s force as the JAX emitter's Python
    arithmetic folds them (``_muscle_force_lane``, ``megastep.py:1453-1500``):
    doubles, rounded to float32 where they meet a tensor."""
    prm = [float(x) for x in st.act_muscleprm[u]]
    range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax = prm[:9]
    lr0, lr1 = float(st.act_lengthrange[u, 0]), float(st.act_lengthrange[u, 1])
    L0 = (lr1 - lr0) / max(range1 - range0, _EPS)
    acc0 = float(st.act_acc0[u]) if st.act_acc0.size else 1.0
    peak = scale / max(acc0, _EPS) if force < 0 else force
    a_, b_ = 0.5 * (lmin + 1.0), 0.5 * (1.0 + lmax)
    y = fvmax - 1.0
    return dict(
        lr0=lr0, l0=max(L0, _EPS), range0=range0, vden=max(L0 * vmax, _EPS),
        lmin=lmin, a=a_, b=b_, lmax=lmax,
        d_rise=max(a_ - lmin, _EPS), d_plo=max(1.0 - a_, _EPS), d_phi=max(b_ - 1.0, _EPS),
        d_fall=max(lmax - b_, _EPS), y=y, d_y=max(y, _EPS), fvmax=fvmax,
        neg_peak=-peak, c_ramp=-peak * fpmax * 0.5, c_lin=-peak * fpmax,
    )


# The order of the muscle constants in K2's table kMus (model_header).
_MUSCLE_KEYS = ("lr0", "l0", "range0", "vden", "lmin", "a", "b", "lmax", "d_rise", "d_plo",
                "d_phi", "d_fall", "y", "d_y", "fvmax", "neg_peak", "c_ramp", "c_lin")


def _le(x, c: float):
    """x <= c with c rounded to float32, as JAX compares with a weak scalar."""
    return x <= float(np.float32(c))


def _muscle_force_lane(st, u, length, vel, a_slot):
    """MuJoCo's muscle force of actuator ``u``: the force-length-velocity
    gain times the activation, plus the passive bias (the JAX
    ``_muscle_force_lane``, op for op; each branch of the curves' chain of
    selects is evaluated, as ``jnp.where`` does)."""
    k = _muscle_consts(st, u)
    L = k["range0"] + _div(length - k["lr0"], k["l0"])
    V = _div(vel, k["vden"])
    x_rise = _div(L - k["lmin"], k["d_rise"])
    x_plo = _div(1.0 - L, k["d_plo"])
    x_phi = _div(L - 1.0, k["d_phi"])
    x_fall = _div(k["lmax"] - L, k["d_fall"])
    gl = torch.where(_le(L, k["lmin"]), 0.0, torch.where(
        _le(L, k["a"]), 0.5 * _sq(x_rise), torch.where(
            _le(L, 1.0), 1.0 - 0.5 * _sq(x_plo), torch.where(
                _le(L, k["b"]), 1.0 - 0.5 * _sq(x_phi), torch.where(
                    _le(L, k["lmax"]), 0.5 * _sq(x_fall), 0.0)))))
    gv = torch.where(_le(V, -1.0), 0.0, torch.where(
        _le(V, 0.0), _sq(V + 1.0), torch.where(
            _le(V, k["y"]), k["fvmax"] - _div(_sq(k["y"] - V), k["d_y"]), k["fvmax"])))
    gain = k["neg_peak"] * gl * gv
    x_ramp = _div(L - 1.0, k["d_phi"])
    x_lin = _div(L - k["b"], k["d_phi"])
    bias = torch.where(_le(L, 1.0), 0.0, torch.where(
        _le(L, k["b"]), k["c_ramp"] * _sq(x_ramp), k["c_lin"] * (0.5 + x_lin)))
    return gain * a_slot + bias


def _frame(n_c, z):
    """The contact frame (n, t1, t2) of a normal, as the JAX
    ``_contact_frames`` builds it: t1 from the x axis (the y axis where
    |nx| > 0.9) made orthogonal to n and normalised, t2 = n × t1."""
    use_ey = torch.abs(n_c[0]) > 0.9
    seed = (torch.where(use_ey, 0.0, 1.0), torch.where(use_ey, 1.0, 0.0), z)
    t1 = _sub3(seed, _scale3(n_c, _dot3(seed, n_c)))
    t1n = torch.clamp(sqrt_rn(_dot3(t1, t1)), min=1e-12)
    t1 = _scale3(t1, 1.0 / t1n)
    return (n_c, t1, _cross(n_c, t1))


def _segseg(gpos, zax, h1, gpos2, zax2, h2):
    """Closest points (c1, c2) between the axes of two capsules, in the
    JAX emitter's order of operations (``megastep.py:1596-1630``)."""
    a0 = _sub3(gpos, _scale3(zax, h1))
    d1 = _scale3(zax, 2.0 * h1)
    b0 = _sub3(gpos2, _scale3(zax2, h2))
    d2 = _scale3(zax2, 2.0 * h2)
    r_ = _sub3(a0, b0)
    a_q, e_q = _dot3(d1, d1), _dot3(d2, d2)
    f_q, c_q, b_q = _dot3(d2, r_), _dot3(d1, r_), _dot3(d1, d2)
    denom = a_q * e_q - b_q * b_q
    s_p = torch.where(
        denom > 1e-12,
        torch.clamp((b_q * f_q - c_q * e_q) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
        0.0,
    )
    t_p = torch.where(e_q > 1e-12, (b_q * s_p + f_q) / torch.clamp(e_q, min=1e-12), 0.0)
    t_p = torch.clamp(t_p, 0.0, 1.0)
    s_p = torch.where(
        a_q > 1e-12, torch.clamp((b_q * t_p - c_q) / torch.clamp(a_q, min=1e-12), 0.0, 1.0), 0.0
    )
    return _add3(a0, _scale3(d1, s_p)), _add3(b0, _scale3(d2, t_p))


def _where_eq(w, j: int, val: float):
    """``val`` where the winner ``w`` is member ``j``, else 0."""
    return torch.where(w == float(j), val, 0.0)


def _select(w, vals):
    """The winner's value of per-member ``vals``: a sum of one-hot terms, as
    the JAX ``_wmask_from_widx._sel`` (``megastep.py:1031-1036``)."""
    acc = None
    for j, val in enumerate(vals):
        t = _where_eq(w, j, float(val))
        acc = t if acc is None else acc + t
    return acc


def _run_mask(w, runs):
    """1 where the winner ``w`` lies in one of the member-index ``runs``,
    else 0 (the JAX ``_wmask_from_widx._mask``)."""
    acc = None
    for lo, hi in runs:
        t = _where_eq(w, lo, 1.0) if lo == hi else torch.where(
            (w >= float(lo)) & (w <= float(hi)), 1.0, 0.0)
        acc = t if acc is None else acc + t
    return acc


def _cand_geom(st, cidx, xpos, xquat, ref, z, geom_cache, terrain, widx):
    """Contact geometry and constraint-dynamics scalars of candidate
    ``cidx``. A ground row is a capsule end against the flat plane, whose
    contact frame is the world's axes (n = z, t1 = x, t2 = y; ``frame``
    None), or against its local terrain plane, with the frame built from the
    plane's normal. A pair row (``cidx >= st.ng_rows``) is capsule against
    capsule: the closest points of the two axes, the normal from geom2
    toward geom1 (+z where the axes meet) and its frame; its path holds both
    bodies' DoFs with their signs. On a compressed row geom2 is the group's
    winner: its world frame is the sum of the members' frames times the
    winner's one-hot, its r2, h2 and inverse weight are the winner's, and
    the signs on the members' DoF union are -1 where every member moves
    the DoF and minus the winner's run mask elsewhere (the JAX ``_cand_geom``,
    ``megastep.py:1561-1589``)."""

    def geom_world_frame(gi):
        if gi in geom_cache:
            return geom_cache[gi]
        b_ = int(st.geom_body[gi])
        gp = st.geom_pos[gi]
        if max(abs(float(x)) for x in gp) < _C_EPS:
            gpos = xpos[b_]
        else:
            gpos = _add3(xpos[b_], _qrot_c(xquat[b_], gp, z))
        gquat = _qmul_c(xquat[b_], st.geom_quat[gi], z)
        out = geom_cache[gi] = (b_, gpos, _qrot_c(gquat, (0.0, 0.0, 1.0), z))
        return out

    gi = int(st.can_geom[cidx])
    _b, gpos, zax = geom_world_frame(gi)
    radius = float(st.geom_size[gi, 0])
    halflen = float(st.geom_size[gi, 1])
    signs = st.cand_signs[cidx]
    invweight = float(st.can_invweight[cidx, 0])
    if cidx >= st.ng_rows:
        if st.pair_comp_groups:
            grp = st.pair_comp_groups[cidx - st.ng_rows]
            w = widx[cidx - st.ng_rows]
            gpos2, zax2 = (z, z, z), (z, z, z)
            for j, (gi2_j, _b2_j) in enumerate(grp["members"]):
                _bj, pj, zj = geom_world_frame(gi2_j)
                e = _where_eq(w, j, 1.0)
                gpos2 = _add3(gpos2, _scale3(pj, e))
                zax2 = _add3(zax2, _scale3(zj, e))
            r2, h2, invweight = _select(w, grp["r2"]), _select(w, grp["h2"]), _select(w, grp["invw"])
            masks = [_run_mask(w, runs) for runs in grp["listed"]]
            signs = [sg if isinstance(sg, float) else -masks[sg] for sg in signs]
        else:
            gi2 = int(st.can_geom2[cidx])
            _b2, gpos2, zax2 = geom_world_frame(gi2)
            r2, h2 = float(st.geom_size[gi2, 0]), float(st.geom_size[gi2, 1])
        c1, c2 = _segseg(gpos, zax, halflen, gpos2, zax2, h2)
        dvec = _sub3(c1, c2)
        dn = sqrt_rn(torch.clamp(_dot3(dvec, dvec), min=1e-18))
        ok = dn > 1e-9
        n_c = (torch.where(ok, dvec[0] / dn, 0.0), torch.where(ok, dvec[1] / dn, 0.0),
               torch.where(ok, dvec[2] / dn, 1.0))
        dist = dn - radius - r2
        cpos = _sub3(c1, _scale3(n_c, radius + 0.5 * dist))
        frame = _frame(n_c, z)
    elif terrain is None:
        ep = _add3(gpos, _scale3(zax, float(st.can_end[cidx]) * halflen))
        dist = ep[2] - st.ground_z - radius
        cpos = (ep[0], ep[1], ep[2] - (radius + 0.5 * dist))
        frame = None
    else:
        ep = _add3(gpos, _scale3(zax, float(st.can_end[cidx]) * halflen))
        h_c, nx_c, ny_c, nz_c = terrain[cidx]
        n_c = (nx_c, ny_c, nz_c)
        dist = (ep[2] - h_c) * nz_c - radius
        cpos = _sub3(ep, _scale3(n_c, radius + 0.5 * dist))
        frame = _frame(n_c, z)
    margin = float(st.can_margin[cidx])
    active = dist < margin

    # solref / solimp constraint dynamics.
    dmin, dmax, width, mid, power = (float(x) for x in st.can_solimp[cidx])
    pos_err = torch.clamp(dist - margin, max=0.0)
    x_ = torch.clamp(_div(torch.abs(pos_err), max(width, 1e-12)), 0.0, 1.0)
    a_c = 1.0 / mid ** (power - 1.0)
    b_c = 1.0 / (1.0 - mid) ** (power - 1.0)
    y_ = torch.where(x_ < mid, a_c * powf(x_, power), 1.0 - b_c * powf(1.0 - x_, power))
    imp = torch.clamp(dmin + y_ * (dmax - dmin), 1e-4, 0.9999)
    tc, dr = float(st.can_solref[cidx][0]), float(st.can_solref[cidx][1])
    return dict(
        path=st.cand_paths[cidx],
        signs=signs,
        cpos=cpos,
        rel=_sub3(cpos, ref),
        active=active,
        imp=imp,
        pos_err=pos_err,
        b_gain=2.0 / (dmax * tc),
        k_gain=1.0 / (dmax * dmax * tc * tc * dr * dr),
        mu=tuple(float(x) for x in st.can_friction[cidx]),
        invweight=invweight,
        frame=frame,
    )


def _friction_tags(condim: int) -> list:
    """The friction directions of a contact's pyramid rows by condim (the
    JAX emitter's tags, ``megastep.py:1798-1810``): none at condim 1, the
    tangents t1 and t2 at condim 3, then the torsion about the normal (rn)
    at condim 4 and the rolling about the tangents (rt1, rt2) at condim 6.
    The rows are [n] at condim 1, else [(tag, +1), (tag, -1) for each tag]."""
    return {1: [], 3: ["t1", "t2"], 4: ["t1", "t2", "rn"],
            6: ["t1", "t2", "rn", "rt1", "rt2"]}[condim]


def _mu_of(mu: tuple, tag: str) -> float:
    """A tag's friction coefficient from a candidate's (sliding, torsional,
    rolling) ``mu``."""
    return mu[0] if tag in ("t1", "t2") else (mu[1] if tag == "rn" else mu[2])


def _contacts(st, v, c_clamped, warm, xpos, xquat, S, ref, Mh, qfrc, z, terrain, widx):
    """Candidate rows, tree LDLᵀ and primal Newton with the bisection line
    search, on the frozen Hessian or, with ``solver_exact``, re-factored at
    every iteration (the JAX ``_contacts_impl``, fused), at condim 1, 3, 4
    or 6. A world without candidates solves Mh qacc = qfrc through the tree
    factor alone (``megastep.py:1785-1788``)."""
    nv = st.nv
    if st.ncand == 0:
        L, dvec = _tree_ldl(st, Mh)
        return _tree_solve(st, L, dvec, qfrc), []
    geom_cache = {}
    cons = [_cand_geom(st, c, xpos, xquat, ref, z, geom_cache, terrain, widx)
            for c in range(st.ncand)]
    tags = _friction_tags(st.condim)

    for c in cons:
        iw = c["invweight"]
        iw = max(iw, 1e-12) if isinstance(iw, float) else torch.clamp(iw, min=1e-12)
        R_ = (1.0 - c["imp"]) / c["imp"] * iw
        c["D"] = torch.where(c["active"], 1.0 / torch.clamp(R_, min=1e-12), 0.0)

    # ---- adhesion split over the active candidates of each actuator ----
    qfrc = list(qfrc)
    for u, group in st.adh_groups.items():
        total = float(st.act_gain[u]) * c_clamped[u]
        count = z
        for ci in group:
            count = count + torch.where(cons[ci]["active"], 1.0, 0.0)
        per = total / torch.clamp(count, min=1.0)
        for ci in group:
            cons[ci]["adh_force"] = torch.where(cons[ci]["active"], per, 0.0)
    for c in cons:
        c.setdefault("adh_force", z)

    def dof_components(c):
        """Jacobian direction components along the path: jp_d = sgn_d (S_v[d]
        + S_w[d] × rel) in the contact frame, sgn_d = ±1 the DoF's sign
        (exact negation, as the JAX ``pick_signed`` and ``_scale3``), or on
        a compressed row a lane value (-1 or -0), multiplied in. The flat
        frame (n = z, t1 = x, t2 = y) picks components, and the free
        joint's translation columns fold to Python floats 0/±1; a contact
        frame dots jp into n, t1, t2, and a translation column picks the
        frame vectors' components. Above condim 3 the rotational
        components (rn, rt1, rt2) take sgn_d S_w[d] the same way: 0 on the
        free joint's translation columns, its rotation axis e_j (a Python
        float in the flat frame) on its rotation columns."""
        rel = c["rel"]
        frame = c["frame"]
        comps = {t: [] for t in ["n"] + tags}

        def put(n_val, t1_val, t2_val, rn_val, rt1_val, rt2_val):
            # The rotational entries are thunks, made only where condim > 3
            # reads them.
            comps["n"].append(n_val)
            for t, val in (("t1", t1_val), ("t2", t2_val), ("rn", rn_val), ("rt1", rt1_val),
                           ("rt2", rt2_val)):
                if t in comps:
                    comps[t].append(val() if callable(val) else val)

        def pick_signed(vec3, idx, sgn):
            x = vec3[idx]
            if isinstance(sgn, torch.Tensor):
                return x * sgn
            return x if sgn == 1.0 else (-x if sgn == -1.0 else x * sgn)

        for d, sgn in zip(c["path"], c["signs"]):
            lane = isinstance(sgn, torch.Tensor)
            fa = st.free_dof_axis.get(d)
            if fa is not None and fa < 3:
                if frame is None:
                    e = [0.0, 0.0, 0.0]
                    e[fa] = sgn
                    put(e[2], e[0], e[1], 0.0, 0.0, 0.0)
                else:
                    n_c, t1, t2 = frame
                    put(pick_signed(n_c, fa, sgn), lambda: pick_signed(t1, fa, sgn),
                        lambda: pick_signed(t2, fa, sgn), 0.0, 0.0, 0.0)
                continue
            if fa is not None:
                j = fa - 3
                ec = [0.0, 0.0, 0.0]
                ec[j] = 1.0
                jp = _add3(S[d][1], _cross_cl(ec, rel, z))
                if lane or sgn != 1.0:
                    jp = _scale3(jp, sgn)
                if frame is None:
                    sj = float(sgn)
                    put(jp[2], jp[0], jp[1], sj if j == 2 else 0.0, sj if j == 0 else 0.0,
                        sj if j == 1 else 0.0)
                else:
                    n_c, t1, t2 = frame
                    put(_dot3(jp, n_c), lambda: _dot3(jp, t1), lambda: _dot3(jp, t2),
                        lambda: pick_signed(n_c, j, sgn), lambda: pick_signed(t1, j, sgn),
                        lambda: pick_signed(t2, j, sgn))
                continue
            w_, v_ = S[d]
            jp = _add3(v_, _cross(w_, rel))
            if lane or sgn != 1.0:
                jp = _scale3(jp, sgn)
                if st.condim > 3:
                    w_ = _scale3(w_, sgn)
            if frame is None:
                put(jp[2], jp[0], jp[1], w_[2], w_[0], w_[1])
            else:
                n_c, t1, t2 = frame
                put(_dot3(jp, n_c), lambda: _dot3(jp, t1), lambda: _dot3(jp, t2),
                    lambda: _dot3(w_, n_c), lambda: _dot3(w_, t1), lambda: _dot3(w_, t2))
        return comps

    def products(c, comps, vec):
        out = {}
        for t, col in comps.items():
            s_ = None
            for i, d in enumerate(c["path"]):
                s_ = _acc(s_, _mul_cf(col[i], vec[d]))
            out[t] = z if s_ is None else s_
        return out

    def row_combos(c, p):
        if st.condim == 1:
            return [p["n"]]
        out = []
        for t in tags:
            mu = _mu_of(c["mu"], t)
            out.append(p["n"] + mu * p[t])
            out.append(p["n"] - mu * p[t])
        return out

    def jar_grad_pass(c, a_vec, grad_con, with_hessian=None, with_aref=False,
                      use_cached_jar=False):
        comps = c.get("comps")
        if comps is None:
            comps = c["comps"] = dof_components(c)
        if with_aref:
            vel_rows = row_combos(c, products(c, comps, v))
            krow = c["k_gain"]
            c["aref"] = [
                -c["b_gain"] * vel - krow * c["imp"] * c["pos_err"] for vel in vel_rows
            ]
            # Adhesion as an applied generalised force along the normal rows.
            adh = c["adh_force"]
            for i, d in enumerate(c["path"]):
                term = _mul_cf(comps["n"][i], adh)
                if term is not None:
                    qfrc[d] = qfrc[d] - term
        if use_cached_jar:
            jars = c["jar_cur"]
        else:
            jrows = row_combos(c, products(c, comps, a_vec))
            jars = [jr - ar for jr, ar in zip(jrows, c["aref"])]
            c["jar_cur"] = jars
        D_ = c["D"]
        wk = [D_ * torch.where(jr < 0.0, 1.0, 0.0) * jr for jr in jars]
        if st.condim == 1:
            coef = {"n": wk[0]}
        else:
            coef_n = z
            for w_ in wk:
                coef_n = coef_n + w_
            coef = {"n": coef_n}
            for ti, t in enumerate(tags):
                coef[t] = _mu_of(c["mu"], t) * (wk[2 * ti] - wk[2 * ti + 1])
        for i, d in enumerate(c["path"]):
            g = None
            for t, cf in coef.items():
                g = _acc(g, _mul_cf(comps[t][i], cf))
            if g is not None:
                grad_con[d] = grad_con[d] + g
        if with_hessian is not None:
            H = with_hessian
            wa = [D_ * torch.where(jr < 0.0, 1.0, 0.0) for jr in jars]
            Bt, Wt = {}, {}
            if st.condim == 1:
                W = wa[0]
            else:
                W = z
                for w_ in wa:
                    W = W + w_
                for ti, t in enumerate(tags):
                    mu = _mu_of(c["mu"], t)
                    Bt[t] = mu * (wa[2 * ti] - wa[2 * ti + 1])
                    Wt[t] = mu * mu * (wa[2 * ti] + wa[2 * ti + 1])
            path = c["path"]
            npath = len(path)
            u_of = {t: [None] * npath for t in ["n"] + tags}
            for j_ in range(npath):
                nj = comps["n"][j_]
                un = _mul_cf(nj, W)
                for t in tags:
                    dj = comps[t][j_]
                    un = _acc(un, _mul_cf(dj, Bt[t]))
                    u_of[t][j_] = _acc(_mul_cf(nj, Bt[t]), _mul_cf(dj, Wt[t]))
                u_of["n"][j_] = un
            for i_ in range(npath):
                for j_ in range(i_, npath):
                    k = _hkey(st, path[i_], path[j_])
                    if k is None:  # cross-tree fill-in: dropped
                        continue
                    val = _mul_cf(comps["n"][i_], u_of["n"][j_])
                    for t in tags:
                        val = _acc(val, _mul_cf(comps[t][i_], u_of[t][j_]))
                    if val is None:
                        continue
                    H[k] = H[k] + val

    def Mh_mul(a_vec):
        out = [None] * nv
        for d in range(nv):
            out[d] = Mh[(d, d)] * a_vec[d]
        for a_, b_ in st.pair_keys:
            if a_ == b_:
                continue
            val = Mh[(a_, b_)]
            out[b_] = out[b_] + val * a_vec[a_]
            out[a_] = out[a_] + val * a_vec[b_]
        return out

    # ---- first pass: aref, adhesion, jars and gradient at warm, Hessian ----
    a_vec = list(warm)
    H = dict(Mh)
    grad_con = [z] * nv
    for c in cons:
        jar_grad_pass(c, a_vec, grad_con, with_hessian=H, with_aref=True)
    for d in range(nv):
        H[(d, d)] = H[(d, d)] + 1e-9
    Ld, dd = _tree_ldl(st, H)

    # ---- Newton iterations: on the frozen Hessian, or (solver_exact) on
    # the Hessian re-filled from the current active set and re-factored ----
    Ma = Mh_mul(a_vec)
    for it in range(max(st.solver_iterations, 1)):
        if it > 0:
            grad_con = [z] * nv
            if st.solver_exact:
                H = dict(Mh)
                for c in cons:
                    jar_grad_pass(c, a_vec, grad_con, with_hessian=H, use_cached_jar=True)
                for d in range(nv):
                    H[(d, d)] = H[(d, d)] + 1e-9
                Ld, dd = _tree_ldl(st, H)
            else:
                for c in cons:
                    jar_grad_pass(c, a_vec, grad_con, use_cached_jar=True)
        grad = [Ma[d] - qfrc[d] + grad_con[d] for d in range(nv)]
        delta = [-x for x in _tree_solve(st, Ld, dd, grad)]

        Md = Mh_mul(delta)
        dMd = z
        gMd = z
        for d in range(nv):
            dMd = dMd + delta[d] * Md[d]
            gMd = gMd + a_vec[d] * Md[d] - qfrc[d] * delta[d]
        for c in cons:
            c["jd_cur"] = row_combos(c, products(c, c["comps"], delta))
            c["djd_cur"] = [c["D"] * jd for jd in c["jd_cur"]]

        # Bisection line search with a final regula falsi (the engine's
        # _exact_linesearch): only the sign of φ' feeds back, so 1-ulp
        # differences do not move the iterate.
        def _dphi(alpha, at_zero=False):
            d_ = gMd if at_zero else gMd + alpha * dMd
            for c in cons:
                for jr, jd, t_ in zip(c["jar_cur"], c["jd_cur"], c["djd_cur"]):
                    ja = jr if at_zero else jr + alpha * jd
                    m_ = torch.where(ja < 0.0, 1.0, 0.0)
                    d_ = d_ + m_ * t_ * ja
            return d_

        dlo = _dphi(z, at_zero=True)
        d0 = dlo
        dhi = _dphi(z + _LS_ALPHA_MAX)
        lo = z
        hi = z + _LS_ALPHA_MAX
        for _k in range(_LS_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            d_ = _dphi(mid)
            neg = d_ < 0.0
            lo = torch.where(neg, mid, lo)
            dlo = torch.where(neg, d_, dlo)
            hi = torch.where(neg, hi, mid)
            dhi = torch.where(neg, dhi, d_)
        t_ = -dlo / torch.clamp(dhi - dlo, min=1e-12)
        alpha_sel = lo + torch.clamp(t_, 0.0, 1.0) * (hi - lo)
        alpha_sel = torch.where(d0 < 0.0, alpha_sel, 0.0)
        a_vec = [a_vec[d] + alpha_sel * delta[d] for d in range(nv)]
        Ma = [Ma[d] + alpha_sel * Md[d] for d in range(nv)]
        for c in cons:
            c["jar_cur"] = [jr + alpha_sel * jd for jr, jd in zip(c["jar_cur"], c["jd_cur"])]

    # ---- final jars → row forces → contact-frame and world forces ----
    for c in cons:
        D_ = c["D"]
        lam_c = [
            torch.clamp(-D_ * torch.where(jr < 0.0, 1.0, 0.0) * jr, min=0.0)
            for jr in c["jar_cur"]
        ]
        fn = z
        for l_ in lam_c:
            fn = fn + l_
        if st.condim >= 3:
            ft1 = c["mu"][0] * (lam_c[0] - lam_c[1])
            ft2 = c["mu"][0] * (lam_c[2] - lam_c[3])
        else:
            ft1 = ft2 = z
        act_m = torch.where(c["active"], 1.0, 0.0)
        c["f_frame"] = (fn * act_m, ft1 * act_m, ft2 * act_m)
        if c["frame"] is None:
            c["f_world"] = (ft1 * act_m, ft2 * act_m, fn * act_m)
        else:
            n_f, t1_f, t2_f = c["frame"]
            c["f_world"] = tuple(
                (fn * n_f[i] + ft1 * t1_f[i] + ft2 * t2_f[i]) * act_m for i in range(3)
            )
    return a_vec, cons


def _hkey(st, a_, b_):
    """The tree-sparse key of the Hessian entry (a_, b_), or None where
    neither DoF is an ancestor of the other (the JAX ``key``,
    ``megastep.py:1774-1783``)."""
    if a_ == b_ or a_ in st.dof_chains[b_]:
        return (a_, b_)
    if b_ in st.dof_chains[a_]:
        return (b_, a_)
    return None


def _tree_ldl(st, A):
    """Tree-sparse LDLᵀ of the dict matrix A → (L dict, list of diagonals)."""
    A = dict(A)

    def key(a_, b_):
        if a_ == b_:
            return (a_, b_)
        return (a_, b_) if a_ in st.dof_chains[b_] else (b_, a_)

    L = {}
    dvec = [None] * st.nv
    for i in st.elim_order:
        chain = st.dof_chains[i]
        di = A[(i, i)]
        dvec[i] = di
        inv = 1.0 / di
        lis = {}
        for a_ in chain:
            lis[a_] = A[key(a_, i)] * inv
            L[(a_, i)] = lis[a_]
        for ia, a_ in enumerate(chain):
            ra = A[key(a_, i)]
            for b_ in chain[ia:]:
                k = key(a_, b_)
                A[k] = A[k] - lis[b_] * ra
    return L, dvec


def _tree_solve(st, L, dvec, b):
    """Solve with the tree factor: leaves→root, the diagonal, root→leaves."""
    y = list(b)
    for i in st.elim_order:
        yi = y[i]
        for a_ in st.dof_chains[i]:
            y[a_] = y[a_] - L[(a_, i)] * yi
    for i in range(st.nv):
        y[i] = y[i] / dvec[i]
    for i in reversed(st.elim_order):
        acc = y[i]
        for a_ in st.dof_chains[i]:
            acc = acc - L[(a_, i)] * y[a_]
        y[i] = acc
    return y


def _emit_sensors(st, cons, z, one):
    """Per-leg 16-value net-force sensors; on terrain the sensor frame is
    the weighted mean normal and the re-orthogonalised mean tangent."""
    out = []
    for s in range(st.nsensor):
        group = [cons[c] for c in st.sensor_groups[s]]
        if not group:
            out.append([z] * 16)
            continue
        w = [torch.where(c["active"], 1.0, 0.0) for c in group]
        count = z
        for w_ in w:
            count = count + w_
        found = torch.where(count > 0, 1.0, 0.0)
        ff = [z, z, z]
        for c, w_ in zip(group, w):
            for i in range(3):
                ff[i] = ff[i] + c["f_frame"][i] * w_
        fmag_sum = z
        posw = [z, z, z]
        posp = [z, z, z]
        for c, w_ in zip(group, w):
            fm = torch.abs(c["f_frame"][0]) * w_
            fmag_sum = fmag_sum + fm
            for i in range(3):
                posw[i] = posw[i] + c["cpos"][i] * fm
                posp[i] = posp[i] + c["cpos"][i] * w_
        pos = [
            torch.where(
                fmag_sum > 1e-12,
                posw[i] / torch.clamp(fmag_sum, min=1e-12),
                posp[i] / torch.clamp(count, min=1.0),
            )
            for i in range(3)
        ]
        if group[0]["frame"] is None:
            normal = (z, z, one)
            tangent = (one, z, z)
        else:
            n_sum = [z, z, z]
            t_sum = [z, z, z]
            for c, w_ in zip(group, w):
                n_f, t1_f, _ = c["frame"]
                for i in range(3):
                    n_sum[i] = n_sum[i] + n_f[i] * w_
                    t_sum[i] = t_sum[i] + t1_f[i] * w_
            nn = sqrt_rn(_dot3(n_sum, n_sum))
            normal = tuple(
                torch.where(nn > 1e-9, n_sum[i] / torch.clamp(nn, min=1e-12),
                            1.0 if i == 2 else 0.0)
                for i in range(3)
            )
            tdn = _dot3(t_sum, normal)
            t_sum = [t_sum[i] - tdn * normal[i] for i in range(3)]
            tn = sqrt_rn(_dot3(t_sum, t_sum))
            tangent = tuple(
                torch.where(tn > 1e-9, t_sum[i] / torch.clamp(tn, min=1e-12),
                            1.0 if i == 0 else 0.0)
                for i in range(3)
            )
        t2 = _cross(normal, tangent)
        tw = [z, z, z]
        for c, w_ in zip(group, w):
            tq = _cross(_sub3(c["cpos"], tuple(pos)), c["f_world"])
            for i in range(3):
                tw[i] = tw[i] + tq[i] * w_
        torque = (_dot3(tuple(tw), normal), _dot3(tuple(tw), tangent), _dot3(tuple(tw), t2))
        out.append([found] + ff + list(torque) + pos + list(normal) + list(tangent))
    return out


# ---------------------------------------------------------------------------
# Packing: State <-> the kernel's world-minor rows
# ---------------------------------------------------------------------------


def _io_rows(st: _Static, k_steps: int) -> tuple:
    """(n_in, n_out) rows of the kernel's input and output at K steps:
    in = qpos, qvel, K ctrl slices, act, qacc, then on a heightfield world
    the 4 plane rows [h, nx, ny, nz] of each candidate, or with compressed
    pair rows one winner row per group; out = (K-1) qpos rows, then qpos,
    qvel, act, qacc, xpos, xquat, site_xpos, actuator_force, sensors."""
    n_in = st.nq + st.nv + k_steps * st.nu + st.na + st.nv + _n_aux(st)
    n_out = (
        (k_steps - 1) * st.nq + st.nq + 2 * st.nv + st.na
        + 7 * st.nbody + 3 * st.nsite + st.nu + 16 * st.nsensor
    )
    return n_in, n_out


def _n_aux(st: _Static) -> int:
    """Input rows sampled outside the kernel: the planes of a heightfield
    world (JAX ``megastep.py:2457``) or the winners of the compressed pair
    groups, one row each (the JAX kernel expands them into mask rows)."""
    return 4 * st.ncand if st.has_hfield else len(st.pair_comp_groups)


def _aux_shape(st: _Static, B: int) -> tuple:
    """The shape of ``terrain_planes``: (B, ncand, 4) planes or (B,
    n_groups) winners."""
    return (B, st.ncand, 4) if st.has_hfield else (B, len(st.pair_comp_groups))


def _check_winners(st: _Static, widx: torch.Tensor) -> None:
    """Refuse winners outside [0, group size) or not whole (reads the
    tensor on the host)."""
    sizes = torch.tensor([len(g["members"]) for g in st.pair_comp_groups], device=widx.device)
    bad = (widx < 0) | (widx >= sizes) | (widx != torch.floor(widx))
    if bool(bad.any()):
        raise ValueError("pair winners must be whole member indices in [0, group size)")


def _unpack(st: _Static, out: torch.Tensor, state: State, ctrl, k_steps: int):
    """The kernel's (n_out, B) rows → (new State, (K, B, nq) qpos rows)."""
    B = out.shape[1]
    o = 0

    def take(n, shape):
        nonlocal o
        r = out[o : o + n].t().reshape((B,) + shape)
        o += n
        return r

    traj = take((k_steps - 1) * st.nq, (k_steps - 1, st.nq))
    qpos = take(st.nq, (st.nq,))
    new = State(
        qpos=qpos,
        qvel=take(st.nv, (st.nv,)),
        ctrl=ctrl,
        act=take(st.na, (st.na,)),
        time=state.time + k_steps * st.timestep,
        qacc=take(st.nv, (st.nv,)),
        xpos=take(3 * st.nbody, (st.nbody, 3)),
        xquat=take(4 * st.nbody, (st.nbody, 4)),
        site_xpos=take(3 * st.nsite, (st.nsite, 3)),
        actuator_force=take(st.nu, (st.nu,)),
        contact_sensordata=take(16 * st.nsensor, (st.nsensor, 16)),
    )
    return new, torch.cat([traj.transpose(0, 1), qpos[None]], dim=0)


def megastep_plain(st: _Static, state: State, ctrl_seq: torch.Tensor | None = None,
                   terrain_planes: torch.Tensor | None = None):
    """K chained plain steps (the plain version of K2).

    Args:
        ctrl_seq: (K, B, nu) controls of the K steps, NaN-free; None is one
            step with ``state.ctrl``.
        terrain_planes: What the K steps read from outside the kernel:
            (B, ncand, 4) ground planes [h, nx, ny, nz] on a heightfield
            world, (B, n_groups) group-local winners on a world with
            compressed pair rows; None otherwise.

    Returns:
        The new State for one step; ``(state, (K, B, nq) qpos rows)`` with a
        ``ctrl_seq``.
    """
    cols = lambda x: [x[:, i] for i in range(x.shape[1])]
    if (_n_aux(st) > 0) != (terrain_planes is not None):
        raise ValueError("planes or winners are needed on a heightfield world or one with "
                         "compressed pair rows, and only there")
    terrain = widx = None
    if st.has_hfield:
        terrain = [tuple(terrain_planes[:, c, k] for k in range(4)) for c in range(st.ncand)]
    elif terrain_planes is not None:
        _check_winners(st, terrain_planes)
        widx = cols(terrain_planes.float())
    q, v, act, warm = cols(state.qpos), cols(state.qvel), cols(state.act), cols(state.qacc)
    ctrls = [state.ctrl] if ctrl_seq is None else list(ctrl_seq)
    traj = []
    for ctrl in ctrls:
        r = emit_step(st, q, v, cols(ctrl), act, warm, terrain, widx)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        traj.append(torch.stack(q, dim=1))
    B = state.qpos.shape[0]
    stack = lambda lst: torch.stack(lst, dim=1) if lst else state.qpos.new_zeros((B, 0))
    rows = lambda vecs, width: (
        torch.stack([torch.stack(list(p), dim=1) for p in vecs], dim=1)
        if vecs else state.qpos.new_zeros((B, 0, width))
    )
    new = State(
        qpos=traj[-1],
        qvel=stack(r["qvel"]),
        ctrl=ctrls[-1],
        act=stack(r["act"]),
        time=state.time + len(ctrls) * st.timestep,
        qacc=stack(r["qacc"]),
        xpos=rows(r["xpos"], 3),
        xquat=rows(r["xquat"], 4),
        site_xpos=rows(r["site_xpos"], 3),
        actuator_force=stack(r["actuator_force"]),
        contact_sensordata=rows(r["sensordata"], 16),
    )
    if ctrl_seq is None:
        return new
    return new, torch.stack(traj)


# ---------------------------------------------------------------------------
# The kernel's generated header and its wrapper
# ---------------------------------------------------------------------------


def _f32(x) -> str:
    """A float as a C literal that rounds to the same float32."""
    v = float(np.float32(x))
    if v != v or v in (float("inf"), float("-inf")):
        raise ValueError(f"non-finite model constant {x}")
    return repr(v) + "f" if "e" in repr(v) or "." in repr(v) else repr(v) + ".0f"


def _fold(vec) -> list:
    """Constants as the emitter folds them: |x| < 1e-12 is an exact 0."""
    return [0.0 if abs(float(x)) < _C_EPS else float(x) for x in vec]


def _fold_quat(c) -> list:
    return [1.0, 0.0, 0.0, 0.0] if _is_ident_quat(c) else _fold(c)


# Shared memory a block of K2 may use (the H100's 227 KB), and what the SM
# holds for all its blocks (228 KB, 1 KB of it reserved per block).
SHARED_LIMIT = 232448
_SM_SHARED = 233472
_BLOCK_RESERVED = 1024


# K2's threads per block (one world per block): the fastest of 32, 64 and
# 128 on the flat header's K = 8 launch at 4096 worlds (chip_smoke.py phase
# 3; PERF.md §6 has the sweep). The multi-fly headers take it unmeasured.
THREADS = 128


def _blocks_per_sm(n_shared_bytes: int) -> int:
    return _SM_SHARED // (n_shared_bytes + _BLOCK_RESERVED)


def scratch_layout(model: PhysicsModel, threads: int | None = None) -> dict:
    """K2's scratch rows of one world and where they live.

    The rows come in slots, ordered by how often a step reads them: the
    Newton loop's candidate rows, then a slot shared by the body arrays of
    the dynamics (dead once the candidates are built) and the Newton loop's
    coefficient and line-search rows (live only after), then the Hessian,
    Mh, the DoF vectors, the motion subspace, the poses and the rest. A slot
    with two sides holds both in the same rows. The block's dynamic shared
    memory takes whole slots from the first while they fit in
    ``SHARED_LIMIT``, and leaves the last, coldest slot out where that lets
    more blocks share an SM; the rest live in a world-major global buffer.

    Returns:
        dict with ``slots`` (list of (offset, size, sides), each side a list
        of (name, offset, size)), ``n_scratch``, ``n_shared``, ``n_global``
        (floats per world), ``threads`` and ``blocks_per_sm`` (as shared
        memory allows).
    """
    st = _Static(model)
    nb, nv, nc = st.nbody, st.nv, st.ncand
    maxp = _max_path(st)
    npk = len(st.pair_keys)
    ntag, nrows = len(_friction_tags(st.condim)), n_pyramid_rows(st.condim)
    tail = [("S_CACT", nc), ("S_CADH", nc), ("S_CPOS", 3 * nc)]
    if st.has_hfield:
        tail.append(("S_FRAME", 9 * nc))
    elif st.ncand_pair:
        tail.append(("S_FRAME", 9 * st.ncand_pair))
    tail += [("S_AF", max(st.nu, 1)), ("S_CCL", max(st.nu, 1))]
    if st.pair_comp_groups:
        tail.append(("S_WIN", len(st.pair_comp_groups)))  # each group's winner, a member index
    slot_specs = [
        [[("S_JAR", nrows * nc), ("S_JD", nrows * nc), ("S_CD", nc), ("S_RED", 2)]],
        [[("S_TERM", _term_rows(st)), ("S_COEF", (2 + 3 * ntag) * nc)],
         [("S_CVEL", 6 * nb), ("S_CACC", 6 * nb), ("S_IB", 9 * nb), ("S_IC", 9 * nb),
          ("S_FSUB", 6 * nb), ("S_HCS", 2 * max(st.nhinge, 1))]],
        [[("S_COMP", (1 + ntag) * maxp * nc), ("S_H", npk), ("S_MH", npk)]],
        [[("S_QFRC", nv), ("S_MA", nv), ("S_GC", nv), ("S_DEL", nv), ("S_MD", nv), ("S_A", nv),
          ("S_V", nv), ("S_Q", st.nq), ("S_ACT", st.na), ("S_INV", nv)]],
        [[("S_SM", 6 * nv)]],
        [[("S_XPOS", 3 * nb), ("S_XQUAT", 4 * nb), ("S_HAX", 3 * max(st.nhinge, 1))]],
        [tail],
    ]
    slots, off = [], 0
    for sides in slot_specs:
        placed, size = [], 0
        for side in sides:
            o, rows = off, []
            for name, n in side:
                rows.append((name, o, n))
                o += n
            placed.append(rows)
            size = max(size, o - off)
        slots.append((off, size, placed))
        off += size
    n_shared = 0
    for o, size, _sides in slots:
        if 4 * (o + size) > SHARED_LIMIT:
            break
        n_shared = o + size
    # The last slot (written once per step and read by the sensors) goes to
    # global memory where that lets more blocks share an SM.
    cold = slots[-1][0]
    if _blocks_per_sm(4 * cold) > _blocks_per_sm(4 * n_shared):
        n_shared = cold
    threads = THREADS if threads is None else int(threads)
    if threads not in (32, 64, 128):
        raise ValueError(f"K2 runs 32, 64 or 128 threads per block, not {threads}")
    return dict(slots=slots, n_scratch=off, n_shared=n_shared, n_global=off - n_shared,
                threads=threads, blocks_per_sm=_blocks_per_sm(4 * n_shared))


def _max_path(st: _Static) -> int:
    cand_bodies = [int(st.geom_body[int(st.can_geom[c])]) for c in range(st.ncand)]
    paths = [st.body_path_dofs[b] for b in range(st.nbody)]
    if st.pair_comp_groups:
        # A compressed row walks geom1's path, then its winner's.
        return max([len(paths[b]) for b in cand_bodies[: st.ng_rows]] + [
            st.cand_split[st.ng_rows + g] + max(len(paths[b2]) for _g2, b2 in grp["members"])
            for g, grp in enumerate(st.pair_comp_groups)])
    return max((len(p) for p in st.cand_paths), default=0)


def _dof_candidates(st: _Static) -> list:
    """Per DoF d, the candidates whose path holds d, in candidate order, as
    (candidate, offset of d's part in the path): d is path entry offset +
    len(dof_chains[d]). Offset -1 is the second part of a compressed row,
    where d lies in one member's body path and the kernel checks the winner.
    The per-DoF and per-entry sums of K2 walk these lists, so that each sum
    adds its terms in the candidates' order, as the serial loop did."""
    lists = [[] for _ in range(st.nv)]
    for c in range(st.ncand):
        split = st.cand_split[c]
        if c >= st.ng_rows and st.pair_comp_groups:
            grp = st.pair_comp_groups[c - st.ng_rows]
            first = st.cand_paths[c][:split]
            for d in first:
                lists[d].append((c, 0))
            for d in sorted({d for _g2, b2 in grp["members"] for d in st.body_path_dofs[b2]}):
                lists[d].append((c, -1))
            entries = [(0, i, d) for i, d in enumerate(first)]
        else:
            path = st.cand_paths[c]
            entries = [(0 if i < split else split, i, d) for i, d in enumerate(path)]
            for off, _i, d in entries:
                lists[d].append((c, off))
        for off, i, d in entries:
            if i - off != len(st.dof_chains[d]):
                raise NotImplementedError(f"candidate {c}'s path is not a chain at DoF {d}")
    return lists


def _ldl_terms(st: _Static, pk_ptr: list, pk_row: list) -> tuple:
    """The tree factor's updates of each Hessian entry, (column i, entry b,
    entry a) in elimination order, and the forward solve's terms of each
    DoF, (entry, DoF i) in elimination order."""
    upd = [[] for _ in range(len(pk_row))]
    fwd = [[] for _ in range(st.nv)]
    for i in st.elim_order:
        base, n = pk_ptr[i], pk_ptr[i + 1] - pk_ptr[i] - 1
        for ia in range(n):
            fwd[pk_row[base + ia]].append((base + ia, i))
            for ib in range(ia, n):
                upd[pk_ptr[pk_row[base + ib]] + ia].append((i, base + ib, base + ia))
    return upd, fwd


def _term_rows(st: _Static) -> int:
    """Rows of S_TERM: the line search's two buffers of NROWS NCAND terms, or
    the most terms of one depth group in the factor or a pass of the
    solve."""
    pk_ptr = np.cumsum([0] + [len(st.dof_path[d]) for d in range(st.nv)]).tolist()
    upd, fwd = _ldl_terms(st, pk_ptr, [a_ for a_, _d in st.pair_keys])
    depth = [len(st.dof_chains[d]) for d in range(st.nv)]
    most = 0
    for g in range(max(depth) + 1):
        dofs = [d for d in range(st.nv) if depth[d] == g]
        most = max(most, sum(len(fwd[d]) for d in dofs), g * len(dofs),
                   sum(len(upd[k]) for d in dofs for k in range(pk_ptr[d], pk_ptr[d + 1])))
    return max(2 * n_pyramid_rows(st.condim) * st.ncand, most)


def _deal(work: list, threads: int) -> list:
    """Items dealt to ``threads`` threads, the longest first to the least
    loaded, as positions t, t + threads, ... of thread t (-1 pads)."""
    load, lists = [0] * threads, [[] for _ in range(threads)]
    for item in sorted(range(len(work)), key=lambda i: (-work[i], i)):
        t = min(range(threads), key=lambda t: (load[t], t))
        load[t] += work[item]
        lists[t].append(item)
    rounds = max(len(x) for x in lists)
    return [lists[t][j] if j < len(lists[t]) else -1
            for j in range(rounds) for t in range(threads)]


def _pack16(lo: int, hi: int) -> int:
    """Two table values of the ordered walks in one int (one load a term):
    ``lo`` in the low 16 bits, ``hi`` above."""
    if not (0 <= lo < 1 << 16 and 0 <= hi < 1 << 15):
        raise NotImplementedError("the model's tables pass K2's 16-bit walk indices")
    return int(lo) | int(hi) << 16


def model_header(model: PhysicsModel, threads: int | None = None) -> tuple:
    """The model's part of K2: shape numbers, scratch layout and tables as a
    C++ header for ``csrc/megastep.cu``.

    Each constant is the float32 value the emitter's Python arithmetic gives
    it (products of Python floats are taken in double, then rounded), and the
    constant frames are folded as the emitter folds them, so that the
    kernel's dense arithmetic repeats the emitter's bit for bit up to
    summation order. The kernel spreads each world's loops over a block of
    ``threads`` (default ``THREADS``); the transposed tables (tree levels,
    each body's children, each DoF's candidates, the mh_mul terms of each
    output, the factor's and the solve's terms by depth group) let each sum
    keep the serial order of its terms.

    Returns:
        (header text, scratch floats per world).
    """
    if not megastep_supported(model):
        raise NotImplementedError("the mega-step kernel does not support this model")
    st = _Static(model)
    layout = scratch_layout(model, threads)
    dc = _dof_candidates(st)
    dt = st.timestep
    lines = [
        "// Generated by flygym_tpu_torch/ops/megastep.py:model_header. Do not edit.",
        "#pragma once",
    ]

    def const(name, value):
        lines.append(f"constexpr int {name} = {int(value)};")

    def table(name, ctype, values):
        values = list(values)
        if not values:
            values = [0]
        fmt = _f32 if ctype == "float" else (lambda x: str(int(x)))
        body = ", ".join(fmt(x) for x in values)
        lines.append(f"MS_TABLE {ctype} {name}[{len(values)}] = {{{body}}};")

    nb, nv = st.nbody, st.nv
    tags = _friction_tags(st.condim)
    cand_bodies = [int(st.geom_body[int(st.can_geom[c])]) for c in range(st.ncand)]
    paths = [st.body_path_dofs[b] for b in range(nb)]
    comp = st.pair_comp_groups
    adh = list(st.adh_groups.items())
    depth = {0: 0}
    for b in st.topo:
        depth[b] = depth[int(st.body_parent[b])] + 1
    n_level = max(depth.values())
    for name, value in (
        ("NQ", st.nq), ("NV", nv), ("NU", st.nu), ("NA", st.na), ("NBODY", nb),
        ("NTOPO", len(st.topo)), ("NHINGE", st.nhinge), ("NSITE", st.nsite),
        ("NCAND", st.ncand), ("NSENSOR", st.nsensor), ("NPK", len(st.pair_keys)),
        ("MAXP", _max_path(st)), ("NFREE", len(st.free_joints)), ("NADH", len(adh)),
        ("REF_BODY", st.ref_body), ("NEWTON_ITERS", max(st.solver_iterations, 1)),
        ("SOLVER_EXACT", st.solver_exact), ("LS_BISECT", _LS_BISECT_ITERS),
        ("NMUS", len(_MUSCLE_KEYS)), ("NLEVEL", n_level), ("THREADS", layout["threads"]),
        # The pyramid rows per candidate and their friction directions.
        ("NTAG", len(tags)), ("NROWS", n_pyramid_rows(st.condim)),
    ):
        const(name, value)
    lines.append(f"constexpr float kDt = {_f32(dt)};")
    lines.append(f"constexpr float kHalfDt = {_f32(0.5 * dt)};")
    lines.append(f"constexpr float kGroundZ = {_f32(st.ground_z)};")
    lines.append(f"constexpr float kAlphaMax = {_f32(_LS_ALPHA_MAX)};")
    if st.has_hfield:
        # Heightfield world: 4 plane rows per candidate follow the state
        # rows of the input, and 9 frame rows per candidate the scratch.
        lines.append("#define MS_HFIELD 1")
        const("N_AUX", _n_aux(st))
    if st.ncand_pair:
        # Fly-fly pair rows follow the NGROUND ground rows; each keeps its
        # contact frame in 9 scratch rows (unless the terrain rows do).
        lines.append("#define MS_PAIRS 1")
        const("NGROUND", st.ng_rows)
        const("NPAIR", st.ncand_pair)
    if comp:
        # Compressed pair rows: one per group, whose geom2 is the group's
        # winner, read from one input row per group after the state rows.
        lines.append("#define MS_PAIRS_COMPRESSED 1")
        const("N_AUX", _n_aux(st))

    # Scratch rows per world (scratch_layout): rows [0, N_SHARED) in the
    # block's shared memory, the rest world-major in global memory.
    for _o, _size, sides in layout["slots"]:
        for side in sides:
            for name, off, _n in side:
                const(name, off)
    const("N_SCRATCH", layout["n_scratch"])
    const("N_SHARED", layout["n_shared"])
    const("N_GLOBAL", layout["n_global"])

    # Bodies; the tree's levels (depth 1, 2, ...) and each body's children
    # in reverse topological order (the order the serial sums added them).
    free_of = {b: (qa, va) for b, qa, va in st.free_joints}
    table("kTopo", "int", st.topo)
    table("kParent", "int", st.body_parent)
    table("kFreeQ", "int", [free_of.get(b, (-1, -1))[0] for b in range(nb)])
    table("kFreeV", "int", [free_of.get(b, (-1, -1))[1] for b in range(nb)])
    table("kFreeBody", "int", [b for b, _qa, _va in st.free_joints])
    lptr, lbody = [0], []
    for lev in range(1, n_level + 1):
        lbody += [b for b in st.topo if depth[b] == lev]
        lptr.append(len(lbody))
    table("kLevelPtr", "int", lptr)
    table("kLevelBody", "int", lbody)
    children = {b: [] for b in range(nb)}
    for b in reversed(st.topo):
        p = int(st.body_parent[b])
        if p != 0:
            children[p].append(b)
    cptr, clist = [0], []
    for b in range(nb):
        clist += children[b]
        cptr.append(len(clist))
    table("kChildPtr", "int", cptr)
    table("kChild", "int", clist)
    table("kBodyQuat", "float", [x for b in range(nb) for x in _fold_quat(st.body_quat[b])])
    table("kBodyPos", "float", [x for b in range(nb) for x in _fold(st.body_pos[b])])
    table("kBodyIQuat", "float", [x for b in range(nb) for x in _fold_quat(st.body_iquat[b])])
    table("kBodyIPos", "float", [x for b in range(nb) for x in _fold(st.body_ipos[b])])
    table("kBodyInertia", "float", st.body_inertia.reshape(-1))
    table("kBodyMass", "float", st.body_mass)
    comp_mass = [float(m) for m in st.body_mass]  # Python sums, as the emitter's
    for b in reversed(st.topo):
        p = int(st.body_parent[b])
        if p != 0:
            comp_mass[p] = comp_mass[p] + comp_mass[b]
    table("kCompMass", "float", comp_mass)
    hptr, hlist, dptr, dlist = [0], [], [0], []
    for b in range(nb):
        hlist += st.body_hinges[b]
        hptr.append(len(hlist))
        dlist += st.body_dofs[b]
        dptr.append(len(dlist))
    table("kBodyHingePtr", "int", hptr)
    table("kBodyHinge", "int", hlist)
    table("kBodyDofPtr", "int", dptr)
    table("kBodyDof", "int", dlist)
    table("kGrav", "float", _fold(st.gravity))

    # Hinges and DoFs.
    table("kHingeAxis", "float", [x for h in range(st.nhinge) for x in _fold(st.hinge_axis[h])])
    table("kHingeQ", "int", st.hinge_qadr)
    table("kHingeV", "int", st.hinge_vadr)
    table("kHingeBody", "int", st.hinge_body)
    table("kHingeK", "float", st.hinge_stiffness)
    table("kHingeRef", "float", st.hinge_springref)
    dof_hinge = [-1] * nv
    for h in range(st.nhinge):
        dof_hinge[int(st.hinge_vadr[h])] = h
    table("kDofHinge", "int", dof_hinge)
    table("kDofBody", "int", st.dof_body)
    table("kDofNegDamp", "float", [-float(x) for x in st.dof_damping])
    table("kDofArm", "float", st.dof_armature)
    table("kDofDtDamp", "float", [dt * float(x) for x in st.dof_damping])
    pk_ptr = [0]
    for d in range(nv):
        pk_ptr.append(pk_ptr[-1] + len(st.dof_path[d]))
    pk_row = [a_ for a_, _d in st.pair_keys]
    table("kPkPtr", "int", pk_ptr)
    table("kPkRow", "int", pk_row)
    table("kPkCol", "int", [d for _a, d in st.pair_keys])
    # mh_mul's terms of each output DoF, in the order the serial loop (over
    # columns d, then d's ancestor entries) added them.
    mv = [[] for _ in range(nv)]
    for d in range(nv):
        for idx in range(pk_ptr[d], pk_ptr[d + 1] - 1):
            mv[d].append((idx, pk_row[idx]))
            mv[pk_row[idx]].append((idx, d))
    mptr = [0]
    for terms in mv:
        mptr.append(mptr[-1] + len(terms))
    table("kMvPtr", "int", mptr)
    table("kMvKX", "int", [_pack16(k, x) for terms in mv for k, x in terms])
    # The DoFs by depth (number of ancestors), shallowest first: the factor
    # and the forward solve take the groups deepest first, the backward
    # solve shallowest first, each DoF's values depending only on deeper
    # (shallower) groups. Per group its columns' Hessian entries.
    n_anc = [len(st.dof_chains[d]) for d in range(nv)]
    groups = [[d for d in range(nv) if n_anc[d] == g] for g in range(max(n_anc) + 1)]
    const("NDG", len(groups))
    table("kDgPtr", "int", np.cumsum([0] + [len(g) for g in groups]))
    table("kDgDof", "int", [d for g in groups for d in g])
    ge = [k for g in groups for d in g for k in range(pk_ptr[d], pk_ptr[d + 1])]
    table("kGePtr", "int", np.cumsum(
        [0] + [sum(pk_ptr[d + 1] - pk_ptr[d] for d in g) for g in groups]))
    table("kGe", "int", ge)
    # The factor's updates of each entry in the serial elimination's order
    # (leaves first, elim_order): entry -= (entry b * (1 / diagonal of
    # column i)) * entry a, from each eliminated column i below it; and the
    # forward solve's terms of each DoF a: y[a] -= (entry k) * y[i], i below
    # a, in elimination order. Both listed by position in kGe (kDgDof), so
    # that a depth group's terms are one run.
    upd, fwd = _ldl_terms(st, pk_ptr, pk_row)
    table("kLuPtr", "int", np.cumsum([0] + [len(upd[k]) for k in ge]))
    table("kLuCol", "int", [i for k in ge for i, _b, _a in upd[k]])
    table("kLuBA", "int", [_pack16(b, a) for k in ge for _i, b, a in upd[k]])
    dg_dof = [d for g in groups for d in g]
    table("kFwPtr", "int", np.cumsum([0] + [len(fwd[d]) for d in dg_dof]))
    table("kFwKI", "int", [_pack16(k, i) for d in dg_dof for k, i in fwd[d]])
    # The backward solve's terms of each DoF: its column's ancestor entries
    # and the ancestors, in the column's order.
    table("kBwPtr", "int", np.cumsum([0] + [pk_ptr[d + 1] - 1 - pk_ptr[d] for d in dg_dof]))
    table("kBwKA", "int", [_pack16(k, pk_row[k]) for d in dg_dof
                           for k in range(pk_ptr[d], pk_ptr[d + 1] - 1)])
    # The Hessian fill's entries dealt to the block's threads, longest
    # first to the least loaded (an entry's work: the candidates on its
    # column's DoF), interleaved so that thread t takes positions t, t + T,
    # ...; -1 pads.
    hf = _deal([len(dc[d]) for _a, d in st.pair_keys], layout["threads"])
    const("NHF", len(hf))
    table("kHf", "int", hf)

    # Actuators.
    table("kActKind", "int", st.act_kind)
    table("kActHinge", "int", st.act_hinge)
    table("kActGain", "float", st.act_gain)
    table("kActKv", "float", st.act_kv)
    table("kCtrlLim", "int", st.act_ctrllimited > 0)
    table("kCtrlRange", "float", st.act_ctrlrange.reshape(-1))
    table("kForceLim", "int", st.act_forcelimited > 0)
    table("kForceRange", "float", st.act_forcerange.reshape(-1))
    # The actuators whose force each DoF takes, in actuator order.
    dof_act = [[] for _ in range(nv)]
    for u in range(st.nu):
        h = int(st.act_hinge[u])
        if int(st.act_kind[u]) != ActKind.ADHESION and h >= 0:
            dof_act[int(st.hinge_vadr[h])].append(u)
    aptr = [0]
    for us in dof_act:
        aptr.append(aptr[-1] + len(us))
    table("kDofActPtr", "int", aptr)
    table("kDofAct", "int", [u for us in dof_act for u in us])
    # Activation slots; the time constants (cylinder: dynprm[0]; muscle:
    # activation dynprm[0], deactivation dynprm[1]); per muscle its folded
    # constants (_MUSCLE_KEYS), zeros for the other kinds.
    table("kActAdr", "int", st.act_actadr)
    table("kActTau0", "float", [max(float(x), _EPS) for x in st.act_dynprm[:, 0]])
    table("kActTau1", "float", [max(float(x), _EPS) for x in st.act_dynprm[:, 1]])
    muscles = [int(k) == ActKind.MUSCLE for k in st.act_kind]
    table("kMus", "float", [
        x for u in range(st.nu) for x in (
            [_muscle_consts(st, u)[key] for key in _MUSCLE_KEYS] if muscles[u]
            else [0.0] * len(_MUSCLE_KEYS))])

    # Candidates: geometry, constraint dynamics, paths.
    cg = [int(g) for g in st.can_geom]
    table("kCandBody", "int", cand_bodies)
    table("kCandGPos", "float", [x for g in cg for x in _fold(st.geom_pos[g])])
    table("kCandGQuat", "float", [x for g in cg for x in _fold_quat(st.geom_quat[g])])
    table("kCandEndH", "float",
          [float(st.can_end[c]) * float(st.geom_size[g, 1]) for c, g in enumerate(cg)])
    table("kCandRad", "float", [st.geom_size[g, 0] for g in cg])
    table("kCandMargin", "float", st.can_margin)
    sol = {k: [] for k in ("width", "mid", "pow", "ac", "bc", "dmin", "dmm", "nbg", "kg", "iw",
                           "mu", "mudir", "mudir2")}
    for c in range(st.ncand):
        dmin, dmax, width, mid, power = (float(x) for x in st.can_solimp[c])
        tc, dr = float(st.can_solref[c][0]), float(st.can_solref[c][1])
        mu = float(st.can_friction[c][0])
        sol["width"].append(max(width, 1e-12))
        sol["mid"].append(mid)
        sol["pow"].append(power)
        sol["ac"].append(1.0 / mid ** (power - 1.0))
        sol["bc"].append(1.0 / (1.0 - mid) ** (power - 1.0))
        sol["dmin"].append(dmin)
        sol["dmm"].append(dmax - dmin)
        sol["nbg"].append(-(2.0 / (dmax * tc)))
        sol["kg"].append(1.0 / (dmax * dmax * tc * tc * dr * dr))
        sol["iw"].append(max(float(st.can_invweight[c, 0]), 1e-12))
        sol["mu"].append(mu)
        # Per tag its coefficient and square (Python products, as the
        # emitter's mu * mu), candidate-major.
        for t in tags:
            mu_t = _mu_of(tuple(float(x) for x in st.can_friction[c]), t)
            sol["mudir"].append(mu_t)
            sol["mudir2"].append(mu_t * mu_t)
    names = dict(width="kSolWidth", mid="kSolMid", pow="kSolPow", ac="kSolA", bc="kSolB",
                 dmin="kSolDmin", dmm="kSolDmm", nbg="kNegBGain", kg="kKGain",
                 iw="kInvW", mu="kMu", mudir="kMuDir", mudir2="kMuDir2")
    for key, name in names.items():
        table(name, "float", sol[key])
    # Path slots: one per body, then (uncompressed pair rows) one per pair
    # row; a compressed row walks its geom1's and its winner's body slots.
    pptr, plist = [0], []
    for path in paths + ([] if comp else st.cand_paths[st.ng_rows:]):
        plist += path
        pptr.append(len(plist))
    table("kPathPtr", "int", pptr)
    table("kPathDof", "int", plist)

    if comp:
        # geom1's half length per group; per member (groups' members end to
        # end, from kGroupBase) geom2's body, pose in the body, radius and
        # half length, and the row's inverse weight were it the winner.
        members = [m for grp in comp for m in grp["members"]]
        base = [0]
        for grp in comp:
            base.append(base[-1] + len(grp["members"]))
        table("kPairH1", "float", [st.geom_size[int(st.can_geom[c]), 1]
                                   for c in range(st.ng_rows, st.ncand)])
        table("kGroupBase", "int", base)
        table("kMemBody2", "int", [b2 for _g2, b2 in members])
        table("kMemGPos2", "float", [x for g2, _b2 in members for x in _fold(st.geom_pos[g2])])
        table("kMemGQuat2", "float",
              [x for g2, _b2 in members for x in _fold_quat(st.geom_quat[g2])])
        table("kMemR2", "float", [r for grp in comp for r in grp["r2"]])
        table("kMemH2", "float", [h for grp in comp for h in grp["h2"]])
        table("kMemInvW", "float", [max(w, 1e-12) for grp in comp for w in grp["invw"]])
    elif st.ncand_pair:
        # Each candidate's path slot, where each pair row's second body's
        # part starts; geom2 of each pair row and both capsules' half
        # lengths.
        table("kCandSlot", "int", cand_bodies[: st.ng_rows]
              + [nb + i for i in range(st.ncand_pair)])
        table("kPairSplit", "int", st.cand_split[st.ng_rows:])
        g2 = [int(st.can_geom2[c]) for c in range(st.ng_rows, st.ncand)]
        table("kPairBody2", "int", [int(st.geom_body[g]) for g in g2])
        table("kPairGPos2", "float", [x for g in g2 for x in _fold(st.geom_pos[g])])
        table("kPairGQuat2", "float", [x for g in g2 for x in _fold_quat(st.geom_quat[g])])
        table("kPairR2", "float", [st.geom_size[g, 0] for g in g2])
        table("kPairH1", "float", [st.geom_size[int(st.can_geom[c]), 1]
                                   for c in range(st.ng_rows, st.ncand)])
        table("kPairH2", "float", [st.geom_size[g, 1] for g in g2])

    # Adhesion groups and sensor groups.
    aptr, alist = [0], []
    for _u, group in adh:
        alist += group
        aptr.append(len(alist))
    table("kAdhAct", "int", [u for u, _g in adh])
    table("kAdhPtr", "int", aptr)
    table("kAdhCand", "int", alist)
    sptr, slist = [0], []
    for s in range(st.nsensor):
        slist += st.sensor_groups[s]
        sptr.append(len(slist))
    table("kSensPtr", "int", sptr)
    table("kSensCand", "int", slist)

    # Per DoF the candidates whose path holds it (_dof_candidates).
    dptr = [0]
    for entries in dc:
        dptr.append(dptr[-1] + len(entries))
    table("kDcPtr", "int", dptr)
    table("kDcCO", "int", [_pack16(c, off + 1) for entries in dc for c, off in entries])

    # Sites.
    table("kSiteBody", "int", st.site_body)
    table("kSitePos", "float", [x for s in range(st.nsite) for x in _fold(st.site_pos[s])])
    return "\n".join(lines) + "\n", layout["n_scratch"]


def _pack(st: _Static, state: State, ctrl_seq, terrain_planes, K: int) -> torch.Tensor:
    """The kernel's world-minor (n_in, B) input rows (``_io_rows``)."""
    B = state.qpos.shape[0]
    ctrl_rows = (state.ctrl if ctrl_seq is None else ctrl_seq).reshape(K, B, st.nu)
    parts = [state.qpos.t(), state.qvel.t(),
             ctrl_rows.permute(0, 2, 1).reshape(K * st.nu, B), state.act.t(), state.qacc.t()]
    if terrain_planes is not None:
        parts.append(terrain_planes.reshape(B, _n_aux(st)).t().to(torch.float32))
    packed = torch.cat(parts)
    if packed.dtype != torch.float32:
        raise TypeError(f"the mega-step kernel takes float32 state, got {packed.dtype}")
    n_in = _io_rows(st, K)[0]
    if packed.shape[0] != n_in:
        raise ValueError(f"state packs into {packed.shape[0]} rows, the model needs {n_in}")
    return packed


# The phases of K2's step that its profile build (-DMS_PROFILE) times with
# clock64(), in the order of its counters.
PROFILE_PHASES = (
    "FK, velocities, inertias, CRBA, RNEA", "forces and actuators",
    "contact candidates and adhesion", "first pass and factor", "Newton: re-fill and factor",
    "Newton: solve", "Newton: mh_mul", "Newton: JD rows", "Newton: line search (dphi)",
    "Newton: update", "outputs and sensors", "Euler and activations",
)


def profile_megastep(model: PhysicsModel, state: State, ctrl_seq: torch.Tensor) -> dict:
    """Clock cycles of each of K2's ``PROFILE_PHASES`` in one K-step launch
    on the card (K = ``ctrl_seq.shape[0]``), summed over the worlds, from
    the profile build of K2 (``_build.build_megastep(profile=True)``; the
    kernel's outputs are those of the plain build), for a model without
    terrain planes or pair winners. Not counted in ``launches``."""
    from flygym_tpu_torch.ops._build import load_megastep

    st = _Static(model)
    K, B = int(ctrl_seq.shape[0]), state.qpos.shape[0]
    dev = state.qpos.device
    if dev.type != "cuda":
        raise RuntimeError("the profile build runs on the card")
    if _n_aux(st) > 0:
        raise ValueError("profile_megastep: the model reads terrain planes or pair winners")
    lib = load_megastep(model_header(model)[0], profile=True)
    packed = _pack(st, state, ctrl_seq, None, K)
    out = torch.empty((_io_rows(st, K)[1], B), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, max(scratch_layout(model)["n_global"], 1)),
                          dtype=torch.float32, device=dev)
    prof = torch.zeros((len(PROFILE_PHASES), B), dtype=torch.int64, device=dev)
    err = lib.megastep_profile_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                   prof.data_ptr(), B, K,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, err)
    cycles = prof.sum(dim=1).tolist()
    return dict(zip(PROFILE_PHASES, cycles))


def kernel_shape(model: PhysicsModel) -> dict:
    """K2's launch for ``model`` as the card takes it (builds the kernel):
    threads per block, dynamic shared bytes per block, global scratch floats
    per world, and the blocks per SM that can be resident
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    from flygym_tpu_torch.ops._build import load_megastep

    lib = load_megastep(model_header(model)[0])
    shape = (ctypes.c_int * 4)()
    _raise_on_error(lib, lib.megastep_shape(shape))
    return dict(zip(("threads", "shared_bytes", "n_global", "blocks_per_sm"), shape))


def kernel_powf(model: PhysicsModel, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x ** y`` elementwise through K2's own pow (``ms_powf`` of
    ``csrc/megastep.cu``, the impedance's), from ``model``'s build, on
    CUDA tensors of float32: the device function alone, to hold against
    :func:`~flygym_tpu_torch.engine.maths.powf`. Not counted in
    ``launches``. The host build's ``megastep_powf_host_f32`` is the same
    code compiled by g++."""
    from flygym_tpu_torch.ops._build import load_megastep

    if x.device.type != "cuda" or y.device != x.device:
        raise RuntimeError(f"kernel_powf runs on CUDA tensors, got {x.device} and {y.device}")
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).expand_as(x).contiguous()
    lib = load_megastep(model_header(model)[0])
    out = torch.empty_like(x)
    if x.numel():
        _raise_on_error(lib, lib.megastep_powf_f32(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream))
    return out


def _raise_on_error(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"megastep launch failed: {lib.cuda_error_string(err).decode()}")


def make_megastep(model: PhysicsModel, k_steps: int = 1):
    """A batched step through K2 that fuses ``k_steps`` physics steps.

    With ``k_steps == 1`` the function is ``fn(state, terrain_planes=None)
    -> state``; with K > 1 it is ``fn(state, ctrl_seq, terrain_planes=None)
    -> (state, (K, B, nq) qpos rows)``, where ``ctrl_seq`` is (K, B, nu) of
    NaN-free controls (``make_megastep`` of the JAX package,
    ``megastep.py:2422-2452``). ``fn.sample_planes(state)`` gives what one
    launch reads for all its K steps from outside the kernel, under the
    state's cached pose: on a heightfield world the (B, ncand, 4) ground
    planes, on a world with compressed pair rows the (B, n_groups) winners
    of the pair groups (JAX ``megastep.py:2656-2673``); without
    ``terrain_planes`` the function samples them itself. Otherwise
    ``fn.sample_planes`` is None. Winners that a caller passes are checked
    on the host (a read of the tensor); those of ``fn.sample_planes`` are
    not.

    For CPU tensors the function runs :func:`megastep_plain`. For CUDA
    tensors it packs the state world-minor, (n_in, B), launches K2 once on
    the current stream (one block per world, its rows in shared memory and,
    past :func:`scratch_layout`'s budget, in a (B, n_global) scratch buffer)
    and unpacks its (n_out, B) rows; the kernel is built at the first launch
    and a build or launch failure raises.
    """
    K = int(k_steps)
    if K < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    if not megastep_supported(model):
        raise NotImplementedError("the mega-step kernel does not support this model")
    st = _Static(model)
    n_in, n_out = _io_rows(st, K)
    built = {}
    sampler = make_plane_sampler(model) or make_pair_winner_sampler(model)
    sampled = {}  # id -> weak reference of each tensor sample_planes made

    def sample_planes(state: State) -> torch.Tensor:
        aux = sampler(state.xpos, state.xquat)
        for key in [key for key, ref in sampled.items() if ref() is None]:
            del sampled[key]
        sampled[id(aux)] = weakref.ref(aux)
        return aux

    def ours(aux) -> bool:
        ref = sampled.get(id(aux))
        return ref is not None and ref() is aux

    def run(state: State, ctrl_seq, terrain_planes):
        if ctrl_seq is not None and tuple(ctrl_seq.shape) != (K,) + tuple(state.ctrl.shape):
            raise ValueError(f"ctrl_seq: expected {(K,) + tuple(state.ctrl.shape)}, "
                             f"got {tuple(ctrl_seq.shape)}")
        B = state.qpos.shape[0]
        if sampler is None:
            if terrain_planes is not None:
                raise ValueError("terrain_planes given for a world without a heightfield or "
                                 "compressed pair rows")
        elif terrain_planes is None:
            terrain_planes = sample_planes(state)
        elif tuple(terrain_planes.shape) != _aux_shape(st, B):
            raise ValueError(f"terrain_planes: expected {_aux_shape(st, B)}, "
                             f"got {tuple(terrain_planes.shape)}")
        elif st.pair_comp_groups and not ours(terrain_planes):
            _check_winners(st, terrain_planes)
        dev = state.qpos.device
        if dev.type == "cpu":
            return megastep_plain(st, state, ctrl_seq, terrain_planes)
        if dev.type != "cuda":
            raise RuntimeError(f"the mega-step kernel runs on CUDA tensors, got {dev}")
        if not built:
            from flygym_tpu_torch.ops._build import load_megastep

            header, _n = model_header(model)
            built["lib"] = load_megastep(header)
            built["n_global"] = scratch_layout(model)["n_global"]
        lib = built["lib"]
        packed = _pack(st, state, ctrl_seq, terrain_planes, K)
        refuse_grad("megastep", packed)
        out = torch.empty((n_out, B), dtype=torch.float32, device=dev)
        scratch = torch.empty((B, max(built["n_global"], 1)), dtype=torch.float32, device=dev)
        if B:
            err = lib.megastep_f32(
                packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, K,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            _raise_on_error(lib, err)
            launches["megastep"] += 1
        ctrl = state.ctrl if ctrl_seq is None else ctrl_seq[-1]
        new, traj = _unpack(st, out, state, ctrl, K)
        return new if ctrl_seq is None else (new, traj)

    if K == 1:
        def fn(state: State, terrain_planes: torch.Tensor | None = None) -> State:
            return run(state, None, terrain_planes)
    else:
        def fn(state: State, ctrl_seq: torch.Tensor, terrain_planes: torch.Tensor | None = None):
            return run(state, ctrl_seq, terrain_planes)

    fn.k_steps = K
    fn.static = st
    fn.sample_planes = None if sampler is None else sample_planes
    return fn
