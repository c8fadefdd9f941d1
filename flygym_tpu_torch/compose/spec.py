"""Model-description IR and compiler: the dm_control.mjcf replacement.

Port of ``flygym_tpu/compose/spec.py``. The reference composes models as MJCF
element trees and compiles them through ``mjcf.Physics.from_mjcf_model``
into MuJoCo C structs (flygym ``compose/base.py:21-27``). Here the same roles
are played by:

- :class:`ModelSpec` — a lightweight host-side IR (bodies, joints, geoms,
  actuators, contact pairs, sensors, cameras) with dm_control-style
  ``attach`` + namespacing semantics (``{model}/{element}`` full identifiers,
  like dm_control's attach, reference ``world.py:279``).
- :meth:`ModelSpec.compile_arrays` — flattens the IR into numpy arrays (dense
  index arrays, level schedules, ancestor/subtree masks), the static fields
  and the one-world initial state, in the form an exported ``.npz`` file
  holds them, plus name→index maps. Each array is built as the JAX compile
  builds it, op for op in float64, then cast as ``jnp.asarray`` casts it
  with x64 off (float64 to float32, int64 to int32), so that the arrays
  come out bit-equal to the JAX package's.
- :meth:`ModelSpec.compile` — the same through
  :func:`~flygym_tpu_torch.compose.bridge.model_from_numpy`, the port's one
  way into a :class:`~flygym_tpu_torch.engine.model.PhysicsModel`.
- :meth:`ModelSpec.to_mjcf_xml` — emits the *compiled* model as MJCF (capsule
  geoms + explicit inertials), used for golden-trajectory cross-validation
  against MuJoCo and for ``save_xml_with_assets`` parity.

All dynamics-relevant quantities are computed here once at compile time, on
the CPU, so the engine's step is shape-static regardless of presets
(SURVEY.md §7 "hard parts").
"""

import io
import json
from dataclasses import dataclass, field as dc_field, replace
from typing import Any

import numpy as np

from flygym_tpu_torch.utils.exceptions import FlyGymInternalError
from flygym_tpu_torch.utils.math import _quat_from_mat_np

__all__ = [
    "ModelSpec",
    "BodySpec",
    "JointSpec",
    "GeomSpec",
    "SiteSpec",
    "CameraSpec",
    "ActuatorSpec",
    "PairSpec",
    "ContactSensorSpec",
]

_BOUND_MASS = 1e-6  # reference mujoco_globals.yaml:6 (boundmass)
_BOUND_INERTIA = 1e-12  # reference mujoco_globals.yaml:7 (boundinertia)


@dataclass
class _Element:
    name: str
    namespace: str = dc_field(default="", kw_only=True)

    @property
    def full_identifier(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class JointSpec(_Element):
    type: str = "hinge"  # "hinge" | "free"
    axis: tuple = (0.0, 0.0, 1.0)
    stiffness: float = 0.0
    damping: float = 0.0
    armature: float = 0.0
    springref: float = 0.0
    extra: dict = dc_field(default_factory=dict)


@dataclass
class GeomSpec(_Element):
    type: str = "capsule"  # "capsule" | "plane" | "sphere" | "box"
    size: tuple = (0.0, 0.0, 0.0)
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    mass: float = 0.0
    # Inertial override (from derived mesh data); None → analytic from shape.
    ipos: tuple | None = None
    iquat: tuple | None = None
    inertia_diag: tuple | None = None
    rgba: tuple = (0.5, 0.5, 0.5, 1.0)
    material: str | None = None
    # Material/procedural-texture table (set by Fly.colorize from
    # visuals.json; consumed by the raycaster's shading stage).
    specular: float = 0.35
    shininess: float = 0.22
    tex_builtin: int = 0  # 0 none | 1 flat | 2 gradient
    tex_rgb1: tuple = (1.0, 1.0, 1.0)
    tex_rgb2: tuple = (1.0, 1.0, 1.0)
    tex_markrgb: tuple = (0.0, 0.0, 0.0)
    tex_random: float = 0.0
    extra: dict = dc_field(default_factory=dict)

    def set_attributes(self, **kwargs):
        """dm_control-style attribute update (used by Fly.colorize)."""
        for key, value in kwargs.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self.extra[key] = value


@dataclass
class SiteSpec(_Element):
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)


@dataclass
class CameraSpec(_Element):
    mode: str = "track"
    target: str | None = None
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    fovy: float = 45.0
    extra: dict = dc_field(default_factory=dict)


@dataclass
class ActuatorSpec(_Element):
    kind: str = "motor"  # ActuatorType value string
    joint: str | None = None  # target joint full name (resolved at compile)
    body: str | None = None  # adhesion target body
    gain: float = 1.0  # kp (position) / gain (motor, adhesion) / kv (velocity)
    kv: float = 0.0  # extra velocity feedback for position/intvelocity
    ctrlrange: tuple | None = None
    forcerange: tuple | None = None
    forcelimited: bool = False
    # Activation dynamics / muscle parameters (None -> MuJoCo defaults).
    dynprm: tuple | None = None
    muscleprm: tuple | None = None
    lengthrange: tuple | None = None
    extra: dict = dc_field(default_factory=dict)


@dataclass
class PairSpec:
    geom1: str  # capsule geom full name
    geom2: str  # plane geom full name
    condim: int = 3  # 1 frictionless | 3 sliding | 4 +torsional | 6 +rolling
    friction: tuple = (1.0, 1.0, 0.005, 1e-4, 1e-4)
    solref: tuple = (0.02, 1.0)
    solimp: tuple = (0.9, 0.95, 1e-3, 0.5, 2.0)  # dmin dmax width midpoint power
    margin: float = 0.0
    name: str = ""


@dataclass
class ContactSensorSpec(_Element):
    subtree_body: str = ""  # contacts of any body in this subtree...
    geom2: str = ""  # ...against this geom


@dataclass
class BodySpec(_Element):
    parent: str | None = None  # None → world
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    joints: list = dc_field(default_factory=list)
    geoms: list = dc_field(default_factory=list)
    sites: list = dc_field(default_factory=list)

    def add_joint(self, joint: JointSpec) -> JointSpec:
        self.joints.append(joint)
        return joint

    def add_geom(self, geom: GeomSpec) -> GeomSpec:
        self.geoms.append(geom)
        return geom

    def add_site(self, site: SiteSpec) -> SiteSpec:
        self.sites.append(site)
        return site


class ModelSpec:
    """A composable model description (fly or world)."""

    def __init__(self, name: str):
        self.name = name
        self.bodies: list[BodySpec] = []  # insertion order = compile order
        self.world_geoms: list[GeomSpec] = []  # static geometry on the world
        self.actuators: list[ActuatorSpec] = []
        self.pairs: list[PairSpec] = []
        self.contact_sensors: list[ContactSensorSpec] = []
        self.cameras: list[CameraSpec] = []
        # Soft weld constraints: (root body full name, refpos, refquat,
        # solref, solimp) pinning a free root body to a world pose
        # (TetheredWorld(weld="soft"); MuJoCo <equality><weld> analog).
        self.welds: list[tuple] = []
        # Optional heightfield terrain: dict(data (nr, nc) heights in mm,
        # xy0 (2,), cell (2,) spacing). None → flat ground plane.
        self.hfield: dict | None = None
        self.options: dict[str, Any] = {
            "timestep": 1e-4,
            "gravity": (0.0, 0.0, -9810.0),  # mm/s^2 (mujoco_globals.yaml:11)
            "solver": "newton",
            "solver_iterations": 2,
            "solver_relaxation": 1.0,
            # Strict-parity solver: exact per-iteration Hessian refactor
            # (see PhysicsModel.solver_exact). Off for speed by default.
            "solver_exact": False,
            # Differentiable solver ops (the JAX package's jax.grad path);
            # the port refuses such a model (compose/bridge.py).
            "differentiable": False,
            # Static contact-slot cap for the engine step's solver: only the
            # ncon CLOSEST candidates reach it each step (top-K, static
            # shapes). The mega-step kernel processes ALL candidates and
            # ignores this. None -> 16 per attached fly — ample for
            # locomotion (a walking fly grounds ~12 capsule ends), but
            # dense multi-fly pile-ups can exceed it; raise it (or use
            # the kernel path) if contacts appear to slip in crowds.
            "ncon_max": None,
            # Nearest-neighbor compression of capsule-capsule pair rows:
            # instead of solving every geom1-geom2 pair, each geom1 group
            # contributes only its closest geom2 (per step). None -> auto
            # (on for oversized pair sets, >= 512 rows: the full default
            # two-fly preset is 3,025 rows).
            "pair_compress": None,
        }
        # Neutral keyframe ingredients, keyed by full identifiers.
        self.neutral_joint_qpos: dict[str, list[float]] = {}
        self.neutral_ctrl: dict[str, float] = {}

    # ------------------------------------------------------------------
    # Composition
    # ------------------------------------------------------------------

    def add_body(self, body: BodySpec) -> BodySpec:
        if any(b.name == body.name and b.namespace == body.namespace
               for b in self.bodies):
            raise ValueError(f"Duplicate body name: {body.full_identifier}")
        self.bodies.append(body)
        return body

    def body_by_name(self, full_name: str) -> BodySpec:
        for b in self.bodies:
            if b.full_identifier == full_name:
                return b
        raise KeyError(full_name)

    def attach(
        self,
        child: "ModelSpec",
        *,
        prefix: str | None = None,
        spawn_pos: tuple = (0.0, 0.0, 0.0),
        spawn_quat: tuple = (1.0, 0.0, 0.0, 0.0),
        free_joint_name: str | None = None,
    ) -> JointSpec | None:
        """Merge ``child`` into this spec under a namespace prefix.

        The child's root bodies (parent None) are attached to this spec's
        world. With ``free_joint_name``, the first root body receives a free
        joint (flat-ground worlds); otherwise it is rigidly fixed at the spawn
        pose (tethered worlds).

        Returns the created free JointSpec, or None.
        """
        prefix = child.name if prefix is None else prefix
        for element_list in (
            child.bodies,
            child.actuators,
            child.contact_sensors,
            child.cameras,
        ):
            for element in element_list:
                if element.namespace:
                    raise ValueError("Child spec is already attached")
                element.namespace = prefix
        for body in child.bodies:
            for sub in (*body.joints, *body.geoms, *body.sites):
                sub.namespace = prefix
            if body.parent is not None:
                body.parent = f"{prefix}/{body.parent}"
        # Re-prefix by-name cross references held by child elements.
        for a in child.actuators:
            if a.joint is not None:
                a.joint = f"{prefix}/{a.joint}"
            if a.body is not None:
                a.body = f"{prefix}/{a.body}"
        for s in child.contact_sensors:
            s.subtree_body = f"{prefix}/{s.subtree_body}"
            s.geom2 = f"{prefix}/{s.geom2}"
        for c in child.cameras:
            if c.target is not None:
                c.target = f"{prefix}/{c.target}"
        for p in child.pairs:
            p.geom1 = f"{prefix}/{p.geom1}"
            p.geom2 = f"{prefix}/{p.geom2}"

        free_joint = None
        roots = [b for b in child.bodies if b.parent is None]
        for root in roots:
            root.pos = tuple(spawn_pos)
            root.quat = tuple(spawn_quat)
            if free_joint_name is not None and free_joint is None:
                free_joint = JointSpec(
                    name=free_joint_name, type="free", namespace=prefix
                )
                root.joints.insert(0, free_joint)
                self.neutral_joint_qpos[free_joint.full_identifier] = [
                    *spawn_pos,
                    *spawn_quat,
                ]

        self.bodies.extend(child.bodies)
        self.actuators.extend(child.actuators)
        self.pairs.extend(child.pairs)
        self.contact_sensors.extend(child.contact_sensors)
        self.cameras.extend(child.cameras)

        # Merge neutral keyframe ingredients, detecting conflicts (the
        # world-level keyframe management of the reference, world.py:151-207).
        for key, value in child.neutral_joint_qpos.items():
            full = f"{prefix}/{key}"
            if full in self.neutral_joint_qpos:
                raise FlyGymInternalError(
                    f"Conflict in neutral joint state for '{full}'"
                )
            self.neutral_joint_qpos[full] = value
        for key, value in child.neutral_ctrl.items():
            full = f"{prefix}/{key}"
            if full in self.neutral_ctrl:
                raise FlyGymInternalError(
                    f"Conflict in neutral actuator input for '{full}'"
                )
            self.neutral_ctrl[full] = value
        return free_joint

    # ------------------------------------------------------------------
    # Compilation
    # ------------------------------------------------------------------

    def compile(self):
        """Compile into the port's
        :class:`~flygym_tpu_torch.compose.bridge.CompiledModel` on the CPU:
        the model, its one-world initial state and the name maps
        (``compiled.body_name2id`` and the rest, as the JAX package's
        ``CompiledModel`` names them); ``flies`` is empty (a world fills
        it, :meth:`BaseWorld.compile`)."""
        from flygym_tpu_torch.compose.bridge import model_from_numpy

        arrays, meta, names = self.compile_arrays()
        return replace(model_from_numpy(arrays, meta), names=names)

    def compile_arrays(self) -> tuple:
        """Flatten into numpy: ``(arrays, meta, names)``.

        ``arrays`` holds ``model.<field>`` for every array field and
        ``state.<field>`` for the one-world initial state, ``meta`` is
        ``{"model": static fields as JSON gives them back, "flies": {}}``
        (what ``scripts/export_torch_model.py:export`` writes, without the
        flies' maps), and ``names`` the compiler's name→index maps.
        """
        from flygym_tpu_torch.engine.model import ActKind

        f32, i32 = np.float32, np.int32

        # --- body ordering: world=0, then DFS over insertion order ---
        children: dict[str | None, list[BodySpec]] = {}
        for b in self.bodies:
            children.setdefault(b.parent, []).append(b)
        ordered: list[BodySpec] = []

        def visit(parent_key):
            for b in children.get(parent_key, []):
                ordered.append(b)
                visit(b.full_identifier)

        visit(None)
        if len(ordered) != len(self.bodies):
            raise FlyGymInternalError("Body graph is not a tree rooted at world")

        nb = len(ordered) + 1  # + world body
        body_id = {"world": 0}
        for i, b in enumerate(ordered):
            body_id[b.full_identifier] = i + 1

        body_parent = np.zeros(nb, i32)
        body_pos = np.zeros((nb, 3), f32)
        body_quat = np.zeros((nb, 4), f32)
        body_quat[:, 0] = 1.0
        for i, b in enumerate(ordered):
            body_parent[i + 1] = body_id.get(
                b.parent if b.parent is not None else "world", 0
            )
            body_pos[i + 1] = b.pos
            body_quat[i + 1] = _normalize(b.quat)

        # --- joints (free + hinge), qpos/qvel layout in body order ---
        hinge_list, free_list = [], []  # (body_id, JointSpec)
        for b in ordered:
            for j in b.joints:
                if j.type == "free":
                    free_list.append((body_id[b.full_identifier], j))
                elif j.type == "hinge":
                    hinge_list.append((body_id[b.full_identifier], j))
                else:
                    raise ValueError(f"Unsupported joint type: {j.type}")

        # Addresses: iterate bodies in order; free joints first within a body.
        qadr, vadr = 0, 0
        joint_qadr, joint_vadr = {}, {}
        free_joints = []
        hinge_entries = []  # (body, spec, qadr, vadr)
        for b in ordered:
            bid = body_id[b.full_identifier]
            for j in b.joints:
                if j.type == "free":
                    joint_qadr[j.full_identifier] = qadr
                    joint_vadr[j.full_identifier] = vadr
                    free_joints.append((bid, qadr, vadr))
                    qadr += 7
                    vadr += 6
                else:
                    joint_qadr[j.full_identifier] = qadr
                    joint_vadr[j.full_identifier] = vadr
                    hinge_entries.append((bid, j, qadr, vadr))
                    qadr += 1
                    vadr += 1
        nq, nv = qadr, vadr
        nh = len(hinge_entries)

        hinge_body = np.zeros(nh, i32)
        hinge_slot = np.zeros(nh, i32)
        hinge_axis = np.zeros((nh, 3), f32)
        hinge_qadr = np.zeros(nh, i32)
        hinge_vadr = np.zeros(nh, i32)
        hinge_stiffness = np.zeros(nh, f32)
        hinge_damping = np.zeros(nh, f32)
        hinge_armature = np.zeros(nh, f32)
        hinge_springref = np.zeros(nh, f32)
        hinge_name2idx = {}
        body_hinge_idx = -np.ones((nb, 3), i32)
        body_hinge_count = np.zeros(nb, i32)
        for k, (bid, j, qa, va) in enumerate(hinge_entries):
            hinge_body[k] = bid
            axis = np.asarray(j.axis, np.float64)
            hinge_axis[k] = axis / np.linalg.norm(axis)
            hinge_qadr[k] = qa
            hinge_vadr[k] = va
            hinge_stiffness[k] = j.stiffness
            hinge_damping[k] = j.damping
            hinge_armature[k] = j.armature
            hinge_springref[k] = j.springref
            hinge_name2idx[j.full_identifier] = k
            slot = body_hinge_count[bid]
            if slot >= 3:
                raise FlyGymInternalError(
                    f"Body {bid} has more than 3 hinge joints"
                )
            body_hinge_idx[bid, slot] = k
            hinge_slot[k] = slot
            body_hinge_count[bid] += 1

        body_free_qadr = -np.ones(nb, i32)
        body_free_vadr = -np.ones(nb, i32)
        for bid, qa, va in free_joints:
            body_free_qadr[bid] = qa
            body_free_vadr[bid] = va

        # --- DoF bookkeeping ---
        dof_body = np.zeros(nv, i32)
        dof_armature = np.zeros(nv, f32)
        dof_damping = np.zeros(nv, f32)
        for bid, _qa, va in free_joints:
            dof_body[va : va + 6] = bid
        for k in range(nh):
            dof_body[hinge_vadr[k]] = hinge_body[k]
            dof_armature[hinge_vadr[k]] = hinge_armature[k]
            dof_damping[hinge_vadr[k]] = hinge_damping[k]

        # --- tree masks and levels ---
        ancestors = [set() for _ in range(nb)]  # body-level ancestors incl self
        level = np.zeros(nb, i32)
        for i in range(nb):
            p = body_parent[i]
            if i == 0:
                ancestors[i] = {0}
            else:
                ancestors[i] = ancestors[p] | {i}
                level[i] = level[p] + 1
        body_subtree_mask = np.zeros((nb, nb), f32)
        for j in range(nb):
            for a in ancestors[j]:
                body_subtree_mask[a, j] = 1.0

        nlevel = int(level.max()) + 1 if nb > 1 else 1
        levels = tuple(
            tuple(int(i) for i in np.nonzero(level == d)[0]) for d in range(nlevel)
        )

        # Pointer-doubling ancestor jump tables (log2(depth) rounds).
        jumps = []
        current = body_parent.copy()
        depth = max(nlevel - 1, 1)
        rounds = max(int(np.ceil(np.log2(depth))), 1) if depth > 1 else 1
        for _ in range(rounds):
            jumps.append(tuple(int(x) for x in current))
            current = current[current]
        ancestor_jumps = tuple(jumps)

        # DoF ancestor mask: strict body ancestry, or same body with i <= j.
        dof_ancestor_mask = np.zeros((nv, nv), f32)
        for i in range(nv):
            for j in range(nv):
                bi, bj = dof_body[i], dof_body[j]
                if bi == bj:
                    dof_ancestor_mask[i, j] = 1.0 if i <= j else 0.0
                elif bi in ancestors[bj]:
                    dof_ancestor_mask[i, j] = 1.0

        # Tree-sparse LDL structure: each DoF's ancestor chain (strict, in
        # root→self order), plus elimination (height) and solve (depth)
        # level schedules (see engine/linalg.py).
        dof_chains = [
            sorted(
                (j for j in range(nv) if j != i and dof_ancestor_mask[j, i] > 0)
            )
            for i in range(nv)
        ]
        maxc = max((len(c) for c in dof_chains), default=1) or 1
        dof_anc = -np.ones((nv, maxc), i32)
        for i, chain in enumerate(dof_chains):
            dof_anc[i, : len(chain)] = chain
        dof_depth = np.array([len(c) for c in dof_chains], i32)
        dof_children: list[list[int]] = [[] for _ in range(nv)]
        for i, chain in enumerate(dof_chains):
            if chain:
                dof_children[chain[-1]].append(i)
        dof_height = np.zeros(nv, i32)
        for i in sorted(range(nv), key=lambda i: -dof_depth[i]):
            if dof_children[i]:
                dof_height[i] = 1 + max(dof_height[c] for c in dof_children[i])
        dof_height_levels = tuple(
            lvl
            for h in range(int(dof_height.max()) + 1 if nv else 0)
            if (lvl := tuple(int(i) for i in np.nonzero(dof_height == h)[0]))
        )
        dof_depth_levels = tuple(
            lvl
            for d in range(int(dof_depth.max()) + 1 if nv else 0)
            if (lvl := tuple(int(i) for i in np.nonzero(dof_depth == d)[0]))
        )

        # --- geoms ---
        geoms: list[tuple[int, GeomSpec]] = [(0, g) for g in self.world_geoms]
        for b in ordered:
            for g in b.geoms:
                geoms.append((body_id[b.full_identifier], g))
        ng = len(geoms)
        geom_body = np.zeros(ng, i32)
        geom_pos = np.zeros((ng, 3), f32)
        geom_quat = np.zeros((ng, 4), f32)
        geom_quat[:, 0] = 1.0
        geom_size = np.zeros((ng, 3), f32)
        geom_rgba = np.ones((ng, 4), f32) * 0.5
        geom_matprops = np.zeros((ng, 2), f32)
        geom_tex = np.zeros((ng, 11), f32)
        geom_types = []
        geom_name2idx = {}
        for gi, (bid, g) in enumerate(geoms):
            geom_body[gi] = bid
            geom_pos[gi] = g.pos
            geom_quat[gi] = _normalize(g.quat)
            size = np.zeros(3)
            size[: len(g.size)] = g.size
            geom_size[gi] = size
            geom_rgba[gi] = g.rgba
            geom_matprops[gi] = (g.specular, g.shininess)
            geom_tex[gi, 0] = g.tex_builtin
            geom_tex[gi, 1:4] = g.tex_rgb1
            geom_tex[gi, 4:7] = g.tex_rgb2
            geom_tex[gi, 7:10] = g.tex_markrgb
            geom_tex[gi, 10] = g.tex_random
            geom_types.append(g.type)
            geom_name2idx[g.full_identifier] = gi

        # --- body inertial properties from geoms ---
        body_mass = np.zeros(nb, f32)
        body_ipos = np.zeros((nb, 3), f32)
        body_iquat = np.zeros((nb, 4), f32)
        body_iquat[:, 0] = 1.0
        body_inertia = np.zeros((nb, 3), f32)
        for i, b in enumerate(ordered):
            mass, ipos, iquat, diag = _combine_geom_inertia(b.geoms)
            bid = i + 1
            body_mass[bid] = max(mass, _BOUND_MASS)
            body_ipos[bid] = ipos
            body_iquat[bid] = iquat
            body_inertia[bid] = np.maximum(diag, _BOUND_INERTIA)

        # --- actuators ---
        nu = len(self.actuators)
        kind_codes = {
            "motor": ActKind.MOTOR,
            "position": ActKind.POSITION,
            "velocity": ActKind.VELOCITY,
            "intvelocity": ActKind.INTVELOCITY,
            "damper": ActKind.DAMPER,
            "adhesion": ActKind.ADHESION,
            "cylinder": ActKind.CYLINDER,
            "muscle": ActKind.MUSCLE,
        }
        act_kind = np.zeros(nu, i32)
        act_hinge = -np.ones(nu, i32)
        act_body = -np.ones(nu, i32)
        act_gain = np.ones(nu, f32)
        act_kv = np.zeros(nu, f32)
        act_ctrlrange = np.zeros((nu, 2), f32)
        act_ctrllimited = np.zeros(nu, f32)
        act_forcerange = np.zeros((nu, 2), f32)
        act_forcelimited = np.zeros(nu, f32)
        act_actadr = -np.ones(nu, i32)
        act_dynprm = np.zeros((nu, 3), f32)
        # MuJoCo muscle gainprm defaults:
        # (range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax)
        act_muscleprm = np.tile(
            np.array([0.75, 1.05, -1.0, 200.0, 0.5, 1.6, 1.5, 1.3, 1.2], f32),
            (nu, 1),
        )
        act_lengthrange = np.tile(np.array([-1.5, 1.5], f32), (nu, 1))
        act_name2idx = {}
        na = 0
        for ai, a in enumerate(self.actuators):
            act_kind[ai] = kind_codes[a.kind]
            if a.joint is not None:
                act_hinge[ai] = hinge_name2idx[a.joint]
            if a.body is not None:
                act_body[ai] = body_id[a.body]
            act_gain[ai] = a.gain
            act_kv[ai] = a.kv
            if a.ctrlrange is not None:
                act_ctrlrange[ai] = a.ctrlrange
                act_ctrllimited[ai] = 1.0
            if a.forcerange is not None and a.forcelimited:
                act_forcerange[ai] = a.forcerange
                act_forcelimited[ai] = 1.0
            if kind_codes[a.kind] in (
                ActKind.INTVELOCITY,
                ActKind.CYLINDER,
                ActKind.MUSCLE,
            ):
                act_actadr[ai] = na
                na += 1
            if a.kind == "cylinder":
                act_dynprm[ai] = (1.0, 0.0, 0.0)  # MuJoCo cylinder timeconst
            elif a.kind == "muscle":
                act_dynprm[ai] = (0.01, 0.04, 0.0)  # tau_act, tau_deact
            if a.dynprm is not None:
                act_dynprm[ai, : len(a.dynprm)] = a.dynprm
            if a.muscleprm is not None:
                act_muscleprm[ai, : len(a.muscleprm)] = a.muscleprm
            if a.lengthrange is not None:
                act_lengthrange[ai] = a.lengthrange
            act_name2idx[a.full_identifier] = ai

        # --- contact candidate table ---
        sensor_slots = {
            s.full_identifier: si for si, s in enumerate(self.contact_sensors)
        }
        can_rows = []
        pair_rows = []  # capsule-capsule rows (appended after ground rows)
        for pair in self.pairs:
            g1 = geom_name2idx[pair.geom1]
            g2 = geom_name2idx[pair.geom2]
            if geom_types[g2] != "plane":
                # Capsule-capsule pair (fly-fly contact): one closest-point
                # contact per geom pair, solved with the same pyramid rows
                # as ground contacts (reference multi-fly worlds rely on
                # MuJoCo's capsule-capsule collider; ``world.py:95-149``).
                if geom_types[g1] not in ("capsule", "sphere") or geom_types[
                    g2
                ] not in ("capsule", "sphere"):
                    raise NotImplementedError(
                        "Contact pairs support capsule/sphere vs plane or "
                        f"capsule/sphere (got {geom_types[g1]} vs "
                        f"{geom_types[g2]})"
                    )
                pair_rows.append(
                    (
                        g1,
                        geom_body[g1],
                        g2,
                        geom_body[g2],
                        (pair.friction[0], pair.friction[2], pair.friction[3]),
                        pair.solref,
                        pair.solimp,
                        pair.margin,
                    )
                )
                continue
            gtype = geom_types[g1]
            if gtype == "capsule":
                ends = (-1.0, 1.0)
            elif gtype == "sphere":
                ends = (0.0,)
            else:
                raise NotImplementedError(
                    f"Unsupported collision geom type: {gtype}"
                )
            bid = geom_body[g1]
            # Sensor slot: first sensor whose subtree contains this body.
            sensor_idx = -1
            for s in self.contact_sensors:
                root = body_id[s.subtree_body]
                if body_subtree_mask[root, bid] > 0 and (
                    geom_name2idx[s.geom2] == g2
                ):
                    sensor_idx = sensor_slots[s.full_identifier]
                    break
            # Adhesion actuator acting on this body, if any.
            adh_idx = -1
            for ai, a in enumerate(self.actuators):
                if a.kind == "adhesion" and act_body[ai] == bid:
                    adh_idx = ai
                    break
            for end in ends:
                can_rows.append(
                    (
                        g1,
                        bid,
                        end,
                        (pair.friction[0], pair.friction[2], pair.friction[3]),
                        pair.solref,
                        pair.solimp,
                        pair.margin,
                        adh_idx,
                        sensor_idx,
                    )
                )
        ncand_pair = len(pair_rows)
        ncand = len(can_rows) + ncand_pair
        can_geom = np.zeros(ncand, i32)
        can_body = np.zeros(ncand, i32)
        can_geom2 = -np.ones(ncand, i32)
        can_body2 = np.zeros(ncand, i32)  # 0 = world (ground rows)
        can_end = np.zeros(ncand, f32)
        can_friction = np.zeros((ncand, 3), f32)
        can_solref = np.zeros((ncand, 2), f32)
        can_solimp = np.zeros((ncand, 5), f32)
        can_margin = np.zeros(ncand, f32)
        can_adh_act = -np.ones(ncand, i32)
        can_sensor = -np.ones(ncand, i32)
        for ci, row in enumerate(can_rows):
            (
                can_geom[ci],
                can_body[ci],
                can_end[ci],
                can_friction[ci],
                can_solref[ci],
                can_solimp[ci],
                can_margin[ci],
                can_adh_act[ci],
                can_sensor[ci],
            ) = row
        for pi, row in enumerate(pair_rows):
            ci = len(can_rows) + pi
            (
                can_geom[ci],
                can_body[ci],
                can_geom2[ci],
                can_body2[ci],
                can_friction[ci],
                can_solref[ci],
                can_solimp[ci],
                can_margin[ci],
            ) = row

        # --- sites ---
        site_entries = []
        site_name2idx = {}
        for b in ordered:
            for s in b.sites:
                site_name2idx[s.full_identifier] = len(site_entries)
                site_entries.append((body_id[b.full_identifier], s))
        nsite = len(site_entries)
        site_body = np.zeros(nsite, i32)
        site_pos = np.zeros((nsite, 3), f32)
        for si, (bid, s) in enumerate(site_entries):
            site_body[si] = bid
            site_pos[si] = s.pos

        # --- neutral keyframe ---
        qpos0 = np.zeros(nq, f32)
        for bid, qa, _va in free_joints:
            qpos0[qa + 3] = 1.0  # identity quat default
        for joint_name, values in self.neutral_joint_qpos.items():
            if joint_name not in joint_qadr:
                raise FlyGymInternalError(
                    f"Neutral state for unknown joint '{joint_name}'"
                )
            adr = joint_qadr[joint_name]
            values = np.atleast_1d(np.asarray(values, f32))
            qpos0[adr : adr + len(values)] = values
        ctrl0 = np.zeros(nu, f32)
        for act_name, value in self.neutral_ctrl.items():
            ctrl0[act_name2idx[act_name]] = value

        # Model-wide contact dimensionality (static pyramid-row count).
        condims = {p.condim for p in self.pairs} or {3}
        bad = condims - {1, 3, 4, 6}
        if bad:
            raise ValueError(f"Unsupported condim values: {sorted(bad)}")
        condim = max(condims)
        if len(condims) > 1:
            import warnings

            warnings.warn(
                f"Mixed pair condims {sorted(condims)}: compiling all "
                f"contacts at condim {condim} (row counts are static); "
                "per-pair friction coefficients are still honored."
            )
        nrows_per_con = {1: 1, 3: 4, 4: 6, 6: 10}[condim]

        # Pair-row groups: contiguous runs sharing geom1 AND contact params
        # (the nested loops in add_fly_fly_contacts emit them geom1-major;
        # splitting on param boundaries keeps two add_fly_fly_contacts
        # calls with different friction in separate groups — the kernel's
        # winner-blend assumes one param set per group). Used by the
        # nearest-neighbor pair compression (engine/contact.py and the
        # mega-kernel): each group contributes only its closest geom2.
        def _pair_root(b):
            b = int(b)
            while b != 0 and int(body_parent[b]) != 0:
                b = int(body_parent[b])
            return b

        pair_groups = []
        if ncand_pair:
            def _gkey(row):
                g1, _b1, _g2, b2, fric, solref, solimp, margin = row
                # geom2's ROOT subtree is part of the key: with N >= 3
                # flies, consecutive add_fly_fly_contacts calls can start
                # and end on the same geom1, and a group must never mix
                # members from two different opposing flies (the
                # compression contract is one winner per geom1 PER
                # OPPOSING FLY, and the winner masks assume one geom2
                # tree per group).
                return (
                    g1,
                    _pair_root(b2),
                    fric,
                    tuple(solref),
                    tuple(solimp),
                    margin,
                )

            run_start, run_key = 0, _gkey(pair_rows[0])
            for i in range(1, ncand_pair):
                key = _gkey(pair_rows[i])
                if key != run_key:
                    pair_groups.append((run_start, i - run_start))
                    run_start, run_key = i, key
            pair_groups.append((run_start, ncand_pair - run_start))
        pc_opt = self.options.get("pair_compress")
        pair_compress = (ncand_pair >= 512) if pc_opt is None else bool(pc_opt)
        if pair_compress and len(pair_groups) >= ncand_pair:
            pair_compress = False  # one row per group: nothing to compress
        if pair_compress:
            # Compression blends each group's winner with STATIC per-DoF
            # Jacobian signs, which assumes geom1 and every geom2 live in
            # DISJOINT kinematic trees (fly-fly contacts). Self-contact
            # pairs (same root subtree) would blend wrong signs — fall
            # back to uncompressed pair rows instead of asserting deep in
            # the kernel builder (ADVICE r3: megastep.py _Static).
            same_tree = any(
                _pair_root(row[1]) == _pair_root(row[3]) for row in pair_rows
            )
            if same_tree:
                import warnings

                warnings.warn(
                    "pair_compress disabled: a contact pair's geoms share "
                    "a kinematic tree (self-contact); nearest-neighbor "
                    "compression assumes disjoint trees (fly-fly). All "
                    f"{ncand_pair} pair rows run uncompressed."
                )
                pair_compress = False

        ncon_max = self.options["ncon_max"]
        if ncon_max is None:
            # Auto: 16 contact slots per root subtree (a fly touches the
            # ground with at most ~12 capsule ends during locomotion).
            n_roots = max(sum(1 for b in self.bodies if b.parent is None), 1)
            ncon_max = 16 * n_roots
        ncand_eff = (
            (ncand - ncand_pair) + len(pair_groups) if pair_compress else ncand
        )
        ncon = min(int(ncon_max), ncand_eff) if ncand else 0
        if (
            self.options.get("differentiable")
            and ncand
            and ncon < ncand_eff
        ):
            import warnings

            warnings.warn(
                f"differentiable mode with ncon={ncon} < {ncand_eff} "
                "candidate rows: the top-K contact selection is a "
                "non-differentiable kink and can chatter frame-to-frame "
                "in dense scenes; consider raising options['ncon_max'] "
                "to the full candidate count."
            )
        ref_body = free_joints[0][0] if free_joints else min(nb - 1, 1)

        weld_rows = []
        for wbody, wpos, wquat, wsolref, wsolimp in self.welds:
            bid = body_id[wbody]
            for fb, fqadr, fvadr in free_joints:
                if fb == bid:
                    weld_rows.append(
                        (bid, fqadr, fvadr, tuple(wpos), tuple(wquat),
                         tuple(wsolref), tuple(wsolimp))
                    )
                    break
            else:
                raise ValueError(
                    f"Weld target {wbody!r} has no free root joint."
                )

        static = dict(
            nbody=nb,
            nq=nq,
            nv=nv,
            nu=nu,
            na=na,
            nhinge=nh,
            nsite=nsite,
            ngeom=ng,
            ncand=ncand,
            ncand_pair=ncand_pair,
            pair_groups=tuple(pair_groups),
            pair_compress=pair_compress,
            ncon=ncon,
            condim=condim,
            nsensor_contact=len(self.contact_sensors),
            timestep=float(self.options["timestep"]),
            solver_type=str(self.options["solver"]),
            solver_iterations=int(self.options["solver_iterations"]),
            solver_exact=bool(self.options.get("solver_exact", False)),
            solver_relaxation=float(self.options["solver_relaxation"]),
            differentiable=bool(self.options.get("differentiable", False)),
            levels=levels,
            ancestor_jumps=ancestor_jumps,
            ref_body=int(ref_body),
            free_joints=tuple(free_joints),
            dof_height_levels=dof_height_levels,
            dof_depth_levels=dof_depth_levels,
            dof_chains=tuple(tuple(c) for c in dof_chains),
            geom_types=tuple(geom_types),
            has_hfield=self.hfield is not None,
            welds=tuple(weld_rows),
        )
        fields = dict(
            gravity=_as_jnp(self.options["gravity"], f32),
            body_parent=body_parent,
            body_pos=body_pos,
            body_quat=body_quat,
            body_mass=body_mass,
            body_ipos=body_ipos,
            body_iquat=body_iquat,
            body_inertia=body_inertia,
            body_hinge_idx=body_hinge_idx,
            body_free_qadr=body_free_qadr,
            body_free_vadr=body_free_vadr,
            body_subtree_mask=body_subtree_mask,
            hinge_body=hinge_body,
            hinge_slot=hinge_slot,
            hinge_axis=hinge_axis,
            hinge_qadr=hinge_qadr,
            hinge_vadr=hinge_vadr,
            hinge_stiffness=hinge_stiffness,
            hinge_damping=hinge_damping,
            hinge_springref=hinge_springref,
            dof_body=dof_body,
            dof_armature=dof_armature,
            dof_damping=dof_damping,
            dof_ancestor_mask=dof_ancestor_mask,
            dof_anc=dof_anc,
            geom_body=geom_body,
            geom_pos=geom_pos,
            geom_quat=geom_quat,
            geom_size=geom_size,
            geom_rgba=geom_rgba,
            geom_matprops=geom_matprops,
            geom_tex=geom_tex,
            can_geom=can_geom,
            can_body=can_body,
            can_geom2=can_geom2,
            can_body2=can_body2,
            can_end=can_end,
            can_friction=can_friction,
            can_solref=can_solref,
            can_solimp=can_solimp,
            can_margin=can_margin,
            can_adh_act=can_adh_act,
            can_sensor=can_sensor,
            can_invweight=np.ones((ncand, nrows_per_con), f32),
            ground_pos=np.zeros(3, f32),
            ground_normal=np.asarray([0.0, 0.0, 1.0], f32),
            hfield_data=_as_jnp(
                self.hfield["data"] if self.hfield else np.zeros((2, 2)), f32
            ),
            hfield_xy0=_as_jnp(
                self.hfield["xy0"] if self.hfield else (-1.0, -1.0), f32
            ),
            hfield_cell=_as_jnp(
                self.hfield["cell"] if self.hfield else (1.0, 1.0), f32
            ),
            act_kind=act_kind,
            act_hinge=act_hinge,
            act_body=act_body,
            act_gain=act_gain,
            act_kv=act_kv,
            act_ctrlrange=act_ctrlrange,
            act_ctrllimited=act_ctrllimited,
            act_forcerange=act_forcerange,
            act_forcelimited=act_forcelimited,
            act_actadr=act_actadr,
            act_dynprm=act_dynprm,
            act_muscleprm=act_muscleprm,
            act_lengthrange=act_lengthrange,
            act_acc0=np.ones((nu,), f32),
            site_body=site_body,
            site_pos=site_pos,
            qpos0=qpos0,
            ctrl0=ctrl0,
        )
        arrays = {f"model.{k}": _as_jnp(v) for k, v in fields.items()}
        meta = {"model": json.loads(json.dumps(static)), "flies": {}}

        from flygym_tpu_torch.compose.bridge import physics_model
        from flygym_tpu_torch.engine import contact
        from flygym_tpu_torch.engine.model import make_initial_state

        model = physics_model(arrays, meta["model"])
        if ncand:
            # Constraint inverse weights at the neutral pose (the analog of
            # MuJoCo's compile-time body_invweight0).
            arrays["model.can_invweight"] = (
                contact.compute_candidate_invweight(model).numpy()
            )
        if any(a.kind == "muscle" for a in self.actuators):
            # acc0: |qacc| per unit actuator force at qpos0 (MuJoCo's
            # compile-time acceleration scaling for muscle peak force).
            arrays["model.act_acc0"] = contact.compute_actuator_acc0(model).numpy()
        state = make_initial_state(model, fused=True)
        for f in type(state).__dataclass_fields__:
            arrays[f"state.{f}"] = getattr(state, f)[0].numpy()

        names = dict(
            body_name2id=body_id,
            hinge_name2id={k: int(v) for k, v in hinge_name2idx.items()},
            hinge_qadr={k: int(hinge_qadr[v]) for k, v in hinge_name2idx.items()},
            hinge_vadr={k: int(hinge_vadr[v]) for k, v in hinge_name2idx.items()},
            actuator_name2id=act_name2idx,
            site_name2id=site_name2idx,
            geom_name2id=geom_name2idx,
            sensor_name2slot=sensor_slots,
            joint_qadr=joint_qadr,
        )
        return arrays, meta, names

    # ------------------------------------------------------------------
    # MJCF export (cross-validation + save_xml_with_assets parity)
    # ------------------------------------------------------------------

    def to_mjcf_xml(self) -> str:
        """Emit the compiled model as MJCF XML.

        Bodies carry explicit <inertial> elements and primitive collision
        geoms, so MuJoCo reproduces exactly the same physical model without
        any mesh assets — this is the golden-test bridge.
        """
        compiled = self.compile()
        m = compiled.model
        fetched = {
            name: getattr(m, name).numpy()
            for name in ("body_parent", "body_pos", "body_quat", "body_mass", "body_ipos",
                         "body_iquat", "body_inertia", "geom_body", "geom_pos", "geom_quat",
                         "geom_size", "geom_rgba", "hinge_body", "hinge_axis", "site_body",
                         "site_pos", "qpos0", "ctrl0")
        }
        body_parent = fetched["body_parent"]
        body_pos = fetched["body_pos"]
        body_quat = fetched["body_quat"]
        body_mass = fetched["body_mass"]
        body_ipos = fetched["body_ipos"]
        body_iquat = fetched["body_iquat"]
        body_inertia = fetched["body_inertia"]
        geom_body = fetched["geom_body"]
        geom_pos = fetched["geom_pos"]
        geom_quat = fetched["geom_quat"]
        geom_size = fetched["geom_size"]
        geom_rgba = fetched["geom_rgba"]
        hinge_axis_arr = fetched["hinge_axis"]

        id2name = {v: k for k, v in compiled.body_name2id.items()}
        id2geom = {v: k for k, v in compiled.geom_name2id.items()}

        out = io.StringIO()
        w = out.write
        g = self.options["gravity"]
        w(f'<mujoco model="{self.name}">\n')
        w('  <compiler angle="radian" autolimits="true" '
          f'boundmass="{_BOUND_MASS}" boundinertia="{_BOUND_INERTIA}">'
          '<lengthrange mode="none"/></compiler>\n')
        w(
            f'  <option timestep="{self.options["timestep"]}" '
            f'gravity="{g[0]} {g[1]} {g[2]}" integrator="Euler" '
            'solver="Newton" iterations="100"/>\n'
        )
        if self.hfield is not None:
            _hd = np.asarray(self.hfield["data"], np.float64)
            _nr, _nc = _hd.shape
            _sx = (_nc - 1) * float(self.hfield["cell"][0]) / 2.0
            _sy = (_nr - 1) * float(self.hfield["cell"][1]) / 2.0
            _ztop = max(float(_hd.max()) - float(_hd.min()), 1e-6)
            _elev = " ".join(
                f"{x:.8g}"
                for x in ((_hd - float(_hd.min())) / _ztop).ravel()
            )
            w(
                f'  <asset><hfield name="terrain_hf" nrow="{_nr}" '
                f'ncol="{_nc}" size="{_sx:.8g} {_sy:.8g} {_ztop:.8g} 1" '
                f'elevation="{_elev}"/></asset>\n'
            )

        # Joint name → spec lookup for attributes.
        joint_specs = {}
        free_names = {}
        for b in self.bodies:
            for j in b.joints:
                if j.type == "free":
                    free_names[compiled.body_name2id[b.full_identifier]] = (
                        j.full_identifier
                    )
                else:
                    joint_specs[j.full_identifier] = j
        hingeidx2name = {v: k for k, v in compiled.hinge_name2id.items()}
        body_hinges = {}
        hinge_body = fetched["hinge_body"]
        for k in range(m.nhinge):
            body_hinges.setdefault(int(hinge_body[k]), []).append(k)

        geoms_by_body = {}
        for gi in range(m.ngeom):
            geoms_by_body.setdefault(int(geom_body[gi]), []).append(gi)

        site_body = fetched["site_body"]
        site_pos_arr = fetched["site_pos"]
        sites_by_body = {}
        siteidx2name = {v: k for k, v in compiled.site_name2id.items()}
        for si in range(m.nsite):
            sites_by_body.setdefault(int(site_body[si]), []).append(si)

        # Heightfield terrain: the engine's ground candidates sample the
        # height grid (engine/terrain.py), so the exported ground geom must
        # BE the heightfield for MuJoCo's explicit pairs to collide with
        # it. MuJoCo normalizes elevation data to [0, 1] and scales by
        # size[2]; pos z = min height re-anchors the surface. Grid axes:
        # data row = y, col = x in both engines.
        hf = self.hfield
        if hf is not None:
            hdata = np.asarray(hf["data"], np.float64)
            nr_h, nc_h = hdata.shape
            cell_x, cell_y = float(hf["cell"][0]), float(hf["cell"][1])
            sx = (nc_h - 1) * cell_x / 2.0
            sy = (nr_h - 1) * cell_y / 2.0
            zmin = float(hdata.min())
            hf_center = (float(hf["xy0"][0]) + sx, float(hf["xy0"][1]) + sy)

        def write_geom(gi, indent):
            gname = id2geom[gi]
            gtype = m.geom_types[gi]
            size = geom_size[gi]
            rgba = " ".join(f"{x:.4g}" for x in geom_rgba[gi])
            if gtype == "plane" and hf is not None and int(geom_body[gi]) == 0:
                w(
                    f'{indent}<geom name="{gname}" type="hfield" '
                    f'hfield="terrain_hf" '
                    f'pos="{hf_center[0]:.8g} {hf_center[1]:.8g} {zmin:.8g}" '
                    f'contype="0" conaffinity="0" rgba="{rgba}"/>\n'
                )
            elif gtype == "plane":
                w(
                    f'{indent}<geom name="{gname}" type="plane" '
                    f'size="{size[0]} {size[1]} 1" contype="0" '
                    f'conaffinity="0" rgba="{rgba}"/>\n'
                )
            else:
                pos = " ".join(f"{x:.8g}" for x in geom_pos[gi])
                quat = " ".join(f"{x:.8g}" for x in geom_quat[gi])
                if gtype == "capsule":
                    size_str = f"{size[0]:.8g} {size[1]:.8g}"
                elif gtype == "sphere":
                    size_str = f"{size[0]:.8g}"
                else:
                    size_str = " ".join(f"{x:.8g}" for x in size)
                w(
                    f'{indent}<geom name="{gname}" type="{gtype}" '
                    f'pos="{pos}" quat="{quat}" size="{size_str}" '
                    f'contype="0" conaffinity="0" rgba="{rgba}"/>\n'
                )

        def write_body(bid, indent):
            name = id2name[bid]
            pos = " ".join(f"{x:.8g}" for x in body_pos[bid])
            quat = " ".join(f"{x:.8g}" for x in body_quat[bid])
            w(f'{indent}<body name="{name}" pos="{pos}" quat="{quat}">\n')
            inner = indent + "  "
            if bid in free_names:
                w(f'{inner}<freejoint name="{free_names[bid]}"/>\n')
            for k in body_hinges.get(bid, []):
                jname = hingeidx2name[k]
                spec = joint_specs[jname]
                axis = " ".join(f"{x:.8g}" for x in hinge_axis_arr[k])
                w(
                    f'{inner}<joint name="{jname}" type="hinge" axis="{axis}" '
                    f'stiffness="{spec.stiffness}" damping="{spec.damping}" '
                    f'armature="{spec.armature}" springref="{spec.springref}"/>\n'
                )
            ip = " ".join(f"{x:.8g}" for x in body_ipos[bid])
            iq = " ".join(f"{x:.8g}" for x in body_iquat[bid])
            di = " ".join(f"{x:.8g}" for x in body_inertia[bid])
            w(
                f'{inner}<inertial pos="{ip}" quat="{iq}" '
                f'mass="{body_mass[bid]:.10g}" diaginertia="{di}"/>\n'
            )
            for gi in geoms_by_body.get(bid, []):
                write_geom(gi, inner)
            for si in sites_by_body.get(bid, []):
                spos = " ".join(f"{x:.8g}" for x in site_pos_arr[si])
                w(f'{inner}<site name="{siteidx2name[si]}" pos="{spos}"/>\n')
            for child in np.nonzero(body_parent == bid)[0]:
                if child != 0 and child != bid:
                    write_body(int(child), inner)
            w(f"{indent}</body>\n")

        w("  <worldbody>\n")
        for gi in geoms_by_body.get(0, []):
            write_geom(gi, "    ")
        for child in np.nonzero(body_parent == 0)[0]:
            if child != 0:
                write_body(int(child), "    ")
        w("  </worldbody>\n")

        if self.welds:
            w("  <equality>\n")
            for wbody, _wpos, _wquat, wsolref, wsolimp in self.welds:
                # All-zero relpose quaternion = "weld at the qpos0 relative
                # pose" (MuJoCo semantics); qpos0 is the spawn pose here.
                sr = " ".join(str(x) for x in wsolref)
                si2 = " ".join(str(x) for x in wsolimp)
                w(
                    f'    <weld body1="{wbody}" body2="world" '
                    f'relpose="0 0 0 0 0 0 0" '
                    f'solref="{sr}" solimp="{si2}"/>\n'
                )
            w("  </equality>\n")

        if self.pairs:
            w("  <contact>\n")
            for pair in self.pairs:
                fr = " ".join(str(x) for x in pair.friction)
                sr = " ".join(str(x) for x in pair.solref)
                si_ = " ".join(str(x) for x in pair.solimp)
                w(
                    f'    <pair geom1="{pair.geom1}" geom2="{pair.geom2}" '
                    f'condim="{pair.condim}" '
                    f'friction="{fr}" solref="{sr}" solimp="{si_}" '
                    f'margin="{pair.margin}"/>\n'
                )
            w("  </contact>\n")

        if self.actuators:
            w("  <actuator>\n")
            for a in self.actuators:
                attrs = [f'name="{a.full_identifier}"']
                if a.joint:
                    attrs.append(f'joint="{a.joint}"')
                if a.ctrlrange is not None:
                    attrs.append(
                        f'ctrlrange="{a.ctrlrange[0]} {a.ctrlrange[1]}"'
                    )
                if a.forcelimited and a.forcerange is not None:
                    attrs.append(
                        'forcelimited="true" '
                        f'forcerange="{a.forcerange[0]} {a.forcerange[1]}"'
                    )
                if a.kind == "position":
                    attrs.append(f'kp="{a.gain}"')
                    if a.kv:
                        attrs.append(f'kv="{a.kv}"')
                    w(f"    <position {' '.join(attrs)}/>\n")
                elif a.kind == "velocity":
                    attrs.append(f'kv="{a.gain}"')
                    w(f"    <velocity {' '.join(attrs)}/>\n")
                elif a.kind == "adhesion":
                    attrs.append(f'body="{a.body}" gain="{a.gain}"')
                    w(f"    <adhesion {' '.join(attrs)}/>\n")
                elif a.kind == "motor":
                    attrs.append(f'gear="{a.gain}"')
                    w(f"    <motor {' '.join(attrs)}/>\n")
                elif a.kind == "muscle":
                    # Emit as <general> with muscle gain/bias/dyn types; the
                    # golden tests set actuator_lengthrange/acc0 post-compile
                    # (estimation is disabled via <lengthrange mode=none>).
                    mp = a.muscleprm or (
                        0.75, 1.05, -1.0, 200.0, 0.5, 1.6, 1.5, 1.3, 1.2
                    )
                    dp = a.dynprm or (0.01, 0.04, 0.0)
                    gp = " ".join(str(x) for x in mp)
                    w(
                        f"    <general {' '.join(attrs)} dyntype=\"muscle\" "
                        f'gaintype="muscle" biastype="muscle" '
                        f'dynprm="{dp[0]} {dp[1]} {dp[2]}" '
                        f'gainprm="{gp}" biasprm="{gp}"/>\n'
                    )
                elif a.kind == "cylinder":
                    dp = a.dynprm or (1.0, 0.0, 0.0)
                    w(
                        f"    <cylinder {' '.join(attrs)} area=\"{a.gain}\" "
                        f'timeconst="{dp[0]}"/>\n'
                    )
                else:  # damper, intvelocity best-effort
                    w(f"    <{a.kind} {' '.join(attrs)}/>\n")
            w("  </actuator>\n")

        # Neutral keyframe.
        compiled_qpos0 = fetched["qpos0"]
        compiled_ctrl0 = fetched["ctrl0"]
        qpos_str = " ".join(f"{x:.8g}" for x in compiled_qpos0)
        ctrl_str = " ".join(f"{x:.8g}" for x in compiled_ctrl0)
        w("  <keyframe>\n")
        w(f'    <key name="neutral" time="0" qpos="{qpos_str}"')
        if m.nu:
            w(f' ctrl="{ctrl_str}"')
        w("/>\n  </keyframe>\n")
        w("</mujoco>\n")
        return out.getvalue()


def _as_jnp(x, dtype=None) -> np.ndarray:
    """``np.asarray(jnp.asarray(x, dtype))`` with x64 off: float64 becomes
    float32 and int64 int32, each value rounded once."""
    a = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _normalize(quat) -> np.ndarray:
    q = np.asarray(quat, np.float64)
    return q / np.linalg.norm(q)


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _analytic_inertia(g: GeomSpec):
    """Unit inertial properties for primitive geoms (about geom frame)."""
    m = g.mass
    if g.type == "sphere":
        r = g.size[0]
        i = 0.4 * m * r * r
        return np.array([i, i, i])
    if g.type == "capsule":
        r, h = g.size[0], g.size[1]  # radius, half-length of cylinder part
        # cylinder part + two hemispheres (mass split by volume)
        v_cyl = np.pi * r * r * (2 * h)
        v_sph = 4 / 3 * np.pi * r**3
        m_cyl = m * v_cyl / (v_cyl + v_sph)
        m_sph = m - m_cyl
        izz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ixx = (
            m_cyl * (r * r / 4 + h * h / 3)
            + m_sph * (0.4 * r * r + h * h + 0.75 * h * r)
        )
        return np.array([ixx, ixx, izz])
    if g.type == "box":
        a, b, c = g.size
        return (
            m
            / 3.0
            * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
        )
    raise NotImplementedError(f"No analytic inertia for geom type {g.type}")


def _combine_geom_inertia(geoms: list[GeomSpec]):
    """Combine per-geom inertial data into body (mass, ipos, iquat, diag)."""
    if not geoms:
        return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)

    total_mass = 0.0
    com = np.zeros(3)
    parts = []  # (mass, com_in_body, inertia_about_its_com_in_body_frame)
    for g in geoms:
        if g.ipos is not None:
            # Derived data is expressed in the body frame already.
            ipos = np.asarray(g.ipos, np.float64)
            R = _quat_to_mat_np(_normalize(g.iquat))
            I_body = R @ np.diag(np.asarray(g.inertia_diag, np.float64)) @ R.T
            mass = g.mass
        else:
            R = _quat_to_mat_np(_normalize(g.quat))
            I_geom = np.diag(_analytic_inertia(g))
            I_body = R @ I_geom @ R.T
            ipos = np.asarray(g.pos, np.float64)
            mass = g.mass
        total_mass += mass
        com += mass * ipos
        parts.append((mass, ipos, I_body))

    if total_mass <= 0:
        return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
    com /= total_mass

    I_total = np.zeros((3, 3))
    for mass, ipos, I_body in parts:
        d = ipos - com
        I_total += I_body + mass * ((d @ d) * np.eye(3) - np.outer(d, d))

    eigval, eigvec = np.linalg.eigh(I_total)
    if np.linalg.det(eigvec) < 0:
        eigvec[:, 0] = -eigvec[:, 0]
    # eigh returns ascending; MuJoCo sorts descending — match MuJoCo.
    order = np.argsort(eigval)[::-1]
    eigval = eigval[order]
    eigvec = eigvec[:, order]
    if np.linalg.det(eigvec) < 0:
        eigvec[:, 2] = -eigvec[:, 2]
    iquat = _quat_from_mat_np(eigvec)
    return float(total_mass), com, iquat, np.maximum(eigval, 0.0)
