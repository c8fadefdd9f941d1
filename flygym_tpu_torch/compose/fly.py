"""The Fly model composer.

Port of ``flygym_tpu/compose/fly.py``, reading the port's own copies of the
assets (``flygym_tpu_torch/assets/model/``). Builds an articulated fly (69
body segments, up to 204 hinge DoFs) from the rigging/derived-geometry JSON
assets into a :class:`ModelSpec`, mirroring the reference's composition API (flygym ``compose/fly.py``): construct, then
``add_joints`` / ``add_actuators`` / ``add_joint_sites`` / ``add_leg_adhesion``
/ ``colorize`` / ``add_tracking_camera``.

Differences from the reference (as in the JAX package):
- Collision geometry is always the capsule fit (derived offline from the
  micro-CT meshes via ``scripts/dev/derive_assets.py``); mesh-vs-ground
  collision does not map well onto shape-static batched steps, and the
  reference itself exposes capsule fitting as its fast path
  (``GeomFittingOption``, fly.py:51-62,584-589). ``geom_fitting_option``
  instead selects which *inertial* data is used (mesh-derived vs capsule).
- The neutral keyframe is assembled lazily at compile() instead of recompiling
  the whole model after every ``add_*`` call (fly.py:653-655 recompiles every
  time; SURVEY.md §7 flags this as a pattern to avoid).
"""

import json
from fnmatch import filter as filter_with_wildcard
from enum import Enum
from os import PathLike
from typing import Any, Iterable

import numpy as np

from flygym_tpu_torch import assets_dir
from flygym_tpu_torch.anatomy import (
    ALL_SEGMENT_NAMES,
    LEGS,
    AnatomicalJoint,
    AxisOrder,
    BodySegment,
    JointDOF,
    JointPreset,
    RotationAxis,
    Skeleton,
)
from flygym_tpu_torch.compose.base import BaseCompositionElement
from flygym_tpu_torch.compose.pose import KinematicPose, KinematicPosePreset
from flygym_tpu_torch.compose.spec import (
    ActuatorSpec,
    BodySpec,
    CameraSpec,
    GeomSpec,
    JointSpec,
    ModelSpec,
    SiteSpec,
)
from flygym_tpu_torch.utils.exceptions import FlyGymInternalError
from flygym_tpu_torch.utils.math import Rotation3D, Vec3

__all__ = ["Fly", "ActuatorType", "MeshType", "GeomFittingOption"]

DEFAULT_RIGGING_CONFIG_PATH = assets_dir / "model/rigging.json"
DEFAULT_GEOMETRY_PATH = assets_dir / "model/derived_geometry.json"
DEFAULT_VISUALS_CONFIG_PATH = assets_dir / "model/visuals.json"


class MeshType(Enum):
    """Mesh resolution used when the capsule/inertia data was derived.

    Kept for API parity with the reference (``fly.py:38-48``); at runtime the
    engine consumes only the derived primitive geometry, not the meshes.
    """

    FULLSIZE = "fullsize"
    SIMPLIFIED_MAX2000FACES = "simplified_max2000faces"


class GeomFittingOption(Enum):
    """Which inertial data to use per segment (see module docstring).

    Attributes:
        UNMODIFIED: Mesh-derived inertia (claws still use capsule inertia,
            matching the reference where tarsus5 is always capsule-fitted).
        ALL_TO_CAPSULES: Capsule-fit inertia for every segment.
        CLAWS_TO_CAPSULES: Same as UNMODIFIED (tarsus5 → capsules).
    """

    UNMODIFIED = "unmodified"
    ALL_TO_CAPSULES = "all_to_capsules"
    CLAWS_TO_CAPSULES = "claws_to_capsules"


class ActuatorType(Enum):
    """Supported actuator types (MuJoCo semantics, ``fly.py:65-77``)."""

    MOTOR = "motor"
    POSITION = "position"
    VELOCITY = "velocity"
    INTVELOCITY = "intvelocity"
    DAMPER = "damper"
    CYLINDER = "cylinder"
    MUSCLE = "muscle"
    ADHESION = "adhesion"


class Fly(BaseCompositionElement):
    """A complete fly: body segments, joints, actuators, sensors, cameras.

    Args:
        name: Identifier for this fly instance.
        rigging_config_path: JSON with per-segment pos/quat/mass.
        geometry_path: JSON with derived capsule fits and inertial data.
        mesh_basedir: Optional directory of per-segment STL meshes
            (``{mesh_type}/{segment}.stl`` with ``fullsize/`` fallback, or
            flat ``{segment}.stl`` — the reference's layout,
            ``fly.py:507-543``). When given, geometry (inertials + capsule
            fits) is derived from the meshes AT COMPOSE TIME (numpy,
            :mod:`flygym_tpu_torch.compose.meshes`) instead of loading ``geometry_path``;
            right-side segments are mirrored from left meshes when
            ``mirror_left2right``.
        root_segment: Root of the kinematic tree.
        mirror_left2right: Mirror left meshes to the right side. Without
            ``mesh_basedir`` this is baked into the derived geometry.
        mesh_type: Preferred mesh subdirectory when deriving from
            ``mesh_basedir``.
        geom_fitting_option: Inertial data selection (see class above).

    Attributes mirror the reference's mapping tables (``fly.py:109-135``),
    with spec elements in place of MJCF elements.
    """

    def __init__(
        self,
        name: str = "nmf",
        *,
        rigging_config_path: PathLike = DEFAULT_RIGGING_CONFIG_PATH,
        geometry_path: PathLike = DEFAULT_GEOMETRY_PATH,
        mesh_basedir: PathLike | None = None,
        root_segment: BodySegment | str = "c_thorax",
        mirror_left2right: bool = True,
        mesh_type: MeshType = MeshType.SIMPLIFIED_MAX2000FACES,
        geom_fitting_option: GeomFittingOption = GeomFittingOption.UNMODIFIED,
    ) -> None:
        self._name = name
        self._spec = ModelSpec(name)
        self.skeleton: Skeleton | None = None
        self.geom_fitting_option = GeomFittingOption(geom_fitting_option)

        self.bodyseg_to_specbody: dict[BodySegment, BodySpec] = {}
        self.bodyseg_to_specgeom: dict[BodySegment, GeomSpec] = {}
        self.jointdof_to_specjoint: dict[JointDOF, JointSpec] = {}
        self.jointdof_to_specactuator_by_type = {ty: {} for ty in ActuatorType}
        self.leg_to_adhesionactuator: dict[str, ActuatorSpec] = {}
        self.anatomicaljoint_to_specsites: dict[AnatomicalJoint, SiteSpec] = {}
        self.cameraname_to_speccamera: dict[str, CameraSpec] = {}

        self.jointdof_to_neutralangle: dict[JointDOF, float] = {}
        self.jointdof_to_neutralaction_by_type = {ty: {} for ty in ActuatorType}

        if isinstance(root_segment, str):
            root_segment = BodySegment(root_segment)
        self.root_segment = root_segment

        with open(rigging_config_path) as f:
            self._rigging = json.load(f)
        if mesh_basedir is not None:
            from flygym_tpu_torch.compose.meshes import derive_geometry_from_meshes

            self._geometry = derive_geometry_from_meshes(
                mesh_basedir,
                self._rigging,
                mesh_type=MeshType(mesh_type).value,
                mirror_left2right=mirror_left2right,
            )
        else:
            with open(geometry_path) as f:
                self._geometry = json.load(f)

        self._add_bodies_and_geoms()

    # Aliases matching the reference attribute names (fly.py:112-124).
    @property
    def bodyseg_to_mjcfbody(self):
        return self.bodyseg_to_specbody

    @property
    def bodyseg_to_mjcfgeom(self):
        return self.bodyseg_to_specgeom

    @property
    def jointdof_to_mjcfjoint(self):
        return self.jointdof_to_specjoint

    @property
    def jointdof_to_mjcfactuator_by_type(self):
        return self.jointdof_to_specactuator_by_type

    @property
    def anatomicaljoint_to_mjcfsites(self):
        return self.anatomicaljoint_to_specsites

    @property
    def cameraname_to_mjcfcamera(self):
        return self.cameraname_to_speccamera

    @property
    def spec(self) -> ModelSpec:
        return self._spec

    @property
    def name(self) -> str:
        """Name of this fly instance."""
        return self._name

    # ------------------------------------------------------------------
    # Canonical order contracts (fly.py:189-219)
    # ------------------------------------------------------------------

    def get_bodysegs_order(self) -> list[BodySegment]:
        """Canonical body segment order used by simulation readouts."""
        return list(self.bodyseg_to_specbody.keys())

    def get_jointdofs_order(self) -> list[JointDOF]:
        """Canonical joint DoF order used by simulation readouts."""
        return list(self.jointdof_to_specjoint.keys())

    def get_actuated_jointdofs_order(
        self, actuator_type: "ActuatorType | str"
    ) -> list[JointDOF]:
        """Canonical actuated-DoF order for control inputs of a given type."""
        actuator_type = ActuatorType(actuator_type)
        return list(self.jointdof_to_specactuator_by_type[actuator_type].keys())

    def get_legs_order(self) -> list[str]:
        """Canonical leg order (same as ``anatomy.LEGS``)."""
        return LEGS

    def get_sites_order(self) -> list[AnatomicalJoint]:
        """Canonical order of anatomical joints with sites."""
        return list(self.anatomicaljoint_to_specsites.keys())

    # ------------------------------------------------------------------
    # Composition steps
    # ------------------------------------------------------------------

    def add_joints(
        self,
        skeleton: Skeleton,
        neutral_pose: KinematicPose | KinematicPosePreset | None = None,
        *,
        stiffness: float = 10.0,
        damping: float = 0.5,
        armature: float = 1e-6,
        **kwargs: Any,
    ) -> dict[JointDOF, JointSpec]:
        """Add hinge joints per the skeleton (reference ``fly.py:221-299``).

        Right-side roll/yaw axes are flipped so rotations are defined
        symmetrically (positive roll is always "outward", fly.py:280-283).
        """
        if neutral_pose is None:
            neutral_lookup = {}
        elif isinstance(neutral_pose, KinematicPose):
            neutral_lookup = neutral_pose.joint_angles_lookup_rad
        elif isinstance(neutral_pose, KinematicPosePreset):
            pose = neutral_pose.get_pose_by_axis_order(skeleton.axis_order)
            neutral_lookup = pose.joint_angles_lookup_rad
        else:
            raise ValueError(
                "When specified, `neutral_pose` must be a "
                "`KinematicPose` or `KinematicPosePreset`."
            )

        self.skeleton = skeleton
        created = {}
        for jointdof in skeleton.iter_jointdofs(self.root_segment):
            child_body = self.bodyseg_to_specbody[jointdof.child]
            neutral_angle = neutral_lookup.get(jointdof.name, 0.0)
            self.jointdof_to_neutralangle[jointdof] = neutral_angle

            axis = np.asarray(jointdof.axis.to_vector(), float)
            if jointdof.child.pos[0] == "r" and jointdof.axis != RotationAxis.PITCH:
                axis = -axis

            joint = JointSpec(
                name=jointdof.name,
                type="hinge",
                axis=tuple(axis),
                stiffness=stiffness,
                damping=damping,
                armature=armature,
                springref=neutral_angle,
                extra=dict(kwargs),
            )
            child_body.add_joint(joint)
            created[jointdof] = joint
            self._spec.neutral_joint_qpos[joint.full_identifier] = [neutral_angle]

        self.jointdof_to_specjoint.update(created)
        return created

    def add_actuators(
        self,
        jointdofs: Iterable[JointDOF],
        actuator_type: "ActuatorType | str",
        neutral_input: (
            "dict[str, float] | KinematicPose | KinematicPosePreset | None"
        ) = None,
        *,
        forcelimited: bool = True,
        forcerange: tuple[float, float] = (-30.0, 30.0),
        **kwargs: Any,
    ) -> dict[JointDOF, ActuatorSpec]:
        """Add actuators on the given DoFs (reference ``fly.py:301-369``).

        ``kwargs`` accepts the MuJoCo-style gains: ``kp`` (position),
        ``kv`` (velocity feedback / velocity actuators), ``gear`` (motor).
        """
        actuator_type = ActuatorType(actuator_type)

        if neutral_input is None:
            neutral_input = {}
        if actuator_type == ActuatorType.POSITION:
            if isinstance(neutral_input, KinematicPose):
                neutral_input = neutral_input.joint_angles_lookup_rad
            elif isinstance(neutral_input, KinematicPosePreset):
                pose = neutral_input.get_pose_by_axis_order(self.skeleton.axis_order)
                neutral_input = pose.joint_angles_lookup_rad
        elif isinstance(neutral_input, (KinematicPose, KinematicPosePreset)):
            # The JAX package fails here with an AttributeError (it reads the
            # pose as a dict); a pose is a neutral input of position servos only.
            raise ValueError(
                f"neutral_input={neutral_input!r} is a pose, which only position "
                f"actuators take; {actuator_type.value} actuators take a dict of "
                "inputs by DoF name or None (make_model: pass neutral_pose=None)"
            )

        gain, kv = _actuator_gains(actuator_type, kwargs)

        created = {}
        for jointdof in jointdofs:
            self.jointdof_to_neutralaction_by_type[actuator_type][jointdof] = (
                neutral_input.get(jointdof.name, 0.0)
            )
            joint = self.jointdof_to_specjoint[jointdof]
            actuator = ActuatorSpec(
                name=f"{jointdof.name}-{actuator_type.value}",
                kind=actuator_type.value,
                joint=joint.full_identifier,
                gain=gain,
                kv=kv,
                ctrlrange=kwargs.get("ctrlrange"),
                forcerange=forcerange,
                forcelimited=forcelimited,
                dynprm=kwargs.get("dynprm"),
                muscleprm=kwargs.get("gainprm"),
                lengthrange=kwargs.get("lengthrange"),
                extra=dict(kwargs),
            )
            self._spec.actuators.append(actuator)
            created[jointdof] = actuator
            self._spec.neutral_ctrl[actuator.full_identifier] = neutral_input.get(
                jointdof.name, 0.0
            )
        self.jointdof_to_specactuator_by_type[actuator_type].update(created)
        return created

    def add_joint_sites(
        self, anatomical_joints: list[AnatomicalJoint]
    ) -> dict[AnatomicalJoint, SiteSpec]:
        """Add tracking sites at anatomical joint origins (``fly.py:371-405``)."""
        created = {}
        for joint in anatomical_joints:
            if joint in self.anatomicaljoint_to_specsites:
                raise ValueError(
                    f"A site has already been added for anatomical joint "
                    f"'{joint.name}'."
                )
            child_body = self.bodyseg_to_specbody[joint.child]
            # Body origins sit at their parent-child joints in this model.
            site = SiteSpec(name=joint.name, pos=(0.0, 0.0, 0.0))
            child_body.add_site(site)
            created[joint] = site
        self.anatomicaljoint_to_specsites.update(created)
        return created

    def add_leg_adhesion(
        self, gain: float | dict[str, float] = 1.0
    ) -> dict[str, ActuatorSpec]:
        """Add adhesion actuators on all tarsus5 segments (``fly.py:407-441``).

        Control input per leg ranges 1..100 (multiplied by the gain to give
        the maximum attraction force).
        """
        if self.leg_to_adhesionactuator:
            raise ValueError("Leg adhesion actuators have already been added.")
        for leg in LEGS:
            tarsus5 = BodySegment(f"{leg}_tarsus5")
            gain_this_leg = gain[leg] if isinstance(gain, dict) else gain
            actuator = ActuatorSpec(
                name=f"{tarsus5.name}-adhesion",
                kind="adhesion",
                body=self.bodyseg_to_specbody[tarsus5].full_identifier,
                gain=gain_this_leg,
                ctrlrange=(1.0, 100.0),
            )
            self._spec.actuators.append(actuator)
            self.leg_to_adhesionactuator[leg] = actuator
        return self.leg_to_adhesionactuator

    def colorize(
        self, visuals_config_path: PathLike = DEFAULT_VISUALS_CONFIG_PATH
    ) -> None:
        """Apply material colors to geoms (``fly.py:443-469``)."""
        if not self.bodyseg_to_specgeom:
            raise ValueError("Must first add geoms via `_add_bodies_and_geoms`.")
        vis_sets, lookup = self._parse_visuals_config(visuals_config_path)
        builtin_ids = {"flat": 1, "gradient": 2}
        for segment, geom in self.bodyseg_to_specgeom.items():
            vis_set_name = lookup[segment]
            params = vis_sets[vis_set_name]
            material = params["material"]
            rgba = list(material.get("rgba", (1, 1, 1, 1)))
            # Fold flat-texture base colors into the rgba so every rgba
            # consumer (retina, MJCF export, simple shading) sees the
            # material's effective base color; the raycaster's texture
            # stage handles gradients and random marks from the per-geom
            # texture table below.
            texture = params.get("texture")
            if texture and "rgb1" in texture:
                rgb1 = texture["rgb1"]
                rgba = [rgba[3] * 0 + c for c in rgb1] + [rgba[3]]
            geom.set_attributes(
                material=vis_set_name,
                rgba=tuple(rgba),
                specular=float(material.get("specular", 0.35)),
                shininess=float(material.get("shininess", 0.22)),
            )
            if texture:
                geom.set_attributes(
                    tex_builtin=builtin_ids.get(texture.get("builtin"), 1),
                    tex_rgb1=tuple(texture.get("rgb1", (1, 1, 1))),
                    tex_rgb2=tuple(
                        texture.get("rgb2", texture.get("rgb1", (1, 1, 1)))
                    ),
                    tex_markrgb=tuple(texture.get("markrgb", (0, 0, 0))),
                    tex_random=float(texture.get("random", 0.0)),
                )

    def add_tracking_camera(
        self,
        name: str = "trackcam",
        mode: str = "track",
        pos_offset: Vec3 = (0, -7.5, 6),
        rotation: Rotation3D = Rotation3D("xyaxes", (1, 0, 0, 0, 0.6, 0.8)),
        fovy: float = 30.0,
        **kwargs: Any,
    ) -> CameraSpec:
        """Add a camera tracking the fly's root body (``fly.py:471-505``)."""
        camera = CameraSpec(
            name=name,
            mode=mode,
            target=self.root_segment.name,
            pos=tuple(pos_offset),
            quat=tuple(rotation.as_quat_wxyz()),
            fovy=fovy,
            extra=dict(kwargs),
        )
        self._spec.cameras.append(camera)
        self.cameraname_to_speccamera[name] = camera
        return camera

    # ------------------------------------------------------------------
    # Internal builders
    # ------------------------------------------------------------------

    def _add_bodies_and_geoms(self) -> None:
        root_cfg = self._rigging[self.root_segment.name]
        body, geom = self._make_body_and_geom(None, self.root_segment, root_cfg)
        self.bodyseg_to_specbody[self.root_segment] = body
        self.bodyseg_to_specgeom[self.root_segment] = geom

        full_skeleton = Skeleton(
            joint_preset=JointPreset.ALL_POSSIBLE, axis_order=AxisOrder.DONTCARE
        )
        for jointdof in full_skeleton.iter_jointdofs(self.root_segment):
            if jointdof.axis != RotationAxis.PITCH:
                continue  # one visit per anatomical joint
            parent_body = self.bodyseg_to_specbody.get(jointdof.parent)
            if parent_body is None:
                raise FlyGymInternalError("Parent not found during tree DFS")
            cfg = self._rigging.get(jointdof.child.name)
            if cfg is None:
                raise FlyGymInternalError(
                    f"Missing rigging config for body segment {jointdof.child.name}"
                )
            body, geom = self._make_body_and_geom(
                parent_body.full_identifier, jointdof.child, cfg
            )
            self.bodyseg_to_specbody[jointdof.child] = body
            self.bodyseg_to_specgeom[jointdof.child] = geom

    def _make_body_and_geom(self, parent_name, segment: BodySegment, cfg):
        body = BodySpec(
            name=segment.name,
            parent=parent_name,
            pos=tuple(cfg["pos"]),
            quat=tuple(cfg["quat"]),
        )
        self._spec.add_body(body)

        geometry = self._geometry[segment.name]
        capsule = geometry["capsule"]
        # tarsus5 claws are always capsule-fitted, like the reference
        # (fly.py:584-589); otherwise the option decides the inertia source.
        use_capsule_inertia = (
            self.geom_fitting_option == GeomFittingOption.ALL_TO_CAPSULES
            or (segment.is_leg() and segment.link == "tarsus5")
        )
        inertia = geometry["capsule_inertia" if use_capsule_inertia else "mesh_inertia"]
        geom = GeomSpec(
            name=segment.name,
            type="capsule",
            size=tuple(capsule["size"]),
            pos=tuple(capsule["pos"]),
            quat=tuple(capsule["quat"]),
            mass=cfg["mass"],
            ipos=tuple(inertia["ipos"]),
            iquat=tuple(inertia["iquat"]),
            inertia_diag=tuple(inertia["diag"]),
        )
        body.add_geom(geom)
        return body, geom

    @staticmethod
    def _parse_visuals_config(visuals_config_path: PathLike):
        """Wildcard-matched visual set assignment (``fly.py:614-651``)."""
        with open(visuals_config_path) as f:
            vis_sets = json.load(f)
        matches_by_segname = {name: [] for name in ALL_SEGMENT_NAMES}
        for vis_set_name, params in vis_sets.items():
            apply_to = params.get("apply_to")
            material = params.get("material")
            if not apply_to or not material:
                raise ValueError(
                    f"Invalid visualization set: {vis_set_name}."
                    "Must specify a non-empty 'apply_to' and 'material'."
                )
            allowed = {"apply_to", "material", "texture"}
            if invalid := (set(params) - allowed):
                raise ValueError(
                    f"Invalid keys in visualization set {vis_set_name}: "
                    f"{invalid}. Must be one of {allowed}."
                )
            targets = set()
            patterns = [apply_to] if isinstance(apply_to, str) else apply_to
            for pattern in patterns:
                targets |= set(filter_with_wildcard(ALL_SEGMENT_NAMES, pattern))
            for segname in targets:
                matches_by_segname[segname].append(vis_set_name)
        for segname, names in matches_by_segname.items():
            if len(names) != 1:
                raise ValueError(
                    f"Zero or multiple vis sets matched for body segment "
                    f"{segname}: {names}. Only one should apply."
                )
        lookup = {
            BodySegment(segname): names[0]
            for segname, names in matches_by_segname.items()
        }
        return vis_sets, lookup


def _actuator_gains(actuator_type: ActuatorType, kwargs: dict) -> tuple[float, float]:
    """Map MuJoCo-style actuator kwargs to (gain, kv)."""
    if actuator_type == ActuatorType.POSITION:
        return float(kwargs.get("kp", 1.0)), float(kwargs.get("kv", 0.0))
    if actuator_type == ActuatorType.VELOCITY:
        return float(kwargs.get("kv", 1.0)), 0.0
    if actuator_type == ActuatorType.INTVELOCITY:
        return float(kwargs.get("kp", 1.0)), float(kwargs.get("kv", 0.0))
    if actuator_type == ActuatorType.DAMPER:
        return float(kwargs.get("kv", 1.0)), 0.0
    if actuator_type == ActuatorType.CYLINDER:
        area = kwargs.get("area")
        if area is None and (d := kwargs.get("diameter")) is not None:
            import math

            area = math.pi * d * d / 4.0
        return float(area if area is not None else 1.0), 0.0
    if actuator_type == ActuatorType.MUSCLE:
        return 1.0, 0.0  # muscle force comes from the FLV model
    return float(kwargs.get("gear", 1.0)), 0.0  # motor
