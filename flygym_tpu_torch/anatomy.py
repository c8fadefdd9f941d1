"""Anatomical definitions of the NeuroMechFly adult *Drosophila* body.

Provides the nomenclature (body segments, anatomical joints, rotational DoFs),
enum presets for configuring models, and the :class:`Skeleton` abstraction that
turns presets into a validated kinematic tree.

Port of ``flygym_tpu/anatomy.py``: pure host-side Python, the data layer that
the composition layer (:mod:`flygym_tpu_torch.compose`) consumes when
compiling a model.

Parity reference: flygym ``anatomy.py`` (constants :186-227, RotationAxis
:64-107, AxisOrder :133-183, BodySegment :230-299, JointDOF :302-349,
AnatomicalJoint :352-386, JointPreset :388-460, ActuatedDOFPreset :463-498,
ContactBodiesPreset :501-562, Skeleton :565-634).

Naming scheme
-------------
Segments are named ``{pos}_{link}``, e.g. ``lf_tibia`` (left-front tibia) or
``c_thorax`` (center thorax). Joint DoFs are named
``{parent}-{child}-{axis}``, e.g. ``c_thorax-lf_coxa-pitch``.
"""

from dataclasses import dataclass, field
from enum import Enum
from typing import Iterable, Iterator, TypeAlias

from flygym_tpu_torch.utils.exceptions import FlyGymInternalError
from flygym_tpu_torch.utils.math import Tree, orderedset

__all__ = [
    "RotationAxis",
    "AxesSet",
    "AxisOrder",
    "JointPreset",
    "ActuatedDOFPreset",
    "ContactBodiesPreset",
    "BodySegment",
    "JointDOF",
    "AnatomicalJoint",
    "Skeleton",
    "SIDES",
    "LEGS",
    "BODY_POSITIONS",
    "LEG_LINKS",
    "ANTENNA_LINKS",
    "PROBOSCIS_LINKS",
    "ABDOMEN_LINKS",
    "PASSIVE_TARSAL_LINKS",
    "ALL_CONNECTED_SEGMENT_PAIRS",
    "ALL_SEGMENT_NAMES",
]


# ---------------------------------------------------------------------------
# Rotation axes and axis orders
# ---------------------------------------------------------------------------

_AXIS_VECTORS = {"pitch": (0, 1, 0), "roll": (0, 0, 1), "yaw": (1, 0, 0)}
_AXIS_LETTERS = {"pitch": "y", "roll": "z", "yaw": "x"}


class RotationAxis(Enum):
    """A rotational joint axis: pitch, roll, or yaw.

    In the anatomical convention, pitch rotates about the local y axis, roll
    about the local z axis, and yaw about the local x axis. Single-letter
    aliases (``"p"``, ``"r"``, ``"y"``) are accepted when constructing from a
    string.
    """

    PITCH = "pitch"
    P = PITCH
    ROLL = "roll"
    R = ROLL
    YAW = "yaw"
    Y = YAW

    @classmethod
    def _missing_(cls, value):
        if isinstance(value, str):
            lowered = value.lower()
            for member in (cls.PITCH, cls.ROLL, cls.YAW):
                if lowered in (member.value, member.value[0]):
                    return member
        return super()._missing_(value)

    def to_vector(self) -> tuple[float, float, float]:
        """Unit rotation axis as an (x, y, z) tuple."""
        return _AXIS_VECTORS[self.value]

    def to_letter_xyz(self) -> str:
        """The Cartesian axis letter ('x', 'y', or 'z') this axis maps to."""
        return _AXIS_LETTERS[self.value]


RotationAxisLike: TypeAlias = RotationAxis | str


class AxesSet(set):
    """A set of :class:`RotationAxis`, coercing members from strings."""

    def __init__(self, iterable: Iterable | None = None, /):
        super().__init__(
            () if iterable is None else {RotationAxis(x) for x in iterable}
        )

    def add(self, value, /):
        axis = RotationAxis(value)  # coerce strings/aliases up front
        super().add(axis)

    def remove(self, value, /):
        super().remove(RotationAxis(value))


AxesSetLike: TypeAlias = AxesSet | Iterable[RotationAxisLike]


class AxisOrder(Enum):
    """Order in which single-axis DoFs are chained at multi-DoF joints.

    Euler-style rotations do not commute, so the order must be fixed and kept
    consistent with the convention of any experimental data used (e.g., the
    axis order used by inverse kinematics on motion capture).

    ``DONTCARE`` (an alias of ``PITCH_ROLL_YAW``) signals that the order is
    irrelevant for the operation at hand.
    """

    PITCH_ROLL_YAW = (RotationAxis.PITCH, RotationAxis.ROLL, RotationAxis.YAW)
    PRY = PITCH_ROLL_YAW
    PITCH_YAW_ROLL = (RotationAxis.PITCH, RotationAxis.YAW, RotationAxis.ROLL)
    PYR = PITCH_YAW_ROLL
    ROLL_PITCH_YAW = (RotationAxis.ROLL, RotationAxis.PITCH, RotationAxis.YAW)
    RPY = ROLL_PITCH_YAW
    ROLL_YAW_PITCH = (RotationAxis.ROLL, RotationAxis.YAW, RotationAxis.PITCH)
    RYP = ROLL_YAW_PITCH
    YAW_PITCH_ROLL = (RotationAxis.YAW, RotationAxis.PITCH, RotationAxis.ROLL)
    YPR = YAW_PITCH_ROLL
    YAW_ROLL_PITCH = (RotationAxis.YAW, RotationAxis.ROLL, RotationAxis.PITCH)
    YRP = YAW_ROLL_PITCH

    DONTCARE = PITCH_ROLL_YAW

    @classmethod
    def _missing_(cls, value):
        parts = None
        if isinstance(value, str) and len(value.split("_")) == 3:
            parts = value.split("_")
        elif isinstance(value, str) and len(value) == 3:
            parts = list(value)  # 3-letter shorthand, e.g. "ypr"
        elif isinstance(value, (list, tuple)) and len(value) == 3:
            parts = list(value)
        if parts is not None:
            return cls(tuple(RotationAxis(p) for p in parts))
        return super()._missing_(value)

    def to_letters_xyz(self) -> str:
        """Permutation of 'xyz' letters corresponding to this order."""
        return "".join(axis.to_letter_xyz() for axis in self.value)

    def to_list_of_str(self) -> list[str]:
        """Axis names as a list of strings."""
        return [axis.value for axis in self.value]

    def to_str(self) -> str:
        """Underscore-joined axis names, e.g. ``'yaw_pitch_roll'``."""
        return "_".join(self.to_list_of_str())


# ---------------------------------------------------------------------------
# Anatomical nomenclature constants
# ---------------------------------------------------------------------------

SIDES: list[str] = ["l", "r"]
LEGS: list[str] = [f"{side}{seg}" for side in SIDES for seg in ("f", "m", "h")]
BODY_POSITIONS: list[str] = ["c", *SIDES, *LEGS]

LEG_LINKS: list[str] = [
    "coxa",
    "trochanterfemur",  # the trochanter and femur are fused in the real fly
    "tibia",
    "tarsus1",
    "tarsus2",
    "tarsus3",
    "tarsus4",
    "tarsus5",
]
ANTENNA_LINKS: list[str] = ["pedicel", "funiculus", "arista"]
PROBOSCIS_LINKS: list[str] = ["rostrum", "haustellum"]
ABDOMEN_LINKS: list[str] = ["abdomen12", "abdomen3", "abdomen4", "abdomen5", "abdomen6"]
PASSIVE_TARSAL_LINKS: list[str] = ["tarsus2", "tarsus3", "tarsus4", "tarsus5"]


def _chain_edges(*segments: str) -> list[tuple[str, str]]:
    """Consecutive (parent, child) pairs along a kinematic chain."""
    return list(zip(segments[:-1], segments[1:]))


ALL_CONNECTED_SEGMENT_PAIRS: list[tuple[str, str]] = [
    ("c_thorax", "c_head"),
    *_chain_edges("c_head", *(f"c_{lk}" for lk in PROBOSCIS_LINKS)),
    *_chain_edges("c_thorax", *(f"c_{lk}" for lk in ABDOMEN_LINKS)),
    *(("c_head", f"{s}_eye") for s in SIDES),
    *(
        edge
        for s in SIDES
        for edge in _chain_edges("c_head", *(f"{s}_{lk}" for lk in ANTENNA_LINKS))
    ),
    *(("c_thorax", f"{s}_wing") for s in SIDES),
    *(("c_thorax", f"{s}_haltere") for s in SIDES),
    *(
        edge
        for leg in LEGS
        for edge in _chain_edges("c_thorax", *(f"{leg}_{lk}" for lk in LEG_LINKS))
    ),
]

ALL_SEGMENT_NAMES: list[str] = orderedset(
    [seg for pair in ALL_CONNECTED_SEGMENT_PAIRS for seg in pair]
)


# ---------------------------------------------------------------------------
# Body feature dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BodySegment:
    """A body segment, identified by its ``{pos}_{link}`` name.

    Attributes:
        name: Segment name, one of :data:`ALL_SEGMENT_NAMES`.
    """

    name: str

    def __post_init__(self):
        if self.name not in ALL_SEGMENT_NAMES:
            raise ValueError(
                f"Invalid body segment name: {self.name}. "
                f"Must be one of {ALL_SEGMENT_NAMES}."
            )

    @property
    def pos(self) -> str:
        """Body position prefix (e.g. ``'lf'``, ``'c'``)."""
        return self.name.partition("_")[0]

    @property
    def link(self) -> str:
        """Link name within the kinematic chain (e.g. ``'tibia'``)."""
        return self.name.partition("_")[2]

    def is_thorax(self) -> bool:
        return self.name == "c_thorax"

    def is_head(self) -> bool:
        return self.name == "c_head"

    def is_proboscis(self) -> bool:
        return self.link in PROBOSCIS_LINKS

    def is_eye(self) -> bool:
        return self.link == "eye"

    def is_antenna(self) -> bool:
        return self.link in ANTENNA_LINKS

    def is_wing(self) -> bool:
        return self.link == "wing"

    def is_haltere(self) -> bool:
        return self.link == "haltere"

    def is_leg(self) -> bool:
        return self.pos in LEGS

    def is_abdomen(self) -> bool:
        return self.link in ABDOMEN_LINKS


@dataclass(frozen=True)
class JointDOF:
    """One rotational degree of freedom of an anatomical joint.

    E.g., the 3-DoF thorax-coxa ball joint decomposes into three JointDOFs,
    one per rotation axis.
    """

    parent: BodySegment
    child: BodySegment
    axis: RotationAxis

    def __post_init__(self):
        # Coerce string arguments (object.__setattr__ because frozen).
        if isinstance(self.parent, str):
            object.__setattr__(self, "parent", BodySegment(self.parent))
        if isinstance(self.child, str):
            object.__setattr__(self, "child", BodySegment(self.child))
        if isinstance(self.axis, str):
            object.__setattr__(self, "axis", RotationAxis(self.axis))

    @property
    def name(self) -> str:
        """Unique name following the pattern ``{parent}-{child}-{axis}``."""
        return f"{self.parent.name}-{self.child.name}-{self.axis.value}"

    @classmethod
    def from_name(cls, name: str) -> "JointDOF":
        """Parse a ``{parent}-{child}-{axis}`` name back into a JointDOF."""
        try:
            parent, child, axis = name.split("-")
            return cls(BodySegment(parent), BodySegment(child), RotationAxis(axis))
        except Exception as e:
            raise ValueError(
                f"Cannot parse {name!r} as a JointDOF "
                "(expected '{parent}-{child}-{axis}')."
            ) from e


@dataclass
class AnatomicalJoint:
    """An anatomical joint between two segments, possibly with multiple DoFs."""

    parent: BodySegment
    child: BodySegment
    axes: AxesSet = field(default_factory=lambda: AxesSet(RotationAxis))

    def __post_init__(self):
        if isinstance(self.parent, str):
            self.parent = BodySegment(self.parent)
        if isinstance(self.child, str):
            self.child = BodySegment(self.child)
        if not isinstance(self.axes, AxesSet):
            self.axes = AxesSet(self.axes)

    def iter_dofs(self, axis_order: AxisOrder) -> Iterator[JointDOF]:
        """Yield this joint's DoFs in the given axis order (present axes only)."""
        for axis in axis_order.value:
            if axis in self.axes:
                yield JointDOF(self.parent, self.child, axis)

    @property
    def name(self) -> str:
        """Unique name following the pattern ``{parent}-{child}``."""
        return f"{self.parent.name}-{self.child.name}"

    def __hash__(self):
        return hash((self.parent, self.child))


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# Per-link DoF restriction for biologically plausible leg joints: the
# thorax-coxa joint is a 3-DoF ball joint, the coxa-trochanterfemur joint has
# pitch + roll, and all more distal leg joints are pure pitch hinges.
_BIOLOGICAL_LEG_AXES = {
    "coxa": ("pitch", "roll", "yaw"),
    "trochanterfemur": ("pitch", "roll"),
}
_DEFAULT_DISTAL_LEG_AXES = ("pitch",)


class JointPreset(Enum):
    """Preset selections of anatomical joints and their DoFs.

    Attributes:
        ALL_POSSIBLE: 3 DoFs at every anatomical joint (204 DoFs).
        ALL_BIOLOGICAL: Biologically plausible DoFs only (126 DoFs).
        LEGS_ONLY: ``ALL_BIOLOGICAL`` restricted to legs (66 DoFs).
        LEGS_ACTIVE_ONLY: ``LEGS_ONLY`` without passive tarsal links (42 DoFs).
    """

    ALL_POSSIBLE = "all_possible"
    ALL_BIOLOGICAL = "all_biological"
    LEGS_ONLY = "legs_only"
    LEGS_ACTIVE_ONLY = "legs_active_only"

    def to_joint_list(self) -> list[AnatomicalJoint]:
        """Materialize the preset as a list of :class:`AnatomicalJoint`."""
        joints = [
            AnatomicalJoint(BodySegment(p), BodySegment(c), AxesSet(RotationAxis))
            for p, c in ALL_CONNECTED_SEGMENT_PAIRS
        ]
        if self is JointPreset.ALL_POSSIBLE:
            return joints

        # Restrict leg joints to biologically plausible DoFs.
        for joint in joints:
            if joint.child.is_leg():
                axes = _BIOLOGICAL_LEG_AXES.get(
                    joint.child.link, _DEFAULT_DISTAL_LEG_AXES
                )
                joint.axes = AxesSet(axes)
        if self is JointPreset.ALL_BIOLOGICAL:
            return joints

        leg_joints = [j for j in joints if j.child.is_leg()]
        if self is JointPreset.LEGS_ONLY:
            return leg_joints
        if self is JointPreset.LEGS_ACTIVE_ONLY:
            return [
                j for j in leg_joints if j.child.link not in PASSIVE_TARSAL_LINKS
            ]
        raise FlyGymInternalError(f"Unhandled JointPreset {self}")


class ActuatedDOFPreset(Enum):
    """Preset filters choosing which skeleton DoFs receive actuators."""

    ALL = "all"
    LEGS_ONLY = "legs_only"
    LEGS_ACTIVE_ONLY = "legs_active_only"

    def filter(self, jointdofs: list[JointDOF]) -> list[JointDOF]:
        """Return the subset of the given DoFs selected by this preset."""
        if self is ActuatedDOFPreset.ALL:
            return list(jointdofs)
        legs = [dof for dof in jointdofs if dof.child.is_leg()]
        if self is ActuatedDOFPreset.LEGS_ONLY:
            return legs
        if self is ActuatedDOFPreset.LEGS_ACTIVE_ONLY:
            return [
                dof for dof in legs if dof.child.link not in PASSIVE_TARSAL_LINKS
            ]
        raise FlyGymInternalError(f"Unhandled ActuatedDOFPreset {self}")


class ContactBodiesPreset(Enum):
    """Preset selections of body segments that collide with the ground."""

    ALL = "all"
    LEGS_THORAX_ABDOMEN_HEAD = "legs_thorax_abdomen_head"
    LEGS_ONLY = "legs_only"
    TIBIA_TARSUS_ONLY = "tibia_tarsus_only"

    def to_body_segments_list(self) -> list[BodySegment]:
        """Materialize the preset as a list of :class:`BodySegment`."""
        all_segments = [BodySegment(name) for name in ALL_SEGMENT_NAMES]
        if self is ContactBodiesPreset.ALL:
            return all_segments
        if self is ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD:
            return [
                s
                for s in all_segments
                if s.is_leg() or s.is_thorax() or s.is_abdomen() or s.is_head()
            ]
        legs = [s for s in all_segments if s.is_leg()]
        if self is ContactBodiesPreset.LEGS_ONLY:
            return legs
        if self is ContactBodiesPreset.TIBIA_TARSUS_ONLY:
            return [
                s for s in legs if s.link == "tibia" or s.link.startswith("tarsus")
            ]
        raise FlyGymInternalError(f"Unhandled ContactBodiesPreset {self}")


# ---------------------------------------------------------------------------
# Skeleton
# ---------------------------------------------------------------------------


class Skeleton:
    """A validated kinematic tree of anatomical joints with a fixed axis order.

    Args:
        axis_order: Within-joint DoF chaining order.
        joint_preset: Joint selection preset. Mutually exclusive with
            ``anatomical_joints``.
        anatomical_joints: Explicit joint list. Mutually exclusive with
            ``joint_preset``.
    """

    def __init__(
        self,
        *,
        axis_order: AxisOrder | list[RotationAxis | str],
        joint_preset: JointPreset | str | None = None,
        anatomical_joints: list[AnatomicalJoint] | None = None,
    ) -> None:
        if (joint_preset is None) == (anatomical_joints is None):
            raise ValueError(
                "Skeleton must be initiated from either joint_preset or "
                "anatomical_joints, but not both."
            )
        if joint_preset is not None:
            anatomical_joints = JointPreset(joint_preset).to_joint_list()
        self.anatomical_joints = anatomical_joints
        self.joint_lookup = {(j.parent, j.child): j for j in anatomical_joints}
        self.body_segments = orderedset(
            [seg for pair in self.joint_lookup for seg in pair]
        )
        self.axis_order = AxisOrder(axis_order)

    def get_tree(self) -> Tree:
        """Build (and validate) the tree over this skeleton's segments."""
        try:
            return Tree(nodes=self.body_segments, edges=list(self.joint_lookup))
        except ValueError as e:
            raise ValueError(
                "Skeleton joints do not form a tree (cycle or orphan "
                "segment detected)."
            ) from e

    def iter_jointdofs(
        self, root: BodySegment | str = "c_thorax"
    ) -> Iterator[JointDOF]:
        """Yield all joint DoFs in depth-first order from ``root``.

        This ordering is the canonical DoF order contract used throughout the
        framework (control inputs, state readouts).
        """
        if isinstance(root, str):
            root = BodySegment(root)
        tree = self.get_tree()
        for parent, child in tree.dfs_edges(root):
            joint = self.joint_lookup[(parent, child)]
            yield from joint.iter_dofs(self.axis_order)

    def get_actuated_dofs_from_preset(
        self, preset: ActuatedDOFPreset | str
    ) -> list[JointDOF]:
        """Apply an :class:`ActuatedDOFPreset` to this skeleton's DoFs."""
        return ActuatedDOFPreset(preset).filter(list(self.iter_jointdofs()))
