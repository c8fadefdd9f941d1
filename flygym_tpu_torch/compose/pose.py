"""Static kinematic poses (named joint-angle snapshots).

Port of ``flygym_tpu/compose/pose.py``. Parity reference: flygym
``compose/pose.py`` (KinematicPose :14-77, YAML loading :80-105,
left-to-right mirroring :108-128, presets :131-161).

Pose files may be YAML or JSON and must contain ``angle_unit`` ("degree" or
"radian"), ``axis_order``, and a ``joint_angles`` mapping from joint DoF names
to angles. PyYAML is imported only when a ``.yaml`` file is read, so the port
runs where it is not installed (the bundled poses are JSON). The bundled
neutral poses are derived from the NeuroMechFly v2 reference assets
(Apache-2.0).
"""

import json
import math
from enum import Enum
from os import PathLike
from pathlib import Path

from flygym_tpu_torch import assets_dir
from flygym_tpu_torch.anatomy import AxisOrder, RotationAxis

__all__ = ["KinematicPose", "KinematicPosePreset"]


class KinematicPose:
    """A snapshot of joint angles defining a static fly pose.

    Args:
        path: Pose file (YAML/JSON). Mutually exclusive with
            ``joint_angles_rad_dict``.
        joint_angles_rad_dict: Mapping of joint DoF names to angles in radians.
            Mutually exclusive with ``path``.
        axis_order: Required with ``joint_angles_rad_dict``; forbidden with
            ``path`` (the file declares its own axis order).
        mirror_left2right: Mirror left-side angles onto missing right-side
            DoFs (anatomical convention: angles are side-symmetric).
    """

    def __init__(
        self,
        *,
        path: PathLike | None = None,
        joint_angles_rad_dict: dict[str, float] | None = None,
        axis_order: AxisOrder | str | list[RotationAxis | str] | None = None,
        mirror_left2right: bool = True,
    ) -> None:
        if (path is None) == (joint_angles_rad_dict is None):
            raise ValueError(
                "Pass exactly one of `path` or `joint_angles_rad_dict`."
            )
        if path is not None:
            if axis_order is not None:
                raise ValueError(
                    "`axis_order` comes from the pose file itself; don't pass "
                    "it together with `path`."
                )
            angles, order = _load_pose_file(path)
        else:
            if axis_order is None:
                raise ValueError(
                    "`joint_angles_rad_dict` carries no axis order — pass "
                    "`axis_order` explicitly."
                )
            angles, order = dict(joint_angles_rad_dict), AxisOrder(axis_order)

        if mirror_left2right:
            for rname, angle in _mirrored_right_side(angles):
                angles.setdefault(rname, angle)

        self.axis_order = order
        self.joint_angles_lookup_rad = angles

    def copy(self) -> "KinematicPose":
        """Return an independent copy of this pose."""
        return KinematicPose(
            joint_angles_rad_dict=dict(self.joint_angles_lookup_rad),
            axis_order=self.axis_order,
        )


def _load_pose_file(path: PathLike) -> tuple[dict[str, float], AxisOrder]:
    path = Path(path)
    with open(path) as f:
        data = json.load(f) if path.suffix == ".json" else _yaml().safe_load(f)

    unit = data.get("angle_unit")
    if unit == "degree":
        scale = math.pi / 180.0
    elif unit == "radian":
        scale = 1.0
    else:
        raise ValueError(
            f"Pose file {path.name}: angle_unit {unit!r} (want 'degree' or "
            "'radian')."
        )

    raw = data.get("joint_angles")
    if not isinstance(raw, dict):
        raise ValueError(f"Pose file {path.name}: no 'joint_angles' mapping.")
    angles = {}
    for name, value in raw.items():
        if not isinstance(value, (int, float)):
            raise ValueError(
                f"Pose file {path.name}: angle {name!r} is {value!r}, not a "
                "number."
            )
        angles[name] = scale * value

    raw_order = data.get("axis_order")
    try:
        order = AxisOrder(raw_order)
    except (ValueError, TypeError):
        raise ValueError(
            f"Pose file {path.name}: bad or absent axis_order {raw_order!r}."
        )
    return angles, order


def _yaml():
    """PyYAML, which only a ``.yaml`` pose file needs."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading a .yaml pose file needs PyYAML (the package 'pyyaml'), which is "
            "not installed; pass the pose as a .json file instead"
        ) from e
    return yaml


def _mirrored_right_side(angles: dict[str, float]):
    """Yield (right-side DoF name, angle) for every left-side entry.

    DoF names follow ``{parent}-{child}-{axis}``; body-segment sides are
    single-letter prefixes (``l`` left, ``r`` right, ``c`` center), so
    mirroring is prefix surgery on the parent/child parts — center parents
    (e.g. ``c_thorax``) stay as they are.
    """

    def flip(seg: str) -> str:
        return "r" + seg[1:] if seg.startswith("l") else seg

    for name, angle in list(angles.items()):
        parent, child, axis = name.split("-")
        if not child.startswith("l"):
            continue
        yield f"{flip(parent)}-{flip(child)}-{axis}", float(angle)


class KinematicPosePreset(Enum):
    """Bundled poses.

    Attributes:
        NEUTRAL: The neutral (resting) pose.
    """

    NEUTRAL = "neutral"

    def get_dir(self) -> Path:
        if self is KinematicPosePreset.NEUTRAL:
            return assets_dir / "model/pose/neutral"
        raise ValueError(f"No pose file is registered for preset {self.value!r}.")

    def get_pose_by_axis_order(
        self, axis_order: AxisOrder, mirror_left2right: bool = True
    ) -> KinematicPose:
        """Load this preset's pose file for the given axis order."""
        pose_path = self.get_dir() / f"{axis_order.to_str()}.json"
        return KinematicPose(path=pose_path, mirror_left2right=mirror_left2right)
