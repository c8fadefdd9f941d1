"""Experimentally recorded fly walking (Spotlight motion capture).

Port of ``flygym_tpu/demo/spotlight.py``. It reads the port's copy of the
clip, ``flygym_tpu_torch/assets/demo/spotlight_behavior_clip.npz``, and
takes the simulator's DoF order as joint DoFs of
:mod:`flygym_tpu_torch.anatomy` or as (leg, parent link, child link, axis)
tuples (a compiled world's ``flies`` maps).
"""

from pathlib import Path

import numpy as np

__all__ = ["MotionSnippet", "DEFAULT_CLIP_PATH"]

DEFAULT_CLIP_PATH = Path(__file__).resolve().parents[1] / "assets/demo/spotlight_behavior_clip.npz"
# Savitzky-Golay smoothing before resampling (reference ``preprocessing.py:80-142``).
SGFILTER_WINDOW_SEC = 0.03
SGFILTER_POLYORDER = 3


class MotionSnippet:
    """A short clip of recorded leg kinematics, in the anatomical convention:
    the right legs' roll and yaw signs are flipped so that left and right
    angles are symmetric.

    Args:
        data_path: NPZ recording; None loads the bundled clip.
        keypoints: the keypoint labels, as (leg, link, link or None)
            tuples. None takes the bundled clip's, which the clip stores as
            pickled objects that this loader does not read: the export of
            the terrain world (``scripts/export_terrain_golden.py``) keeps
            them as JSON in ``terrain_fly.npz``.

    Attributes:
        joint_angles: (n_frames, 6 legs, 7 DoFs per leg) radians.
        fwdkin_egoxyz: (n_frames, n_keypoints, 3) keypoint positions in the
            ego frame.
        keypoints: the labels of its keypoints.
        legs: leg labels, e.g. ``"lf"``.
        dofs_per_leg: (parent link, child link, axis) per DoF slot.
        data_fps: recording frame rate in Hz.
    """

    def __init__(self, data_path=None, keypoints=None) -> None:
        with np.load(data_path or DEFAULT_CLIP_PATH, allow_pickle=False) as npz:
            self.joint_angles = np.array(npz["joint_angles"], copy=True)
            self.fwdkin_egoxyz = np.asarray(npz["fwdkin_egoxyz"])
            self.legs = npz["legs"].tolist()
            self.dofs_per_leg = [tuple(x) for x in npz["dofs_per_leg"].tolist()]
            self.data_fps = npz["data_fps"].item()
        if keypoints is None:
            from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, read_meta

            keypoints = read_meta(TERRAIN_FLY)["clip_keypoints"]
        self.keypoints = [tuple(k) for k in keypoints]
        on_right = np.array([leg[0] == "r" for leg in self.legs])
        is_mirror_axis = np.array(
            [axis in ("roll", "yaw") for _p, _c, axis in self.dofs_per_leg]
        )
        sign = np.where(on_right[:, None] & is_mirror_axis[None, :], -1.0, 1.0)
        self.joint_angles *= sign[None, :, :]

    def get_joint_angles(self, output_timestep: float, output_dof_order: list) -> np.ndarray:
        """Smooth, resample and reorder the clip for replay.

        Savitzky-Golay smoothing, cubic interpolation onto the simulation's
        time grid, then the columns of ``output_dof_order``, a list of
        joint DoFs or of (leg, parent link, child link, axis) tuples.

        Returns:
            (n_output_steps, len(output_dof_order)) radians.
        """
        from scipy.interpolate import interp1d
        from scipy.signal import savgol_filter

        window = int(SGFILTER_WINDOW_SEC * self.data_fps) | 1
        smoothed = savgol_filter(self.joint_angles, window, SGFILTER_POLYORDER, axis=0)

        src_t = np.arange(len(smoothed)) / self.data_fps
        out_t = np.arange(0, len(smoothed) / self.data_fps, output_timestep)
        spline = interp1d(
            src_t,
            smoothed,
            kind="cubic",
            axis=0,
            bounds_error=False,
            fill_value=(smoothed[0], smoothed[-1]),
        )
        resampled = spline(out_t)

        order = [_dof_key(d) for d in output_dof_order]
        leg_of = [self.legs.index(leg) for leg, _p, _c, _a in order]
        slot_of = [self.dofs_per_leg.index((p, c, a)) for _leg, p, c, a in order]
        return resampled[:, leg_of, slot_of]


def _dof_key(dof) -> tuple:
    """A joint DoF, or its tuple, as (leg, parent link, child link, axis)."""
    if hasattr(dof, "child"):
        return (dof.child.pos, dof.parent.link, dof.child.link, dof.axis.value)
    return tuple(dof)
