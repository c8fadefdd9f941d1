"""Example 05: ommatidia vision and olfaction.

``main`` is ``examples/05_vision_olfaction.py`` in torch: a colourised
LEGS_ONLY fly at (0, 0, 2) on flat ground, both compound eyes rendered once
(721 ommatidia each, pale and yellow channels: the retina kernel K3 and the
acceptance blur, :meth:`~flygym_tpu_torch.vision.Retina.make_render_batched`)
and an odor plume sampled once at the antennae and the maxillary palps.

Run on the card: ``python -m flygym_tpu_torch.demo.vision_olfaction``.
"""

import numpy as np

from flygym_tpu_torch.ops import checked_device

__all__ = ["build_world", "main", "ODOR_SOURCE"]

# One attractive odor source ahead and to the left of the fly.
ODOR_SOURCE = dict(source_pos=[[20.0, 10.0, 1.0]], peak_intensity=[[1.0]])


def build_world():
    """``(fly, world)`` as example 05 composes them (``fly.colorize()`` at
    (0, 0, 2) on :class:`FlatGroundWorld`)."""
    from flygym_tpu_torch.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu_torch.compose import FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu_torch.utils.math import Rotation3D

    fly = Fly(name="fly0")
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.colorize()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    return fly, world


def main(device="cuda", verbose: bool = True) -> dict:
    """Render both eyes and sample the odor once on ``device`` (the card
    unless the caller asks for the CPU); print what example 05 prints.

    Returns:
        ``{"intensities": (2, 721, 2), "odor": (1, 4)}`` as numpy arrays.
    """
    from flygym_tpu_torch.olfaction import OdorField
    from flygym_tpu_torch.vision import Retina

    device = checked_device(device)
    fly, world = build_world()
    model, state = world.compile()
    model, state = model.to(device), state.to(device)

    retina = Retina.for_fly(world, fly.name)
    intensities = retina.make_render_batched(model)(state)[0].cpu().numpy()
    field = OdorField.for_fly(world, fly.name, **ODOR_SOURCE)
    odor = field.sample(model, state)[0].cpu().numpy()
    if verbose:
        print("retina output:", intensities.shape, "(eyes, ommatidia, channels)")
        print(f"left eye mean {intensities[0].mean():.3f}, "
              f"right eye mean {intensities[1].mean():.3f}")
        print("odor intensities (dim, [l-ant r-ant l-palp r-palp]):")
        print(np.round(odor, 5))
        print("left antenna smells more:", odor[0, 0] > odor[0, 1])
    return {"intensities": intensities, "odor": odor}


if __name__ == "__main__":
    main()
