"""Example 09: multimodal navigation with many flies (config 5).

``examples/09_multimodal_navigation.py`` in torch: the default walking world
(:func:`~flygym_tpu_torch.env.gym._build_default_world`) with an attractor
sphere ahead, an odor source at its foot, vision on and 10 physics steps per
env step; ``n_envs`` worlds take 3 env steps together. On the card each env
step is one K = 10 launch of the mega-step kernel K2, one launch of the
retina kernel K3 and the acceptance blur.

Run: ``python -m flygym_tpu_torch.demo.multimodal_navigation [n_envs]``.
"""

import sys

import numpy as np
import torch

from flygym_tpu_torch.ops import checked_device

__all__ = ["ATTRACTOR", "ODOR", "DECISION_INTERVAL", "build_world", "build_env", "main"]

ATTRACTOR = dict(pos=(30.0, 0.0, 3.0), radius=3.0)
ODOR = dict(source_pos=[[30.0, 0.0, 1.0]], peak_intensity=[[1.0]])
DECISION_INTERVAL = 10


def build_world():
    """``(fly, world)``: the default env world with the attractor."""
    from flygym_tpu_torch.env.gym import _build_default_world

    fly, world = _build_default_world()
    world.add_object("attractor", ATTRACTOR["pos"], radius=ATTRACTOR["radius"])
    return fly, world


def build_env(device="cuda", megastep: bool | None = None):
    """Config 5's env on ``device``, as example 09 builds it
    (``examples/09_multimodal_navigation.py:26-38``)."""
    from flygym_tpu_torch.env import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    device = checked_device(device)
    fly, world = build_world()
    world.compile()
    odor = OdorField.for_fly(world, fly.name, **ODOR)
    return VectorFlyEnv(world, fly.name, enable_vision=True, odor_field=odor,
                        decision_interval=DECISION_INTERVAL, device=device, megastep=megastep)


def main(n_envs: int = 16, device="cuda", n_steps: int = 3, verbose: bool = True) -> dict:
    """``n_steps`` env steps of ``n_envs`` worlds at zero joint targets with
    adhesion on, from a seeded reset; prints what example 09 prints.
    Returns the env, the states, the last observations, rewards and dones."""
    env = build_env(device)
    states = env.reset_batched(torch.Generator().manual_seed(0), n_envs)
    step = env.make_batched_step()
    actions = {
        "joints": torch.zeros((n_envs, env.n_actuated), device=env.device),
        "adhesion": torch.ones((n_envs, 6), device=env.device),
    }
    for _ in range(n_steps):
        states, obs, rewards, dones, _ = step(states, actions)
    if verbose:
        print(f"{n_envs} envs; observation shapes:")
        for key, value in obs.items():
            print(f"  {key}: {tuple(value.shape)}")
        print(f"mean odor at antennae: {float(obs['odor_intensity'][:, 0, :2].mean()):.5f}")
        print(f"vision mean intensity: {float(obs['vision'].mean()):.3f}")
        print(f"rewards: {np.round(rewards[:8].cpu().numpy(), 5).tolist()}")
    return {"env": env, "states": states, "obs": obs, "rewards": rewards, "dones": dones}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
