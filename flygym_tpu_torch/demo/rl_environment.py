"""Example 06: the RL environments.

``examples/06_rl_environment.py`` in torch, one function for each half of
its ``main``:

- :func:`gym_half`: ``FlyEnv()``, a ``gymnasium.Env`` of one world on the
  default walking fly: reset, one random action, one env step. It needs
  ``gymnasium``.
- :func:`vector_half`: ``VectorFlyEnv()`` stepping ``n_envs`` worlds
  together through :meth:`~flygym_tpu_torch.env.VectorFlyEnv.make_batched_step`
  (on the card one K = 10 launch of the mega-step kernel K2 per env step).

Run: ``python -m flygym_tpu_torch.demo.rl_environment [n_envs]`` (both
halves; the first needs ``gymnasium``).
"""

import sys

import torch

from flygym_tpu_torch.ops import checked_device

__all__ = ["gym_half", "vector_half", "main"]


def gym_half(device="cuda", verbose: bool = True) -> dict:
    """``FlyEnv()`` on ``device``: ``reset(seed=0)``, one step of a sampled
    action. Returns the observation after the reset (``obs``), the spaces,
    the step's reward and whether it terminated."""
    from flygym_tpu_torch.env import FlyEnv

    env = FlyEnv(device=checked_device(device))
    obs, _info = env.reset(seed=0)
    if verbose:
        print("observation keys:", sorted(obs))
    env.action_space.seed(0)
    action = env.action_space.sample()
    _obs, reward, terminated, _truncated, _ = env.step(action)
    if verbose:
        print(f"one env step: reward={reward:.4f} terminated={terminated}")
    return {"obs": obs, "action_space": env.action_space,
            "observation_space": env.observation_space, "reward": reward,
            "terminated": terminated}


def vector_half(n_envs: int = 64, device="cuda", verbose: bool = True) -> dict:
    """``VectorFlyEnv()`` on ``device``: ``n_envs`` worlds reset from a
    seeded generator and stepped once together at zero joint targets with
    adhesion on. Returns the states, observations, rewards and dones."""
    from flygym_tpu_torch.env import VectorFlyEnv

    core = VectorFlyEnv(device=checked_device(device))
    states = core.reset_batched(torch.Generator().manual_seed(0), n_envs)
    step = core.make_batched_step()
    actions = {
        "joints": torch.zeros((n_envs, core.n_actuated), device=core.device),
        "adhesion": torch.ones((n_envs, 6), device=core.device),
    }
    states, obs, rewards, dones, _ = step(states, actions)
    if verbose:
        print(f"{n_envs} envs stepped together: rewards shape {tuple(rewards.shape)}, "
              f"mean reward {float(rewards.mean()):.4f}, any done {bool(dones.any())}")
    return {"states": states, "obs": obs, "rewards": rewards, "dones": dones}


def main(n_envs: int = 64, device="cuda") -> None:
    gym_half(device)
    vector_half(n_envs, device)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
