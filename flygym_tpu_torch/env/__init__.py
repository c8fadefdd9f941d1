"""Reinforcement-learning environments of the port."""

from flygym_tpu_torch.env.gym import FlyEnv, VectorFlyEnv, env_frame

__all__ = ["FlyEnv", "VectorFlyEnv", "env_frame"]
