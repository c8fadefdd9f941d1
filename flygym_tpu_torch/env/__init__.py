"""Reinforcement-learning environments of the port."""

from flygym_tpu_torch.env.gym import VectorFlyEnv

__all__ = ["VectorFlyEnv"]
