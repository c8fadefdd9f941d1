"""Example 13: evolution-strategies training on the batched env (config 5
"for RL training").

``examples/13_rl_training_es.py`` in torch: a sinusoidal gait generator (per
DoF amplitude and phase, a phase per leg and a shared log-frequency around
10 Hz) is trained for forward walking by antithetic OpenAI-ES with
rank-normalised returns. Every update runs the whole population, ``n_envs``
episodes of ``episode_len`` env steps, through
:meth:`~flygym_tpu_torch.env.VectorFlyEnv.make_batched_step` of
``VectorFlyEnv()``: on the card one K = 10 launch of the mega-step kernel K2
per env step, and no tree-LDL launch. The perturbations and the resets draw
from one explicit ``torch.Generator`` seeded with ``seed``.

Run: ``python -m flygym_tpu_torch.demo.rl_training_es [--small]`` (``--small``
is 64 envs, 10 updates, 25 env steps).
"""

import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.compose.fly import ActuatorType
from flygym_tpu_torch.engine.maths import sinf
from flygym_tpu_torch.ops import checked_device

__all__ = ["THETA_KEYS", "make_policy", "flatten", "unflatten", "es_update",
           "population_returns", "train", "main"]

# The policy's parameters in the order ``jax.flatten_util.ravel_pytree``
# lays out JAX's dict (its keys sorted), with their sizes per actuated DoF
# (None: one value, 6: one per leg).
THETA_KEYS = ("amp", "leg_phase", "log_freq", "phase")
LEG_PHASE = (0.0, math.pi, 0.0, math.pi, 0.0, math.pi)  # tripod gait


def make_policy(env):
    """``(init_theta, policy)`` of JAX's ``make_policy`` (example 13,
    :40-76) for ``env`` (a :class:`~flygym_tpu_torch.env.VectorFlyEnv` with
    its ``fly``).

    ``init_theta(generator)`` draws amp (0.05 N) and phase (0.3 N) per
    actuated DoF; ``policy(theta, t)`` gives joints = neutral +
    clip(amp, ±0.8) sin(2π f t + phase + leg phase) and adhesion on while
    sin(2π f t + leg phase) < 0 (the stance half-cycle), f = 10
    exp(clip(log_freq, ±1.5)) Hz; ``theta``'s entries may carry a leading
    population axis, and sin is glibc's, as XLA's CPU backend computes it.
    """
    dev = env.device
    neutral = env._state0.ctrl[0, env._act_ids]
    order = env.fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    legs = list(env.fly.get_legs_order())
    leg_of_dof = torch.tensor([legs.index(d.child.name[:2]) for d in order], device=dev)
    n_act = env.n_actuated

    def init_theta(generator: torch.Generator) -> dict:
        gdev = generator.device
        return dict(
            amp=(0.05 * torch.randn(n_act, generator=generator, device=gdev)).to(dev),
            phase=(0.3 * torch.randn(n_act, generator=generator, device=gdev)).to(dev),
            leg_phase=torch.tensor(LEG_PHASE, dtype=torch.float32, device=dev),
            log_freq=torch.zeros((), device=dev),
        )

    def policy(theta: dict, t: float) -> dict:
        freq = 10.0 * torch.exp(torch.clamp(theta["log_freq"], -1.5, 1.5))
        base = (2.0 * math.pi * freq * t)[..., None]
        leg_ph = theta["leg_phase"][..., leg_of_dof]
        amp = torch.clamp(theta["amp"], -0.8, 0.8)
        joints = neutral + amp * sinf(base + theta["phase"] + leg_ph)
        adhesion = (sinf(base + theta["leg_phase"]) < 0.0).to(torch.float32)
        return dict(joints=joints, adhesion=adhesion)

    return init_theta, policy


def flatten(theta: dict) -> torch.Tensor:
    """θ as one vector (or one row per population member), in
    ``ravel_pytree``'s order."""
    lead = theta["log_freq"].shape
    return torch.cat([theta[k].reshape(lead + (-1,)) for k in THETA_KEYS], dim=-1)


def unflatten(flat: torch.Tensor, n_act: int) -> dict:
    """Inverse of :func:`flatten` for ``n_act`` actuated DoFs."""
    sizes = {"amp": n_act, "leg_phase": 6, "log_freq": 1, "phase": n_act}
    parts = torch.split(flat, [sizes[k] for k in THETA_KEYS], dim=-1)
    theta = dict(zip(THETA_KEYS, parts))
    theta["log_freq"] = theta["log_freq"][..., 0]
    return theta


def es_update(flat: torch.Tensor, returns: torch.Tensor, eps: torch.Tensor, sigma: float,
              lr: float) -> torch.Tensor:
    """One antithetic ES step (example 13, :126-133): the returns of θ + σε
    (first half) against θ − σε ranked, the ranks scaled to [-0.5, 0.5],
    the gradient their weighted mean of ε over σ."""
    half = eps.shape[0]
    adv = returns[:half] - returns[half:]
    ranks = torch.argsort(torch.argsort(adv, stable=True), stable=True).to(torch.float32)
    w = ranks / max(half - 1, 1) - 0.5
    grad = (w[:, None] * eps).mean(dim=0) / sigma
    return flat + lr * grad


def population_returns(env, step, policy, flat, eps, generator, sigma: float,
                       episode_len: int) -> torch.Tensor:
    """(n_envs,) mean reward per env step of the antithetic population
    θ ± σε from fresh resets; a fallen or flipped world collects 0 on the
    steps it is down."""
    n_act = env.n_actuated
    thetas = unflatten(torch.cat([flat[None] + sigma * eps, flat[None] - sigma * eps]), n_act)
    n_envs = 2 * eps.shape[0]
    states = env.reset_batched(generator, n_envs)
    dt_env = np.float32(env.decision_interval * float(env.model.timestep))
    total = torch.zeros(n_envs, device=env.device)
    for i in range(episode_len):
        t = float(np.float32(i) * dt_env)
        states, _obs, r, done, _ = step(states, policy(thetas, t))
        total += torch.where(done, 0.0, r)
    return total / episode_len


def train(n_envs: int = 1024, n_updates: int = 50, episode_len: int = 100,
          sigma: float = 0.05, lr: float = 0.25, seed: int = 0, device="cuda",
          verbose: bool = True, timings: list | None = None):
    """ES on ``VectorFlyEnv()`` on ``device`` (the card unless the caller
    asks for the CPU). Returns the curve of population mean rewards, one per
    update, and the trained θ. ``timings``, if given, gets each update's
    seconds (the card synchronised)."""
    from flygym_tpu_torch.env import VectorFlyEnv

    env = VectorFlyEnv(device=checked_device(device))
    step = env.make_batched_step()
    init_theta, policy = make_policy(env)
    generator = torch.Generator().manual_seed(seed)
    flat = flatten(init_theta(generator))
    half = n_envs // 2
    curve = []
    for u in range(n_updates):
        t0 = time.perf_counter()
        eps = torch.randn((half, flat.shape[0]), generator=generator).to(env.device)
        returns = population_returns(env, step, policy, flat, eps, generator, sigma,
                                     episode_len)
        flat = es_update(flat, returns, eps, sigma, lr)
        mean_r, best = returns.mean().item(), returns.max().item()
        if timings is not None:
            timings.append(time.perf_counter() - t0)
        curve.append(mean_r)
        if verbose:
            print(f"update {u:3d}: population mean reward {mean_r:+.5f} (best {best:+.5f})",
                  flush=True)
    return np.asarray(curve), unflatten(flat, env.n_actuated)


def main(n_envs: int = 1024, n_updates: int = 50, episode_len: int = 100, device="cuda",
         out: Path | None = None) -> np.ndarray:
    """Train, print the first and last fifths' mean rewards and write the
    curve (one value per update) to ``out`` (default
    ``es_learning_curve.csv`` in the temporary directory)."""
    curve, _theta = train(n_envs=n_envs, n_updates=n_updates, episode_len=episode_len,
                          device=device)
    fifth = max(len(curve) // 5, 1)
    print(f"\nmean reward: first fifth {curve[:fifth].mean():+.5f} -> "
          f"last fifth {curve[-fifth:].mean():+.5f}")
    out = Path(tempfile.gettempdir()) / "es_learning_curve.csv" if out is None else Path(out)
    np.savetxt(out, curve, header="population_mean_reward_per_update")
    print(f"learning curve written to {out}")
    return curve


if __name__ == "__main__":
    if "--small" in sys.argv:
        main(n_envs=64, n_updates=10, episode_len=25)
    else:
        main()
