"""RL env traffic: ``VectorFlyEnv.make_batched_step()`` of config 5.

The mix file gives ``envs``, ``episode_steps``, ``vision`` (the retina
rendered by K3 and the blur, or not) and ``odor``, the action noise and
``warmup_steps``. Set-up loads the configuration's world into
``flygym_tpu_torch.env.VectorFlyEnv`` on the mega-step path (one K2
launch of ``decision_interval`` steps per env step), makes every step's
action from the seed (the neutral joint targets plus Gaussian noise,
adhesion on) and warms up one short episode. The window runs episodes of
``episode_steps`` env steps back to back, each from a fresh
``reset_batched`` drawn from a seeded generator on the card, with no
auto-reset, as an RL trainer's rollout does.

Each env step's time runs from the end of the one before it (or of the
episode's reset) to its own end, from CUDA events recorded on the stream,
with no host synchronisation between steps.

The check follows one env step drawn from the seed, in the window's first
episode, from the program's own state before it: the state, reward, done
and every observation it returned, against the plain env step
(:class:`~portbench.reference.env.EnvReference`); and the episode's reset by
itself, the reference drawing the same noise from a copy of the generator.
"""

import statistics
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from portbench.compare import STATE_FIELDS, gap, state_gap
from portbench.digest import WINDOW
from portbench.harness import seeded_generator
from portbench.reference.env import EnvReference
from portbench.reference.model import State, load_world
from portbench.reference.runner import precision

__all__ = ["EnvRun", "setup"]

BODY_OBS = ("joints", "fly", "contact_forces", "end_effectors", "fly_orientation")
POSE_STEPS = 4
POSE_WORLDS = 64




def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, n = 20, exclusive)."""
    return statistics.quantiles(values, n=20)[18]


class EnvRun:
    """One env cell's set-up, window and check (see the module)."""

    def __init__(self, config: dict, mix: dict, seed: int, device, *,
                 decision_interval: int | None = None):
        from flygym_tpu_torch.compose.bridge import load_compiled
        from flygym_tpu_torch.env.gym import VectorFlyEnv
        from flygym_tpu_torch.olfaction import OdorField

        self.device = torch.device(device)
        self.n = int(mix["envs"])
        self.steps = int(mix["episode_steps"])
        self.vision, self.odor = bool(mix["vision"]), bool(mix["odor"])
        self.limits = mix["limits"]
        self.world = Path(config["dir"]) / config["world"]
        self.interval = int(decision_interval or config["decision_interval"])
        _m, state0, meta = load_world(self.world)
        act_ids = torch.tensor(meta["env"]["act_ids"], device=self.device)

        # The traffic from the seed: each step's actions, the resets' noise.
        gen = seeded_generator(self.device, seed)
        neutral = state0.ctrl[0].to(self.device)[act_ids]
        noise = float(mix["action_noise_rad"])
        self.actions = [
            {"joints": neutral + noise * torch.randn((self.n, len(act_ids)), generator=gen,
                                                     device=self.device),
             "adhesion": torch.ones((self.n, 6), device=self.device)}
            for _ in range(self.steps)]
        self.reset_gen = seeded_generator(self.device, seed + 1)
        rng = np.random.default_rng(seed)
        self.check_step = int(rng.integers(self.steps))
        # The poses K3's roofline counts its pairs on: a sample of worlds at
        # a few steps of the window's first episode.
        self.pose_steps = set(rng.choice(self.steps, min(POSE_STEPS, self.steps), replace=False)
                              .tolist())
        self.pose_worlds = torch.as_tensor(
            rng.choice(self.n, min(POSE_WORLDS, self.n), replace=False), device=self.device)
        self.poses = []
        self._pair_share = None

        compiled = load_compiled(self.world)
        self.env = VectorFlyEnv(
            compiled, device=self.device, megastep=True, decision_interval=self.interval,
            enable_vision=self.vision,
            odor_field=OdorField.for_compiled(compiled) if self.odor else None)
        self.step = self.env.make_batched_step()
        # Warm-up: one reset and a few steps of the cell's own shapes.
        warm = seeded_generator(self.device, seed + 2)
        states = self.env.reset_batched(warm, self.n)
        for a in self.actions[: int(mix["warmup_steps"])]:
            states = self.step(states, a)[0]
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self):
        if self.device.type != "cuda":
            return perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def _ms(a, b) -> float:
        return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)

    def window(self, seconds: float, span) -> dict:
        """Whole episodes until ``seconds`` have passed; the card is
        synchronised at both ends and after each episode."""
        marks = []
        self._sync()
        with span(WINDOW):
            t0 = perf_counter()
            episodes = self._episodes(seconds, span, t0, marks)
            elapsed = perf_counter() - t0
        return {"seconds": elapsed, "episodes": episodes, "env_steps": len(marks),
                "marks": marks, "attempted": len(marks)}

    episode_ends = ()

    def _episodes(self, seconds: float, span, t0: float, marks: list) -> int:
        episodes, self.episode_ends = 0, []
        while True:
            first = episodes == 0
            if first:
                self.reset_state = self.reset_gen.get_state()
            with span("portbench.env.reset"):
                states = self.env.reset_batched(self.reset_gen, self.n)
            if first:
                self.reset_out = states
            prev = self._event()
            for t in range(self.steps):
                if first and t == self.check_step:
                    self.step_in = states
                with span("portbench.env.step"):
                    out = self.step(states, self.actions[t])
                states = out[0]
                mark = self._event()
                marks.append((prev, mark))
                prev = mark
                if first and t == self.check_step:
                    self.step_out = out
                if first and t in self.pose_steps and self.vision:
                    self.poses.append((states.xpos[self.pose_worlds],
                                       states.xquat[self.pose_worlds]))
            with span("portbench.sync"):
                self._sync()
            episodes += 1
            self.episode_ends.append(perf_counter() - t0)
            if perf_counter() - t0 >= seconds:
                return episodes

    def end_to_end(self, w: dict) -> dict:
        step_ms = [self._ms(a, b) for a, b in w["marks"]]
        return {"env_steps_per_s": w["env_steps"] * self.n / w["seconds"],
                "env_step_ms_p95": p95(step_ms)}

    def pair_share(self):
        """The share of (ray, geom) pairs that contribute on the sampled
        poses (the frozen plain arithmetic, on the CPU), or None."""
        from portbench.reference import vision

        if not self.poses:
            return None
        if self._pair_share is None:
            model, _s, meta = load_world(self.world)
            left, right = meta["env"]["eye_bodies"]
            retina = vision.build_retina(model, left_eye_body=left, right_eye_body=right)
            tables = vision.RetinaTables(model, retina, "cpu")
            xpos = torch.cat([p[0] for p in self.poses]).cpu()
            xquat = torch.cat([p[1] for p in self.poses]).cpu()
            pairs = vision.contributing_pairs(tables, vision.pack_rows(tables, xpos, xquat))
            self._pair_share = float(pairs.float().mean().item())
        return self._pair_share

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.env = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> list:
        """``(name, gap, limit)`` of the reset and the window's step against
        the reference, computed in ``control``'s precision (None: float32)."""
        ref = EnvReference(self.world, self.device, vision_on=self.vision, odor_on=self.odor,
                           decision_interval=self.interval)
        gen = torch.Generator(device=self.device)
        gen.set_state(self.reset_state)
        reset = ref.reset(gen, self.n)
        out = [("reset", state_gap(self.reset_out, reset, STATE_FIELDS + ("ctrl", "time")),
                self.limits["reset"])]
        state, obs, reward, done, _info = self.step_out
        want = ref.advance(State.of(self.step_in), self.actions[self.check_step], control)
        with torch.inference_mode(), precision(control):
            want_reward, want_done = ref.reward_done(want)
            want_obs = ref.observe(want)
        out.append(("state", max(state_gap(state, want), gap(state.ctrl, want.ctrl)),
                    self.limits["state"]))
        out.append(("reward", gap(reward, want_reward), self.limits["reward"]))
        out.append(("done", float((done != want_done).sum().item()), self.limits["done"]))
        out.append(("body_obs", max(gap(obs[k], want_obs[k]) for k in BODY_OBS),
                    self.limits["body_obs"]))
        if self.odor:
            out.append(("odor", gap(obs["odor_intensity"], want_obs["odor_intensity"]),
                        self.limits["odor"]))
        if self.vision:
            out.append(("vision", gap(obs["vision"], want_obs["vision"]), self.limits["vision"]))
        if set(obs) != set(want_obs):
            out.append(("obs_keys", 1.0, 0.0))
        return out


def setup(config: dict, mix: dict, seed: int, device, **kw) -> EnvRun:
    return EnvRun(config, mix, seed, device, **kw)
