"""Replay traffic: the reference's own benchmark protocol on the port.

The mix file gives ``worlds``, ``k_steps`` (steps fused per K2 launch),
``episode_steps``, ``settle_steps`` and the spawn jitter. Set-up loads the
configuration's world into ``flygym_tpu_torch.BatchSimulation`` on the
mega-step path, jitters each world's spawn and picks each world's
``episode_steps``-long window of the Spotlight clip (resampled to the
timestep) from the seed, turns adhesion on for all six legs, settles
``settle_steps`` steps and replays one episode untimed. Every episode of
the measured window replays the same targets from that state, on a device
copy, through ``flygym_tpu_torch.demo.benchmark.replay_episode``, the
port's own replay loop (one K-step launch per chunk).

The check follows one chunk drawn from the seed, in the window's first
episode, from the program's own state at its start (the walkers are
chaotic, but K2 is meant to equal its plain version to the last bit); and
by themselves, the start (the loaded, jittered worlds) and the last settle
step (a one-step launch).
"""

from dataclasses import replace
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from portbench.compare import STATE_FIELDS, gap, state_gap
from portbench.digest import WINDOW
from portbench.harness import seeded_generator
from portbench.reference import emitter
from portbench.reference.model import State, load_world
from portbench.reference.runner import plain_chain

__all__ = ["ReplayRun", "resample_clip", "setup"]

# Savitzky-Golay smoothing before resampling (the reference's
# ``preprocessing.py:80-142``, as the port's ``demo/spotlight.py`` has it).
SGFILTER_WINDOW_SEC = 0.03
SGFILTER_POLYORDER = 3


def resample_clip(path, timestep: float, dof_order: list) -> np.ndarray:
    """The clip's joint angles, anatomical signs, smoothed and resampled to
    ``timestep`` by cubic interpolation, in the columns of ``dof_order``
    ((leg, parent link, child link, axis) tuples): (n_steps, n_dofs)
    float64. A copy of ``flygym_tpu_torch/demo/spotlight.py``."""
    from scipy.interpolate import interp1d
    from scipy.signal import savgol_filter

    with np.load(path, allow_pickle=False) as npz:
        angles = np.array(npz["joint_angles"], copy=True)
        legs = npz["legs"].tolist()
        dofs_per_leg = [tuple(x) for x in npz["dofs_per_leg"].tolist()]
        fps = npz["data_fps"].item()
    on_right = np.array([leg[0] == "r" for leg in legs])
    mirror = np.array([axis in ("roll", "yaw") for _p, _c, axis in dofs_per_leg])
    angles *= np.where(on_right[:, None] & mirror[None, :], -1.0, 1.0)[None]
    window = int(SGFILTER_WINDOW_SEC * fps) | 1
    smoothed = savgol_filter(angles, window, SGFILTER_POLYORDER, axis=0)
    src_t = np.arange(len(smoothed)) / fps
    out_t = np.arange(0, len(smoothed) / fps, timestep)
    spline = interp1d(src_t, smoothed, kind="cubic", axis=0, bounds_error=False,
                      fill_value=(smoothed[0], smoothed[-1]))
    resampled = spline(out_t)
    leg_of = [legs.index(leg) for leg, _p, _c, _a in dof_order]
    slot_of = [dofs_per_leg.index((p, c, a)) for _leg, p, c, a in dof_order]
    return resampled[:, leg_of, slot_of]



def _clone(state):
    return state.map(torch.clone)



class ReplayRun:
    """One replay cell's set-up, window and check (see the module)."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from flygym_tpu_torch.batch import BatchSimulation
        from flygym_tpu_torch.compose.bridge import load_compiled
        from flygym_tpu_torch.demo.benchmark import replay_episode

        self.replay_episode = replay_episode
        self.device = torch.device(device)
        self.n = int(mix["worlds"])
        self.K = int(mix["k_steps"])
        self.steps = int(mix["episode_steps"])
        self.limits = mix["limits"]
        self.world = Path(config["dir"]) / config["world"]
        fly = config["fly"]
        _m, _s, meta = load_world(self.world)
        self.timestep = float(meta["model"]["timestep"])
        self.adh_ids = meta["flies"][fly]["adh_ids"]
        dof_order = [tuple(d) for d in meta["flies"][fly]["actuated_dofs"]["position"]]

        # The traffic, made from the seed: each world's window of the clip
        # and its spawn jitter, on the device.
        gen = seeded_generator(self.device, seed)
        clip = torch.as_tensor(
            resample_clip(Path(config["dir"]) / config["clip"], self.timestep,
                          dof_order).astype(np.float32), device=self.device)
        starts = torch.randint(0, clip.shape[0] - self.steps + 1, (self.n,), generator=gen,
                               device=self.device)
        self.targets = clip[starts[:, None] + torch.arange(self.steps, device=self.device)]
        lo, hi = (torch.tensor(v, dtype=torch.float32, device=self.device)
                  for v in zip(*mix["spawn_jitter_mm"]))
        self.jitter = lo + (hi - lo) * torch.rand((self.n, 3), generator=gen, device=self.device)
        rng = np.random.default_rng(seed)
        self.check_chunk = int(rng.integers(self.steps // self.K))

        # The program: loaded, batched, jittered, adhesion on, settled, and
        # one untimed episode.
        sim = BatchSimulation(load_compiled(self.world), self.n, device=self.device,
                              megastep=True, megastep_k=self.K)
        state = sim.state
        sim.state = replace(state, qpos=torch.cat([state.qpos[:, :3] + self.jitter,
                                                   state.qpos[:, 3:]], dim=1))
        sim.set_leg_adhesion_states(sim.compiled.fly_names[0],
                                    torch.ones(6, device=self.device))
        self.start = _clone(sim.state)
        settle = int(mix["settle_steps"])
        if settle > 1:
            sim.rollout(None, settle - 1, record_trajectory=False)
        self.settle_in = _clone(sim.state)
        sim.rollout(None, 1, record_trajectory=False)
        self.settle_out = _clone(sim.state)
        self.act_ids = sim.actuator_ids(sim.compiled.fly_names[0], "position")
        self.base = self.replay_episode(sim, sim.shards, self.targets, self.act_ids, self.steps)
        sim.synchronize()
        self.sim = sim
        self.chunk_in = self.chunk_out = None

    def _capture(self, i: int, state) -> None:
        chunk = i // self.K
        if chunk == self.check_chunk - 1:
            self.chunk_in = _clone(state)
        elif chunk == self.check_chunk:
            self.chunk_out = _clone(state)

    def window(self, seconds: float, span) -> dict:
        """Whole episodes until ``seconds`` have passed; the card is
        synchronised at both ends and after each episode."""
        self.sim.synchronize()
        with span(WINDOW):
            t0 = perf_counter()
            episodes = self._episodes(seconds, span, t0)
            elapsed = perf_counter() - t0
        chunks = episodes * (self.steps // self.K)
        return {"seconds": elapsed, "episodes": episodes, "chunks": chunks,
                "world_steps": episodes * self.steps * self.n, "attempted": chunks}

    episode_ends = ()

    def _episodes(self, seconds: float, span, t0: float) -> int:
        episodes, self.episode_ends = 0, []
        while True:
            states = [_clone(s) for s in self.base]
            first = episodes == 0
            if first and self.check_chunk == 0:
                self.chunk_in = _clone(states[0])
            with span("portbench.replay.episode"):
                self.replay_episode(self.sim, states, self.targets, self.act_ids, self.steps,
                                    on_step=self._capture if first else None)
            with span("portbench.sync"):
                self.sim.synchronize()
            episodes += 1
            self.episode_ends.append(perf_counter() - t0)
            if perf_counter() - t0 >= seconds:
                return episodes

    def end_to_end(self, w: dict) -> dict:
        return {"world_steps_per_s": w["world_steps"] / w["seconds"]}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.sim = self.base = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> list:
        """``(name, gap, limit)`` of the start, the last settle step and the
        window's chunk against the reference, computed in ``control``'s
        precision (None: float32)."""
        model, state0, _meta = load_world(self.world)
        static = emitter._Static(model)
        dev = self.device
        start = state0.to(dev).map(lambda x: x.expand((self.n,) + x.shape[1:]).clone())
        ctrl = start.ctrl.clone()
        ctrl[:, torch.tensor(self.adh_ids, device=dev)] = 1.0
        start = replace(start, ctrl=ctrl, qpos=torch.cat(
            [start.qpos[:, :3] + self.jitter, start.qpos[:, 3:]], dim=1))
        fields = STATE_FIELDS + ("ctrl", "time")
        out = [("start", state_gap(self.start, start, fields), self.limits["start"])]

        s_in = State.of(self.settle_in)
        ref, _rows = plain_chain(static, s_in, s_in.ctrl[None], control)
        out.append(("settle_step", state_gap(self.settle_out, ref), self.limits["settle_step"]))

        c_in = State.of(self.chunk_in)
        seq = c_in.ctrl.expand((self.K,) + c_in.ctrl.shape).clone()
        i0 = self.check_chunk * self.K
        seq[:, :, self.act_ids] = self.targets[:, i0: i0 + self.K].transpose(0, 1)
        ref, _rows = plain_chain(static, c_in, seq, control)
        chunk = max(state_gap(self.chunk_out, ref), gap(self.chunk_out.ctrl, ref.ctrl))
        out.append(("chunk", chunk, self.limits["chunk"]))
        return out


def setup(config: dict, mix: dict, seed: int, device) -> ReplayRun:
    return ReplayRun(config, mix, seed, device)
