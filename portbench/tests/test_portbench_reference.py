"""The reference against the port's own plain versions on the CPU, at two
worlds and a few steps: the frozen emitter equals
``flygym_tpu_torch.ops.megastep.megastep_plain`` and the plain env step
equals ``VectorFlyEnv``'s (state, reward, done, every observation), to the
last bit."""

from dataclasses import fields, replace
from pathlib import Path

import torch

from portbench.reference import emitter
from portbench.reference.env import EnvReference
from portbench.reference.model import State, load_world
from portbench.registry import Benchmark

BENCH = Benchmark()


def _world(name):
    cfg = BENCH.config(name)
    return Path(cfg["dir"]) / cfg["world"]


def _as(cls, state):
    return cls(**{f.name: getattr(state, f.name).clone() for f in fields(cls)})


def test_emitter_equals_the_ports_plain_step():
    from flygym_tpu_torch.compose.bridge import load_compiled
    from flygym_tpu_torch.engine.model import State as PortState
    from flygym_tpu_torch.ops import megastep

    path = _world("benchmark_fly")
    compiled = load_compiled(path)
    model, state0, _meta = load_world(path)
    gen = torch.Generator().manual_seed(3)
    state = state0.map(lambda x: x.expand((2,) + x.shape[1:]).clone())
    qpos = state.qpos.clone()
    qpos[:, 7:] += 0.05 * torch.randn(qpos[:, 7:].shape, generator=gen)
    state = replace(state, qpos=qpos)
    seq = state.ctrl.expand((2,) + state.ctrl.shape).clone()
    seq[1, :, :42] += 0.1
    want, want_rows = megastep.megastep_plain(megastep._Static(compiled.model),
                                              _as(PortState, state), seq)
    got, rows = emitter.megastep_plain(emitter._Static(model), state, seq)
    assert torch.equal(rows, want_rows)
    for f in fields(State):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_env_step_equals_the_ports():
    from flygym_tpu_torch.compose.bridge import load_compiled
    from flygym_tpu_torch.env.gym import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    path = _world("env_fly")
    compiled = load_compiled(path)
    env = VectorFlyEnv(compiled, device="cpu", megastep=True, decision_interval=2,
                       enable_vision=True, odor_field=OdorField.for_compiled(compiled))
    ref = EnvReference(path, "cpu", vision_on=True, odor_on=True, decision_interval=2)
    got0 = env.reset_batched(torch.Generator().manual_seed(5), 2)
    want0 = ref.reset(torch.Generator().manual_seed(5), 2)
    for f in fields(State):
        assert torch.equal(getattr(got0, f.name), getattr(want0, f.name)), f.name
    gen = torch.Generator().manual_seed(1)
    action = {"joints": want0.ctrl[0, ref.act_ids] + 0.05 * torch.randn((2, 42), generator=gen),
              "adhesion": torch.ones(2, 6)}
    state, obs, reward, done, _ = env.step(got0, action)
    want = ref.advance(want0, action)
    want_reward, want_done = ref.reward_done(want)
    want_obs = ref.observe(want)
    for f in fields(State):
        assert torch.equal(getattr(state, f.name), getattr(want, f.name)), f.name
    assert torch.equal(reward, want_reward) and torch.equal(done, want_done)
    assert set(obs) == set(want_obs)
    for k in obs:
        assert torch.equal(obs[k], want_obs[k]), k
