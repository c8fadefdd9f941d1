"""Export the vision-and-odor RL environment (config 5) for the PyTorch port.

Config 5 of ``BASELINE.json`` is multimodal navigation with vmapped flies
for RL training; ``examples/09_multimodal_navigation.py`` builds it: the
default walking world of ``flygym_tpu/env/gym.py`` (LEGS_ONLY, 42 position
actuators at kp 50, leg adhesion, flat ground), an attractor sphere at
(30, 0, 3) of radius 3, an odor source at (30, 0, 1) of peak 1, vision on,
10 physics steps per env step. This script runs the JAX package on the CPU
and writes:

- ``flygym_tpu_torch/assets/env_fly.npz``: the compiled world, as
  ``scripts/export_torch_model.py`` writes the benchmark fly, with a
  ``meta["env"]`` entry: the env's index maps (actuators, joints, contact
  sensors, root, eyes and leg tips), ``decision_interval`` and the odor
  field's tables.
- ``flygym_tpu_torch/assets/env_fly_golden.npz``: the JAX state of 8 worlds
  from ``reset_batched(PRNGKey(0), 8)`` after 2,500 vmapped engine steps at
  the neutral joint targets with adhesion on; the actions of 5 env steps
  (neutral targets plus 0.05 rad of numpy noise, seed 0, adhesion on); and
  for each env step ``qpos``, ``qvel``, every observation, reward and done
  from two JAX paths:

  - ``engine.*``: ``VectorFlyEnv.make_batched_step()`` on the CPU (the
    vmapped engine step and the jnp retina);
  - ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
    emit_step``), stepped eagerly as ``scripts/export_megastep_golden.py``
    steps it, observed with the env's ``observe`` and ``_reward_done``.
    ``xpos``/``xquat`` are the emitter's own outputs: the pose that each
    step started from, as the engine's state carries it.

Run from the repository root (about 9 minutes on one CPU core, most of it
the eager emitter)::

    JAX_PLATFORMS=cpu python scripts/export_env_golden.py
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
MODEL_PATH = ASSETS / "env_fly.npz"
GOLDEN_PATH = ASSETS / "env_fly_golden.npz"

GOLDEN_WORLDS = 8
GOLDEN_SETTLE_STEPS = 2500
GOLDEN_ENV_STEPS = 5
ACTION_NOISE = 0.05
SEED = 0
ADHESION_ON = 100.0  # the env's 1 + 99 * clip(1.0)

ATTRACTOR = dict(pos=(30.0, 0.0, 3.0), radius=3.0)
ODOR = dict(source_pos=[[30.0, 0.0, 1.0]], peak_intensity=[[1.0]])
DECISION_INTERVAL = 10


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_env():
    """Config 5 as ``examples/09_multimodal_navigation.py:25-38`` builds it."""
    from flygym_tpu.env.gym import VectorFlyEnv, _build_default_world
    from flygym_tpu.olfaction import OdorField

    fly, world = _build_default_world()
    world.add_object("attractor", ATTRACTOR["pos"], radius=ATTRACTOR["radius"])
    world.compile()
    odor = OdorField.for_fly(world, fly.name, **ODOR)
    env = VectorFlyEnv(
        world, fly.name, enable_vision=True, odor_field=odor,
        decision_interval=DECISION_INTERVAL,
    )
    return fly, world, env


def env_meta(env) -> dict:
    """The env's index maps and tables, as the port's ``VectorFlyEnv`` reads them."""
    ids = lambda x: [int(i) for i in np.asarray(x)]
    odor = env.odor_field
    return {
        "fly": env.fly_name,
        "decision_interval": int(env.decision_interval),
        "act_ids": ids(env._act_ids),
        "adh_ids": ids(env._adh_ids),
        "qpos_adrs": ids(env._qpos_adrs),
        "qvel_adrs": ids(env._qvel_adrs),
        "sensor_slots": ids(env._sensor_slots),
        "root_body": int(env._root_body),
        "tip_bodies": ids(env._tip_bodies),
        "eye_bodies": [int(env.retina.left_eye_body), int(env.retina.right_eye_body)],
        "odor": {
            "source_pos": np.asarray(odor.source_pos, np.float32).tolist(),
            "peak_intensity": np.asarray(odor.peak_intensity, np.float32).tolist(),
            "sensor_bodies": ids(odor.sensor_bodies),
            "sensor_offsets": np.asarray(odor.sensor_offsets, np.float32).tolist(),
            "diffusion": odor.diffusion,
            "gaussian_scale": float(odor.gaussian_scale),
        },
    }


def settled_state(env, n_worlds=GOLDEN_WORLDS, settle_steps=GOLDEN_SETTLE_STEPS):
    """``reset_batched(PRNGKey(0), n)``, then vmapped engine steps at the
    neutral joint targets with adhesion on."""
    import jax

    from flygym_tpu.engine.step import step

    states = env.reset_batched(jax.random.PRNGKey(SEED), n_worlds)
    states = dataclasses.replace(
        states, ctrl=states.ctrl.at[:, env._adh_ids].set(ADHESION_ON)
    )
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    for _ in range(settle_steps):
        states = vstep(env.model, states)
    return states


def make_actions(env, n_worlds=GOLDEN_WORLDS, n_steps=GOLDEN_ENV_STEPS):
    """(n_steps, B, 42) joint targets and (n_steps, B, 6) adhesion actions."""
    neutral = np.asarray(env._state0.ctrl)[np.asarray(env._act_ids)]
    rng = np.random.default_rng(SEED)
    joints = neutral + ACTION_NOISE * rng.standard_normal((n_steps, n_worlds, neutral.size))
    return joints.astype(np.float32), np.ones((n_steps, n_worlds, 6), np.float32)


def _record(out, prefix, states, obs, reward, done):
    out.setdefault(f"{prefix}.qpos", []).append(np.asarray(states.qpos))
    out.setdefault(f"{prefix}.qvel", []).append(np.asarray(states.qvel))
    for key, value in obs.items():
        out.setdefault(f"{prefix}.obs.{key}", []).append(np.asarray(value))
    out.setdefault(f"{prefix}.reward", []).append(np.asarray(reward))
    out.setdefault(f"{prefix}.done", []).append(np.asarray(done))


def engine_rollout(env, states, joints, adhesion) -> dict:
    """The JAX env's batched step (vmapped engine + jnp retina on the CPU)."""
    import jax.numpy as jnp

    step = env.make_batched_step()
    out = {}
    for i in range(joints.shape[0]):
        action = {"joints": jnp.asarray(joints[i]), "adhesion": jnp.asarray(adhesion[i])}
        states, obs, reward, done, _ = step(states, action)
        _record(out, "engine", states, obs, reward, done)
    return {k: np.stack(v) for k, v in out.items()}


def emitter_rollout(env, states, joints, adhesion) -> dict:
    """The JAX mega-step emitter, ``decision_interval`` eager steps per env
    step, observed with the env's ``observe`` and ``_reward_done``."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State
    from flygym_tpu.ops import megastep

    st = megastep._Static(env.model)
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    rows = lambda vecs, width: (
        np.stack([pack(p) for p in vecs], axis=1) if vecs
        else np.zeros((states.qpos.shape[0], 0, width), np.float32)
    )
    q, v, act, warm = (cols(getattr(states, k)) for k in ("qpos", "qvel", "act", "qacc"))
    ctrl = np.array(states.ctrl, np.float32)
    time = np.asarray(states.time)
    act_ids, adh_ids = np.asarray(env._act_ids), np.asarray(env._adh_ids)
    observe = jax.jit(jax.vmap(env.observe))
    reward_done = jax.jit(jax.vmap(env._reward_done))
    out = {}
    for i in range(joints.shape[0]):
        ctrl[:, act_ids] = joints[i]
        ctrl[:, adh_ids] = 1.0 + 99.0 * np.clip(adhesion[i], 0.0, 1.0)
        for _ in range(env.decision_interval):
            r = megastep.emit_step(st, q, v, cols(ctrl), act, warm)
            q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        time = time + env.decision_interval * env.model.timestep
        na = len(r["act"])
        state = State(
            qpos=jnp.asarray(pack(r["qpos"])),
            qvel=jnp.asarray(pack(r["qvel"])),
            ctrl=jnp.asarray(ctrl),
            act=jnp.asarray(pack(r["act"]) if na else np.zeros((ctrl.shape[0], 0), np.float32)),
            time=jnp.asarray(time, jnp.float32),
            qacc=jnp.asarray(pack(r["qacc"])),
            xpos=jnp.asarray(rows(r["xpos"], 3)),
            xquat=jnp.asarray(rows(r["xquat"], 4)),
            site_xpos=jnp.asarray(rows(r["site_xpos"], 3)),
            actuator_force=jnp.asarray(pack(r["actuator_force"])),
            contact_sensordata=jnp.asarray(rows(r["sensordata"], 16)),
        )
        reward, done = reward_done(state)
        _record(out, "emitter", state, observe(state), reward, done)
        print(f"emitter env step {i + 1}/{joints.shape[0]}", flush=True)
    return {k: np.stack(v) for k, v in out.items()}


def main():
    # The golden is taken on the CPU backend (full fp32 matmuls), on the
    # vmapped engine step.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import flygym_tpu
    from flygym_tpu.engine.model import State

    exporter = _load_script("export_torch_model")
    _fly, world, env = build_env()
    sim = flygym_tpu.Simulation(world)
    arrays, meta = exporter.export(world, sim)
    np.testing.assert_array_equal(arrays["state.qpos"], np.asarray(env._state0.qpos))
    meta["env"] = env_meta(env)
    exporter.save_npz(MODEL_PATH, arrays, meta)
    print(f"wrote {MODEL_PATH} ({MODEL_PATH.stat().st_size} bytes)", flush=True)

    settled = settled_state(env)
    joints, adhesion = make_actions(env)
    golden = {
        f"state.{f.name}": np.asarray(getattr(settled, f.name))
        for f in dataclasses.fields(State)
    }
    golden.update(joints=joints, adhesion=adhesion)
    golden.update(engine_rollout(env, settled, joints, adhesion))
    print("engine golden done", flush=True)
    golden.update(emitter_rollout(env, settled, joints, adhesion))
    gmeta = {
        "n_worlds": GOLDEN_WORLDS,
        "settle_steps": GOLDEN_SETTLE_STEPS,
        "n_env_steps": GOLDEN_ENV_STEPS,
        "decision_interval": DECISION_INTERVAL,
        "action_noise": ACTION_NOISE,
        "seed": SEED,
    }
    exporter.save_npz(GOLDEN_PATH, golden, gmeta)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
