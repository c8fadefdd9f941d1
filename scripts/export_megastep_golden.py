"""Export the JAX mega-step golden of the replay for the PyTorch port.

The port's mega-step kernel (K2) solves every ground candidate, as the JAX
package's mega-step does, while the engine step keeps the top 16 contacts,
so K2 is held against the JAX emitter and not against the engine golden.
This script runs ``flygym_tpu.ops.megastep.emit_step`` eagerly on (B,)
arrays (the pattern of ``tests/engine/test_megastep.py:70-100``) from the
settled state of ``flygym_tpu_torch/assets/benchmark_fly_golden.npz``, for
the same 8 worlds and 50 replay steps, and writes
``flygym_tpu_torch/assets/benchmark_fly_megastep_golden.npz``: the settled
state, the targets, and qpos, qvel and contact sensor data at every step.

Run from the repository root (about 5 minutes on one CPU core)::

    JAX_PLATFORMS=cpu python scripts/export_megastep_golden.py
"""

import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
MODEL_PATH = ASSETS / "benchmark_fly.npz"
ENGINE_GOLDEN_PATH = ASSETS / "benchmark_fly_golden.npz"
GOLDEN_PATH = ASSETS / "benchmark_fly_megastep_golden.npz"


def _read(path):
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(str(npz["meta"]))
        arrays = {k: npz[k] for k in npz.files if k != "meta"}
    return arrays, meta


def emit_rollout(jax_model, state: dict, targets: np.ndarray, act_ids, n_steps: int):
    """``n_steps`` chained JAX emitter steps of the replay.

    Args:
        jax_model: The compiled JAX ``PhysicsModel``.
        state: ``{field: (B, ...) ndarray}`` of the settled state.
        targets: (B, >= n_steps, n_dofs) target angles.
        act_ids: The position actuators' model indices.

    Returns:
        (qpos, qvel, sensordata), each (n_steps, B, ...) float32 arrays.
    """
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep

    st = megastep._Static(jax_model)
    cols = lambda x: [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    q, v, act, warm = (cols(state[k]) for k in ("qpos", "qvel", "act", "qacc"))
    ctrl = np.array(state["ctrl"], np.float32)
    stack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    qpos, qvel, sens = [], [], []
    for i in range(n_steps):
        ctrl[:, act_ids] = targets[:, i]
        r = megastep.emit_step(st, q, v, cols(ctrl), act, warm)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        qpos.append(stack(q))
        qvel.append(stack(v))
        sens.append(np.stack([stack(s_) for s_ in r["sensordata"]], axis=1))
    return np.stack(qpos), np.stack(qvel), np.stack(sens)


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from flygym_tpu.demo.benchmark import make_model

    _fly, world, _cam = make_model()
    jax_model, _state0 = world.compile()
    _arrays, model_meta = _read(MODEL_PATH)
    fly = next(iter(model_meta["flies"].values()))
    act_ids = np.asarray(fly["act_ids"]["position"])

    engine, engine_meta = _read(ENGINE_GOLDEN_PATH)
    state = {k[len("state."):]: v for k, v in engine.items() if k.startswith("state.")}
    n_steps = int(engine_meta["n_steps"])
    qpos, qvel, sens = emit_rollout(jax_model, state, engine["targets"], act_ids, n_steps)

    arrays = {f"state.{k}": v for k, v in state.items()}
    arrays.update(targets=engine["targets"], qpos=qpos, qvel=qvel, sensordata=sens)
    meta = dict(engine_meta, path="mega-step emitter (flygym_tpu/ops/megastep.py emit_step)")
    np.savez_compressed(GOLDEN_PATH, meta=np.array(json.dumps(meta, sort_keys=True)), **arrays)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
