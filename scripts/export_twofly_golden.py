"""Export example 11's two stacked flies for the PyTorch port.

``examples/11_two_flies_interacting.py`` builds two LEGS_ONLY flies with leg
adhesion in one flat world, "bottom" at (0, 0, 1.2) and "top" at (0, 0,
3.2), joined by 49 capsule-capsule contact pair rows between their thorax,
abdomen and head capsules; the top fly drops onto the bottom one and the
stack settles. This script runs the JAX package on the CPU and writes:

- ``flygym_tpu_torch/assets/twofly.npz``: the compiled world and both flies'
  index maps, as ``scripts/export_torch_model.py`` writes the benchmark fly.
- ``flygym_tpu_torch/assets/twofly_golden.npz``: 8 worlds whose top fly is
  moved by seeded xy offsets (``offsets``, uniform in +-0.1 mm) so that the
  worlds differ, with adhesion 1 on the bottom fly's legs, settled by
  example 11's 800 steps through the vmapped engine step; then 16 steps
  recorded three times:

  - ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
    emit_step``), stepped eagerly on (B,) arrays;
  - ``engine.*``: the vmapped engine step;
  - ``probe.*``: the same engine step from the settled state perturbed by
    1e-5 relative in qpos and 1e-5 absolute in qvel (seeded normal noise):
    the stacked flies are ill-conditioned, so a port of the engine step is
    held to this probe's spread rather than to a fixed tolerance.

  Each records per step ``qpos``, ``qvel`` and ``sensordata``. The script
  checks that every settled world has at least one active pair row.

Run from the repository root (about 5-10 minutes on one CPU core, most of it
the eager emitter)::

    JAX_PLATFORMS=cpu python scripts/export_twofly_golden.py
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
MODEL_PATH = ASSETS / "twofly.npz"
GOLDEN_PATH = ASSETS / "twofly_golden.npz"
EXAMPLE = REPO / "examples" / "11_two_flies_interacting.py"

GOLDEN_WORLDS = 8
GOLDEN_SETTLE_STEPS = 800  # example 11's rollout
GOLDEN_STEPS = 16
TOP_OFFSET_MM = 0.1
PROBE_EPS = 1e-5
SEED = 0


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_world():
    """Example 11's world, built by the example's own function."""
    return _load("example_11", EXAMPLE).make_two_fly_world()


def export_model():
    """Example 11's world compiled by the JAX package and flattened:
    ``(world, jax simulation, arrays, meta)``."""
    import flygym_tpu

    world = build_world()
    sim = flygym_tpu.Simulation(world)
    arrays, meta = _load("export_torch_model", REPO / "scripts" / "export_torch_model.py").export(
        world, sim)
    return world, sim, arrays, meta


def top_offsets(n_worlds=GOLDEN_WORLDS, seed=SEED) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-TOP_OFFSET_MM, TOP_OFFSET_MM, (n_worlds, 2)).astype(np.float32)


def settled_state(sim, offsets, settle_steps=GOLDEN_SETTLE_STEPS):
    """The top fly's root moved by ``offsets`` (forward kinematics redone),
    adhesion 1 on the bottom fly, then ``settle_steps`` vmapped engine
    steps."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.kinematics import forward_kinematics
    from flygym_tpu.engine.model import compute_site_xpos
    from flygym_tpu.engine.step import step

    sim.set_leg_adhesion_states("bottom", np.ones((offsets.shape[0], 6), np.float32))
    st = sim.state
    model = sim.model
    _body, qadr, _vadr = model.free_joints[1]
    qpos = st.qpos.at[:, qadr : qadr + 2].add(jnp.asarray(offsets))
    xpos, xquat = jax.vmap(lambda q: forward_kinematics(model, q))(qpos)
    site = jax.vmap(lambda p, q: compute_site_xpos(model, p, q))(xpos, xquat)
    st = dataclasses.replace(st, qpos=qpos, xpos=xpos, xquat=xquat, site_xpos=site)
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    for _ in range(settle_steps):
        st = vstep(model, st)
    return st


def active_pair_rows(model, st) -> np.ndarray:
    """(B,) count of pair rows closer than their margin in each world."""
    import jax

    from flygym_tpu.engine.contact import contact_candidates
    from flygym_tpu.engine.kinematics import geom_poses

    gpos, gquat = jax.vmap(geom_poses, in_axes=(None, 0, 0))(model, st.xpos, st.xquat)
    dist = jax.vmap(contact_candidates, in_axes=(None, 0, 0))(model, gpos, gquat)[0]
    ng = model.ncand - model.ncand_pair
    return np.asarray((dist[:, ng:] < model.can_margin[ng:]).sum(axis=1))


def perturbed(st, eps=PROBE_EPS, seed=SEED):
    """The conditioning probe's start: qpos scaled by 1 + eps N(0, 1), qvel
    moved by eps N(0, 1) (``tests/tpu/test_megastep_tpu.py:421-428``, with
    numpy's generator)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed + 1)
    nq = rng.standard_normal(st.qpos.shape).astype(np.float32)
    nv = rng.standard_normal(st.qvel.shape).astype(np.float32)
    return dataclasses.replace(st, qpos=st.qpos * (1.0 + eps * jnp.asarray(nq)),
                               qvel=st.qvel + eps * jnp.asarray(nv))


def engine_loop(model, st, name, n_steps=GOLDEN_STEPS) -> dict:
    import jax

    from flygym_tpu.engine.step import step

    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    rec = {"qpos": [], "qvel": [], "sensordata": []}
    for _ in range(n_steps):
        st = vstep(model, st)
        rec["qpos"].append(np.asarray(st.qpos))
        rec["qvel"].append(np.asarray(st.qvel))
        rec["sensordata"].append(np.asarray(st.contact_sensordata))
    return {f"{name}.{k}": np.stack(v) for k, v in rec.items()}


def emitter_loop(model, st, n_steps=GOLDEN_STEPS) -> dict:
    """The mega-step emitter stepped eagerly on (B,) arrays."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep

    jst = megastep._Static(model)
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    q, v, act, warm = cols(st.qpos), cols(st.qvel), cols(st.act), cols(st.qacc)
    ctrl = cols(st.ctrl)
    rec = {"qpos": [], "qvel": [], "sensordata": []}
    for t in range(n_steps):
        r = megastep.emit_step(jst, q, v, ctrl, act, warm)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        rec["qpos"].append(pack(q))
        rec["qvel"].append(pack(v))
        rec["sensordata"].append(np.stack([pack(s) for s in r["sensordata"]], axis=1))
        print(f"emitter step {t + 1}/{n_steps}", flush=True)
    return {f"emitter.{k}": np.stack(v) for k, v in rec.items()}


def main():
    # The goldens are taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.engine.model import State

    exporter = _load("export_torch_model", REPO / "scripts" / "export_torch_model.py")
    world, _sim, arrays, meta = export_model()
    exporter.save_npz(MODEL_PATH, arrays, meta)
    print(f"wrote {MODEL_PATH} ({MODEL_PATH.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    model = bsim.model
    offsets = top_offsets()
    settled = settled_state(bsim, offsets)
    active = active_pair_rows(model, settled)
    print(f"settled; active pair rows per world {active.tolist()}", flush=True)
    if not (active > 0).all():
        raise RuntimeError(f"a settled world has no active pair row: {active.tolist()}")
    golden = {
        f"state.{f.name}": np.asarray(getattr(settled, f.name))
        for f in dataclasses.fields(State)
    }
    golden["offsets"] = offsets
    golden.update(engine_loop(model, settled, "engine"))
    golden.update(engine_loop(model, perturbed(settled), "probe"))
    print("engine golden and probe done", flush=True)
    golden.update(emitter_loop(model, settled))
    gmeta = {
        "n_worlds": GOLDEN_WORLDS,
        "settle_steps": GOLDEN_SETTLE_STEPS,
        "n_steps": GOLDEN_STEPS,
        "top_offset_mm": TOP_OFFSET_MM,
        "probe_eps": PROBE_EPS,
        "seed": SEED,
    }
    exporter.save_npz(GOLDEN_PATH, golden, gmeta)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
