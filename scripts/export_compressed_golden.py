"""Export the worlds with compressed fly-fly pair rows for the PyTorch port.

Two presets, each compiled and run by the JAX package on the CPU:

- **The default two-fly preset** (``scripts/dev/bench_models.py:
  make_two_fly_world(full_pairs=True)``): two LEGS_ONLY flies with leg
  adhesion, "bottom" at (0, 0, 1.2) and "top" at (0, 0, 3.2), joined by
  ``world.add_fly_fly_contacts("bottom", "top")`` with its default
  LEGS_THORAX_ABDOMEN_HEAD preset: 55 x 55 = 3,025 capsule-capsule pair rows,
  which the compile compresses (512 rows or more) to one row per geom1 group,
  55 groups of 55. Written as ``flygym_tpu_torch/assets/twofly_full.npz`` and
  ``twofly_full_golden.npz``.
- **The 3-fly pile** (``tests/core/test_multifly.py::TestThreeFlies``): three
  bare LEGS_ONLY flies (no actuators, no sensors) stacked at z 1.2, 3.0 and
  4.8, all-pairs contacts between each fly's thorax and 6 tarsi (147 pair
  rows), ``pair_compress`` forced on: 21 groups of 7, each facing one
  opposing fly. Written as ``threefly.npz`` and ``threefly_golden.npz``.

Each golden holds 8 worlds whose flies above the first are moved by seeded
xy offsets (``offsets``, uniform in +-0.1 mm), with adhesion 1 on the bottom
fly's legs where it has adhesion, settled through the vmapped engine step
(800 steps for two flies, example 11's depth; 1,100 for the pile, where
every world has an active compressed row), then 16 steps recorded three
times:

- ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.
  emit_step``) stepped eagerly on (B,) arrays, fed the winners of
  ``make_pair_winner_sampler`` sampled at steps 0 and 8 from the cached pose
  (the K = 8 chunking of ``rollout_batched``); the winners are stored as
  ``emitter.widx``, (2, B, n_groups);
- ``engine.*``: the vmapped engine step, which picks winners in the step;
- ``probe.*``: the engine step from the settled state perturbed by 1e-5
  relative in qpos and 1e-5 absolute in qvel (the conditioning probe of
  ``scripts/export_twofly_golden.py``).

Each records per step ``qpos``, ``qvel`` and ``sensordata``. ``settled_gap``
holds, per world, each fly's root height above the fly below it after the
settle. The script checks that every settled world has an active compressed
row (a winner closer than its margin) and records the smallest root gap in
the golden's meta (``settled_gap_min``); it warns where that gap is under
example 11's 0.4 mm rest check.

Run from the repository root (about 10-20 minutes on one CPU core, most of
it the eager emitter on the 55 x 55 preset)::

    JAX_PLATFORMS=cpu python scripts/export_compressed_golden.py

``--slide-off N`` writes nothing: it drops the default preset's top fly in N
worlds (seeded offsets in +-0.1 mm), runs 800 JAX engine steps and prints
how many worlds end with the top root less than 0.4 mm above the bottom one,
and how far from it in xy (about 5 minutes at N = 512)::

    JAX_PLATFORMS=cpu python scripts/export_compressed_golden.py --slide-off 512
"""

import dataclasses
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"

GOLDEN_WORLDS = 8
GOLDEN_STEPS = 16
OFFSET_MM = 0.1
PROBE_EPS = 1e-5
REST_GAP_MM = 0.4  # example 11's check: the upper root 0.4 mm above the lower
WINNER_K = 8  # the emitter's winners are sampled once per 8 steps
SEED = 0

PRESETS = {
    "twofly_full": {"settle_steps": 800},
    # The pile rings: its tarsi touch and leave the flies below, so an
    # active compressed row in all 8 worlds holds at some steps only. At
    # 1,500 steps (``test_three_fly_pile_settles``) three worlds have none;
    # at 1,100 every world has one.
    "threefly": {"settle_steps": 1100},
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_world(preset: str):
    """The composed JAX world of ``preset``."""
    if preset == "twofly_full":
        bench = _load("bench_models", REPO / "scripts" / "dev" / "bench_models.py")
        return bench.make_two_fly_world(full_pairs=True)
    from flygym_tpu.anatomy import (
        ALL_SEGMENT_NAMES, AxisOrder, BodySegment, JointPreset, Skeleton)
    from flygym_tpu.compose import FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    world = FlatGroundWorld()
    for i, name in enumerate(("a", "b", "c")):
        fly = Fly(name=name)
        fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=KinematicPosePreset.NEUTRAL)
        world.add_fly(fly, (0, 0, 1.2 + 1.8 * i), Rotation3D("quat", (1, 0, 0, 0)))
    segs = [BodySegment("c_thorax")] + [
        BodySegment(s) for s in ALL_SEGMENT_NAMES if s.endswith("tarsus5")]
    world.add_all_fly_fly_contacts(bodysegs=segs)
    world._spec.options["pair_compress"] = True
    return world


def export_model(preset: str):
    """``preset``'s world compiled by the JAX package and flattened:
    ``(world, jax simulation, arrays, meta)``."""
    import flygym_tpu

    world = build_world(preset)
    sim = flygym_tpu.Simulation(world)
    arrays, meta = _load("export_torch_model", REPO / "scripts" / "export_torch_model.py").export(
        world, sim)
    return world, sim, arrays, meta


def fly_offsets(n_flies: int, n_worlds=GOLDEN_WORLDS, seed=SEED) -> np.ndarray:
    """(n_worlds, n_flies - 1, 2) xy offsets of the flies above the first."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-OFFSET_MM, OFFSET_MM, (n_worlds, n_flies - 1, 2)).astype(np.float32)


def settled_state(bsim, world, offsets, settle_steps: int):
    """Every fly above the first moved by its offset (forward kinematics
    redone), adhesion 1 on the first fly where it has adhesion, then
    ``settle_steps`` vmapped engine steps."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.kinematics import forward_kinematics
    from flygym_tpu.engine.model import compute_site_xpos
    from flygym_tpu.engine.step import step

    first = next(iter(world.fly_lookup))
    if bsim._adh_ids.get(first) is not None and len(bsim._adh_ids[first]):
        bsim.set_leg_adhesion_states(first, np.ones((offsets.shape[0], 6), np.float32))
    st = bsim.state
    model = bsim.model
    qpos = st.qpos
    for i, (_body, qadr, _vadr) in enumerate(model.free_joints[1:]):
        qpos = qpos.at[:, qadr : qadr + 2].add(jnp.asarray(offsets[:, i]))
    xpos, xquat = jax.vmap(lambda q: forward_kinematics(model, q))(qpos)
    site = jax.vmap(lambda p, q: compute_site_xpos(model, p, q))(xpos, xquat)
    st = dataclasses.replace(st, qpos=qpos, xpos=xpos, xquat=xquat, site_xpos=site)
    vstep = jax.jit(jax.vmap(step, in_axes=(None, 0)))
    for _ in range(settle_steps):
        st = vstep(model, st)
    return st


def root_gaps(model, st) -> np.ndarray:
    """(B, n_flies - 1) each fly's root z above the root of the fly below."""
    qpos = np.asarray(st.qpos)
    z = np.stack([qpos[:, qadr + 2] for _b, qadr, _v in model.free_joints], axis=1)
    return z[:, 1:] - z[:, :-1]


def winners(model, xpos, xquat) -> np.ndarray:
    """(B, n_groups) float32 winners of JAX's pair-winner sampler."""
    import jax.numpy as jnp

    from flygym_tpu.engine.contact import make_pair_winner_sampler

    return np.asarray(make_pair_winner_sampler(model)(jnp.asarray(xpos), jnp.asarray(xquat)))


def active_winner_rows(model, st) -> np.ndarray:
    """(B,) count of compressed rows whose winner is closer than its margin."""
    import jax

    from flygym_tpu.engine.contact import contact_candidates
    from flygym_tpu.engine.kinematics import geom_poses

    gpos, gquat = jax.vmap(geom_poses, in_axes=(None, 0, 0))(model, st.xpos, st.xquat)
    dist = np.asarray(jax.vmap(contact_candidates, in_axes=(None, 0, 0))(model, gpos, gquat)[0])
    ng = model.ncand - model.ncand_pair
    margin = np.asarray(model.can_margin)
    w = winners(model, st.xpos, st.xquat).astype(np.int64)
    count = np.zeros(dist.shape[0], np.int64)
    for g, (start, _size) in enumerate(model.pair_groups):
        rows = ng + start + w[:, g]
        count += dist[np.arange(dist.shape[0]), rows] < margin[rows]
    return count


def emitter_loop(model, st, n_steps=GOLDEN_STEPS) -> dict:
    """The mega-step emitter stepped eagerly on (B,) arrays, with winners
    sampled every WINNER_K steps from the pose the last step cached."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep

    jst = megastep._Static(model)
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    q, v, act, warm = cols(st.qpos), cols(st.qvel), cols(st.act), cols(st.qacc)
    ctrl = cols(st.ctrl)
    xpos, xquat = np.asarray(st.xpos), np.asarray(st.xquat)
    rec = {"qpos": [], "qvel": [], "sensordata": [], "widx": []}
    for t in range(n_steps):
        t0 = time.perf_counter()
        if t % WINNER_K == 0:
            w = winners(model, xpos, xquat)
            rec["widx"].append(w)
            widx = cols(w)
        r = megastep.emit_step(jst, q, v, ctrl, act, warm, None, widx)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        xpos = np.stack([pack(p) for p in r["xpos"]], axis=1)
        xquat = np.stack([pack(p) for p in r["xquat"]], axis=1)
        rec["qpos"].append(pack(q))
        rec["qvel"].append(pack(v))
        sens = [pack(s) for s in r["sensordata"]]
        rec["sensordata"].append(np.stack(sens, axis=1) if sens
                                 else np.zeros((pack(q).shape[0], 0, 16), np.float32))
        print(f"emitter step {t + 1}/{n_steps} in {time.perf_counter() - t0:.1f} s", flush=True)
    return {f"emitter.{k}": np.stack(v) for k, v in rec.items()}


def export_preset(preset: str) -> None:
    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.engine.model import State

    twofly = _load("export_twofly_golden", REPO / "scripts" / "export_twofly_golden.py")
    exporter = _load("export_torch_model", REPO / "scripts" / "export_torch_model.py")
    model_path, golden_path = ASSETS / f"{preset}.npz", ASSETS / f"{preset}_golden.npz"
    world, _sim, arrays, meta = export_model(preset)
    exporter.save_npz(model_path, arrays, meta)
    print(f"wrote {model_path} ({model_path.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    model = bsim.model
    if not (model.pair_compress and model.ncand_pair):
        raise RuntimeError(f"{preset}: the pair rows are not compressed")
    offsets = fly_offsets(len(model.free_joints))
    t0 = time.perf_counter()
    settled = settled_state(bsim, world, offsets, PRESETS[preset]["settle_steps"])
    gaps = root_gaps(model, settled)
    active = active_winner_rows(model, settled)
    print(f"{preset}: settled in {time.perf_counter() - t0:.1f} s; root gaps min "
          f"{gaps.min():.4f} mm; active compressed rows per world {active.tolist()}", flush=True)
    if not (active > 0).all():
        raise RuntimeError(f"{preset}: a settled world has no active compressed row")
    if gaps.min() <= REST_GAP_MM:
        print(f"{preset}: warning: the smallest settled root gap {gaps.min():.4f} mm is "
              f"under the {REST_GAP_MM} mm rest check", flush=True)
    golden = {
        f"state.{f.name}": np.asarray(getattr(settled, f.name))
        for f in dataclasses.fields(State)
    }
    golden["offsets"] = offsets
    golden["settled_gap"] = gaps
    golden.update(twofly.engine_loop(model, settled, "engine"))
    golden.update(twofly.engine_loop(model, twofly.perturbed(settled), "probe"))
    print(f"{preset}: engine golden and probe done", flush=True)
    golden.update(emitter_loop(model, settled))
    gmeta = {
        "n_worlds": GOLDEN_WORLDS,
        "settle_steps": PRESETS[preset]["settle_steps"],
        "n_steps": GOLDEN_STEPS,
        "offset_mm": OFFSET_MM,
        "probe_eps": PROBE_EPS,
        "winner_k": WINNER_K,
        "settled_gap_min": float(gaps.min()),
        "seed": SEED,
    }
    exporter.save_npz(golden_path, golden, gmeta)
    print(f"wrote {golden_path} ({golden_path.stat().st_size} bytes)", flush=True)


def slide_off(n_worlds: int, seed: int = 7) -> None:
    """The default preset's drop in ``n_worlds`` worlds through the JAX
    engine: the worlds whose top fly does not rest on the bottom one."""
    from flygym_tpu.batch import BatchSimulation

    world = build_world("twofly_full")
    bsim = BatchSimulation(world, n_worlds)
    offsets = fly_offsets(2, n_worlds, seed)
    st = settled_state(bsim, world, offsets, PRESETS["twofly_full"]["settle_steps"])
    gaps = root_gaps(bsim.model, st)[:, 0]
    qpos = np.asarray(st.qpos)
    (_b0, q_bottom, _v0), (_b1, q_top, _v1) = bsim.model.free_joints
    sep = np.linalg.norm(qpos[:, q_top:q_top + 2] - qpos[:, q_bottom:q_bottom + 2], axis=1)
    low = gaps <= REST_GAP_MM
    print(f"JAX engine, {n_worlds} worlds, {PRESETS['twofly_full']['settle_steps']} steps: the "
          f"top root {REST_GAP_MM} mm or less above the bottom one in {int(low.sum())} worlds, "
          f"{np.round(sep[low], 3).tolist()} mm away in xy (root z gaps "
          f"{np.round(gaps[low], 3).tolist()} mm); resting worlds up to {sep[~low].max():.3f} mm "
          f"away", flush=True)


def main():
    # The goldens are taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--slide-off"]:
        slide_off(int(sys.argv[2]))
        return
    for preset in sys.argv[1:] or PRESETS:
        export_preset(preset)


if __name__ == "__main__":
    main()
