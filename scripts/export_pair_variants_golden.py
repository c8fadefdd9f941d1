"""Export example 11's two flies at other contact settings for the PyTorch port.

Two worlds, each compiled and run by the JAX package on the CPU:

- **twofly_condim6**: example 11's world (``examples/11_two_flies_interacting.py``:
  two LEGS_ONLY flies with leg adhesion, "bottom" at (0, 0, 1.2) and "top"
  at (0, 0, 3.2), 49 capsule-capsule pair rows between their thorax,
  abdomen and head capsules) with the ground contacts and the pair rows at
  ``ContactParams(condim=6)``: 10 pyramid rows per candidate, the torsion
  and both rolling directions on the pair rows too.
- **twofly_terrain**: example 11's flies and pair set on
  ``BlocksTerrainWorld()`` (its defaults), "bottom" at (0, 0, 1.5) and "top"
  at (0, 0, 3.5), with ``pair_compress`` on: 7 groups of 7 pair rows, each
  solved as one row against its group's winner, beside 220 ground rows on
  the heightfield.

Each world is written as ``flygym_tpu_torch/assets/<name>.npz`` with an
8-world ``<name>_golden.npz``: the top fly moved by seeded xy offsets
(``offsets``, uniform in +-0.1 mm), adhesion 1 on the bottom fly's legs,
800 vmapped JAX engine steps (example 11's rollout), then 16 steps recorded
three times, as ``scripts/export_twofly_golden.py`` and
``scripts/export_compressed_golden.py`` record them:

- ``emitter.*``: the mega-step emitter (``flygym_tpu.ops.megastep.emit_step``)
  stepped eagerly on (B,) arrays. On the terrain world it is fed what the
  JAX mega-step samples outside its kernel, at steps 0 and 8 (the K = 8
  chunking) from the pose the last step cached: each kept candidate's
  ground plane from the jitted plane sampler (``emitter.planes``, (2, B,
  ncand, 4) in the compressed candidate order) and each group's winner
  (``emitter.widx``, (2, B, n_groups));
- ``engine.*``: the vmapped engine step;
- ``probe.*``: the engine step from the settled state perturbed by 1e-5
  relative in qpos and 1e-5 absolute in qvel (the conditioning probe).

Each records per step ``qpos``, ``qvel`` and ``sensordata``; the emitter
also ``qacc``. ``settled_gap`` holds each world's top root height above the
bottom one after the settle (example 11's check asks for more than 0.4 mm),
and ``active_pairs`` each world's count of pair rows closer than their margin
(the contacts between the resting flies come and go from step to step; the
script asks for an active one in at least half the worlds).

The condim-6 golden also holds one emitter step of example 11's world
compiled at condim 1 and at condim 4 from the condim-6 golden's settled
state (``c1.*`` and ``c4.*``: ``qpos``, ``qvel``, ``qacc``, ``sensordata``),
so that the port's emitter is held to JAX's at every condim without running
the eager JAX emitter in a test.

Run from the repository root (about 30-40 minutes on one CPU core, most of
it the eager emitter; one argument names one world)::

    JAX_PLATFORMS=cpu python scripts/export_pair_variants_golden.py [twofly_condim6|twofly_terrain]
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

NAMES = ("twofly_condim6", "twofly_terrain")
GOLDEN_WORLDS = 8
GOLDEN_SETTLE_STEPS = 800  # example 11's rollout
GOLDEN_STEPS = 16
AUX_K = 8  # planes and winners are sampled once per 8 steps
OTHER_CONDIMS = (1, 4)  # one emitter step each, from the condim-6 settle
REST_GAP_MM = 0.4  # example 11's check
SEED = 0


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script(name: str):
    return _load(name, REPO / "scripts" / f"{name}.py")


def build_world(name: str):
    """Example 11's world at ``twofly_condim{1,3,4,6}`` or on the blocks
    terrain with compressed pair rows (``twofly_terrain``), composed by the
    JAX package as the example composes it."""
    from flygym_tpu.anatomy import AxisOrder, ContactBodiesPreset, JointPreset, Skeleton
    from flygym_tpu.compose import BlocksTerrainWorld, FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu.compose.physics import ContactParams
    from flygym_tpu.utils.math import Rotation3D

    terrain = name == "twofly_terrain"
    params = ContactParams() if terrain else ContactParams(condim=int(name[len("twofly_condim"):]))

    def mkfly(fly_name):
        fly = Fly(name=fly_name)
        fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=KinematicPosePreset.NEUTRAL)
        fly.add_leg_adhesion()
        fly.colorize()
        fly.add_tracking_camera()
        return fly

    world = BlocksTerrainWorld() if terrain else FlatGroundWorld()
    z0 = 1.5 if terrain else 1.2
    quat = Rotation3D("quat", (1, 0, 0, 0))
    world.add_fly(mkfly("bottom"), (0, 0, z0), quat, ground_contact_params=params)
    world.add_fly(mkfly("top"), (0, 0, z0 + 2.0), quat, ground_contact_params=params)
    segs = [s for s in ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD.to_body_segments_list()
            if "thorax" in s.name or "abdomen" in s.name or "head" in s.name]
    world.add_fly_fly_contacts("bottom", "top", bodysegs=segs, contact_params=params)
    if terrain:
        world.spec.options["pair_compress"] = True
    return world


def export_model(name: str):
    """``name``'s world compiled by the JAX package and flattened:
    ``(world, jax simulation, arrays, meta)``."""
    import flygym_tpu

    world = build_world(name)
    sim = flygym_tpu.Simulation(world)
    arrays, meta = _script("export_torch_model").export(world, sim, render=True)
    return world, sim, arrays, meta


def aux_samplers(model):
    """The JAX mega-step's out-of-kernel samplers, jitted:
    ``(planes(xpos, xquat) -> (B, kept ncand, 4) or None, winners(xpos,
    xquat) -> (B, n_groups) or None)``; the planes in the compressed
    candidate order (``_Static.pair_keep``), as ``make_megastep``'s
    ``sample_planes`` takes them."""
    import jax

    from flygym_tpu.engine.contact import make_pair_winner_sampler
    from flygym_tpu.engine.terrain import make_plane_sampler
    from flygym_tpu.ops import megastep

    keep = megastep._Static(model).pair_keep
    planes = winners = None
    if model.has_hfield:
        full = jax.jit(make_plane_sampler(model))
        planes = (lambda x, q: np.asarray(full(x, q))[:, keep]) if keep is not None else (
            lambda x, q: np.asarray(full(x, q)))
    if model.pair_compress and model.ncand_pair:
        w = jax.jit(make_pair_winner_sampler(model))
        winners = lambda x, q: np.asarray(w(x, q))
    return planes, winners


def emitter_loop(model, st, n_steps=GOLDEN_STEPS, prefix="emitter") -> dict:
    """The mega-step emitter stepped eagerly on (B,) arrays, fed the planes
    and winners sampled every ``AUX_K`` steps from the cached pose."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep

    jst = megastep._Static(model)
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    planes_of, winners_of = aux_samplers(model)
    q, v, act, warm = cols(st.qpos), cols(st.qvel), cols(st.act), cols(st.qacc)
    ctrl = cols(st.ctrl)
    xpos, xquat = np.asarray(st.xpos), np.asarray(st.xquat)
    rec = {"qpos": [], "qvel": [], "qacc": [], "sensordata": [], "planes": [], "widx": []}
    terrain = widx = None
    for t in range(n_steps):
        t0 = time.perf_counter()
        if t % AUX_K == 0:
            if planes_of is not None:
                pl = planes_of(jnp.asarray(xpos), jnp.asarray(xquat))
                rec["planes"].append(pl)
                terrain = [tuple(jnp.asarray(pl[:, c, k]) for k in range(4))
                           for c in range(pl.shape[1])]
            if winners_of is not None:
                w = winners_of(jnp.asarray(xpos), jnp.asarray(xquat))
                rec["widx"].append(w)
                widx = cols(w)
        r = megastep.emit_step(jst, q, v, ctrl, act, warm, terrain, widx)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        xpos = np.stack([pack(p) for p in r["xpos"]], axis=1)
        xquat = np.stack([pack(p) for p in r["xquat"]], axis=1)
        rec["qpos"].append(pack(q))
        rec["qvel"].append(pack(v))
        rec["qacc"].append(pack(warm))
        rec["sensordata"].append(np.stack([pack(s) for s in r["sensordata"]], axis=1))
        print(f"{prefix} step {t + 1}/{n_steps} in {time.perf_counter() - t0:.1f} s", flush=True)
    return {f"{prefix}.{k}": np.stack(v) for k, v in rec.items() if v}


def other_condims(settled) -> dict:
    """One emitter step of example 11's world at each of ``OTHER_CONDIMS``
    from the condim-6 settled state."""
    import flygym_tpu

    out = {}
    for c in OTHER_CONDIMS:
        model = flygym_tpu.Simulation(build_world(f"twofly_condim{c}")).model
        if model.condim != c:
            raise RuntimeError(f"twofly_condim{c} compiled at condim {model.condim}")
        out.update(emitter_loop(model, settled, 1, prefix=f"c{c}"))
    return out


def export(name: str) -> None:
    from flygym_tpu.batch import BatchSimulation
    from flygym_tpu.engine.model import State

    twofly = _script("export_twofly_golden")
    compressed = _script("export_compressed_golden")
    exporter = _script("export_torch_model")
    model_path, golden_path = ASSETS / f"{name}.npz", ASSETS / f"{name}_golden.npz"
    world, _sim, arrays, meta = export_model(name)
    exporter.save_npz(model_path, arrays, meta)
    print(f"wrote {model_path} ({model_path.stat().st_size} bytes)", flush=True)

    bsim = BatchSimulation(world, GOLDEN_WORLDS)
    model = bsim.model
    offsets = twofly.top_offsets()
    t0 = time.perf_counter()
    settled = twofly.settled_state(bsim, offsets)
    gaps = compressed.root_gaps(model, settled)[:, 0]
    if model.pair_compress:
        active = compressed.active_winner_rows(model, settled)
    else:
        active = twofly.active_pair_rows(model, settled)
    print(f"{name}: settled in {time.perf_counter() - t0:.1f} s; root gaps "
          f"{np.round(gaps, 4).tolist()} mm; active pair rows per world {active.tolist()}",
          flush=True)
    if (active > 0).sum() < GOLDEN_WORLDS // 2:
        raise RuntimeError(f"{name}: fewer than half the settled worlds have an active pair row")
    if gaps.min() <= REST_GAP_MM:
        raise RuntimeError(f"{name}: a settled top root is {gaps.min():.4f} mm above the "
                           f"bottom one, under example 11's {REST_GAP_MM} mm")
    golden = {f"state.{f.name}": np.asarray(getattr(settled, f.name))
              for f in dataclasses.fields(State)}
    golden["offsets"] = offsets
    golden["settled_gap"] = gaps
    golden["active_pairs"] = active
    golden.update(twofly.engine_loop(model, settled, "engine"))
    golden.update(twofly.engine_loop(model, twofly.perturbed(settled), "probe"))
    print(f"{name}: engine golden and probe done", flush=True)
    golden.update(emitter_loop(model, settled))
    if name == "twofly_condim6":
        golden.update(other_condims(settled))
    gmeta = {
        "n_worlds": GOLDEN_WORLDS,
        "settle_steps": GOLDEN_SETTLE_STEPS,
        "n_steps": GOLDEN_STEPS,
        "top_offset_mm": twofly.TOP_OFFSET_MM,
        "probe_eps": twofly.PROBE_EPS,
        "aux_k": AUX_K,
        "other_condims": list(OTHER_CONDIMS) if name == "twofly_condim6" else [],
        "settled_gap_min": float(gaps.min()),
        "seed": SEED,
    }
    exporter.save_npz(golden_path, golden, gmeta)
    print(f"wrote {golden_path} ({golden_path.stat().st_size} bytes)", flush=True)


def main():
    # The goldens are taken on the CPU backend (full fp32 matmuls).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["FLYGYM_TPU_MEGASTEP"] = "0"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    names = sys.argv[1:] or NAMES
    for name in names:
        if name not in NAMES:
            raise SystemExit(f"unknown world {name!r}; the worlds are {NAMES}")
        export(name)


if __name__ == "__main__":
    main()
