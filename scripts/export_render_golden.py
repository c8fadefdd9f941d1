"""Export camera frames of the JAX renderer for the PyTorch port's tests.

The JAX package renders on the CPU backend, jitted as its ``Renderer``
renders (``flygym_tpu/render/renderer.py``), from the settled states of the
committed goldens, so the port renders the same poses from its own assets.
Frames are floats in [0, 1], before the uint8 cast. The cases:

- ``capsule``: the benchmark fly's ``trackcam``, settled world 0 of
  ``benchmark_fly_golden.npz``;
- ``mesh``: the same with ``mesh_fidelity=True`` (the segments' SDFs);
- ``aim``: a ``targetbody`` camera at (0, -10, 4) aimed at the thorax
  (fovy 40), settled world 1;
- ``lights``: world 1 with three lights (a point light following the
  thorax 10 mm above it, a fixed point light without shadows, a
  directional light) and seeded ground and sky textures;
- ``batch``: 16 of 20 worlds (the settled worlds, world w from world w mod
  8, every body moved by a seeded offset per world), one call;
- ``terrain``: config 3's fly on its blocks terrain, settled world 0 of
  ``terrain_fly_golden.npz``, a tracking camera as ``trackcam``;
- ``flyenv``: ``FlyEnv``'s camera (7.5 mm behind and 6 mm above the root)
  on config 5's world, settled world 0 of ``env_fly_golden.npz``, rendered
  eagerly, as ``FlyEnv.render`` renders it (not jitted).

Writes ``flygym_tpu_torch/assets/render_golden.npz``. Run from the
repository root (about 1 minute)::

    JAX_PLATFORMS=cpu python scripts/export_render_golden.py
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "flygym_tpu_torch" / "assets"
GOLDEN_PATH = ASSETS / "render_golden.npz"

RES = (48, 64)
BATCH_RES = (24, 32)
BATCH_WORLDS = 20
BATCH_IDS = list(range(4, 20))
BATCH_OFFSET_MM = 0.5
SEED = 0
THORAX = "nmf/c_thorax"
AIM_CAMERA = dict(mode="targetbody", pos=(0.0, -10.0, 4.0), fovy=40.0)
TRACK_CAMERA = dict(mode="track", pos=(0.0, -7.5, 6.0), fovy=30.0)
LIGHTS = [
    {"kind": "point", "target": THORAX, "offset": [0.0, 0.0, 10.0], "color": 0.8},
    {"kind": "point", "pos": [4.0, -3.0, 6.0], "color": [0.9, 0.5, 0.3], "cast_shadow": False,
     "falloff": 20.0},
    {"kind": "directional", "dir": [0.2, 0.1, -0.97], "color": 0.3, "specular": 0.5},
]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def textures():
    """(ground, sky): seeded (8, 8, 3) and (4, 16, 3) float32 images."""
    rng = np.random.default_rng(SEED)
    return (rng.random((8, 8, 3)).astype(np.float32),
            rng.random((4, 16, 3)).astype(np.float32))


def batch_offsets():
    """(BATCH_WORLDS, 3) seeded offsets of every body in each batch world."""
    rng = np.random.default_rng(SEED + 1)
    return rng.uniform(-BATCH_OFFSET_MM, BATCH_OFFSET_MM, (BATCH_WORLDS, 3)).astype(np.float32)


def golden_state(path, world=None):
    """The settled JAX state of a committed golden (all worlds, or one)."""
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State

    with np.load(path) as npz:
        fields = {k[len("state."):]: npz[k] for k in npz.files if k.startswith("state.")}
    if world is not None:
        fields = {k: v[world] for k, v in fields.items()}
    return State(**{k: jnp.asarray(v) for k, v in fields.items()})


def camera(name, target, **kw):
    from flygym_tpu.compose.spec import CameraSpec
    from flygym_tpu.utils.math import Rotation3D

    quat = tuple(Rotation3D("xyaxes", (1, 0, 0, 0, 0.6, 0.8)).as_quat_wxyz())
    return CameraSpec(name=name, mode=kw["mode"], target=target, pos=kw["pos"], quat=quat,
                      fovy=kw["fovy"])


def render(renderer, state, batched=False):
    if batched:
        return np.asarray(renderer._render_fn_batch(0, state))
    return np.asarray(renderer._render_fn(0, state))[None]


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import dataclasses

    import jax.numpy as jnp

    from flygym_tpu.render.raycast import render_pixels
    from flygym_tpu.render.renderer import Renderer

    frames = {}
    fly, world = _load_script("export_torch_model").build_benchmark()
    model, _ = world.compile()
    settled = golden_state(ASSETS / "benchmark_fly_golden.npz")
    one = lambda w: jax.tree.map(lambda x: x[w], settled)
    frames["capsule"] = render(Renderer(model, world, "trackcam", camera_res=RES), one(0))
    frames["mesh"] = render(
        Renderer(model, world, "trackcam", camera_res=RES, mesh_fidelity=True), one(0))
    frames["aim"] = render(Renderer(model, world, camera("aimcam", THORAX, **AIM_CAMERA),
                                    camera_res=RES), one(1))
    ground, sky = textures()
    frames["lights"] = render(Renderer(model, world, "trackcam", camera_res=RES, lights=LIGHTS,
                                       ground_texture=ground, sky_texture=sky), one(1))
    src = np.arange(BATCH_WORLDS) % settled.xpos.shape[0]
    batch = jax.tree.map(lambda x: x[src], settled)
    batch = dataclasses.replace(batch, xpos=batch.xpos + batch_offsets()[:, None, :])
    frames["batch"] = render(
        Renderer(model, world, "trackcam", camera_res=BATCH_RES, world_ids=BATCH_IDS),
        jax.tree.map(lambda x: x[jnp.asarray(BATCH_IDS)], batch), batched=True)

    terrain = _load_script("export_terrain_golden")
    tfly, tworld = terrain.build_world()
    tmodel, _ = tworld.compile()
    frames["terrain"] = render(
        Renderer(tmodel, tworld, camera("track", f"{tfly.name}/c_thorax", **TRACK_CAMERA),
                 camera_res=RES),
        golden_state(ASSETS / "terrain_fly_golden.npz", 0))

    _efly, _eworld, env = _load_script("export_env_golden").build_env()
    estate = golden_state(ASSETS / "env_fly_golden.npz", 0)
    from flygym_tpu.engine.kinematics import geom_poses

    emodel = env.model
    root = estate.xpos[env._root_body]
    cam = camera("flyenv", None, **TRACK_CAMERA)
    mask = jnp.asarray([1.0 if t in ("capsule", "sphere") else 0.0 for t in emodel.geom_types],
                       jnp.float32)

    def flyenv_frame(state):  # eager, as FlyEnv.render renders
        gpos, gquat = geom_poses(emodel, state.xpos, state.xquat)
        return render_pixels(emodel, gpos, gquat, root + jnp.array([0.0, -7.5, 6.0]),
                             jnp.asarray(cam.quat, jnp.float32), *RES, 30.0, mask)

    frames["flyenv"] = np.asarray(flyenv_frame(estate))[None]

    meta = {"res": list(RES), "batch_res": list(BATCH_RES), "batch_worlds": BATCH_WORLDS,
            "batch_ids": BATCH_IDS, "lights": LIGHTS, "aim_camera": AIM_CAMERA,
            "track_camera": TRACK_CAMERA, "thorax": THORAX,
            "cases": {k: list(v.shape) for k, v in frames.items()}}
    arrays = {f"frame.{k}": v.astype(np.float32) for k, v in frames.items()}
    arrays.update(ground_texture=ground, sky_texture=sky, batch_offsets=batch_offsets())
    np.savez_compressed(GOLDEN_PATH, meta=np.array(json.dumps(meta, sort_keys=True)), **arrays)
    print(f"wrote {GOLDEN_PATH} ({GOLDEN_PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
