"""The port's compile against the JAX package's, on the CPU.

Every committed world (``flygym_tpu_torch/assets/*.npz``) is composed again
by the port (``flygym_tpu_torch/demo/worlds.py``, the export scripts'
builders) and its compile held against the file; the worlds no script
exports (``make_model``'s options, the heightfield and gapped terrains, a
fly derived from STL meshes) against a live JAX compile. Every array field,
the initial state and ``meta`` come out bit-equal, except

- ``model.can_invweight`` and ``model.act_acc0``: the port factors the
  neutral-pose mass matrix with torch's Cholesky where the JAX compile takes
  XLA's, so the two round otherwise. They are held to a relative bar
  (:data:`INVWEIGHT_BAR`, :data:`ACC0_BAR`; the largest gaps over the 17
  committed worlds were 1.71e-5 on the 3-fly pile and 3.26e-7 on the
  muscle fly);
- ``state.xquat``: the JAX compile takes the neutral pose's kinematics
  jitted, and XLA's CPU backend fuses its quaternion products into fused
  multiply-adds; the port repeats the fusion
  (``forward_kinematics(..., fused=True)``) and still parts by up to two
  ulps in one component of at most two segments per fly (the front legs'
  tarsus4).

Also: ``to_mjcf_xml`` against JAX's string and in MuJoCo, ``Retina.for_fly``
and ``OdorField.for_fly`` against JAX's, the composed benchmark world's
engine step against ``benchmark_fly_golden.npz``, and the mega-step gate on
the composed worlds K2 has not seen.
"""

import dataclasses
import importlib.util
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import flygym_tpu
from flygym_tpu_torch import BatchSimulation, Simulation, load_compiled
from flygym_tpu_torch.compose.bridge import ASSETS, _read_npz, load_golden
from flygym_tpu_torch.demo import benchmark
from flygym_tpu_torch.demo.worlds import WORLDS, build_world
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# Relative bars of the two fields the port's Cholesky rounds otherwise than
# XLA's (largest measured gaps over the committed worlds: 1.71e-5 and
# 3.26e-7).
INVWEIGHT_BAR = 5e-5
ACC0_BAR = 2e-6
RELATIVE_BARS = {"model.can_invweight": INVWEIGHT_BAR, "model.act_acc0": ACC0_BAR}
# Fields that may part by a few ulps (see the module docstring).
ULP_BARS = {"state.xquat": 2}
# What the export scripts add to a fly's maps beyond export()'s.
SCRIPT_EXTRAS = ("tip_bodies", "eye_bodies")


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same_compile(arrays: dict, meta: dict, ref: dict, ref_meta: dict) -> None:
    """The port's ``(arrays, meta)`` against the JAX package's: names,
    shapes and dtypes equal, every field bit-equal but those of
    :data:`RELATIVE_BARS` and :data:`ULP_BARS`, held to their bars; the
    static fields, the flies' maps and (where the reference has them) the
    renderer's names equal."""
    assert sorted(arrays) == sorted(ref)
    off = []
    for key, want in ref.items():
        got = arrays[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if np.array_equal(got, want):
            continue
        if key in RELATIVE_BARS:
            rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1e-30)
            assert rel.max() <= RELATIVE_BARS[key], (key, rel.max())
        elif key in ULP_BARS:
            np.testing.assert_array_max_ulp(got, want, maxulp=ULP_BARS[key])
            assert (got != want).sum() <= 2 * max(len(ref_meta["flies"]), 1), key
        else:
            off.append(key)
    assert off == [], f"fields not bit-equal: {off}"
    assert meta["model"] == ref_meta["model"]
    flies = {fly: {k: v for k, v in maps.items() if k not in SCRIPT_EXTRAS}
             for fly, maps in ref_meta["flies"].items()}
    assert meta["flies"] == flies
    if "render" in ref_meta:
        assert meta["render"] == ref_meta["render"]


# ---------------------------------------------------------------------------
# every committed world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_committed_world_compiles_bit_equal(name):
    """The port's compile of ``name`` against the ``.npz`` file the JAX
    package wrote."""
    _fly, world = build_world(name)
    arrays, meta, _names = world.compile_arrays()
    assert_same_compile(arrays, meta, *_read_npz(ASSETS / f"{name}.npz"))


def test_compiled_world_loads_like_its_file():
    """``world.compile()`` goes through ``model_from_numpy``: the model's
    tensors and static fields are those of the loaded file but for the
    Cholesky field, and the name maps ride along."""
    _fly, world = build_world("twofly")
    model, state = world.compile()
    loaded = load_compiled(ASSETS / "twofly.npz")
    for f in dataclasses.fields(model):
        a, b = getattr(model, f.name), getattr(loaded.model, f.name)
        if isinstance(a, torch.Tensor) and f.name != "can_invweight":
            assert torch.equal(a, b), f.name
        elif f.name in ("nv", "pair_groups", "dof_chains", "welds", "levels"):
            assert a == b, f.name
    assert torch.equal(state.qpos, loaded.initial_state.qpos)
    assert world.compiled.flies == loaded.flies and world.compiled.render == loaded.render
    assert world.compiled.body_name2id["top/c_thorax"] == loaded.flies["top"]["body_ids"][0]
    with pytest.raises(AttributeError):
        loaded.body_name2id


@pytest.mark.parametrize("seed", [0, 3])
def test_blocks_terrain_repeats_the_jax_generator(seed):
    from flygym_tpu.compose import BlocksTerrainWorld as JaxBlocks

    from flygym_tpu_torch.compose import BlocksTerrainWorld

    port = BlocksTerrainWorld(rng_seed=seed, extent=5.0).spec.hfield
    jax = JaxBlocks(rng_seed=seed, extent=5.0).spec.hfield
    np.testing.assert_array_equal(port["data"], jax["data"])
    assert port["xy0"] == jax["xy0"] and port["cell"] == jax["cell"]


# ---------------------------------------------------------------------------
# worlds without a file: against a live JAX compile
# ---------------------------------------------------------------------------


def _box_stl(path: Path, a: float, b: float, c: float) -> None:
    """A closed binary STL box (12 outward triangles) centred at 0."""
    x, y, z = a / 2, b / 2, c / 2
    v = [(-x, -y, -z), (x, -y, -z), (x, y, -z), (-x, y, -z),
         (-x, -y, z), (x, -y, z), (x, y, z), (-x, y, z)]
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
             (2, 3, 7), (2, 7, 6), (1, 2, 6), (1, 6, 5), (3, 0, 4), (3, 4, 7)]
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(faces)))
        for face in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for i in face:
                f.write(struct.pack("<3f", *v[i]))
            f.write(struct.pack("<H", 0))


def _mesh_dir(tmp_path: Path) -> Path:
    """Boxes of three sizes for every segment the fly loads (left and centre
    names; the right side mirrors the left)."""
    rigging = json.loads((ASSETS / "model" / "rigging.json").read_text())
    for i, name in enumerate(sorted({f"l{n[1:]}" if n[0] == "r" else n for n in rigging})):
        _box_stl(tmp_path / f"{name}.stl", *[(4e-4, 2e-4, 6e-4), (3e-4, 3e-4, 5e-4),
                                              (2e-4, 1e-4, 8e-4)][i % 3])
    return tmp_path


def _world(pkg, case: str, mesh_dir: Path):
    """``case``'s world composed by ``pkg`` (the JAX package's or the
    port's modules, as a namespace)."""
    if case in ("trim_contacts", "simplify_geom"):
        return pkg.make_model(**{case: True})[1]
    if case == "all_biological":
        return pkg.make_model(joints_preset=pkg.JointPreset.ALL_BIOLOGICAL,
                              actuated_dofs_preset=pkg.ActuatedDOFPreset.ALL)[1]
    if case == "all_possible":
        return pkg.make_model(joints_preset=pkg.JointPreset.ALL_POSSIBLE)[1]
    if case == "motor":
        # With a motor, make_model's default neutral pose fails in both
        # packages (Fly.add_actuators reads a preset as a dict for every
        # kind but position); without one the joints start at 0.
        return pkg.make_model(actuator_type=pkg.ActuatorType.MOTOR, neutral_pose=None,
                              spawn_rotation=pkg.Rotation3D("quat", (0.9, 0, 0, 0.1)))[1]
    fly = pkg.Fly(name="f", mesh_basedir=mesh_dir if case == "mesh_basedir" else None)
    fly.add_joints(pkg.Skeleton(axis_order="ypr", joint_preset="legs_only"),
                   neutral_pose=pkg.KinematicPosePreset.NEUTRAL)
    fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset("legs_active_only"),
                      pkg.ActuatorType.POSITION, kp=30.0,
                      neutral_input=pkg.KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    fly.add_joint_sites(fly.skeleton.anatomical_joints[:6])
    if case == "heightfield":
        heights = np.random.default_rng(7).uniform(-0.2, 0.3, (40, 48)).astype(np.float32)
        world = pkg.HeightfieldTerrainWorld(heights=heights, xy0=(-6.0, -5.0), cell=(0.25, 0.25))
    elif case == "gapped":
        world = pkg.GappedTerrainWorld(extent=6.0, gap_width=0.5)
    else:
        world = pkg.TetheredWorld()
    world.add_fly(fly, (0.1, -0.2, 1.5), pkg.Rotation3D("quat", (1, 0, 0, 0)))
    return world


def _namespace(jax: bool):
    import types

    if jax:
        from flygym_tpu import anatomy, compose
        from flygym_tpu.demo import benchmark as bench
        from flygym_tpu.utils.math import Rotation3D
    else:
        from flygym_tpu_torch import anatomy, compose
        from flygym_tpu_torch.demo import benchmark as bench
        from flygym_tpu_torch.utils.math import Rotation3D
    return types.SimpleNamespace(
        make_model=bench.make_model, JointPreset=anatomy.JointPreset,
        ActuatedDOFPreset=anatomy.ActuatedDOFPreset, Skeleton=anatomy.Skeleton,
        ActuatorType=compose.ActuatorType, Fly=compose.Fly,
        KinematicPosePreset=compose.KinematicPosePreset, Rotation3D=Rotation3D,
        HeightfieldTerrainWorld=compose.HeightfieldTerrainWorld,
        GappedTerrainWorld=compose.GappedTerrainWorld, TetheredWorld=compose.TetheredWorld)


LIVE_CASES = ["trim_contacts", "simplify_geom", "all_biological", "all_possible", "motor",
              "heightfield", "gapped", "mesh_basedir"]


@pytest.fixture
def jax_numpy_meshes(monkeypatch):
    """The JAX package's mesh tools on their numpy paths, which the port
    copies (its tests hold them equal to the C++ library)."""
    from flygym_tpu.native import meshtools

    monkeypatch.setattr(meshtools, "_get_lib", lambda: None)


@pytest.mark.parametrize("case", LIVE_CASES)
def test_world_without_a_file_compiles_like_jax(case, tmp_path, jax_numpy_meshes):
    exporter = _load_script("export_torch_model")
    mesh_dir = _mesh_dir(tmp_path) if case == "mesh_basedir" else None
    jax_world = _world(_namespace(True), case, mesh_dir)
    ref, ref_meta = exporter.export(jax_world, flygym_tpu.Simulation(jax_world), render=True)
    ref_meta = json.loads(json.dumps(ref_meta))
    world = _world(_namespace(False), case, mesh_dir)
    arrays, meta, _names = world.compile_arrays()
    assert_same_compile(arrays, meta, ref, ref_meta)


# ---------------------------------------------------------------------------
# MJCF, retina, odor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["benchmark_fly", "terrain_fly", "twofly", "muscle_fly",
                                  "softweld_fly", "tethered_fly"])
def test_mjcf_equals_the_jax_package_and_loads_in_mujoco(name):
    mujoco = pytest.importorskip("mujoco")
    port = build_world(name)[1].spec.to_mjcf_xml()
    jax_builders = {"benchmark_fly": lambda: _load_script("export_torch_model").build_benchmark(),
                    "terrain_fly": lambda: _load_script("export_terrain_golden").build_world(),
                    "twofly": lambda: (None, _load_script("export_twofly_golden").build_world()),
                    "muscle_fly": lambda: _load_script("export_actuator_golden")
                    .build_world("muscle_fly"),
                    "tethered_fly": lambda: _load_script("export_actuator_golden")
                    .build_world("tethered_fly"),
                    "softweld_fly": lambda: _load_script("export_taxis_golden")
                    .build_world("softweld_fly")}
    assert port == jax_builders[name]()[1].spec.to_mjcf_xml()
    m = mujoco.MjModel.from_xml_string(port)
    compiled = load_compiled(ASSETS / f"{name}.npz").model
    assert (m.nbody, m.nq, m.nv, m.nu) == (compiled.nbody, compiled.nq, compiled.nv, compiled.nu)


@pytest.fixture(scope="module")
def taxis_worlds():
    """The visual-taxis world composed by each package, compiled."""
    jax_world = _load_script("export_taxis_golden").build_world("taxis_fly")[1]
    jax_world.compile()
    world = build_world("taxis_fly")[1]
    world.compile()
    return jax_world, world


@pytest.mark.parametrize("kwargs", [{}, {"acceptance_fwhm_deg": 8.0, "n_rings": 6}])
def test_retina_for_fly_equals_the_jax_package(taxis_worlds, kwargs):
    from flygym_tpu.vision import Retina as JaxRetina

    from flygym_tpu_torch.vision import Retina

    jax_world, world = taxis_worlds
    jax = JaxRetina.for_fly(jax_world, "nmf", **kwargs)
    port = Retina.for_fly(world, "nmf", **kwargs)
    assert (port.left_eye_body, port.right_eye_body) == (jax.left_eye_body, jax.right_eye_body)
    assert port.left_eye_body == world.compiled.body_name2id["nmf/l_eye"]
    for f in ("directions_left", "directions_right", "channel_weights", "blur_weights"):
        a, b = getattr(port, f), getattr(jax, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert port.n_ommatidia == jax.n_ommatidia and port.cone_half_rad == jax.cone_half_rad
    assert Retina.for_compiled(load_compiled(ASSETS / "taxis_fly.npz")).left_eye_body == \
        port.left_eye_body


@pytest.mark.parametrize("diffusion", ["inverse_square", "gaussian"])
def test_odor_field_for_fly_equals_the_jax_package(taxis_worlds, diffusion):
    from flygym_tpu.olfaction import OdorField as JaxOdorField

    from flygym_tpu_torch.olfaction import OdorField

    jax_world, world = taxis_worlds
    kw = dict(source_pos=[[20.0, 3.0, 1.0], [-5.0, 4.0, 0.5]],
              peak_intensity=[[1.0, 0.0], [0.2, 2.0]], diffusion=diffusion)
    jax = JaxOdorField.for_fly(jax_world, "nmf", **kw)
    port = OdorField.for_fly(world, "nmf", **kw)
    for f in ("source_pos", "peak_intensity", "sensor_bodies", "sensor_offsets"):
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(jax, f)), err_msg=f)
    assert (port.diffusion, port.gaussian_scale) == (jax.diffusion, jax.gaussian_scale)
    jax_state = jax_world.compile()[1]
    got = port.sample(world.compiled.model, world.compiled.initial_state)[0].numpy()
    want = np.asarray(jax.sample(jax_world.compiled.model, jax_state))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        OdorField.for_fly(world, "nmf", [[0, 0, 0]], [[1.0], [2.0]])


# ---------------------------------------------------------------------------
# the composed worlds on the engine and the mega-step gate
# ---------------------------------------------------------------------------


def test_composed_benchmark_world_tracks_the_jax_golden():
    """The replay's 50 steps from the golden's settled JAX state, on the
    port's engine step of the world the port composed, within the bars the
    exported model meets (``GOLDEN_TOLERANCE``)."""
    _fly, world, _cam = benchmark.make_model()
    world.compile()
    worst = benchmark.track_golden(world.compiled, load_golden(), device="cpu", n_worlds=2,
                                   megastep=False)
    for key, bar in benchmark.GOLDEN_TOLERANCE.items():
        assert worst[key] <= bar, (key, worst[key])


def test_simulations_take_a_world():
    fly, world, _cam = benchmark.make_model(trim_contacts=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Simulation(world)
    sim = Simulation(world, device="cpu")
    assert sim.world is world and sim.compiled is world.compiled
    assert sim.compiled.fly_names == [fly.name] and sim.model.ncand == 36
    batch = BatchSimulation(world, 3, device="cpu")
    batch.set_leg_adhesion_states(fly.name, np.ones(6, np.float32))
    batch.rollout(None, 2, record_trajectory=False)
    assert batch.state.qpos.shape == (3, 73) and torch.isfinite(batch.state.qpos).all()
    assert Simulation(load_compiled(), device="cpu").world is None
    empty = type(world)()
    with pytest.raises(ValueError, match="at least one fly"):
        Simulation(empty, device="cpu")


@pytest.mark.parametrize("kwargs, nv, ncand", [
    ({"trim_contacts": True}, 72, 36), ({"simplify_geom": True}, 72, 110),
    ({"joints_preset": "all_biological", "actuated_dofs_preset": "all"}, 132, 110),
    ({"joints_preset": "all_possible"}, 210, 110)])
def test_megastep_gate_takes_the_composed_worlds(kwargs, nv, ncand):
    """K2's gate on shapes no exported world has: each passes, and its
    header builds (the walk indices fit in 16 bits, the first scratch slot
    in shared memory)."""
    _fly, world, _cam = benchmark.make_model(**kwargs)
    model, _state = world.compile()
    assert (model.nv, model.ncand) == (nv, ncand)
    assert ms.megastep_supported(model)
    text, n_scratch = ms.model_header(model)
    layout = ms.scratch_layout(model)
    assert text and n_scratch == layout["n_scratch"]
    assert 4 * layout["n_shared"] <= ms.SHARED_LIMIT and layout["n_global"] == 0


def test_megastep_gate_refuses_what_does_not_fit(monkeypatch):
    """A world whose first scratch slot passes a block's shared memory is
    refused before any build, and the simulation takes the engine step."""
    _fly, world, _cam = benchmark.make_model(trim_contacts=True)
    model, _state = world.compile()
    monkeypatch.setattr(ms, "SHARED_LIMIT", 4 * 100)
    assert not ms.megastep_supported(model)
    with pytest.raises(NotImplementedError):
        ms.model_header(model)
    sim = BatchSimulation(world, 2, device="cpu")
    assert sim.megastep is False
