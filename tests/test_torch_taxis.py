"""Visual taxis (config 4) and CPG walking (config 2) in the port against the
JAX package: the drive, the CPG with a per-world, per-leg drive, the taxis
controller, and both closed loops against their JAX goldens
(``scripts/export_taxis_golden.py``).

Inputs are seeded with numpy. The JAX controller runs eagerly (op by op),
as the goldens ran it. The retina does not repeat JAX's jnp raycast to the
last bit (``tests/test_torch_vision.py``: within 1e-5 on 99.9% of the
ommatidia), so the taxis's drive, made from the vision's means, is held
within a tolerance; fed the golden's drives, the loop repeats the golden.
JAX is imported inside the fixtures and tests that need it, so the ``cuda``
test runs on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_taxis.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import (
    CPG_FLY, CPG_GOLDEN, TAXIS_FLY, TAXIS_GOLDEN, _read_npz, load_loop_golden)
from flygym_tpu_torch.control import CPGController, CPGState, object_azimuth_drive
from flygym_tpu_torch.control import extract_preprogrammed_steps
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.demo.cpg_walking import CPGWalkingLoop
from flygym_tpu_torch.demo.spotlight import MotionSnippet
from flygym_tpu_torch.demo.visual_taxis import PHYSICS_PER_CONTROL, TAXIS_GAIN, TaxisLoop
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
CPG_STEPS = 100
# The drive against JAX's on the same vision: the two means sum 1442
# values in another order (a few ulps of 1), times the gain 8.
DRIVE_ATOL = 1e-5
# The taxis's own drive against the golden's: the vision within 1e-5 on
# 99.9% of the ommatidia (tests/test_torch_vision.py), its mean within
# ~1e-6, times the gain 8.
LOOP_DRIVE_ATOL = 1e-4


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def taxis():
    return load_compiled(TAXIS_FLY), load_loop_golden(TAXIS_GOLDEN)


@pytest.fixture(scope="module")
def cpg_walk():
    return load_compiled(CPG_FLY), load_loop_golden(CPG_GOLDEN)


@pytest.fixture(scope="module")
def steps_data(cpg_walk):
    compiled, _golden = cpg_walk
    fly = compiled.fly_names[0]
    order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    return extract_preprogrammed_steps(MotionSnippet(), order)


def _jax_cpg(steps_data):
    from flygym_tpu.control import CPGController as JaxCPG

    return JaxCPG(steps_data, timestep=1e-4)


def _jax_states(phase, amplitude, damplitude):
    import jax.numpy as jnp

    from flygym_tpu.control import CPGState as JaxState

    return JaxState(phase=jnp.asarray(phase), amplitude=jnp.asarray(amplitude),
                    damplitude=jnp.asarray(damplitude))


def test_object_azimuth_drive_matches_jax():
    """Per world, on seeded vision: a dark left eye, a dark right eye (both
    clipped), and mild asymmetries."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.control.taxis import object_azimuth_drive as jax_drive

    rng = np.random.default_rng(0)
    vision = rng.uniform(0.5, 1.0, (6, 2, 721, 2)).astype(np.float32)
    vision[0, 0] *= 0.1  # dark left eye: turn left, clipped
    vision[1, 1] *= 0.1  # dark right eye
    want = np.asarray(jax.vmap(lambda v: jax_drive(v, 8.0))(jnp.asarray(vision)))
    got = object_azimuth_drive(torch.from_numpy(vision), 8.0).numpy()
    assert got.shape == (6, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=DRIVE_ATOL)
    np.testing.assert_array_equal(got[0], np.float32([0.2, 0.2, 0.2, 1.8, 1.8, 1.8]))
    np.testing.assert_array_equal(got[1], np.float32([1.8, 1.8, 1.8, 0.2, 0.2, 0.2]))
    assert (got[2:, :3] != got[2:, 3:]).all()


def test_cpg_with_a_per_leg_drive_equals_jax(steps_data):
    """The CPG of B worlds with a (B, 6) drive, drawn per step in [0.2,
    1.8], against JAX's vmapped CPG over 100 steps: bit for bit in the
    state, the targets and the adhesion."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    phase = rng.uniform(0, 2 * np.pi, (B, 6)).astype(np.float32)
    zeros = np.zeros((B, 6), np.float32)
    drives = rng.uniform(0.2, 1.8, (CPG_STEPS, B, 6)).astype(np.float32)
    jcpg = _jax_cpg(steps_data)
    vcpg = jax.vmap(lambda c, d: jcpg(c, drive=d))
    jst = _jax_states(phase, zeros, zeros)
    cpg = CPGController(steps_data, timestep=1e-4, device="cpu")
    st = CPGState.from_numpy(phase, zeros, zeros, device="cpu")
    for t in range(CPG_STEPS):
        jst, jtargets, jadh = vcpg(jst, jnp.asarray(drives[t]))
        st, targets, adh = cpg(st, drive=torch.from_numpy(drives[t]))
    for name in ("phase", "amplitude", "damplitude"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jtargets))
    np.testing.assert_array_equal(adh.numpy(), np.asarray(jadh))
    assert np.abs(st.amplitude.numpy() - 1.0).max() > 0.05  # the drives moved R


@pytest.fixture(scope="module")
def jax_worlds():
    """name -> (fly, world, JAX simulation) of a fresh compile."""
    import flygym_tpu

    module = _script("export_taxis_golden")
    out = {}
    for name in ("taxis_fly", "cpg_fly"):
        fly, world = module.build_world(name)
        out[name] = (fly, world, flygym_tpu.Simulation(world))
    return out


def test_taxis_controller_matches_jax_per_world(taxis, jax_worlds):
    """The controller's control step on the golden's settled worlds against
    JAX's ``VisualTaxisController`` world by world: the vision within 1e-5
    on 99.9% of the ommatidia, the drive within ``LOOP_DRIVE_ATOL``, the
    phase within 1e-6."""
    import jax.numpy as jnp

    from flygym_tpu.control import VisualTaxisController as JaxTaxis
    from flygym_tpu.control.taxis import object_azimuth_drive as jax_drive
    from flygym_tpu.engine.model import State as JaxState
    from flygym_tpu.vision import Retina as JaxRetina

    compiled, golden = taxis
    fly, world, jsim = jax_worlds["taxis_fly"]
    sim = BatchSimulation(compiled, B, device="cpu", megastep=False)
    sim.state = golden["state"].map(lambda x: x[:B].clone())
    loop = TaxisLoop(sim)
    cs = CPGState.from_numpy(*(golden["controller"][k][:B] for k in
                               ("phase", "amplitude", "damplitude")), device="cpu")
    _state, cs_new, vision, drive = loop.control(sim.state, cs)
    jtaxis = JaxTaxis(cpg=_script("export_taxis_golden").make_cpg(fly, 1e-4),
                      retina=JaxRetina.for_fly(world, fly.name), gain=8.0)
    for b in range(B):
        one = JaxState(**{f.name: jnp.asarray(getattr(sim.state, f.name)[b].numpy())
                          for f in dataclasses.fields(JaxState)})
        jcs = _jax_states(*(golden["controller"][k][b] for k in
                            ("phase", "amplitude", "damplitude")))
        jcs, _targets, _adh, jvision = jtaxis(jcs, jsim.model, one)
        gap = np.abs(vision[b].numpy() - np.asarray(jvision))
        assert (gap <= 1e-5).mean() >= 0.999
        np.testing.assert_allclose(drive[b].numpy(), np.asarray(jax_drive(jvision, 8.0)),
                                   rtol=0, atol=LOOP_DRIVE_ATOL)
        np.testing.assert_allclose(cs_new.phase[b].numpy(), np.asarray(jcs.phase), rtol=0,
                                   atol=1e-6)


def test_taxis_loop_engine_path_matches_the_golden(taxis):
    """Two control steps (40 engine steps) on 2 worlds from the golden's
    settled state with its controllers, against the JAX engine's loop. The
    first control step is held: drives within ``LOOP_DRIVE_ATOL`` and states
    within ``GOLDEN_TOLERANCE`` (measured qpos 8e-7, qvel 7.5e-4, drive
    1e-6 over 8 worlds), as there JAX's own engine and emitter agree within
    it; from the second they part by up to ~4 in qvel as the legs' contacts
    switch, so the second is held finite, with the phase within 1e-5. The
    pillar lies to the left, so the left legs are slowed."""
    compiled, golden = taxis
    sim = BatchSimulation(compiled, B, device="cpu", megastep=False)
    sim.state = golden["state"].map(lambda x: x[:B].clone())
    loop = TaxisLoop(sim)
    assert PHYSICS_PER_CONTROL == golden["meta"]["physics_per_control"] == 20
    cs = CPGState.from_numpy(*(golden["controller"][k][:B] for k in
                               ("phase", "amplitude", "damplitude")), device="cpu")
    _cs, rec = loop.run(cs, 2, record=True)
    eng, em = golden["engine"], golden["emitter"]
    assert (rec["drive"][..., :3] < rec["drive"][..., 3:]).all()
    tol = {**GOLDEN_TOLERANCE, "drive": LOOP_DRIVE_ATOL}
    for key in ("qpos", "qvel", "drive"):
        assert np.abs(eng[key][0] - em[key][0]).max() <= tol[key]  # the JAX paths agree
        gap = np.abs(rec[key][0].numpy() - eng[key][0, :B]).max()
        assert gap <= tol[key], (key, gap)
        assert torch.isfinite(rec[key]).all()
    np.testing.assert_allclose(rec["phase"].numpy(), eng["phase"][:2, :B], rtol=0, atol=1e-5)


@pytest.mark.parametrize("record", ["engine", "emitter"])
def test_taxis_vision_and_drive_from_the_golden_poses(taxis, record):
    """The render and the drive at every control step of the golden, from
    the poses the JAX path recorded (the settled state's at the first), on
    2 worlds: the vision within 1e-5 on 99.9% of the ommatidia and the
    drive within ``LOOP_DRIVE_ATOL`` of the JAX path's. They hold where the
    walk itself has parted the two JAX paths. Measured on all 8 worlds:
    the vision within 1e-5 on at least 99.93% of the ommatidia, the drive
    within 1e-6, but for world 6 on the emitter's poses at the 9th step,
    where one ray's value is 0.033 off and moves the drive by 2.1e-4
    (``chip_smoke.py`` phase 36 holds every world to what the vision's gap
    implies)."""
    compiled, golden = taxis
    want = golden[record]
    settled = golden["state"].map(lambda x: x[:B].clone())
    render = TaxisLoop(BatchSimulation(compiled, B, device="cpu", megastep=False)).render
    for t in range(want["vision"].shape[0]):
        pose = settled if t == 0 else dataclasses.replace(
            settled, xpos=torch.from_numpy(want["xpos"][t - 1, :B]),
            xquat=torch.from_numpy(want["xquat"][t - 1, :B]))
        vision = render(pose)
        gap = np.abs(vision.numpy() - want["vision"][t, :B])
        assert (gap <= 1e-5).mean() >= 0.999, t
        drive = object_azimuth_drive(vision, TAXIS_GAIN).numpy()
        np.testing.assert_allclose(drive, want["drive"][t, :B], rtol=0, atol=LOOP_DRIVE_ATOL,
                                   err_msg=f"control step {t + 1}")


def test_cpg_walking_plain_emitter_repeats_the_golden(cpg_walk):
    """Example 04's loop through the plain emitter (K2's plain version) for
    3 steps on 2 worlds: 0 gaps to the JAX emitter's record in qpos, qvel
    and the CPG phase."""
    compiled, golden = cpg_walk
    sim = BatchSimulation(compiled, B, device="cpu", megastep=True)
    sim.state = golden["state"].map(lambda x: x[:B].clone())
    loop = CPGWalkingLoop(sim)
    cs = CPGState.from_numpy(*(golden["controller"][k][:B] for k in
                               ("phase", "amplitude", "damplitude")), device="cpu")
    _cs, rec = loop.run(cs, 3, record=True)
    em = golden["emitter"]
    for name in ("qpos", "qvel", "phase"):
        np.testing.assert_array_equal(rec[name].numpy(), em[name][:3, :B], err_msg=name)


def test_cpg_walking_engine_path_matches_the_golden(cpg_walk):
    """The loop's 40 engine steps on 2 worlds against the JAX engine's
    within ``GOLDEN_TOLERANCE``; the phase bit for bit (the controller
    repeats JAX's arithmetic)."""
    compiled, golden = cpg_walk
    sim = BatchSimulation(compiled, B, device="cpu", megastep=False)
    sim.state = golden["state"].map(lambda x: x[:B].clone())
    loop = CPGWalkingLoop(sim)
    cs = CPGState.from_numpy(*(golden["controller"][k][:B] for k in
                               ("phase", "amplitude", "damplitude")), device="cpu")
    n = golden["meta"]["n_steps"]
    _cs, rec = loop.run(cs, n, record=True)
    eng = golden["engine"]
    np.testing.assert_array_equal(rec["phase"].numpy(), eng["phase"][:, :B])
    assert np.abs(rec["qpos"].numpy() - eng["qpos"][:, :B]).max() <= GOLDEN_TOLERANCE["qpos"]
    assert np.abs(rec["qvel"].numpy() - eng["qvel"][:, :B]).max() <= GOLDEN_TOLERANCE["qvel"]


@pytest.mark.parametrize("name, path", [("taxis_fly", TAXIS_FLY), ("cpg_fly", CPG_FLY)])
def test_committed_world_equals_a_fresh_export(jax_worlds, name, path):
    fly, world, jsim = jax_worlds[name]
    arrays, meta = _script("export_torch_model").export(world, jsim)
    if name == "taxis_fly":
        meta["flies"][fly.name]["eye_bodies"] = _script("export_taxis_golden").eye_bodies(
            world, fly)
    committed, committed_meta = _read_npz(path)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


@pytest.fixture
def cuda_taxis(taxis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return taxis


@pytest.mark.cuda
def test_taxis_k2_path_repeats_the_golden_on_the_card(cuda_taxis):
    """The loop on the card (K3, then one K = 20 launch of K2 per control
    step) fed the golden's drives: 0 gaps to the JAX emitter's record in
    qpos, qvel and the CPG phase over every control step."""
    compiled, golden = cuda_taxis
    n = golden["state"].qpos.shape[0]
    sim = BatchSimulation(compiled, n, device="cuda", megastep_k=PHYSICS_PER_CONTROL)
    sim.state = golden["state"].to("cuda")
    loop = TaxisLoop(sim)
    cs = CPGState.from_numpy(*(golden["controller"][k] for k in
                               ("phase", "amplitude", "damplitude")), device="cuda")
    em = golden["emitter"]
    before = ms.launches["megastep"]
    _cs, rec = loop.run(cs, em["qpos"].shape[0], record=True,
                        drives=torch.from_numpy(em["drive"]).cuda())
    torch.cuda.synchronize()
    assert ms.launches["megastep"] - before == em["qpos"].shape[0]
    for name in ("qpos", "qvel", "phase"):
        np.testing.assert_array_equal(rec[name].cpu().numpy(), em[name], err_msg=name)
