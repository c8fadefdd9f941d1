"""The port's CPG and hybrid controllers against the JAX package's.

Both packages start from one controller state (numpy arrays, the JAX
package's ``HybridState.init`` of worlds 0..B-1) and run 200 steps: the JAX
controller vmapped over the worlds and called eagerly, as the terrain
golden's export runs it, and the port's batched one. Tip heights and
contact forces are seeded and made to trigger both reflex rules.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, load_compiled
from flygym_tpu_torch.control import (
    CPGController,
    CPGState,
    HybridController,
    HybridState,
    extract_preprogrammed_steps,
)
from flygym_tpu_torch.demo.spotlight import MotionSnippet

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 3
N_STEPS = 200
TOL = 1e-6


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(TERRAIN_FLY)


@pytest.fixture(scope="module")
def jax_steps():
    from flygym_tpu.compose import ActuatorType
    from flygym_tpu.control import extract_preprogrammed_steps as jax_extract
    from flygym_tpu.demo import MotionSnippet as JaxSnippet

    fly, _world = _load_script("export_terrain_golden").build_world()
    return jax_extract(JaxSnippet(), fly.get_actuated_jointdofs_order(ActuatorType.POSITION))


@pytest.fixture(scope="module")
def steps(compiled):
    order = [tuple(d) for d in compiled.flies["rugged"]["actuated_dofs"]["position"]]
    return extract_preprogrammed_steps(MotionSnippet(), order)


@pytest.fixture(scope="module")
def start():
    """The JAX package's initial states of worlds 0..B-1, as numpy."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.control import HybridState as JaxHybridState

    cs = jax.tree.map(lambda *x: jnp.stack(x), *[JaxHybridState.init(i) for i in range(B)])
    return cs, {"phase": np.asarray(cs.cpg.phase), "amplitude": np.asarray(cs.cpg.amplitude),
                "damplitude": np.asarray(cs.cpg.damplitude),
                "retraction": np.asarray(cs.retraction), "stumbling": np.asarray(cs.stumbling)}


def _inputs(seed=0):
    """Per step: tip heights (B, 6) with a leg sometimes stuck 0.1-0.3 mm
    below the others, and contact forces (B, 6, 3) that oppose the heading
    by more than the threshold on some legs; headings (B, 3) of unit length."""
    rng = np.random.default_rng(seed)
    tips = rng.uniform(0.0, 0.04, (N_STEPS, B, 6)).astype(np.float32)
    stuck = rng.random((N_STEPS, B, 6)) < 0.15
    tips -= np.where(stuck, rng.uniform(0.1, 0.3, stuck.shape), 0.0).astype(np.float32)
    forces = rng.normal(0.0, 1.5, (N_STEPS, B, 6, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, B)
    heading = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(B)], -1).astype(np.float32)
    return tips, forces, heading


@pytest.mark.parametrize("key", ["tables", "stance", "freq_hz", "dof_map", "neutral"])
def test_step_tables_equal_jax(jax_steps, steps, key):
    np.testing.assert_array_equal(np.asarray(steps[key]), np.asarray(jax_steps[key]))


def test_motion_snippet_reads_the_clip_labels():
    snippet = MotionSnippet()
    assert len(snippet.keypoints) == snippet.fwdkin_egoxyz.shape[1] == 30
    assert ("lf", "tarsus5", None) in snippet.keypoints
    assert snippet.fwdkin_egoxyz.dtype == np.float32


def test_cpg_matches_jax_over_200_steps(jax_steps, steps, start):
    import jax

    from flygym_tpu.control import CPGController as JaxCPG

    jcpg = JaxCPG(jax_steps, timestep=1e-4)
    cpg = CPGController(steps, timestep=1e-4, device="cpu")
    vcall = jax.vmap(jcpg)
    jstate = start[0].cpg
    state = HybridState.from_numpy(start[1], device="cpu").cpg
    worst = 0.0
    for _ in range(N_STEPS):
        jstate, jt, ja = vcall(jstate)
        state, t, a = cpg(state)
        for got, want in ((state.phase, jstate.phase), (state.amplitude, jstate.amplitude),
                          (state.damplitude, jstate.damplitude), (t, jt), (a, ja)):
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
    assert worst <= TOL, worst


def test_hybrid_matches_jax_over_200_steps(jax_steps, steps, start):
    """Both rules fire (checked), and every output and state agrees."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.control import CPGController as JaxCPG
    from flygym_tpu.control import HybridController as JaxHybrid

    jhyb = jax.vmap(JaxHybrid(cpg=JaxCPG(jax_steps, timestep=1e-4)))
    hyb = HybridController(cpg=CPGController(steps, timestep=1e-4, device="cpu"))
    tips, forces, heading = _inputs()
    jstate, state = start[0], HybridState.from_numpy(start[1], device="cpu")
    worst, fired = 0.0, {"retraction": False, "stumbling": False, "release": False}
    for i in range(N_STEPS):
        jstate, jt, ja = jhyb(jstate, jnp.asarray(tips[i]), jnp.asarray(forces[i]),
                              jnp.asarray(heading))
        state, t, a = hyb(state, torch.from_numpy(tips[i]), torch.from_numpy(forces[i]),
                          torch.from_numpy(heading))
        pairs = [(t, jt), (a, ja), (state.retraction, jstate.retraction),
                 (state.stumbling, jstate.stumbling), (state.cpg.phase, jstate.cpg.phase)]
        for got, want in pairs:
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
        fired["retraction"] |= bool((state.retraction > 0).any())
        fired["stumbling"] |= bool((state.stumbling > 0).any())
        fired["release"] |= bool(((a == 1.0) & (torch.maximum(state.retraction, state.stumbling)
                                                 > 0.2)).any())
    assert all(fired.values()), fired
    assert worst <= TOL, worst


def test_controller_defaults_to_the_card(steps):
    """No device means CUDA: without a card the constructor raises."""
    if torch.cuda.is_available():
        assert CPGController(steps).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CPGController(steps)


@pytest.mark.parametrize("cls", ["CPGState", "HybridState"])
def test_controller_state_from_numpy_defaults_to_the_card(start, cls):
    """No device means CUDA: without a card ``from_numpy`` raises."""
    arrays = start[1]
    if cls == "HybridState":
        make = lambda: HybridState.from_numpy(arrays).cpg
    else:
        make = lambda: CPGState.from_numpy(arrays["phase"], arrays["amplitude"],
                                           arrays["damplitude"])
    if torch.cuda.is_available():
        assert make().phase.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_init_draws_phases_from_a_generator():
    cpu = torch.device("cpu")
    a = HybridState.init(5, torch.Generator().manual_seed(3), cpu)
    b = HybridState.init(5, torch.Generator().manual_seed(3), cpu)
    assert torch.equal(a.cpg.phase, b.cpg.phase)
    assert a.cpg.phase.shape == (5, 6)
    assert float(a.cpg.phase.min()) >= 0.0 and float(a.cpg.phase.max()) < 2 * np.pi
    assert not a.retraction.any() and not a.cpg.amplitude.any()


@pytest.mark.cuda
def test_controller_on_the_card_equals_the_cpu(steps):
    """200 steps of the hybrid controller on CUDA tensors and on CPU tensors
    from one state and the same seeded readouts, bit for bit: on the card
    torch divides a tensor by a Python float as a product with the float's
    reciprocal, which moved the CPG's bin position by up to 6e-8, so the
    controller divides by a tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tips, forces, heading = _inputs(seed=1)
    init = HybridState.init(B, torch.Generator().manual_seed(0), device="cpu")
    arrays = {"phase": init.cpg.phase, "amplitude": init.cpg.amplitude,
              "damplitude": init.cpg.damplitude, "retraction": init.retraction,
              "stumbling": init.stumbling}
    runs = {}
    for dev in ("cpu", "cuda"):
        hyb = HybridController(cpg=CPGController(steps, timestep=1e-4, device=dev))
        state = HybridState.from_numpy({k: v.numpy() for k, v in arrays.items()}, device=dev)
        out = []
        for i in range(N_STEPS):
            state, t, a = hyb(state, torch.from_numpy(tips[i]).to(dev),
                              torch.from_numpy(forces[i]).to(dev), torch.from_numpy(heading).to(dev))
            out += [t.cpu(), a.cpu(), state.cpg.phase.cpu(), state.retraction.cpu()]
        runs[dev] = out
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert torch.equal(got, want)
