"""The port's retina against the JAX package's: tables, the render oracle,
the kernel's plain version (K3) and K3's host build.

The fly is config 5's (``flygym_tpu_torch/assets/env_fly.npz``); its poses
are the settled worlds of ``env_fly_golden.npz`` with numpy pose noise, put
through the JAX forward kinematics, so both renders read the same
``xpos``/``xquat``. The ``cuda`` test runs on a machine with the card and
PyTorch only::

    python -m pytest --noconftest tests/test_torch_vision.py -m cuda
"""

import dataclasses
import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import ENV_FLY, load_compiled, load_env_golden
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import retina as rk
from flygym_tpu_torch.render.raycast import raycast_scene
from flygym_tpu_torch.vision import Retina, hex_lattice_directions

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_WORLDS = 4
BRANCHES = {"cone": None, "hard": 0.0}  # acceptance_fwhm_deg of each shading branch


def _share_within(got, want, tol) -> float:
    return float((np.abs(np.asarray(got) - np.asarray(want)) <= tol).mean())


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(ENV_FLY)


def load_env_exporter():
    spec = importlib.util.spec_from_file_location(
        "export_env_golden", REPO / "scripts" / "export_env_golden.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_env():
    _fly, _world, env = load_env_exporter().build_env()
    return env


@pytest.fixture(scope="module")
def poses(jax_env):
    """(xpos, xquat) numpy of N_WORLDS settled worlds with pose noise: root
    shifted by up to 1.5 mm and turned by up to 0.6 rad, joints by 0.05 rad."""
    import jax

    from flygym_tpu.engine.kinematics import forward_kinematics

    golden = load_env_golden()
    qpos = golden["state"].qpos[:N_WORLDS].numpy().copy()
    rng = np.random.default_rng(1)
    qpos[:, :2] += rng.uniform(-1.5, 1.5, (N_WORLDS, 2))
    yaw = rng.uniform(-0.6, 0.6, N_WORLDS)
    qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6] = np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)
    qpos[:, 7:] += rng.normal(0.0, 0.05, qpos[:, 7:].shape)
    xpos, xquat = jax.vmap(lambda q: forward_kinematics(jax_env.model, q))(qpos)
    return np.asarray(xpos, np.float32), np.asarray(xquat, np.float32)


def _port_state(compiled, xpos, xquat) -> State:
    s0 = compiled.initial_state
    B = xpos.shape[0]
    state = s0.map(lambda x: x.expand((B,) + x.shape[1:]).clone())
    return dataclasses.replace(state, xpos=torch.tensor(xpos), xquat=torch.tensor(xquat))


def _jax_state(jax_env, xpos, xquat):
    import jax
    import jax.numpy as jnp

    s0 = jax.tree.map(lambda x: jnp.broadcast_to(x, (xpos.shape[0],) + x.shape), jax_env._state0)
    return dataclasses.replace(s0, xpos=jnp.asarray(xpos), xquat=jnp.asarray(xquat))


@pytest.fixture(scope="module")
def jax_renders(jax_env, poses):
    """JAX ``Retina.render`` (the jnp oracle) of the posed worlds, per
    branch, run op by op: under ``jit`` XLA fuses and reassociates, and the
    jitted render differs from the eager one by up to 7e-5 in 0.12% of
    outputs (measured), where the port's oracle is within 3e-7 of the eager."""
    import jax

    from flygym_tpu.vision import Retina as JaxRetina

    state = _jax_state(jax_env, *poses)
    out = {}
    for name, fwhm in BRANCHES.items():
        ret = JaxRetina.build(jax_env.model, 5, 6, acceptance_fwhm_deg=fwhm)
        out[name] = np.asarray(jax.vmap(lambda s: ret.render(jax_env.model, s))(state))
    return out


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_retina_tables_equal_jax(compiled, jax_env, branch):
    from flygym_tpu.vision import Retina as JaxRetina
    from flygym_tpu.vision import hex_lattice_directions as jax_hex

    fwhm = BRANCHES[branch]
    want = JaxRetina.build(
        jax_env.model, jax_env.retina.left_eye_body, jax_env.retina.right_eye_body,
        acceptance_fwhm_deg=fwhm,
    )
    got = Retina.for_compiled(compiled, "fly0", acceptance_fwhm_deg=fwhm)
    np.testing.assert_array_equal(hex_lattice_directions(), jax_hex())
    assert (got.left_eye_body, got.right_eye_body) == (want.left_eye_body, want.right_eye_body)
    for name in ("directions_left", "directions_right", "channel_weights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype
    if fwhm == 0.0:
        assert got.blur_weights is None and want.blur_weights is None
    else:
        np.testing.assert_array_equal(got.blur_weights, want.blur_weights)
    assert got.cone_half_rad == want.cone_half_rad
    assert got.n_ommatidia == want.n_ommatidia == 721


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_render_oracle_matches_jax(compiled, poses, jax_renders, branch):
    """The port's oracle (raycast_scene and Retina.render) against JAX's:
    the same jnp arithmetic, so at least 99.9% within 1e-5."""
    ret = Retina.for_compiled(compiled, acceptance_fwhm_deg=BRANCHES[branch])
    got = ret.render(compiled.model, _port_state(compiled, *poses)).numpy()
    want = jax_renders[branch]
    assert got.shape == want.shape == (N_WORLDS, 2, 721, 2)
    assert _share_within(got, want, 1e-5) >= 0.999
    assert np.abs(got[0] - got[1]).max() > 1e-3  # the worlds differ


@pytest.fixture(scope="module")
def tiny_scene():
    """The three-geom scene of tests/engine/test_retina_kernel.py: ground,
    a free capsule head (the eyes), a capsule post and a sphere."""
    from flygym_tpu.compose.spec import BodySpec, GeomSpec, JointSpec, ModelSpec

    spec = ModelSpec("tiny")
    spec.world_geoms.append(GeomSpec(name="ground", type="plane", size=(100.0, 100.0, 1.0)))
    head = BodySpec(name="head", parent=None)
    head.add_joint(JointSpec(name="headfree", type="free"))
    head.add_geom(GeomSpec(name="headgeom", type="capsule", size=(0.4, 0.3), mass=1e-3,
                           rgba=(0.9, 0.6, 0.2, 1.0)))
    spec.add_body(head)
    post = BodySpec(name="post", parent=None)
    post.add_geom(GeomSpec(name="postgeom", type="capsule", size=(0.8, 3.0), mass=1e-3,
                           pos=(6.0, 2.0, 3.0), rgba=(0.2, 0.4, 0.9, 1.0)))
    spec.add_body(post)
    ball = BodySpec(name="ball", parent=None)
    ball.add_geom(GeomSpec(name="ballgeom", type="sphere", size=(1.5,), mass=1e-3,
                           pos=(8.0, -4.0, 1.5), rgba=(1.0, 0.1, 0.1, 1.0)))
    spec.add_body(ball)
    spec.neutral_joint_qpos["headfree"] = [0, 0, 1.5, 1, 0, 0, 0]
    compiled = spec.compile()
    return compiled.model, compiled.body_name2id["head"]


def _tiny_inputs(tiny_scene, n, seed):
    """JAX batched states of the tiny scene (head moved and turned) and the
    port's view of the same model's geom arrays."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.kinematics import forward_kinematics
    from flygym_tpu.engine.model import make_initial_state

    model, _hid = tiny_scene
    state = make_initial_state(model)
    rng = np.random.default_rng(seed)
    qpos = np.broadcast_to(np.asarray(state.qpos), (n, model.nq)).copy()
    qpos[:, :2] += rng.uniform(-1.5, 1.5, (n, 2))
    yaw = rng.uniform(-0.6, 0.6, n)
    qpos[:, 3], qpos[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)
    xp, xq = jax.vmap(lambda q: forward_kinematics(model, q))(jnp.asarray(qpos))
    batched = dataclasses.replace(batched, qpos=jnp.asarray(qpos), xpos=xp, xquat=xq)
    t = lambda x: torch.tensor(np.asarray(x))
    port_model = types.SimpleNamespace(
        geom_types=tuple(model.geom_types), geom_size=t(model.geom_size),
        geom_rgba=t(model.geom_rgba), geom_body=t(model.geom_body).long(),
        geom_pos=t(model.geom_pos), geom_quat=t(model.geom_quat),
        ground_pos=t(model.ground_pos), has_hfield=False, device=torch.device("cpu"),
    )
    return batched, port_model, t(xp), t(xq)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_matches_the_pallas_kernel_in_interpret_mode(tiny_scene, branch):
    """retina_plain against the JAX Pallas kernel (interpret mode) on the
    tiny scene: the same arithmetic, at least 99.9% within 1e-5."""
    from flygym_tpu.ops.retina_pallas import make_retina_kernel as jax_kernel
    from flygym_tpu.vision import Retina as JaxRetina

    model, hid = tiny_scene
    fwhm = BRANCHES[branch]
    jret = JaxRetina.build(model, hid, hid, n_rings=3, acceptance_fwhm_deg=fwhm)
    pret = Retina.build(None, hid, hid, n_rings=3, acceptance_fwhm_deg=fwhm)
    batched, port_model, xpos, xquat = _tiny_inputs(tiny_scene, 4, seed=3)
    want = np.asarray(jax_kernel(model, jret, interpret=True, layout="rays")(batched))
    tables = rk.RetinaTables(port_model, pret)
    assert tables.use_cone == (branch == "cone")
    got = rk.retina_plain(tables, rk.pack_rows(tables, xpos, xquat)).numpy()
    assert got.shape == want.shape == (4, 2, 37, 2)
    assert _share_within(got, want, 1e-5) >= 0.999
    assert np.abs(got[0] - got[1]).max() > 1e-4


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_matches_the_jax_oracle_on_the_fly(compiled, poses, jax_renders, branch):
    """K3's plain version and the blur against JAX's jnp oracle on the full
    fly: the JAX package's own bar for its kernel against that oracle
    (tests/engine/test_retina_kernel.py:97-98), 99.5% within 1e-3."""
    ret = Retina.for_compiled(compiled, acceptance_fwhm_deg=BRANCHES[branch])
    render = ret.make_render_batched(compiled.model)
    before = rk.launches["retina"]
    got = render(_port_state(compiled, *poses)).numpy()
    assert rk.launches["retina"] == before  # the CPU runs the plain version
    want = jax_renders[branch]
    assert _share_within(got, want, 1e-3) >= 0.995
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_host_build_of_the_kernel_matches_plain(compiled, poses, branch):
    """csrc/retina.cu compiled as host C++ (g++) against retina_plain: the
    kernel's arithmetic on the CPU (measured bit-identical; bar 99.9% within
    1e-5)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = _build.build_retina_host()
    tables = rk.RetinaTables(compiled.model, Retina.for_compiled(
        compiled, acceptance_fwhm_deg=BRANCHES[branch]))
    packed = rk.pack_rows(tables, *(torch.tensor(p) for p in poses))
    want = rk.retina_plain(tables, packed)
    got = torch.full_like(want, -1.0)
    err = lib.retina_host_f32(
        packed.data_ptr(), tables.dirs.data_ptr(), tables.weights.data_ptr(),
        tables.radius.data_ptr(), tables.rgb.data_ptr(), got.data_ptr(),
        N_WORLDS, tables.R, tables.G, tables.ground_z, tables.tanh_cone, int(tables.use_cone),
    )
    assert err == 0
    assert _share_within(got, want, 1e-5) >= 0.999
    assert (got - want).abs().max() <= 1e-5


def test_heightfield_is_refused(compiled):
    hfield = dataclasses.replace(compiled.model, has_hfield=True)
    ret = Retina.for_compiled(compiled)
    assert not rk.retina_kernel_supported(hfield)
    with pytest.raises(NotImplementedError, match="heightfield"):
        ret.make_render_batched(hfield)
    with pytest.raises(NotImplementedError, match="heightfield"):
        rk.make_retina_kernel(hfield, ret)
    state = compiled.initial_state
    with pytest.raises(NotImplementedError, match="heightfield"):
        raycast_scene(hfield, state.xpos, state.xquat, state.xpos[:, :1], state.xpos[:, :1], None)


def test_retina_needs_env_metadata():
    with pytest.raises(ValueError, match="env metadata"):
        Retina.for_compiled(load_compiled())


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(ENV_FLY)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_kernel_matches_plain(cuda_compiled, branch):
    """K3 against its plain version on the card at 1000 worlds: at least
    99.9% within 1e-5, all finite and in [0, 1]."""
    golden = load_env_golden()
    n = 1000
    idx = torch.arange(n) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    gen = torch.Generator().manual_seed(0)
    state = dataclasses.replace(
        state, xpos=state.xpos + 0.3 * torch.randn(state.xpos.shape, generator=gen).cuda()
    )
    model = cuda_compiled.model.to("cuda")
    kern = rk.make_retina_kernel(
        model, Retina.for_compiled(cuda_compiled, acceptance_fwhm_deg=BRANCHES[branch])
    )
    before = rk.launches["retina"]
    got = kern(state)
    want = rk.retina_plain(kern.tables, rk.pack_rows(kern.tables, state.xpos, state.xquat))
    torch.cuda.synchronize()
    assert rk.launches["retina"] == before + 1
    assert torch.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert ((got - want).abs() <= 1e-5).float().mean().item() >= 0.999
