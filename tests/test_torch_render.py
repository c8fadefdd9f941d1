"""The port's camera raycaster against the JAX package's, on the CPU.

The JAX functions run jitted, as the JAX ``Renderer`` runs them, so its CPU
backend contracts products feeding sums into fused multiply-adds; the
port's camera path rounds them the same way (``raycast_scene(...,
fused=True)``). Inputs are the settled states of the committed goldens; the
frames of ``flygym_tpu_torch/assets/render_golden.npz`` were written by
``scripts/export_render_golden.py``.

Bars (``FRAME_BARS``, ``demo/render_cases.py``, held by the golden's frames
and by the card's): see there. The raycast of trackcam's rays: its geom index
equal on every ray; its distance within 5e-6 relative on 99.5% of the rays and
within 5e-5 on every one (measured with the same inputs on both sides: the
distance bit-equal on 99.28% of the capsule rays and 95.15% of the mesh-SDF
rays, within 5e-6 on 99.67% / 99.97%, the largest gaps 4.0e-5 / 1.9e-5, on
grazing rays whose quadratic cancels); the heightfield's plain march:
distance and index bit-equal to eager JAX's, normals within 2e-7.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import (
    TERRAIN_FLY,
    TERRAIN_GOLDEN,
    load_compiled,
    load_golden,
    load_terrain_golden,
)
from flygym_tpu_torch.demo.render_cases import CASES, frame_gap, load_render_golden, render_case
from flygym_tpu_torch.engine.kinematics import geom_poses
from flygym_tpu_torch.engine.maths import quat_to_mat
from flygym_tpu_torch.env.gym import FRAME_QUAT
from flygym_tpu_torch.render import raycast as pr
from flygym_tpu_torch.render.raycast import capsule_mask
from flygym_tpu_torch.render.sdf import build_sdf_pack

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 64
IDX_SHARE = 1.0
T_RTOL, T_SHARE, T_RTOL_ALL = 5e-6, 0.995, 5e-5


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def golden():
    return load_render_golden()


@pytest.fixture(scope="module")
def bench():
    """(JAX world, JAX model, port compiled, port state of settled world 0)."""
    _fly, world = _load_script("export_torch_model").build_benchmark()
    model, _ = world.compile()
    state = load_golden()["state"].map(lambda x: x[:1].clone())
    return world, model, load_compiled(), state


@pytest.fixture(scope="module")
def terrain():
    _fly, world = _load_script("export_terrain_golden").build_world()
    model, _ = world.compile()
    state = load_terrain_golden(TERRAIN_GOLDEN)["state"].map(lambda x: x[:1].clone())
    return world, model, load_compiled(TERRAIN_FLY), state


def _track_rays(compiled, state):
    """trackcam's (1, H*W, 3) origins and directions for world 0."""
    dirs = pr.camera_rays(H, W, 30.0).reshape(-1, 3) @ quat_to_mat(
        torch.tensor(FRAME_QUAT, dtype=torch.float32)).T
    origin = state.xpos[0, 1] + torch.tensor([0.0, -7.5, 6.0])
    return origin.expand(dirs.shape)[None].contiguous(), dirs[None].contiguous()


@pytest.mark.parametrize("height, width, fovy", [(24, 32, 45.0), (48, 64, 30.0), (25, 33, 45.0)])
def test_camera_rays_match_jax(height, width, fovy):
    from flygym_tpu.render.raycast import camera_rays

    got = pr.camera_rays(height, width, fovy)
    want = np.asarray(camera_rays(height, width, fovy))
    assert got.shape == want.shape == (height, width, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-7)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("height, width, fovy", [(24, 32, 45.0), (48, 64, 30.0), (25, 33, 45.0),
                                                 (120, 160, 30.0)])
def test_fused_camera_rays_match_jitted_jax(height, width, fovy):
    """The rays as the jitted ``Renderer`` rounds them (``fused=True``):
    bit-equal to the jitted JAX ``camera_rays`` on at least 99% of the
    components (measured: 99.22%, 99.87%, 99.27% and 99.10%; the plain
    rays 58-81%), within two ulps on every one."""
    import jax

    from flygym_tpu.render.raycast import camera_rays

    got = pr.camera_rays(height, width, fovy, fused=True).numpy()
    want = np.asarray(jax.jit(lambda: camera_rays(height, width, fovy))())
    assert (got == want).mean() >= 0.99
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_fused_geom_poses_equal_jitted_jax(bench):
    """The renderer's geom poses (``geom_poses(..., fused=True)``) equal the
    jitted JAX ``geom_poses`` to the last bit."""
    import jax

    from flygym_tpu.engine.kinematics import geom_poses as jax_geom_poses

    _world, jax_model, compiled, state = bench
    got = geom_poses(compiled.model, state.xpos, state.xquat, fused=True)
    want = jax.jit(jax_geom_poses)(jax_model, _jnp(state.xpos[0]), _jnp(state.xquat[0]))
    for g, w in zip(got, want):
        assert torch.equal(g[0], torch.from_numpy(np.asarray(w)))


def test_hash31_rounds_its_argument_as_jitted_jax():
    """The hash's sine argument contracted as XLA's CPU backend contracts it,
    fma(z, 74.7, fma(x, 127.1, y * 311.7)), and glibc's sinf: the hash equals
    the jitted JAX hash on 98.8% of 200,000 seeded lattice points (sinf and
    XLA's sin part by one ulp above ~2,000, which moves the hash by ~3e-3).
    The plain left-to-right sum misses on a quarter of them."""
    import jax

    from flygym_tpu.render.raycast import _hash31

    p = np.random.default_rng(0).integers(-80, 80, (200_000, 3)).astype(np.float32)
    want = np.asarray(jax.jit(_hash31)(p))
    got = pr._hash31(torch.tensor(p)).numpy()
    assert (got == want).mean() >= 0.985
    assert (np.abs(got - want) <= 5e-3).mean() >= 0.9999
    x, y, z = (torch.tensor(p[:, i]) for i in range(3))
    plain = torch.sin(x * 127.1 + y * 311.7 + z * 74.7) * 43758.5453
    assert ((plain - torch.floor(plain)).numpy() == want).mean() < 0.8


def test_value_noise3_matches_jax():
    import jax

    from flygym_tpu.render.raycast import _value_noise3

    x = (np.random.default_rng(1).random((100_000, 3)) * 80 - 40).astype(np.float32)
    want = np.asarray(jax.jit(_value_noise3)(x))
    got = pr._value_noise3(torch.tensor(x)).numpy()
    assert ((got >= 0) & (got < 1)).all()
    assert (np.abs(got - want) <= 5e-3).mean() >= 0.999


def test_bilinear_wrap_matches_jax():
    import jax

    from flygym_tpu.render.raycast import _bilinear_wrap

    rng = np.random.default_rng(2)
    tex = rng.random((5, 7, 3)).astype(np.float32)
    u, v = (rng.uniform(-3, 3, 1000).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(_bilinear_wrap)(tex, u, v))
    got = pr._bilinear_wrap(torch.tensor(tex), torch.tensor(u), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Texel centres sample exactly; u = 1.25 and -0.75 wrap to 0.25.
    tex = torch.tensor([[[1.0, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 1, 1]]])
    got = pr._bilinear_wrap(tex, torch.tensor([0.25, 0.75, 1.25, -0.75]), torch.full((4,), 0.25))
    np.testing.assert_allclose(got[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[1], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(got[2:], got[:1].expand(2, 3), atol=1e-6)


def test_soft_shadow_matches_jax(bench):
    """The penumbra of the sun's shadow rays from every hit of trackcam's
    frame, and of a point light's bounded ones."""
    import jax

    from flygym_tpu.render.raycast import _soft_shadow_capsules

    _world, _model, compiled, state = bench
    m = compiled.model
    gpos, gquat = geom_poses(m, state.xpos, state.xquat)
    o, d = _track_rays(compiled, state)
    mask = capsule_mask(m)
    t, _idx, normal = pr.raycast_scene(m, gpos, gquat, o, d, mask, fused=True)
    hit = torch.where((t < 1e29)[..., None], o + t[..., None] * d, o) + 1e-2 * normal
    p0, p1, radius = pr._capsule_segments(m, gpos, gquat, pr._FUSED)
    sun = pr.default_lights()[0]["vec"]
    to_light = torch.tensor([2.0, -1.0, 6.0]) - hit
    dist = torch.linalg.norm(to_light, dim=-1)
    for dirs, max_t in ((-sun.expand(hit.shape), None), (to_light / dist[..., None], dist)):
        got = pr._soft_shadow_capsules(p0, p1, radius, mask, hit, dirs, max_t=max_t)[0].numpy()
        jmax = None if max_t is None else _jnp(max_t[0])
        want = np.asarray(jax.jit(_soft_shadow_capsules, static_argnames=())(
            _jnp(p0[0]), _jnp(p1[0]), _jnp(radius), _jnp(mask), _jnp(hit[0]), _jnp(dirs[0]),
            max_t=jmax))
        assert (got < 1).mean() > 0.05  # some of the frame is in shadow
        assert (np.abs(got - want) <= 1e-4).mean() >= 0.999


def _raycast_pair(compiled, state, jax_model, sdf=None, jax_sdf=None, fused=True):
    """The port's raycast of trackcam's rays and JAX's: jitted for the
    camera's fused rounding, eager for the plain one."""
    import jax

    from flygym_tpu.render.raycast import raycast_scene

    m = compiled.model
    gpos, gquat = geom_poses(m, state.xpos, state.xquat)
    o, d = _track_rays(compiled, state)
    mask = capsule_mask(m)
    got = pr.raycast_scene(m, gpos, gquat, o, d, mask, sdf_pack=sdf, fused=fused)
    fn = lambda gp, gq, o, d: raycast_scene(jax_model, gp, gq, o, d, _jnp(mask), sdf_pack=jax_sdf)
    want = (jax.jit(fn) if fused else fn)(_jnp(gpos[0]), _jnp(gquat[0]), _jnp(o[0]), _jnp(d[0]))
    return [g[0].numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("scene", ["capsule", "sdf", "heightfield"])
def test_raycast_scene_matches_jax(bench, terrain, scene):
    """trackcam's rays: capsules and mesh SDFs as the camera renders them
    (fused, against jitted JAX); the heightfield as the retina's path does
    (plain, against eager JAX: XLA's compile of the jitted march takes ~25 s;
    the camera's fused march is held by the golden's terrain frame)."""
    if scene == "heightfield":
        _world, jax_model, compiled, state = terrain
        got, want = _raycast_pair(compiled, state, jax_model, fused=False)
    else:
        world, jax_model, compiled, state = bench
        sdf = jax_sdf = None
        if scene == "sdf":
            from flygym_tpu.render.sdf import build_sdf_pack as jax_build

            sdf = build_sdf_pack(compiled.model, compiled.render["geom_names"])
            jax_sdf = jax_build(jax_model, world.compiled.geom_name2id)
        got, want = _raycast_pair(compiled, state, jax_model, sdf, jax_sdf)
    (t, idx, normal), (jt, jidx, jnormal) = got, want
    assert (jidx == -1).mean() > 0.2 and (jidx >= 0).mean() > 0.02  # ground and fly in view
    if scene == "heightfield":  # the plain march: t and idx bit-equal to eager JAX's
        assert np.array_equal(t, jt) and np.array_equal(idx, jidx)
        assert np.abs(normal - jnormal).max() <= 2e-7
        return
    same = idx == jidx
    assert same.mean() >= IDX_SHARE
    hit = same & (jt < 1e29)
    rel = np.abs(t - jt)[hit] / np.abs(jt[hit])
    assert (rel <= T_RTOL).mean() >= T_SHARE and rel.max() <= T_RTOL_ALL
    assert (np.abs(normal - jnormal).max(axis=-1)[hit] <= 1e-3).mean() >= T_SHARE


@pytest.mark.parametrize("case", CASES)
def test_render_pixels_matches_the_jax_golden(golden, case):
    """Each case of the golden rendered by the port from the same state."""
    got = render_case(case, device="cpu", golden=golden)()
    want = golden["frames"][case]
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    gap = frame_gap(got, want)
    assert gap["ok"], gap


def test_capsule_frame_fresh_through_jax(bench, golden):
    """The capsule case rendered afresh by the JAX renderer equals the
    committed golden, and the port's frame holds to it."""
    import jax

    from flygym_tpu.engine.model import State
    from flygym_tpu.render.renderer import Renderer

    world, model, _compiled, state = bench
    jstate = State(**{k: _jnp(getattr(state, k)[0]) for k in state.__dataclass_fields__})
    fresh = np.asarray(Renderer(model, world, "trackcam", camera_res=(H, W))._render_fn(0, jstate))
    np.testing.assert_array_equal(fresh, golden["frames"]["capsule"][0])
    assert jax.default_backend() == "cpu"
    got = render_case("capsule", device="cpu", golden=golden)()[0]
    assert frame_gap(got, fresh)["ok"]
