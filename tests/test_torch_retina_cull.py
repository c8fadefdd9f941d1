"""K3's redesign on the CPU: the ray tiles, the cull of geoms per tile, and
the host build against K3 as it stood before the redesign.

K3 shades each eye's rays in tiles of 32 (``ops/retina.py:ray_tiles``) and
sweeps, per (world, eye, tile), only the geoms whose bounding sphere the
tile's cone can reach (``csrc/retina.cu:keep_geom``). That is right only if
the cull keeps every (tile, geom) pair in which some ray of the tile is hit
or covered by the geom; then the outputs keep their bits. Here the cull's
keep mask (the host build's, ``retina_tiles_host_f32``, and on the card the
profile build's) is held against the contributing pairs
(``ops/retina.py:contributing_pairs``, the plain version's arithmetic in
torch), over 200 seeded poses of config 5's fly, three in four of them with
eyes placed inside, just outside and near the geoms, at random orientations
(so that most geoms lie behind or beside an eye). The shipped host builds
(tiles, and each ray a tile of its own) are held against the build of
``scripts/k3_before_redesign/retina.cu`` to the last bit. The ``cuda``
tests run on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_retina_cull.py -m cuda
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import ENV_FLY, load_compiled, load_env_golden
from flygym_tpu_torch.engine.kinematics import forward_kinematics
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import retina as rk
from flygym_tpu_torch.vision import Retina

torch.set_num_threads(1)

BEFORE = Path(__file__).resolve().parents[1] / "scripts" / "k3_before_redesign" / "retina.cu"
BRANCHES = {"cone": None, "hard": 0.0}  # acceptance_fwhm_deg of each shading branch
N_POSES = 200
CHUNK = 25  # worlds per torch pass of the contributing pairs
OTHER_WARPS = (2, 8, 24)  # K3's block shapes besides the shipped one


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(ENV_FLY)


def _tables(compiled, branch) -> rk.RetinaTables:
    retina = Retina.for_compiled(compiled, acceptance_fwhm_deg=BRANCHES[branch])
    return rk.RetinaTables(compiled.model, retina)


def _posed(compiled, n, seed, root_mm=1.5, yaw_rad=0.6, joint_rad=0.05):
    """(xpos, xquat) of the env golden's settled worlds with numpy pose
    noise (test_torch_vision.py's recipe), through the port's kinematics."""
    golden = load_env_golden()
    qpos = golden["state"].qpos[np.arange(n) % golden["state"].qpos.shape[0]].numpy().copy()
    rng = np.random.default_rng(seed)
    qpos[:, :2] += rng.uniform(-root_mm, root_mm, (n, 2))
    yaw = rng.uniform(-yaw_rad, yaw_rad, n)
    qpos[:, 3], qpos[:, 4], qpos[:, 5], qpos[:, 6] = np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)
    qpos[:, 7:] += rng.normal(0.0, joint_rad, qpos[:, 7:].shape)
    return forward_kinematics(compiled.model, torch.tensor(qpos, dtype=torch.float32))


def _adversarial_rows(tables, xpos, xquat, seed) -> torch.Tensor:
    """Packed rows in which, in three worlds of four, each eye sits at a
    random orientation inside a geom (0.999 of its radius from its
    segment), just outside it (1.001) or near it (1.01 to 4 radii)."""
    packed = rk.pack_rows(tables, xpos, xquat).clone()
    B, G = packed.shape[0], tables.G
    seg = packed[:, 14:].reshape(B, G, 6).double().numpy()
    rng = np.random.default_rng(seed)
    for b in range(B):
        for e in range(2):
            mode = (b + e) % 4
            if mode == 3:
                continue
            g = rng.integers(G)
            p0, ba = seg[b, g, :3], seg[b, g, 3:] - seg[b, g, :3]
            base = p0 + np.clip(rng.uniform(-0.2, 1.2), 0.0, 1.0) * ba
            n = rng.normal(size=3)
            if ba @ ba > 0:
                n -= ba * (n @ ba) / (ba @ ba)
            n /= np.linalg.norm(n)
            f = (0.999, 1.001, 1.0 + rng.uniform(0.01, 3.0))[mode]
            q = rng.normal(size=4)
            packed[b, 7 * e : 7 * e + 3] = torch.tensor(base + f * tables.radius[g].item() * n)
            packed[b, 7 * e + 3 : 7 * e + 7] = torch.tensor(q / np.linalg.norm(q))
    return packed


def _render_tiles(lib, tables, packed) -> tuple:
    """The tiled host build: its outputs and its cull's keep mask."""
    B = packed.shape[0]
    out = torch.full((B, 2, tables.R, 2), -1.0)
    keep = torch.zeros((B, 2, tables.T, tables.G), dtype=torch.uint8)
    assert lib.retina_tiles_host_f32(
        packed.data_ptr(), tables.ray_index.data_ptr(), tables.tile_dirs.data_ptr(),
        tables.tile_weights.data_ptr(), tables.tile_axis.data_ptr(), tables.radius.data_ptr(),
        tables.rgb.data_ptr(), out.data_ptr(), keep.data_ptr(), B, tables.R, tables.T, tables.G,
        tables.ground_z, tables.tanh_cone, int(tables.use_cone)) == 0
    return out, keep.bool()


def _needed(tables, packed) -> tuple:
    """(B, 2, T, G) bool, True where some ray of the tile is hit or covered
    by the geom, and the number of eyes that lie inside some geom."""
    slots = tables.ray_index.long().reshape(2, tables.T, rk.TILE)
    needed = torch.zeros((packed.shape[0], 2, tables.T, tables.G), dtype=torch.bool)
    inside = 0
    for i in range(0, packed.shape[0], CHUNK):
        rows = packed[i : i + CHUNK]
        contrib = rk.contributing_pairs(tables, rows)  # (b, 2, R, G)
        for e in range(2):
            per_slot = contrib[:, e][:, slots[e].clamp(min=0)]  # (b, T, 32, G)
            needed[i : i + CHUNK, e] = (per_slot & (slots[e] >= 0)[None, :, :, None]).any(dim=2)
        # Eyes that lie inside some geom (the plain version's outside gate is 0).
        eye = rows[:, :14].reshape(-1, 2, 7)[:, :, None, :3]
        seg = rows[:, 14:].reshape(-1, 1, tables.G, 6)
        p0, ba = seg[..., :3], seg[..., 3:] - seg[..., :3]
        s = torch.clamp(((eye - p0) * ba).sum(-1) / (ba * ba).sum(-1).clamp(min=1e-12), 0.0, 1.0)
        dist = (eye - p0 - s[..., None] * ba).norm(dim=-1)
        inside += int((dist < tables.radius).any(dim=-1).sum())
    return needed, inside


def _render_before(lib, tables, packed) -> torch.Tensor:
    B = packed.shape[0]
    out = torch.full((B, 2, tables.R, 2), -1.0)
    assert lib.retina_before_host_f32(
        packed.data_ptr(), tables.dirs.data_ptr(), tables.weights.data_ptr(),
        tables.radius.data_ptr(), tables.rgb.data_ptr(), out.data_ptr(), B, tables.R, tables.G,
        tables.ground_z, tables.tanh_cone, int(tables.use_cone)) == 0
    return out


@pytest.fixture(scope="module")
def host_builds():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build.build_retina_host(), _build.build_retina_host(BEFORE)


@pytest.fixture(scope="module")
def adversarial(compiled):
    """Per branch: the 200 adversarial rows and the tables."""
    xpos, xquat = _posed(compiled, N_POSES, seed=11)
    out = {}
    for branch in BRANCHES:
        tables = _tables(compiled, branch)
        out[branch] = (tables, _adversarial_rows(tables, xpos, xquat, seed=12))
    return out


def test_ray_tiles_hold_every_ray_once_inside_its_cone(compiled):
    tables = _tables(compiled, "cone")
    R, T = tables.R, tables.T
    assert T == -(-R // rk.TILE) == 23
    for e in range(2):
        order = tables.ray_index[e].long()
        assert torch.equal(order[order >= 0].sort().values, torch.arange(R))
        assert (order[: R] >= 0).all() and (order[R:] == -1).all()  # pads end the last tile
        slot = order >= 0
        assert torch.equal(tables.tile_dirs[e][slot], tables.dirs[e][order[slot]])
        assert torch.equal(tables.tile_weights[e][slot], tables.weights[order[slot]])
        assert (tables.tile_dirs[e][~slot] == 0).all() and (tables.tile_weights[e][~slot] == 0).all()
        axis = tables.tile_axis[e].double()
        assert torch.allclose(axis[:, :3].norm(dim=1), torch.ones(T, dtype=torch.float64), atol=1e-6)
        d = tables.tile_dirs[e].double().reshape(T, rk.TILE, 3)
        a = axis[:, None, :3].expand_as(d)
        angle = torch.atan2(torch.linalg.cross(d, a).norm(dim=-1), (d * a).sum(-1))
        inside = angle <= axis[:, 3:4]
        assert inside[slot.reshape(T, rk.TILE)].all()
        # Compact: the mean half-angle is less than half the lattice order's.
        assert axis[:, 3].mean() < 0.6


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cull_keeps_every_contributing_pair(host_builds, adversarial, branch):
    lib, _before = host_builds
    tables, packed = adversarial[branch]
    _out, keep = _render_tiles(lib, tables, packed)
    needed, inside = _needed(tables, packed)
    assert inside >= N_POSES // 4  # the adversarial eyes are there
    assert needed.float().mean() > 0.02  # and the scene is seen
    missed = needed & ~keep
    assert int(missed.sum()) == 0, f"{int(missed.sum())} contributing (tile, geom) pairs culled"
    assert keep.float().mean() < 0.3  # the cull does cull


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_host_build_equals_the_before_build(compiled, host_builds, adversarial, branch):
    """The shipped host builds (tiles and cull; each ray a tile of its own,
    in lattice order) against K3 before the redesign, to the last bit: on
    test_torch_vision.py's posed worlds and on the adversarial poses."""
    lib, before = host_builds
    tables, packed = adversarial[branch]
    vision = rk.pack_rows(tables, *_posed(compiled, 4, seed=1))
    for rows in (vision, packed):
        want = _render_before(before, tables, rows)
        assert torch.isfinite(want).all() and want.min() >= 0.0 and want.max() <= 1.0
        assert torch.equal(_render_tiles(lib, tables, rows)[0], want)
        per_ray = torch.full_like(want, -1.0)
        assert lib.retina_host_f32(
            rows.data_ptr(), tables.dirs.data_ptr(), tables.weights.data_ptr(),
            tables.radius.data_ptr(), tables.rgb.data_ptr(), per_ray.data_ptr(), rows.shape[0],
            tables.R, tables.G, tables.ground_z, tables.tanh_cone, int(tables.use_cone)) == 0
        assert torch.equal(per_ray, want)


def test_before_build_equals_plain(compiled, host_builds):
    """K3 before its redesign, the yardstick chip_smoke.py times the
    redesign against, equals the plain version on the posed worlds."""
    _lib, before = host_builds
    for branch in BRANCHES:
        tables = _tables(compiled, branch)
        packed = rk.pack_rows(tables, *_posed(compiled, 4, seed=1))
        assert torch.equal(_render_before(before, tables, packed), rk.retina_plain(tables, packed))


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(ENV_FLY)


def _launch_before(tables, packed) -> torch.Tensor:
    """K3 before its redesign on the card."""
    B = packed.shape[0]
    out = torch.empty((B, 2, tables.R, 2), device="cuda")
    assert _build.load_retina(BEFORE).retina_before_f32(
        packed.data_ptr(), tables.dirs.data_ptr(), tables.weights.data_ptr(),
        tables.radius.data_ptr(), tables.rgb.data_ptr(), out.data_ptr(), B, tables.R, tables.G,
        tables.ground_z, tables.tanh_cone, int(tables.use_cone),
        torch.cuda.current_stream().cuda_stream) == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_kernel_equals_the_before_build(cuda_compiled, branch):
    """K3 against its build before the redesign on the card, to the last
    bit, at 1000 posed worlds and every block shape; the profile build's
    outputs too."""
    retina = Retina.for_compiled(cuda_compiled, acceptance_fwhm_deg=BRANCHES[branch])
    tables = rk.RetinaTables(cuda_compiled.model.to("cuda"), retina)
    xpos, xquat = _posed(cuda_compiled, 1000, seed=3)
    packed = rk.pack_rows(tables, xpos.cuda(), xquat.cuda())
    want = _launch_before(tables, packed)
    before = rk.launches["retina"]
    assert torch.equal(rk.launch_retina(tables, packed), want)
    assert rk.launches["retina"] == before + 1
    for warps in OTHER_WARPS:
        assert torch.equal(rk.launch_build(tables, packed, warps), want)
    assert torch.equal(rk.keep_mask(tables, packed)[0], want)
    assert rk.launches["retina"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_card_cull_keeps_every_contributing_pair(cuda_compiled, adversarial, branch):
    """The profile build's keep mask on the card (acosf and asinf of the
    card, not of the host) holds every contributing (tile, geom) pair of
    the 200 adversarial poses, and the outputs equal the before build's."""
    cpu_tables, rows = adversarial[branch]
    retina = Retina.for_compiled(cuda_compiled, acceptance_fwhm_deg=BRANCHES[branch])
    tables = rk.RetinaTables(cuda_compiled.model.to("cuda"), retina)
    packed = rows.cuda()
    got, keep = rk.keep_mask(tables, packed)
    assert torch.equal(got, _launch_before(tables, packed))
    needed, _inside = _needed(cpu_tables, rows)
    missed = needed & ~keep.cpu()
    assert int(missed.sum()) == 0, f"{int(missed.sum())} contributing (tile, geom) pairs culled"
    if shutil.which("g++") is not None:  # the card's mask against the host's
        host = _render_tiles(_build.build_retina_host(), cpu_tables, rows)[1]
        assert (keep.cpu() != host).float().mean() <= 1e-4
