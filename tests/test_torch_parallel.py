"""Worlds split over a mesh of devices: ``flygym_tpu_torch/parallel``,
``make_megastep_sharded``, ``BatchSimulation(mesh=)``, ``put_like`` and
example 12, against the unsharded port and the JAX package.

On the CPU a mesh is a list of shards on the CPU (a device may repeat), as
the JAX package's tests shard over ``tests/conftest.py``'s 8 virtual CPU
devices. Every step has no operation across worlds, so a sharded run
equals the unsharded one to the last bit (``torch.equal``): K2's plain
version (the mega-step on the CPU) at 2 shards on the flat fly, the
terrain fly and compressed pair rows on terrain, the plane and winner
samplers per shard, and the engine step at 8 shards, which is also held to
JAX's ``BatchSimulation(world, 16, mesh=)`` within the engine golden's bars.
"""

import contextlib
import io
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import (
    TERRAIN_FLY, TWOFLY_FULL, TWOFLY_FULL_GOLDEN, load_golden, load_twofly_golden)
from flygym_tpu_torch.demo import multichip_scaling
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.ops import megastep as ms
from flygym_tpu_torch.parallel import (
    gather_world_axis, make_world_mesh, replicate_model, shard_world_axis)
from flygym_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _same(a: State, b: State) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in fields(a))


@pytest.fixture(scope="module")
def compiled():
    return load_compiled()


@pytest.fixture(scope="module")
def golden():
    return load_golden()


def _settled(golden, n: int) -> State:
    """The golden's settled worlds repeated to ``n``."""
    idx = torch.arange(n) % golden["state"].qpos.shape[0]
    return golden["state"].map(lambda x: x[idx].clone())


def _differ(state: State, model) -> State:
    """``state`` with seeded noise in every hinge (0.01 rad) and in qvel
    (0.1), the forward kinematics redone: no two worlds, and so no two
    shards, are the same, and a shard that read another's block would
    show."""
    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    n = state.qpos.shape[0]
    gen = torch.Generator().manual_seed(n)
    qpos, qvel = state.qpos.clone(), state.qvel.clone()
    qpos[:, model.hinge_qadr] += 0.01 * torch.randn((n, len(model.hinge_qadr)), generator=gen)
    qvel += 0.1 * torch.randn(qvel.shape, generator=gen)
    xpos, xquat = forward_kinematics(model, qpos)
    return replace(state, qpos=qpos, qvel=qvel, xpos=xpos, xquat=xquat)


def test_mesh_blocks_and_the_divisibility_error(compiled):
    """Contiguous equal blocks, block i on device i, joined back in order;
    dim 1 for (K, B, ...) rows; one model copy per distinct device; the
    mesh needs a card by default; JAX's error text where the worlds do not
    divide."""
    mesh = make_world_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_name == "world"
    x = torch.arange(8 * 3.0).reshape(8, 3)
    blocks = shard_world_axis(x, mesh)
    assert [b.tolist() for b in blocks] == [x[2 * i:2 * i + 2].tolist() for i in range(4)]
    assert all(b.device == torch.device("cpu") for b in blocks)
    assert torch.equal(gather_world_axis(blocks), x)
    rows = torch.arange(2 * 8.0).reshape(2, 8)
    assert torch.equal(shard_world_axis(rows, mesh, dim=1)[1], rows[:, 2:4])
    assert torch.equal(gather_world_axis(shard_world_axis(rows, mesh, dim=1), dim=1), rows)
    state = compiled.initial_state.map(lambda v: v.expand((8,) + v.shape[1:]).clone())
    shards = shard_world_axis(state, mesh)
    assert [s.qpos.shape[0] for s in shards] == [2] * 4
    assert _same(gather_world_axis(shards), state)
    models = replicate_model(compiled.model, mesh)
    assert len(models) == 4 and all(m is models[0] for m in models)
    one = make_world_mesh(["cpu"])
    assert shard_world_axis(x, one)[0] is x and gather_world_axis([x]) is x
    sim = BatchSimulation(compiled, 2, device="cpu")
    assert sim.mesh.devices == (torch.device("cpu"),) and len(sim.shards) == 1
    assert sim.state is sim.shards[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_world_mesh()
    with pytest.raises(ValueError, match="n_worlds=6 not divisible by mesh axis 'world' of "
                                         "size 4"):
        shard_world_axis(x[:6], mesh)
    with pytest.raises(ValueError) as e:
        BatchSimulation(compiled, 12, mesh=make_world_mesh(["cpu"] * 8))
    # flygym_tpu/batch.py:57-61's text.
    assert str(e.value) == "n_worlds=12 not divisible by mesh axis 'world' of size 8"


def test_megastep_on_two_shards_equals_unsharded(compiled, golden):
    """The benchmark fly in BatchSimulation with the mega-step (its plain
    version on the CPU) over 2 shards: one K = 1 step and one K = 2 launch
    (rollout of 2), with the golden's first targets, equal to the
    unsharded batch to the last bit; the state stays per shard."""
    mesh = make_world_mesh(["cpu", "cpu"])
    fly = compiled.fly_names[0]
    targets = torch.as_tensor(golden["targets"][:4, :2]).transpose(0, 1)
    sims = [BatchSimulation(compiled, 4, device="cpu", megastep=True, megastep_k=2),
            BatchSimulation(compiled, 4, mesh=mesh, megastep=True, megastep_k=2)]
    for sim in sims:
        sim.state = _differ(_settled(golden, 4), compiled.model)
        sim.set_actuator_inputs(fly, "position", targets[0])
        sim.step()
    assert _same(sims[0].state, sims[1].state)
    assert len(sims[1].shards) == 2 and sims[1].shards[1].qpos.shape[0] == 2
    seq = torch.full((2, 4, compiled.model.nu), float("nan"))
    seq[:, :, sims[0].actuator_ids(fly, "position")] = targets
    trajs = [sim.rollout(seq, 2) for sim in sims]
    assert sims[1].step_fns(2)[1].k_steps == 2
    assert torch.equal(trajs[0], trajs[1]) and _same(sims[0].state, sims[1].state)


@pytest.mark.parametrize("world", ["terrain_fly", "twofly_terrain"])
def test_megastep_with_planes_and_winners_on_two_shards(world):
    """K2's plain version through ``make_megastep_sharded`` over 2 shards
    of one world each, sampling per shard: the terrain fly (plane rows) and
    example 11's flies on the blocks terrain (compressed pair rows on a
    heightfield: planes, then winners), one K = 1 launch from the goldens'
    settled worlds, equal to the unsharded launch to the last bit."""
    from flygym_tpu_torch.compose.bridge import (
        ASSETS, TWOFLY_TERRAIN_GOLDEN, load_terrain_golden)

    c = load_compiled(ASSETS / f"{world}.npz")
    golden = (load_terrain_golden() if world == "terrain_fly"
              else load_twofly_golden(TWOFLY_TERRAIN_GOLDEN))
    state = golden["state"].map(lambda v: v[:2].clone())
    fn = ms.make_megastep_sharded(c.model, make_world_mesh(["cpu", "cpu"]))
    assert fn.sample_planes is not None
    got = fn(shard_world_axis(state, make_world_mesh(["cpu", "cpu"])))
    assert len(got) == 2 and _same(gather_world_axis(got), ms.make_megastep(c.model)(state))


def test_planes_and_winners_per_shard_equal_the_unsharded_sample():
    """The terrain fly's plane sampler and the default two-fly preset's
    winner sampler, run per shard by the sharded mega-step, equal the
    unsharded sample."""
    mesh = make_world_mesh(["cpu", "cpu"])
    gen = torch.Generator().manual_seed(0)
    terrain = load_compiled(TERRAIN_FLY)
    st = terrain.initial_state
    state = st.map(lambda v: v.expand((6,) + v.shape[1:]).clone())
    state = replace(state, xpos=state.xpos + 0.5 * torch.rand(state.xpos.shape, generator=gen))
    full = load_twofly_golden(TWOFLY_FULL_GOLDEN)["state"]
    pairs = load_compiled(TWOFLY_FULL)
    for model, s in ((terrain.model, state), (pairs.model, full.map(lambda v: v[:6].clone()))):
        want = ms.make_megastep(model).sample_planes(s)
        fn = ms.make_megastep_sharded(model, mesh)
        got = fn.sample_planes(shard_world_axis(s, mesh))
        assert len(got) == 2 and torch.equal(gather_world_axis(got), want)
    assert want.shape == (6, 55)  # the preset's 55 groups


@pytest.fixture(scope="module")
def jax_sharded(golden):
    """16 steps of JAX's BatchSimulation(world, 16, mesh=) over the 8
    virtual CPU devices, from the golden's settled worlds with its targets."""
    import jax

    import flygym_tpu
    from flygym_tpu.demo.benchmark import make_model
    from flygym_tpu.engine.model import State as JaxState
    from flygym_tpu.parallel import make_world_mesh as jax_mesh
    from flygym_tpu.parallel import shard_world_axis as jax_shard

    if len(jax.devices()) < 8:
        pytest.skip("needs tests/conftest.py's 8 virtual devices")
    mesh = jax_mesh(jax.devices()[:8])
    _fly, world, _cam = make_model()
    sim = flygym_tpu.BatchSimulation(world, 16, mesh=mesh)
    start = _settled(golden, 16)
    sim.state = jax_shard(JaxState(**{f.name: getattr(start, f.name).numpy()
                                      for f in fields(start)}), mesh)
    seq = _targets_seq(golden, sim.model.nu)
    sim.rollout(seq.numpy(), 16)
    return {k: np.asarray(getattr(sim.state, k)) for k in ("qpos", "qvel")}


def _targets_seq(golden, nu: int) -> torch.Tensor:
    """(16, 16, nu): the golden's first 16 targets of each world on the
    position actuators, NaN (hold) elsewhere."""
    compiled = load_compiled()
    ids = torch.as_tensor(compiled.flies[compiled.fly_names[0]]["act_ids"]["position"])
    targets = torch.as_tensor(golden["targets"][:, :16])
    idx = torch.arange(16) % targets.shape[0]
    seq = torch.full((16, 16, nu), float("nan"))
    seq[:, :, ids] = targets[idx].transpose(0, 1)
    return seq


def test_engine_path_on_eight_shards(compiled, golden, jax_sharded):
    """The engine step (K1/K1b's plain versions on the CPU) over 8 shards
    for 16 steps with the golden's targets: from 16 worlds that differ,
    equal to the unsharded batch to the last bit; from the golden's
    settled worlds, within the engine golden's bars of JAX's sharded
    BatchSimulation on 8 virtual devices."""
    mesh = make_world_mesh(["cpu"] * 8)
    seq = _targets_seq(golden, compiled.model.nu)
    sims = [BatchSimulation(compiled, 16, device="cpu"),
            BatchSimulation(compiled, 16, mesh=mesh)]
    trajs = []
    for sim in sims:
        assert not sim.megastep
        sim.state = _differ(_settled(golden, 16), compiled.model)
        trajs.append(sim.rollout(seq, 16))
    assert torch.equal(trajs[0], trajs[1]) and _same(sims[0].state, sims[1].state)
    sim = sims[1]
    sim.state = _settled(golden, 16)
    sim.rollout(seq, 16)
    for key in ("qpos", "qvel"):
        gap = np.abs(getattr(sim.state, key).numpy() - jax_sharded[key]).max()
        assert gap <= GOLDEN_TOLERANCE[key], (key, gap)


def test_put_like_round_trip(compiled, golden, tmp_path):
    """A checkpoint of a sharded batch loads back onto its shards'
    devices, block for block (``load_state`` through ``put_like``); a
    State reference puts it on that State's device; a state of another
    width is refused."""
    mesh = make_world_mesh(["cpu"] * 4)
    sim = BatchSimulation(compiled, 8, mesh=mesh)
    sim.state = _differ(_settled(golden, 8), compiled.model)
    sim.step()
    want = [s.map(torch.clone) for s in sim.shards]
    sim.save_state(tmp_path / "state.npz")
    sim.reset()
    assert not _same(sim.state, gather_world_axis(want))
    sim.load_state(tmp_path / "state.npz")
    assert all(_same(a, b) for a, b in zip(sim.shards, want))
    loaded = checkpoint.load_state(tmp_path / "state.npz", device="cpu")
    put = checkpoint.put_like(loaded, want)
    assert [s.qpos.shape[0] for s in put] == [2] * 4 and all(map(_same, put, want))
    assert _same(checkpoint.put_like(loaded, want[0]), loaded)
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.put_like(loaded.map(lambda x: x[:6]), want)


def test_example_12_on_two_shards(compiled):
    """Example 12 reduced: 2 shards of 4 worlds on the CPU, one step and
    a rollout of 8; the lines it prints, and its trajectory equal to the
    same worlds unsharded."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = multichip_scaling.main(2, device="cpu", n_steps=8)
    lines = out.getvalue().splitlines()
    assert lines[0] == "devices: 2 x cpu"
    assert lines[1] == "qpos sharding: ['(4, 73) on cpu', '(4, 73) on cpu']"
    assert lines[-2] == ("stepped 8 worlds over 2 devices; joint angles (8, 66), trajectory "
                         "leaf (8, 8, 73)")
    assert lines[-1] == "OK"
    sim = r["sim"]
    ref = BatchSimulation(sim.compiled, 8, device="cpu")
    ref.set_leg_adhesion_states("fly", np.ones((8, 6), np.float32))
    ref.step()
    assert torch.equal(ref.rollout(None, 8), r["traj"]) and _same(ref.state, sim.state)


@pytest.mark.cuda
def test_two_shards_on_one_card_equal_unsharded(compiled, golden):
    """2 shards on cuda:0 through K2, from 64 worlds that differ: a K = 1
    step and a K = 8 rollout of the benchmark fly, each shard equal to the
    last bit to an unsharded batch of its own 32 worlds, with one launch
    per shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = make_world_mesh(["cuda:0", "cuda:0"])
    start = _differ(_settled(golden, 64), compiled.model).to("cuda")
    sharded = BatchSimulation(compiled, 64, mesh=mesh)
    sharded.state = start
    refs = []
    for block in shard_world_axis(start, mesh):
        refs.append(BatchSimulation(compiled, 32))
        refs[-1].state = block.map(torch.clone)
    launches = []
    for sims in ([sharded], refs):
        ms.reset_launches()
        for sim in sims:
            assert sim.megastep
            sim.step()
            sim.rollout(None, 16)
        torch.cuda.synchronize()
        launches.append(ms.launches["megastep"])
    assert launches == [6, 6]
    assert all(_same(s, r.state) for s, r in zip(sharded.shards, refs))
