"""The fused mass-matrix stages against the JAX package's jitted ones, on
the CPU, on every committed world.

The JAX compile takes the neutral pose's mass matrix inside
``jax.jit(compute_candidate_invweight)``; XLA's CPU backend contracts its
products into fused multiply-adds and sums its dots in orders of its own.
``body_spatial_inertias(..., fused=True)`` and ``crba(..., fused=True)``
repeat that. Each stage is fed the JAX program's own input for it and held
with ``torch.equal`` to what the jitted program makes of it:

- the principal axes' quaternion (``quat_mul_fma``), against
  ``quat_mul`` jitted alone;
- from the jitted program's ``R`` on, every stage that program keeps in
  memory: the skew of the com, the spatial inertias, the subtree product, F,
  S Fᵀ and M.

Two stages still part, so the compile's two Cholesky fields keep their
route (``ROADMAP.md`` queue 3 item 7): the forward kinematics (its
``quat_mul`` of the third ancestor jump, in 2 entries per fly) and
``quat_to_mat`` (LLVM reorders each entry's products before it contracts
them). Neither is held here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flygym_tpu.engine import dynamics as j_dynamics
from flygym_tpu.engine import kinematics as j_kinematics
from flygym_tpu.engine import maths as j_maths
from flygym_tpu.engine.model import PhysicsModel as JaxPhysicsModel
from flygym_tpu_torch.compose.bridge import ASSETS, _read_npz, physics_model
from flygym_tpu_torch.demo.worlds import WORLDS
from flygym_tpu_torch.engine import dynamics, maths

torch.set_num_threads(1)


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _models(name: str):
    """The JAX package's and the port's :class:`PhysicsModel` of the
    committed world ``name``."""
    arrays, meta = _read_npz(ASSETS / f"{name}.npz")
    static = meta["model"]
    kw = {}
    for f in dataclasses.fields(JaxPhysicsModel):
        if f.metadata.get("static"):
            if f.name in static:
                kw[f.name] = _tuples(static[f.name])
        else:
            kw[f.name] = jnp.asarray(arrays[f"model.{f.name}"])
    return JaxPhysicsModel(**kw), physics_model(arrays, static)


def _jax_mass_matrix(m, xpos, xquat, hinge_xaxis):
    """``dynamics.crba`` at the given poses as the JAX compile jits it, with
    the stages XLA keeps in memory anyway (the dots' operands and results)
    returned beside M; returning them leaves M's rounding as it is."""
    ref = xpos[m.ref_body]
    S = j_kinematics.dof_subspace(m, xpos, hinge_xaxis, ref)
    R = j_maths.quat_to_mat(j_maths.quat_mul(xquat, m.body_iquat))
    com = xpos + j_maths.quat_rotate(xquat, m.body_ipos)
    c = j_maths.skew(com - ref)
    I_body = j_dynamics.body_spatial_inertias(m, xpos, xquat, ref)
    nb = m.nbody
    I_comp = (m.body_subtree_mask @ I_body.reshape(nb, 36)).reshape(nb, 6, 6)
    F = jnp.einsum("dij,dj->di", I_comp[m.dof_body], S)
    return dict(M=j_dynamics.crba(m, I_body, S), S=S, R=R, com=com, c=c,
                I_body=I_body, I_comp=I_comp, F=F, SF=S @ F.T)


def _mass_matrix_only(m, xpos, xquat, hinge_xaxis):
    ref = xpos[m.ref_body]
    S = j_kinematics.dof_subspace(m, xpos, hinge_xaxis, ref)
    return j_dynamics.crba(m, j_dynamics.body_spatial_inertias(m, xpos, xquat, ref), S)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))[None]


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_fused_stages_equal_jax(name):
    jm, model = _models(name)
    poses = jax.jit(lambda m: j_kinematics.kinematics_full(m, m.qpos0))(jm)
    want = {k: _t(v) for k, v in jax.jit(_jax_mass_matrix)(jm, *poses).items()}
    # Returning the stages did not move M off the program that returns M alone.
    assert torch.equal(want["M"], _t(jax.jit(_mass_matrix_only)(jm, *poses)))

    xpos, xquat, _hinge_xaxis = (_t(p) for p in poses)
    ref = xpos[:, model.ref_body]
    iquat = jax.jit(j_maths.quat_mul)(poses[1], jm.body_iquat)
    assert torch.equal(maths.quat_mul_fma(xquat, model.body_iquat), _t(iquat))
    com = xpos + maths.quat_rotate_fma(xquat, model.body_ipos)
    assert torch.equal(maths.skew(com - ref[:, None]), want["c"])

    I_body = dynamics.spatial_inertia_fused(model, want["R"], com, ref)
    assert torch.equal(I_body, want["I_body"])
    B, nb = 1, model.nbody
    mask = model.body_subtree_mask.expand(B, nb, nb)
    lanes = 4 if nb >= 64 else 1
    I_comp = maths.matmul_fma(mask, want["I_body"].reshape(B, nb, 36), lanes=lanes)
    assert torch.equal(I_comp.reshape(B, nb, 6, 6), want["I_comp"])
    S = want["S"]
    F = maths.matmul_fma(want["I_comp"][:, model.dof_body], S[..., None])[..., 0]
    assert torch.equal(F, want["F"])
    SF = maths.matmul_fma(S, want["F"].transpose(-1, -2), lanes=2 if model.nv > 64 else 1)
    assert torch.equal(SF, want["SF"])
    assert torch.equal(dynamics.crba(model, want["I_body"], S, fused=True), want["M"])


@pytest.mark.parametrize("shape, lanes", [
    ((3, 3, 3), 1), ((42, 6, 42), 1), ((72, 6, 72), 2), ((70, 70, 36), 4), ((72, 12, 72), 4)])
def test_matmul_fma_sums_as_xla_dot(shape, lanes):
    """:func:`maths.matmul_fma`'s orders on random operands, against a jitted
    ``jnp`` product of the same shape: one chain at k = 3 and at 42 × 6 × 42,
    two lanes at 72 × 6 × 72, four lanes at k = 12; at k = 70 with a 0/1
    left operand, as the subtree mask is (XLA's order for other operands
    there is not the model's)."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    if k == 70:
        a = (a > 0.5).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = maths.matmul_fma(torch.from_numpy(a), torch.from_numpy(b), lanes=lanes)
    assert torch.equal(got, torch.from_numpy(np.asarray(jax.jit(jnp.matmul)(a, b))))


def test_unfused_route_is_the_step_route():
    """The step's stages stay torch's own: ``fused=False`` is the default,
    and the fused stages part from it (so the default was not switched)."""
    _jm, model = _models("benchmark_fly")
    from flygym_tpu_torch.engine.kinematics import dof_subspace, kinematics_full

    xpos, xquat, hx = kinematics_full(model, model.qpos0[None])
    ref = xpos[:, model.ref_body]
    S = dof_subspace(model, xpos, hx, ref)
    plain = dynamics.crba(model, dynamics.body_spatial_inertias(model, xpos, xquat, ref), S)
    fused = dynamics.crba(
        model, dynamics.body_spatial_inertias(model, xpos, xquat, ref, fused=True), S,
        fused=True)
    assert not torch.equal(plain, fused)
    torch.testing.assert_close(plain, fused, rtol=1e-5, atol=1e-9)
