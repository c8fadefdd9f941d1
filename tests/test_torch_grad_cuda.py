"""The gradient path's kernels on the card (``-m cuda``; skipped without
one). No JAX here: the card's machine has none.

K1 and K1b outside the autograd Function, K2 and K3 raise on an input that
requires grad (their outputs would carry no graph); through the Function
(``ops/ldl.py:tree_ldl_solve_grad``) the factor of ``H.detach()`` and the
solve run, its backward launches K1b once more, and its gradients agree
with autograd through the plain versions on the card.
"""

import dataclasses

import pytest
import torch

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import BENCHMARK_FLY, ENV_FLY, load_golden
from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.ops import ldl

# Kernels against the plain versions on the card, relative to the largest
# |g|: the same sums in other orders (the plain padded scatters accumulate
# in an order that changes from run to run on CUDA).
CARD_BAR = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_cuda_kernels_refuse_an_input_that_requires_grad(cuda_device):
    """K1 and K1b outside the Function, K2 and K3 raise where an input
    requires grad; through the Function, the factor of H.detach() and the
    solve run, and the backward makes one more K1b launch."""
    from flygym_tpu_torch.ops.megastep import make_megastep

    model = load_compiled(BENCHMARK_FLY).model.to(cuda_device)
    H, b = ldl.sample_problems(model, 8)
    Hg = H.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="would cut the graph"):
        ldl.tree_ldl_factor(model.ldl, Hg)
    L, d = ldl.tree_ldl_factor(model.ldl, Hg.detach())
    with pytest.raises(RuntimeError, match="would cut the graph"):
        ldl.tree_ldl_solve(model.ldl, L, d, b.clone().requires_grad_(True))
    w = torch.randn_like(b)
    ldl.reset_launches()
    (ldl.tree_ldl_solve_grad(model.ldl, Hg, L, d, b) * w).sum().backward()
    assert ldl.launches == {"tree_ldl_factor": 0, "tree_ldl_solve": 1,
                            "tree_ldl_solve_backward": 1}
    Hp = H.clone().requires_grad_(True)
    Lp, dp = linalg.tree_ldl_factor(model.ldl, Hp)
    (linalg.tree_ldl_solve(model.ldl, Lp, dp, b) * w).sum().backward()
    gap = (Hg.grad - Hp.grad).abs().max() / Hp.grad.abs().max()
    assert gap < CARD_BAR, float(gap)
    state = load_golden()["state"].map(lambda t: t[:4].to(cuda_device))
    with pytest.raises(RuntimeError, match="would cut the graph"):
        make_megastep(model, 1)(dataclasses.replace(state, ctrl=state.ctrl.requires_grad_(True)))
    from flygym_tpu_torch.ops import retina as rk
    from flygym_tpu_torch.vision import Retina

    env = load_compiled(ENV_FLY)
    tables = rk.RetinaTables(env.model.to(cuda_device), Retina.for_compiled(env))
    st = env.initial_state.to(cuda_device)
    packed = rk.pack_rows(tables, st.xpos.requires_grad_(True), st.xquat)
    with pytest.raises(RuntimeError, match="would cut the graph"):
        rk.launch_retina(tables, packed)


@pytest.mark.cuda
def test_pose_fit_graph_replays_the_eager_gradient(cuda_device):
    """The pose fit's CUDA graph (``utils/pose_conversion.py:graphed_backward``)
    gives, at each qpos written into the captured tensor, the gradient of
    the eager cost and backward (the backward's scatters sum in an order
    that may change from run to run: CARD_BAR)."""
    from flygym_tpu_torch.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu_torch.compose import KinematicPosePreset
    from flygym_tpu_torch.compose.fly import Fly
    from flygym_tpu_torch.utils import pose_conversion as pc

    pose = KinematicPosePreset.NEUTRAL.get_pose_by_axis_order(AxisOrder.YPR)
    flies = []
    for order in (AxisOrder.YPR, AxisOrder.PRY):
        fly = Fly()
        fly.add_joints(Skeleton(axis_order=order, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=pose)
        flies.append(fly.compile())
    (_m, ref_state), (model, _s) = flies
    model = model.to(cuda_device)
    cost = pc.pose_cost(model, ref_state.xpos[0].numpy(), ref_state.xquat[0].numpy())
    qpos = torch.zeros(model.nq, device=cuda_device, requires_grad=True)
    replay = pc.graphed_backward(cost, qpos)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        q = (torch.rand(model.nq, generator=gen) - 0.5).to(cuda_device)
        with torch.no_grad():
            qpos.copy_(q)
        replay()
        got = qpos.grad.clone()
        x = q.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(cost(x), x)
        assert ((got - want).abs().max() / want.abs().max()).item() < CARD_BAR
