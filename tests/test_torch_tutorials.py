"""The port's tutorial notebooks (``tutorials/torch/``) against the JAX
package's, on the CPU.

The JAX notebooks ran on the CPU once at reduced sizes, and
``scripts/export_tutorials_golden.py`` kept what they show and the arrays
behind it in ``flygym_tpu_torch/assets/tutorials_golden.npz``. Here each torch
notebook runs through ``scripts/run_tutorial.py`` with its setup cell
replaced by ``DEVICE = "cpu"`` and its sizes cell by the golden's sizes, in
a temporary directory (the notebooks write under ``outputs/tutorials``).
A torch notebook has one code cell more than its JAX counterpart (the sizes
cell, second), so the JAX notebook's code cell i is the port's i + 1.

- Equal: tutorial 1's printed sizes, the reprs of what its joints,
  actuators, adhesion and camera cells show, its MJCF string and the legs in
  contact; tutorial 1bis's printed coxa, its options, ``3025`` and the edited
  world's compile (the two Cholesky fields to the compile test's bars,
  ``ROADMAP.md`` queue 3 item 7); tutorial 4's CPG tick from the JAX
  notebook's initial phases.
- Within ``GOLDEN_TOLERANCE`` (the engine step against the jitted JAX
  engine): tutorial 2's and 3's trajectories and readouts.
- Within ``tests/test_torch_env.py``'s bars: the retina, the odor and the
  env step, taken from the JAX notebook's reset states (the port draws its
  reset noise from a ``torch.Generator``, JAX from a ``PRNGKey``); the
  contact forces, which reach ~150 in this step, with a relative part added.
- Shape and finiteness: the mesh rollout of tutorial 3 and the notebook's
  own env step.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import assets_dir
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.engine.model import State
from test_torch_compile import RELATIVE_BARS, ULP_BARS
from test_torch_env import RATE_ATOL, check_obs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = assets_dir / "tutorials_golden.npz"
NOTEBOOKS = REPO / "tutorials" / "torch"
# The golden's sizes (scripts/export_tutorials_golden.py).
SIZES = {
    "1_composing_models_and_scenes": None,
    "1bis_advanced_model_composition": None,
    "2_replaying_experimental_recordings": "settle_steps = 100\nn_steps = 100",
    "3_gpu_accelerated_simulation": "n_worlds = 4\nn_steps = 20",
    "4_closed_loop_control": "settle_steps = 100\nn_envs = 4",
}


def _runner():
    spec = importlib.util.spec_from_file_location("run_tutorial", REPO / "scripts" / "run_tutorial.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN, allow_pickle=False) as g:
        return {k: g[k] for k in g.files}


def _run(name: str, tmp_path, monkeypatch):
    """Run notebook ``name`` on the CPU at the golden's sizes in
    ``tmp_path``: (namespace, stdout, {code cell: the repr it shows})."""
    monkeypatch.chdir(tmp_path)
    outputs, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        ns = _runner().run_tutorial(NOTEBOOKS / f"{name}.ipynb", setup='DEVICE = "cpu"',
                                    sizes=SIZES[name], outputs=outputs)
    return ns, out.getvalue(), outputs


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_notebooks_are_torch_only_and_committed_without_outputs():
    """Every torch notebook imports neither JAX nor the JAX package, sets
    ``DEVICE = "cuda"`` in its tagged setup cell with no fallback, tags a
    sizes cell second, and carries no outputs."""
    import json

    names = sorted(p.stem for p in NOTEBOOKS.glob("*.ipynb"))
    assert names == sorted(SIZES)
    for name in names:
        cells = _runner().code_cells(NOTEBOOKS / f"{name}.ipynb")
        assert "setup" in cells[0][0] and "sizes" in cells[1][0], name
        assert 'DEVICE = "cuda"' in cells[0][1] and "is_available" not in cells[0][1]
        for _tags, src in cells:
            for word in ("import jax", "from jax", "flygym_tpu.", "import flygym_tpu\n",
                         "JAX_PLATFORMS", "except"):
                assert word not in src, (name, word)
        nb = json.loads((NOTEBOOKS / f"{name}.ipynb").read_text())
        assert all(not c.get("outputs") for c in nb["cells"] if c["cell_type"] == "code")


def test_tutorial_1_equals_the_jax_notebook(golden, tmp_path, monkeypatch):
    ns, stdout, shown = _run("1_composing_models_and_scenes", tmp_path, monkeypatch)
    assert stdout == str(golden["t1.stdout"]) == "70 72 48\n"
    for jax_cell in (2, 3, 4, 5):  # joints, actuators, adhesion, camera
        assert shown[jax_cell + 1] == str(golden[f"t1.repr.{jax_cell}"]), jax_cell
    mjcf = (tmp_path / "outputs" / "tutorials" / "fly_world.xml").read_text()
    assert mjcf == str(golden["t1.mjcf"])
    found = _np(ns["found"])
    assert np.array_equal(found, golden["t1.found"]) and found.all()


def test_tutorial_1bis_equals_the_jax_notebook(golden, tmp_path, monkeypatch):
    ns, stdout, shown = _run("1bis_advanced_model_composition", tmp_path, monkeypatch)
    assert stdout == str(golden["t1bis.stdout"])
    assert shown[6 + 1] == str(golden["t1bis.repr.6"])  # the applied options
    assert shown[8 + 1] == str(golden["t1bis.repr.8"]) == "3025"
    assert repr(ns["spec"].options) == str(golden["t1bis.options"])
    # The edited world's compile (cell 3 of the JAX notebook), field by field.
    for key, want in golden.items():
        if not key.startswith(("t1bis.model.", "t1bis.state.")):
            continue
        kind, field = key.split(".")[1:]
        got = _np(getattr(ns[kind], field))
        got = got[0] if kind == "state" else got
        got = got.astype(want.dtype)
        assert got.shape == want.shape, key
        name = f"{kind}.{field}"
        if name in RELATIVE_BARS:
            rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1e-30)
            assert rel.max() <= RELATIVE_BARS[name], (key, rel.max())
        elif name in ULP_BARS:
            np.testing.assert_array_max_ulp(got, want, maxulp=ULP_BARS[name])
        else:
            assert np.array_equal(got, want), key


def test_tutorial_2_tracks_the_jax_notebook(golden, tmp_path, monkeypatch):
    """The settle and replay at 100 steps each: the trajectory and the
    positions within the qpos bar, the contact flags equal, the actuator
    torques within kp times the qpos bar, the contact forces within the
    qvel bar (a force is a mass times an acceleration of the order of the
    velocity gap over a step)."""
    ns, _stdout, _shown = _run("2_replaying_experimental_recordings", tmp_path, monkeypatch)
    traj = _np(ns["traj"])
    assert traj.shape == golden["t2.traj"].shape == (100, 1, 73)
    assert np.abs(traj - golden["t2.traj"]).max() <= GOLDEN_TOLERANCE["qpos"]
    assert np.abs(_np(ns["tau"]) - golden["t2.tau"]).max() <= 50.0 * GOLDEN_TOLERANCE["qpos"]
    assert np.array_equal(_np(ns["found"]), golden["t2.found"])
    assert np.abs(_np(ns["force"]) - golden["t2.force"]).max() <= GOLDEN_TOLERANCE["qvel"]
    assert _np(ns["keypoints"]).shape == golden["t2.keypoints"].shape
    video = tmp_path / "outputs" / "tutorials"
    assert any(p.stem == "replay" and p.stat().st_size > 0 for p in video.iterdir())


def test_tutorial_3_tracks_the_jax_notebook(golden, tmp_path, monkeypatch):
    """4 worlds for 20 steps: the joint angles equal, the rollout within
    the qpos bar; the mesh rollout (two CPU shards) finite."""
    ns, _stdout, _shown = _run("3_gpu_accelerated_simulation", tmp_path, monkeypatch)
    assert np.array_equal(_np(ns["angles"]), golden["t3.angles"])
    traj = _np(ns["traj"])
    assert traj.shape == golden["t3.traj"].shape == (20, 4, 73)
    assert np.abs(traj - golden["t3.traj"]).max() <= GOLDEN_TOLERANCE["qpos"]
    mesh_traj = _np(ns["traj_mesh"])
    assert mesh_traj.shape == (20, 4, 73) and np.isfinite(mesh_traj).all()
    assert ns["mesh"].size == 2 and len(ns["sim"].shards) == 2


def test_tutorial_4_tracks_the_jax_notebook(golden, tmp_path, monkeypatch):
    from flygym_tpu_torch.control.cpg import CPGState

    ns, _stdout, _shown = _run("4_closed_loop_control", tmp_path, monkeypatch)
    # The CPG tick from the JAX notebook's initial phases, equal.
    zeros = np.zeros((1, 6), np.float32)
    start = CPGState.from_numpy(golden["t4.cpg_phase"][None], zeros, zeros, device="cpu")
    _state, targets, adhesion = ns["cpg"](start, drive=1.0)
    assert np.array_equal(_np(targets)[0], golden["t4.targets"])
    assert np.array_equal(_np(adhesion)[0], golden["t4.adhesion"])
    assert _np(ns["targets"]).shape == (1, 42)
    # Vision and olfaction at the compiled neutral state.
    check_obs("vision", _np(ns["intensities"])[0], golden["t4.intensities"])
    check_obs("odor_intensity", _np(ns["odor"])[0], golden["t4.odor"])
    # The notebook's own env step: the port's reset noise.
    for key, value in ns["obs"].items():
        assert np.isfinite(_np(value)).all(), key
    # The env step from the JAX notebook's reset states.
    reset = State(**{f: torch.as_tensor(golden[f"t4.reset.{f}"]) for f in State.__dataclass_fields__})
    env = ns["env"]
    actions = {"joints": reset.ctrl[:, env._act_ids], "adhesion": torch.ones((4, 6))}
    _states, obs, reward, done, _info = ns["step"](reset, actions,
                                                   torch.Generator().manual_seed(1))
    assert set(obs) == {k[len("t4.obs."):] for k in golden if k.startswith("t4.obs.")}
    for key, value in obs.items():
        if key == "contact_forces":
            # This step lands the noisy reset's legs: forces up to ~150
            # (test_torch_env's golden stays below ~10), so the absolute
            # bar takes a relative part, 1e-4 (measured: 7.7e-3 at 95.7).
            np.testing.assert_allclose(_np(value), golden[f"t4.obs.{key}"], rtol=1e-4,
                                       atol=RATE_ATOL)
        else:
            check_obs(key, _np(value), golden[f"t4.obs.{key}"])
    np.testing.assert_allclose(_np(reward), golden["t4.reward"], atol=1e-6)
    assert np.array_equal(_np(done), golden["t4.done"])
