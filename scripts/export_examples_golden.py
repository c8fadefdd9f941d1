"""Export what examples 01, 02 and 03 of the JAX package print, for the port.

Runs ``examples/01_build_a_fly.py`` (as it is),
``examples/02_replay_recorded_walking.py`` (``n_steps=100,
settle_steps=100, render=False``) and ``examples/03_batched_simulation.py``
(``n_worlds=8, n_steps=50``: the reduced sizes of
``tests/examples/test_examples_smoke.py``) on the CPU, and writes
``flygym_tpu_torch/assets/examples_basic_golden.npz``:

- ``ex01.stdout``, ``ex01.mjcf`` (the MJCF string the example exports; the
  export is captured here instead of written to its path), ``ex01.mass``
  (the bodies' summed mass it prints, unrounded) and ``ex01.found`` (the
  legs' contact flags after its settle);
- ``ex02.stdout``, ``ex02.start`` and ``ex02.end`` (the root's xyz before
  and after the replay, unrounded);
- ``ex03.stdout`` (its world-steps/s are this machine's) and ``ex03.qpos``
  (the final (8, nq) qpos of its simulation).

Each simulation the examples build is recorded by wrapping the JAX
package's ``Simulation`` and ``BatchSimulation`` for the run.
``tests/test_torch_examples_basic.py`` holds the port's examples
(``flygym_tpu_torch/demo/build_a_fly.py``, ``replay_recorded_walking.py``,
``batched_simulation.py``) to these numbers.

Run from the repository root (a few minutes on one CPU core, most of it
XLA's compiles of the rollouts)::

    JAX_PLATFORMS=cpu python scripts/export_examples_golden.py
"""

import contextlib
import importlib.util
import io
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import flygym_tpu  # noqa: E402
import flygym_tpu.batch  # noqa: E402
from flygym_tpu.compose.base import BaseCompositionElement  # noqa: E402

OUT = REPO / "flygym_tpu_torch" / "assets" / "examples_basic_golden.npz"
SIMS = []


def _recording(cls):
    class Recording(cls):
        """The class, each instance kept in SIMS with its qpos before each
        rollout (``qpos_before``)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.qpos_before = []
            SIMS.append(self)

        def rollout(self, *args, **kwargs):
            self.qpos_before.append(np.asarray(self.state.qpos))
            return super().rollout(*args, **kwargs)

    return Recording


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name: str, **kwargs) -> str:
    SIMS.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(name).main(**kwargs)
    print(out.getvalue(), end="", file=sys.stderr)
    return out.getvalue()


def main() -> None:
    flygym_tpu.Simulation = _recording(flygym_tpu.Simulation)
    flygym_tpu.BatchSimulation = flygym_tpu.batch.BatchSimulation = _recording(
        flygym_tpu.batch.BatchSimulation)
    mjcf = []
    BaseCompositionElement.save_xml_with_assets = lambda self, path: mjcf.append(
        self.spec.to_mjcf_xml())
    golden = {}

    stdout = _run("01_build_a_fly")
    (sim,) = SIMS
    found = np.asarray(sim.get_ground_contact_info("fly0")[0])
    golden.update({"ex01.stdout": stdout, "ex01.mjcf": mjcf[0],
                   "ex01.mass": float(np.asarray(sim.model.body_mass).sum()) * 1e3,
                   "ex01.found": found})

    stdout = _run("02_replay_recorded_walking", n_steps=100, settle_steps=100, render=False)
    (sim,) = SIMS
    golden.update({"ex02.stdout": stdout, "ex02.start": sim.qpos_before[1][0, :3],
                   "ex02.end": np.asarray(sim.state.qpos)[0, :3]})

    stdout = _run("03_batched_simulation", n_worlds=8, n_steps=50)
    (sim,) = SIMS
    golden.update({"ex03.stdout": stdout, "ex03.qpos": np.asarray(sim.state.qpos)})
    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in golden.items()})
    print(f"wrote {OUT}", file=sys.stderr)


if __name__ == "__main__":
    main()
