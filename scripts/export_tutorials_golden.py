"""Export what the JAX package's tutorial notebooks show, for the port.

Runs the code cells of ``tutorials/1_composing_models_and_scenes.ipynb``,
``1bis_advanced_model_composition.ipynb``,
``2_replaying_experimental_recordings.ipynb``,
``3_tpu_accelerated_simulation.ipynb`` and ``4_closed_loop_control.ipynb``
on the CPU, in order, one namespace per notebook (``scripts/run_tutorial.py``
reads the cells), and writes ``flygym_tpu_torch/assets/tutorials_golden.npz``.
The notebooks are not edited: their first cell (the JAX platform setup) is
replaced by this script's, and these sizes are swapped in memory:

- tutorial 2 settles 100 steps (``sim.rollout(None, 500)``) and replays 100
  (``n_steps = 2000``);
- tutorial 3 runs 4 worlds (``n_worlds = 32``) for 20 steps
  (``n_steps = 50``);
- tutorial 4 runs its own 4 envs.

The files the notebooks write under ``/tmp`` go to ``outputs/tutorials_golden/``.

Kept, per notebook (``t1.``, ``t1bis.``, ``t2.``, ``t3.``, ``t4.``): what it
prints (``stdout``), the repr of each code cell's last expression where the
notebook shows one (``repr.<cell>``), and the arrays behind its results:

- t1: ``mjcf`` (the exported string), ``found`` (the legs in contact after
  the warmup);
- t1bis: ``options`` (the repr of ``spec.options`` at the end) and the edited
  world's compile (``model.<field>``, ``state.<field>``);
- t2: ``traj`` (the replay's qpos), ``tau``, ``found``, ``force``,
  ``keypoints``;
- t3: ``traj`` (the rollout's qpos), ``angles``;
- t4: ``cpg_phase`` (the CPG's initial phases), ``targets``, ``adhesion``,
  ``intensities``, ``odor``, the env's reset states (``reset.<field>``), and
  after its step ``obs.<key>``, ``reward``, ``done``.

``tests/test_torch_tutorials.py`` runs the port's notebooks
(``tutorials/torch/``) on the CPU at these sizes and holds them to it.

Run from the repository root (a few minutes on one CPU core, most of it
XLA's compiles)::

    JAX_PLATFORMS=cpu python scripts/export_tutorials_golden.py
"""

import contextlib
import dataclasses
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

OUT = REPO / "flygym_tpu_torch" / "assets" / "tutorials_golden.npz"
FILES = REPO / "outputs" / "tutorials_golden"
NOTEBOOKS = {
    "t1": "1_composing_models_and_scenes",
    "t1bis": "1bis_advanced_model_composition",
    "t2": "2_replaying_experimental_recordings",
    "t3": "3_tpu_accelerated_simulation",
    "t4": "4_closed_loop_control",
}
# (old, new) source swaps per notebook; each old string occurs exactly once.
SIZES = {
    "t2": [("sim.rollout(None, 500)", "sim.rollout(None, 100)"),
           ("n_steps = 2000", "n_steps = 100")],
    "t3": [("n_worlds = 32", "n_worlds = 4"), ("n_steps = 50", "n_steps = 20")],
}


def _runner():
    spec = importlib.util.spec_from_file_location("run_tutorial", REPO / "scripts" / "run_tutorial.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_notebook(key: str):
    """Run notebook ``key``'s code cells but the first; return (namespace,
    stdout, {cell index: repr of its last expression})."""
    runner = _runner()
    cells = [src for _tags, src in runner.code_cells(REPO / "tutorials" / f"{NOTEBOOKS[key]}.ipynb")]
    src_all = "\n".join(cells)
    for old, _new in SIZES.get(key, []):
        assert src_all.count(old) == 1, (key, old)
    ns = {"__name__": "__tutorial__"}
    out = io.StringIO()
    reprs = {}
    for i, src in enumerate(cells[1:], start=1):
        src = src.replace("/tmp/", f"{FILES}/")
        for old, new in SIZES.get(key, []):
            src = src.replace(old, new)
        with contextlib.redirect_stdout(out):
            value = runner.run_cell(src, ns, f"{key}[{i}]")
        if value is not None:
            reprs[i] = repr(value)
    print(out.getvalue(), end="", file=sys.stderr)
    return ns, out.getvalue(), reprs


def _np(x):
    return np.asarray(x)


def main() -> None:
    FILES.mkdir(parents=True, exist_ok=True)
    golden = {}

    def keep(key, ns_out):
        _ns, stdout, reprs = ns_out
        golden[f"{key}.stdout"] = stdout
        for i, r in reprs.items():
            golden[f"{key}.repr.{i}"] = r

    run = run_notebook("t1")
    keep("t1", run)
    ns = run[0]
    golden["t1.mjcf"] = (FILES / "fly_world.xml").read_text()
    golden["t1.found"] = _np(ns["found"])

    run = run_notebook("t1bis")
    keep("t1bis", run)
    ns = run[0]
    golden["t1bis.options"] = repr(ns["spec"].options)
    for prefix, obj in (("model", ns["model"]), ("state", ns["state"])):
        for f in dataclasses.fields(obj):
            if not f.metadata.get("static"):
                golden[f"t1bis.{prefix}.{f.name}"] = _np(getattr(obj, f.name))

    run = run_notebook("t2")
    keep("t2", run)
    ns = run[0]
    for name in ("traj", "tau", "found", "force", "keypoints"):
        golden[f"t2.{name}"] = _np(ns[name])

    run = run_notebook("t3")
    keep("t3", run)
    ns = run[0]
    golden["t3.traj"] = _np(ns["traj"])
    golden["t3.angles"] = _np(ns["angles"])

    # The CPG's initial phases, taken before its tick as the notebook draws them.
    from flygym_tpu.control.cpg import CPGState

    golden["t4.cpg_phase"] = _np(CPGState.init(0).phase)
    run = run_notebook("t4")
    keep("t4", run)
    ns = run[0]
    for name in ("targets", "adhesion", "intensities", "odor", "reward", "done"):
        golden[f"t4.{name}"] = _np(ns[name])
    reset = ns["env"].reset_batched(jax.random.PRNGKey(0), n_envs=ns["n_envs"])
    for f in dataclasses.fields(reset):
        golden[f"t4.reset.{f.name}"] = _np(getattr(reset, f.name))
    for k, v in ns["obs"].items():
        golden[f"t4.obs.{k}"] = _np(v)

    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in golden.items()})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)", file=sys.stderr)


if __name__ == "__main__":
    main()
