"""Run a tutorial notebook's code cells in order, in one namespace, without
Jupyter.

A notebook of ``tutorials/torch/`` tags two of its code cells: ``setup``
(``DEVICE = "cuda"``) and ``sizes`` (the notebook's own sizes for the card).
Either can be replaced on request, e.g. to run a notebook on the CPU at small
sizes. Markdown cells are skipped; nothing is caught, so a failing cell
fails the run.

Run one notebook on the card at its own sizes::

    python3 scripts/run_tutorial.py tutorials/torch/3_gpu_accelerated_simulation.ipynb

or on the CPU, smaller::

    python3 scripts/run_tutorial.py tutorials/torch/3_gpu_accelerated_simulation.ipynb \\
        --setup 'DEVICE = "cpu"' --sizes 'n_worlds = 4; n_steps = 20'

As a module: ``run_tutorial(path, setup=..., sizes=...)`` returns the
namespace the cells ran in (``outputs=`` collects what each cell shows);
``code_cells(path)`` returns ``(tags, source)`` per code cell and
``run_cell(source, namespace)`` runs one.
"""

import argparse
import ast
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

__all__ = ["code_cells", "run_cell", "run_tutorial"]


def code_cells(path) -> list:
    """``(tags, source)`` of each code cell of the notebook at ``path``, in
    order; ``tags`` is a tuple of the cell's metadata tags."""
    nb = json.loads(Path(path).read_text())
    out = []
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        src = cell["source"]
        out.append((tuple(cell.get("metadata", {}).get("tags", ())),
                    "".join(src) if isinstance(src, list) else src))
    return out


def run_cell(src: str, ns: dict, name: str = "<cell>"):
    """Execute one cell's source in ``ns`` and return the value of its last
    statement where that is an expression (what a notebook shows), else
    None."""
    tree = ast.parse(src)
    last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
    exec(compile(tree, name, "exec"), ns)
    if last is None:
        return None
    return eval(compile(ast.Expression(last.value), name, "eval"), ns)


def run_tutorial(path, *, setup: str | None = None, sizes: str | None = None,
                 outputs: dict | None = None, verbose: bool = False) -> dict:
    """Run the code cells of the notebook at ``path`` in order in one fresh
    namespace and return it.

    Args:
        setup: Source that replaces the cell tagged ``setup``, or None.
        sizes: Source that replaces the cell tagged ``sizes``, or None.
        outputs: A dict that receives, by code-cell index, the repr of the
            value each cell shows (its last expression's, taken when the
            cell ran), where it is not None.
        verbose: Print each cell's index and seconds after it ran.
    """
    ns = {"__name__": "__tutorial__"}
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    for i, (tags, src) in enumerate(code_cells(path)):
        if "setup" in tags and setup is not None:
            src = setup
        if "sizes" in tags and sizes is not None:
            src = sizes
        start = time.perf_counter()
        value = run_cell(src, ns, f"{Path(path).name}[cell {i}]")
        if outputs is not None and value is not None:
            outputs[i] = repr(value)
        if verbose:
            print(f"[run_tutorial] {Path(path).name} cell {i}: "
                  f"{time.perf_counter() - start:.2f} s", flush=True)
    return ns


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("notebook")
    parser.add_argument("--setup", default=None, help="source replacing the setup cell")
    parser.add_argument("--sizes", default=None, help="source replacing the sizes cell")
    args = parser.parse_args(argv)
    start = time.perf_counter()
    run_tutorial(args.notebook, setup=args.setup, sizes=args.sizes, verbose=True)
    print(f"[run_tutorial] {args.notebook}: {time.perf_counter() - start:.2f} s")


if __name__ == "__main__":
    main()
