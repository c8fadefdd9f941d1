"""What ``BENCHMARK.json`` names, found by name in files of their own.

- a cell (``workloads``) names a configuration and a traffic mix;
- a configuration ``<name>`` is ``configs/<name>.json`` with its input
  files beside it (the entry's ``file``);
- a traffic mix ``<traffic>`` is ``traffic/<traffic>.json``, a data file of
  parameters whose ``driver`` names the general generator that reads it,
  ``traffic/<driver>.py``;
- a per-layer metric ``<name>`` is ``metrics/<name>.py``, a reader with
  ``read(reading) -> float | None``.

A later configuration, mix, traffic driver or metric is added as new files and new
entries; nothing here changes.
"""

import importlib.util
import json
from pathlib import Path

__all__ = ["Benchmark", "ROOT", "PACKAGE"]

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT, package: Path = PACKAGE):
        self.root, self.package = Path(root), Path(package)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's JSON, with ``dir``: the folder its input
        files are named from."""
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        path = self.root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["dir"] = str(path.parent)
        return cfg

    def traffic(self, name: str) -> dict:
        return json.loads((self.package / "traffic" / f"{name}.json").read_text())

    def driver(self, name: str):
        """The traffic driver ``traffic/<name>.py``, loaded by path."""
        return _load(self.package / "traffic" / f"{name}.py", f"_portbench_driver_{name}")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.spec["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The metric's reader module, loaded by path (a metric's name may
        hold dots)."""
        return _load(self.package / "metrics" / f"{metric}.py", f"_portbench_metric_{metric}")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
