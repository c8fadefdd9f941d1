"""No run imports JAX or the JAX package, and the reference imports
nothing of the port: module names compared whole, by their top-level part
(``flygym_tpu_torch`` is not ``flygym_tpu``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN, forbidden_modules
from portbench.registry import PACKAGE, ROOT


def test_whole_name_compare():
    assert forbidden_modules({"flygym_tpu_torch": 1, "flygym_tpu_torch.ops": 1}) == []
    assert forbidden_modules({"flygym_tpu.ops.megastep": 1}) == ["flygym_tpu"]
    assert forbidden_modules({"jaxlib.xla_client": 1, "jax": 1, "jaxtyping": 1}) == ["jax",
                                                                                    "jaxlib"]
    assert forbidden_modules({"flax.linen": 1, "flaxen": 1}) == ["flax"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_sources_import_no_jax(path):
    assert not _imports(path) & set(FORBIDDEN)
    if "reference" in path.parts:
        assert "flygym_tpu_torch" not in _imports(path)


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port_or_jax():
    loaded = _modules_after("import portbench.reference.env, portbench.reference.runner, "
                            "portbench.counts")
    assert "flygym_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)


def test_a_run_loads_no_jax():
    loaded = _modules_after(
        "import portbench.run, portbench.harness, portbench.control\n"
        "from portbench.registry import Benchmark\n"
        "b = Benchmark()\n"
        "for m in b.spec['per_layer']: b.reader(m['name'])\n"
        "for c in b.spec['workloads']: b.driver(b.traffic(c['traffic'])['driver'])\n"
        "import flygym_tpu_torch.env.gym, flygym_tpu_torch.batch, flygym_tpu_torch.demo.benchmark")
    assert "flygym_tpu_torch" in loaded and not loaded & set(FORBIDDEN)
