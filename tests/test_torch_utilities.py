"""The port's last utilities against the JAX package's: the physics-options
files (``utils/config.py``), the flygym 1.x body names (``utils/api1to2.py``)
and ``find_font`` (``utils/plot.py``), on the same inputs."""

import json

import pytest

from flygym_tpu.compose.spec import ModelSpec as JaxModelSpec
from flygym_tpu.utils import api1to2 as jax_api1to2
from flygym_tpu.utils import config as jax_config
from flygym_tpu.utils import plot as jax_plot

from flygym_tpu_torch.compose.spec import ModelSpec
from flygym_tpu_torch.utils import api1to2, config, plot

# tests/core/test_multifly.py:289-295's document, and the same as JSON.
YAML_DOC = ("option:\n"
            "  timestep: 2e-4\n"
            "  gravity: [0, 0, -9000]\n"
            "solver_iterations: 5\n"
            "custom_flag: 7\n")
JSON_DOC = {"option": {"timestep": 2e-4, "gravity": [0, 0, -9000]}, "solver_iterations": 5,
            "custom_flag": 7, "integrator": "implicitfast", "solver_exact": 1}


@pytest.mark.parametrize("kind", ["yaml", "json", "dict"])
def test_apply_physics_options_as_jax(kind, tmp_path):
    """The same document, as a YAML file, a JSON file and a dict, onto a
    fresh spec of each package: the applied options and the spec's options
    equal JAX's, with test_multifly's values."""
    if kind == "yaml":
        doc = tmp_path / "globals.yaml"
        doc.write_text(YAML_DOC)
    elif kind == "json":
        doc = tmp_path / "globals.json"
        doc.write_text(json.dumps(JSON_DOC))
    else:
        doc = json.loads(json.dumps(JSON_DOC))
    spec, jax_spec = ModelSpec("cfg"), JaxModelSpec("cfg")
    applied = config.apply_physics_options(spec, doc)
    want = jax_config.apply_physics_options(jax_spec, doc)
    assert applied == want and spec.options == jax_spec.options
    assert spec.options["timestep"] == 2e-4
    assert spec.options["gravity"] == (0, 0, -9000)
    assert spec.options["solver_iterations"] == 5
    assert spec.options["extra"]["custom_flag"] == 7
    assert "timestep" in applied
    assert config.DEFAULT_PHYSICS_OPTIONS == jax_config.DEFAULT_PHYSICS_OPTIONS


def test_api1to2_lookups_as_jax():
    """Both tables and both lookups equal JAX's, and an unknown name raises."""
    assert api1to2.BODY_NAMES_OLD2NEW == jax_api1to2.BODY_NAMES_OLD2NEW
    assert api1to2.BODY_NAMES_NEW2OLD == jax_api1to2.BODY_NAMES_NEW2OLD
    assert api1to2.get_body_name_old2new_lookup() == jax_api1to2.get_body_name_old2new_lookup()
    assert api1to2.get_body_name_new2old_lookup() == jax_api1to2.get_body_name_new2old_lookup()
    assert api1to2.BODY_NAMES_OLD2NEW["LFFemur"] == "lf_trochanterfemur"
    assert api1to2.BODY_NAMES_OLD2NEW["A1A2"] == "c_abdomen12"
    with pytest.raises(ValueError, match="Unknown legacy body name"):
        api1to2._old2new("LFWing")


@pytest.mark.parametrize("preferred", ["DejaVuSans", "no-such-font"])
def test_find_font_as_jax(preferred, tmp_path, monkeypatch):
    """On a tree of fonts (and on the machine's own font directories),
    ``find_font`` picks JAX's font: the preferred family, else the first."""
    fonts = tmp_path / "fonts" / "truetype"
    fonts.mkdir(parents=True)
    for name in ("Other-Regular.ttf", "DejaVuSans-Bold.ttf"):
        (fonts / name).write_bytes(b"")
    assert plot.find_font(preferred) == jax_plot.find_font(preferred)
    monkeypatch.setattr(plot, "_FONT_DIRS", [tmp_path / "fonts"])
    monkeypatch.setattr(jax_plot, "_FONT_DIRS", [tmp_path / "fonts"])
    got = plot.find_font(preferred)
    assert got == jax_plot.find_font(preferred) and got is not None
    if preferred == "DejaVuSans":
        assert got.endswith("DejaVuSans-Bold.ttf")
    monkeypatch.setattr(plot, "_FONT_DIRS", [tmp_path / "none"])
    assert plot.find_font(preferred) is None
