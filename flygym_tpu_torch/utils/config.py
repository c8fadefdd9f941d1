"""Physics-options configuration files.

Port of ``flygym_tpu/utils/config.py`` (parity reference: flygym
``utils/mjcf.py:10-43``, ``set_mujoco_globals``): a YAML or JSON document
of physics globals (timestep, gravity, solver settings) applied onto a
:class:`~flygym_tpu_torch.compose.spec.ModelSpec`'s options, with the
keys it does not know kept for downstream consumers. PyYAML is imported
only when a ``.yaml`` file is read, so that the port runs without it.
"""

import json
from os import PathLike
from pathlib import Path

__all__ = ["apply_physics_options", "DEFAULT_PHYSICS_OPTIONS"]

# The compiled defaults mirror the reference's mujoco_globals.yaml:
# timestep 1e-4 s, gravity (0, 0, -9810) mm/s^2.
DEFAULT_PHYSICS_OPTIONS = {
    "timestep": 1e-4,
    "gravity": (0.0, 0.0, -9810.0),
    "solver": "newton",
    "solver_iterations": 3,
}

_KNOWN = {
    "timestep": float,
    "gravity": tuple,
    "solver": str,
    "solver_iterations": int,
    "solver_exact": bool,
    "differentiable": bool,
    "solver_relaxation": float,
    "ncon_max": int,
}


def _yaml():
    """PyYAML, which only a ``.yaml`` options file needs."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading a .yaml options file needs PyYAML (the package 'pyyaml'), which is "
            "not installed; pass the options as a .json file or a dict instead"
        ) from e
    return yaml


def apply_physics_options(spec, config: "PathLike | dict") -> dict:
    """Apply a physics-options document to a ModelSpec.

    Accepts a YAML or JSON path or a dict. Known keys update
    ``spec.options`` (cast to their types); an ``option`` sub-document
    (mujoco_globals' layout) is flattened first; other keys are kept under
    ``spec.options['extra']``; ``integrator`` is dropped (the step is always
    semi-implicit Euler).

    Returns the dict of applied options.
    """
    if not isinstance(config, dict):
        path = Path(config)
        with open(path) as f:
            config = json.load(f) if path.suffix == ".json" else _yaml().safe_load(f)

    flat = dict(config)
    # mujoco_globals-style nesting: hoist the "option" block.
    option_block = flat.pop("option", None)
    if isinstance(option_block, dict):
        for key, value in option_block.items():
            flat.setdefault(key, value)

    applied = {}
    extra = {}
    for key, value in flat.items():
        if key in _KNOWN:
            caster = _KNOWN[key]
            value = caster(value) if caster is not tuple else tuple(value)
            spec.options[key] = value
            applied[key] = value
        elif key == "integrator":
            continue
        else:
            extra[key] = value
    if extra:
        spec.options.setdefault("extra", {}).update(extra)
    return applied
