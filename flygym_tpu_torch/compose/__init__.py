"""Model composition: build flies and worlds and compile them, or load a
compiled world exported from the JAX package.

Port of ``flygym_tpu/compose/__init__.py``. The composition classes are
imported lazily, as there, so that the bridge and the data layers load
without the whole composition stack.
"""

from flygym_tpu_torch.compose.bridge import CompiledModel, load_compiled, model_from_numpy

_LAZY = {
    "Fly": "flygym_tpu_torch.compose.fly",
    "ActuatorType": "flygym_tpu_torch.compose.fly",
    "MeshType": "flygym_tpu_torch.compose.fly",
    "GeomFittingOption": "flygym_tpu_torch.compose.fly",
    "BaseWorld": "flygym_tpu_torch.compose.world",
    "FlatGroundWorld": "flygym_tpu_torch.compose.world",
    "TetheredWorld": "flygym_tpu_torch.compose.world",
    "HeightfieldTerrainWorld": "flygym_tpu_torch.compose.world",
    "BlocksTerrainWorld": "flygym_tpu_torch.compose.world",
    "GappedTerrainWorld": "flygym_tpu_torch.compose.world",
    "KinematicPose": "flygym_tpu_torch.compose.pose",
    "KinematicPosePreset": "flygym_tpu_torch.compose.pose",
    "ContactParams": "flygym_tpu_torch.compose.physics",
    "BaseCompositionElement": "flygym_tpu_torch.compose.base",
    "ModelSpec": "flygym_tpu_torch.compose.spec",
}

__all__ = ["CompiledModel", "load_compiled", "model_from_numpy", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'flygym_tpu_torch.compose' has no attribute {name!r}")
