"""Shared compile/export interface for composition elements.

Port of ``flygym_tpu/compose/base.py``. Parity reference: flygym
``compose/base.py:11-35`` (compile → (MjModel, MjData) via
``mjcf.Physics.from_mjcf_model``; ``save_xml_with_assets``). Here compile
returns the port's analog, ``(PhysicsModel, State)``, on the CPU.
"""

from abc import ABC, abstractmethod
from os import PathLike
from pathlib import Path

__all__ = ["BaseCompositionElement"]


class BaseCompositionElement(ABC):
    """Base class for anything that owns a :class:`ModelSpec` and can be
    compiled."""

    @property
    @abstractmethod
    def spec(self):
        """The underlying :class:`~flygym_tpu_torch.compose.spec.ModelSpec`."""

    def compile(self):
        """Compile to ``(PhysicsModel, State)`` on the CPU, the state one
        world (B = 1).

        The full compile (:class:`~flygym_tpu_torch.compose.bridge.CompiledModel`
        with its name maps) is cached on ``self.compiled``.
        """
        self.compiled = self.spec.compile()
        return self.compiled.model, self.compiled.initial_state

    def save_xml_with_assets(self, path: PathLike) -> None:
        """Export the compiled model as a standalone MJCF XML file.

        Unlike the reference (which exports mesh assets alongside), the
        compiled model is fully self-contained: primitive geoms + explicit
        inertial elements.
        """
        Path(path).write_text(self.spec.to_mjcf_xml())
