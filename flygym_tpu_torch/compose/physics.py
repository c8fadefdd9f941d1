"""Contact physics parameters.

Port of ``flygym_tpu/compose/physics.py``. The contact model follows
MuJoCo's soft-constraint formulation (solref / solimp / friction / margin)
so that models tuned for the reference behave the same here. The engine consumes these parameters directly when building its
per-contact stiffness/damping/impedance tables
(see :mod:`flygym_tpu_torch.engine.contact`).

Parity reference: flygym ``compose/physics.py:6-164``.
"""

from dataclasses import dataclass

__all__ = ["ContactParams"]


@dataclass(kw_only=True)
class ContactParams:
    """Friction, solver-reference, and solver-impedance parameters for contacts.

    Solver reference (``solref``) controls how fast constraint violations
    (penetrations) are corrected: a virtual spring-damper with time constant
    ``solver_refaccl_timeconst`` and damping ratio ``solver_refaccl_dampratio``.

    Solver impedance (``solimp``) controls how stiff the constraint is as a
    function of penetration depth, interpolating from ``solver_impedance_min``
    at first touch to ``solver_impedance_max`` at a penetration of
    ``solver_impedance_min2max_width``.

    Defaults are the fly-tuned values of the reference (very stiff contacts at
    dt = 1e-4 s, in the mm/gram unit system).
    """

    # Contact friction coefficients.
    sliding_friction: float = 1.0
    torsional_friction: float = 2e-2
    rolling_friction: float = 1e-4
    # Contact dimensionality: 1 frictionless, 3 sliding (reference default,
    # flygym ``physics.py`` pairs compile at condim 3), 4 + torsional,
    # 6 + rolling.
    condim: int = 3

    # Constraint-correction spring-damper (solref).
    solver_refaccl_timeconst: float = 2e-4
    solver_refaccl_dampratio: float = 1.0

    # Constraint impedance as a function of penetration (solimp).
    solver_impedance_min: float = 0.98
    solver_impedance_max: float = 0.99
    solver_impedance_min2max_width: float = 1e-5
    solver_impedance_transitionmidpoint: float = 0.5
    solver_impedance_transitionsharpness: float = 3.0

    # Contact force starts to act at this distance before touching (mm).
    # Helps prevent tiny leg tips from tunneling through the ground.
    margin: float = 1e-3

    def get_friction_tuple(self) -> tuple[float, float, float, float, float]:
        """5-tuple friction for an explicit contact pair:
        (sliding x2, torsional, rolling x2)."""
        self._raise_on_invalid_friction()
        return (
            self.sliding_friction,
            self.sliding_friction,
            self.torsional_friction,
            self.rolling_friction,
            self.rolling_friction,
        )

    def get_solref_tuple(self) -> tuple[float, float]:
        """(timeconst, dampratio) solver-reference pair."""
        self._raise_on_invalid_solver_refaccl()
        return (self.solver_refaccl_timeconst, self.solver_refaccl_dampratio)

    def get_solimp_tuple(self) -> tuple[float, float, float, float]:
        """(dmin, dmax, midpoint, power) impedance tuple.

        Note: like the reference, the transition width is carried separately
        via :attr:`solver_impedance_min2max_width`.
        """
        self._raise_on_invalid_solver_impedance()
        return (
            self.solver_impedance_min,
            self.solver_impedance_max,
            self.solver_impedance_transitionmidpoint,
            self.solver_impedance_transitionsharpness,
        )

    def get_solimp_full_tuple(self) -> tuple[float, float, float, float, float]:
        """(dmin, dmax, width, midpoint, power) — the full 5-element impedance
        spec consumed by the engine's contact pipeline."""
        self._raise_on_invalid_solver_impedance()
        return (
            self.solver_impedance_min,
            self.solver_impedance_max,
            self.solver_impedance_min2max_width,
            self.solver_impedance_transitionmidpoint,
            self.solver_impedance_transitionsharpness,
        )

    def is_valid(self, raise_on_invalid: bool = True) -> bool:
        """Validate all parameter ranges.

        Args:
            raise_on_invalid: Raise ``ValueError`` instead of returning False.
        """
        try:
            self._raise_on_invalid_friction()
            self._raise_on_invalid_solver_refaccl()
            self._raise_on_invalid_solver_impedance()
            return True
        except ValueError as e:
            if raise_on_invalid:
                raise ValueError(f"Invalid ContactParams: {e}") from e
            return False

    def _raise_on_invalid_friction(self):
        if self.sliding_friction < 0:
            raise ValueError("sliding_friction cannot be negative")
        if self.torsional_friction < 0:
            raise ValueError("torsional_friction cannot be negative")
        if self.rolling_friction < 0:
            raise ValueError("rolling_friction cannot be negative")

    def _raise_on_invalid_solver_refaccl(self):
        if not self.solver_refaccl_timeconst > 0:
            raise ValueError("Solver reference time constant must be positive")
        if not self.solver_refaccl_dampratio > 0:
            raise ValueError("solver_refaccl_dampratio needs to be > 0")

    def _raise_on_invalid_solver_impedance(self):
        if not 0 < self.solver_impedance_min < 1:
            raise ValueError("Minimum solver impedance must be in (0, 1)")
        if not 0 < self.solver_impedance_max < 1:
            raise ValueError("Maximum solver impedance must be in (0, 1)")
        if self.solver_impedance_max < self.solver_impedance_min:
            raise ValueError("Maximum solver impedance cannot be less than minimum")
        if not self.solver_impedance_min2max_width > 0:
            raise ValueError(
                "impedance width: the mid-to-max transition needs a positive distance"
            )
        if not 0 < self.solver_impedance_transitionmidpoint < 1:
            raise ValueError(
                "impedance midpoint has to lie strictly inside (0, 1)"
            )
        if self.solver_impedance_transitionsharpness < 1:
            raise ValueError(
                "impedance sharpness below 1 (sub-linear transitions are "
                "not representable)"
            )
