"""Variable attribute registry.

The reference keeps a process-global ``VARIABLE_ATTRIBUTES`` dict
(symbolics/01_Types.jl:1) plus a global ``DEFINITION_TABLE``; module globals
break multi-domain use and jit caching, so here the registry is an explicit
object owned by each :class:`~metafem.solver.domain.FEM_Domain`.

Attribute vocabulary mirrors the reference exactly
(symbolics/01_Types.jl:27-33):

* ``INTERNAL_VAR``   -- a DOF field (allocated in the global x)
* ``EXTERNAL_VAR``   -- known data (never differentiated into K)
* ``CONTROLPOINT_VAR`` -- one value per control point (interpolated)
* ``GLOBAL_VAR``     -- a scalar (time, dt, material constants)
* ``INTEGRATION_POINT_VAR`` -- evaluated at quadrature points via a definition
* ``SYMMETRIC_TENSOR`` -- rank-2 component ids auto-sorted (Voigt storage)
"""

from __future__ import annotations

from typing import Dict, Tuple

INTERNAL_VAR = "INTERNAL_VAR"
EXTERNAL_VAR = "EXTERNAL_VAR"
CONTROLPOINT_VAR = "CONTROLPOINT_VAR"
GLOBAL_VAR = "GLOBAL_VAR"
INTEGRATION_POINT_VAR = "INTEGRATION_POINT_VAR"
SYMMETRIC_TENSOR = "SYMMETRIC_TENSOR"

_VALID = {
    INTERNAL_VAR,
    EXTERNAL_VAR,
    CONTROLPOINT_VAR,
    GLOBAL_VAR,
    INTEGRATION_POINT_VAR,
    SYMMETRIC_TENSOR,
}


class VariableRegistry:
    """Maps a variable name to its attribute set.

    Pre-declares the built-ins the reference installs in
    ``initialize_Definitions!`` (symbolics/01_Types.jl:126-133):
    coordinates x, y, z (control-point external vars), t and dt (global),
    the facet normal n (integration-point var), the Kronecker delta
    (symmetric) and the Levi-Civita symbol.
    """

    def __init__(self) -> None:
        self._attrs: Dict[str, Tuple[str, ...]] = {}
        for c in ("x", "y", "z"):
            self.declare(c, EXTERNAL_VAR, CONTROLPOINT_VAR)
        self.declare("t", EXTERNAL_VAR, GLOBAL_VAR)
        self.declare("dt", EXTERNAL_VAR, GLOBAL_VAR)
        self.declare("n", EXTERNAL_VAR, INTEGRATION_POINT_VAR)
        self.declare("delta", EXTERNAL_VAR, SYMMETRIC_TENSOR)
        self.declare("eps3", EXTERNAL_VAR)  # Levi-Civita

    def declare(self, name: str, *attrs: str) -> None:
        for a in attrs:
            if a not in _VALID:
                raise ValueError(f"unknown variable attribute {a!r}")
        self._attrs[name] = tuple(attrs)

    def attributes(self, name: str) -> Tuple[str, ...]:
        return self._attrs.get(name, ())

    def is_declared(self, name: str) -> bool:
        return name in self._attrs

    def is_internal(self, name: str) -> bool:
        return INTERNAL_VAR in self.attributes(name)

    def is_external(self, name: str) -> bool:
        return EXTERNAL_VAR in self.attributes(name)

    def is_symmetric(self, name: str) -> bool:
        return SYMMETRIC_TENSOR in self.attributes(name)

    def add_attribute(self, name: str, attr: str) -> None:
        if attr not in _VALID:
            raise ValueError(f"unknown variable attribute {attr!r}")
        cur = self._attrs.get(name, ())
        if attr not in cur:
            self._attrs[name] = cur + (attr,)

    def internal_names(self):
        return [k for k, v in self._attrs.items() if INTERNAL_VAR in v]
