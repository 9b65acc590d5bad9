"""Element library: polynomials, shape functions, quadrature, tables."""

from .polynomial import Polynomial
from .structures import ElementType, make_element_type
from .discretization import (ClassicalDiscretization,
                             initialize_classical_element, sd_mode_list,
                             sd_ids_to_mode)
from . import quadrature
