"""IO: checkpoints and VTK output."""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .vtk import write_vtk  # noqa: F401
