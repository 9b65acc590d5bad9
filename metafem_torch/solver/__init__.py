"""Solver stack of the port: domain frontend, local/global assembly, time
integration."""

from .domain import FEM_Domain  # noqa: F401
