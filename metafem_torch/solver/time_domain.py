"""Generalized-alpha time integration + Newton helpers.

Port of ``metafem/solver/time_domain.py`` (which mirrors MetaFEM.jl's
solver/04_Time_Domain.jl) for an arbitrary number of time levels (0 =
static, 1 = first-order, 2 = second-order ODEs): the global state x is
stored ``[max_time_level + 1, basicfield_size]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import device_constant


@dataclasses.dataclass
class GeneralAlpha:
    """alpha/gamma parameter sets (04_Time_Domain.jl:1-8); dissipative=True
    selects backward-Euler-like gamma = (1, 1)."""
    alpha_params: Tuple[float, ...] = (1.0, 1.0, 1.0)
    gamma_params: Tuple[float, ...] = (0.5, 0.5)
    beta_params: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1))
    K_params: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1))

    @classmethod
    def dissipative(cls) -> "GeneralAlpha":
        return cls(gamma_params=(1.0, 1.0))

    def update_time(self, dt: float, max_time_level: int) -> None:
        """beta_l = 1 / (prod(gamma[:l]) * dt^l); K_l = alpha_l * beta_l
        (update_Time!, 04_Time_Domain.jl:10-18)."""
        levels = max_time_level + 1
        prod_gamma = np.array(
            [np.prod(self.gamma_params[:i]) for i in range(levels)])
        dt_pow = np.array([dt ** i for i in range(levels)])
        self.beta_params = 1.0 / (prod_gamma * dt_pow)
        self.K_params = (np.asarray(self.alpha_params[:levels])
                         * self.beta_params)


def initialize_dx(x: torch.Tensor, dt: float,
                  gamma_params: Tuple[float, ...]) -> torch.Tensor:
    """Generalized-alpha predictor (initialize_dx!, 04_Time_Domain.jl:20-30):
    dx[l-1] = dt * (x[l] + gamma_l * dx[l]), top level down."""
    levels = x.shape[0]
    dx = torch.zeros_like(x)
    for level in range(levels - 1, 0, -1):
        dx[level - 1] = dt * (x[level] + gamma_params[level - 1] * dx[level])
    return dx


def update_dx(dx: torch.Tensor, delta_x: torch.Tensor,
              beta_params: np.ndarray) -> torch.Tensor:
    """Corrector: dx[l] += beta_l * delta_x (update_dx!, :32-39)."""
    beta = device_constant(beta_params, dx.dtype, dx.device)
    return dx + beta[:, None] * delta_x[None, :].to(dx.dtype)


def x_star_of(x: torch.Tensor, dx: torch.Tensor,
              alpha_params: Tuple[float, ...]) -> torch.Tensor:
    """Stage state: x* = x + alpha o dx (update_x_star!, :41-49)."""
    levels = x.shape[0]
    alpha = device_constant(alpha_params[:levels], x.dtype, x.device)
    return x + alpha[:, None] * dx


def normalized_norm(v: torch.Tensor) -> float:
    return float(torch.linalg.norm(v)) / math.sqrt(v.numel())
