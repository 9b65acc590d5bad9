"""The port's slice end to end on the CPU against the reference.

The README's thermal Newton step (examples/thermal_2d.py in both
packages) at nel=(20,10) and (40,20): the Newton residual of iteration 0
agrees at rtol 1e-12, both take the same number of Newton iterations,
the final temperatures agree within 1e-6 * max|T| (both steps stop at a
residual below 1e-6; in the reference alone, stopping at 1e-6 instead of
1e-11 moves T by 1.9e-7 * max|T| at (40,20)), and the port stays within
the FEATool bar of tests/test_solver.py (0.01).
"""

import os
import sys

import numpy as np
import pytest
import torch

from metafem_torch.examples import thermal_2d

torch.set_num_threads(2)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "examples"))
import thermal_2d as ref_thermal_2d  # noqa: E402


def _residual_history(monkeypatch, module):
    """Record every Newton residual the domain module computes."""
    seen = []
    orig = module.normalized_norm

    def record(v):
        seen.append(orig(v))
        return seen[-1]
    monkeypatch.setattr(module, "normalized_norm", record)
    return seen


@pytest.mark.parametrize("nel", [(20, 10), (40, 20)])
def test_slice_matches_reference(nel, monkeypatch):
    import metafem.solver.domain as ref_domain
    import metafem_torch.solver.domain as port_domain
    hist_r = _residual_history(monkeypatch, ref_domain)
    hist_p = _residual_history(monkeypatch, port_domain)
    _, mesh_r, res_r = ref_thermal_2d.solve(nel=nel)
    _, mesh_p, res_p = thermal_2d.solve(nel=nel, device="cpu")

    assert res_r < 1e-6 and res_p < 1e-6
    np.testing.assert_allclose(hist_p[0], hist_r[0], rtol=1e-12)
    assert len(hist_p) == len(hist_r), (hist_p, hist_r)
    T_r, T_p = mesh_r.fields["T"], mesh_p.fields["T"]
    np.testing.assert_allclose(T_p, T_r, rtol=0,
                               atol=1e-6 * np.abs(T_r).max())
    assert thermal_2d.featool_error(mesh_p) < 0.01
