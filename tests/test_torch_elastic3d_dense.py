"""The Neo-Hookean load step of test_torch_elastic3d.py with the dense
block-offset layout forced on both sides (``dense_min_n=0``): one dense
group of G=9 units, 117 offsets and C=3 channels, the layout the SpMV
kernel runs on the card at full size.  The reference's example is
replayed with that layout option passed to its
``assemble_global_variables``; no reference file changes.  The bars are
test_torch_elastic3d.py's: d1/L within 1e-8 relative of the reference
and within 2% of the analytic curve.

A file of its own because the reference compiles its grouped dense SpMV
into the BiCGStab(4) loop, which makes this test take about two minutes
on the CPU.
"""

import torch

from metafem.solver.domain import FEM_Domain as RefDomain

from test_torch_elastic3d import check_hyper_step, hyper_load_step, \
    ref_hyper

torch.set_num_threads(2)

DENSE = {"dense_min_n": 0}


def test_dense_layout_load_step_matches_reference(monkeypatch):
    orig = RefDomain.assemble_global_variables
    monkeypatch.setattr(RefDomain, "assemble_global_variables",
                        lambda self, **kw: orig(self, **{**DENSE, **kw}))
    holder = {}

    def ref_build():
        out = ref_hyper.build(e_number=2)
        holder["dom"] = out[0]
        return out

    d_r, d1, res, dom = hyper_load_step(ref_build, port_layout=DENSE)
    groups = [d.pattern.offset_layout.pallas_groups
              for d in (dom, holder["dom"])]
    for d, (grp,) in zip((dom, holder["dom"]), groups):
        assert d.pattern.offset_layout.n_coo == 0
        assert (len(grp.units), grp.n_off, grp.n_vars) == (9, 117, 3)
    assert groups[0][0].offsets == groups[1][0].offsets
    check_hyper_step(d_r, d1, res)
