"""Weak form -> assembly IR: the linear/nonlinear gradient split and the
DOF-block layout.

Behavioral model: the reference's ``extract_Words`` /
``construct_AssembleWeakform`` / ``initialize_LocalAssembly!``
(solver/02_LocalAssembly.jl:1-122):

* every bilinear form's base term is differentiated per internal (DOF) word
  by :func:`~metafem.symbolics.diff.collect_variations`;
* a gradient is **linear** when its coefficient contains no internal words
  and no integration-point variables (except the facet normal ``n``) — those
  are assembled once per time step into ``K_linear``; the rest are
  **nonlinear** and re-assembled every Newton iteration
  (02_LocalAssembly.jl:49-54);
* DOF blocks: ``basic_vars`` is the sorted list of base DOF column names
  (e.g. ``['d1', 'd2', 'p']``), ``sparse_mapping`` maps a coupled
  (dual_pos, base_pos) variable pair to its sparse block unit
  (02_LocalAssembly.jl:60-74,104-105).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..symbolics.api import word_base_sym, word_local_sym, word_total_sym
from ..symbolics.diff import collect_variations
from ..symbolics.ir import GroundTerm, Term, Word, add
from ..symbolics.registry import (CONTROLPOINT_VAR, EXTERNAL_VAR,
                                  INTEGRATION_POINT_VAR, INTERNAL_VAR)
from ..symbolics.simplify import simplify_common
from ..symbolics.tensor_table import TensorTable
from ..symbolics.weakform import BilinearForm

#: (total_sym, td_order, sd_ids, basic_pos) — solver/02_LocalAssembly.jl:27
InnervarInfo = Tuple[str, int, Tuple[int, ...], int]
#: (total_sym, local_sym, base_var, sd_ids, c_ids) — :28
ExtervarInfo = Tuple[str, str, str, Tuple[int, ...], Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class AssembleBilinear:
    """One lowered bilinear contribution.

    ``base_term`` is the scalar coefficient evaluated at quadrature points;
    ``dual_info`` selects the test-function row block; ``derivative_info``
    (None for residues) selects the trial-function column block.
    ``form_id`` links residues and gradients back to the BilinearForm they
    came from (per-AssembleWeakform numbering) — used by the refined
    affine/nonaffine split (solver/refine.py).
    """
    base_term: GroundTerm
    dual_info: InnervarInfo
    derivative_info: Optional[InnervarInfo]
    form_id: int = -1


@dataclasses.dataclass
class AssembleWeakform:
    residues: List[AssembleBilinear]
    linear_gradients: List[AssembleBilinear]
    nonlinear_gradients: List[AssembleBilinear]
    innervar_infos: List[InnervarInfo]
    linear_extervar_infos: List[ExtervarInfo]
    extervar_infos: List[ExtervarInfo]
    #: forms whose RESIDUE references an integration-point variable
    #: (other than the geometric normal n): those re-evaluate user
    #: callbacks / itg-var definitions from the current x each iteration
    #: (e.g. J2's radial return), so the residue is x-dependent even
    #: when every gradient is classified linear — never affine
    itg_form_ids: Set[int] = dataclasses.field(default_factory=set)

    def is_empty(self) -> bool:
        return not (self.residues or self.linear_gradients
                    or self.nonlinear_gradients)

    def affine_form_ids(self) -> Set[int]:
        """Forms whose residue is affine in the DOF vector: every gradient
        is x-independent (linear), so residue(x) = sum_td G_td @ x[td] +
        residue(0) holds exactly at the discrete level.  Used by the
        refined-residual path to replace per-iteration volume assembly
        with frozen f64 tangent streams."""
        nonaffine = ({b.form_id for b in self.nonlinear_gradients}
                     | self.itg_form_ids)
        return {b.form_id for b in self.residues} - nonaffine


@dataclasses.dataclass
class LocalAssembly:
    basic_vars: List[str]                       # sorted DOF column names
    bvar_mapping: Dict[str, int]                # name -> 0-based position
    #: (local_sym, basic_pos, td_order) for x <-> controlpoint-column sync
    local_innervar_infos: List[Tuple[str, int, int]]
    #: controlpoint external-variable column names to allocate
    controlpoint_extervars: List[str]
    assembled_weakform: AssembleWeakform
    assembled_boundary_weakform_pairs: Dict[int, AssembleWeakform]
    #: (dual_pos, base_pos) -> sparse block unit id
    sparse_mapping: Dict[Tuple[int, int], int]
    max_sd_order: int

    @property
    def n_vars(self) -> int:
        return len(self.basic_vars)

    @property
    def max_time_level(self) -> int:
        if not self.local_innervar_infos:
            return 0
        return max(td for (_, _, td) in self.local_innervar_infos)


def extract_words(tb: TensorTable, src) -> Tuple[Set[Word], Set[Word]]:
    """Classify every word reachable from ``src`` into internal (DOF) vs
    external variables, recursing through definitions
    (solver/02_LocalAssembly.jl:1-25)."""
    internal: Set[Word] = set()
    external: Set[Word] = set()
    _extract(tb, internal, external, src)
    return internal, external


def _extract(tb, internal, external, src) -> None:
    if isinstance(src, (int, float)):
        return
    if isinstance(src, Word):
        attrs = tb.registry.attributes(src.base)
        if INTERNAL_VAR in attrs:
            internal.add(src)
        elif EXTERNAL_VAR in attrs:
            if INTEGRATION_POINT_VAR in attrs and src.base != "n":
                _extract(tb, internal, external, tb.definitions[src.base][1])
            else:
                external.add(src)
        else:
            _extract(tb, internal, external, tb.evaluate_tensor(src))
        return
    if isinstance(src, Term):
        for s in src.subterms:
            _extract(tb, internal, external, s)
        return
    if isinstance(src, BilinearForm):
        _extract(tb, internal, external, src.base_term)
        return
    for s in src:  # a list of forms
        _extract(tb, internal, external, s)


def _has_itg_var(tb, src) -> bool:
    """True when ``src`` references an integration-point variable (other
    than the geometric normal n), including through definitions — such a
    term re-evaluates its itg-var definition (e.g. a user radial-return
    callback) from the CURRENT x at every assembly, so it is x-dependent
    even when its collect_variations gradients are all x-independent."""
    if isinstance(src, (int, float)):
        return False
    if isinstance(src, Word):
        attrs = tb.registry.attributes(src.base)
        if INTEGRATION_POINT_VAR in attrs and src.base != "n":
            return True
        if INTERNAL_VAR in attrs or EXTERNAL_VAR in attrs:
            return False
        return _has_itg_var(tb, tb.evaluate_tensor(src))
    if isinstance(src, Term):
        return any(_has_itg_var(tb, s) for s in src.subterms)
    return False


def _innervar_info(dim: int, w: Word,
                   bvar_mapping: Dict[str, int]) -> InnervarInfo:
    return (word_total_sym(dim, w), w.td, tuple(w.sd_ids),
            bvar_mapping[word_base_sym(dim, w)])


def _extervar_info(dim: int, w: Word) -> ExtervarInfo:
    return (word_total_sym(dim, w), word_local_sym(dim, w), w.base,
            tuple(w.sd_ids), tuple(w.c_ids))


def construct_assemble_weakform(tb: TensorTable,
                                forms: Sequence[BilinearForm],
                                bvar_mapping: Dict[str, int],
                                ) -> AssembleWeakform:
    """The linear/nonlinear gradient split
    (solver/02_LocalAssembly.jl:30-58)."""
    dim = tb.dim
    residues: List[AssembleBilinear] = []
    linear_gradients: List[AssembleBilinear] = []
    nonlinear_gradients: List[AssembleBilinear] = []
    innervar_infos: List[InnervarInfo] = []
    linear_extervar_infos: List[ExtervarInfo] = []
    extervar_infos: List[ExtervarInfo] = []

    def _union(dst: list, items) -> None:
        for it in items:
            if it not in dst:
                dst.append(it)

    itg_form_ids: Set[int] = set()
    for form_id, bf in enumerate(forms):
        dual_info = _innervar_info(dim, bf.dual_word, bvar_mapping)
        inner_words, exter_words = extract_words(tb, bf.base_term)

        residues.append(AssembleBilinear(bf.base_term, dual_info, None,
                                         form_id))
        if _has_itg_var(tb, bf.base_term):
            itg_form_ids.add(form_id)
        _union(innervar_infos,
               [_innervar_info(dim, w, bvar_mapping) for w in inner_words])
        _union(extervar_infos, [_extervar_info(dim, w) for w in exter_words])

        for diff_word, termvec in collect_variations(bf.base_term, tb).items():
            diffed = simplify_common(add(termvec))
            d_inner, d_exter = extract_words(tb, diffed)
            derivative_info = _innervar_info(dim, diff_word, bvar_mapping)
            bil = AssembleBilinear(diffed, dual_info, derivative_info,
                                   form_id)
            is_linear = not d_inner and all(
                INTEGRATION_POINT_VAR not in tb.registry.attributes(w.base)
                or w.base == "n" for w in d_exter)
            if is_linear:
                linear_gradients.append(bil)
                _union(linear_extervar_infos,
                       [_extervar_info(dim, w) for w in d_exter])
            else:
                nonlinear_gradients.append(bil)

    return AssembleWeakform(residues, linear_gradients, nonlinear_gradients,
                            innervar_infos, linear_extervar_infos,
                            extervar_infos, itg_form_ids)


def _sd_order(wf: AssembleWeakform) -> int:
    orders = [1]
    for bil in wf.residues + wf.linear_gradients + wf.nonlinear_gradients:
        orders.append(len(bil.dual_info[2]))
        if bil.derivative_info is not None:
            orders.append(len(bil.derivative_info[2]))
    for info in wf.innervar_infos:
        orders.append(len(info[2]))
    for info in wf.extervar_infos + wf.linear_extervar_infos:
        orders.append(len(info[3]))
    return max(orders)


def initialize_local_assembly(tb: TensorTable,
                              domain_forms: Sequence[BilinearForm],
                              boundary_form_pairs: Dict[int,
                                                        Sequence[BilinearForm]],
                              extra_vars: Sequence[str] = (),
                              explicit_max_sd_order: int = 9,
                              ) -> LocalAssembly:
    """Build the per-workpiece assembly IR
    (solver/02_LocalAssembly.jl:83-112)."""
    dim = tb.dim
    inner_words, exter_words = extract_words(tb, list(domain_forms))
    for forms in boundary_form_pairs.values():
        _extract(tb, inner_words, exter_words, list(forms))

    basic_vars = sorted({word_base_sym(dim, w) for w in inner_words})
    bvar_mapping = {v: i for i, v in enumerate(basic_vars)}

    local_innervar_infos = sorted(
        {(word_local_sym(dim, w), bvar_mapping[word_base_sym(dim, w)], w.td)
         for w in inner_words})
    cp_exter = sorted(
        {word_local_sym(dim, w) for w in exter_words
         if CONTROLPOINT_VAR in tb.registry.attributes(w.base)
         and w.base not in ("x", "y", "z")})
    controlpoint_extervars = list(dict.fromkeys([*extra_vars, *cp_exter]))

    assembled = construct_assemble_weakform(tb, domain_forms, bvar_mapping)
    assembled_bdy = {
        bg_id: construct_assemble_weakform(tb, forms, bvar_mapping)
        for bg_id, forms in boundary_form_pairs.items()}

    pairs: Set[Tuple[int, int]] = set()
    for wf in [assembled, *assembled_bdy.values()]:
        for bil in wf.linear_gradients + wf.nonlinear_gradients:
            pairs.add((bil.dual_info[3], bil.derivative_info[3]))
    sparse_mapping = {p: i for i, p in enumerate(sorted(pairs))}

    max_sd = max([_sd_order(assembled)]
                 + [_sd_order(wf) for wf in assembled_bdy.values()])
    max_sd = min(max_sd, explicit_max_sd_order)

    return LocalAssembly(
        basic_vars=basic_vars, bvar_mapping=bvar_mapping,
        local_innervar_infos=local_innervar_infos,
        controlpoint_extervars=controlpoint_extervars,
        assembled_weakform=assembled,
        assembled_boundary_weakform_pairs=assembled_bdy,
        sparse_mapping=sparse_mapping, max_sd_order=max_sd)
