"""Weak-form collection: Bilinear distribution + per-test-word grouping.

Mirrors ``build_WeakForm`` / ``collect_BilinearTerms!`` / ``regulate_LHS!``
(symbolics/10_WeakForm.jl:72-124): a user weak form is a sum of products
each containing exactly one ``Bilinear(dual, base)``; coefficients multiply
into the base side; the dual side is variationally differentiated and the
result grouped per test word.
"""

from __future__ import annotations

import dataclasses
from typing import List

from .diff import collect_variations
from .ir import GroundTerm, Term, Word, add, bilinear_term, mul, substitute
from .registry import EXTERNAL_VAR, INTERNAL_VAR
from .simplify import simplify_common, unroll_and_simplify


@dataclasses.dataclass(frozen=True)
class BilinearForm:
    """(test word, coefficient term): the inner product (δ dual_word, base)."""
    dual_word: Word
    base_term: GroundTerm


def collect_bilinear_terms(tb, buffer: List[Term], t: GroundTerm) -> List[Term]:
    if isinstance(t, (int, float)):
        return buffer
    if isinstance(t, Word):
        a = tb.registry.attributes(t.base)
        if INTERNAL_VAR not in a and EXTERNAL_VAR not in a:
            if not t.sd_ids and t.td == 0:
                raw_ids, raw_def = tb.definitions[t.base]
                target = substitute(unroll_and_simplify(raw_def, tb.dim),
                                    list(raw_ids), list(t.c_ids))
                return collect_bilinear_terms(tb, buffer, target)
        return buffer
    if t.op == "Bilinear":
        buffer.append(t)
    elif t.op == "+":
        for s in t.subterms:
            collect_bilinear_terms(tb, buffer, s)
    elif t.op == "*":
        sub_vecs = [collect_bilinear_terms(tb, [], s) for s in t.subterms]
        hit_ids = [i for i, v in enumerate(sub_vecs) if v]
        if len(hit_ids) > 1:
            raise ValueError(
                f"one product may contain only one Bilinear: {t!r}")
        if len(hit_ids) == 1:
            others = [s for i, s in enumerate(t.subterms) if i != hit_ids[0]]
            for bil in sub_vecs[hit_ids[0]]:
                new_base = mul(others + [bil.subterms[1]])
                buffer.append(bilinear_term(bil.subterms[0], new_base))
    elif _contains_bilinear(t):
        # e.g. Bilinear(a,b)^2 (two identical Bilinears in a product merge
        # into a power during simplification) — never a valid weak form
        raise ValueError(
            f"Bilinear may only appear linearly in a weak form, found it "
            f"under {t.op!r}: {t!r}")
    return buffer


def _contains_bilinear(t: GroundTerm) -> bool:
    if not isinstance(t, Term):
        return False
    if t.op == "Bilinear":
        return True
    return any(_contains_bilinear(s) for s in t.subterms)


def _check_words_resolvable(tb, t: GroundTerm) -> None:
    if isinstance(t, Word):
        if not tb.registry.is_declared(t.base) and t.base not in tb.definitions:
            raise ValueError(
                f"variable {t.base!r} is neither declared (internal_var / "
                f"external_var) nor defined (define)")
    elif isinstance(t, Term):
        for s in t.subterms:
            _check_words_resolvable(tb, s)


def build_weakform(tb, src: GroundTerm) -> List[BilinearForm]:
    from .ir import free_index
    if isinstance(src, Term):
        fset = free_index(src)
        if fset:
            raise ValueError(
                f"a weak form must be a scalar; free indices {list(fset)} "
                f"remain (did you mean a summed index?)")
        _check_words_resolvable(tb, src)
        src = unroll_and_simplify(src, tb.dim)
    raw = collect_bilinear_terms(tb, [], src)
    db: dict = {}
    for bf in raw:
        dual_term, base_term = bf.subterms
        for dual_word, factors in collect_variations(dual_term, tb).items():
            db.setdefault(dual_word, []).append(
                simplify_common(mul([add(factors), base_term])))
    return [BilinearForm(w, simplify_common(add(bases)))
            for w, bases in db.items()]
