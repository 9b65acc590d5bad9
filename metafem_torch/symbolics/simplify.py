"""Expansion to sum-of-products + hash-based like-term merging.

Reproduces the behavior of the reference's five active rewrite rules
(Add/Mul/Pow_Splat, Distributive_MP/AM, symbolics/07_Simplification.jl:5-10)
and its hard-coded dictionary merger ``check_Merge`` (:23-75), but as direct
recursion: the reference itself retired its generic pattern matcher for
speed (rules_archive/legacy_rules.jl:1-4), so we don't build one.
"""

from __future__ import annotations

import itertools

from .ir import (GroundTerm, Term, Word, add, construct_term, free_index,
                 mul, pow_, unroll_dumb_indices)


# ---------------------------------------------------------------------------
# expansion: distribute products over sums, flatten, splat powers
# ---------------------------------------------------------------------------

def _expand(t: GroundTerm) -> GroundTerm:
    if not isinstance(t, Term):
        return t
    if t.op == "+":
        out = []
        for s in t.subterms:
            s = _expand(s)
            if isinstance(s, Term) and s.op == "+":
                out.extend(s.subterms)
            else:
                out.append(s)
        return add(out)
    if t.op == "*":
        # each factor expands to a sum of products; cartesian-distribute
        factor_sums = []
        for s in t.subterms:
            s = _expand(s)
            if isinstance(s, Term) and s.op == "+":
                factor_sums.append(list(s.subterms))
            else:
                factor_sums.append([s])
        prods = []
        for combo in itertools.product(*factor_sums):
            flat = []
            for c in combo:
                if isinstance(c, Term) and c.op == "*":
                    flat.extend(c.subterms)
                else:
                    flat.append(c)
            prods.append(mul(flat))
        return add(prods)
    if t.op == "^":
        b = _expand(t.subterms[0])
        e = _expand(t.subterms[1])
        if isinstance(b, Term) and b.op == "^":  # (a^b)^c -> a^(b*c)
            return _expand(pow_(b.subterms[0], mul([b.subterms[1], e])))
        if isinstance(b, Term) and b.op == "*":  # (a*b)^c -> a^c * b^c
            return _expand(mul([pow_(f, e) for f in b.subterms]))
        return pow_(b, e)
    # Bilinear / var_delta / function calls: expand children only
    return construct_term(t.op, [_expand(s) for s in t.subterms])


def expand_and_flatten(t: GroundTerm) -> GroundTerm:
    prev = None
    while prev != t:
        prev, t = t, _expand(t)
    return t


# ---------------------------------------------------------------------------
# like-term merging (coefficients under '+', exponents under '*')
# ---------------------------------------------------------------------------

def check_merge(t: GroundTerm) -> GroundTerm:
    if not isinstance(t, Term):
        return t
    subs = [check_merge(s) for s in t.subterms]
    if t.op == "+":
        classifier: dict = {}
        order: list = []
        for s in subs:
            if isinstance(s, (int, float)):
                main, coeff = 1.0, float(s)
            elif (isinstance(s, Term) and s.op == "*"
                  and isinstance(s.subterms[0], (int, float))):
                main, coeff = mul(list(s.subterms[1:])), float(s.subterms[0])
            else:
                main, coeff = s, 1.0
            if main not in classifier:
                order.append(main)
            classifier[main] = classifier.get(main, 0.0) + coeff
        out = []
        for main in order:
            coeff = classifier[main]
            if isinstance(main, Term) and main.op == "*":
                out.append(mul([coeff, *main.subterms]))
            else:
                out.append(mul([coeff, main]))
        return add(out)
    if t.op == "*":
        preserved = [s for s in subs if free_index(s)]
        processing = [s for s in subs if not free_index(s)]
        classifier: dict = {}
        order = []
        for s in processing:
            if (isinstance(s, Term) and s.op == "^"
                    and not isinstance(s, (int, float))):
                main, expo = s.subterms
            else:
                main, expo = s, 1.0
            if main not in classifier:
                order.append(main)
            classifier[main] = add([classifier.get(main, 0.0), expo])
        out = [construct_term("^", [main, check_merge(classifier[main])])
               for main in order]
        return mul(out + preserved)
    return construct_term(t.op, subs)


# ---------------------------------------------------------------------------
# user-extensible rewrite rules
#
# The reference exposes @Define_Rewrite_Rule / @Define_Semantic_Constraint /
# @Define_Aux_Semantics (symbolics/05_Syntactic_Structure.jl:116-160) plus a
# backtracking pattern matcher (06_Rewrite.jl:1-205) so users can add
# simplification rules.  Here a rule is plain Python — no pattern DSL, as
# the reference itself retired the DSL for its hot path
# (rules_archive/legacy_rules.jl:1-4): a callable ``rule(term) ->
# replacement | None`` inspecting the Term/Word IR directly.  Rules are
# applied to every (sub)term to fixpoint inside simplify_common, i.e. at
# every @Def / weak-form build / differentiation — the same surface the
# reference's apply_Rules covers (06_Rewrite.jl:173-205).
# ---------------------------------------------------------------------------

_USER_RULES: list = []          # [(name, fn)]
_MAX_REWRITES = 200


def register_rule(fn, *, name: str | None = None) -> str:
    """Register ``fn(term) -> replacement | None`` as a rewrite rule.

    ``term`` is a Word / Term / number from metafem.symbolics.ir; return
    a replacement to rewrite, or None to pass.  Rules run during every
    simplification, so register BEFORE building weak forms and keep
    them cheap.  Returns the rule name (for unregister_rule)."""
    name = name or getattr(fn, "__name__", None) or f"rule{len(_USER_RULES)}"
    _USER_RULES.append((name, fn))
    return name


def unregister_rule(name: str) -> None:
    _USER_RULES[:] = [(n, f) for (n, f) in _USER_RULES if n != name]


def registered_rules() -> list:
    return [n for (n, _) in _USER_RULES]


def _apply_user_rules(t: GroundTerm) -> GroundTerm:
    for _ in range(_MAX_REWRITES):
        # head rewrite to fixpoint
        for _ in range(_MAX_REWRITES):
            for _, fn in _USER_RULES:
                r = fn(t)
                if r is not None and r != t:
                    t = r
                    break
            else:
                break
        else:
            raise ValueError(
                f"user rewrite rules did not reach a head fixpoint in "
                f"{_MAX_REWRITES} steps on {t!r}")
        # descend; a child rewrite may expose a new head match
        if not isinstance(t, Term):
            return t
        subs = [_apply_user_rules(s) for s in t.subterms]
        if subs == list(t.subterms):
            return t
        t = construct_term(t.op, subs)
    raise ValueError(
        f"user rewrite rules did not reach a fixpoint in "
        f"{_MAX_REWRITES} rounds (rule cycle?) on {t!r}")


def simplify_common(t: GroundTerm) -> GroundTerm:
    t = check_merge(expand_and_flatten(t))
    if _USER_RULES:
        t2 = _apply_user_rules(t)
        if t2 != t:
            t = check_merge(expand_and_flatten(t2))
    return t


# ---------------------------------------------------------------------------
# special symbols: Kronecker delta, Levi-Civita (on concrete indices)
# ---------------------------------------------------------------------------

_EPS3 = {(1, 2, 3): 1.0, (2, 3, 1): 1.0, (3, 1, 2): 1.0,
         (1, 3, 2): -1.0, (3, 2, 1): -1.0, (2, 1, 3): -1.0}


def _replace_special(t: GroundTerm) -> GroundTerm:
    if isinstance(t, Word):
        if t.base == "delta":
            if t.td != 0 or t.sd_ids:
                return 0.0
            if (len(t.c_ids) == 2 and isinstance(t.c_ids[0], int)
                    and isinstance(t.c_ids[1], int)):
                return 1.0 if t.c_ids[0] == t.c_ids[1] else 0.0
        elif t.base == "eps3" and len(t.c_ids) == 3:
            if t.td != 0 or t.sd_ids:
                return 0.0
            if all(isinstance(c, int) for c in t.c_ids):
                return _EPS3.get(tuple(t.c_ids), 0.0)
        return t
    if isinstance(t, Term):
        return construct_term(t.op, [_replace_special(s) for s in t.subterms])
    return t


def replace_special_terms(t: GroundTerm) -> GroundTerm:
    return simplify_common(_replace_special(t))


def unroll_and_simplify(t: GroundTerm, dim: int) -> GroundTerm:
    """unroll dumb indices over 1..dim, evaluate δ/ϵ, simplify
    (symbolics/08_Tensor.jl:7)."""
    return replace_special_terms(unroll_dumb_indices(t, dim))
