"""The four derivative flavors: time, space, variation, symbol.

The reference drives these with rewrite rules (symbolics/09_Differentiation.jl
Num/Add/Mul/Pow/Log/Cond_Diff applied to a ∂-wrapped copy); here they are the
same chain rules applied by direct recursion, with a per-flavor leaf handler
(diff_Eval_*_Local!, 09_Differentiation.jl:47-73,99-112).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .ir import GroundTerm, Term, Word, add, call, construct_term, mul, pow_
from .registry import (CONTROLPOINT_VAR, EXTERNAL_VAR, INTERNAL_VAR)
from .simplify import simplify_common


#: chain rules for function ops: op -> rule(subterms, d) where ``d`` is
#: the recursive differentiator; returns the derivative term.  The
#: reference's analog is its exported DIFF_RULES rewrite-rule vector
#: (09_Differentiation.jl:4-13) — user-extensible via register_diff_rule.
DIFF_RULES: Dict[str, Callable] = {
    "exp": lambda s, d: mul([d(s[0]), call("exp", s[0])]),
    "sqrt": lambda s, d: mul([d(s[0]), 0.5,
                              pow_(call("sqrt", s[0]), -1.0)]),
    "sin": lambda s, d: mul([d(s[0]), call("cos", s[0])]),
    "cos": lambda s, d: mul([-1.0, d(s[0]), call("sin", s[0])]),
    "tan": lambda s, d: mul([d(s[0]),
                             pow_(call("cos", s[0]), -2.0)]),
    "tanh": lambda s, d: mul([d(s[0]), add(
        [1.0, mul([-1.0, pow_(call("tanh", s[0]), 2.0)])])]),
    "abs": lambda s, d: mul([d(s[0]), call("sign", s[0])]),
    "sign": lambda s, d: 0.0,
}


def register_diff_rule(op: str, rule: Callable) -> None:
    """Extend the differentiation engine with a chain rule for a custom
    function op: ``rule(subterms, d) -> derivative term`` where
    ``d(subterm)`` recursively differentiates.  Pairs with
    FEM_Domain.register_function (the numeric evaluation of the op)."""
    DIFF_RULES[op] = rule


def _diff(t: GroundTerm, leaf: Callable[[Word], GroundTerm]) -> GroundTerm:
    if isinstance(t, (int, float)):
        return 0.0
    if isinstance(t, Word):
        return leaf(t)
    if t.op == "+":
        return add([_diff(s, leaf) for s in t.subterms])
    if t.op == "*":
        out = []
        subs = list(t.subterms)
        for i, s in enumerate(subs):
            rest = subs[:i] + subs[i + 1:]
            out.append(mul([_diff(s, leaf)] + rest))
        return add(out)
    if t.op == "^":
        a, b = t.subterms
        t1 = mul([_diff(a, leaf), pow_(a, construct_term("+", [b, -1.0])), b])
        db = _diff(b, leaf)
        if isinstance(db, (int, float)) and db == 0.0:
            return t1
        return add([t1, mul([db, call("log", a), pow_(a, b)])])
    if t.op == "log":
        return mul([_diff(t.subterms[0], leaf), pow_(t.subterms[0], -1.0)])
    if t.op == "ifelse":
        c, x, y = t.subterms
        return call("ifelse", c, _diff(x, leaf), _diff(y, leaf))
    rule = DIFF_RULES.get(t.op)
    if rule is not None:
        return rule(list(t.subterms), lambda s: _diff(s, leaf))
    raise ValueError(
        f"cannot differentiate through operation {t.op!r}; register a "
        f"chain rule via metafem.register_diff_rule")


def _attrs(tb, w: Word):
    return tb.registry.attributes(w.base)


def diff_time(t: GroundTerm, tb) -> GroundTerm:
    """d/dt: bump td_order; external vars have no time derivative."""
    def leaf(w: Word) -> GroundTerm:
        if EXTERNAL_VAR in _attrs(tb, w):
            return 0.0
        return w.replace(td=w.td + 1)
    return simplify_common(_diff(t, leaf)) if not isinstance(t, (int, float)) else 0.0


def diff_space(t: GroundTerm, d_id, tb) -> GroundTerm:
    """d/dx_{d_id}: append to sd_ids; non-controlpoint external vars -> 0."""
    def leaf(w: Word) -> GroundTerm:
        a = _attrs(tb, w)
        if EXTERNAL_VAR in a and CONTROLPOINT_VAR not in a:
            return 0.0
        return w.replace(sd_ids=(*w.sd_ids, d_id))
    return simplify_common(_diff(t, leaf)) if not isinstance(t, (int, float)) else 0.0


def diff_variation(t: GroundTerm, tb) -> GroundTerm:
    """Variational derivative: wrap each internal (DOF) word occurrence in
    δ(...); external vars vanish; definition vars recurse through their
    definitions (09_Differentiation.jl:65-73)."""
    def leaf(w: Word) -> GroundTerm:
        a = _attrs(tb, w)
        if INTERNAL_VAR in a:
            return construct_term("var_delta", [w])
        if EXTERNAL_VAR in a:
            return 0.0
        return diff_variation(tb.evaluate_tensor(w), tb)
    if isinstance(t, (int, float)):
        return 0.0
    return simplify_common(_diff(t, leaf))


def _delta_func(c1, c2) -> GroundTerm:
    if isinstance(c1, int) and isinstance(c2, int):
        return 1.0 if c1 == c2 else 0.0
    return Word("delta", 0, (c1, c2), (), symmetric=True)


def diff_symbol(t: GroundTerm, tb, diff_word: Word) -> GroundTerm:
    """Symbolic derivative d(t)/d(diff_word), producing Kronecker-delta
    products on matching words and named derivative tensors on definition
    vars (09_Differentiation.jl:99-112)."""
    def leaf(w: Word) -> GroundTerm:
        if (w.base == diff_word.base and w.td == diff_word.td
                and len(w.c_ids) == len(diff_word.c_ids)
                and len(w.sd_ids) == len(diff_word.sd_ids)):
            deltas = [_delta_func(i1, i2)
                      for i1, i2 in zip(w.c_ids, diff_word.c_ids)]
            deltas += [_delta_func(i1, i2)
                       for i1, i2 in zip(w.sd_ids, diff_word.sd_ids)]
            return mul(deltas) if deltas else 1.0
        a = _attrs(tb, w)
        if INTERNAL_VAR in a or EXTERNAL_VAR in a:
            return 0.0
        # definition variable: materialize a named derivative tensor
        info = tb.get_tensor_diff(tb.word_to_info(w), tb.word_to_info(diff_word))
        ids = (*w.c_ids, *w.sd_ids, *diff_word.c_ids, *diff_word.sd_ids)
        return tb.info_to_word(info, ids)
    if isinstance(t, (int, float)):
        return 0.0
    return simplify_common(_diff(t, leaf))


def collect_variations(t: GroundTerm, tb) -> Dict[Word, List[GroundTerm]]:
    """Split the variation of ``t`` into per-test-word coefficient lists:
    returns {dual_word: [factors...]} such that
    δt = Σ_w Σ_f f * δ(w)   (09_Differentiation.jl:75-97)."""
    buffer: Dict[Word, List[GroundTerm]] = {}
    _collect(buffer, diff_variation(t, tb))
    return buffer


def _is_var(x) -> bool:
    return isinstance(x, Term) and x.op == "var_delta"


def _collect(buffer: Dict[Word, List[GroundTerm]], t: GroundTerm) -> None:
    if isinstance(t, (int, float, Word)):
        return
    if t.op == "var_delta":
        buffer.setdefault(t.subterms[0], []).append(1.0)
    elif t.op == "+":
        for s in t.subterms:
            _collect(buffer, s)
    elif t.op == "*":
        var_ids = [i for i, s in enumerate(t.subterms) if _is_var(s)]
        if len(var_ids) != 1:
            raise ValueError(
                f"each product must contain exactly one variation: {t!r}")
        word = t.subterms[var_ids[0]].subterms[0]
        rest = [s for i, s in enumerate(t.subterms) if i != var_ids[0]]
        buffer.setdefault(word, []).append(mul(rest) if rest else 1.0)
    else:
        raise ValueError(f"unexpected IR in variation collection: {t!r}")
