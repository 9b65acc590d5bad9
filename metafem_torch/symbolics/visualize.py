"""Pretty printer for the symbolic IR (cf. symbolics/02_Reload.jl)."""

from __future__ import annotations

from .ir import Term, Word

_SUBSCRIPT = str.maketrans("0123456789", "₀₁₂₃₄"
                           "₅₆₇₈₉")


def _fmt_id(x) -> str:
    return str(x).translate(_SUBSCRIPT) if isinstance(x, int) else str(x)


def visualize(t) -> str:
    if isinstance(t, (int, float)):
        v = float(t)
        return str(int(v)) if v.is_integer() else f"{v:g}"
    if isinstance(t, Word):
        s = t.base
        if t.c_ids or t.sd_ids or t.td:
            comp = ",".join(_fmt_id(x) for x in t.c_ids)
            deriv = ",".join(["t"] * t.td + [_fmt_id(x) for x in t.sd_ids])
            s += "{" + comp + (";" + deriv if deriv else "") + "}"
        return s
    if isinstance(t, Term):
        if t.op == "+":
            return "(" + " + ".join(visualize(s) for s in t.subterms) + ")"
        if t.op == "*":
            return " * ".join(visualize(s) for s in t.subterms)
        if t.op == "^":
            return f"({visualize(t.subterms[0])})^({visualize(t.subterms[1])})"
        if t.op == "var_delta":
            return f"δ({visualize(t.subterms[0])})"
        return f"{t.op}(" + ", ".join(visualize(s) for s in t.subterms) + ")"
    return repr(t)
