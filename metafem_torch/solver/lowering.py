"""Lowering of concrete symbolic terms into PyTorch tensor expressions.

Port of ``metafem/solver/lowering.py``; the builtin functions map to
their torch counterparts.

The analog of the reference's ``parse_Term2Expr!``
(symbolics/08_Tensor.jl:169-233), which emits Julia broadcast `Expr`s and
evals them; here the term tree is evaluated directly on the gathered
quadrature-point tensors.  Common subexpressions are shared via a memo
keyed on the (hash-consed) term — the equivalent of the reference's
``declared_syms`` set; the 64-word sum chunking is unnecessary because
each node is one eager tensor operation.

Leaves resolve against an environment mapping a word's total symbol (e.g.
``T_1``, ``n1``) to a ``[batch, nq]`` array (or scalar), prepared by the
assembly layer.  Words of definition variables are inlined recursively
through :meth:`TensorTable.evaluate_tensor`; integration-point variables
evaluate their definition once per total symbol (the tuple-assignment
protocol of ``generates_All_Related_ITG_Symbols``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..symbolics.api import word_total_sym
from ..symbolics.ir import GroundTerm, Term, Word
from ..symbolics.registry import (EXTERNAL_VAR, INTEGRATION_POINT_VAR,
                                  INTERNAL_VAR)
from ..symbolics.tensor_table import TensorTable

def _lift(fn: Callable) -> Callable:
    """Apply a torch function to arguments that may be Python numbers
    (constants of the weak form): numbers become tensors of the type and
    device of the first tensor argument, or 0-d float64 tensors."""
    def call(*args):
        like = next((a for a in args if torch.is_tensor(a)), None)
        if like is None:
            return fn(*(torch.as_tensor(a, dtype=torch.float64)
                        for a in args))
        return fn(*(a if torch.is_tensor(a) else
                    torch.as_tensor(a, dtype=like.dtype, device=like.device)
                    for a in args))
    return call


_BUILTIN_FNS: Dict[str, Callable] = {
    "log": _lift(torch.log),
    "exp": _lift(torch.exp),
    "sqrt": _lift(torch.sqrt),
    "abs": _lift(torch.abs),
    "sin": _lift(torch.sin),
    "cos": _lift(torch.cos),
    "tan": _lift(torch.tan),
    "tanh": _lift(torch.tanh),
    "sign": _lift(torch.sign),
    "max": _lift(torch.maximum),
    "min": _lift(torch.minimum),
    "ifelse": _lift(torch.where),
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
}


class LoweringContext:
    """Lowers ground terms against an environment of gathered variables.

    ``env``: total_sym -> tensor or Python number.  ``functions``: user
    callback registry (the analog of the reference's ``Main.$op`` dispatch,
    symbolics/08_Tensor.jl:210) — names resolve here before the torch
    builtins.
    """

    def __init__(self, tb: TensorTable, env: Dict[str, object],
                 functions: Dict[str, Callable] | None = None,
                 user_state=None):
        self.tb = tb
        self.env = env
        self.functions = functions or {}
        self.user_state = user_state
        self._memo: Dict[GroundTerm, object] = {}

    def lower(self, t: GroundTerm):
        if isinstance(t, (int, float)):
            return float(t)
        got = self._memo.get(t)
        if got is None:
            got = self._memo[t] = (self._lower_word(t)
                                   if isinstance(t, Word)
                                   else self._lower_term(t))
        return got

    # -- leaves ---------------------------------------------------------
    def _lower_word(self, w: Word):
        sym = word_total_sym(self.tb.dim, w)
        if sym in self.env:
            return self.env[sym]
        attrs = self.tb.registry.attributes(w.base)
        if INTERNAL_VAR in attrs:
            raise KeyError(
                f"internal variable {sym!r} was not gathered into the "
                f"assembly environment")
        if EXTERNAL_VAR in attrs:
            if INTEGRATION_POINT_VAR in attrs and w.base != "n":
                if w.sd_ids or w.td:
                    raise ValueError(
                        f"integration-point variable {w.base!r} cannot "
                        f"carry derivatives; use a controlpoint variable")
                self._lower_itg_var(w)
                return self.env[sym]
            raise KeyError(
                f"external variable {sym!r} was not provided to the "
                f"assembly environment")
        # definition variable: inline its indexed instance
        val = self.lower(self.tb.propagate_symbol(self.tb.evaluate_tensor(w)))
        self.env[sym] = val
        return val

    def _lower_itg_var(self, w: Word) -> None:
        """Evaluate a user integration-point variable's definition once per
        base symbol and populate every component's total symbol — the
        tuple-assignment of generates_All_Related_ITG_Symbols
        (symbolics/08_Tensor.jl:150-186).  Multi-component variables (e.g.
        a symmetric plastic-strain tensor) are backed by a function
        returning all Voigt components at once."""
        from ..symbolics.api import word_to_sym
        from ..symbolics.ir import inverse_voigt_id, substitute, voigt_size
        from ..symbolics.simplify import unroll_and_simplify

        ids, raw_def = self.tb.definitions[w.base]
        dim = self.tb.dim
        inst = unroll_and_simplify(raw_def, dim)
        if ids:
            inst = substitute(inst, list(ids), list(w.c_ids))
        val = self.lower(self.tb.propagate_symbol(inst))

        if not w.c_ids:
            self.env[word_to_sym(dim, w.base, 0, (), ())] = val
            return
        symmetric = self.tb.registry.is_symmetric(w.base)
        if len(w.c_ids) == 1:
            n_out = dim
            comp_ids = [(v,) for v in range(1, dim + 1)]
        elif len(w.c_ids) == 2 and symmetric:
            n_out = voigt_size(dim)
            comp_ids = [inverse_voigt_id(v, dim) for v in range(1, n_out + 1)]
        elif len(w.c_ids) == 2:
            n_out = dim * dim
            comp_ids = [(a, b) for a in range(1, dim + 1)
                        for b in range(1, dim + 1)]
        else:
            raise ValueError("integration-point variables of rank > 2 are "
                             "not supported")
        if not isinstance(val, (tuple, list)) or len(val) != n_out:
            raise ValueError(
                f"the definition of {w.base!r} must return {n_out} "
                f"components (got {type(val).__name__})")
        for cid, out in zip(comp_ids, val):
            self.env[word_to_sym(dim, w.base, 0, cid, (),
                                 symmetric=symmetric)] = out

    # -- interior nodes ---------------------------------------------------
    def _lower_term(self, t: Term):
        if t.op == "+":
            acc = self.lower(t.subterms[0])
            for s in t.subterms[1:]:
                acc = acc + self.lower(s)
            return acc
        if t.op == "*":
            acc = self.lower(t.subterms[0])
            for s in t.subterms[1:]:
                acc = acc * self.lower(s)
            return acc
        if t.op == "^":
            b, e = (self.lower(s) for s in t.subterms)
            if isinstance(e, float) and e == round(e):
                # integer powers: keep exact & cheap (avoids NaN for b<0)
                n = int(e)
                if n < 0:
                    return 1.0 / self._int_pow(b, -n)
                return self._int_pow(b, n)
            return b ** e
        args = [self.lower(s) for s in t.subterms]
        fn = self.functions.get(t.op)
        if fn is not None:
            import inspect
            params = inspect.signature(fn).parameters
            if "user" in params:
                # history / material state passed in from the runtime
                # state (replaces MetaFEM.jl's mutable MaterialState
                # closure, J2Plasticity.jl:86-199)
                return fn(*args, user=self.user_state)
            return fn(*args)
        fn = _BUILTIN_FNS.get(t.op)
        if fn is None:
            raise ValueError(f"unknown function {t.op!r} in weak form; "
                             f"register it via FEM_Domain.register_function")
        return fn(*args)

    @staticmethod
    def _int_pow(b, n: int):
        if n == 0:
            return 1.0
        acc = b
        for _ in range(n - 1):
            acc = acc * b
        return acc
