"""Symbolic weak-form layer (the CAS).

Re-implements, TPU-first, the behavior of the reference's ``src/symbolics/``
(MetaFEM.jl): tensor-index meta-expressions are parsed into a Word/Term IR,
simplified by expansion + hash-merging, unrolled over dumb (summed) indices,
and differentiated (time / space / variation / symbol) to produce the
per-test-function bilinear forms that the assembly layer lowers into jitted
JAX functions.  The reference's runtime Julia-Expr codegen becomes trace-time
program construction here.
"""

from .ir import (
    Word,
    Term,
    GroundTerm,
    add,
    mul,
    pow_,
    bilinear_term,
    call,
    construct_term,
    substitute,
    unroll_dumb_indices,
    free_index,
    dumb_index,
    gensym,
    voigt_id,
    inverse_voigt_id,
)
from .registry import (
    VariableRegistry,
    INTERNAL_VAR,
    EXTERNAL_VAR,
    CONTROLPOINT_VAR,
    GLOBAL_VAR,
    INTEGRATION_POINT_VAR,
    SYMMETRIC_TENSOR,
)
from .simplify import (simplify_common, replace_special_terms,
                       unroll_and_simplify, register_rule,
                       unregister_rule, registered_rules)
from .tensor_table import TensorTable
from .diff import (
    diff_time,
    diff_space,
    diff_variation,
    diff_symbol,
    collect_variations,
    register_diff_rule,
    DIFF_RULES,
)
from .weakform import build_weakform, BilinearForm
from .api import (Expr, SymRef, index, indices, Bilinear, fn, log, ifelse,
                  d, as_term, word_to_sym, word_total_sym, word_local_sym,
                  word_base_sym)
from .visualize import visualize
