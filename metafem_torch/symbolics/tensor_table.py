"""Definition database + derivative-tensor cache.

Mirrors the reference's ``TensorTable`` / ``PhysicalTensor`` machinery
(symbolics/08_Tensor.jl): user definitions (``@Def`` analog) are stored as
(free index list, term); indexed instances and time/space/symbol-derivative
variants are built lazily and cached.  Owned by the FEM_Domain (no module
globals, unlike the reference's DEFINITION_TABLE).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from .ir import (GroundTerm, Term, Word, gensym, reindex, substitute)
from .registry import (EXTERNAL_VAR, INTERNAL_VAR, SYMMETRIC_TENSOR,
                       VariableRegistry)
from .simplify import replace_special_terms, simplify_common, unroll_and_simplify

TensorInfo = Tuple[str, int, int, int]  # (base sym, n_components, td, n_sd)


@dataclasses.dataclass
class PhysicalTensor:
    info: TensorInfo
    definition: GroundTerm
    free_index: List[str]
    indexed_instances: Dict[Tuple, GroundTerm]


class TensorTable:
    def __init__(self, dim: int, registry: VariableRegistry):
        self.dim = dim
        self.registry = registry
        self.definitions: Dict[str, Tuple[Tuple[str, ...], GroundTerm]] = {}
        self.tensors: Dict[TensorInfo, PhysicalTensor] = {}
        self.diff_tensors: Dict[Tuple[TensorInfo, TensorInfo], TensorInfo] = {}

    # -- declaration -------------------------------------------------------
    def define(self, name: str, free_ids: Sequence[str], term: GroundTerm):
        """The @Def analog (symbolics/10_WeakForm.jl:20-39)."""
        from .ir import free_index
        term = simplify_common(term)
        fset = free_index(term)
        if set(fset) != set(free_ids):
            raise ValueError(
                f"free indices must match declaration: {list(free_ids)} vs "
                f"{list(fset)} in definition of {name!r}")
        self.definitions[name] = (tuple(free_ids), term)
        # invalidate caches built from older definitions of the same name
        self.tensors = {k: v for k, v in self.tensors.items() if k[0] != name}

    def define_raw(self, name: str, free_ids: Sequence[str],
                   term: GroundTerm) -> None:
        """Store a definition without the free-index check — used for
        multi-output integration-point variables whose RHS is a user
        function returning all components at once (the reference's
        tuple-assignment protocol, symbolics/08_Tensor.jl:169-186)."""
        self.definitions[name] = (tuple(free_ids), simplify_common(term))
        self.tensors = {k: v for k, v in self.tensors.items() if k[0] != name}

    # -- info/word helpers --------------------------------------------------
    @staticmethod
    def word_to_info(w: Word) -> TensorInfo:
        return (w.base, len(w.c_ids), w.td, len(w.sd_ids))

    def info_to_word(self, info: TensorInfo, ids: Sequence) -> Word:
        sym, n_c, td, n_sd = info
        return Word(sym, td, tuple(ids[:n_c]), tuple(ids[n_c:n_c + n_sd]),
                    symmetric=self.registry.is_symmetric(sym))

    # -- tensor construction -------------------------------------------------
    def get_tensor(self, info: TensorInfo) -> PhysicalTensor:
        t = self.tensors.get(info)
        if t is None:
            t = self.tensors[info] = self._build_tensor(info)
        return t

    def _build_tensor(self, info: TensorInfo) -> PhysicalTensor:
        sym, n_c, td, n_sd = info
        if td > 0:
            from .diff import diff_time
            base = self.get_tensor((sym, n_c, td - 1, n_sd))
            target_def = diff_time(base.definition, self)
            target_ids = list(base.free_index)
        elif n_sd > 0:
            from .diff import diff_space
            base = self.get_tensor((sym, n_c, td, n_sd - 1))
            ph = gensym()
            target_def = diff_space(base.definition, ph, self)
            target_ids, target_def = reindex(target_def,
                                             list(base.free_index) + [ph])
        else:
            if sym not in self.definitions:
                raise KeyError(
                    f"{sym!r} is not declared (neither a field variable nor "
                    f"a definition)")
            raw_ids, raw_def = self.definitions[sym]
            target_def = self.inline_tensor_diff(
                unroll_and_simplify(raw_def, self.dim))
            target_ids = list(raw_ids)
        return self._construct_tensor(info, target_ids, target_def)

    def _construct_tensor(self, info: TensorInfo, declared_ids: List[str],
                          definition: GroundTerm) -> PhysicalTensor:
        from .ir import free_index
        fset = free_index(definition)
        if set(fset) != set(declared_ids):
            raise ValueError(
                f"free indices must match: {declared_ids} vs {list(fset)}")
        ids, definition = reindex(definition, declared_ids)
        if len(ids) == 2:
            swapped = substitute(definition, list(ids), list(reversed(ids)))
            if swapped == definition:
                self.registry.add_attribute(info[0], SYMMETRIC_TENSOR)
        return PhysicalTensor(info, definition, list(ids), {})

    # -- evaluation ----------------------------------------------------------
    def evaluate_tensor(self, w: Word) -> GroundTerm:
        """Indexed instance of a definition variable
        (symbolics/08_Tensor.jl:52-62)."""
        tensor = self.get_tensor(self.word_to_info(w))
        target_ids = (*w.c_ids, *w.sd_ids)
        if not target_ids or list(target_ids) == tensor.free_index:
            return tensor.definition
        inst = tensor.indexed_instances.get(target_ids)
        if inst is None:
            inst = self.inline_tensor_diff(replace_special_terms(
                substitute(tensor.definition, tensor.free_index,
                           list(target_ids))))
            tensor.indexed_instances[target_ids] = inst
        return inst

    # -- named symbolic derivatives d(W, F{i,j}) -----------------------------
    def inline_tensor_diff(self, t: GroundTerm) -> GroundTerm:
        return simplify_common(self._inline(t)[1])

    def _inline(self, t: GroundTerm):
        if isinstance(t, (int, float)):
            return False, t
        if isinstance(t, Word):
            a = self.registry.attributes(t.base)
            if INTERNAL_VAR in a or EXTERNAL_VAR in a:
                return False, t
            local_def = self.evaluate_tensor(t)
            if isinstance(local_def, (int, float)):
                return True, local_def
            return False, t
        if t.op == "d":
            from .diff import diff_symbol
            if len(t.subterms) != 2 or not isinstance(t.subterms[1], Word):
                raise ValueError("d(expr, word) expects a word to diff by")
            return True, diff_symbol(self.inline_tensor_diff(t.subterms[0]),
                                     self, t.subterms[1])
        changed, subs = False, []
        for s in t.subterms:
            c, s2 = self._inline(s)
            changed |= c
            subs.append(s2)
        if changed:
            from .ir import construct_term
            return True, construct_term(t.op, subs)
        return False, t

    def get_tensor_diff(self, src_info: TensorInfo,
                        diff_info: TensorInfo) -> TensorInfo:
        pair = (src_info, diff_info)
        got = self.diff_tensors.get(pair)
        if got is None:
            got = self.diff_tensors[pair] = self._construct_tensor_diff(
                src_info, diff_info)
        return got

    def _construct_tensor_diff(self, src_info: TensorInfo,
                               diff_info: TensorInfo) -> TensorInfo:
        from .diff import diff_symbol
        src_dof = src_info[1] + src_info[3]
        diff_dof = diff_info[1] + diff_info[3]
        name = (f"D_{src_info[0]}__{diff_info[0]}"
                f"_{diff_info[1]}_{diff_info[2]}_{diff_info[3]}")
        target_info: TensorInfo = (name, src_dof + diff_dof, 0, 0)

        src_tensor = self.get_tensor(src_info)
        diff_ids = [gensym() for _ in range(diff_dof)]
        diff_word = self.info_to_word(diff_info, diff_ids)
        target_ids = list(src_tensor.free_index) + diff_ids
        target_def = diff_symbol(src_tensor.definition, self, diff_word)
        self.tensors[target_info] = self._construct_tensor(
            target_info, target_ids, target_def)
        return target_info

    # -- single-use inlining for lowering (symbolics/08_Tensor.jl:124-147) ---
    def count_words(self, t: GroundTerm) -> int:
        if isinstance(t, (int, float)):
            return 0
        if isinstance(t, Word):
            return 1
        return sum(self.count_words(s) for s in t.subterms)

    def propagate_symbol(self, t: GroundTerm) -> GroundTerm:
        return simplify_common(self._propagate(t)[1])

    def _propagate(self, t: GroundTerm):
        if isinstance(t, (int, float)):
            return False, t
        if isinstance(t, Word):
            a = self.registry.attributes(t.base)
            if INTERNAL_VAR in a or EXTERNAL_VAR in a:
                return False, t
            local_def = self.evaluate_tensor(t)
            if isinstance(local_def, Term) and self.count_words(local_def) > 1:
                return False, t
            return True, self.propagate_symbol(local_def)
        changed, subs = False, []
        for s in t.subterms:
            c, s2 = self._propagate(s)
            changed |= c
            subs.append(s2)
        if changed:
            from .ir import construct_term
            return True, construct_term(t.op, subs)
        return False, t
