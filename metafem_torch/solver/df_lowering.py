"""Two-float (double-f32) assembly lowering: residual evaluation of any
weak form with ~48-bit values, in float32 words.

Port of ``metafem/solver/df_lowering.py``.  The refined Newton step in
its ``df32`` residual mode (``jit_step.make_refined_step``) evaluates
the residues of *nonaffine volume* forms (the cavity's u.grad(u)
convection, a T-dependent conductivity, J2's return map) at every
refine.  In that mode:

* every gathered variable, geometry table and intermediate is an (hi,
  lo) float32 pair (``twofloat.DF``);
* the gather-to-quadrature and test-function contractions are
  dot2-compensated loops (``twofloat.df_dot2``), never ``einsum``,
  which could contract the error-free transforms;
* +, *, integer ^ and / run in DF; comparisons compare float64 values;
  ``ifelse`` selects both words; transcendentals, non-integer powers
  and user callbacks (``user=`` included) run in float64 on the
  quadrature-point arrays [B, nq] and are split back;
* the reduction to the global residual stays exact
  (``assembly._reduce_df``): lattice placement moves values without
  rounding and every accumulation is a df_add or a two_sum-compensated
  gather sum.

On the card float64 is native, so the port's default residual mode is
float64; this module exists so that the two-float mode, the reference's
production mode on its TPU, runs on the card too.
"""

from __future__ import annotations

import inspect
from typing import Dict, List

import torch

from ..elements.discretization import sd_ids_to_mode
from ..linsolve import twofloat as tf
from ..linsolve.twofloat import DF
from ..symbolics.registry import (CONTROLPOINT_VAR, GLOBAL_VAR,
                                  INTEGRATION_POINT_VAR)
from .lattice_reduce import gather_lattice_nodes
from .lowering import LoweringContext, _BUILTIN_FNS

#: comparisons, taken on float64 values (selection only)
_DF_CMP = {"lt": lambda a, b: a < b, "gt": lambda a, b: a > b,
           "le": lambda a, b: a <= b, "ge": lambda a, b: a >= b}


def df_index(x: DF, idx) -> DF:
    """x[..., idx] of both words."""
    return DF(x.hi[..., idx], x.lo[..., idx])


def df_einsum_bqa_ba(T: DF, V: DF) -> DF:
    """sum_a T[b, q, a] * V[b, a] -> [b, q], dot2-compensated (the
    gather-to-quadrature contraction of ``assembly._build_env``)."""
    na = T.hi.shape[-1]
    return tf.df_dot2(
        (df_index(T, a), DF(V.hi[:, None, a], V.lo[:, None, a]))
        for a in range(na))


def df_einsum_bqa_bq(T: DF, V: DF) -> DF:
    """sum_q T[b, q, a] * V[b, q] -> [b, a], dot2-compensated (the
    test-function contraction of ``assembly._assemble_part``)."""
    nq = T.hi.shape[1]
    return tf.df_dot2(
        (DF(T.hi[:, q, :], T.lo[:, q, :]),
         DF(V.hi[:, q, None], V.lo[:, q, None]))
        for q in range(nq))


def df_gather(vec: DF, idx) -> DF:
    return DF(vec.hi[idx], vec.lo[idx])


def build_env_df(tb, wp_state: dict, part_state: dict, cw,
                 inner_infos, exter_infos, x_star: DF, t, dt,
                 global_vars: dict, is_boundary: bool,
                 gather_fast=None) -> Dict[str, object]:
    """DF mirror of ``assembly._build_env``: every entry is a DF pair.
    ``part_state`` holds DF geometry tables (itg_vals, weights, normals)
    and the int64 el_cp; ``x_star`` is a DF of [levels, n] words."""
    env: Dict[str, object] = {}
    itg_vals: DF = part_state["itg_vals"]
    el_cp = part_state["el_cp"]
    disc, info, la = cw.disc, cw.info, cw.la
    dev = x_star.hi.device

    def node_vals(vec: DF, block_base) -> DF:
        """vec[block_base + el_cp] as [B, na] of both words."""
        if gather_fast is not None:
            sl = slice(block_base, block_base + info.n_cp)
            return DF(gather_lattice_nodes(vec.hi[sl], gather_fast),
                      gather_lattice_nodes(vec.lo[sl], gather_fast))
        return df_gather(vec, el_cp + block_base if block_base else el_cp)

    for (sym, td, sd_ids, pos) in inner_infos:
        if len(sd_ids) > la.max_sd_order:
            env[sym] = 0.0
            continue
        m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
        nodes = node_vals(DF(x_star.hi[td], x_star.lo[td]),
                          info.dof_offset + pos * info.n_cp)
        env[sym] = df_einsum_bqa_ba(df_index(itg_vals, m), nodes)

    for (sym, local_sym, base, sd_ids, c_ids) in exter_infos:
        attrs = tb.registry.attributes(base)
        if GLOBAL_VAR in attrs:
            if base == "t":
                env[sym] = tf.as_df(t, dev)
            elif base == "dt":
                env[sym] = tf.as_df(dt, dev)
            elif sym in global_vars:
                env[sym] = tf.as_df(global_vars[sym], dev)
            else:
                raise KeyError(f"global variable {sym!r} has no value")
        elif CONTROLPOINT_VAR in attrs:
            if len(sd_ids) > la.max_sd_order:
                env[sym] = 0.0
                continue
            m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
            col: DF = wp_state["fields"][local_sym]
            env[sym] = df_einsum_bqa_ba(df_index(itg_vals, m),
                                        node_vals(col, 0))
        elif INTEGRATION_POINT_VAR in attrs and base == "n":
            if not is_boundary:
                raise ValueError("the normal n{i} only exists on "
                                 "boundaries")
            env[sym] = df_index(part_state["normals"], c_ids[0] - 1)
        else:
            raise ValueError(f"unresolved external variable {sym!r}")
    return env


class DFLoweringContext(LoweringContext):
    """LoweringContext whose values are DF pairs (or Python numbers for
    constants, whose words go to ``device``).  +, *, integer ^ and / run
    in DF; comparisons compare float64 values; everything else (powers
    with non-integer exponents, transcendentals, user callbacks) runs in
    float64 on the quadrature-point arrays and is split back."""

    def __init__(self, tb, env, functions=None, user_state=None,
                 device="cpu"):
        super().__init__(tb, env, functions, user_state=user_state)
        self.device = device

    def _df(self, v) -> DF:
        return tf.as_df(v, self.device)

    def _lower_term(self, t):
        if t.op == "+":
            acc = self._df(self.lower(t.subterms[0]))
            for s in t.subterms[1:]:
                acc = tf.df_add(acc, self._df(self.lower(s)))
            return acc
        if t.op == "*":
            acc = self._df(self.lower(t.subterms[0]))
            for s in t.subterms[1:]:
                acc = tf.df_mul(acc, self._df(self.lower(s)))
            return acc
        if t.op == "^":
            b = self._df(self.lower(t.subterms[0]))
            e = self.lower(t.subterms[1])
            if isinstance(e, float) and e == round(e):
                n = int(e)
                if n < 0:
                    return tf.df_div(self._df(1.0), self._df_int_pow(b, -n))
                if n == 0:
                    return 1.0
                return self._df_int_pow(b, n)
            return self._fallback(lambda bb, ee: bb ** ee, [b, e])
        args = [self.lower(s) for s in t.subterms]
        if t.op == "ifelse":
            c, a, b = args
            a, b = self._df(a), self._df(b)
            cond = c.hi if isinstance(c, DF) else c
            return DF(torch.where(cond, a.hi, b.hi),
                      torch.where(cond, a.lo, b.lo))
        cmp = _DF_CMP.get(t.op)
        if cmp is not None:
            a, b = (tf.df_to_f64(v) if isinstance(v, DF) else v
                    for v in args)
            return cmp(a, b)
        fn = self.functions.get(t.op)
        if fn is not None:
            if "user" in inspect.signature(fn).parameters:
                return self._fallback(
                    lambda *aa: fn(*aa, user=self.user_state), args)
            return self._fallback(fn, args)
        fn = _BUILTIN_FNS.get(t.op)
        if fn is None:
            raise ValueError(f"unknown function {t.op!r} in weak form; "
                             f"register it via "
                             f"FEM_Domain.register_function")
        return self._fallback(fn, args)

    @staticmethod
    def _df_int_pow(b: DF, n: int) -> DF:
        acc = b
        for _ in range(n - 1):
            acc = tf.df_mul(acc, b)
        return acc

    def _fallback(self, fn, args):
        """float64 evaluation of an op without a DF form.  A user callback
        behind a multi-component integration-point variable (J2's Voigt
        plastic strain) returns a tuple of components; each is split back
        to a DF pair (booleans pass through)."""
        out = fn(*(tf.df_to_f64(a) if isinstance(a, DF) else a
                   for a in args))

        def split(o):
            o = torch.as_tensor(o, device=self.device)
            if o.dtype == torch.bool:
                return o
            return tf.df_from_f64(o)

        if isinstance(out, (tuple, list)):
            return tuple(split(o) for o in out)
        return split(out)


def assemble_part_df(tb, cw, part_state: dict, bilinears_res,
                     ctx: DFLoweringContext) -> Dict[int, DF]:
    """DF mirror of ``assembly._assemble_part``, residues only (the
    tangent needs no extended precision: it sets the convergence rate,
    not the answer): per DOF position, the [B, na] contribution pair."""
    disc, la = cw.disc, cw.la
    itg_vals: DF = part_state["itg_vals"]
    weights: DF = part_state["weights"]
    out: Dict[int, DF] = {}
    for bil in bilinears_res:
        _, _, sd_ids, pos = bil.dual_info
        if len(sd_ids) > la.max_sd_order:
            continue
        m = sd_ids_to_mode(tb.dim, sd_ids, disc.sd_modes)
        cwgt = tf.df_mul(ctx._df(ctx.lower(bil.base_term)), weights)
        contrib = df_einsum_bqa_bq(df_index(itg_vals, m), cwgt)
        prev = out.get(pos)
        out[pos] = contrib if prev is None else tf.df_add(prev, contrib)
    return out


def df_tables(wp_states: List[dict]) -> List[dict]:
    """The float64 geometry state of ``FEM_Domain._f64_tables`` split into
    DF pairs on its own device: itg_vals, weights, normals and the
    fields become DF; el_cp stays int64."""
    def part(p, boundary):
        out = {"itg_vals": tf.df_from_f64(p["itg_vals"]),
               "weights": tf.df_from_f64(p["weights"]),
               "el_cp": p["el_cp"]}
        if boundary:
            out["normals"] = tf.df_from_f64(p["normals"])
        return out

    return [{"el": None if ws["el"] is None else part(ws["el"], False),
             "bdy": {bg: [part(p, True) for p in plist]
                     for bg, plist in ws["bdy"].items()},
             "fields": {k: tf.df_from_f64(v)
                        for k, v in ws["fields"].items()}}
            for ws in wp_states]
