"""Dense bounded-variable simplex — JAX kernel (vmap/jit-able).

The device twin of solver/simplex_np.py: same algorithm (logical-variable
form, composite phase-1, Dantzig pricing with a Bland anti-cycling fallback,
largest-pivot ratio tie-break), same tolerances, expressed as a
``lax.while_loop`` over a dense tableau so that XLA can fuse the pricing
reduction, the ratio test and the rank-1 pivot update into a handful of
kernels.  All shapes are static; everything vmaps over a batch of
(c, lo, hi) triples, which is how hundreds of independent branch-and-bound
nodes / AIRA subproblems share one device.

Dtype follows the system matrix W: float64 for the exact path, float32 for
the wave backend's device waves.  Exact front parity (BASELINE.md §A) is
preserved for the f32 path by the f64 basis certificates in
solver/verify.py.  The kernel contains no ``dot``/``matmul``: every product
is an elementwise multiply and a reduction, so no float32 product can be
lowered to reduced-precision tensor-core arithmetic (TF32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from moip_aira_tpu.solver.simplex_np import (
    COST_TOL,
    FEAS_TOL,
    PIVOT_TOL,
    STALL_LIMIT,
)

# status codes (match SolveStatus ints)
OPTIMAL = 0
INFEASIBLE = 1
UNBOUNDED = 2
ITER_LIMIT = 3
RUNNING = -1

BIG = 1e30  # stand-in for +inf inside ratio arithmetic


class SimplexState(NamedTuple):
    T: jnp.ndarray  # (m, nc) tableau = B^-1 [A | -I]
    basis: jnp.ndarray  # (m,) int32 column index of each basic var
    in_basis: jnp.ndarray  # (nc,) bool
    at_upper: jnp.ndarray  # (nc,) bool (meaningful for nonbasic)
    xB: jnp.ndarray  # (m,) basic values
    phase: jnp.ndarray  # () int32
    stall: jnp.ndarray  # () int32
    last_obj: jnp.ndarray  # () f64
    it: jnp.ndarray  # () int32
    status: jnp.ndarray  # () int32


class LPOutcome(NamedTuple):
    status: jnp.ndarray  # () int32
    obj: jnp.ndarray  # () float
    x: jnp.ndarray  # (n,) structural values
    basis: jnp.ndarray  # (m,) int32 — final basis (for exact verification)
    at_upper: jnp.ndarray  # (nc,) bool — nonbasic bound statuses
    iters: jnp.ndarray  # () int32


def _nonbasic_values(at_upper, lo, hi):
    finite_lo = jnp.isfinite(lo)
    finite_hi = jnp.isfinite(hi)
    base = jnp.where(finite_lo, lo, jnp.where(finite_hi, hi, 0.0))
    return jnp.where(at_upper & finite_hi, hi, base)


def make_lp_solver(
    W: jnp.ndarray,
    max_iters: int,
    feas_tol: float = FEAS_TOL,
    cost_tol: float = COST_TOL,
    pivot_tol: float = PIVOT_TOL,
    progress_tol: float = 1e-12,
    stall_limit: int = STALL_LIMIT,
):
    """Build an LP solver closed over the static system matrix W = [A|-I].

    Returns solve(c_full, lo, hi) -> LPOutcome, pure and vmap-able.
    c_full has length nc (structural costs then zeros).  Works in W's dtype:
    float64 for the exact path, float32 for the wave backend (whose results
    are then certified in f64 by solver/verify.py).
    """
    m, nc = W.shape
    n = nc - m
    FEAS_TOL = feas_tol
    COST_TOL = cost_tol
    PIVOT_TOL = pivot_tol
    T0 = -W  # initial tableau for the logical basis B = -I
    basis0 = jnp.arange(n, n + m, dtype=jnp.int32)
    in_basis0 = jnp.concatenate(
        [jnp.zeros(n, dtype=bool), jnp.ones(m, dtype=bool)]
    )
    col_ids = jnp.arange(nc, dtype=jnp.int32)

    def solve(c_full, lo, hi):
        finite_lo = jnp.isfinite(lo)
        finite_hi = jnp.isfinite(hi)
        empty_box = jnp.any(lo > hi + FEAS_TOL)

        at_upper0 = jnp.concatenate(
            [~finite_lo[:n] & finite_hi[:n], jnp.zeros(m, dtype=bool)]
        )
        z0 = _nonbasic_values(at_upper0, lo, hi)
        xB0 = -(T0 * jnp.where(in_basis0, 0.0, z0)[None, :]).sum(axis=1)

        st0 = SimplexState(
            T=T0,
            basis=basis0,
            in_basis=in_basis0,
            at_upper=at_upper0,
            xB=xB0,
            phase=jnp.int32(1),
            stall=jnp.int32(0),
            last_obj=jnp.asarray(jnp.inf, dtype=W.dtype),
            it=jnp.int32(0),
            status=jnp.where(empty_box, jnp.int32(INFEASIBLE), jnp.int32(RUNNING)),
        )

        def cond(st: SimplexState):
            return (st.status == RUNNING) & (st.it < max_iters)

        def body(st: SimplexState):
            bl = lo[st.basis]
            bh = hi[st.basis]
            below = st.xB < bl - FEAS_TOL
            above = st.xB > bh + FEAS_TOL
            infeas_sum = jnp.sum(jnp.where(below, bl - st.xB, 0.0)) + jnp.sum(
                jnp.where(above, st.xB - bh, 0.0)
            )
            now_feasible = infeas_sum <= FEAS_TOL
            phase = jnp.where((st.phase == 1) & now_feasible, 2, st.phase)
            entered_p2 = (st.phase == 1) & now_feasible
            stall = jnp.where(entered_p2, 0, st.stall)
            last_obj = jnp.where(entered_p2, jnp.inf, st.last_obj)

            cB = jnp.where(
                phase == 1,
                jnp.where(below, -1.0, jnp.where(above, 1.0, 0.0)),
                c_full[st.basis],
            )
            zv = _nonbasic_values(st.at_upper, lo, hi)
            # NOTE: explicit reduction, NOT a matvec — a float32 dot may be
            # lowered to TF32 (about three decimal digits), and ~1e-2
            # reduced-cost noise makes the pricing loop cycle.
            d_raw = -jnp.sum(cB[:, None] * st.T, axis=0)
            d = jnp.where(phase == 1, d_raw, c_full + d_raw)
            cur_obj = jnp.where(
                phase == 1,
                infeas_sum,
                (c_full[st.basis] * st.xB).sum()
                + jnp.where(st.in_basis, 0.0, c_full * zv).sum(),
            )

            nb = ~st.in_basis
            free = nb & ~finite_lo & ~finite_hi
            can_up = nb & (~st.at_upper | free) & (d < -COST_TOL)
            can_dn = nb & (st.at_upper | free) & (d > COST_TOL)
            eligible = can_up | can_dn
            any_elig = eligible.any()

            # entering column: Dantzig (max |d|), Bland after a stall
            bland = st.stall >= stall_limit
            score_dantzig = jnp.where(eligible, jnp.abs(d), -1.0)
            score_bland = jnp.where(eligible, -col_ids.astype(W.dtype), -BIG)
            q = jnp.argmax(jnp.where(bland, score_bland, score_dantzig)).astype(
                jnp.int32
            )
            sigma = jnp.where(can_up[q], 1.0, -1.0)
            alpha = st.T[:, q]
            eta = -sigma * alpha

            # --- ratio test ----------------------------------------------
            # entering variable bound flip
            flip_theta = jnp.where(
                finite_lo[q] & finite_hi[q], hi[q] - lo[q], jnp.inf
            )
            feas_b = ~below & ~above
            moving = jnp.abs(eta) > PIVOT_TOL
            bl_s = jnp.where(jnp.isfinite(bl), bl, -BIG)
            bh_s = jnp.where(jnp.isfinite(bh), bh, BIG)
            r_dn = (st.xB - bl_s) / jnp.where(eta < 0, -eta, 1.0)
            r_up = (bh_s - st.xB) / jnp.where(eta > 0, eta, 1.0)
            ratios = jnp.full((m,), jnp.inf, dtype=W.dtype)
            hits_upper = jnp.zeros((m,), dtype=bool)
            c1 = moving & feas_b & (eta < 0) & jnp.isfinite(bl)
            ratios = jnp.where(c1, r_dn, ratios)
            c2 = moving & feas_b & (eta > 0) & jnp.isfinite(bh)
            ratios = jnp.where(c2, r_up, ratios)
            hits_upper = hits_upper | c2
            c3 = moving & below & (eta > 0)
            r3 = (bl - st.xB) / jnp.where(eta > 0, eta, 1.0)
            ratios = jnp.where(c3, r3, ratios)
            c4 = moving & above & (eta < 0)
            r4 = (st.xB - bh) / jnp.where(eta < 0, -eta, 1.0)
            ratios = jnp.where(c4, r4, ratios)
            hits_upper = hits_upper | c4
            ratios = jnp.maximum(ratios, 0.0)

            rmin = ratios.min()
            tied = ratios <= rmin + FEAS_TOL
            # tie-break: largest |eta| (Bland: smallest basis index)
            pick_score = jnp.where(tied, jnp.abs(eta), -1.0)
            pick_bland = jnp.where(tied, -st.basis.astype(W.dtype), -BIG)
            r_pick = jnp.argmax(jnp.where(bland, pick_bland, pick_score)).astype(
                jnp.int32
            )
            row_blocks = rmin < flip_theta
            theta = jnp.where(row_blocks, ratios[r_pick], flip_theta)
            unbounded = ~jnp.isfinite(theta)

            # --- step (flip and pivot both computed, selected by mask —
            # cheaper to compile and uniform under vmap than lax.cond) -----
            xB_new = st.xB + eta * theta
            status = jnp.where(
                ~any_elig,
                jnp.where(phase == 1, INFEASIBLE, OPTIMAL),
                jnp.where(unbounded,
                          jnp.where(phase == 1, INFEASIBLE, UNBOUNDED),
                          RUNNING),
            ).astype(jnp.int32)
            do_pivot = (status == RUNNING) & row_blocks
            do_flip = (status == RUNNING) & ~row_blocks

            p_col = st.basis[r_pick]
            leave_up = hits_upper[r_pick]
            at_upper = st.at_upper
            at_upper = at_upper.at[q].set(
                jnp.where(do_flip, ~at_upper[q], at_upper[q])
            )
            at_upper = at_upper.at[p_col].set(
                jnp.where(do_pivot, leave_up, at_upper[p_col])
            )
            in_b = st.in_basis
            in_b = in_b.at[p_col].set(jnp.where(do_pivot, False, in_b[p_col]))
            in_b = in_b.at[q].set(jnp.where(do_pivot, True, in_b[q]))

            start = jnp.where(finite_lo[q] | finite_hi[q], zv[q], 0.0)
            newval = start + sigma * theta
            piv = st.T[r_pick, q]
            row = st.T[r_pick, :] / jnp.where(jnp.abs(piv) > 0, piv, 1.0)
            colv = st.T[:, q].at[r_pick].set(0.0)
            T_piv = (st.T - jnp.outer(colv, row)).at[r_pick, :].set(row)
            T = jnp.where(do_pivot, T_piv, st.T)
            basis = st.basis.at[r_pick].set(
                jnp.where(do_pivot, q, st.basis[r_pick])
            )
            xB2 = jnp.where(
                do_pivot | do_flip,
                xB_new.at[r_pick].set(jnp.where(do_pivot, newval, xB_new[r_pick])),
                st.xB,
            )

            # watermark stall detection: only a *material* improvement of
            # the best objective seen resets the counter (f32 noise must not)
            progressed = cur_obj < last_obj - progress_tol
            new_stall = jnp.where(progressed, 0, stall + 1)
            new_last = jnp.minimum(last_obj, cur_obj)

            return SimplexState(
                T=T,
                basis=basis,
                in_basis=in_b,
                at_upper=at_upper,
                xB=xB2,
                phase=jnp.int32(phase),
                stall=jnp.int32(new_stall),
                last_obj=new_last,
                it=st.it + 1,
                status=status,
            )

        final = jax.lax.while_loop(cond, body, st0)
        status = jnp.where(
            final.status == RUNNING, jnp.int32(ITER_LIMIT), final.status
        )
        zv = _nonbasic_values(final.at_upper, lo, hi)
        z = jnp.where(final.in_basis, 0.0, zv)
        z = z.at[final.basis].set(final.xB)
        obj = (c_full * z).sum()
        return LPOutcome(
            status=status,
            obj=obj,
            x=z[:n],
            basis=final.basis,
            at_upper=final.at_upper,
            iters=final.it,
        )

    return solve
