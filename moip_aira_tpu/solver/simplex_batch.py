"""Batched exact (f64) bounded-variable revised simplex — host, lockstep.

The wave backend re-solves on the host every device lane whose f64
certificate fails (solver/wave.py).  One `simplex_np.solve_lp` call per
lane is a per-pivot Python loop over (m, n+2m) arrays, so a wave with many
failed lanes would leave the device idle while the host crawls.

This module solves S such LPs AT ONCE: one lockstep iteration advances
every live lane with whole-batch NumPy ops (one (S,m)x(m,nc) GEMM prices
every lane's reduced costs; basis inverses update by batched rank-1), and
the working set is physically COMPACTED whenever at least half its lanes
have finished, so the lockstep tail never pays full-batch elementwise cost.
The algorithm, tolerances and — critically — the EXACTNESS RULES are the
same as `simplex_np.solve_lp` (the sequential oracle, which remains the
ground-truth court):

* all arithmetic is float64; all data in the target problems is integer,
  so 1e-7/1e-9 tolerances recover exact optima from non-drifted state;
* terminal claims (OPTIMAL / INFEASIBLE / UNBOUNDED) are only accepted
  from a FRESHLY REFACTORED basis inverse — a lane whose claim arises from
  rank-1-updated state is refactored and made to re-derive the claim from
  exact data (the simplex_np defence against tableau rot, kept verbatim);
* warm bases are validated (in-range, duplicate-free, nonsingular) and
  must beat the cold logical basis on initial infeasibility to be used;
* degenerate cycling is broken by Bland's rule after a stall, per lane.

Replaces the same reference hot path as simplex_np: the LP relaxations
inside CPXmipopt (reference src/aira.cpp:480-487) — CPLEX performs
this exact-resolution role internally; here it is the f64 court for the
speculative f32 device kernels.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from moip_aira_tpu.solver.simplex_np import (
    FEAS_TOL,
    COST_TOL,
    PIVOT_TOL,
    STALL_LIMIT,
    LPResult,
    SimplexWorkspace,
)
from moip_aira_tpu.solver.status import SolveStatus

REFACTOR_EVERY = 96  # batched inverses are cheap; refactor often

# internal lane states
_RUN = 0
_OPT = 1
_INF = 2
_UNB = 3
_ITL = 4

_STATUS_MAP = {
    _OPT: SolveStatus.OPTIMAL,
    _INF: SolveStatus.INFEASIBLE,
    _UNB: SolveStatus.UNBOUNDED,
    _ITL: SolveStatus.ITERATION_LIMIT,
}


def _batch_inv(Bmats: np.ndarray):
    """Batched inverse; returns (inv, ok_mask).  Singular lanes get junk
    rows and ok=False (the caller cold-starts or fails them)."""
    s = Bmats.shape[0]
    try:
        inv = np.linalg.inv(Bmats)
        ok = np.isfinite(inv).all(axis=(1, 2))
        return inv, ok
    except np.linalg.LinAlgError:
        out = np.zeros_like(Bmats)
        ok = np.zeros(s, dtype=bool)
        for i in range(s):
            try:
                out[i] = np.linalg.inv(Bmats[i])
                ok[i] = np.isfinite(out[i]).all()
            except np.linalg.LinAlgError:
                pass
        return out, ok


def solve_lp_batch(
    ws: SimplexWorkspace,
    c: np.ndarray,  # (S, n) structural objectives
    lo: np.ndarray,  # (S, nc)
    hi: np.ndarray,  # (S, nc)
    warm_basis: Optional[np.ndarray] = None,  # (S, m) int, row of -1 = cold
    warm_at_upper: Optional[np.ndarray] = None,  # (S, nc) bool/int
    max_iters: int = 20000,
) -> List[LPResult]:
    """Minimise c[i] @ x s.t. [A|-I] z = 0, lo[i] <= z <= hi[i], for all i.

    Returns one `simplex_np.LPResult` per lane (same contract: d/at_upper/
    in_basis populated on OPTIMAL for reduced-cost fixing and child warm
    starts).  Exactness: see module docstring.
    """
    m, nc, n = ws.m, ws.ncols, ws.n
    W = ws.W  # (m, nc)
    S = c.shape[0]
    if S == 0:
        return []
    lo_full = np.asarray(lo, dtype=np.float64)
    hi_full = np.asarray(hi, dtype=np.float64)
    cz_full = np.zeros((S, nc))
    cz_full[:, :n] = c

    # ---- outputs (written at finalisation, indexed by original lane) ------
    out_stat = np.full(S, _ITL, dtype=np.int32)
    out_obj = np.full(S, np.nan)
    out_x = np.zeros((S, n))
    out_d = np.zeros((S, nc))
    out_atup = np.zeros((S, nc), dtype=bool)
    out_inb = np.zeros((S, nc), dtype=bool)

    flo_full = np.isfinite(lo_full)
    fhi_full = np.isfinite(hi_full)

    # empty boxes are infeasible outright (exact comparison on input data)
    empty = (lo_full > hi_full + FEAS_TOL).any(axis=1)
    out_stat[empty] = _INF
    oid = np.flatnonzero(~empty)  # compacted position -> original lane
    if oid.size == 0:
        return _emit(out_stat, out_obj, out_x, out_d, out_atup, out_inb)

    # ---- compacted working arrays -----------------------------------------
    lo_a = lo_full[oid]
    hi_a = hi_full[oid]
    cz_a = cz_full[oid]
    flo = flo_full[oid]
    fhi = fhi_full[oid]
    s = oid.size

    def _nonbasic_state(at_up, flo_, fhi_, lo_, hi_):
        """Repair + evaluate nonbasic statuses -> (at_upper, zvals)."""
        au = at_up & fhi_
        au = au | (~flo_ & fhi_)
        zv = np.where(au, hi_, np.where(flo_, lo_, 0.0))
        zv[~flo_ & ~fhi_] = 0.0
        return au, zv

    basis = np.broadcast_to(np.arange(n, n + m), (s, m)).copy()
    at_upper, zvals = _nonbasic_state(
        np.zeros((s, nc), dtype=bool), flo, fhi, lo_a, hi_a
    )
    BI = np.broadcast_to(-np.eye(m), (s, m, m)).copy()  # B=-I => B^-1=-I
    in_basis = np.zeros((s, nc), dtype=bool)
    np.put_along_axis(in_basis, basis, True, axis=1)
    zn = np.where(in_basis, 0.0, zvals)
    xB = np.einsum("smk,sk->sm", BI, -(zn @ W.T))

    def _infeas_of(xB_, basis_, lo_, hi_):
        bl_ = np.take_along_axis(lo_, basis_, axis=1)
        bh_ = np.take_along_axis(hi_, basis_, axis=1)
        return (
            np.maximum(bl_ - xB_, 0.0).sum(axis=1)
            + np.maximum(xB_ - bh_, 0.0).sum(axis=1)
        )

    # ---- warm bases: validate, invert, adopt where they beat cold ---------
    if warm_basis is not None:
        wb = np.asarray(warm_basis, dtype=np.int64)[oid]
        wa = (
            np.asarray(warm_at_upper, dtype=bool)[oid]
            if warm_at_upper is not None
            else np.zeros((s, nc), dtype=bool)
        )
        valid = (wb >= 0).all(axis=1) & (wb < nc).all(axis=1)
        if valid.any():
            wsort = np.sort(wb, axis=1)
            valid &= (wsort[:, 1:] != wsort[:, :-1]).all(axis=1)
        sel = np.flatnonzero(valid)
        if sel.size:
            Bm = W[:, wb[sel]].transpose(1, 0, 2)  # (v, m, m)
            BIw, okw = _batch_inv(Bm)
            sel = sel[okw]
            if sel.size:
                BIw = BIw[okw]
                au_w, zv_w = _nonbasic_state(
                    wa[sel], flo[sel], fhi[sel], lo_a[sel], hi_a[sel]
                )
                inb_w = np.zeros((sel.size, nc), dtype=bool)
                np.put_along_axis(inb_w, wb[sel], True, axis=1)
                zn = np.where(inb_w, 0.0, zv_w)
                xB_w = np.einsum("smk,sk->sm", BIw, -(zn @ W.T))
                inf_w = _infeas_of(xB_w, wb[sel], lo_a[sel], hi_a[sel])
                inf_c = _infeas_of(xB[sel], basis[sel], lo_a[sel], hi_a[sel])
                better = inf_w < inf_c
                adopt = sel[better]
                if adopt.size:
                    basis[adopt] = wb[adopt]
                    BI[adopt] = BIw[better]
                    xB[adopt] = xB_w[better]
                    at_upper[adopt] = au_w[better]
                    zvals[adopt] = zv_w[better]
                    in_basis[adopt] = inb_w[better]

    live = np.ones(s, dtype=bool)
    since_ref = np.zeros(s, dtype=np.int64)
    stall = np.zeros(s, dtype=np.int64)
    last_obj = np.full(s, np.inf)
    col_ids = np.arange(nc)

    def _refactor(rows: np.ndarray):
        """Exact BI + xB for compacted rows; singular (impossible from
        valid pivots; guard) lanes finalise as iteration trouble."""
        nonlocal live
        if rows.size == 0:
            return
        Bm = W[:, basis[rows]].transpose(1, 0, 2)
        BIn, okr = _batch_inv(Bm)
        good = rows[okr]
        BI[good] = BIn[okr]
        zn_ = np.where(in_basis[good], 0.0, zvals[good])
        xB[good] = np.einsum("smk,sk->sm", BI[good], -(zn_ @ W.T))
        since_ref[good] = 0
        bad = rows[~okr]
        if bad.size:
            out_stat[oid[bad]] = _ITL
            live[bad] = False

    def _finalize(rows: np.ndarray, code: int, phase1_rows: np.ndarray):
        """Write outputs for compacted rows claiming a terminal state."""
        nonlocal live
        if rows.size == 0:
            return
        codes = np.where(phase1_rows, _INF, code)
        out_stat[oid[rows]] = codes
        live[rows] = False
        optr = rows[codes == _OPT]
        if optr.size:
            z = zvals[optr].copy()
            np.put_along_axis(z, basis[optr], xB[optr], axis=1)
            g = oid[optr]
            out_obj[g] = (cz_a[optr] * z).sum(axis=1)
            out_x[g] = z[:, :n]
            cBo = np.take_along_axis(cz_a[optr], basis[optr], axis=1)
            yo = np.einsum("sm,smk->sk", cBo, BI[optr])
            out_d[g] = cz_a[optr] - yo @ W
            out_atup[g] = at_upper[optr]
            out_inb[g] = in_basis[optr]
        unbr = rows[codes == _UNB]
        if unbr.size:
            out_obj[oid[unbr]] = -np.inf

    for _it in range(max_iters):
        if not live.any():
            break
        # ---- compaction: drop finished lanes once they are the majority ---
        nlive = int(live.sum())
        if nlive * 2 <= s:
            keep = live
            oid = oid[keep]
            lo_a, hi_a, cz_a = lo_a[keep], hi_a[keep], cz_a[keep]
            flo, fhi = flo[keep], fhi[keep]
            basis, in_basis = basis[keep], in_basis[keep]
            at_upper, zvals = at_upper[keep], zvals[keep]
            BI, xB = BI[keep], xB[keep]
            since_ref, stall = since_ref[keep], stall[keep]
            last_obj = last_obj[keep]
            live = np.ones(nlive, dtype=bool)
            s = nlive

        # periodic refactor (exactness defence: discard rank-1 drift)
        _refactor(np.flatnonzero(live & (since_ref >= REFACTOR_EVERY)))

        bl = np.take_along_axis(lo_a, basis, axis=1)
        bh = np.take_along_axis(hi_a, basis, axis=1)
        below = xB < bl - FEAS_TOL
        above = xB > bh + FEAS_TOL
        infsum = (
            np.where(below, bl - xB, 0.0).sum(axis=1)
            + np.where(above, xB - bh, 0.0).sum(axis=1)
        )
        phase1 = infsum > FEAS_TOL

        czB = np.take_along_axis(cz_a, basis, axis=1)
        cB = np.where(
            phase1[:, None], np.where(below, -1.0, np.where(above, 1.0, 0.0)),
            czB,
        )
        # objective at the CURRENT basis (stall detection, pre-step)
        cur_obj = np.where(
            phase1,
            infsum,
            (czB * xB).sum(axis=1)
            + (np.where(in_basis, 0.0, zvals) * cz_a).sum(axis=1),
        )
        y = np.einsum("sm,smk->sk", cB, BI)  # y = cB B^-1
        d = -(y @ W)
        d = np.where(phase1[:, None], d, d + cz_a)

        nb = ~in_basis
        free = nb & ~flo & ~fhi
        can_up = nb & ((~at_upper) | free) & (d < -COST_TOL)
        can_dn = nb & (at_upper | free) & (d > COST_TOL)
        eligible = can_up | can_dn
        any_elig = eligible.any(axis=1)

        # ---- terminal claims (no eligible column), refactor-verified ------
        claim = live & ~any_elig
        if claim.any():
            rows = np.flatnonzero(claim)
            fresh = since_ref[rows] == 0
            _finalize(rows[fresh], _OPT, phase1[rows[fresh]])
            _refactor(rows[~fresh])  # stale: re-derive from exact data

        step = live & any_elig
        if not step.any():
            continue

        # entering column: Dantzig (max |d|) or Bland (first eligible)
        bland = stall >= STALL_LIMIT
        scores = np.where(eligible, np.abs(d), -1.0)
        q_dtz = scores.argmax(axis=1)
        q_bld = np.where(eligible, col_ids[None, :], nc).min(axis=1)
        q = np.where(bland, np.minimum(q_bld, nc - 1), q_dtz)
        rows_all = np.arange(s)
        sigma = np.where(can_up[rows_all, q], 1.0, -1.0)

        alpha = np.einsum("smk,sk->sm", BI, W[:, q].T)
        eta = -sigma[:, None] * alpha

        # ---- ratio test -----------------------------------------------------
        lo_q = lo_a[rows_all, q]
        hi_q = hi_a[rows_all, q]
        theta_flip = np.where(
            np.isfinite(lo_q) & np.isfinite(hi_q), hi_q - lo_q, np.inf
        )
        moving = np.abs(eta) > PIVOT_TOL
        feas_b = ~below & ~above
        fin_bl = np.isfinite(bl)
        fin_bh = np.isfinite(bh)
        safe_e = np.where(moving, eta, 1.0)
        ratios = np.full((s, m), np.inf)
        hits_up = np.zeros((s, m), dtype=bool)
        mdn = moving & feas_b & (eta < 0) & fin_bl
        ratios = np.where(mdn, (xB - bl) / (-safe_e), ratios)
        mup = moving & feas_b & (eta > 0) & fin_bh
        ratios = np.where(mup, (bh - xB) / safe_e, ratios)
        hits_up |= mup
        mbu = moving & below & (eta > 0)
        ratios = np.where(mbu, (bl - xB) / safe_e, ratios)
        mau = moving & above & (eta < 0)
        ratios = np.where(mau, (xB - bh) / (-safe_e), ratios)
        hits_up |= mau
        ratios = np.maximum(ratios, 0.0)

        rmin = ratios.min(axis=1)
        tied = ratios <= rmin[:, None] + FEAS_TOL
        # tie-break: max |pivot| for stability; Bland: min basis index
        pick_d = np.where(tied, np.abs(eta), -1.0)
        pick_b = np.where(tied, -basis.astype(np.float64), -np.inf)
        pick = np.where(bland[:, None], pick_b, pick_d)
        r = pick.argmax(axis=1)
        r_ratio = ratios[rows_all, r]
        row_blocks = rmin < theta_flip
        theta = np.where(row_blocks, r_ratio, theta_flip)

        # ---- unbounded terminal claims (refactor-verified) ----------------
        unbounded = step & ~np.isfinite(theta)
        if unbounded.any():
            rows = np.flatnonzero(unbounded)
            fresh = since_ref[rows] == 0
            # bounded phase-1 cannot be unbounded; guard as simplex_np
            _finalize(rows[fresh], _UNB, phase1[rows[fresh]])
            _refactor(rows[~fresh])
            step = step & ~unbounded

        # ---- apply step -----------------------------------------------------
        do_flip = np.flatnonzero(step & ~row_blocks)
        do_piv = np.flatnonzero(step & row_blocks)
        stepm = step  # for the masked xB update below
        # non-stepping lanes may carry theta=inf junk; zero it so the masked
        # branch does not manufacture inf*0 NaN warnings
        theta_sane = np.where(stepm & np.isfinite(theta), theta, 0.0)
        xB = np.where(stepm[:, None], xB + eta * theta_sane[:, None], xB)
        if do_flip.size:
            qf = q[do_flip]
            new_up = ~at_upper[do_flip, qf]
            at_upper[do_flip, qf] = new_up
            zvals[do_flip, qf] = np.where(
                new_up, hi_a[do_flip, qf], lo_a[do_flip, qf]
            )
        if do_piv.size:
            ql = q[do_piv]
            rl = r[do_piv]
            pl = np.arange(do_piv.size)
            p_col = basis[do_piv, rl]  # leaving columns
            l2u = hits_up[do_piv, rl]
            at_upper[do_piv, p_col] = l2u
            zvals[do_piv, p_col] = np.where(
                l2u, hi_a[do_piv, p_col], lo_a[do_piv, p_col]
            )
            in_basis[do_piv, p_col] = False
            in_basis[do_piv, ql] = True
            start = np.where(
                np.isfinite(lo_a[do_piv, ql]) | np.isfinite(hi_a[do_piv, ql]),
                zvals[do_piv, ql],
                0.0,
            )
            newval = start + sigma[do_piv] * theta[do_piv]
            # rank-1 update of BI on the pivoting lanes only
            BIp = BI[do_piv]
            al = alpha[do_piv]
            pvals = al[pl, rl]
            safe_p = np.where(np.abs(pvals) > 1e-300, pvals, 1.0)
            rowdiv = BIp[pl, rl, :] / safe_p[:, None]
            colv = al.copy()
            colv[pl, rl] = pvals - 1.0
            BI[do_piv] = BIp - colv[:, :, None] * rowdiv[:, None, :]
            basis[do_piv, rl] = ql
            xB[do_piv, rl] = newval
            since_ref[do_piv] += 1

        # stall detection (objective progress at the pre-step basis)
        progressed = cur_obj < last_obj - 1e-12
        stall = np.where(stepm, np.where(progressed, 0, stall + 1), stall)
        last_obj = np.where(stepm, cur_obj, last_obj)

    # lanes still live at max_iters stay _ITL (out_stat default)
    return _emit(out_stat, out_obj, out_x, out_d, out_atup, out_inb)


def _emit(out_stat, out_obj, out_x, out_d, out_atup, out_inb) -> List[LPResult]:
    out: List[LPResult] = []
    for i in range(out_stat.shape[0]):
        stt = _STATUS_MAP[int(out_stat[i])]
        if stt == SolveStatus.OPTIMAL:
            out.append(
                LPResult(
                    stt,
                    float(out_obj[i]),
                    out_x[i].copy(),
                    d=out_d[i].copy(),
                    at_upper=out_atup[i].copy(),
                    in_basis=out_inb[i].copy(),
                )
            )
        elif stt == SolveStatus.UNBOUNDED:
            out.append(LPResult(stt, -np.inf, None))
        else:
            out.append(LPResult(stt, np.nan, None))
    return out
