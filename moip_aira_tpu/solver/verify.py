"""Exact (f64) certification of f32 device LP results — rigorous intervals.

The wave backend's device kernel runs the simplex in float32.  Exactness is
restored here, and
it must be *rigorous*: a tolerance-level soundness slip at scale produced a
dominated point on 2AP40 (one bad prune in ~150k certified LPs).  The
certificates therefore bound their own floating-point error:

* ``dual_bound`` — for ANY dual vector y, every feasible z (W z = 0,
  lo <= z <= hi) satisfies  c.z = (c - yW).z = d.z >= sum_j min over the box
  of d_j z_j.  We evaluate that box-minimum with an interval envelope
  [d - E, d + E] where E_j >= the f64 roundoff of computing d_j, so
  ``dual_bound`` is a mathematically valid lower bound on the LP no matter
  how wrong the claimed basis is.  Branch-and-bound pruning uses ONLY this
  (solver/wave.py), never the claimed vertex value.
* OPTIMAL claim ``ok`` — basic solution from ``B z_B = -N z_N`` satisfies
  all bounds and the reduced costs have the right signs: the claimed vertex
  is (near-)optimal, so its value is a trustworthy *upper* guide for
  heuristics and branching.  Soundness never rests on it.
* INFEASIBLE claim — Farkas certificate from the phase-1 basis: with
  ``a = y1.W`` evaluated with the same interval envelope, proving
  ``sup over the box of a.z < 0`` proves the box empty (any feasible z has
  a.z = y1.(Wz) = 0).  The supremum uses outward rounding, so a false
  infeasibility can never certify.

Free columns (both bounds infinite) would force the interval box-min to
-inf.  The only free columns in practice are the logical columns of
objective-bound rows at unconstrained stages (rhs = +-inf); those rows are
vacuous, and since ANY y yields a valid bound we simply zero their dual
components.  Logical columns are singletons (the -I block), so the zeroed
component makes d_j = 0 *exactly* with E_j = 0 and the column contributes
exactly 0.

Lanes whose certificate fails (f32 landed on a wrong basis — rare, counted)
are re-solved exactly on the host.  Everything is vectorised over the
batch: the certificates cost two batched (m,m) solves plus two GEMMs,
trivial next to the device wave they confirm.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from moip_aira_tpu.solver import simplex_jax as sx

CERT_TOL = 1e-9
_EPS = np.finfo(np.float64).eps


class CertifiedBatch(NamedTuple):
    ok: np.ndarray  # (B,) bool — certificate valid
    status: np.ndarray  # (B,) int32 (sx codes, only valid where ok)
    obj: np.ndarray  # (B,) f64 claimed-vertex objective (where ok & optimal)
    x: np.ndarray  # (B, n) f64 exact structural solution
    #: exact reduced costs (B, nc) and nonbasic-at-upper/in-basis masks for
    #: reduced-cost fixing in the branch-and-bound layer (rows valid where
    #: ok & optimal)
    d: np.ndarray = None
    at_upper: np.ndarray = None
    in_basis: np.ndarray = None
    #: (B,) rigorous f64 lower bound on the lane's LP value — valid for ANY
    #: claimed basis (see module docstring); +inf where infeasibility
    #: certified, -inf where no finite bound could be established
    dual_bound: np.ndarray = None
    #: (B, nc) rigorous elementwise envelope of the reduced-cost roundoff:
    #: the true reduced cost of the y used for dual_bound lies in [d-E, d+E]
    d_err: np.ndarray = None


class LPVerifier:
    def __init__(self, W: np.ndarray):
        self.W = np.asarray(W, dtype=np.float64)  # (m, nc)
        self.Wabs = np.abs(self.W)
        self.m, self.nc = self.W.shape
        self.n = self.nc - self.m
        # dot-product roundoff envelope: |fl(u.v) - u.v| <= gamma sum|u_i v_i|
        # with gamma = m eps / (1 - m eps); 4x safety margin
        self._gamma = 4.0 * self.m * _EPS

    def _d_with_err(self, y, c=None):
        """Reduced costs for dual vector y with a rigorous error envelope.

        Returns (d, E): the true c - y.W (entrywise) lies in [d - E, d + E].
        """
        u = y @ self.W
        E = (np.abs(y) @ self.Wabs) * self._gamma
        if c is None:
            return -u, E
        d = c - u
        # the subtraction adds at most eps*|d| of further roundoff
        return d, E + np.abs(d) * (2.0 * _EPS)

    @staticmethod
    def _box_min(d, E, lo, hi, finite_lo, finite_hi):
        """sum_j min over z in [lo,hi], d' in [d-E, d+E] of d'_j z_j.

        -inf wherever an infinite bound direction cannot be excluded.
        """
        dm, dp = d - E, d + E
        both = finite_lo & finite_hi
        lo_s = np.where(finite_lo, lo, 0.0)
        hi_s = np.where(finite_hi, hi, 0.0)
        corner = np.minimum(
            np.minimum(dm * lo_s, dp * lo_s), np.minimum(dm * hi_s, dp * hi_s)
        )
        # lo = -inf: need d' <= 0 for all d' (dp <= 0); min then at z = hi
        lo_inf = ~finite_lo & finite_hi
        t_lo_inf = np.where(dp <= 0.0, np.minimum(dm * hi_s, dp * hi_s), -np.inf)
        # hi = +inf: need d' >= 0 (dm >= 0); min then at z = lo
        hi_inf = finite_lo & ~finite_hi
        t_hi_inf = np.where(dm >= 0.0, np.minimum(dm * lo_s, dp * lo_s), -np.inf)
        # both infinite: only an exactly-zero interval contributes 0
        free = ~finite_lo & ~finite_hi
        t_free = np.where((dm == 0.0) & (dp == 0.0), 0.0, -np.inf)
        terms = np.where(
            both, corner, np.where(lo_inf, t_lo_inf, np.where(hi_inf, t_hi_inf, t_free))
        )
        return terms.sum(axis=1)

    @staticmethod
    def _box_max(a, E, lo, hi, finite_lo, finite_hi):
        """sum_j max over z in [lo,hi], a' in [a-E, a+E] of a'_j z_j.

        +inf wherever an infinite bound direction cannot be excluded.
        """
        am, ap = a - E, a + E
        both = finite_lo & finite_hi
        lo_s = np.where(finite_lo, lo, 0.0)
        hi_s = np.where(finite_hi, hi, 0.0)
        corner = np.maximum(
            np.maximum(am * lo_s, ap * lo_s), np.maximum(am * hi_s, ap * hi_s)
        )
        lo_inf = ~finite_lo & finite_hi
        t_lo_inf = np.where(am >= 0.0, np.maximum(am * hi_s, ap * hi_s), np.inf)
        hi_inf = finite_lo & ~finite_hi
        t_hi_inf = np.where(ap <= 0.0, np.maximum(am * lo_s, ap * lo_s), np.inf)
        free = ~finite_lo & ~finite_hi
        t_free = np.where((am == 0.0) & (ap == 0.0), 0.0, np.inf)
        terms = np.where(
            both, corner, np.where(lo_inf, t_lo_inf, np.where(hi_inf, t_hi_inf, t_free))
        )
        return terms.sum(axis=1)

    def certify(
        self,
        c: np.ndarray,  # (B, nc) f64
        lo: np.ndarray,  # (B, nc)
        hi: np.ndarray,  # (B, nc)
        status: np.ndarray,  # (B,) int32 claims from the device
        basis: np.ndarray,  # (B, m) int32
        at_upper: np.ndarray,  # (B, nc) bool
    ) -> CertifiedBatch:
        W, m, nc, n = self.W, self.m, self.nc, self.n
        B = c.shape[0]
        ok = np.zeros(B, dtype=bool)
        out_status = np.asarray(status, dtype=np.int32).copy()
        out_obj = np.full(B, np.nan)
        out_x = np.zeros((B, n))

        claim_opt = status == sx.OPTIMAL
        claim_inf = status == sx.INFEASIBLE
        out_d = np.zeros((B, nc))
        out_atup = np.zeros((B, nc), dtype=bool)
        out_inb = np.zeros((B, nc), dtype=bool)
        out_lb = np.full(B, -np.inf)
        out_derr = np.zeros((B, nc))
        interesting = claim_opt | claim_inf
        if not interesting.any():
            return CertifiedBatch(
                ok, out_status, out_obj, out_x, out_d, out_atup, out_inb,
                out_lb, out_derr,
            )

        idx = np.flatnonzero(interesting)
        basis_i = basis[idx]  # (b, m)
        Bmats = W[:, basis_i].transpose(1, 0, 2)  # (b, m, m)

        # nonbasic values
        finite_lo = np.isfinite(lo[idx])
        finite_hi = np.isfinite(hi[idx])
        zN = np.where(
            finite_lo, lo[idx], np.where(finite_hi, hi[idx], 0.0)
        )
        zN = np.where(at_upper[idx] & finite_hi, hi[idx], zN)
        in_basis = np.zeros((len(idx), nc), dtype=bool)
        np.put_along_axis(in_basis, basis_i, True, axis=1)
        zN = np.where(in_basis, 0.0, zN)

        rhs_vec = -(zN @ W.T)  # (b, m): -N z_N
        xB, solvable = _batch_solve(Bmats, rhs_vec)

        z = zN.copy()
        np.put_along_axis(z, basis_i, xB, axis=1)

        lo_i, hi_i = lo[idx], hi[idx]
        feas = (
            (z >= lo_i - 1e-7) & (z <= hi_i + 1e-7)
        ).all(axis=1) & solvable

        # rows whose own logical column is free on both sides are vacuous
        # (objective-bound rows at unconstrained stages): zero their dual
        # components so the free column contributes exactly 0 to the bound
        free_cols = ~finite_lo & ~finite_hi  # (b, nc)
        row_free = free_cols[:, n:]  # (b, m) — logical j <-> row j

        cl_opt = claim_opt[idx]
        so = np.flatnonzero(cl_opt)  # OPTIMAL claims, within idx
        sf = np.flatnonzero(~cl_opt)  # INFEASIBLE claims, within idx
        ok_i = np.zeros(len(idx), dtype=bool)
        lb = np.full(len(idx), -np.inf)
        d = np.zeros((len(idx), nc))
        E = np.zeros((len(idx), nc))

        # ---- optimality certificates (OPTIMAL claims only) -----------------
        if so.size:
            cB = np.take_along_axis(c[idx[so]], basis_i[so], axis=1)
            y, solvable_T = _batch_solve(Bmats[so].transpose(0, 2, 1), cB)
            y = np.where(row_free[so], 0.0, y)
            # clean solve noise: true duals of non-binding rows are exactly
            # 0, but the f64 solve leaves ~1e-13 residue that would make the
            # one-side-infinite logical columns sign-indefinite (and the
            # bound -inf).  Zeroing tiny components is valid — ANY y gives a
            # bound — and costs at most tau * (row range) of tightness.
            tau = 1e-10 * (1.0 + np.abs(y).max(axis=1, keepdims=True))
            y = np.where(np.abs(y) <= tau, 0.0, y)
            d_o, E_o = self._d_with_err(y, c[idx[so]])
            d[so] = d_o
            E[so] = E_o
            inb_o = in_basis[so]
            atup_o = at_upper[idx[so]]
            flo_o, fhi_o = finite_lo[so], finite_hi[so]
            at_lo_nb = ~inb_o & ~atup_o & flo_o
            at_hi_nb = ~inb_o & (atup_o | (~flo_o & fhi_o))
            free_nb = ~inb_o & free_cols[so]
            # soundness: a nonbasic column flagged "at upper" with an
            # INFINITE upper bound is an invalid solver state — rejecting it
            # is what kept an earlier device kernel's inf-bound pivot-row bug
            # from silently certifying wrong optima
            bogus_state = ~inb_o & atup_o & ~fhi_o
            ok_i[so] = (
                np.where(at_lo_nb, d_o >= -CERT_TOL, True).all(axis=1)
                & np.where(at_hi_nb & fhi_o, d_o <= CERT_TOL, True).all(axis=1)
                & np.where(free_nb, np.abs(d_o) <= CERT_TOL, True).all(axis=1)
                & ~bogus_state.any(axis=1)
                & feas[so]
                & solvable_T
            )
            # rigorous any-y lower bound (valid even where opt_ok is False)
            lb[so] = np.where(
                solvable_T,
                self._box_min(d_o, E_o, lo_i[so], hi_i[so], flo_o, fhi_o),
                -np.inf,
            )

        # ---- infeasibility certificates (INFEASIBLE claims only) -----------
        if sf.size:
            below = xB[sf] < np.take_along_axis(lo_i[sf], basis_i[sf], axis=1) - 1e-9
            above = xB[sf] > np.take_along_axis(hi_i[sf], basis_i[sf], axis=1) + 1e-9
            c1B = np.where(below, -1.0, np.where(above, 1.0, 0.0))
            y1, s1 = _batch_solve(Bmats[sf].transpose(0, 2, 1), c1B)
            y1 = np.where(row_free[sf], 0.0, y1)
            tau1 = 1e-10 * (1.0 + np.abs(y1).max(axis=1, keepdims=True))
            y1 = np.where(np.abs(y1) <= tau1, 0.0, y1)
            a, E1 = self._d_with_err(y1)
            a = -a  # _d_with_err returns -(y1 @ W); the Farkas row is +y1.W
            sup = self._box_max(
                a, E1, lo_i[sf], hi_i[sf], finite_lo[sf], finite_hi[sf]
            )
            # a.z = 0 for every feasible z, so sup < 0 (outward-rounded)
            # proves the box empty — no tolerance: the interval is rigorous
            ok_i[sf] = (sup < 0.0) & s1 & solvable[sf]

            # ---- single-row Farkas rescue --------------------------------
            # A kernel's infeasibility claim typically hinges on ONE
            # violated row (no eligible entering column for it); the
            # combined phase-1 vector above mixes every violated row's
            # multiplier and often fails where the single row certifies
            # (measured on the since-deleted dual kernel: 2586 failed
            # infeasibility audits on 2AP20; the rescue stays because the
            # primal's claims hinge the same way).
            # For y = sgn * (B^-T e_r): a = y.W has a_{basic k} = sgn*d_rk,
            # and sup over the box of a.z equals (max over nonbasics of
            # xB_r) - lo_r (below case; mirrored above), so sup < 0 proves
            # the box empty by the same any-y argument — one extra batched
            # (m, m) solve for the lanes still unproven.
            fail = np.flatnonzero(~ok_i[sf] & solvable[sf])
            if fail.size:
                sfF = sf[fail]
                vio_b = np.where(
                    below[fail],
                    np.take_along_axis(lo_i[sfF], basis_i[sfF], axis=1)
                    - xB[sfF],
                    0.0,
                )
                vio_a = np.where(
                    above[fail],
                    xB[sfF]
                    - np.take_along_axis(hi_i[sfF], basis_i[sfF], axis=1),
                    0.0,
                )
                vio = np.maximum(vio_b, vio_a)
                r_star = np.argmax(vio, axis=1)  # (f,)
                has_vio = vio[np.arange(fail.size), r_star] > 0.0
                sgn = np.where(
                    np.take_along_axis(
                        below[fail], r_star[:, None], axis=1
                    )[:, 0],
                    -1.0,
                    1.0,
                )
                cR = np.zeros((fail.size, m))
                cR[np.arange(fail.size), r_star] = sgn
                yR, sR = _batch_solve(
                    Bmats[sfF].transpose(0, 2, 1), cR
                )
                yR = np.where(row_free[sfF], 0.0, yR)
                tauR = 1e-10 * (1.0 + np.abs(yR).max(axis=1, keepdims=True))
                yR = np.where(np.abs(yR) <= tauR, 0.0, yR)
                aR, ER = self._d_with_err(yR)
                aR = -aR
                supR = self._box_max(
                    aR, ER, lo_i[sfF], hi_i[sfF],
                    finite_lo[sfF], finite_hi[sfF],
                )
                ok_i[sfF] |= (supR < 0.0) & sR & has_vio

        ok[idx] = ok_i
        obj_i = (c[idx] * z).sum(axis=1)
        out_obj[idx] = np.where(cl_opt, obj_i, np.nan)
        out_x[idx] = z[:, :n]
        out_d[idx] = d
        out_derr[idx] = E
        out_atup[idx] = at_upper[idx] | (~finite_lo & finite_hi)
        out_inb[idx] = in_basis
        # dual_bound: +inf where infeasibility certified (empty node),
        # the any-y bound for optimality claims, -inf otherwise
        out_lb[idx] = np.where(
            cl_opt, lb, np.where(ok_i, np.inf, -np.inf)
        )
        return CertifiedBatch(
            ok, out_status, out_obj, out_x, out_d, out_atup, out_inb,
            out_lb, out_derr,
        )


def _batch_solve(mats: np.ndarray, rhs: np.ndarray):
    """Solve mats[i] @ x = rhs[i]; returns (x, solvable_mask)."""
    b = mats.shape[0]
    try:
        x = np.linalg.solve(mats, rhs[..., None])[..., 0]
        bad = ~np.isfinite(x).all(axis=1)
        return x, ~bad
    except np.linalg.LinAlgError:
        xs = np.zeros_like(rhs)
        okm = np.zeros(b, dtype=bool)
        for i in range(b):
            try:
                xs[i] = np.linalg.solve(mats[i], rhs[i])
                okm[i] = np.isfinite(xs[i]).all()
            except np.linalg.LinAlgError:
                okm[i] = False
        return xs, okm
