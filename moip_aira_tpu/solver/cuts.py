"""Exactly-valid cutting planes for binary knapsack-structured rows.

The reference gets its cutting planes for free from CPLEX inside
``CPXmipopt`` (reference src/aira.cpp:480-487); on the KP2D family
(near-uniform weights, capacity = half the weight sum) those cuts are what
keeps trees small — pure LP-bound branch-and-bound explodes by ~100x.

This module separates *integer-combinatorial* cuts whose validity is a
counting argument over integer data — no floating-point derivation, hence
no rigor gap against the exactness invariant (CLAUDE.md):

* **Extended cover cuts** from a packing row  w.x <= b  (w >= 0 integer,
  x binary):  if C is a cover (sum_C w_j > b) then  sum_C x_j <= |C|-1,
  and every item at least as heavy as the heaviest cover item can join the
  left side (extended cover, Balas):  sum_{E(C)} x_j <= |C|-1 with
  E(C) = C ∪ {j : w_j >= max_C w_i}.
* The same from a covering row  v.x >= b1  via complementation
  y = 1-x:  v.y <= V-b1, cover in y gives  sum_{E(C)} x_j >= |E(C)|-|C|+1.

Separation is the classic greedy on the fractional LP point; each cut is
checked for violation before it is kept.  Cuts are appended as ordinary
<=/>= rows (one new row each), so every downstream consumer — the exact
host simplex, the f64 certifier, the device kernels — prices them like any
other constraint and exactness is untouched.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

#: minimum violation of the fractional point for a cut to be kept
VIOL_TOL = 1e-4


def _greedy_cover(w: np.ndarray, b: float, pref: np.ndarray) -> Optional[np.ndarray]:
    """Indices of a minimal cover of ``w.x <= b`` preferring high ``pref``.

    Greedy: add items by descending ``pref`` until the weight exceeds b,
    then drop redundant members (heaviest-first) to make it minimal.
    Returns None when no cover exists (sum w <= b).
    """
    order = np.argsort(-pref, kind="stable")
    tot = 0.0
    take: List[int] = []
    for j in order:
        take.append(int(j))
        tot += w[j]
        if tot > b:
            break
    else:
        return None
    # minimalise: remove members that keep it a cover (ascending weight
    # keeps the heavy ones, which strengthens the extension)
    take_sorted = sorted(take, key=lambda j: w[j])
    keep = list(take)
    for j in take_sorted:
        if tot - w[j] > b:
            keep.remove(j)
            tot -= w[j]
    return np.asarray(keep, dtype=np.int64)


def cover_cuts_leq(
    w: np.ndarray,
    b: float,
    xstar: np.ndarray,
    free: np.ndarray,
) -> List[Tuple[np.ndarray, float]]:
    """Extended cover cuts for ``w.x <= b`` violated at ``xstar``.

    ``free`` marks binary variables not fixed at the current node; fixed
    variables are folded into the rhs by the caller.  Returns a list of
    (row_coefficients_over_all_vars, rhs) meaning ``row.x <= rhs``.
    """
    n = w.shape[0]
    idx = np.flatnonzero(free & (w > 0))
    if idx.size == 0:
        return []
    wf = w[idx].astype(np.float64)
    xf = np.clip(xstar[idx], 0.0, 1.0)
    cover = _greedy_cover(wf, b, xf)
    if cover is None:
        return []
    cut_rhs = float(cover.size - 1)
    wmax = wf[cover].max()
    ext = np.flatnonzero(wf >= wmax)
    members = np.union1d(cover, ext)
    if xf[members].sum() <= cut_rhs + VIOL_TOL:
        return []
    row = np.zeros(n)
    row[idx[members]] = 1.0
    return [(row, cut_rhs)]


def cover_cuts_geq(
    v: np.ndarray,
    b1: float,
    xstar: np.ndarray,
    free: np.ndarray,
) -> List[Tuple[np.ndarray, float]]:
    """Complemented extended cover cuts for ``v.x >= b1`` (v >= 0).

    Substituting y = 1 - x turns the covering row into the packing row
    ``v.y <= sum(v) - b1``; a cover C in y yields
    ``sum_{E(C)} y_j <= |C|-1``  i.e.  ``sum_{E(C)} x_j >= |E(C)|-|C|+1``.
    Returned as (row, rhs) meaning ``row.x >= rhs`` — the caller flips the
    sign for canonical <= storage.
    """
    n = v.shape[0]
    idx = np.flatnonzero(free & (v > 0))
    if idx.size == 0:
        return []
    vf = v[idx].astype(np.float64)
    yb = float(vf.sum() - b1)
    if yb < 0:
        return []  # row infeasible over the free vars alone; B&B handles it
    ystar = np.clip(1.0 - xstar[idx], 0.0, 1.0)
    cover = _greedy_cover(vf, yb, ystar)
    if cover is None:
        return []
    vmax = vf[cover].max()
    ext = np.flatnonzero(vf >= vmax)
    members = np.union1d(cover, ext)
    cut_rhs = float(members.size - (cover.size - 1))
    if (1.0 - ystar[members]).sum() >= cut_rhs - VIOL_TOL:
        return []
    row = np.zeros(n)
    row[idx[members]] = 1.0
    return [(row, cut_rhs)]


def separate_cover_cuts(
    A: np.ndarray,
    row_lb: np.ndarray,
    row_ub: np.ndarray,
    xstar: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    is_int: np.ndarray,
    max_cuts: int = 8,
) -> List[Tuple[np.ndarray, float, float]]:
    """Separate extended cover cuts from every knapsack-shaped row.

    A row qualifies when all its nonzero coefficients sit on binary
    variables and share one sign pattern (>= 0).  Variables fixed at the
    node (lo == hi) are folded into the rhs.  Returns rows as
    (coefficients, cut_lb, cut_ub) ready to append to the system.
    """
    m, n = A.shape
    binary = is_int & (lo[:n] >= -1e-9) & (hi[:n] <= 1.0 + 1e-9)
    fixed = hi[:n] - lo[:n] < 0.5
    free = binary & ~fixed
    out: List[Tuple[np.ndarray, float, float]] = []
    for r in range(m):
        a = A[r]
        nz = a != 0
        if not nz.any() or not binary[nz].all() or (a[nz] < 0).any():
            continue
        fixed_contrib = float(a[fixed] @ np.rint(xstar[fixed])) if fixed.any() else 0.0
        if np.isfinite(row_ub[r]):
            for row, rhs in cover_cuts_leq(a, row_ub[r] - fixed_contrib, xstar, free):
                out.append((row, -np.inf, rhs + float(row[fixed] @ np.rint(xstar[fixed]))))
                if len(out) >= max_cuts:
                    return out
        if np.isfinite(row_lb[r]):
            for row, rhs in cover_cuts_geq(a, row_lb[r] - fixed_contrib, xstar, free):
                out.append((row, rhs + float(row[fixed] @ np.rint(xstar[fixed])), np.inf))
                if len(out) >= max_cuts:
                    return out
    return out
