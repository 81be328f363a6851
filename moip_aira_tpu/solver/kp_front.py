"""Full-front dynamic program for bi-objective knapsack instances.

The reference solves its knapsack family (2KP50.lp …, KP2D in the paper)
point-by-point: one CPLEX MIP per lexicographic stage per Pareto point
(src/aira.cpp:452-536), with cuts and presolve carrying the hardness of the
correlated knapsack subproblems.  A branch-and-bound rebuild matches it on
small instances but hits the knapsack wall (tiny LP gaps, huge node counts)
long before the reference's 100–2000-item sizes.

This module takes a dense device route instead: for the *single-capacity*
bi-objective family, the entire nondominated set is one dense dynamic
program

    g[c, s] = max { v0(T) : T subset of items, w(T) <= c, v1(T) == s }

over a (cap+1, V1+1) table — a few hundred MB of int32 whose per-item
update is two shifted elementwise maxima.  That is pure vector work at
device-memory bandwidth: the whole 2KP100 front (77 points) is ~100
shifted-max passes over one table, where the MIP ladder stalls for hours.
No branching, no LP, no tolerances — the arithmetic is
exact integer throughout, so the result needs no certification.

Structure detection is conservative: exactly two objectives, one capacity
row, nonnegative integer data, integral variables (bounded integers are
binary-split into power-of-two pseudo-items).  Everything else falls back
to the general AIRA + wave engine.

The table is bucketed (rounded up to multiples of 256 with no-op padding
items) so XLA compiles are keyed on the bucket shape, not the exact
instance — repeated benchmark sizes share one compile.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import Sense
from moip_aira_tpu.utils.device import enable_compile_cache

#: hard ceiling on table cells (int32) so detection never commits the jax
#: path to an allocation it cannot make: 2^31 cells = 8 GB.
MAX_TABLE_CELLS = 2**31
#: numpy-oracle ceiling — the python loop over items is ~1 GB/s, keep the
#: oracle to sizes where it answers in seconds.
MAX_TABLE_CELLS_NP = 2**27

_BUCKET = 256
#: the NumPy oracle's "unreachable" cell value
_NEG = -(2**30)


@dataclasses.dataclass
class KP2:
    """Canonical maximisation form: max (V[0]·x, V[1]·x) s.t. w·x <= cap,
    x binary after multiplicity expansion."""

    w: np.ndarray  # (n_items,) int64 > 0 expanded weights
    V: np.ndarray  # (2, n_items) int64 >= 0 expanded values
    cap: int
    #: True when the original problem minimises (points are negated back)
    negate: bool
    #: which original objective rides the DP s-axis (the smaller value sum)
    s_axis: int

    @property
    def table_cells(self) -> int:
        return (self.cap + 1) * (int(self.V[1].sum()) + 1)


def detect_kp2(problem: Problem) -> Optional[KP2]:
    """Return the canonical KP2 structure, or None if it doesn't apply.

    Accepts: 2 objectives; all variables integer with lb 0; exactly one
    structural row that is a pure <= capacity row (or >= with nonpositive
    data, the mirrored form); objective/weight data integral; objectives
    uniformly "profit-like" (maximise nonnegative, or minimise nonpositive
    as the reference's .mop convention encodes it).
    """
    p = problem
    if p.objcnt != 2 or p.m_struct != 1:
        return None
    if not bool(np.all(p.is_int)):
        return None
    if not bool(np.all(p.lb == 0)):
        return None
    w = np.asarray(p.A[0], dtype=np.float64)
    row_lb = float(p.row_lb[0])
    row_ub = float(p.row_ub[0])
    if np.isfinite(row_ub) and not np.isfinite(row_lb):
        cap = row_ub
    elif np.isfinite(row_lb) and not np.isfinite(row_ub) and np.all(w <= 0):
        # -w·x >= -cap mirrored form
        w, cap = -w, -row_lb
    else:
        return None
    if cap < 0 or np.any(w < 0):
        return None
    if not np.all(w == np.rint(w)):
        return None
    # integer weights make a fractional capacity equivalent to its floor
    cap = math.floor(cap)
    C = np.asarray(p.C, dtype=np.float64)
    if not np.all(C == np.rint(C)):
        return None
    if p.objsen is Sense.MAX and np.all(C >= 0):
        V = C.copy()
        negate = False
    elif p.objsen is Sense.MIN and np.all(C <= 0):
        V = -C
        negate = True
    else:
        return None

    # effective integer upper bounds; unbounded vars are capped by capacity
    ub = np.asarray(p.ub, dtype=np.float64).copy()
    unb = ~np.isfinite(ub)
    if np.any(unb):
        with np.errstate(divide="ignore"):
            by_cap = np.floor(np.where(w > 0, cap / np.maximum(w, 1e-300), 0))
        # a zero-weight unbounded var with positive value => unbounded front
        if np.any(unb & (w == 0) & (V.max(axis=0) > 0)):
            return None
        ub[unb] = by_cap[unb]
    ub = np.rint(ub).astype(np.int64)
    w = np.rint(w).astype(np.int64)
    V = np.rint(V).astype(np.int64)
    cap = int(cap)

    # drop useless items; expand multiplicities by binary splitting
    ws, v0s, v1s = [], [], []
    for i in range(p.n):
        u = int(ub[i])
        if u <= 0 or (V[0, i] == 0 and V[1, i] == 0):
            continue
        if w[i] > cap:
            continue
        u = min(u, cap // w[i]) if w[i] > 0 else u
        t = 1
        while u > 0:
            k = min(t, u)
            ws.append(w[i] * k)
            v0s.append(V[0, i] * k)
            v1s.append(V[1, i] * k)
            u -= k
            t *= 2
    if not ws:
        w_e = np.zeros(0, dtype=np.int64)
        V_e = np.zeros((2, 0), dtype=np.int64)
    else:
        w_e = np.asarray(ws, dtype=np.int64)
        V_e = np.stack(
            [np.asarray(v0s, dtype=np.int64), np.asarray(v1s, dtype=np.int64)]
        )

    # the smaller value sum rides the s-axis (smaller table)
    s_axis = int(np.argmin(V_e.sum(axis=1))) if w_e.size else 1
    if s_axis == 0:
        V_e = V_e[::-1].copy()
    kp = KP2(w=w_e, V=V_e, cap=int(cap), negate=negate, s_axis=s_axis)
    if kp.table_cells > MAX_TABLE_CELLS:
        return None
    return kp


def _extract_front(last_row: np.ndarray, kp: KP2) -> np.ndarray:
    """Nondominated (obj0, obj1) points from the c=cap table row, in the
    problem's native objective order and the store's descending-lex sort."""
    best = np.asarray(last_row, dtype=np.int64)
    S = best.shape[0] - 1
    pts = []
    run = -1
    for s in range(S, -1, -1):
        if best[s] > run:
            run = int(best[s])
            pts.append((run, s))
    if not pts:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(pts, dtype=np.int64)  # columns: (v_other, v_s)
    if kp.s_axis == 0:
        arr = arr[:, ::-1]
    if kp.negate:
        arr = -arr
    order = np.lexsort((arr[:, 1], arr[:, 0]))
    return arr[order[::-1]]


def front_np(kp: KP2) -> np.ndarray:
    """NumPy oracle: full-table DP, exact int32 arithmetic.

    Unreachable cells start at ``_NEG``; adding every item's value to one
    still leaves it negative (checked below), so the update needs no mask:
    two in-place passes per item over a preallocated buffer."""
    S = int(kp.V[1].sum())
    C = kp.cap
    if (C + 1) * (S + 1) > MAX_TABLE_CELLS_NP:
        raise MemoryError(
            f"KP2 table {(C + 1)}x{(S + 1)} exceeds the numpy-oracle budget"
        )
    if int(kp.V[0].sum()) >= -_NEG:
        raise OverflowError("KP2 value sum exceeds the int32 table range")
    g = np.full((C + 1, S + 1), _NEG, dtype=np.int32)
    g[:, 0] = 0
    cand = np.empty_like(g)
    for wi, b0, a1 in zip(kp.w, kp.V[0], kp.V[1]):
        wi, b0, a1 = int(wi), int(b0), int(a1)
        c = cand[: C + 1 - wi, : S + 1 - a1]
        np.add(g[: C + 1 - wi, : S + 1 - a1], b0, out=c)
        tgt = g[wi:, a1:]
        np.maximum(tgt, c, out=tgt)
    return _extract_front(np.maximum(g[C], -1), kp)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def _dp_runner(C_p: int, S_p: int, wmax: int, amax: int, C: int):
    """The jitted DP for one bucketed table geometry (cached, so instances
    of the same size class share one compile)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(w_a, b0_a, a1_a):
        g0 = jnp.full((C_p, S_p), -1, dtype=jnp.int32)
        g0 = g0.at[:, 0].set(0)

        def step(g, item):
            wi, b0i, a1i = item
            # shifted read g[c-wi, s-a1i] via a NEG-padded frame: static
            # slice sizes, dynamic offsets
            gp = jnp.full((C_p + wmax, S_p + amax), -1, dtype=jnp.int32)
            gp = jax.lax.dynamic_update_slice(gp, g, (wmax, amax))
            sh = jax.lax.dynamic_slice(gp, (wmax - wi, amax - a1i), (C_p, S_p))
            cand = jnp.where(sh >= 0, sh + b0i, -1)
            return jnp.maximum(g, cand), None

        g, _ = jax.lax.scan(step, g0, (w_a, b0_a, a1_a))
        return g[C]

    return run


def front_jax(kp: KP2) -> np.ndarray:
    """Device DP: ``lax.scan`` over items, each step two shifted elementwise
    maxima over the (C_p, S_p) int32 table — pure memory-bandwidth work
    that XLA fuses into a few passes.  Table dims and item count are
    bucketed so the compile is reused across instances of the same size
    class."""
    import jax.numpy as jnp

    S = int(kp.V[1].sum())
    C = kp.cap
    n = kp.w.shape[0]
    C_p = _round_up(C + 1, _BUCKET)
    S_p = _round_up(S + 1, _BUCKET)
    n_p = _round_up(max(n, 1), 64)
    # no-op padding items: w=0, v=0 leaves the table unchanged
    w = np.zeros(n_p, dtype=np.int32)
    b0 = np.zeros(n_p, dtype=np.int32)
    a1 = np.zeros(n_p, dtype=np.int32)
    w[:n] = kp.w
    b0[:n] = kp.V[0]
    a1[:n] = kp.V[1]
    wmax = int(w.max()) if n else 0
    amax = int(a1.max()) if n else 0
    run = _dp_runner(C_p, S_p, wmax, amax, C)
    last = np.asarray(run(jnp.asarray(w), jnp.asarray(b0), jnp.asarray(a1)))
    return _extract_front(last[: S + 1], kp)


def kp2_front(problem: Problem) -> Optional[np.ndarray]:
    """Detect + solve on the device (``front_jax``); returns sorted
    nondominated points, or None when the DP does not apply."""
    kp = detect_kp2(problem)
    if kp is None:
        return None
    enable_compile_cache()
    return front_jax(kp)
