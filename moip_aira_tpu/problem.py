"""Canonical dense problem model.

Reference parity: src/problem.{h,cpp}.  The reference keeps the problem inside
a CPLEX ``CPXLPptr`` and mutates objective rows / RHS in place
(problem.cpp:119-152, aira.cpp:467-518).  Here the problem is a set of dense
arrays designed for the batched device solve path:

* ``A`` (m_struct x n)   structural constraint matrix,
* ``row_lb`` / ``row_ub`` (m_struct)  activity bounds per structural row
  ('<=' rows have row_lb = -inf, '=' rows have row_lb == row_ub),
* ``C`` (objcnt x n)     objective coefficient matrix — these rows double as
  the *objective-bound constraint rows*: for a MIN problem each subproblem
  imposes C[j] @ x <= rhs[j] (reference problem.cpp:119-132 appends rows of
  sense 'L' with RHS +CPX_INFBOUND; MAX uses 'G' / -inf),
* ``lb`` / ``ub`` / ``is_int`` (n)  variable bounds and integrality.

The per-subproblem mutable state (the ``rhs`` array of objective bounds and
branch-and-bound variable bounds) lives *outside* this object, so one Problem
can be shared read-only by every worker and every vmapped device lane.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from moip_aira_tpu.sense import INF, Sense


@dataclasses.dataclass
class Problem:
    """A multi-objective integer program in canonical dense form."""

    #: number of objectives (reference problem.h:11 `objcnt`)
    objcnt: int
    #: shared optimisation sense of every objective (problem.h:19 `objsen`)
    objsen: Sense
    #: variable names in column order
    var_names: List[str]
    #: objective coefficients, shape (objcnt, n)
    C: np.ndarray
    #: structural constraints, shape (m_struct, n)
    A: np.ndarray
    #: structural row activity bounds, shape (m_struct,)
    row_lb: np.ndarray
    row_ub: np.ndarray
    #: variable bounds, shape (n,)
    lb: np.ndarray
    ub: np.ndarray
    #: integrality mask, shape (n,)
    is_int: np.ndarray
    #: source filename (problem.h:33 `filename_`)
    filename: str = ""
    #: MIP gap tolerance kept for API parity (problem.cpp:13); the native
    #: solver is exact so it never auto-shrinks (aira.cpp:498-514 is moot).
    mip_tolerance: float = 1e-4

    def __post_init__(self) -> None:
        self.C = np.asarray(self.C, dtype=np.float64)
        self.A = np.asarray(self.A, dtype=np.float64)
        if self.A.size == 0:
            self.A = self.A.reshape(0, self.C.shape[1])
        self.row_lb = np.asarray(self.row_lb, dtype=np.float64)
        self.row_ub = np.asarray(self.row_ub, dtype=np.float64)
        self.lb = np.asarray(self.lb, dtype=np.float64)
        self.ub = np.asarray(self.ub, dtype=np.float64)
        self.is_int = np.asarray(self.is_int, dtype=bool)
        assert self.C.shape[0] == self.objcnt
        assert self.A.shape[1] == self.C.shape[1]

    # -- shape helpers -----------------------------------------------------
    @property
    def n(self) -> int:
        """Number of structural variables."""
        return self.C.shape[1]

    @property
    def m_struct(self) -> int:
        """Number of structural constraint rows (objective rows excluded)."""
        return self.A.shape[0]

    @property
    def m_total(self) -> int:
        """Structural rows plus the objcnt objective-bound rows."""
        return self.m_struct + self.objcnt

    # -- canonical initial objective-bound RHS -----------------------------
    def initial_rhs(self) -> np.ndarray:
        """The all-unconstrained objective-bound vector.

        Reference problem.cpp:119-132: +inf for MIN (rows of sense 'L'),
        -inf for MAX (rows of sense 'G').
        """
        fill = INF if self.objsen is Sense.MIN else -INF
        return np.full(self.objcnt, fill, dtype=np.float64)

    def objective_row_bounds(self, rhs: np.ndarray):
        """Convert an objective-bound vector into (lo, hi) activity bounds.

        For MIN each bound is an upper bound C[j] @ x <= rhs[j]; for MAX a
        lower bound. Returns arrays of shape (objcnt,).
        """
        rhs = np.asarray(rhs, dtype=np.float64)
        if self.objsen is Sense.MIN:
            return np.full(self.objcnt, -INF), rhs.copy()
        return rhs.copy(), np.full(self.objcnt, INF)

    def full_row_matrix(self) -> np.ndarray:
        """Structural rows stacked with objective rows: shape (m_total, n)."""
        return np.vstack([self.A, self.C])

    def evaluate_objectives(self, x: np.ndarray) -> np.ndarray:
        """Round(C @ x) as the reference does for unoptimised objectives
        (aira.cpp:523-530)."""
        return np.rint(self.C @ x).astype(np.int64)

    def summary(self) -> str:
        kind = "MIN" if self.objsen is Sense.MIN else "MAX"
        return (
            f"Problem({self.filename!r}: {self.objcnt} objectives ({kind}), "
            f"{self.n} vars ({int(self.is_int.sum())} integer), "
            f"{self.m_struct} structural rows)"
        )
