"""Batched lexicographic branch-and-bound — the monolithic device kernel.

One jitted call solves a whole batch of CLMOIP subproblems end-to-end on
device: for each lane, a ``lax.scan`` over the objective permutation runs a
depth-first branch-and-bound (``lax.while_loop`` over a fixed-capacity node
stack) whose LP relaxations are the dense bounded-variable simplex of
simplex_jax.py, in float64.  This is the batched replacement for the reference's
per-worker ``CPXmipopt`` loop (src/aira.cpp:452-536): where the reference
gets parallelism from OS threads each blocking in CPLEX, here every AIRA
worker / EPP strip / B&B node is a vmap lane on the same chip.

Lanes that exhaust the static node stack or iteration budget report a
resource flag and are re-solved by the exact NumPy backend on the host — a
safety valve that keeps the device shapes small and static.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense
from moip_aira_tpu.solver import simplex_jax as sx
from moip_aira_tpu.solver.lex import LexOutcome, LexRequest, NumpyLexBackend
from moip_aira_tpu.solver.status import SolveStatus
from moip_aira_tpu.utils.device import enable_compile_cache

INT_TOL = 1e-6

# status codes for a lex solve lane
LEX_OPTIMAL = 0
LEX_INFEASIBLE = 1
LEX_RESOURCE = 3  # node stack overflow / iteration limit -> host fallback


def _ceil_tol(v):
    return jnp.ceil(v - INT_TOL)


def make_lex_vmapped(problem: Problem, **kw):
    """The vmapped (un-jitted) kernel — for composition under shard_map/jit
    with mesh shardings (parallel/mesh.py)."""
    return make_lex_kernel(problem, jit_wrap=False, **kw)


def make_lex_kernel(
    problem: Problem,
    max_nodes_stack: int = 160,
    max_bnb_nodes: int = 20000,
    lp_max_iters: int = 2000,
    jit_wrap: bool = True,
):
    """Build the jitted batched kernel for one Problem.

    Returns fn(rhs (B,k) f64, perm (B,k) i32) ->
      (status (B,) i32, results (B,k) i64, ip_counts (B,) i32)
    """
    p = problem
    k = p.objcnt
    n = p.n
    m = p.m_total
    is_min = p.objsen is Sense.MIN

    A_full = np.vstack([p.A, p.C])
    W = jnp.asarray(np.hstack([A_full, -np.eye(m)]))
    lp_solve = sx.make_lp_solver(W, lp_max_iters)

    C = jnp.asarray(p.C)
    lb = jnp.asarray(p.lb)
    ub = jnp.asarray(p.ub)
    row_lb = jnp.asarray(p.row_lb)
    row_ub = jnp.asarray(p.row_ub)
    is_int = jnp.asarray(p.is_int)
    obj_integral = jnp.asarray(
        [
            bool(
                np.all(p.C[j] == np.rint(p.C[j]))
                and np.all(p.is_int[np.abs(p.C[j]) > 0])
            )
            for j in range(k)
        ]
    )

    MAXN = max_nodes_stack

    def bnb(c_struct, obj_int, srhs, active):
        """Min c_struct @ x s.t. structural rows, objective rows <=/>= srhs,
        variable integrality. Returns (found, resource, unbounded, obj, x,
        nodes).  ``active=False`` lanes start with an empty stack so the
        vmapped while_loop costs them nothing."""
        if is_min:
            olo = jnp.full((k,), -jnp.inf)
            ohi = srhs
        else:
            olo = srhs
            ohi = jnp.full((k,), jnp.inf)
        lo_log = jnp.concatenate([row_lb, olo])
        hi_log = jnp.concatenate([row_ub, ohi])
        c_full = jnp.concatenate([c_struct, jnp.zeros(m)])

        stack_lo = jnp.zeros((MAXN, n)).at[0].set(lb)
        stack_hi = jnp.zeros((MAXN, n)).at[0].set(ub)

        st0 = dict(
            stack_lo=stack_lo,
            stack_hi=stack_hi,
            sp=jnp.where(active, 1, 0).astype(jnp.int32),
            best=jnp.float64(jnp.inf),
            best_x=jnp.zeros(n),
            nodes=jnp.int32(0),
            resource=jnp.bool_(False),
            unbounded=jnp.bool_(False),
        )

        def cond(st):
            return (st["sp"] > 0) & ~st["resource"] & ~st["unbounded"]

        def body(st):
            sp = st["sp"] - 1
            nlo = st["stack_lo"][sp]
            nhi = st["stack_hi"][sp]
            lo = jnp.concatenate([nlo, lo_log])
            hi = jnp.concatenate([nhi, hi_log])
            out = lp_solve(c_full, lo, hi)
            nodes = st["nodes"] + 1
            resource = st["resource"] | (nodes > max_bnb_nodes) | (
                out.status == sx.ITER_LIMIT
            )
            unbounded = st["unbounded"] | (out.status == sx.UNBOUNDED)

            feasible_lp = out.status == sx.OPTIMAL
            bound = jnp.where(obj_int, _ceil_tol(out.obj), out.obj)
            pruned = bound >= st["best"] - jnp.where(obj_int, INT_TOL, 1e-9)

            frac = jnp.where(is_int, jnp.abs(out.x - jnp.rint(out.x)), 0.0)
            jvar = jnp.argmax(frac).astype(jnp.int32)
            integral = frac[jvar] <= INT_TOL

            improves = out.obj < st["best"] - INT_TOL
            take = feasible_lp & ~pruned & integral & improves
            best = jnp.where(take, out.obj, st["best"])
            best_x = jnp.where(take, out.x, st["best_x"])

            branch = feasible_lp & ~pruned & ~integral
            overflow = branch & (sp + 2 > MAXN)
            resource = resource | overflow
            can_push = branch & ~overflow

            fl = jnp.floor(out.x[jvar] + INT_TOL)
            # push "up" child first, "down" child on top (DFS explores down)
            up_lo = nlo.at[jvar].set(fl + 1.0)
            dn_hi = nhi.at[jvar].set(fl)
            slo = st["stack_lo"]
            shi = st["stack_hi"]
            slo = jnp.where(can_push, slo.at[sp].set(up_lo).at[sp + 1].set(nlo), slo)
            shi = jnp.where(can_push, shi.at[sp].set(nhi).at[sp + 1].set(dn_hi), shi)
            new_sp = jnp.where(can_push, sp + 2, sp)

            return dict(
                stack_lo=slo,
                stack_hi=shi,
                sp=new_sp.astype(jnp.int32),
                best=best,
                best_x=best_x,
                nodes=nodes,
                resource=resource,
                unbounded=unbounded,
            )

        fin = jax.lax.while_loop(cond, body, st0)
        found = jnp.isfinite(fin["best"]) & ~fin["resource"]
        return found, fin["resource"], fin["unbounded"], fin["best"], fin[
            "best_x"
        ], fin["nodes"]

    def lex_one(rhs, perm):
        """Full lexicographic solve for one lane."""

        def stage(carry, j):
            srhs, alive, resource, result, ips = carry
            c = (1.0 if is_min else -1.0) * C[j]
            active = alive & ~resource
            found, res_flag, unb, obj, x, nodes = bnb(
                c, obj_integral[j], srhs, active
            )
            found = found & active
            res_flag = res_flag & active
            sense_obj = jnp.where(is_min, obj, -obj)
            val = jnp.rint(sense_obj)
            new_alive = alive & found
            new_resource = resource | res_flag
            result = jnp.where(new_alive, result.at[j].set(val.astype(jnp.int64)), result)
            srhs = jnp.where(new_alive, srhs.at[j].set(val), srhs)
            ips = ips + jnp.where(alive & ~resource, 1, 0)
            return (srhs, new_alive, new_resource, result, ips), None

        carry0 = (
            rhs,
            jnp.bool_(True),
            jnp.bool_(False),
            jnp.zeros(k, dtype=jnp.int64),
            jnp.int32(0),
        )
        (srhs, alive, resource, result, ips), _ = jax.lax.scan(
            stage, carry0, perm
        )
        status = jnp.where(
            resource,
            jnp.int32(LEX_RESOURCE),
            jnp.where(alive, jnp.int32(LEX_OPTIMAL), jnp.int32(LEX_INFEASIBLE)),
        )
        return status, result, ips

    batched = jax.vmap(lex_one)
    return jax.jit(batched) if jit_wrap else batched


class JaxLexBackend:
    """Batched device backend with host fallback for resource-limited lanes.

    A single static batch width is used for every call (padded with dummy
    lanes / chunked when oversubscribed) so each problem shape triggers
    exactly ONE device compile, which the persistent compile cache
    (utils/device.py) then keeps across runs.
    """

    name = "jax"

    def __init__(self, problem: Problem, batch_width: int = 32, **kernel_kwargs):
        jax.config.update("jax_enable_x64", True)
        enable_compile_cache()
        self.problem = problem
        self.batch_width = batch_width
        self.kernel = make_lex_kernel(problem, **kernel_kwargs)
        self._fallback = NumpyLexBackend(problem)
        self.device_batches = 0
        self.fallback_count = 0

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        if not reqs:
            return []
        out: List[LexOutcome] = []
        for i0 in range(0, len(reqs), self.batch_width):
            out.extend(self._solve_chunk(reqs[i0 : i0 + self.batch_width]))
        return out

    def _solve_chunk(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        b = len(reqs)
        size = self.batch_width
        k = self.problem.objcnt
        rhs = np.zeros((size, k), dtype=np.float64)
        perm = np.tile(np.arange(k, dtype=np.int32), (size, 1))
        # dummy lanes replay lane 0 (cheap: relaxation identical, converges
        # with the batch)
        rhs[:] = reqs[0].rhs
        perm[:] = np.asarray(reqs[0].perm, dtype=np.int32)
        for i in range(b):
            rhs[i] = reqs[i].rhs
            perm[i] = np.asarray(reqs[i].perm, dtype=np.int32)

        status, results, ips = self.kernel(jnp.asarray(rhs), jnp.asarray(perm))
        status = np.asarray(status)
        results = np.asarray(results)
        ips = np.asarray(ips)
        self.device_batches += 1

        out: List[LexOutcome] = []
        for i in range(b):
            if status[i] == LEX_RESOURCE:
                # exact host fallback for pathological lanes
                self.fallback_count += 1
                out.append(self._fallback.lex_solve(reqs[i]))
            elif status[i] == LEX_OPTIMAL:
                out.append(
                    LexOutcome(
                        SolveStatus.OPTIMAL,
                        results[i].astype(np.int64),
                        int(ips[i]),
                    )
                )
            else:
                out.append(
                    LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[i]))
                )
        return out
