"""Bulk-synchronous round scheduler.

This is the execution substrate that replaces the reference's
one-OS-thread-per-worker model (src/aira.cpp:297-324): all live workers are
advanced until each either finishes or yields a CLMOIP subproblem; the
round's subproblems are then solved as ONE batched backend call (on the
device: one batched wave of LPs, or one jitted vmapped lexicographic
branch-and-bound kernel), results are fed
back, and the next round begins.  Bound sharing between workers happens
naturally at round boundaries — the device-side analogue of the reference's
shared-memory exchange, and the single-host analogue of the mesh collective
exchange in parallel/mesh.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from moip_aira_tpu.core.store import Solutions
from moip_aira_tpu.engine.worker import aira_worker
from moip_aira_tpu.engine.worker_spec import WorkerSpec
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.solver.lex import LexRequest


class Scheduler:
    """Runs a set of AIRA workers to completion against a lex-solve backend."""

    def __init__(self, problem: Problem, backend):
        self.problem = problem
        self.backend = backend
        self.ip_count = 0
        self.rounds = 0
        self.batch_sizes: List[int] = []

    def run(
        self,
        specs: Sequence[WorkerSpec],
        all_store: Solutions,
        infeasibles: Optional[Solutions] = None,
    ) -> Solutions:
        """Advance all workers to completion; returns ``all_store``."""
        if infeasibles is None:
            infeasibles = Solutions(self.problem.objcnt)

        gens = []
        for spec in specs:
            g = aira_worker(self.problem, spec, all_store, infeasibles)
            gens.append((spec, g))

        # Prime every worker to its first yield.
        live = []  # (spec, gen, pending_rhs)
        for spec, g in gens:
            try:
                rhs = next(g)
                live.append([spec, g, rhs])
            except StopIteration:
                pass

        from moip_aira_tpu.utils.trace import GLOBAL_TIMINGS, TRACE, trace

        while live:
            self.rounds += 1
            reqs = [
                LexRequest(rhs=item[2], perm=item[0].perm) for item in live
            ]
            self.batch_sizes.append(len(reqs))
            if TRACE:
                for item, r in zip(live, reqs):
                    trace(item[0].id, f"round {self.rounds}: solve rhs={r.rhs}")
            with GLOBAL_TIMINGS.span("scheduler.solve_round"):
                outcomes = self.backend.lex_solve_batch(reqs)
            nxt = []
            for item, out in zip(live, outcomes):
                spec, g, _ = item
                self.ip_count += out.ip_solves
                reply = (out.status.is_infeasible, out.result)
                try:
                    rhs = g.send(reply)
                    nxt.append([spec, g, rhs])
                except StopIteration:
                    pass
            live = nxt
        return all_store
