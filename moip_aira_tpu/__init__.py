"""moip_aira_tpu — an exact multi-objective integer programming framework in JAX.

A from-scratch rebuild of the capabilities of WPettersson/moip_aira (the AIRA
recursive algorithm of Ozlen-Burton-MacRae 2014 plus the synergistic and EPP
parallel decompositions of Pettersson-Ozlen 2019), built for an accelerator:

* The inner single-objective ILP subproblems (reference: CPLEX ``CPXmipopt``,
  src/aira.cpp:452-536) are solved by a batched dense bounded-variable simplex
  plus branch-and-bound written in JAX, vmapped over many independent
  subproblems per device.
* The worker decompositions (reference: src/cluster.cpp, src/aira.cpp:1886-1990)
  become host-side state machines feeding a bulk-synchronous batched solve
  round, with bound sharing performed between rounds.
* Multi-chip scaling uses a ``jax.sharding.Mesh`` with min/max allreduce of
  bound vectors and allgather of incumbents, replacing the reference's
  shared-memory ``Locking_Vars`` cells (src/lockingvars.h).
"""

__version__ = "0.1.0"

from moip_aira_tpu.sense import Sense, INF
from moip_aira_tpu.problem import Problem

__all__ = ["Sense", "INF", "Problem", "__version__"]
