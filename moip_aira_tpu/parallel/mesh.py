"""Multi-chip execution: device meshes, sharded solve rounds, bound-exchange
collectives.

Reference parity: src/lockingvars.h + the bound-sharing protocol of
src/aira.cpp:679-692, 923-1107, 1111-1551.  The reference exchanges bounds
through shared-memory ``int*`` cells under a mutex; here the multi-chip
equivalent is bulk-synchronous (SURVEY §5 north star):

* the round's CLMOIP subproblems are a batch sharded over the mesh — each
  chip solves its share of AIRA workers / EPP strips / B&B nodes,
* per-objective bounds are combined with a min/max allreduce over the mesh
  axes (``jax.lax.pmin``/``pmax`` inside ``shard_map``, device to device),
* newly found incumbent points are allgathered so every chip's relaxation
  store can prune with them.

The mesh axes play the roles of the reference's two decompositions: the
``workers`` axis carries the synergistic permutation workers and the
``strips`` axis the EPP range strips (a chip owns one (ordering, strip)
pair) — the analogue of dp x tp axis layouts in ML meshes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
try:
    from jax import shard_map as _shard_map

    def shard_map(f, **kw):  # jax>=0.7 renamed check_rep -> check_vma
        kw["check_vma"] = kw.pop("check_rep", True)
        return _shard_map(f, **kw)
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import Sense

BIGVAL = np.float64(2**52)


def make_mesh(
    n_devices: Optional[int] = None, axes: Tuple[str, str] = ("workers", "strips")
) -> Mesh:
    """A 2D mesh over the available devices.

    The second axis gets the largest power-of-two factor <= sqrt(n), the
    first the rest — e.g. 8 devices -> (4, 2), 1 device -> (1, 1).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    s = 1
    while s * 2 <= max(1, int(n**0.5)) and n % (s * 2) == 0:
        s *= 2
    w = n // s
    arr = np.array(devs).reshape(w, s)
    return Mesh(arr, axes)


def make_distributed_round(problem: Problem, mesh: Mesh, batch_per_device: int = 2):
    """One bulk-synchronous solve round, jitted over the mesh.

    Returns (step_fn, batch_size).  ``step_fn(rhs, perm)`` with
    rhs (B, k) f64 and perm (B, k) i32, B = batch_per_device * mesh size:

      1. shards the subproblem batch over BOTH mesh axes,
      2. runs the full lexicographic branch-and-bound kernel per lane,
      3. allreduces per-objective bound vectors (min and max) over the mesh
         (the collective replacement for the reference's shared cells), and
      4. allgathers every lane's result so each host-side store can merge
         the round's incumbents.

    This is the "full training step" of the framework: compute + collectives
    in one compiled program.
    """
    from moip_aira_tpu.solver.lex_jax import make_lex_vmapped

    vm = make_lex_vmapped(problem)
    axes = tuple(mesh.axis_names)
    nd = mesh.size
    B = batch_per_device * nd
    k = problem.objcnt
    batch_spec = P(axes, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(batch_spec, batch_spec),
        out_specs=(
            P(axes),  # per-shard status
            P(None, None),  # allgathered results
            P(None),  # allgathered status
            P(None, None),  # reduced lower bounds
            P(None, None),  # reduced upper bounds
        ),
        check_rep=False,
    )
    def local_round(rhs, perm):
        status, results, ips = vm(rhs, perm)
        feas = status == 0
        vals = results.astype(jnp.float64)
        lo_loc = jnp.where(feas[:, None], vals, BIGVAL).min(axis=0)
        hi_loc = jnp.where(feas[:, None], vals, -BIGVAL).max(axis=0)
        # monotone min/max reduction across devices — the reference's
        # `share_bounds` fixpoint (aira.cpp:1374-1512) in one collective
        for ax in axes:
            lo_loc = jax.lax.pmin(lo_loc, ax)
            hi_loc = jax.lax.pmax(hi_loc, ax)
        # allgather incumbents (the `found_any` / solution broadcast)
        all_results = results
        all_status = status
        for ax in axes:
            all_results = jax.lax.all_gather(all_results, ax, tiled=True)
            all_status = jax.lax.all_gather(all_status, ax, tiled=True)
        return status, all_results, all_status, lo_loc[None], hi_loc[None]

    @jax.jit
    def step(rhs, perm):
        return local_round(rhs, perm)

    return step, B


def shard_batch(mesh: Mesh, arr: jnp.ndarray) -> jnp.ndarray:
    """Place a batch-leading array with its batch dim split over the mesh."""
    spec = P(tuple(mesh.axis_names), *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def make_bound_exchange(mesh: Mesh, k: int, slots: int):
    """The per-round enumeration collective (reference aira.cpp:923-1551
    intent, SURVEY §5 north star), as ONE compiled program over the mesh:

    * **allgather of infeasible boxes** — the reference's only cross-worker
      store is the shared ``infeasibles`` list (aira.cpp:816-827); an
      infeasible objective-bound box is permutation-independent, so every
      domain can prune with every other domain's dead ends.  (Feasible lex
      results are NOT exchangeable across domains: they are lexicographic
      optima *under the producing worker's permutation*, which is why the
      reference, too, keeps per-thread private solution stores.)
    * **pmin/pmax allreduce of solved objective values** — after the first
      round this yields the exact ideal point (each objective led by some
      worker), from which domains derive sound "beyond the ideal point"
      infeasibility cuts.

    Returns ``exchange(boxes, flags, vals, vflags)`` where per-device arrays
    are stacked into a (D*slots, …) batch sharded over the mesh:
      boxes  (D*slots, k) f64 — infeasible rhs boxes (padding rows arbitrary)
      flags  (D*slots,)  i32 — 1 = real box, 0 = padding
      vals   (D*slots, k) f64 — feasible result vectors
      vflags (D*slots,)  i32 — 1 = real value row, 0 = padding
    and returns (all_boxes, all_flags, lo, hi) replicated on every device.
    """
    axes = tuple(mesh.axis_names)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axes, None), P(axes), P(axes, None), P(axes)),
        out_specs=(P(None, None), P(None), P(None, None), P(None, None)),
        check_rep=False,
    )
    def _exchange(boxes, flags, vals, vflags):
        vmask = (vflags > 0)[:, None]
        lo_loc = jnp.where(vmask, vals, BIGVAL).min(axis=0)
        hi_loc = jnp.where(vmask, vals, -BIGVAL).max(axis=0)
        for ax in axes:
            lo_loc = jax.lax.pmin(lo_loc, ax)
            hi_loc = jax.lax.pmax(hi_loc, ax)
        all_boxes = boxes
        all_flags = flags
        for ax in axes:
            all_boxes = jax.lax.all_gather(all_boxes, ax, tiled=True)
            all_flags = jax.lax.all_gather(all_flags, ax, tiled=True)
        return all_boxes, all_flags, lo_loc[None], hi_loc[None]

    return jax.jit(_exchange)
