"""Multi-chip mesh tests on the 8-virtual-device CPU mesh (conftest)."""

import numpy as np
import pytest

import jax


def test_make_mesh_shapes():
    from moip_aira_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    assert mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("workers", "strips")
    m1 = make_mesh(1)
    assert m1.size == 1


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_distributed_round_2ap05():
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.mesh import (
        make_distributed_round,
        make_mesh,
        shard_batch,
    )
    from moip_aira_tpu.parallel.symgroup import sym_perms

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    mesh = make_mesh(8)
    step, B = make_distributed_round(p, mesh, batch_per_device=1)
    perms = sym_perms(p.objcnt)
    import jax.numpy as jnp

    rhs = shard_batch(mesh, jnp.asarray(np.tile(p.initial_rhs(), (B, 1))))
    perm = shard_batch(
        mesh,
        jnp.asarray(
            np.array([list(perms[i % len(perms)]) for i in range(B)], dtype=np.int32)
        ),
    )
    status, results, all_status, lo, hi = step(rhs, perm)
    assert (np.asarray(all_status) == 0).all()
    res = np.asarray(results)
    # identity-permutation lanes give the lexmin point (17, 50); the reversed
    # permutation gives (42, 21) — the two ends of the golden front
    assert {tuple(r) for r in res} == {(17, 50), (42, 21)}
    # allreduced bound vectors = elementwise min/max over all lanes
    assert np.asarray(lo)[0].tolist() == [17.0, 21.0]
    assert np.asarray(hi)[0].tolist() == [42.0, 50.0]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_wave_backend_mesh_sharded():
    """Full front computation with LP waves sharded over the CPU mesh."""
    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    front = solve_front(p, n_workers=2, backend="wave", mesh_devices=8)
    assert front.solution_count == 6


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_scheduler_exchange_prunes():
    """The collective bound exchange must actually prune: same exact front,
    strictly fewer ILP subproblems than severed-domains-without-exchange
    (the exchange's reason to exist)."""
    from moip_aira_tpu.api import make_backend
    from moip_aira_tpu.core.store import Solutions
    from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.mesh import make_mesh

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    mesh = make_mesh(8)
    fronts, ips = [], {}
    for ex in (True, False):
        st = Solutions(p.objcnt)
        ms = MeshScheduler(
            p, make_backend(p, "numpy"), mesh, exchange=ex, mode="sync"
        )
        ms.run(6, True, st)
        fronts.append(st.sorted_unique_points())
        ips[ex] = ms.ip_count
        if ex:
            assert ms.severed > 0  # domains really were disconnected
            assert ms.exchanged_boxes > 0  # collective really carried boxes
    assert np.array_equal(fronts[0], fronts[1])  # exactness unaffected
    assert ips[True] < ips[False]  # exchanged bounds pruned subproblems


def test_mesh_exchange_carry_over_unit():
    """>slots new boxes in one round ALL propagate across later rounds in
    arrival order — an earlier version silently dropped the tail
    (`new_boxes[d][:S]`)."""
    from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
    from moip_aira_tpu.io import read_problem

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G2AP05.lp")
    ms = MeshScheduler(p, backend=None, mesh=None, slots=32)
    boxes = np.arange(80 * p.objcnt, dtype=np.float64).reshape(80, p.objcnt)
    sent = [ms._drain_pending(0, boxes)]
    assert len(sent[0]) == 32
    sent.append(ms._drain_pending(0, np.zeros((0, p.objcnt))))
    sent.append(ms._drain_pending(0, np.zeros((0, p.objcnt))))
    assert [len(s) for s in sent] == [32, 32, 16]
    assert np.array_equal(np.vstack(sent), boxes)  # nothing lost, in order
    assert ms.carried_boxes == 48 + 16  # logged backlog per round
    # domains queue independently
    assert len(ms._drain_pending(1, boxes[:5])) == 5
    assert len(ms._drain_pending(0, boxes[:5])) == 5


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_exchange_tiny_slots_parity():
    """A starved slot budget (slots=1) must only DEFER exchange, never
    change the front; the carry counter records the backlog."""
    from moip_aira_tpu.api import make_backend
    from moip_aira_tpu.core.store import Solutions
    from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.mesh import make_mesh

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    # 2 domains x 3 workers: a domain can produce several boxes per round,
    # so slots=1 genuinely starves the exchange (8 domains of 1 would not)
    mesh = make_mesh(2)
    st = Solutions(p.objcnt)
    ms = MeshScheduler(
        p, make_backend(p, "numpy"), mesh, slots=1, mode="sync"
    )
    ms.run(6, True, st)
    ref = Solutions(p.objcnt)
    ms_ref = MeshScheduler(
        p, make_backend(p, "numpy"), mesh, slots=64, mode="sync"
    )
    ms_ref.run(6, True, ref)
    assert np.array_equal(st.sorted_unique_points(), ref.sorted_unique_points())
    assert len(st.sorted_unique_points()) == 7  # golden front size
    assert ms.carried_boxes > 0  # the tiny budget really did defer


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_scheduler_golden_2ap05():
    """Distributed enumeration (workers partitioned over domains, collective
    exchange each round) reproduces the golden front through solve_front."""
    from moip_aira_tpu.api import solve_front
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.symgroup import max_workers

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    front = solve_front(
        p, n_workers=max_workers(p.objcnt), backend="numpy", mesh_devices=8
    )
    assert front.solution_count == 7
    assert front.ip_count > 0 and front.rounds > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_strip_ips_flat_and_golden():
    """Strip mode (the round-5 default): total IPs must stay ~flat as the
    mesh grows — mesh=8 IPs <= 1.2x mesh=1 —
    with the exact golden front at every size."""
    from moip_aira_tpu.api import make_backend
    from moip_aira_tpu.core.store import Solutions
    from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.mesh import make_mesh

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    golden = None
    ips = {}
    for n_dev in (1, 8):
        st = Solutions(p.objcnt)
        ms = MeshScheduler(
            p, make_backend(p, "numpy"), make_mesh(n_dev), mode="strip"
        )
        ms.run(6, True, st)
        pts = st.sorted_unique_points()
        assert len(pts) == 7  # golden front size
        if golden is None:
            golden = pts
        else:
            assert np.array_equal(pts, golden)
        ips[n_dev] = ms.ip_count
    assert ips[8] <= 1.2 * ips[1], ips


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_mesh_strip_exchange_carries_boxes():
    """The strip-mode collective really ships infeasible boxes when the
    mesh has >1 domain."""
    from moip_aira_tpu.api import make_backend
    from moip_aira_tpu.core.store import Solutions
    from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler
    from moip_aira_tpu.io import read_problem
    from moip_aira_tpu.parallel.mesh import make_mesh

    from conftest import EXAMPLES

    p = read_problem(f"{EXAMPLES}/G3AP05.lp")
    st = Solutions(p.objcnt)
    ms = MeshScheduler(
        p, make_backend(p, "numpy"), make_mesh(4), mode="strip"
    )
    ms.run(6, True, st)
    assert len(st.sorted_unique_points()) == 7
    assert ms.exchanged_boxes > 0
