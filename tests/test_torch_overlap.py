"""The overlapped round pipeline of the port's engine:
``RoundSchedule(overlap=True)`` must be bitwise the synchronous loop.

The pipeline only moves WHEN host planning happens (chunk N+1 is
planned and staged once chunk N's ops are enqueued), never WHAT is
planned: the host rng and the per-round id generators advance in
execution order either way, and ``commit_chunk`` splices staged rows
into the latest table.  On the CPU every op runs when it is called, so
these tests pin the ordering and the bookkeeping (the stream and event
discipline of the card is held by ``tests/test_torch_cuda.py``):

  - sparse store with capacity forcing eviction, spill and refill
    across dispatch boundaries (scaffold and moon, host and device
    sampling): bitwise;
  - dense store (no residency; plans are still made ahead): bitwise;
  - the pod backend on a one-rank mesh with the sharded sparse store,
    and ``PodFLConfig``'s default ``overlap=True``: bitwise;
  - a slow ``stage_chunk`` only costs time, results and the dispatch
    count stay;
  - ``EngineResult.timing`` carries the five keys;
  - a refault burst is invisible in the results and the spill worker's
    time is reported;
  - a switch policy forces the synchronous loop.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import pod
from repro_torch.fl.engine import (TIMING_KEYS, AggregateStrategy,
                                   DenseClientStateStore, RoundSchedule,
                                   SparseClientStateStore, run_rounds)
from repro_torch.fl.local import LocalSpec
from repro_torch.fl.task import vision_task
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.utils import tree_math as tm

SEED = 0
N_CLIENTS = 8
CAPACITY = 4


@pytest.fixture(scope="module")
def setup():
    task = vision_task("mlp", in_ch=1, seed_kwargs={"img": 8, "d_hidden": 16})
    rng = np.random.default_rng(SEED)
    per = 16
    x = rng.normal(size=(N_CLIENTS, per, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(N_CLIENTS, per)).astype(np.int32)
    data = FederatedDataset(x=x, y=y,
                            n_real=np.full((N_CLIENTS,), per, np.int32),
                            test_x=x[0], test_y=y[0], n_classes=10,
                            name="overlap-test")
    return task, data


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh("cpu")


def _sched(sampling, *, overlap, rounds=6, chunk=2):
    return RoundSchedule(rounds=rounds, lr_decay=1.0, eval_every=0,
                         seed=SEED, chunk_size=chunk, sampling=sampling,
                         host_rng_offset=17, overlap=overlap)


def _spec(algo="scaffold"):
    return LocalSpec(n_steps=2, batch_size=4, lr=0.05, variant=algo,
                     update_impl="fused_interpret")


def _host_run(setup, store, sched, algo="scaffold", **kw):
    task, data = setup
    strat = AggregateStrategy(spec=_spec(algo), algorithm=algo,
                              participation=0.25, state_store=store)
    return run_rounds(task, data, strat, sched, device="cpu", **kw)


def _state_leaves(state):
    """The tensors of an ``algo_state`` (the pod's dense store keeps its
    rows in a ``ClientRows``)."""
    return tm.tree_leaves({k: v.rows if isinstance(v, pod.ClientRows) else v
                           for k, v in state.items()})


def _assert_bitwise(a, b):
    assert [h["local_loss"] for h in a.history] == \
        [h["local_loss"] for h in b.history]
    for x, y in zip(tm.tree_leaves(a.params), tm.tree_leaves(b.params)):
        assert torch.equal(x, y)
    la, lb = _state_leaves(a.algo_state), _state_leaves(b.algo_state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert a.dispatches == b.dispatches


@pytest.mark.parametrize("algo", ["scaffold", "moon"])
@pytest.mark.parametrize("sampling", ["host", "device"])
def test_overlap_matches_sync_sparse_host(setup, algo, sampling):
    """capacity 4 with chunk 2 × K 2 evicts, spills and refaults rows at
    the dispatch boundaries — where a stale index or an early or late
    draw would diverge."""
    sync = _host_run(setup, SparseClientStateStore(capacity=CAPACITY),
                     _sched(sampling, overlap=False), algo)
    ovl = _host_run(setup, SparseClientStateStore(capacity=CAPACITY),
                    _sched(sampling, overlap=True), algo)
    _assert_bitwise(sync, ovl)


def test_overlap_matches_sync_dense(setup):
    """Dense store: no residency, but planning ahead moves the host rng's
    draws relative to the dispatch — which must not matter."""
    sync = _host_run(setup, DenseClientStateStore(),
                     _sched("host", overlap=False))
    ovl = _host_run(setup, DenseClientStateStore(),
                    _sched("host", overlap=True))
    _assert_bitwise(sync, ovl)
    assert ovl.timing["host_residency_ms"] == 0.0


def test_overlap_matches_sync_pod(setup, mesh):
    task, data = setup

    def run(overlap):
        strat = pod.PodAggregateStrategy(
            spec=_spec(), algorithm="scaffold", mesh=mesh,
            clients_per_round=2,
            state_store=pod.ShardedSparseClientStateStore(capacity=CAPACITY,
                                                          mesh=mesh))
        return run_rounds(task, data, strat, _sched("host", overlap=overlap),
                          device="cpu")

    _assert_bitwise(run(False), run(True))


def test_pod_config_default_overlap_runs_the_pipeline(setup, mesh):
    """``PodFLConfig``'s default ``overlap=True`` reaches the schedule
    and equals ``overlap=False`` bitwise, sparse and dense."""
    task, data = setup
    runs = {}
    for store in ("dense", "sparse"):
        for overlap in (True, False):
            cfg = pod.PodFLConfig(
                mesh, rounds=4, clients_per_round=2, chunk_size=2,
                spec=pod.PodFLSpec(algorithm="scaffold", local_steps=2,
                                   batch_size=4, lr=0.05,
                                   update_impl="fused_interpret"),
                sampling="host", store=store, store_capacity=CAPACITY,
                **({} if overlap else {"overlap": False}))
            assert cfg.schedule().overlap is overlap
            runs[store, overlap] = pod.run_pod_rounds(task, data, cfg)
    _assert_bitwise(runs["sparse", True], runs["sparse", False])
    _assert_bitwise(runs["dense", True], runs["dense", False])
    for x, y in zip(tm.tree_leaves(runs["dense", True].params),
                    tm.tree_leaves(runs["sparse", True].params)):
        assert torch.equal(x, y)


class _SlowStageStore(SparseClientStateStore):
    """Host planning slower than the device's work: the pipeline's stage
    becomes the bottleneck, and must change nothing but the time."""

    def stage_chunk(self, ids_block):
        time.sleep(0.02)
        return super().stage_chunk(ids_block)


def test_slow_host_prep_degrades_gracefully(setup):
    sync = _host_run(setup, _SlowStageStore(capacity=CAPACITY),
                     _sched("host", overlap=False))
    ovl = _host_run(setup, _SlowStageStore(capacity=CAPACITY),
                    _sched("host", overlap=True))
    _assert_bitwise(sync, ovl)
    assert ovl.dispatches == 3          # ceil(6 rounds / chunk 2)
    assert ovl.timing["host_residency_ms"] >= 3 * 20.0


def test_timing_breakdown_populated(setup):
    res = _host_run(setup, SparseClientStateStore(capacity=CAPACITY),
                    _sched("host", overlap=True))
    assert set(res.timing) == set(TIMING_KEYS) == {
        "host_residency_ms", "staged_transfer_ms", "dispatch_enqueue_ms",
        "device_wait_ms", "spill_materialize_ms"}
    assert all(v >= 0.0 for v in res.timing.values())
    # the sparse path really staged rows
    assert res.timing["staged_transfer_ms"] > 0.0
    assert res.timing["host_residency_ms"] >= \
        res.timing["staged_transfer_ms"]


def test_refault_burst_is_bitwise_and_spill_time_is_surfaced(setup):
    """capacity 4 against 8 clients with K 2 × chunk 2 turns every
    dispatch boundary into an eviction burst: rows spill to host memory
    and refault on the client's next turn.  Invisible in the results
    (sparse == dense, overlap == sync, bitwise); the spill worker's time
    is reported apart from ``host_residency_ms``."""
    rounds = 10
    dense = _host_run(setup, DenseClientStateStore(),
                      _sched("host", overlap=False, rounds=rounds))
    sync_store = SparseClientStateStore(capacity=CAPACITY)
    sync = _host_run(setup, sync_store,
                     _sched("host", overlap=False, rounds=rounds))
    ovl_store = SparseClientStateStore(capacity=CAPACITY)
    ovl = _host_run(setup, ovl_store,
                    _sched("host", overlap=True, rounds=rounds))
    _assert_bitwise(sync, ovl)
    assert [h["local_loss"] for h in dense.history] == \
        [h["local_loss"] for h in ovl.history]
    for x, y in zip(tm.tree_leaves(dense.params), tm.tree_leaves(ovl.params)):
        assert torch.equal(x, y)
    for store in (sync_store, ovl_store):
        assert store.spilled_rows > 0 and store.refaulted_rows > 0
    assert ovl.timing["spill_materialize_ms"] > 0.0, ovl.timing
    assert sync.timing["spill_materialize_ms"] > 0.0, sync.timing


def test_switch_policy_forces_overlap_off(setup):
    """A switch policy needs each round's history before the next round
    is planned, so the engine drops to the synchronous chunk-1 loop —
    results equal an explicit synchronous run."""

    class _NeverSwitch:
        def __init__(self):
            self.calls = 0

        def should_switch(self, rnd, history):
            self.calls += 1
            assert len(history) == rnd + 1
            return False

    def run(overlap):
        policy = _NeverSwitch()
        res = _host_run(setup, SparseClientStateStore(capacity=CAPACITY),
                        _sched("host", overlap=overlap, rounds=4),
                        switch_policy=policy)
        return res, policy

    (a, pa), (b, pb) = run(False), run(True)
    _assert_bitwise(a, b)
    assert a.dispatches == 4 and pa.calls == pb.calls == 4
