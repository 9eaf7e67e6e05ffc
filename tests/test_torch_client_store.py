"""The port's ``SparseClientStateStore`` against its dense oracle and
against the JAX package's store, on the CPU.

  - store-level gather/scatter round trips over id sequences with
    capacity < n_clients (a seeded case and hypothesis sweeps): eviction,
    spill to host memory and refill of cold clients across dispatches;
  - ``spill=False``, the forgetful mode (a refault is the template);
  - a dispatch with more distinct clients than the capacity raises;
  - ``population`` is ``n_clients``, not the capacity;
  - the residency plan (``slot_of``, ``owner``, ``stamp`` and
    ``to_dense``) equals the JAX ``SparseClientStateStore``'s on the same
    id sequences;
  - engine runs: sparse == dense BITWISE for scaffold and moon on the
    tree and ``fused_interpret`` paths, under host and device sampling,
    and for scaffold with int8 + top-k + error-feedback uploads (both of
    its tables sparse), with capacity 4 < chunk 2 × K 2 × 3 dispatches,
    so rows spill and fault back in.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.fl.engine import SparseClientStateStore as JSparseStore
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.compression import CompressionSpec
from repro_torch.fl.engine import (DENSE_STORE, AggregateStrategy,
                                   DenseClientStateStore, RoundSchedule,
                                   SparseClientStateStore, run_rounds)
from repro_torch.fl.local import LocalSpec
from repro_torch.fl.task import vision_task
from repro_torch.utils import tree_math as tm

SEED = 0
N_CLIENTS = 8
CAPACITY = 4            # chunk 2 × K 2 → at most 4 distinct per dispatch


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
                            name="store-test")
    return task, data


def _template():
    return {"a": torch.arange(3, dtype=torch.float32),
            "b": torch.zeros((2, 2), dtype=torch.float32)}


def _rows_for(ids, scale):
    """Per-client rows whose values name the client and the dispatch."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.float32)
    return {"a": scale * ids[:, None] + torch.arange(3.0)[None, :],
            "b": (scale * ids)[:, None, None].expand(len(ids), 2, 2).clone()}


def _drive(store, dispatches, n_clients):
    """Replay dispatches through a store AND a dict reference: each
    gathers (checking residency brought the right rows in), rewrites its
    rows and scatters them back."""
    state = store.init(_template(), n_clients)
    reference = {}
    for t, ids in enumerate(dispatches):
        ids = np.asarray(sorted(ids), np.int64)
        if ids.size == 0:
            continue
        state = store.prepare_chunk(state, ids)
        got = store.gather(state, torch.as_tensor(ids))
        for j, cid in enumerate(ids):
            want = reference.get(int(cid), _template())
            assert torch.equal(got["a"][j], want["a"])
            assert torch.equal(got["b"][j], want["b"])
        rows = _rows_for(ids, scale=float(t + 1))
        state = store.scatter(state, torch.as_tensor(ids), rows)
        for j, cid in enumerate(ids):
            reference[int(cid)] = {"a": rows["a"][j], "b": rows["b"][j]}
    return state, reference


def _check_dense_view(store, state, reference, n_clients):
    dense = store.to_dense(state)
    for cid in range(n_clients):
        want = reference.get(cid, _template())
        assert torch.equal(dense["a"][cid], want["a"])
        assert torch.equal(dense["b"][cid], want["b"])


def test_gather_scatter_roundtrip_with_eviction_refill():
    """A client written in dispatch 0, evicted while others run, comes
    back with its written row (host spill) in a later dispatch."""
    store = SparseClientStateStore(capacity=3)
    dispatches = [[0, 1, 2], [3, 4, 5], [6, 7, 3], [0, 1, 5], [2, 4, 6]]
    state, reference = _drive(store, dispatches, n_clients=8)
    _check_dense_view(store, state, reference, n_clients=8)
    assert store.spill_materialize_ms > 0.0
    assert store.spilled_rows == 11 and store.refaulted_rows == 6


def test_forgetful_mode_drops_evicted_rows():
    store = SparseClientStateStore(capacity=2, spill=False)
    state = store.init(_template(), 6)
    state = store.prepare_chunk(state, np.array([0, 1]))
    state = store.scatter(state, torch.tensor([0, 1]), _rows_for([0, 1], 9.0))
    state = store.prepare_chunk(state, np.array([2, 3]))   # evicts 0 and 1
    state = store.prepare_chunk(state, np.array([0]))      # 0 refaults...
    got = store.gather(state, torch.tensor([0]))
    assert torch.equal(got["a"][0], _template()["a"])      # ...as the template
    assert not store._cold and store.refaulted_rows == 0


def test_capacity_must_cover_one_dispatch():
    store = SparseClientStateStore(capacity=2)
    state = store.init(_template(), 8)
    with pytest.raises(ValueError, match="capacity"):
        store.prepare_chunk(state, np.array([0, 1, 2]))
    with pytest.raises(ValueError, match="capacity"):
        SparseClientStateStore(capacity=0)


def test_population_reports_n_clients_not_capacity():
    sparse = SparseClientStateStore(capacity=3)
    assert sparse.population(sparse.init(_template(), 11)) == 11
    assert DENSE_STORE.population(DENSE_STORE.init(_template(), 11)) == 11


def test_init_leaves_the_template_untouched():
    tmpl = _template()
    store = SparseClientStateStore(capacity=2)
    state = store.prepare_chunk(store.init(tmpl, 4), np.array([1]))
    store.scatter(state, torch.tensor([1]), _rows_for([1], 5.0))
    assert torch.equal(tmpl["a"], _template()["a"])


def test_hypothesis_random_id_sequences():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None, database=None)
    @hyp.given(st.lists(
        st.sets(st.integers(min_value=0, max_value=9),
                min_size=0, max_size=4),
        min_size=1, max_size=8))
    def run(dispatches):
        store = SparseClientStateStore(capacity=4)
        state, reference = _drive(store, dispatches, n_clients=10)
        _check_dense_view(store, state, reference, n_clients=10)

    run()


def test_sparse_store_is_identity_hashed():
    """Mutable spill members make every store its own object."""
    a = SparseClientStateStore(capacity=4)
    b = SparseClientStateStore(capacity=4)
    assert a != b and hash(a) != hash(b)
    assert dataclasses.is_dataclass(a)


# ---------------------------------------------------------------------------
# the residency plan against the JAX package's store
# ---------------------------------------------------------------------------

PLAN_SEQUENCES = {
    "revisits": [[0, 1, 2], [3, 4, 5], [6, 7, 3], [0, 1, 5], [2, 4, 6]],
    "random": [list(np.random.default_rng(s).choice(12, size=4,
                                                     replace=False))
               for s in range(10)],
}


@pytest.mark.parametrize("name", PLAN_SEQUENCES)
def test_residency_plan_matches_jax_store(name):
    """On the same id sequences (writing the same rows), the port's
    slot_of, owner, stamp and to_dense equal the JAX store's after every
    dispatch."""
    n, cap = 12, 4
    tstore, jstore = SparseClientStateStore(capacity=cap), JSparseStore(cap)
    tstate = tstore.init(_template(), n)
    jstate = jstore.init(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), _template()), n)
    for t, ids in enumerate(PLAN_SEQUENCES[name]):
        ids = np.asarray(sorted(ids), np.int64)
        tstate = tstore.prepare_chunk(tstate, ids)
        jstate = jstore.prepare_chunk(jstate, ids.astype(np.int32))
        rows = _rows_for(ids, float(t + 1))
        tstate = tstore.scatter(tstate, torch.as_tensor(ids), rows)
        jstate = jstore.scatter(jstate, jnp.asarray(ids), jax.tree_util.
                                tree_map(lambda r: jnp.asarray(r.numpy()),
                                         rows))
        for key in ("slot_of", "owner", "stamp"):
            np.testing.assert_array_equal(tstate[key].numpy(),
                                          np.asarray(jstate[key]), key)
        tdense, jdense = tstore.to_dense(tstate), jstore.to_dense(jstate)
        for k in ("a", "b"):
            np.testing.assert_array_equal(tdense[k].numpy(),
                                          np.asarray(jdense[k]))


# ---------------------------------------------------------------------------
# engine parity: sparse == dense, bitwise
# ---------------------------------------------------------------------------

def _sched(sampling, rounds=6, chunk=2, overlap=False):
    return RoundSchedule(rounds=rounds, lr_decay=1.0, eval_every=0,
                         seed=SEED, chunk_size=chunk, sampling=sampling,
                         host_rng_offset=17, overlap=overlap)


def _run(setup, algo, impl, store, sampling="host", compression=None,
         rounds=6):
    task, data = setup
    spec = LocalSpec(n_steps=2, batch_size=4, lr=0.05,
                     variant="plain" if algo == "fedavg" else algo,
                     update_impl=impl, compression=compression)
    strat = AggregateStrategy(spec=spec, algorithm=algo, participation=0.25,
                              state_store=store)
    return run_rounds(task, data, strat, _sched(sampling, rounds),
                      device="cpu"), strat


def _dense_rows(strat, res, key):
    store = dict(strat._residency_entries())[key]
    state = res.algo_state[key]
    return (store.to_dense(state)
            if isinstance(store, SparseClientStateStore) else state)


def _assert_same(dense, sparse, keys):
    (rd, sd), (rs, ss) = dense, sparse
    assert [h["local_loss"] for h in rd.history] == \
        [h["local_loss"] for h in rs.history]
    for a, b in zip(tm.tree_leaves(rd.params), tm.tree_leaves(rs.params)):
        assert torch.equal(a, b)
    for key in keys:
        a, b = _dense_rows(sd, rd, key), _dense_rows(ss, rs, key)
        for x, y in zip(tm.tree_leaves(a), tm.tree_leaves(b)):
            assert torch.equal(x, y), key
        assert any(bool(x.abs().sum() > 0) for x in tm.tree_leaves(b))
    if "c_global" in rd.algo_state:
        for x, y in zip(tm.tree_leaves(rd.algo_state["c_global"]),
                        tm.tree_leaves(rs.algo_state["c_global"])):
            assert torch.equal(x, y)


def _spilled_and_refaulted(store) -> bool:
    """Some row went to host memory and some came back from there."""
    return store.spilled_rows > 0 and store.refaulted_rows > 0


@pytest.mark.parametrize("algo", ["scaffold", "moon"])
@pytest.mark.parametrize("impl", ["tree", "fused_interpret"])
def test_host_sparse_matches_dense(setup, algo, impl):
    """capacity 4 with chunk 2 × K 2 evicts and refaults revisited
    clients across the 3 dispatches."""
    key = {"scaffold": "c_clients", "moon": "w_prev"}[algo]
    dense = _run(setup, algo, impl, DenseClientStateStore())
    sparse = _run(setup, algo, impl, SparseClientStateStore(capacity=CAPACITY))
    _assert_same(dense, sparse, [key])
    assert _spilled_and_refaulted(sparse[1].state_store)
    assert sparse[0].timing["spill_materialize_ms"] > 0.0


@pytest.mark.parametrize("impl", ["tree", "fused_interpret"])
def test_device_sampling_sparse_matches_dense(setup, impl):
    """sampling="device": the ids drawn at planning time fault the
    right rows in — still bitwise (10 rounds: this seed's draws revisit
    a spilled client from round 8 on)."""
    dense = _run(setup, "scaffold", impl, DenseClientStateStore(), "device",
                 rounds=10)
    sparse = _run(setup, "scaffold", impl,
                  SparseClientStateStore(capacity=CAPACITY), "device",
                  rounds=10)
    _assert_same(dense, sparse, ["c_clients"])
    assert _spilled_and_refaulted(sparse[1].state_store)


@pytest.mark.parametrize("impl", ["tree", "fused_interpret"])
def test_compressed_error_feedback_rows_sparse_matches_dense(setup, impl):
    """scaffold with int8 + top-k 25% + error feedback: the control
    variates AND the residual rows in sparse stores (two instances)."""
    comp = CompressionSpec(8, 0.25, True)
    dense = _run(setup, "scaffold", impl, DenseClientStateStore(),
                 compression=comp)
    sparse = _run(setup, "scaffold", impl,
                  SparseClientStateStore(capacity=CAPACITY), compression=comp)
    _assert_same(dense, sparse, ["c_clients", "ef_residuals"])
    strat = sparse[1]
    assert strat._ef_store is not strat.state_store
    assert len(strat.residency_stores) == 2
    assert all(_spilled_and_refaulted(s) for s in strat.residency_stores)


def test_prepare_chunk_state_is_stage_then_commit(setup):
    """The strategy's one-call residency hook equals its two halves."""
    task, data = setup
    spec = LocalSpec(n_steps=2, batch_size=4, lr=0.05, variant="scaffold",
                     compression=CompressionSpec(8, 0.25, True))
    states = []
    for split in (False, True):
        strat = AggregateStrategy(spec=spec, algorithm="scaffold",
                                  state_store=SparseClientStateStore(2))
        state = strat.init_state(task, task.init(
            torch.Generator().manual_seed(0)), N_CLIENTS)
        for ids in ([0, 1], [2, 3], [0, 2]):
            state = (strat.commit_chunk_state(
                state, strat.stage_chunk_state(np.array(ids))) if split
                else strat.prepare_chunk_state(state, np.array(ids)))
        states.append((strat, state))
    (sa, a), (sb, b) = states
    for key in ("c_clients", "ef_residuals"):
        for k in ("slot_of", "owner", "stamp"):
            assert torch.equal(a[key][k], b[key][k])
    assert [s.refaulted_rows for s in sa.residency_stores] == \
        [s.refaulted_rows for s in sb.residency_stores] == [1, 1]


def test_fedavg_with_a_sparse_store_has_no_residency(setup):
    """fedavg keeps no client rows: the sparse store is never used and
    the run equals the dense one."""
    dense = _run(setup, "fedavg", "tree", DenseClientStateStore())
    sparse = _run(setup, "fedavg", "tree",
                  SparseClientStateStore(capacity=CAPACITY))
    _assert_same(dense, sparse, [])
    assert sparse[0].timing["host_residency_ms"] == 0.0
