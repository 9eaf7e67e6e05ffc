"""The whole slice: ``repro_torch``'s P1 cyclic relay → P2 FedAvg(M/Adam)
pipeline against the JAX package's, on the CPU.

Both packages start from the same JAX-initialized params (carried with
``repro_torch.bridge``) and train on the same client batches: the port
gets the JAX engine's threefry batch indices injected, and
``sampling="host"`` makes both draw the same client ids from numpy.  The
JAX side runs its Pallas kernels in interpret mode
(``update_impl="fused_interpret"``); the port runs ``"fused"``, which on
CPU tensors is each kernel's plain version.

Tolerances: per-round losses rtol 1e-4 and final params atol 1e-4 (conv
and matmul reductions sum in another order, and the differences
compound over 4 rounds of SGD); accuracies equal up to 2 test samples
(an argmax tie may flip); ledger bytes and dispatch counts exactly.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_numpy_params, torch_leaves)

import jax
from repro.core.cyclic import CyclicConfig as JCyclicConfig
from repro.core.pipeline import run_cyclic_then_federated as j_run
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.fl.simulation import FLConfig as JFLConfig
from repro.fl.task import vision_task as j_vision_task
from repro_torch import bridge
from repro_torch.core import comm_accounting
from repro_torch.core.cyclic import (CyclicConfig, cyclic_pretrain,
                                     make_cyclic_round_fn)
from repro_torch.core.pipeline import (Phase, run_cyclic_then_federated,
                                       run_phase_schedule)
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.engine import (AggregateStrategy, RoundSchedule,
                                   SparseClientStateStore, make_eval_fn,
                                   run_rounds)
from repro_torch.fl.simulation import (FLConfig, init_server_state,
                                       make_round_fn, run_federated)
from repro_torch.fl.task import vision_task
from repro_torch.utils.tree_math import tree_leaves

SEED = 0
N_CLIENTS, N_TRAIN, N_TEST = 8, 256, 64
STEPS, BATCH = 3, 8
# mlp over 32×32×3 inputs: cheap to compile on the JAX side
MODEL_KW = {"img": 32}


def _configs(server_opt: str, impl: str):
    common = dict(local_steps=STEPS, batch_size=BATCH, eval_every=1,
                  seed=SEED, sampling="host", update_impl=impl)
    cyc = dict(rounds=2, participation=0.25, **common)
    # Adam's normalization turns a reduction-order difference in a
    # near-zero pseudo-gradient element into a step of up to lr, so the
    # adam case steps at a small server lr
    server_lr = 1e-3 if server_opt == "adam" else 1.0
    fed = dict(rounds=2, participation=0.25, server_opt=server_opt,
               server_lr=server_lr, chunk_size=1, **common)
    return cyc, fed


@pytest.fixture(scope="module")
def jax_side():
    task = j_vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs=MODEL_KW)
    data = J_DATASETS.get("cifar10-like")(n_clients=N_CLIENTS, beta=0.5,
                                          seed=SEED, n_train=N_TRAIN,
                                          n_test=N_TEST)
    return task, data


@pytest.fixture(scope="module")
def torch_side():
    task = vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs=MODEL_KW)
    data = DATASETS.get("cifar10-like")(n_clients=N_CLIENTS, beta=0.5,
                                        seed=SEED, n_train=N_TRAIN,
                                        n_test=N_TEST)
    return task, data


def _run_both(jax_side, torch_side, server_opt):
    jtask, jdata = jax_side
    ttask, tdata = torch_side
    cyc, fed = _configs(server_opt, "fused_interpret")
    jcyc, jfed = JCyclicConfig(**cyc), JFLConfig(**fed)
    # the JAX pipeline inits P1 from PRNGKey(seed): carry the same init
    init = bridge.params_from_numpy(jax_numpy_params(
        jtask.init(jax.random.PRNGKey(SEED))))
    jres = j_run(jtask, jdata, jcyc, jfed)

    n_data = jdata.n_per_client
    k1, k2 = jcyc.n_selected(N_CLIENTS), jfed.n_selected(N_CLIENTS)
    idx1 = jax_engine_indices(SEED, jcyc.rounds, k1, STEPS, BATCH, n_data)
    idx2 = jax_engine_indices(SEED, jfed.rounds, k2, STEPS, BATCH, n_data)
    tcyc = CyclicConfig(**dict(cyc, update_impl="fused"),
                        batch_indices=index_source(idx1))
    tfed = FLConfig(**dict(fed, update_impl="fused"),
                    batch_indices=index_source(idx2))
    # run_cyclic_then_federated's two phases, from the carried JAX init
    ledger = comm_accounting.CommLedger()
    p1 = cyclic_pretrain(ttask, tdata, tcyc, init_params=init, ledger=ledger,
                         device="cpu")
    p2 = run_federated(ttask, tdata, tfed, init_params=p1.params,
                       ledger=ledger, device="cpu")
    return jres, (p1, p2, ledger)


@pytest.mark.parametrize("server_opt", ["none", "momentum", "adam"])
def test_pipeline_matches_jax(jax_side, torch_side, server_opt):
    jres, (p1, p2, ledger) = _run_both(jax_side, torch_side, server_opt)
    j_hist = jres.history
    t_hist = p1.history + [dict(h, round=h["round"] + len(p1.history))
                           for h in p2.history]
    assert [h["round"] for h in j_hist] == [h["round"] for h in t_hist]
    assert [h["phase"] for h in j_hist] == [h["phase"] for h in t_hist]
    np.testing.assert_allclose([h["local_loss"] for h in t_hist],
                               [h["local_loss"] for h in j_hist], rtol=1e-4)
    for jh, th in zip(j_hist, t_hist):
        assert ("acc" in jh) == ("acc" in th)
        if "acc" in jh:
            assert abs(jh["acc"] - th["acc"]) * N_TEST <= 2 + 1e-6
    for a, b in zip(torch_leaves(p2.params),
                    jax_leaves(jres.federated.params)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert ledger.total_bytes == jres.ledger.total_bytes
    assert p1.dispatches == jres.cyclic.dispatches
    assert p2.dispatches == jres.federated.dispatches


def test_port_pipeline_history_and_ledger(jax_side, torch_side):
    """The port's own run_cyclic_then_federated: the JAX result's history
    shape, the Table-IV closed form, and the caller's init untouched."""
    jtask, jdata = jax_side
    ttask, tdata = torch_side
    cyc, fed = _configs("momentum", "fused")
    jres = j_run(jtask, jdata, JCyclicConfig(**dict(cyc, update_impl="tree")),
                 JFLConfig(**dict(fed, update_impl="tree")))
    res = run_cyclic_then_federated(ttask, tdata, CyclicConfig(**cyc),
                                    FLConfig(**fed), device="cpu")
    assert [(h["round"], h["phase"], "acc" in h) for h in res.history] == \
        [(h["round"], h["phase"], "acc" in h) for h in jres.history]
    assert all(np.isfinite(h["local_loss"]) for h in res.history)
    x = sum(t.numel() * t.element_size()
            for t in tree_leaves(res.federated.params))
    k1 = CyclicConfig(**cyc).n_selected(N_CLIENTS)
    k2 = FLConfig(**fed).n_selected(N_CLIENTS)
    assert res.ledger.total_bytes == comm_accounting.overhead_with_cyclic(
        "fedavg", k1, cyc["rounds"], k2, fed["rounds"], x)
    assert res.ledger.total_bytes == jres.ledger.total_bytes


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_init_params_unchanged(torch_side, impl):
    task, data = torch_side
    init = task.init(torch.Generator().manual_seed(3))
    before = [t.clone() for t in tree_leaves(init)]
    cyc, fed = _configs("momentum", impl)
    res = cyclic_pretrain(task, data, CyclicConfig(**cyc), init_params=init,
                          device="cpu")
    run_federated(task, data, FLConfig(**fed), init_params=res.params,
                  device="cpu")
    for a, b in zip(before, tree_leaves(init)):
        assert torch.equal(a, b)
    assert not torch.equal(tree_leaves(res.params)[0], before[0])


def test_tree_and_fused_agree(torch_side):
    """The port's tree path and fused path run the same math."""
    task, data = torch_side
    out = []
    for impl in ("tree", "fused"):
        cyc, fed = _configs("momentum", impl)
        out.append(run_cyclic_then_federated(
            task, data, CyclicConfig(**dict(cyc, grad_clip=1.0, momentum=0.9,
                                            weight_decay=1e-3)),
            FLConfig(**fed), device="cpu"))
    np.testing.assert_allclose([h["local_loss"] for h in out[0].history],
                               [h["local_loss"] for h in out[1].history],
                               rtol=1e-5)
    for a, b in zip(torch_leaves(out[0].federated.params),
                    torch_leaves(out[1].federated.params)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_device_sampling_is_seeded(torch_side):
    """sampling="device" draws ids with torch.randperm on the engine's
    generator: the same seed repeats a run, another seed changes it."""
    task, data = torch_side
    init = task.init(torch.Generator().manual_seed(0))
    cfg = FLConfig(rounds=2, participation=0.25, local_steps=2, batch_size=4,
                   eval_every=0, update_impl="fused", sampling="device")
    runs = [run_federated(task, data, dc.replace(cfg, seed=s),
                          init_params=init, device="cpu").history
            for s in (0, 0, 1)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


class _RecordIds:
    """Wraps a strategy: its round body records the client ids the
    engine drew and leaves the params as they are."""

    def __init__(self, inner):
        self.inner, self.ids = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def build_round(self, task, dev):
        def body(params, inputs, lr_scale, algo_state):
            self.ids.append(inputs.ids.clone())
            return params, algo_state, torch.zeros(())
        return body


def test_device_sampling_statistics(torch_side):
    """sampling="device" draws K distinct in-range ids per round, and
    over many rounds each client is chosen about rounds·K/n times, as
    the JAX engine's permutation draw chooses them."""
    task, data = torch_side
    rounds = 400
    rec = _RecordIds(AggregateStrategy(spec=FLConfig(
        participation=0.25, local_steps=1, batch_size=4).local_spec(),
        participation=0.25))
    run_rounds(task, data, rec, RoundSchedule(rounds=rounds, eval_every=0,
                                              sampling="device"),
               device="cpu")
    ids = torch.stack(rec.ids).numpy()
    n, K = data.n_clients, rec.n_selected(data.n_clients)
    assert ids.shape == (rounds, K) and K > 1
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(set(row)) == K for row in ids.tolist())
    counts = np.bincount(ids.ravel(), minlength=n)
    p = K / n
    sd = np.sqrt(rounds * p * (1 - p))
    assert np.all(np.abs(counts - rounds * p) < 4 * sd), counts


def _entry_points(task, data):
    cyc = CyclicConfig(rounds=1, local_steps=1, batch_size=4, eval_every=0)
    fed = FLConfig(rounds=1, local_steps=1, batch_size=4, eval_every=0)
    return {
        "run_rounds": lambda **kw: run_rounds(
            task, data, cyc.strategy(), RoundSchedule(rounds=1, eval_every=0),
            **kw),
        "cyclic_pretrain": lambda **kw: cyclic_pretrain(task, data, cyc, **kw),
        "run_federated": lambda **kw: run_federated(task, data, fed, **kw),
        "run_phase_schedule": lambda **kw: run_phase_schedule(
            task, data, [Phase("P1", cyc), Phase("P2", fed)], **kw),
        "run_cyclic_then_federated": lambda **kw: run_cyclic_then_federated(
            task, data, cyc, fed, **kw),
        "make_round_fn": lambda **kw: make_round_fn(task, fed, **kw),
        "init_server_state": lambda **kw: init_server_state(
            task, fed, data.n_clients, **kw),
        "make_cyclic_round_fn": lambda **kw: make_cyclic_round_fn(
            task, cyc, **kw),
        "make_eval_fn": lambda **kw: make_eval_fn(task, 16, **kw),
        "run_pod_training": _pod_training,
    }


def _pod_training(**kw):
    """``launch.train.run_pod_training`` at a tiny size (the one-rank
    mesh it makes is destroyed after)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    from repro_torch.fl.pod import PodFLSpec
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import run_pod_training
    cfg = get_reduced("tinyllama-1.1b")
    data = make_synthetic_tokenlm(n_clients=4, seq_len=8,
                                  n_seq_per_client=4, vocab=cfg.vocab_size)
    try:
        return run_pod_training(cfg, data, cyclic_rounds=1, fl_rounds=1,
                                clients_per_round=2,
                                spec=PodFLSpec(local_steps=1, batch_size=2),
                                **kw)
    finally:
        tmesh.destroy()


@pytest.mark.parametrize("entry", ["run_rounds", "cyclic_pretrain",
                                   "run_federated", "run_phase_schedule",
                                   "run_cyclic_then_federated",
                                   "make_round_fn", "init_server_state",
                                   "make_cyclic_round_fn", "make_eval_fn",
                                   "run_pod_training"])
def test_entry_points_need_cuda_unless_cpu(torch_side, monkeypatch, entry):
    task, data = torch_side
    fn = _entry_points(task, data)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(device="cuda")
    fn(device="cpu")


@pytest.mark.parametrize("kwargs,item", [
    ({"peft": "lora:8"}, "M11"),
    ({"trainable_filter": "head"}, "M11"),
])
def test_unported_options_raise(kwargs, item):
    """The PEFT knobs (ROADMAP ``item``, ported): the tree path has no
    trainable slice and raises; a fused config carries them to its
    local spec."""
    with pytest.raises(ValueError, match="fused flat path"):
        FLConfig(**kwargs)
    spec = FLConfig(update_impl="fused", **kwargs).local_spec()
    assert (spec.peft, spec.trainable_filter) == (
        kwargs.get("peft"), kwargs.get("trainable_filter"))


def test_unported_engine_options_raise():
    """M10 is ported: the overlapped loop and the sparse store build, and
    a state_store without the store contract still raises."""
    assert RoundSchedule(rounds=1, overlap=True).overlap
    AggregateStrategy(spec=FLConfig().local_spec(),
                      state_store=SparseClientStateStore(capacity=4))
    with pytest.raises(ValueError, match="state_store"):
        AggregateStrategy(spec=FLConfig().local_spec(), state_store=object())
