"""The trainable slice (federated PEFT) in the port against the JAX
package: the filters (``sharding.rules.trainable_mask``), the filtered
flat buffers (``FlatView`` / ``ShardedFlatView`` with ``filter=``), the
knobs of ``fl.local`` and the engine runs of ``tests/test_peft.py``.

Model: the reduced qwen1.5-0.5b with ``lora:4`` adapters (f32), on
``make_synthetic_tokenlm`` (8 clients × 8 sequences of 16 tokens,
vocab 512).  Engine runs: 2 clients a round, 2 SGD steps of batch 4,
lr 0.05, ``sampling="host"``; the port's runs take the JAX package's
threefry batch indices and its init params (carried by the bridge), and
run the kernels' plain versions (``fused_interpret``, as the JAX side
runs its Pallas kernels in interpret mode).  Tolerances: losses rtol
1e-5, params atol 2e-5 (the matmuls of the 2-layer model sum in another
order); the host engine against the pod atol 1e-5 (one K2 pass against
K's sequential K6 accumulation); compressed uploads as in
``tests/test_torch_compression.py`` (within 1e-4 but for at most 0.1% of
the elements, each within twice the largest residual, where a delta sat
on a rounding edge).  Frozen leaves, the all-matching filter and the
byte counts: exact.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_numpy_params, torch_config, torch_leaves)

import jax
import jax.numpy as jnp
from repro.configs import get_reduced as jget_reduced
from repro.configs import with_peft as jwith_peft
from repro.core.comm_accounting import CommLedger as JCommLedger
from repro.data.synthetic import make_synthetic_tokenlm as j_tokenlm
from repro.fl import compression as jcomp
from repro.fl import engine as jengine
from repro.fl import local as jlocal
from repro.fl import pod as jpod
from repro.fl.task import lm_task as j_lm_task
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import transformer as JT
from repro.sharding import rules as jrules
from repro.utils.flatten import FlatView as JFlatView
from repro_torch import bridge
from repro_torch.core import comm_accounting as acc
from repro_torch.core.comm_accounting import CommLedger
from repro_torch.data.synthetic import make_synthetic_tokenlm
from repro_torch.fl import compression as comp
from repro_torch.fl import engine, pod
from repro_torch.fl.local import (LocalSpec, effective_trainable_filter,
                                  host_flat_ops, parse_peft, validate_peft)
from repro_torch.fl.simulation import FLConfig
from repro_torch.fl.task import lm_task
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm
from repro_torch.utils.flatten import FlatView, is_frozen_bucket

SEED = 0
ARCH = "qwen1.5-0.5b"
N_CLIENTS, N_SEQ, SEQ = 8, 8, 16
STEPS, BATCH, K, ROUNDS = 2, 4, 2, 2
ATOL = 2e-5


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_host_mesh("cpu")
    yield m
    tmesh.destroy()


@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX config/task/data/init and the port's config/task/data."""
    jcfg = jwith_peft(jget_reduced(ARCH), "lora:4")
    kw = dict(n_clients=N_CLIENTS, seq_len=SEQ, n_seq_per_client=N_SEQ,
              vocab=jcfg.vocab_size, beta=0.5, seed=SEED)
    jtask = j_lm_task(jcfg)
    jinit = jax_numpy_params(jtask.init(jax.random.PRNGKey(SEED)))
    cfg = torch_config(jcfg)
    return (jcfg, jtask, j_tokenlm(**kw), jinit, cfg, lm_task(cfg),
            make_synthetic_tokenlm(**kw))


def _init():
    return bridge.params_from_numpy(_setup()[3])


def _indices(rounds=ROUNDS):
    return jax_engine_indices(SEED, rounds, K, STEPS, BATCH, N_SEQ)


def _sched(rounds=ROUNDS, **kw):
    return engine.RoundSchedule(
        rounds=rounds, lr_decay=1.0, eval_every=0, seed=SEED, chunk_size=2,
        sampling="host", host_rng_offset=17,
        batch_indices=index_source(_indices(rounds)), **kw)


def _spec(**kw):
    return LocalSpec(n_steps=STEPS, batch_size=BATCH, lr=0.05,
                     update_impl="fused_interpret", **kw)


def _run(*, backend="host", mesh=None, rounds=ROUNDS, ledger=None, **kw):
    _, _, _, _, _, task, data = _setup()
    if backend == "host":
        strat = engine.AggregateStrategy(spec=_spec(**kw),
                                         participation=K / N_CLIENTS)
    else:
        strat = pod.PodAggregateStrategy(spec=_spec(**kw), mesh=mesh,
                                         clients_per_round=K)
    return engine.run_rounds(task, data, strat, _sched(rounds),
                             init_params=_init(), ledger=ledger,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(backend="host", compression=None, rounds=ROUNDS):
    """The JAX package's run of the same case (``fused_interpret``), with
    its ledger."""
    jcfg, jtask, jdata, jinit, _, _, _ = _setup()
    spec = jlocal.LocalSpec(n_steps=STEPS, batch_size=BATCH, lr=0.05,
                            update_impl="fused_interpret", peft="lora:4",
                            compression=compression)
    if backend == "host":
        strat = jengine.AggregateStrategy(spec=spec,
                                          participation=K / N_CLIENTS)
    else:
        strat = jpod.PodAggregateStrategy(spec=spec, mesh=j_make_host_mesh(),
                                          clients_per_round=K)
    led = JCommLedger()
    sched = jengine.RoundSchedule(rounds=rounds, lr_decay=1.0, eval_every=0,
                                  seed=SEED, chunk_size=2, sampling="host",
                                  host_rng_offset=17)
    res = jengine.run_rounds(jtask, jdata, strat, sched,
                             init_params=jax.tree_util.tree_map(
                                 jnp.asarray, jinit), ledger=led)
    return res, led


def _losses(res):
    return np.array([h["local_loss"] for h in res.history])


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_spec", ["lora", "head", r"attn/w[qk]/",
                                         r"(^|/)final_norm/scale$"])
def test_trainable_mask_matches_jax(filter_spec):
    jcfg, _, _, jinit, _, _, _ = _setup()
    assert rules.trainable_mask(_init(), filter_spec) == \
        jrules.trainable_mask(jinit, filter_spec)
    assert rules.resolve_trainable_filter(filter_spec) == \
        jrules.resolve_trainable_filter(filter_spec)
    assert rules.trainable_mask(_init(), None) is None
    assert rules.TRAINABLE_FILTERS == jrules.TRAINABLE_FILTERS


def test_zero_leaf_filter_raises_at_construction():
    plain = TT.init_lm(get_plain_cfg(), device="meta")
    with pytest.raises(ValueError, match="matches zero leaves"):
        rules.trainable_mask(plain, "lora")
    task = lm_task(get_plain_cfg())
    with pytest.raises(ValueError, match="matches zero leaves"):
        host_flat_ops(task, True, torch.device("cpu"), "lora")
    strat = engine.AggregateStrategy(spec=_spec(peft="lora:4"))
    with pytest.raises(ValueError, match="matches zero leaves"):
        strat.flat_ops(task, torch.device("cpu"))


def get_plain_cfg():
    return dataclasses.replace(_setup()[4], lora_rank=0)


# ---------------------------------------------------------------------------
# the filtered flat buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filter_spec", ["lora", "head", "."])
def test_filtered_buffers_match_jax_element_for_element(filter_spec):
    _, _, _, jinit, _, _, _ = _setup()
    tp = _init()
    mask = rules.trainable_mask(tp, filter_spec)
    view, jview = FlatView.of(tp, filter=mask), JFlatView.of(jinit,
                                                              filter=mask)
    assert view.buffer_sizes == jview.buffer_sizes
    assert view.frozen_sizes == jview.frozen_sizes
    for got, want in ((view.flatten(tp), jview.flatten(jinit)),
                      (view.flatten_frozen(tp), jview.flatten_frozen(jinit))):
        assert list(got) == list(want)
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    # the round trip, and the zero fill of an absent frozen bucket
    back = view.unflatten(view.flatten(tp), view.flatten_frozen(tp))
    assert all(torch.equal(a, b) for a, b in zip(tm.tree_leaves(back),
                                                 tm.tree_leaves(tp)))
    zf = view.unflatten(view.flatten(tp))
    for a, m in zip(tm.tree_leaves(zf), mask):
        assert m or not a.any()
    # stacked: frozen rows broadcast the shared bucket
    st = tm.tree_map(lambda t: torch.stack([t, 2 * t]), tp)
    sb = view.flatten_stacked(st)
    jsb = jview.flatten_stacked(jax.tree_util.tree_map(
        lambda a: np.stack([a, 2 * a]), jinit))
    for name in sb:
        np.testing.assert_array_equal(sb[name].numpy(), np.asarray(jsb[name]))
    un = view.unflatten_stacked(sb, view.flatten_frozen(tp))
    for a, b, m in zip(tm.tree_leaves(un), tm.tree_leaves(st), mask):
        assert torch.equal(a, b if m else torch.stack([b[0], b[0]]))
    # the per-leaf normal draws skip the frozen leaves, keyed by the
    # global slot index
    full = FlatView.of(tp)
    z, zfull = view.normal(3), full.unflatten(full.normal(3))
    zt = view.unflatten(z)
    for a, b, m in zip(tm.tree_leaves(zt), tm.tree_leaves(zfull), mask):
        assert torch.equal(a, b) if m else not a.any()


@pytest.mark.parametrize("mesh_name,shape", [("1x1", (1, 1)),
                                             ("2x2", (2, 2))])
def test_sharded_filtered_buffers_match_jax(mesh_name, shape):
    """Trainable and frozen groups, each with its (dtype × axes)
    decomposition, and their buffers bitwise the JAX package's; a
    sharded group (trainable or frozen) still raises M13b on the rank."""
    _, _, _, jinit, _, _, _ = _setup()
    tp = _init()
    m = types.SimpleNamespace(axis_names=("data", "model"),
                              devices=np.empty(shape),
                              shape=dict(zip(("data", "model"), shape)))
    view = rules.sharded_flat_view(tp, m, "fsdp_tp", "lora")
    jview = jrules.sharded_flat_view(jinit, m, "fsdp_tp", "lora")
    assert [(g.name, g.axes, g.n_shards, g.size) for g in view.groups] == \
        [(g.name, g.axes, g.n_shards, g.size) for g in jview.groups]
    assert view.frozen_groups and view.trainable_groups
    assert all(is_frozen_bucket(g.name) for g in view.frozen_groups)
    assert rules.frozen_flat_shardings(view) == {
        g.name: tuple(jrules.flat_buffer_pspec(g))
        for g in jview.frozen_groups}
    for got, want in ((view.flatten(tp), jview.flatten(jinit)),
                      (view.flatten_frozen(tp), jview.flatten_frozen(jinit))):
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    back = view.unflatten(view.flatten(tp), view.flatten_frozen(tp))
    assert all(torch.equal(a, b) for a, b in zip(tm.tree_leaves(back),
                                                 tm.tree_leaves(tp)))
    if shape == (1, 1):
        local = view.local_view()
        assert local.frozen_sizes and local.buffer_sizes == {"float32": sum(
            g.size for g in view.trainable_groups)}
    else:
        # a rank holds its row of every group: per-shard sizes
        assert any(g.n_shards > 1 for g in view.frozen_groups)
        local = view.local_view()
        assert local.frozen_sizes == {g.name: g.size
                                      for g in view.frozen_groups}
        assert local.buffer_sizes == {g.name: g.size
                                      for g in view.trainable_groups}


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm,
                                   torch.ops.aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_frozen_leaves_never_require_grad():
    """Under the "lora" filter the gradient is taken with respect to the
    trainable bucket only: the frozen bucket never requires grad, the
    backward packs one adapter-sized gradient, and it runs no matmul for
    a frozen weight's gradient (fewer than the full model's backward)."""
    tp, cfg = _init(), _setup()[4]
    fops = host_flat_ops(lm_task(cfg), True, torch.device("cpu"), "lora")
    full = host_flat_ops(lm_task(cfg), True, torch.device("cpu"))
    toks = torch.from_numpy(_setup()[6].x[0][:BATCH])
    labs = torch.from_numpy(_setup()[6].y[0][:BATCH])
    counts = {}
    for name, ops_ in (("lora", fops), ("full", full)):
        p = {k: b.requires_grad_(True) for k, b in
             ops_.place(ops_.flatten(tp)).items()}
        frozen = ops_.place_frozen(ops_.flatten_frozen(tp))
        assert not any(b.requires_grad for b in frozen.values())
        loss, _ = TT.lm_loss(ops_.unflatten(p, frozen), cfg,
                             {"tokens": toks, "labels": labs})
        with _CountMatmuls() as cm:
            grads = torch.autograd.grad(loss, list(p.values()))
        counts[name] = cm.n
        assert [g.shape for g in grads] == [b.shape for b in p.values()]
    assert fops.view.total_size < full.view.total_size / 10
    assert counts["lora"] < counts["full"]


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------

def test_peft_knobs_match_jax():
    for peft in ("lora:8", "lora:1"):
        assert parse_peft(peft) == jlocal.parse_peft(peft)
    for bad in ("adapters:8", "lora", "lora:0", "lora:-3"):
        with pytest.raises(ValueError):
            parse_peft(bad)
    for kw in (dict(peft="lora:4"), dict(trainable_filter="head"),
               dict(peft="lora:4", trainable_filter="head"), {}):
        assert effective_trainable_filter(_spec(**kw)) == \
            jlocal.effective_trainable_filter(jlocal.LocalSpec(
                2, 4, 0.05, update_impl="fused_interpret", **kw))
    assert validate_peft("lora:8", update_impl="fused") == "lora:8"


def test_tree_impl_and_relay_reject_peft(mesh):
    with pytest.raises(ValueError, match="fused flat path"):
        LocalSpec(2, 4, 0.05, peft="lora:8")
    with pytest.raises(ValueError, match="fused flat path"):
        LocalSpec(2, 4, 0.05, trainable_filter="head")
    with pytest.raises(ValueError, match="fused flat path"):
        pod.PodFLSpec(peft="lora:8")
    with pytest.raises(ValueError, match="fused flat path"):
        FLConfig(peft="lora:8")
    with pytest.raises(ValueError, match="P2 rounds only"):
        engine.RelayStrategy(spec=_spec(peft="lora:4"))
    with pytest.raises(ValueError, match="P2 rounds only"):
        pod.PodRelayStrategy(spec=_spec(peft="lora:4"), mesh=mesh)


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def test_all_matching_filter_equals_unfiltered_bitwise():
    base, allf = _run(), _run(trainable_filter=r".")
    np.testing.assert_array_equal(_losses(base), _losses(allf))
    for a, b in zip(tm.tree_leaves(base.params), tm.tree_leaves(allf.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["host", "pod"])
def test_frozen_leaves_bitwise_invariant_and_jax_parity(mesh, backend):
    """Every frozen leaf comes back bitwise; every adapter leaf moves; the
    run matches the JAX package's (its host engine, or its pod on one
    device)."""
    res = _run(backend=backend, mesh=mesh, peft="lora:4")
    p0 = _init()
    mask = rules.trainable_mask(p0, "lora")
    moved = 0
    for a, b, m in zip(tm.tree_leaves(p0), tm.tree_leaves(res.params), mask):
        if m:
            moved += int(not torch.equal(a, b))
        else:
            assert torch.equal(a, b)
    assert moved == sum(mask) == 14
    jres, _ = _jax_run(backend)
    np.testing.assert_allclose(_losses(res), _losses(jres), rtol=1e-5)
    for a, b in zip(torch_leaves(res.params), jax_leaves(jres.params)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_host_engine_equals_pod(mesh):
    host = _run(peft="lora:4")
    pd = _run(backend="pod", mesh=mesh, peft="lora:4")
    np.testing.assert_allclose(_losses(host), _losses(pd), rtol=1e-5)
    for a, b in zip(torch_leaves(host.params), torch_leaves(pd.params)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def _trainable_bytes(filter_spec):
    shapes = _setup()[5].shapes()
    mask = rules.trainable_mask(shapes, filter_spec)
    return sum(t.numel() * t.element_size()
               for t, m in zip(tm.tree_leaves(shapes), mask) if m)


def test_ledger_equals_closed_form_and_jax():
    led = CommLedger()
    _run(peft="lora:4", ledger=led)
    payload = _trainable_bytes("lora")
    x = led.summary()["model_bytes"]
    assert led.p2_upload_bytes == ROUNDS * K * payload
    assert led.p2_bytes == ROUNDS * acc.compressed_round_bytes(
        "fedavg", K, x, payload)
    assert led.summary()["payload_ratio"] == x / payload > 5
    _, jled = _jax_run("host")
    assert led.summary() == jled.summary()


def test_peft_composes_with_int8_topk_compression():
    """The lossy spec compresses the SLICE: the ledger's payload is
    ``payload_bytes`` over the trainable buckets (both ratios multiply),
    the JAX ledger's exactly, and the params and error-feedback rows
    match the JAX run at the compressed tolerance."""
    spec = comp.CompressionSpec(bits=8, density=0.25, error_feedback=True)
    led = CommLedger()
    res = _run(peft="lora:4", ledger=led, compression=spec)
    sizes = tuple(host_flat_ops(_setup()[5], True, torch.device("cpu"),
                                "lora").view.buffer_sizes.values())
    payload = comp.payload_bytes(spec, sizes)
    assert payload < _trainable_bytes("lora")
    assert led.p2_upload_bytes == ROUNDS * K * payload
    jres, jled = _jax_run("host", jcomp.CompressionSpec(8, 0.25, True))
    assert led.summary() == jled.summary()
    ef = res.algo_state["ef_residuals"]["float32"].numpy()
    jef = np.asarray(jres.algo_state["ef_residuals"]["float32"])
    n = sizes[0]
    ef, jef = ef[:, :n], jef[:, :n]
    assert np.any(jef != 0)
    bound = 2 * np.abs(jef).max()
    for a, b in list(zip(torch_leaves(res.params),
                         jax_leaves(jres.params))) + [(ef, jef)]:
        off = np.abs(a - b) > 1e-4
        assert off.sum() <= max(1, a.size // 1000), int(off.sum())
        assert np.all(np.abs(a - b)[off] <= bound)


def test_trained_adapters_merge_into_the_base():
    """Merging the trained adapters gives a plain model with the adapter
    model's forward (atol 2e-5), the deployment path."""
    res = _run(peft="lora:4")
    cfg, data = _setup()[4], _setup()[6]
    merged = TL.merge_lora(res.params)
    toks = {"tokens": torch.from_numpy(data.x[0][:2])}
    a, _, _ = TT.lm_forward(res.params, cfg, toks)
    b, _, _ = TT.lm_forward(merged, dataclasses.replace(cfg, lora_rank=0),
                            toks)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_federated_config_runs_the_slice():
    """``FLConfig`` takes the knobs (the JAX package's surface): a
    ``run_federated`` LoRA round leaves the frozen leaves bitwise."""
    from repro_torch.fl.simulation import run_federated
    _, _, _, _, _, task, data = _setup()
    cfg = FLConfig(rounds=1, participation=K / N_CLIENTS, local_steps=STEPS,
                   batch_size=BATCH, lr=0.05, eval_every=0, seed=SEED,
                   sampling="host", update_impl="fused_interpret",
                   peft="lora:4")
    res = run_federated(task, data, cfg, init_params=_init(), device="cpu")
    mask = rules.trainable_mask(res.params, "lora")
    for a, b, m in zip(tm.tree_leaves(_init()), tm.tree_leaves(res.params),
                       mask):
        assert m or torch.equal(a, b)
