"""CharLSTM-256 on ``shakespeare-like`` in the port against the JAX
package, on the CPU.

The model (embed + two LSTM layers + head, gates i, f, g, o, the forget
gate biased by +1) at d_hidden 16 and 8 tokens: logits within 1e-5, the
task's loss and gradient, its representation and prediction.  The
pipeline: P1 relay → P2 FedAvgM from the JAX package's init under
``sampling="host"`` with the JAX engine's threefry batch indices
injected, tree and fused, at ``test_torch_pipeline.py``'s tolerances
(losses rtol 1e-4, params atol 1e-4, ledger bytes exactly).  Then the
full-width CharLSTM's flat bucket (813,632 params padded to 814,080)
lies above ``topk_cut()``: its compressed upload takes the radix route
on the card, and on a CPU tensor the plain path, checked here bitwise
against the JAX package's numpy oracle.
"""
import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_numpy_params, torch_leaves)

import jax
import jax.numpy as jnp
from repro.core.cyclic import CyclicConfig as JCyclicConfig
from repro.core.pipeline import run_cyclic_then_federated as j_run
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.fl import compression as jcomp
from repro.fl.simulation import FLConfig as JFLConfig
from repro.fl.task import charlm_task as j_charlm_task
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import comm_accounting
from repro_torch.core.cyclic import CyclicConfig, cyclic_pretrain
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.compression import CompressionSpec, topk_k
from repro_torch.fl.local import host_flat_ops
from repro_torch.fl.simulation import FLConfig, run_federated
from repro_torch.fl.task import charlm_task
from repro_torch.kernels import fused_update as fu
from repro_torch.models import paper_models as pm
from repro_torch.utils.tree_math import tree_leaves

SEED = 0
VOCAB, D_EMBED, D_HIDDEN, SEQ = 64, 8, 16, 8
N_CLIENTS, N_SEQ, N_TEST = 6, 16, 32
STEPS, BATCH = 3, 4
DATA_KW = dict(n_clients=N_CLIENTS, seq_len=SEQ, n_seq_per_client=N_SEQ,
               n_test=N_TEST)


def _jparams(seed=SEED, d_hidden=D_HIDDEN):
    return jpm.charlstm_init(jax.random.PRNGKey(seed), vocab=VOCAB,
                             d_embed=D_EMBED, d_hidden=d_hidden)


def _tokens(seed, shape=(4, SEQ)):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_charlstm_forward_matches_jax(dtype):
    jp = _jparams()
    tok = _tokens(1)
    want = np.asarray(jpm.charlstm_apply(jp, jnp.asarray(tok)))
    got = pm.charlstm_apply(bridge.params_from_numpy(jax_numpy_params(jp)),
                            torch.from_numpy(tok).to(dtype))
    assert got.shape == (4, SEQ, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _shapes(tree):
    return {(a, b): tuple(t.shape) for a, sub in tree.items()
            for b, t in (sub.items() if isinstance(sub, dict)
                         else [("", sub)])}


def test_charlstm_layout_and_size():
    """The reference's keys and shapes; 813,632 params at full width."""
    p = pm.charlstm_init(torch.Generator().manual_seed(0))
    assert _shapes(p) == _shapes(_jparams(d_hidden=256))
    assert sum(t.numel() for t in tree_leaves(p)) == 813_632
    assert pm.PAPER_MODELS.get("charlstm")[2] == "charlm"


def test_charlm_task_loss_grad_repr_predict():
    jtask, task = j_charlm_task(VOCAB, D_EMBED, D_HIDDEN), \
        charlm_task(VOCAB, D_EMBED, D_HIDDEN)
    assert task.kind == jtask.kind == "charlm" and task.name == jtask.name
    jp = _jparams(3)
    bx, by = _tokens(4), _tokens(5)
    jloss, jgrad = jax.value_and_grad(jtask.loss_fn)(
        jp, jnp.asarray(bx), jnp.asarray(by))
    tp = bridge.params_from_numpy(jax_numpy_params(jp))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tx, ty = torch.from_numpy(bx), torch.from_numpy(by).long()
    loss = task.loss_fn(tp, tx, ty, None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jax_leaves(jgrad)):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        z = task.repr_fn(tp, tx)
        pred = task.predict_fn(tp, tx)
        acc = task.accuracy(tp, tx, ty)
    assert z.shape == (4, VOCAB)          # the last position's logits
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jtask.repr_fn(jp, jnp.asarray(bx))),
        rtol=1e-5, atol=1e-5)
    assert pred.shape == (4, SEQ)
    np.testing.assert_array_equal(
        pred.numpy(), np.asarray(jtask.predict_fn(jp, jnp.asarray(bx))))
    np.testing.assert_allclose(
        float(acc), float(jtask.accuracy(jp, jnp.asarray(bx),
                                         jnp.asarray(by))), atol=1e-7)


def _configs(impl):
    common = dict(local_steps=STEPS, batch_size=BATCH, eval_every=1,
                  eval_batch=16, seed=SEED, sampling="host",
                  update_impl=impl)
    cyc = dict(rounds=2, participation=0.5, **common)
    fed = dict(rounds=2, participation=0.5, server_opt="momentum",
               chunk_size=1, **common)
    return cyc, fed


@pytest.fixture(scope="module")
def sides():
    jtask = j_charlm_task(VOCAB, D_EMBED, D_HIDDEN)
    task = charlm_task(VOCAB, D_EMBED, D_HIDDEN)
    jdata = J_DATASETS.get("shakespeare-like")(seed=SEED, **DATA_KW)
    data = DATASETS.get("shakespeare-like")(seed=SEED, **DATA_KW)
    return (jtask, jdata), (task, data)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_charlm_pipeline_matches_jax(sides, impl):
    """P1 + P2 (FedAvgM) on token data, the port's tree or fused path
    against the JAX package's tree or interpret-mode Pallas path."""
    (jtask, jdata), (task, data) = sides
    cyc, fed = _configs("tree" if impl == "tree" else "fused_interpret")
    jcyc, jfed = JCyclicConfig(**cyc), JFLConfig(**fed)
    init = bridge.params_from_numpy(jax_numpy_params(
        jtask.init(jax.random.PRNGKey(SEED))))
    jres = j_run(jtask, jdata, jcyc, jfed)

    k1, k2 = jcyc.n_selected(N_CLIENTS), jfed.n_selected(N_CLIENTS)
    idx1 = jax_engine_indices(SEED, jcyc.rounds, k1, STEPS, BATCH, N_SEQ)
    idx2 = jax_engine_indices(SEED, jfed.rounds, k2, STEPS, BATCH, N_SEQ)
    tcyc = CyclicConfig(**dict(cyc, update_impl=impl),
                        batch_indices=index_source(idx1))
    tfed = FLConfig(**dict(fed, update_impl=impl),
                    batch_indices=index_source(idx2))
    ledger = comm_accounting.CommLedger()
    p1 = cyclic_pretrain(task, data, tcyc, init_params=init, ledger=ledger,
                         device="cpu")
    p2 = run_federated(task, data, tfed, init_params=p1.params,
                       ledger=ledger, device="cpu")

    t_hist = p1.history + [dict(h, round=h["round"] + len(p1.history))
                           for h in p2.history]
    j_hist = jres.history
    assert [(h["round"], h["phase"]) for h in t_hist] == \
        [(h["round"], h["phase"]) for h in j_hist]
    np.testing.assert_allclose([h["local_loss"] for h in t_hist],
                               [h["local_loss"] for h in j_hist], rtol=1e-4)
    for jh, th in zip(j_hist, t_hist):
        # accuracy over N_TEST × SEQ predicted characters: equal up to
        # two argmax ties
        assert abs(jh["acc"] - th["acc"]) * N_TEST * SEQ <= 2 + 1e-6
    for a, b in zip(torch_leaves(p2.params),
                    jax_leaves(jres.federated.params)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert ledger.total_bytes == jres.ledger.total_bytes


def test_charlm_bucket_takes_the_above_cut_upload():
    """CharLSTM-256's one f32 bucket (813,632 params, padded to 814,080)
    is above the cluster's cut: on the card its top-k upload is the four
    radix launches and K4 alone.  On the CPU the engine's
    ``FlatParamOps.compress_delta`` runs the plain path (no launch
    counted): c and the residual bit for bit the JAX package's numpy
    oracle over the logical elements, the pad lanes zero, and τ the
    radix threshold's plain twin."""
    task = charlm_task()
    fops = host_flat_ops(task, False, torch.device("cpu"))
    n_logical = fops.view.buffer_sizes["float32"]
    n = fops.padded_sizes["float32"]
    assert (n_logical, n) == (813_632, 814_080)
    assert n > fu.topk_cut() and fu.topk_launches(n) == 4
    spec = CompressionSpec(bits=8, density=0.25, error_feedback=True)
    d = (np.random.default_rng(7).normal(size=n_logical) * 1e-2) \
        .astype(np.float32)
    d[128:256] = 0.0
    bufs = fops.pad({"float32": torch.from_numpy(d)})
    before = {f.__name__: f.launches for f in fu.UPLOAD_KERNELS}
    c, r = fops.compress_delta(bufs, spec)
    assert {f.__name__: f.launches for f in fu.UPLOAD_KERNELS} == before
    c_np, r_np = jcomp.numpy_compress(
        d, jcomp.CompressionSpec(8, 0.25, True))
    np.testing.assert_array_equal(c["float32"][:n_logical].numpy(), c_np)
    np.testing.assert_array_equal(r["float32"][:n_logical].numpy(), r_np)
    assert not c["float32"][n_logical:].any()
    k = topk_k(spec, n_logical)
    _, _, tau = fu.topk_compress(bufs["float32"], k, bits=8,
                                 with_residual=True)
    assert tau.view(torch.int32) == fu.topk_threshold_plain(
        bufs["float32"], k).view(torch.int32)


def test_pod_rejects_charlm():
    """The pod takes a charlm task since the pod slice of M2d: its flat
    ops hold the host engine's bucket; a task kind it does not know is
    still rejected, naming the kinds it runs."""
    import dataclasses
    from repro_torch.fl.pod import PodFLConfig, PodFLSpec
    from repro_torch.launch.mesh import destroy, make_host_mesh
    mesh = make_host_mesh("cpu")
    try:
        strategy = PodFLConfig(mesh, spec=PodFLSpec(update_impl="fused")) \
            .strategy()
        task = charlm_task(VOCAB, D_EMBED, D_HIDDEN)
        fops = strategy.flat_ops(task, torch.device("cpu"))
        assert fops.view == host_flat_ops(task, False,
                                          torch.device("cpu")).view
        with pytest.raises(ValueError, match="unknown task kind"):
            strategy.flat_ops(dataclasses.replace(task, kind="audio"),
                              torch.device("cpu"))
    finally:
        destroy()


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_charlm_on_the_pod_matches_the_host_engine(sides, impl):
    """CharLSTM on the one-rank pod (M2d on the pod): the relay bitwise
    the host relay, the P2 FedAvgM rounds (sequential K6 accumulation)
    within rtol 1e-5 of the host's (one K2 pass), and the eval stream's
    per-sample mean over positions (a sequence's loss) equal."""
    from repro_torch.core.pipeline import Phase, run_phase_schedule
    from repro_torch.fl import pod
    from repro_torch.launch.mesh import destroy, make_host_mesh
    from repro_torch.models.transformer import _xent

    (jtask, jdata), (ttask, tdata) = sides

    def seq_loss(params, bx, by):
        logits = pm.charlstm_apply(params, bx)
        return torch.stack([_xent(logits[i], by[i])[0]
                            for i in range(bx.shape[0])])

    init = bridge.params_from_numpy(jax_numpy_params(
        jtask.init(jax.random.PRNGKey(SEED))))
    n_data = jdata.n_per_client
    idx1 = jax_engine_indices(SEED, 1, 2, STEPS, BATCH, n_data)
    idx2 = jax_engine_indices(SEED, 2, 3, STEPS, BATCH, n_data)
    spec = pod.PodFLSpec(local_steps=STEPS, batch_size=BATCH, lr=0.5,
                         server_opt="momentum", update_impl=impl)
    mesh = make_host_mesh("cpu")
    try:
        res = run_phase_schedule(ttask, tdata, [
            Phase("P1", pod.PodCyclicConfig(
                mesh, rounds=1, clients_per_round=2, spec=spec,
                sampling="host", batch_indices=index_source(idx1),
                eval_every=1, eval_batch=7), eval_fn=seq_loss),
            Phase("P2", pod.PodFLConfig(
                mesh, rounds=2, clients_per_round=3, spec=spec,
                sampling="host", batch_indices=index_source(idx2),
                eval_every=1, eval_batch=7), eval_fn=seq_loss)],
            device="cpu", init_params=init)
    finally:
        destroy()
    tcyc = CyclicConfig(rounds=1, participation=2 / N_CLIENTS,
                        local_steps=STEPS, batch_size=BATCH, lr=0.5,
                        lr_decay=1.0, eval_every=1, eval_batch=7, seed=SEED,
                        sampling="host", update_impl=impl,
                        batch_indices=index_source(idx1))
    tfed = FLConfig(rounds=2, participation=3 / N_CLIENTS, local_steps=STEPS,
                    batch_size=BATCH, lr=0.5, lr_decay=1.0,
                    server_opt="momentum", eval_every=1, eval_batch=7,
                    seed=SEED, sampling="host", update_impl=impl,
                    chunk_size=4, batch_indices=index_source(idx2))
    p1 = cyclic_pretrain(ttask, tdata, tcyc, init_params=init, device="cpu",
                         eval_fn=seq_loss)
    p2 = run_federated(ttask, tdata, tfed, init_params=p1.params,
                       device="cpu", eval_fn=seq_loss)
    r1, r2 = res.phases[0].result, res.phases[1].result
    for a, b in zip(tree_leaves(r1.params), tree_leaves(p1.params)):
        assert torch.equal(a, b)
    assert [h["acc"] for h in r1.history] == [h["acc"] for h in p1.history]
    np.testing.assert_allclose([h["local_loss"] for h in r2.history],
                               [h["local_loss"] for h in p2.history],
                               rtol=1e-5)
    np.testing.assert_allclose([h["acc"] for h in r2.history],
                               [h["acc"] for h in p2.history], rtol=1e-5)
    for a, b in zip(torch_leaves(r2.params), torch_leaves(p2.params)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
