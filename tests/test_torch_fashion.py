"""CNN-Fashion (2 conv + dropout + 2 FC) in the port against the JAX
package, on the CPU.

The forward with the dropout keep-mask injected (the JAX package's own
``bernoulli`` draw) within 1e-5; a P2 run (FedAvg, and FedAvgM) from the
JAX package's init, with its threefry batch indices and its per-step
keep-masks injected through ``RoundSchedule.batch_indices`` and
``RoundSchedule.step_masks``, at ``test_torch_pipeline.py``'s tolerances
(losses rtol 1e-4, params atol 1e-4).  Then the port's own dropout: each
step of an engine run draws from a generator seeded per (round, client
slot, step), the run repeats under the same seed, and training with
dropout differs from training without it.  The single-round surface
``make_round_fn`` matches the reference's with its masks injected, and
draws dropout per step under an int key and under an index source.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices,
                          jax_engine_masks, jax_leaves, jax_local_indices,
                          jax_local_masks, jax_numpy_params, mask_source,
                          torch_leaves)

import jax
import jax.numpy as jnp
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.fl.simulation import FLConfig as JFLConfig
from repro.fl.simulation import make_round_fn as j_make_round_fn
from repro.fl.simulation import run_federated as j_run_federated
from repro.fl.task import vision_task as j_vision_task
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.engine import run_rounds
from repro_torch.fl.simulation import FLConfig, make_round_fn, run_federated
from repro_torch.fl.task import Task, vision_task
from repro_torch.models import paper_models as pm
from repro_torch.utils.tree_math import tree_leaves

SEED = 0
N_CLIENTS, N_TRAIN, N_TEST = 8, 256, 64
STEPS, BATCH = 3, 8
FLAT = 32 * 7 * 7                   # the dropout's width (B, 1568)


def _jparams(seed=SEED):
    return jpm.cnn_fashion_init(jax.random.PRNGKey(seed), n_classes=10,
                                in_ch=1)


@pytest.mark.parametrize("train", [True, False])
def test_cnn_fashion_forward_matches_jax(train):
    """With the JAX package's keep-mask injected (train) or no dropout
    (eval): logits within 1e-5; 215,370 params in the reference's
    layout."""
    jp = _jparams()
    x = np.random.default_rng(1).normal(size=(4, 28, 28, 1)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpm.cnn_fashion_apply(jp, jnp.asarray(x), train=train,
                                            rng=key))
    mask = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5,
                                                          (4, FLAT))))
    tp = bridge.params_from_numpy(jax_numpy_params(jp))
    got = pm.cnn_fashion_apply(tp, torch.from_numpy(x), train=train,
                               rng=mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert sum(t.numel() for t in tree_leaves(tp)) == 215_370
    assert [tuple(t.shape) for t in tree_leaves(pm.cnn_fashion_init(
        torch.Generator().manual_seed(0)))] == \
        [tuple(t.shape) for t in jax.tree_util.tree_leaves(jp)]


def test_cnn_fashion_generator_dropout():
    """A generator draws ``uniform < 1 - drop`` on its device: the same
    seed gives the same logits, another seed others, eval draws
    nothing, and a mask of the wrong shape raises."""
    tp = pm.cnn_fashion_init(torch.Generator().manual_seed(0))
    x = torch.randn(4, 28, 28, 1, generator=torch.Generator().manual_seed(1))

    def run(seed, train=True):
        return pm.cnn_fashion_apply(tp, x, train=train,
                                    rng=torch.Generator().manual_seed(seed))
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert torch.equal(run(5, train=False), pm.cnn_fashion_apply(tp, x))
    with pytest.raises(ValueError, match="keep-mask"):
        pm.cnn_fashion_apply(tp, x, train=True,
                             rng=torch.ones(4, 10, dtype=torch.bool))


@pytest.fixture(scope="module")
def sides():
    kw = dict(n_clients=N_CLIENTS, beta=0.5, seed=SEED, n_train=N_TRAIN,
              n_test=N_TEST)
    return ((j_vision_task("cnn_fashion", n_classes=10, in_ch=1),
             J_DATASETS.get("fashion-like")(**kw)),
            (vision_task("cnn_fashion", n_classes=10, in_ch=1),
             DATASETS.get("fashion-like")(**kw)))


@pytest.mark.parametrize("impl,server_opt", [("tree", "none"),
                                             ("fused", "none"),
                                             ("fused", "momentum")])
def test_cnn_fashion_p2_matches_jax_with_its_masks(sides, impl, server_opt):
    (jtask, jdata), (task, data) = sides
    common = dict(rounds=2, participation=0.25, local_steps=STEPS,
                  batch_size=BATCH, eval_every=1, seed=SEED,
                  sampling="host", server_opt=server_opt, chunk_size=1)
    jcfg = JFLConfig(**common, update_impl="tree" if impl == "tree"
                     else "fused_interpret")
    jinit = jtask.init(jax.random.PRNGKey(SEED))
    jres = j_run_federated(jtask, jdata, jcfg, init_params=jinit)

    K = jcfg.n_selected(N_CLIENTS)
    cfg = FLConfig(**common, update_impl=impl)
    schedule = dataclasses.replace(
        cfg.schedule(),
        batch_indices=index_source(jax_engine_indices(
            SEED, 2, K, STEPS, BATCH, data.n_per_client)),
        step_masks=mask_source(jax_engine_masks(
            SEED, 2, K, STEPS, (BATCH, FLAT), 0.5)))
    res = run_rounds(task, data, cfg.strategy(), schedule,
                     init_params=bridge.params_from_numpy(
                         jax_numpy_params(jinit)), device="cpu")
    np.testing.assert_allclose([h["local_loss"] for h in res.history],
                               [h["local_loss"] for h in jres.history],
                               rtol=1e-4)
    for jh, th in zip(jres.history, res.history):
        assert abs(jh["acc"] - th["acc"]) * N_TEST <= 2 + 1e-6
    for a, b in zip(torch_leaves(res.params), jax_leaves(jres.params)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def _recording(task: Task, seen: list, drop: bool = True) -> Task:
    """``task`` whose loss records each step's dropout source (and, with
    ``drop`` False, hands the model none)."""
    def loss_fn(params, bx, by, rng=None):
        seen.append(rng)
        if isinstance(rng, torch.Generator):
            seen[-1] = rng.initial_seed()
        return task.loss_fn(params, bx, by, rng if drop else None)
    return dataclasses.replace(task, loss_fn=loss_fn)


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_engine_trains_with_dropout(sides, impl):
    """Every SGD step of an engine run gets its own generator seed; the
    run repeats under the same seed; without dropout it differs."""
    _, (task, data) = sides
    cfg = FLConfig(rounds=2, participation=0.25, local_steps=2,
                   batch_size=BATCH, eval_every=0, seed=SEED,
                   sampling="host", update_impl=impl)
    init = task.init(torch.Generator().manual_seed(0))
    runs = []
    for drop in (True, True, False):
        seen = []
        res = run_federated(_recording(task, seen, drop), data, cfg,
                            init_params=init, device="cpu")
        runs.append((res.history, tree_leaves(res.params), seen))
    steps = 2 * cfg.n_selected(N_CLIENTS) * 2
    assert len(runs[0][2]) == steps and len(set(runs[0][2])) == steps
    assert runs[0][2] == runs[1][2] and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]


@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_make_round_fn_trains_with_dropout(sides, impl):
    """One FedAvg round through ``make_round_fn`` on clients (5, 0): with
    the reference's batch draws as the key and its keep-masks as
    ``step_masks`` it matches the reference's round; with no masks,
    under an int key and under an index source alike, every step draws
    from a generator of its own seed."""
    (jtask, jdata), (task, data) = sides
    common = dict(local_steps=STEPS, batch_size=BATCH, lr=0.05)
    jfn = j_make_round_fn(jtask, JFLConfig(
        **common, update_impl="tree" if impl == "tree"
        else "fused_interpret"))
    cfg = FLConfig(**common, update_impl=impl)
    jparams = _jparams(2)
    ids = np.array([5, 0])
    weights = np.full(2, float(data.n_per_client), np.float32)
    key = jax.random.PRNGKey(4)
    jx, jy, _ = jdata.device_arrays()
    jp, _, jm = jfn(key, jparams, jx, jy, jnp.asarray(ids),
                    jnp.asarray(weights), jnp.float32(0.9), {})
    cks = jax.random.split(key, len(ids))
    idx = np.stack([jax_local_indices(ck, STEPS, BATCH, data.n_per_client)
                    for ck in cks])
    masks = np.stack([jax_local_masks(ck, STEPS, (BATCH, FLAT), 0.5)
                      for ck in cks])
    params = bridge.params_from_numpy(jax_numpy_params(jparams))
    rows = lambda slot, step: torch.from_numpy(idx[slot, step])
    p, _, m = make_round_fn(task, cfg, device="cpu")(
        rows, params, data.x, data.y, ids, weights, 0.9, {},
        step_masks=lambda slot, step: torch.from_numpy(masks[slot, step]))
    np.testing.assert_allclose(float(m["local_loss"]),
                               float(jm["local_loss"]), rtol=1e-5)
    for a, b in zip(torch_leaves(p), jax_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-5)

    for key in (rows, 7):
        seen = []
        make_round_fn(_recording(task, seen), cfg, device="cpu")(
            key, params, data.x, data.y, ids, weights, 0.9, {})
        assert len(seen) == 2 * STEPS and len(set(seen)) == 2 * STEPS
        assert all(isinstance(s, int) for s in seen)
