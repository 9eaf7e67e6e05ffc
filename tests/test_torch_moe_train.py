"""Federated fine-tuning of the MoE zoo: ``run_pod_training`` on the
reduced deepseek-v2-lite-16b and deepseek-v3-671b with ``lora:4``
adapters against the JAX package's, under the "lora" filter and under
``/(lora_a|lora_b)$|/router/w$`` (the adapters and every MoE router,
deepseek-v3's ``mtp`` block's included).

P2 only (``cyclic_rounds=0``): 2 rounds of 2 clients × 2 SGD steps of
batch 4 on ``make_synthetic_tokenlm`` (8 clients × 8 sequences of 16
tokens), f32, on the one-rank pod, both sides from the JAX package's
``init_lm`` (carried by the bridge) on its threefry batch indices under
``sampling="host"``; the port runs the kernels' plain versions.
Tolerances: history losses rtol 1e-5, params atol 2e-5 (as
``test_torch_train.py``); which trainable leaves move, and the frozen
leaves (bitwise their init), exactly.  In the JAX run every trainable
leaf moves: the dense layer's MLP adapters and, under the router
filter, each router.
"""
import functools

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_numpy_params, torch_leaves)

import jax
from repro.configs import get_reduced as jget_reduced
from repro.configs import with_peft as jwith_peft
from repro.data.synthetic import make_synthetic_tokenlm as j_tokenlm
from repro.fl.pod import PodFLSpec as JPodFLSpec
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_reduced, with_peft
from repro_torch.data.synthetic import make_synthetic_tokenlm
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm

SEED = 0
N_CLIENTS, N_SEQ, SEQ = 8, 8, 16
STEPS, BATCH, K, ROUNDS = 2, 4, 2, 2
ROUTER_FILTER = r"/(lora_a|lora_b)$|/router/w$"
CASES = [(a, f) for a in ("deepseek-v2-lite-16b", "deepseek-v3-671b")
         for f in ("lora", ROUTER_FILTER)]


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_host_mesh("cpu")
    yield m
    tmesh.destroy()


def _data_kw(vocab):
    return dict(n_clients=N_CLIENTS, seq_len=SEQ, n_seq_per_client=N_SEQ,
                vocab=vocab, beta=0.5, seed=SEED)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, filt):
    jcfg = jwith_peft(jget_reduced(arch), "lora:4")
    jinit = jax_numpy_params(JT.init_lm(jax.random.PRNGKey(SEED), jcfg))
    jres = jtrain.run_pod_training(
        jcfg, j_tokenlm(**_data_kw(jcfg.vocab_size)), spec=JPodFLSpec(
            local_steps=STEPS, batch_size=BATCH, lr=0.05,
            update_impl="fused_interpret", peft="lora:4",
            trainable_filter=filt),
        mesh=j_make_host_mesh(), cyclic_rounds=0, fl_rounds=ROUNDS,
        clients_per_round=K, seed=SEED, sampling="host", chunk_size=2)
    return jinit, [h["loss"] for h in jres.history], jax_leaves(jres.params)


@pytest.mark.parametrize("arch,filt", CASES)
def test_moe_pod_training_matches_jax(arch, filt, mesh):
    jinit, jlosses, jparams = _jax_run(arch, filt)
    cfg = with_peft(get_reduced(arch), "lora:4")
    init = bridge.params_from_numpy(jinit)
    idx = jax_engine_indices(SEED, ROUNDS, K, STEPS, BATCH, N_SEQ)
    tres = train.run_pod_training(
        cfg, make_synthetic_tokenlm(**_data_kw(cfg.vocab_size)),
        spec=train.PodFLSpec(local_steps=STEPS, batch_size=BATCH, lr=0.05,
                             update_impl="fused", peft="lora:4",
                             trainable_filter=filt),
        mesh=mesh, cyclic_rounds=0, fl_rounds=ROUNDS, clients_per_round=K,
        seed=SEED, sampling="host", chunk_size=2, init_params=init,
        batch_indices={"P2": index_source(idx)})
    np.testing.assert_allclose([h["loss"] for h in tres.history], jlosses,
                               rtol=1e-5)
    got = torch_leaves(tres.params)
    for a, b in zip(got, jparams):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)

    # the same trainable leaves move on both sides; frozen ones stay
    mask = rules.trainable_mask(init, filt)
    start = torch_leaves(init)
    jmoved = [not np.array_equal(a, b) for a, b in zip(start, jparams)]
    tmoved = [not np.array_equal(a, b) for a, b in zip(start, got)]
    assert tmoved == jmoved == list(mask)
    for a, b, m in zip(tm.tree_leaves(init), tm.tree_leaves(tres.params),
                       mask):
        if not m:
            assert torch.equal(a, b)
    paths = [p for p, m in zip(tm.tree_paths(init), mask) if m]
    assert any(p.endswith("/router/w") for p in paths) == \
        (filt == ROUTER_FILTER)
    # the upload is the slice: 4 bytes an element, each client, each round
    n_slice = sum(t.numel() for t, m in zip(tm.tree_leaves(init), mask) if m)
    assert tres.schedule.ledger.p2_upload_bytes == ROUNDS * K * 4 * n_slice
