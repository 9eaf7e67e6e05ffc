"""``repro_torch.launch.train`` (``run_pod_training``, its CLI) and
``examples/federated_llm_torch.py`` against the JAX package's, on the
CPU.

``run_pod_training`` at the smoke size: the reduced tinyllama-1.1b with
``lora:4`` adapters (f32) on ``make_synthetic_tokenlm`` (8 clients × 8
sequences of 16 tokens), P1 1 round then P2 2 rounds of 2 clients × 2
SGD steps of batch 4, on the one-rank pod, with the example's
per-sequence loss as the eval metric.  Both sides start from the JAX
package's ``init_lm`` (carried by the bridge) and train on its threefry
batch indices (P1 keyed by the seed, P2 by the seed + 17, as
``run_pod_training`` offsets it) under ``sampling="host"``; the port
runs the kernels' plain versions.  Tolerances: losses and eval values
rtol 1e-5, params atol 2e-5 (the matmuls sum in another order); the
phases, the frozen leaves (bitwise) and the ledger bytes exactly.  The
CLI and the example run at a tiny size in subprocesses with
``--device cpu`` and exit 0.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_numpy_params, torch_leaves)

import jax
import jax.numpy as jnp
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

ROOT = Path(__file__).resolve().parent.parent
SEED, ARCH = 0, "tinyllama-1.1b"
N_CLIENTS, N_SEQ, SEQ = 8, 8, 16
STEPS, BATCH, K = 2, 4, 2
P1_ROUNDS, P2_ROUNDS = 1, 2


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_host_mesh("cpu")
    yield m
    tmesh.destroy()


def _jax_eval_loss(jcfg):
    """The JAX example's per-sequence eval metric."""
    def eval_loss(params, bx, by):
        logits, _, _ = JT.lm_forward(params, jcfg, {"tokens": bx})
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(
            logits, jnp.maximum(by, 0)[..., None], axis=-1)[..., 0]
        valid = (by >= 0).astype(jnp.float32)
        per_tok = (logz - gold) * valid
        return per_tok.sum(axis=-1) / jnp.maximum(valid.sum(axis=-1), 1.0)
    return eval_loss


@pytest.fixture(scope="module")
def both(mesh):
    jcfg = jwith_peft(jget_reduced(ARCH), "lora:4")
    kw = dict(n_clients=N_CLIENTS, seq_len=SEQ, n_seq_per_client=N_SEQ,
              vocab=jcfg.vocab_size, beta=0.5, seed=SEED)
    jinit = jax_numpy_params(JT.init_lm(jax.random.PRNGKey(SEED), jcfg))
    common = dict(cyclic_rounds=P1_ROUNDS, fl_rounds=P2_ROUNDS,
                  clients_per_round=K, seed=SEED, eval_batch=16,
                  sampling="host", chunk_size=2)
    jres = jtrain.run_pod_training(
        jcfg, j_tokenlm(**kw), spec=JPodFLSpec(
            local_steps=STEPS, batch_size=BATCH, lr=0.05,
            update_impl="fused_interpret", peft="lora:4"),
        mesh=j_make_host_mesh(), eval_fn=_jax_eval_loss(jcfg), **common)
    cfg = with_peft(get_reduced(ARCH), "lora:4")
    indices = {"P1": jax_engine_indices(SEED, P1_ROUNDS, K, STEPS, BATCH,
                                        N_SEQ),
               "P2": jax_engine_indices(SEED + 17, P2_ROUNDS, K, STEPS, BATCH,
                                        N_SEQ)}
    init = bridge.params_from_numpy(jinit)
    tres = train.run_pod_training(
        cfg, make_synthetic_tokenlm(**kw), spec=train.PodFLSpec(
            local_steps=STEPS, batch_size=BATCH, lr=0.05, update_impl="fused",
            peft="lora:4"),
        mesh=mesh, eval_fn=train.sequence_loss_metric(cfg),
        init_params=init,
        batch_indices={k: index_source(v) for k, v in indices.items()},
        **common)
    return jres, tres, init


def test_run_pod_training_matches_jax(both):
    jres, tres, _ = both
    assert [h["phase"] for h in tres.history] == \
        [h["phase"] for h in jres.history] == ["P1", "P2", "P2"]
    for key in ("loss", "eval"):
        np.testing.assert_allclose([h[key] for h in tres.history],
                                   [h[key] for h in jres.history], rtol=1e-5)
    for a, b in zip(torch_leaves(tres.params), jax_leaves(jres.params)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_p1_relays_the_full_model_and_p2_the_slice(both):
    """P1 strips the trainable filter (every leaf moves); P2 keeps the
    frozen leaves at P1's end bitwise and moves every adapter leaf; the
    ledger's P2 upload is the adapter slice's bytes."""
    _, tres, init = both
    p1 = tres.schedule.phases[0].result.params
    mask = rules.trainable_mask(init, "lora")
    for a, b in zip(tm.tree_leaves(init), tm.tree_leaves(p1)):
        assert not torch.equal(a, b)
    for a, b, m in zip(tm.tree_leaves(p1), tm.tree_leaves(tres.params), mask):
        assert torch.equal(a, b) != m
    ledger = tres.schedule.ledger
    n_lora = sum(t.numel() for t, m in zip(tm.tree_leaves(init), mask) if m)
    assert ledger.p2_upload_bytes == P2_ROUNDS * K * 4 * n_lora
    assert ledger.summary()["model_bytes"] == 4 * sum(
        t.numel() for t in tm.tree_leaves(init))


def test_sample_round_batches_matches_jax():
    kw = dict(n_clients=4, seq_len=8, n_seq_per_client=6, vocab=64, seed=1)
    ids = np.array([2, 0, 3])
    got = train.sample_round_batches(make_synthetic_tokenlm(**kw), ids, 2, 3,
                                     np.random.default_rng(5))
    want = jtrain.sample_round_batches(j_tokenlm(**kw), ids, 2, 3,
                                       np.random.default_rng(5))
    for k in ("tokens", "labels"):
        assert got[k].shape == (3, 2, 3, 8)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("extra", [[], ["--peft", "lora:4",
                                        "--eval-every", "1"]])
def test_cli_runs_on_the_cpu(extra):
    out = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
                "--rounds", "2", "--cyclic-rounds", "1", "--clients", "4",
                "--local-steps", "2", "--batch", "4", "--seq", "16"] + extra)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] tinyllama-1.1b: loss" in out.stdout


@pytest.mark.parametrize("peft", ["lora:8", "none"])
def test_example_runs_on_the_cpu(peft):
    out = _run(["examples/federated_llm_torch.py", "--tiny", "--device",
                "cpu", "--local-steps", "2", "--seq", "16", "--peft", peft])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[llm] eval loss" in out.stdout
    assert ("trainable (lora:8)" in out.stdout) == (peft != "none")
