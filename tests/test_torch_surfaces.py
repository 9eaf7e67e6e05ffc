"""The port's remaining reference surfaces against the JAX package, on
the CPU: the learning-rate schedules (rtol 1e-6), the single P1 round
``make_cyclic_round_fn`` (tree and fused, on the MLP and on CNN-Fashion,
with the reference's batch draws and dropout keep-masks injected; loss
rtol 1e-5, params atol 1e-5), the host-side
``make_eval_fn`` (against the reference's and against the engine's own
eval stream, on vision and token data), ``ClientBatchIterator`` (bit
for bit) and the three ``examples/*_torch.py`` at a tiny size on the
CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import (jax_leaves, jax_local_indices, jax_local_masks,
                          jax_numpy_params, torch_leaves)

import jax
import jax.numpy as jnp
from repro.core.cyclic import CyclicConfig as JCyclicConfig
from repro.core.cyclic import make_cyclic_round_fn as j_make_cyclic_round_fn
from repro.data.federated import ClientBatchIterator as JClientBatchIterator
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.fl.engine import make_eval_fn as j_make_eval_fn
from repro.fl.task import charlm_task as j_charlm_task
from repro.fl.task import vision_task as j_vision_task
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.core.cyclic import CyclicConfig, make_cyclic_round_fn
from repro_torch.data.federated import ClientBatchIterator
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.engine import make_eval_fn
from repro_torch.fl.simulation import FLConfig, run_federated
from repro_torch.fl.task import charlm_task, vision_task
from repro_torch.optim import schedules as sched
from repro_torch.utils.tree_math import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
STEPS_AT = (0, 1, 5, 17, 49, 50, 51, 100, 299, 300, 499, 500, 1000)
MLP_KW = {"img": 32}

SCHEDULES = {
    "constant": lambda m: m.constant_schedule(0.1),
    "exponential": lambda m: m.exponential_decay(0.05),
    "exponential_per_10": lambda m: m.exponential_decay(0.05, 0.9, 10),
    "cosine": lambda m: m.cosine_decay(0.1, 300),
    "cosine_floor": lambda m: m.cosine_decay(0.1, 300, 0.2),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 50, 500),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """At every step, as an int and as an int tensor: an f32 0-dim tensor
    on the step's device, within rtol 1e-6 of the reference."""
    port, ref = SCHEDULES[name](sched), SCHEDULES[name](jsched)
    want = [float(ref(jnp.asarray(s, jnp.int32))) for s in STEPS_AT]
    for as_tensor in (False, True):
        got = []
        for s in STEPS_AT:
            lr = port(torch.tensor(s) if as_tensor else s)
            assert lr.dtype == torch.float32 and lr.shape == ()
            assert lr.device == torch.device("cpu")
            got.append(float(lr))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def vision_sides():
    kw = dict(n_clients=6, beta=0.5, seed=0, n_train=192, n_test=40)
    return ((j_vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs=MLP_KW),
             J_DATASETS.get("cifar10-like")(**kw)),
            (vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs=MLP_KW),
             DATASETS.get("cifar10-like")(**kw)))


@pytest.fixture(scope="module")
def fashion_sides():
    kw = dict(n_clients=6, beta=0.5, seed=0, n_train=192, n_test=40)
    return ((j_vision_task("cnn_fashion", n_classes=10, in_ch=1),
             J_DATASETS.get("fashion-like")(**kw)),
            (vision_task("cnn_fashion", n_classes=10, in_ch=1),
             DATASETS.get("fashion-like")(**kw)))


@pytest.mark.parametrize("model", ["mlp", "cnn_fashion"])
@pytest.mark.parametrize("impl", ["tree", "fused"])
def test_cyclic_round_fn_matches_jax(vision_sides, fashion_sides, impl,
                                     model):
    """One relay round over clients (4, 1, 2) from the same params, the
    reference's per-client, per-step batch draws injected as the key and
    its dropout keep-masks (CNN-Fashion's (B, 1568)) as ``step_masks``."""
    (jtask, jdata), (task, data) = (vision_sides if model == "mlp"
                                    else fashion_sides)
    steps, batch = 3, 8
    common = dict(local_steps=steps, batch_size=batch, lr=0.05)
    jfn = j_make_cyclic_round_fn(jtask, JCyclicConfig(
        **common, update_impl="tree" if impl == "tree"
        else "fused_interpret"))
    fn = make_cyclic_round_fn(task, CyclicConfig(**common, update_impl=impl),
                              device="cpu")
    jparams = jtask.init(jax.random.PRNGKey(2))
    ids = np.array([4, 1, 2])
    key = jax.random.PRNGKey(9)
    jp, jm = jfn(key, jparams, jnp.asarray(jdata.x), jnp.asarray(jdata.y),
                 jnp.asarray(ids), jnp.float32(0.9))
    cks = jax.random.split(key, len(ids))
    idx = np.stack([jax_local_indices(ck, steps, batch, data.n_per_client)
                    for ck in cks])
    masks = np.stack([jax_local_masks(ck, steps, (batch, 32 * 7 * 7), 0.5)
                      for ck in cks])
    params = bridge.params_from_numpy(jax_numpy_params(jparams))
    before = [t.clone() for t in tree_leaves(params)]
    p, m = fn(lambda slot, step: torch.from_numpy(idx[slot, step]),
              params, data.x, data.y, ids, 0.9,
              step_masks=lambda slot, step: torch.from_numpy(
                  masks[slot, step]))
    np.testing.assert_allclose(float(m["local_loss"]),
                               float(jm["local_loss"]), rtol=1e-5)
    for a, b in zip(torch_leaves(p), jax_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # the caller's params are never written; an int key repeats itself
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))
    runs = [fn(7, params, data.x, data.y, ids, 0.9)[0] for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in
               zip(torch_leaves(runs[0]), torch_leaves(runs[1])))


@pytest.fixture(scope="module")
def charlm_sides():
    kw = dict(n_clients=4, seq_len=8, n_seq_per_client=8, n_test=37, seed=0)
    return ((j_charlm_task(64, 8, 16),
             J_DATASETS.get("shakespeare-like")(**kw)),
            (charlm_task(64, 8, 16),
             DATASETS.get("shakespeare-like")(**kw)))


@pytest.mark.parametrize("kind", ["vision", "charlm"])
def test_make_eval_fn_matches_jax_and_the_eval_stream(vision_sides,
                                                      charlm_sides, kind):
    """``make_eval_fn`` equals the reference's on the same params, and
    the engine's in-run eval stream (tail batch padded, weighted) on a
    run's final params: token tasks average over every position."""
    (jtask, jdata), (task, data) = (vision_sides if kind == "vision"
                                    else charlm_sides)
    batch = 16                      # 40 and 37 test samples: a tail batch
    jparams = jtask.init(jax.random.PRNGKey(5))
    params = bridge.params_from_numpy(jax_numpy_params(jparams))
    want = j_make_eval_fn(jtask, batch)(jparams, jdata.test_x, jdata.test_y)
    got = make_eval_fn(task, batch, device="cpu")(params, data.test_x,
                                                  data.test_y)
    assert isinstance(got, float)
    assert abs(got - want) < 1e-6
    res = run_federated(task, data, FLConfig(
        rounds=1, participation=0.5, local_steps=2, batch_size=4,
        eval_every=1, eval_batch=batch, update_impl="fused"),
        init_params=params, device="cpu")
    stream = res.history[-1]["acc"]
    host = make_eval_fn(task, batch, device="cpu")(res.params, data.test_x,
                                                   data.test_y)
    assert abs(stream - host) < 1e-6


def test_client_batch_iterator_is_bitwise():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 5)).astype(np.float32)
    y = rng.integers(0, 10, size=37)
    port = ClientBatchIterator(x, y, 8, 3)
    ref = JClientBatchIterator(x, y, 8, 3)
    for _ in range(3):
        got, want = list(port.epoch()), list(ref.epoch())
        assert len(got) == len(want) == 4
        for (bx, by), (jx, jy) in zip(got, want):
            assert bx.tobytes() == jx.tobytes()
            assert by.tobytes() == jy.tobytes()


TINY = ["--device", "cpu", "--clients", "4", "--n-train", "128",
        "--n-test", "32", "--local-steps", "2"]


@pytest.mark.parametrize("example,extra,expect", [
    ("quickstart_torch.py", ["--cyclic-rounds", "1", "--fl-rounds", "1"],
     "Cyclic+FedAvg best acc"),
    ("phase_schedules_torch.py", [], "adaptive relay"),
    ("switch_policies_torch.py", ["--total", "4"], "[switch] plateau")])
def test_torch_example_runs_on_the_cpu(example, extra, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / example)]
                         + TINY + extra, capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout


def test_serve_batch_example_runs_on_the_cpu():
    """``examples/serve_batch_torch.py``: the four input families of the
    JAX package's ``serve_batch.py`` through ``Engine.generate``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_batch_torch.py"),
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "2"], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for arch, shape in (("qwen2-1.5b", "(2, 2)"), ("mamba2-1.3b", "(2, 2)"),
                        ("internvl2-1b", "(2, 2)"),
                        ("musicgen-medium", "(2, 2, 4)")):
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith(f"[{arch}"))
        assert line.endswith(f"out_shape={shape}")
