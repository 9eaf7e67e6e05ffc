"""Tensor parallelism over ``model`` for the SSM, hybrid, VLM and audio
zoo, and FedProx under tensor parallelism, against the JAX package's pod
and against the whole model, on the CPU.

Four ranks: ``tests/torch_pod_sharded_worker.py`` runs in four
processes over a ``file://`` gloo store; at the same time the JAX pod
runs in a subprocess on 4 fake CPU devices (meshes from
``repro.launch.mesh._make_mesh``).  The models are the reduced
mamba2-1.3b (16 SSM heads) and hymba-1.5b (4 attention heads on 2 kv
heads beside 16 SSM heads), on ``make_synthetic_tokenlm`` (4 clients ×
8 sequences of 16 tokens), 2 clients × 2 SGD steps of batch 4 a round,
from the JAX package's init on its threefry batch indices.  Cases, each
under ``fsdp_tp``, where XLA's partitioner splits the JAX pod's step
over ``model``:

  * (2, 2) and (1, 4): the P1 relay of the whole model, then one P2
    round from its end (hymba on (2, 2) with ``lora:4`` in P2): the SSM
    heads, the MLP, the vocabulary and hymba's attention split;
  * FedProx (μ 0.5) P2 rounds on the reduced tinyllama-1.1b on (1, 4)
    (its kv projections whole: ``partial`` leaves) and on mamba2-1.3b on
    (2, 2): the anchor is the model-local tree, the proximal term summed
    over ``model``.

Tolerances, as in ``tests/test_torch_pod_sharded.py``: losses rtol
1e-5, params atol 2e-5.  In the same workers the (2, 2) cases run under
``replicated`` too: ``fsdp_tp`` matches it within those tolerances.
``lower_pod_round`` counts every collective of each run (P1 and P2
summed).

On the four gloo ranks alone, against the whole model on each rank:
``launch.steps.make_train_step`` on the reduced internvl2-1b (tied,
vocabulary-parallel text embedding after the patch embeddings) and
musicgen-medium (4 codebooks' vocabulary split), mamba2-1.3b and
hymba-1.5b (also with 3 attention heads, which stay whole on 2 ranks
while the SSM splits), model-local against whole: losses, the first
gradient and the params after two steps; the tensor-parallel prefill
and two greedy decode steps of mamba2-1.3b and hymba-1.5b (the SSD core
as ``ssd_chunked`` and as K8's plain version), each rank's SSM state
its heads of the whole state; the codebook cross-entropy (1, 2 and 4
codebooks over 2 and 4 ranks: two ranks per codebook, two codebooks per
rank) against ``_xent``, one codebook bitwise the form before codebooks;
and a control: the gated norm's Σx² reduced by ``reduce_from_model``
(an identity backward) moves the SSM archs' gradients far beyond the
tolerance.
"""
import json
import sys
import textwrap

import numpy as np
import pytest
from torch_parity import jax_engine_indices

from test_torch_pod_sharded import ROOT, _jax_init, _spawn, _wait

SEED, ARCH = 0, "mamba2-1.3b"
HYMBA, LLAMA, VLM, AUDIO = ("hymba-1.5b", "tinyllama-1.1b", "internvl2-1b",
                            "musicgen-medium")
N_CLIENTS, N_SEQ, SEQ = 4, 8, 16
STEPS, BATCH, K, LR = 2, 4, 2, 0.05
ATOL = 2e-5
# large enough that the proximal gradient moves the params far beyond
# ATOL within a round (a partial leaf's counted |model| times would show)
MU = 0.5
# the model-local step against the whole model's: the first gradient
# and the params after two steps, each leaf's largest gap over its
# largest magnitude (f32, the GEMMs split; ~1e-6 read)
STEP_RTOL = 1e-4

CASES = {
    "mamba-22": dict(shape=[2, 2], layout="fsdp_tp", kind="p1p2"),
    "mamba-14": dict(shape=[1, 4], layout="fsdp_tp", kind="p1p2"),
    "hymba-lora-22": dict(shape=[2, 2], layout="fsdp_tp", kind="p1p2",
                          arch=HYMBA, peft="lora:4"),
    "hymba-14": dict(shape=[1, 4], layout="fsdp_tp", kind="p1p2",
                     arch=HYMBA),
    "prox-llama-14": dict(shape=[1, 4], layout="fsdp_tp", kind="rounds",
                          arch=LLAMA, algorithm="fedprox",
                          spec={"mu": MU}),
    "prox-mamba-22": dict(shape=[2, 2], layout="fsdp_tp", kind="rounds",
                          algorithm="fedprox", spec={"mu": MU}),
}
# the port only: the replicated twins the (2, 2) cases are held to
TWINS = {name: "rep-" + name for name, c in CASES.items()
         if c["shape"] == [2, 2]}
# hymba with 3 attention heads: on 2 model ranks the attention stays
# whole while the SSM heads and the MLP split
HYMBA_3 = {"n_heads": 3, "n_kv_heads": 1}
STEPS_CASES = {
    "steps-vlm-22": dict(shape=[2, 2], arch=VLM),
    "steps-vlm-14": dict(shape=[1, 4], arch=VLM),
    "steps-audio-22": dict(shape=[2, 2], arch=AUDIO),
    "steps-audio-14": dict(shape=[1, 4], arch=AUDIO),
    "steps-mamba-14": dict(shape=[1, 4], arch=ARCH, control=True),
    "steps-hymba-22": dict(shape=[2, 2], arch=HYMBA, control=True),
    "steps-hymba3-22": dict(shape=[2, 2], arch=HYMBA, overrides=HYMBA_3),
}
SERVE = {
    "serve-mamba-14": dict(shape=[1, 4], arch=ARCH),
    "serve-mamba-22": dict(shape=[2, 2], arch=ARCH,
                           ssd_impl="pallas_interpret"),
    "serve-hymba-14": dict(shape=[1, 4], arch=HYMBA,
                           ssd_impl="pallas_interpret"),
    "serve-hymba-22": dict(shape=[2, 2], arch=HYMBA),
    "serve-hymba3-22": dict(shape=[2, 2], arch=HYMBA, overrides=HYMBA_3),
}
XENT = {"xent-22": [2, 2], "xent-14": [1, 4]}

_JAX_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax
    from repro.configs import get_reduced, with_peft
    from repro.data.synthetic import make_synthetic_tokenlm
    from repro.fl import pod
    from repro.fl.engine import run_rounds
    from repro.fl.task import lm_task
    from repro.launch.mesh import _make_mesh
    cfg = json.load(open(sys.argv[1]))
    out = {}
    for name, case in cfg["cases"].items():
        mesh = _make_mesh(tuple(case["shape"]), ("data", "model"))
        peft = case.get("peft")
        mcfg = with_peft(get_reduced(case.get("arch", cfg["arch"])), peft)
        data = make_synthetic_tokenlm(n_clients=cfg["n_clients"],
            seq_len=cfg["seq"], n_seq_per_client=cfg["n_seq"],
            vocab=mcfg.vocab_size, seed=cfg["seed"])
        task = lm_task(mcfg)
        spec = pod.PodFLSpec(update_impl="fused_interpret",
            algorithm=case.get("algorithm", "fedavg"), peft=peft,
            **dict(cfg["spec"], **case.get("spec", {})))
        common = dict(rounds=1, clients_per_round=cfg["K"], spec=spec,
                      layout=case["layout"], sampling="host", chunk_size=1)
        params = task.init(jax.random.PRNGKey(cfg["seed"]))
        losses = []
        for phase in (("P1", "P2") if case["kind"] == "p1p2" else ("P2",)):
            c = (pod.PodCyclicConfig(mesh=mesh, **dict(common,
                     spec=dataclasses.replace(spec, peft=None)))
                 if phase == "P1" else pod.PodFLConfig(mesh=mesh, **common))
            res = run_rounds(task, data, c.strategy(), c.schedule(),
                             init_params=params)
            params = res.params
            losses += [h["local_loss"] for h in res.history]
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"{name}/p{i}"] = np.asarray(leaf, np.float32)
        out[f"{name}/loss"] = np.array(losses)
    np.savez(cfg["out"], **out)
""")

_LOWER = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.launch.mesh import destroy, make_fake_mesh
    from repro_torch.launch.train import PodFLSpec, lower_pod_round
    cfg = json.load(open(sys.argv[1]))
    out = {}
    for name, case in cfg["cases"].items():
        mesh = make_fake_mesh(case["shape"], ("data", "model"))
        peft = case.get("peft")
        spec = PodFLSpec(update_impl="fused", peft=peft,
                         algorithm=case.get("algorithm", "fedavg"),
                         **dict(cfg["spec"], **case.get("spec", {})))
        mcfg = with_peft(get_reduced(case.get("arch", cfg["arch"])), peft)
        counts, nbytes = {}, {}
        for kind in (("cyclic", "fl") if case["kind"] == "p1p2"
                     else ("fl",)):
            c = lower_pod_round(mcfg, mesh, kind=kind, spec=spec, K=cfg["K"],
                                batch=cfg["spec"]["batch_size"],
                                seq=cfg["seq"], layout=case["layout"],
                                seed=cfg["seed"])
            for k, v in c.collectives.items():
                counts[k] = counts.get(k, 0) + v
            for k, v in c.collective_bytes.items():
                nbytes[k] = nbytes.get(k, 0) + v
        out[name] = {"collectives": counts, "bytes": nbytes}
    destroy()
    json.dump(out, open(cfg["out"], "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank port runs (every case, the replicated twins, the
    step, serve and cross-entropy checks), the four-device JAX runs and
    ``lower_pod_round`` of every training case, side by side."""
    tmp = tmp_path_factory.mktemp("pod4tpzoo")
    for arch, peft in {(c.get("arch", ARCH), c.get("peft"))
                       for c in CASES.values()}:
        tag = "lora" if peft else "full"
        np.savez(tmp / f"init_{arch}_{tag}.npz", *_jax_init(arch, peft))
    np.save(tmp / "indices.npy", jax_engine_indices(SEED, 1, K, STEPS,
                                                    BATCH, N_SEQ))
    cases = dict(CASES)
    for src, twin in TWINS.items():
        cases[twin] = dict(CASES[src], layout="replicated")
    for name, c in STEPS_CASES.items():
        cases[name] = dict(c, kind="steps")
    for name, c in SERVE.items():
        cases[name] = dict(c, kind="serve")
    for name, shape in XENT.items():
        cases[name] = dict(shape=shape, kind="xent")
    spec = dict(local_steps=STEPS, batch_size=BATCH, lr=LR)
    base = dict(arch=ARCH, seed=SEED, n_clients=N_CLIENTS, seq=SEQ,
                n_seq=N_SEQ, K=K, spec=spec, dir=str(tmp))
    (tmp / "cfg.json").write_text(json.dumps(dict(base, cases=cases)))
    (tmp / "jcfg.json").write_text(json.dumps(dict(
        base, cases=CASES, out=str(tmp / "jax.npz"))))
    (tmp / "lcfg.json").write_text(json.dumps(dict(
        base, cases={n: c for n, c in cases.items()
                     if c["kind"] in ("p1p2", "rounds")},
        out=str(tmp / "lowered.json"))))
    src = str(ROOT / "src")
    jproc = _spawn([sys.executable, "-c", _JAX_REFERENCE,
                    str(tmp / "jcfg.json")],
                   {"JAX_PLATFORMS": "cpu", "PYTHONPATH": src,
                    "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    store = f"file://{tmp / 'store'}"
    workers = [_spawn([sys.executable,
                       str(ROOT / "tests" / "torch_pod_sharded_worker.py"),
                       str(tmp / "cfg.json"), str(rank), "4", store],
                      {"PYTHONPATH": src, "OMP_NUM_THREADS": "1"})
               for rank in range(4)]
    _wait(workers, "torch_pod_sharded_worker.py")
    lower = _spawn([sys.executable, "-c", _LOWER, str(tmp / "lcfg.json")],
                   {"PYTHONPATH": src, "OMP_NUM_THREADS": "1"})
    _wait([jproc], "the JAX reference")
    _wait([lower], "lower_pod_round")
    return tmp


def _ranks(tmp, kind, case):
    return [json.loads((tmp / f"{kind}_{case}_{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("case", list(CASES))
def test_four_ranks_tp_zoo_match_jax(runs, case):
    """The port's losses and params are the JAX pod's within the sharded
    tests' tolerances, and every rank computed tensor-parallel in every phase
    (FedProx included) with "tp" collectives."""
    got = np.load(runs / f"torch_{case}.npz")
    want = {k[len(case) + 1:]: v for k, v in np.load(runs / "jax.npz").items()
            if k.startswith(f"{case}/")}
    n = len([k for k in want if k.startswith("p")])
    assert n == len([k for k in got if k.startswith("p")])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for i in range(n):
        np.testing.assert_allclose(got[f"p{i}"], want[f"p{i}"], atol=ATOL,
                                   rtol=0, err_msg=f"p{i}")
    phases = 2 if CASES[case]["kind"] == "p1p2" else 1
    for cnt in _ranks(runs, "counts", case):
        assert cnt["tp_compute_phases"] == [True] * phases
        assert cnt["collectives"]["tp"] > 0


@pytest.mark.parametrize("case", list(TWINS))
def test_fsdp_tp_zoo_matches_replicated(runs, case):
    """On (2, 2) the tensor-parallel step gives the replicated layout's
    params and losses within the JAX comparison's tolerances; only
    ``fsdp_tp`` computes over ``model``."""
    a = np.load(runs / f"torch_{case}.npz")
    b = np.load(runs / f"torch_{TWINS[case]}.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for k in a.files:
        if k not in ("loss", "acc"):
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0,
                                       err_msg=k)
    for s, r in zip(_ranks(runs, "counts", case),
                    _ranks(runs, "counts", TWINS[case])):
        assert s["tp_compute"] and not r["tp_compute"]
        assert s["collectives"]["tp"] > 0 == r["collectives"]["tp"]


@pytest.mark.parametrize("case", list(CASES) + list(TWINS.values()))
def test_lower_pod_round_counts_the_tp_zoo_collectives(runs, case):
    """The captured rounds (P1 and P2 summed for the relay-then-rounds
    cases) issue every collective of the real four-rank run, kind by
    kind, count and bytes."""
    low = json.loads((runs / "lowered.json").read_text())[case]
    for cnt in _ranks(runs, "counts", case):
        assert cnt["collectives"] == low["collectives"]
        assert cnt["bytes"] == low["bytes"]


@pytest.mark.parametrize("case", list(STEPS_CASES))
def test_model_local_train_step_matches_the_whole_tree(runs, case):
    """``make_train_step`` on each rank's model-local tree (the VLM's and
    the audio arch's vocabulary, heads and MLP split; the SSM's heads;
    the hybrid's branches) gives the whole tree's losses, first gradient
    and params after two steps, its ``"tp"`` collectives counted and the
    tree still model-local; with ``control`` the planted norm fault moves
    the first gradient beyond a hundred times the tolerance."""
    c = STEPS_CASES[case]
    for r in _ranks(runs, "steps", case):
        assert r["still_local"] and r["tp"] > 0
        assert r["tp_ssm"] == (c["arch"] in (ARCH, HYMBA))
        assert r["tp_heads"] == (c["arch"] != ARCH and
                                 "overrides" not in c)
        for got, want in [r["first_loss"]] + r["losses"]:
            assert abs(got - want) <= 1e-5 * abs(want)
        assert r["grad"] <= STEP_RTOL and r["params"] <= STEP_RTOL
        if c.get("control"):
            assert r["control_grad"] > 100 * STEP_RTOL


@pytest.mark.parametrize("case", list(SERVE))
def test_ssm_prefill_and_decode_on_four_ranks(runs, case):
    """The reduced SSM and hybrid archs under ``fsdp_tp``: prefill and two
    greedy decode steps on each rank's model-local tree (its SSM heads, a
    share of the vocabulary, the logits gathered whole) equal the whole
    tree's within the params' tolerance with the same greedy tokens, and
    the rank's SSM state and conv history are its heads and channels of
    the whole model's."""
    c = SERVE[case]
    for r in _ranks(runs, "serve", case):
        assert r["tp_ssm"] and r["tp_vocab"]
        assert r["logits_shape"][-1] == 512 and len(r["logits"]) == 3
        assert all(r["greedy_equal"])
        assert max(r["logits"]) <= ATOL and r["cache"] <= ATOL
        heads = 16 // c["shape"][1]
        assert r["ssm_shapes"][0][2] == heads
        assert r["ssm_shapes"][1][-1] == heads * 32 + 2 * (
            32 if c["arch"] == ARCH else 16)
        assert max(r["ssm_state"]) <= ATOL


@pytest.mark.parametrize("case", list(XENT))
def test_codebook_cross_entropy_over_model(runs, case):
    """The vocabulary-parallel cross-entropy over the flattened
    ``(codebook, vocab)`` columns (1, 2 and 4 codebooks: a rank within
    one codebook, or holding whole ones) equals ``_xent`` over the whole
    within f32 rounding, forward and gradient; with one codebook its nll
    is bitwise the form before codebooks."""
    for r in _ranks(runs, "xent", case):
        assert r["bitwise_one_codebook"]
        for ncb in ("1", "2", "4"):
            x = r[ncb]
            assert x["tp"] == 3
            assert x["loss"] <= 1e-6 * x["loss_value"]
            assert x["grad"] <= 1e-6 * x["grad_max"]


def test_ssd_chunked_gradient_is_finite_where_the_decay_overflows():
    """A 128-token chunk whose decays span more than f32's exp can hold
    (the full-width archs' chunk at large dt·|A|): ``ssd_chunked``'s
    forward and its gradient in x are the JAX package's, and its
    gradient in dt is finite, the JAX package's wherever that one is
    (the heads whose decays stay in range); the JAX formula (the mask
    applied after the exp) gives NaN through the masked entries' 0·inf
    in the others."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import ssm as jssm
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(SEED)
    b, s, h, p, n, chunk = 2, 128, 4, 8, 16, 128
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 2.0 + 1.0).astype(np.float32)
    A = -np.array([0.1, 1.0, 4.0, 16.0], np.float32)
    B, C = (rng.standard_normal((b, s, 1, n)).astype(np.float32)
            for _ in range(2))
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    for a in args[:2]:
        a.requires_grad_()
    y = ssd_chunked(*args, chunk)
    gx, gdt = torch.autograd.grad(y.sum(), args[:2])

    def jax_sum(x, dt):
        return jnp.sum(jssm.ssd_chunked(x, dt, jnp.asarray(A),
                                        jnp.asarray(B), jnp.asarray(C),
                                        chunk))
    jy = np.asarray(jssm.ssd_chunked(x, dt, A, B, C, chunk))
    jgx, jgdt = (np.asarray(g) for g in
                 jax.grad(jax_sum, argnums=(0, 1))(x, dt))
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), jgx, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(gdt).all()
    ok = np.isfinite(jgdt).all(axis=(0, 1))         # per head
    assert ok[0] and not ok.all()
    np.testing.assert_allclose(gdt.numpy()[..., ok], jgdt[..., ok],
                               rtol=1e-3, atol=1e-3)
