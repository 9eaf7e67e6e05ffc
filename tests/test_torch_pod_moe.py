"""The MoE zoo on the sharded pod (``repro_torch.fl.pod``) against the
JAX package's pod, on the CPU: expert parallelism and MLA's heads over
``model``, and each MoE layer's capacity global over the batch group.

Four ranks: ``tests/torch_pod_sharded_worker.py`` runs in four
processes over a ``file://`` gloo store; at the same time the JAX pod
runs in a subprocess on 4 fake CPU devices (meshes from
``repro.launch.mesh._make_mesh``), where the client batch is one global
array whose B XLA shards over (pod, data): the capacity, the slots and
the drops of every MoE layer are the whole batch's.  The models are the
reduced deepseek-v2-lite-16b (softmax router, MLA without q-LoRA, a
dense-FFN prefix layer) and deepseek-v3-671b (sigmoid router, q-LoRA,
the MTP block), both with 4 experts of top-2 at a ``capacity_factor``
that binds (set with ``dataclasses.replace`` on both sides), on
``make_synthetic_tokenlm`` (4 clients × 8 sequences of 16 tokens), 1
round of 2 clients × 2 SGD steps of batch 4, from the JAX package's
init on its threefry batch indices.  Cases:

  * (2, 2) ``fsdp_tp``: P2 FedAvgM + ``lora:4`` through
    ``run_pod_training``, and the P1 relay of the whole model — two
    experts and two heads a rank, the batch split over ``data``;
  * (4, 1) ``fsdp_only``: P2 rounds of the whole model, gather-then-
    compute, the batch split four ways;
  * (1, 4) ``fsdp_tp``, deepseek-v3-671b: one expert and one head a
    rank, the batch whole.

Two more cases run the other places where the pod computes an MoE on a
split batch: P2 rounds on the tree update path (whole leaves on every
rank, the batch split four ways on (4, 1)) and the eval stream after
each round on (2, 2) ``fsdp_tp``, whose accuracy is the JAX pod's.

Every case drops pairs.  Tolerances, as in
``tests/test_torch_pod_sharded.py``: losses rtol 1e-5, params atol 2e-5.
In the same workers the two (2, 2) cases run under ``replicated`` too
(the batch split, nothing over ``model``): ``fsdp_tp`` matches it within
those tolerances.  ``lower_pod_round`` counts every collective of the
runs, the ``"moe"`` kind included.  On (1, 4) the MLA archs' prefill and
two greedy decode steps on each rank's model-local tree equal the whole
model's, and each rank keeps the whole latent cache.

One process: on the one-rank mesh an MoE step carries no context (the
local ``moe`` path), and a run started from ``engine.FlatRows`` ends with
the rows of a run started from the tree.
"""
import json
import sys
import textwrap

import numpy as np
import pytest
from torch_parity import jax_engine_indices

from test_torch_pod_sharded import ROOT, _jax_init, _spawn, _wait

SEED, ARCH, V3 = 0, "deepseek-v2-lite-16b", "deepseek-v3-671b"
N_CLIENTS, N_SEQ, SEQ = 4, 8, 16
STEPS, BATCH, K, LR = 2, 4, 2, 0.05
ATOL = 2e-5
# C = ceil(2·64/4 · 0.75) = 24 slots an expert for the 128 pairs of a
# step's 64 tokens: some expert overflows in every layer
CF = 0.75

CASES = {
    "tp-lora-fedavgm": dict(shape=[2, 2], layout="fsdp_tp", kind="train",
                            peft="lora:4", server_opt="momentum"),
    "tp-relay": dict(shape=[2, 2], layout="fsdp_tp", kind="relay"),
    "only-rounds": dict(shape=[4, 1], layout="fsdp_only", kind="rounds"),
    "tp14-v3": dict(shape=[1, 4], layout="fsdp_tp", kind="rounds", arch=V3),
}
# the other paths that run the model on a split batch: the tree update
# path's steps and the eval's forward
PATHS = {
    "tree-rounds": dict(shape=[4, 1], layout="fsdp_only", kind="rounds",
                        update_impl="tree"),
    "eval-rounds": dict(shape=[2, 2], layout="fsdp_tp", kind="rounds",
                        kw={"eval_every": 1}),
}
for _c in (*CASES.values(), *PATHS.values()):
    _c["capacity_factor"] = CF
# the port only: the replicated twins the fsdp_tp cases are held to
TWINS = {"tp-lora-fedavgm": "rep-lora-fedavgm", "tp-relay": "rep-relay"}
SERVE = {"serve-v2": ARCH, "serve-v3": V3}

_JAX_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax
    from repro.configs import get_reduced, with_peft
    from repro.data.synthetic import make_synthetic_tokenlm
    from repro.fl import pod
    from repro.fl.engine import run_rounds
    from repro.fl.task import lm_task
    from repro.launch import train
    from repro.launch.mesh import _make_mesh
    cfg = json.load(open(sys.argv[1]))
    out = {}
    for name, case in cfg["cases"].items():
        mesh = _make_mesh(tuple(case["shape"]), ("data", "model"))
        peft = case.get("peft")
        mcfg = dataclasses.replace(
            with_peft(get_reduced(case.get("arch", cfg["arch"])), peft),
            capacity_factor=case["capacity_factor"])
        data = make_synthetic_tokenlm(n_clients=cfg["n_clients"],
            seq_len=cfg["seq"], n_seq_per_client=cfg["n_seq"],
            vocab=mcfg.vocab_size, seed=cfg["seed"])
        task = lm_task(mcfg)
        spec = pod.PodFLSpec(
            update_impl=case.get("update_impl", "fused_interpret"),
            server_opt=case.get("server_opt", "none"), peft=peft,
            **cfg["spec"])
        common = dict(rounds=1, clients_per_round=cfg["K"], spec=spec,
                      layout=case["layout"], sampling="host", chunk_size=1)
        if case["kind"] == "train":
            res = train.run_pod_training(mcfg, data, cyclic_rounds=0,
                fl_rounds=1, clients_per_round=cfg["K"], spec=spec,
                mesh=mesh, seed=cfg["seed"], sampling="host",
                layout=case["layout"], chunk_size=1)
            losses = [h["loss"] for h in res.history]
        else:
            c = (pod.PodCyclicConfig(mesh=mesh, **common)
                 if case["kind"] == "relay" else
                 pod.PodFLConfig(mesh=mesh, **common, **case.get("kw", {})))
            res = run_rounds(task, data, c.strategy(), c.schedule(),
                init_params=task.init(jax.random.PRNGKey(cfg["seed"])))
            losses = [h["local_loss"] for h in res.history]
        for i, leaf in enumerate(jax.tree_util.tree_leaves(res.params)):
            out[f"{name}/p{i}"] = np.asarray(leaf, np.float32)
        out[f"{name}/loss"] = np.array(losses)
        out[f"{name}/acc"] = np.array([h["acc"] for h in res.history
                                       if "acc" in h])
    np.savez(cfg["out"], **out)
""")

_LOWER = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.launch.mesh import destroy, make_fake_mesh
    from repro_torch.launch.train import PodFLSpec, lower_pod_round
    cfg = json.load(open(sys.argv[1]))
    out = {}
    for name, case in cfg["cases"].items():
        if case["kind"] not in ("train", "relay", "rounds"):
            continue
        mesh = make_fake_mesh(case["shape"], ("data", "model"))
        peft = case.get("peft")
        spec = PodFLSpec(update_impl="fused", peft=peft,
                         server_opt=case.get("server_opt", "none"),
                         **cfg["spec"])
        mcfg = dataclasses.replace(
            with_peft(get_reduced(case.get("arch", cfg["arch"])), peft),
            capacity_factor=case["capacity_factor"])
        c = lower_pod_round(
            mcfg, mesh, kind="cyclic" if case["kind"] == "relay" else "fl",
            spec=spec, K=cfg["K"], batch=cfg["spec"]["batch_size"],
            seq=cfg["seq"], layout=case["layout"], seed=cfg["seed"])
        out[name] = {"collectives": c.collectives,
                     "bytes": c.collective_bytes}
    destroy()
    json.dump(out, open(cfg["out"], "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank port runs (every case, the replicated twins and the
    serve checks), the four-device JAX runs and ``lower_pod_round`` of
    every training case, side by side."""
    tmp = tmp_path_factory.mktemp("pod4moe")
    for arch, peft in {(c.get("arch", ARCH), c.get("peft"))
                       for c in CASES.values()}:
        tag = "lora" if peft else "full"
        np.savez(tmp / f"init_{arch}_{tag}.npz", *_jax_init(arch, peft))
    np.save(tmp / "indices.npy", jax_engine_indices(SEED, 1, K, STEPS,
                                                    BATCH, N_SEQ))
    cases = dict(CASES)
    for src, twin in TWINS.items():
        cases[twin] = dict(CASES[src], layout="replicated")
    for name, arch in SERVE.items():
        cases[name] = dict(shape=[1, 4], kind="serve", arch=arch)
    lowered = dict(cases)
    cases.update(PATHS)
    spec = dict(local_steps=STEPS, batch_size=BATCH, lr=LR)
    base = dict(arch=ARCH, seed=SEED, n_clients=N_CLIENTS, seq=SEQ,
                n_seq=N_SEQ, K=K, spec=spec, dir=str(tmp))
    (tmp / "cfg.json").write_text(json.dumps(dict(base, cases=cases)))
    (tmp / "jcfg.json").write_text(json.dumps(dict(
        base, cases=dict(CASES, **PATHS), out=str(tmp / "jax.npz"))))
    (tmp / "lcfg.json").write_text(json.dumps(dict(
        base, cases=lowered, out=str(tmp / "lowered.json"))))
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


def _counts(tmp, case):
    return [json.loads((tmp / f"counts_{case}_{r}.json").read_text())
            for r in range(4)]


def _matches_jax(tmp, case, c):
    """The port's losses, eval accuracies and params are the JAX pod's;
    pairs were dropped; ``fsdp_tp`` computed with the experts and the
    heads split ("tp" collectives) and the other layouts did not; the MoE
    layers dispatched over the batch group ("moe" collectives) exactly
    when the batch is split (|data| > 1)."""
    got = np.load(tmp / f"torch_{case}.npz")
    want = {k[len(case) + 1:]: v for k, v in np.load(tmp / "jax.npz").items()
            if k.startswith(f"{case}/")}
    n = len([k for k in want if k.startswith("p")])
    assert n == len([k for k in got if k.startswith("p")])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["acc"], want["acc"])
    for i in range(n):
        np.testing.assert_allclose(got[f"p{i}"], want[f"p{i}"], atol=ATOL,
                                   rtol=0, err_msg=f"p{i}")
    counts = _counts(tmp, case)
    tp_on = c["layout"] == "fsdp_tp" and c.get("update_impl") != "tree"
    for cnt in counts:
        assert cnt["tp_compute"] == tp_on
        assert (cnt["collectives"]["tp"] > 0) == cnt["tp_compute"]
        assert (cnt["collectives"]["moe"] > 0) == (c["shape"][0] > 1)
        assert cnt["dropped"] < cnt["routed"]
    # each rank counts the drops of its own rows of the batch
    assert sum(cnt["dropped"] for cnt in counts) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_four_ranks_moe_match_jax(runs, case):
    """The step's paths on the three meshes (``_matches_jax``)."""
    _matches_jax(runs, case, CASES[case])


@pytest.mark.parametrize("case", list(PATHS))
def test_tree_path_and_eval_moe_match_jax(runs, case):
    """The tree update path's steps and the eval's forward take each MoE
    layer's capacity over the whole batch too: the params, losses and
    accuracies are the JAX pod's (``_matches_jax``); the eval case
    evaluated after its round."""
    _matches_jax(runs, case, PATHS[case])
    acc = np.load(runs / f"torch_{case}.npz")["acc"]
    assert len(acc) == (1 if "kw" in PATHS[case] else 0)


@pytest.mark.parametrize("case", list(TWINS))
def test_fsdp_tp_moe_matches_replicated(runs, case):
    """On (2, 2) the expert- and head-parallel step gives the replicated
    layout's params and losses within the JAX comparison's tolerances;
    both dispatch over ``data`` ("moe"), only ``fsdp_tp`` over ``model``
    ("tp"), and both drop the same pairs."""
    tmp = runs
    a = np.load(tmp / f"torch_{case}.npz")
    b = np.load(tmp / f"torch_{TWINS[case]}.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for k in a.files:
        if k != "loss":
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0,
                                       err_msg=k)
    for s, r in zip(_counts(tmp, case), _counts(tmp, TWINS[case])):
        assert s["tp_compute"] and not r["tp_compute"]
        assert s["collectives"]["tp"] > 0 == r["collectives"]["tp"]
        assert s["collectives"]["moe"] > 0 and r["collectives"]["moe"] > 0
        assert s["dropped"] == r["dropped"] > 0
        assert s["capacity"] == r["capacity"]


@pytest.mark.parametrize("case", list(CASES) + list(TWINS.values()))
def test_lower_pod_round_counts_the_moe_runs_collectives(runs, case):
    """The captured round issues every collective of the real four-rank
    run, kind by kind, count and bytes — the "moe" kind too."""
    low = json.loads((runs / "lowered.json").read_text())[case]
    for cnt in _counts(runs, case):
        assert cnt["collectives"] == low["collectives"]
        assert cnt["bytes"] == low["bytes"]


@pytest.mark.parametrize("case", list(SERVE))
def test_mla_prefill_and_decode_on_four_ranks(runs, case):
    """The reduced MLA arch on (1, 4) under ``fsdp_tp``: prefill and two
    greedy decode steps on each rank's model-local tree (one head and
    one expert a rank, a quarter of the vocabulary, the logits gathered
    whole) equal the whole tree's within the params' tolerance, and the
    rank's latent cache is the whole model's."""
    for r in range(4):
        serve = json.loads((runs / f"serve_{case}_{r}.json").read_text())
        assert serve["tp_heads"] and serve["tp_experts"]
        assert serve["kv_heads"] == 1 and serve["logits_shape"][-1] == 512
        assert len(serve["logits"]) == 3
        assert max(serve["logits"]) <= ATOL and serve["cache"] <= ATOL


def test_one_rank_keeps_the_local_moe_path_and_rows_round_trip():
    """On the one-rank mesh an MoE step carries no context (the
    pre-existing ``moe`` path, bit for bit), and a run started from
    :class:`FlatRows` (the rows a rank packs from the tree) ends with the
    same rows as a run started from the tree, the frozen rows the very
    storage it was given, unchanged."""
    import torch
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    from repro_torch.fl import pod
    from repro_torch.fl.engine import FlatRows, run_rounds
    from repro_torch.fl.task import lm_task
    from repro_torch.launch.mesh import destroy, make_host_mesh
    mcfg = with_peft(get_reduced(ARCH), "lora:4")
    task = lm_task(mcfg)
    data = make_synthetic_tokenlm(n_clients=N_CLIENTS, seq_len=SEQ,
                                  n_seq_per_client=N_SEQ,
                                  vocab=mcfg.vocab_size, seed=SEED)
    init = task.init(torch.Generator().manual_seed(SEED))
    mesh = make_host_mesh("cpu")
    try:
        c = pod.PodFLConfig(mesh, rounds=1, clients_per_round=K,
                            spec=pod.PodFLSpec(
                                local_steps=STEPS, batch_size=BATCH, lr=LR,
                                update_impl="fused", peft="lora:4",
                                trainable_filter=r"/(lora_a|lora_b)$|"
                                                 r"/router/w$"),
                            sampling="host", seed=SEED)
        strategy = c.strategy()
        fops = strategy.flat_ops(task, mesh.device)
        assert fops.tp is None
        rows = FlatRows(fops.flatten(init), fops.flatten_frozen(init))
        a = run_rounds(task, data, strategy, c.schedule(), init_params=init,
                       device="cpu")
        b = run_rounds(task, data, strategy, c.schedule(),
                       init_params=rows, device="cpu")
    finally:
        destroy()
    assert isinstance(b.params, FlatRows)
    want = fops.flatten(a.params)
    assert sorted(want) == sorted(b.params.params)
    for name, t in want.items():
        assert torch.equal(b.params.params[name], t), name
        assert not torch.equal(rows.params[name], t), name
    assert all(b.params.frozen[n].data_ptr() == t.data_ptr() and
               torch.equal(b.params.frozen[n], t)
               for n, t in rows.frozen.items())
    assert [h["local_loss"] for h in a.history] == \
        [h["local_loss"] for h in b.history]
