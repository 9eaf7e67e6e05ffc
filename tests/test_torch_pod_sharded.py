"""Sharded FSDP/TP groups on the pod (``repro_torch.fl.pod``) against the
JAX package's pod, on the CPU.

Four ranks: ``tests/torch_pod_sharded_worker.py`` runs in four
processes over a ``file://`` gloo store; at the same time the JAX pod
runs in a subprocess on 4 fake CPU devices, its meshes built with
``repro.launch.mesh._make_mesh``.  The model is the reduced
qwen1.5-0.5b on ``make_synthetic_tokenlm`` (4 clients × 8 sequences of
16 tokens), 1 round of 2 clients × 2 SGD steps of batch 4, started from
the JAX package's init on its threefry batch indices (injected) under
``sampling="host"``; the port runs the kernels' plain versions.  Cases:

  * (2, 2) ``fsdp_tp``, ``lora:4``, P2 FedAvgM through
    ``run_pod_training``: trainable buckets sharded over ``data`` and
    over ``model``, the frozen base over both;
  * (2, 2) ``fsdp_tp``, the P1 relay of the whole model;
  * (2, 2) ``fsdp_tp``, int8 + top-k 25% + error feedback: top-k keeps k
    of each shard, and each rank's error-feedback rows (every client's
    row of its own shards) match the JAX pod's;
  * (4, 1) ``fsdp_only``, SCAFFOLD, hierarchical (2 pods): ``c`` compared
    row for row;
  * (2, 2) ``fsdp_tp``, ``lora:4`` with a DP clip that binds (no noise):
    the clip norm sums over each bucket's axes;
  * (2, 2) ``fsdp_tp``, the whole model with a gradient clip that binds:
    each step's global norm sums every bucket's Σg² over its own axes
    (``model``, ``data+model``; never over the ``data`` replicas of the
    ``model`` bucket), one all-reduce per axis set a step, and equals the
    replicated layout's norm;
  * the compressed case again with the sparse client store
    (``store="sparse"``), port only: its error-feedback rows, kept whole
    on each rank, match the JAX pod's dense rows (the stores are exact)
    and the port's dense run bit for bit;
  * (1, 4) ``fsdp_tp``, the reduced tinyllama-1.1b: pure tensor
    parallelism, its 2 kv heads replicated on the 4 ``model`` ranks.

Under ``fsdp_tp`` on these meshes the steps compute tensor-parallel over
``model`` (``sharding.tensor_parallel``: heads, MLP and vocabulary split,
``"tp"`` all-reduces), as XLA's partitioner splits the JAX pod's step.

Tolerances, as in ``tests/test_torch_pod.py``: losses rtol 1e-5, params
atol 2e-5 (the matmuls sum in another order), scaffold's ``c`` at the
params' tolerance over S·lr; compressed uploads within 1e-4, except at
most 0.1% of the elements, each by no more than twice the largest
residual.  In the same workers, on (2, 2), the FedAvgM and the relay
cases run under ``fsdp_only`` (gather-then-compute) and ``replicated``
too: ``fsdp_only`` equals ``replicated`` bitwise (uncompressed, no clip:
a sum over two ``data`` ranks has one order and K1 is elementwise) and
``fsdp_tp`` equals it within the tolerances above (the row-parallel
reduce sums in another order); each sharded rank holds a quarter of the
frozen base.  The vocabulary-parallel embedding and cross-entropy on
four ranks against the whole-vocabulary functions.

One process: the per-shard layout (``ShardedFlatView.local_view``,
``flatten_local``, ``normal_local``, the whole-leaf round trip) against
the packed buffers, the row gradient (summed once over ``data``, never
over ``model``, also for a leaf gathered over ``model`` in a
tensor-parallel step) against a replicated leaf's gradient, the client store
under a bucket sharded over ``data``, and ``ops.fused_dp_clip_noise``
against the JAX entry.
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import jax_engine_indices

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.checkpoint.store import load_metadata, load_pytree
from repro_torch.configs import get_reduced, with_peft
from repro_torch.fl import pod
from repro_torch.fl.task import lm_task
from repro_torch.kernels import ops
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm
from repro_torch.utils.flatten import FlatView, take_runs

ROOT = Path(__file__).resolve().parent.parent
SEED, ARCH = 0, "qwen1.5-0.5b"
N_CLIENTS, N_SEQ, SEQ = 4, 8, 16
STEPS, BATCH, K, LR = 2, 4, 2, 0.05
ATOL = 2e-5

CASES = {
    "tp-lora-fedavgm": dict(shape=[2, 2], layout="fsdp_tp", kind="train",
                            peft="lora:4", server_opt="momentum"),
    "tp-relay": dict(shape=[2, 2], layout="fsdp_tp", kind="relay"),
    "tp-compressed-ef": dict(shape=[2, 2], layout="fsdp_tp", kind="rounds",
                             compressed=True),
    "only-scaffold-lanes": dict(shape=[4, 1], layout="fsdp_only",
                                kind="rounds", algorithm="scaffold",
                                kw={"aggregation": "hierarchical",
                                    "n_pods": 2}),
    "tp-lora-dp": dict(shape=[2, 2], layout="fsdp_tp", kind="rounds",
                       peft="lora:4", dp=1e-4),
    "tp-clip": dict(shape=[2, 2], layout="fsdp_tp", kind="rounds",
                    grad_clip=1.0),
    "tp14-tinyllama": dict(shape=[1, 4], layout="fsdp_tp", kind="rounds",
                           arch="tinyllama-1.1b"),
}
# the port only: the same runs under the replicated layout (fsdp_tp within
# tolerance) and under fsdp_only (bitwise)
BITWISE = {"tp-lora-fedavgm": "rep-lora-fedavgm", "tp-relay": "rep-relay"}
FSDP_ONLY = {"tp-lora-fedavgm": "only-lora-fedavgm",
             "tp-relay": "only-relay"}
# the port only: the replicated twin whose step norms the clip case meets
NORM_TWIN = {"tp-clip": "rep-clip"}
# the port only: a case under the sparse client store, held against the
# JAX run of the dense case it names
SPARSE = {"tp-compressed-ef-sparse": "tp-compressed-ef"}

_JAX_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from repro.configs import get_reduced, with_peft
    from repro.data.synthetic import make_synthetic_tokenlm
    from repro.fl import compression, pod, privacy
    from repro.fl.engine import run_rounds
    from repro.fl.task import lm_task
    from repro.launch import train
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
            algorithm=case.get("algorithm", "fedavg"),
            server_opt=case.get("server_opt", "none"), peft=peft,
            dp=privacy.DPSpec(case["dp"]) if case.get("dp") else None,
            compression=(compression.CompressionSpec(8, 0.25, True)
                         if case.get("compressed") else None),
            grad_clip=case.get("grad_clip"), **cfg["spec"])
        common = dict(rounds=1, clients_per_round=cfg["K"], spec=spec,
                      layout=case["layout"], sampling="host", chunk_size=1)
        state = {}
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
            state = res.algo_state
        for i, leaf in enumerate(jax.tree_util.tree_leaves(res.params)):
            out[f"{name}/p{i}"] = np.asarray(leaf, np.float32)
        out[f"{name}/loss"] = np.array(losses)
        for b, t in state.get("c_global", {}).items():
            out[f"{name}/c/{b}"] = np.asarray(t, np.float32)
        for b, t in state.get("ef_residuals", {}).items():
            out[f"{name}/ef/{b}"] = np.asarray(t, np.float32)
    np.savez(cfg["out"], **out)
""")


def _jax_init(arch, peft):
    from repro.configs import get_reduced as jget_reduced
    from repro.configs import with_peft as jwith_peft
    from repro.fl.task import lm_task as j_lm_task
    jtask = j_lm_task(jwith_peft(jget_reduced(arch), peft))
    return [np.asarray(x, np.float32) for x in
            jax.tree_util.tree_leaves(jtask.init(jax.random.PRNGKey(SEED)))]


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=dict(os.environ, **env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(procs, what, timeout=300):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"{what} failed:\n{out}\n{err[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank port runs (every case, and the replicated twins) and
    the four-device JAX runs, side by side."""
    tmp = tmp_path_factory.mktemp("pod4sharded")
    for arch, peft in {(c.get("arch", ARCH), c.get("peft"))
                       for c in CASES.values()}:
        tag = "lora" if peft else "full"
        np.savez(tmp / f"init_{arch}_{tag}.npz", *_jax_init(arch, peft))
    np.save(tmp / "indices.npy", jax_engine_indices(SEED, 1, K, STEPS,
                                                    BATCH, N_SEQ))
    cases = dict(CASES)
    for src, twin in BITWISE.items():
        cases[twin] = dict(CASES[src], layout="replicated", checkpoint=True)
        cases[FSDP_ONLY[src]] = dict(CASES[src], layout="fsdp_only",
                                     checkpoint=True)
    for src, twin in NORM_TWIN.items():
        cases[twin] = dict(CASES[src], layout="replicated")
    for case, ref in SPARSE.items():
        cases[case] = dict(CASES[ref], kw={"store": "sparse",
                                           "store_capacity": N_CLIENTS})
    cases["vocab"] = dict(shape=[1, 4], kind="vocab")
    spec = dict(local_steps=STEPS, batch_size=BATCH, lr=LR)
    base = dict(arch=ARCH, seed=SEED, n_clients=N_CLIENTS, seq=SEQ,
                n_seq=N_SEQ, K=K, spec=spec, dir=str(tmp))
    (tmp / "cfg.json").write_text(json.dumps(dict(base, cases=cases)))
    (tmp / "jcfg.json").write_text(json.dumps(dict(
        base, cases=CASES, out=str(tmp / "jax.npz"))))
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
    _wait([jproc], "the JAX reference")
    return tmp


def _view(case, rank, layout=None):
    """The port's ShardedFlatView of a case's model (under its layout, or
    ``layout``) and the coordinates of ``rank`` on its mesh."""
    shape = CASES[case]["shape"]
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros(shape),
                                 shape=dict(zip(("data", "model"), shape)))
    task = lm_task(with_peft(get_reduced(CASES[case].get("arch", ARCH)),
                             CASES[case].get("peft")))
    view = rules.sharded_flat_view(task.shapes(), mesh,
                                   layout or CASES[case]["layout"],
                                   "lora" if CASES[case].get("peft") else None)
    return view, {"data": rank // shape[1], "model": rank % shape[1]}


def _assert_compressed_close(pairs, bound):
    for a, b in pairs:
        off = np.abs(a - b) > 1e-4
        assert off.sum() <= max(1, a.size // 1000), int(off.sum())
        assert np.all(np.abs(a - b)[off] <= bound)


def _counts(tmp, case):
    return [json.loads((tmp / f"counts_{case}_{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("case", list(CASES) + list(SPARSE))
def test_four_ranks_sharded_match_jax(runs, case):
    tmp, ref = runs, SPARSE.get(case, case)
    c = CASES[ref]
    got = np.load(tmp / f"torch_{case}.npz")
    want = {k[len(ref) + 1:]: v for k, v in np.load(tmp / "jax.npz").items()
            if k.startswith(f"{ref}/")}
    n = len([k for k in want if k.startswith("p")])
    assert n == len([k for k in got if k.startswith("p")])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    view, _ = _view(ref, 0)
    assert any(g.n_shards > 1 for g in view.groups)
    for cnt in _counts(tmp, case):  # fsdp_tp on model > 1: tensor-parallel
        assert cnt["tp_compute"] == (c["layout"] == "fsdp_tp")
        assert (cnt["collectives"]["tp"] > 0) == cnt["tp_compute"]
    if c.get("compressed"):
        pairs = [(got[f"p{i}"], want[f"p{i}"]) for i in range(n)]
        ef_max = 0.0
        for r in range(4):
            _, coords = _view(ref, r)
            rows = view.local_rows(coords)
            mine = np.load(tmp / f"rows_{case}_{r}.npz")
            for g in view.trainable_groups:
                jr = want[f"ef/{g.name}"][:, rows[g.name], :g.size]
                assert mine[f"ef/{g.name}"].shape[0] == N_CLIENTS
                pairs.append((mine[f"ef/{g.name}"][:, :g.size], jr))
                ef_max = max(ef_max, float(np.abs(jr).max()))
        assert ef_max > 0
        _assert_compressed_close(pairs, 2 * ef_max)
        if case in SPARSE:          # the port's dense run, bit for bit
            dense = np.load(tmp / f"torch_{ref}.npz")
            for k in dense.files:
                np.testing.assert_array_equal(got[k], dense[k], k)
            for r in range(4):
                a = np.load(tmp / f"rows_{case}_{r}.npz")
                b = np.load(tmp / f"rows_{ref}_{r}.npz")
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], k)
    else:
        for i in range(n):
            np.testing.assert_allclose(got[f"p{i}"], want[f"p{i}"],
                                       atol=ATOL, rtol=0)
    if c.get("dp"):
        # the clip norm: one all-reduce per client over each axis set of
        # the sharded trainable buckets; the clip binds on every client
        n_sets = len({g.axes for g in view.trainable_groups if g.axes})
        for cnt in _counts(tmp, case):
            assert cnt["collectives"]["clip"] == K * n_sets
            assert len(cnt["clip_scales"]) == K
            assert all(0 < x < 1 for x in cnt["clip_scales"])
    if c.get("grad_clip"):
        # the step's clip norm: one all-reduce per axis set of the sharded
        # trainable buckets a step, never over replicas — each step's norm
        # the replicated layout's (the clip binds on every step)
        n_sets = len({g.axes for g in view.trainable_groups if g.axes})
        assert n_sets == 2
        twin = _counts(tmp, NORM_TWIN[case])
        for cnt, rep in zip(_counts(tmp, case), twin):
            assert cnt["collectives"]["clip"] == K * STEPS * n_sets
            assert rep["collectives"]["clip"] == 0
            assert len(cnt["grad_norms"]) == K * STEPS
            assert all(x > c["grad_clip"] for x in cnt["grad_norms"])
            np.testing.assert_allclose(cnt["grad_norms"], rep["grad_norms"],
                                       rtol=1e-5)
    if c.get("algorithm") == "scaffold":
        for r in range(4):
            _, coords = _view(ref, r)
            rows = view.local_rows(coords)
            mine = np.load(tmp / f"rows_{case}_{r}.npz")
            for g in view.trainable_groups:
                np.testing.assert_allclose(
                    mine[f"c/{g.name}"][:g.size],
                    want[f"c/{g.name}"][rows[g.name], :g.size],
                    atol=ATOL / (STEPS * LR), rtol=0)


# the fsdp_tp cases lower_pod_round takes (its phase kwargs are the
# defaults: no hierarchical lanes, the dense store)
LOWERED = ("tp-lora-fedavgm", "tp-relay", "tp-compressed-ef", "tp-lora-dp",
           "tp-clip", "tp14-tinyllama")

_LOWER = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.fl import compression, privacy
    from repro_torch.launch.mesh import destroy, make_fake_mesh
    from repro_torch.launch.train import PodFLSpec, lower_pod_round
    cfg = json.load(open(sys.argv[1]))
    out = {}
    for name in cfg["lowered"]:
        case = cfg["cases"][name]
        mesh = make_fake_mesh(case["shape"], ("data", "model"))
        peft = case.get("peft")
        spec = PodFLSpec(
            update_impl="fused", algorithm=case.get("algorithm", "fedavg"),
            server_opt=case.get("server_opt", "none"), peft=peft,
            dp=privacy.DPSpec(case["dp"]) if case.get("dp") else None,
            compression=(compression.CompressionSpec(8, 0.25, True)
                         if case.get("compressed") else None),
            grad_clip=case.get("grad_clip"), **cfg["spec"])
        c = lower_pod_round(
            with_peft(get_reduced(case.get("arch", cfg["arch"])), peft), mesh,
            kind="cyclic" if case["kind"] == "relay" else "fl", spec=spec,
            K=cfg["K"], batch=cfg["spec"]["batch_size"], seq=cfg["seq"],
            layout=case["layout"], seed=cfg["seed"])
        out[name] = {"collectives": c.collectives,
                     "bytes": c.collective_bytes, "kernels": c.kernels}
    destroy()
    json.dump(out, open(cfg["out"], "w"))
""")


@pytest.fixture(scope="module")
def lowered(runs):
    """``lower_pod_round`` of each case of LOWERED, in a process of its
    own (the fake process group cannot share one with gloo)."""
    cfg = json.loads((runs / "cfg.json").read_text())
    cfg.update(lowered=LOWERED, out=str(runs / "lowered.json"))
    (runs / "lcfg.json").write_text(json.dumps(cfg))
    proc = _spawn([sys.executable, "-c", _LOWER, str(runs / "lcfg.json")],
                  {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    _wait([proc], "lower_pod_round")
    return json.loads((runs / "lowered.json").read_text())


@pytest.mark.parametrize("case", LOWERED)
def test_lower_pod_round_counts_the_runs_collectives(runs, lowered, case):
    """The captured round issues every collective of the real four-rank
    run, kind by kind, count and bytes; its kernels are the real run's
    calls."""
    low = lowered[case]
    for cnt in _counts(runs, case):
        assert cnt["collectives"] == low["collectives"]
        assert cnt["bytes"] == low["bytes"]
        for k in ("local_step", "delta_accum", "server_update"):
            assert cnt["calls"][k] == low["kernels"].get(
                k, {"calls": 0})["calls"], k
    assert low["collectives"]["gather"] > 0 and low["collectives"]["grad"] > 0


@pytest.mark.parametrize("case", BITWISE)
def test_fsdp_tp_equals_replicated_bitwise(runs, case):
    """On (2, 2) the sharded gather-then-compute step gives the
    replicated layout's params and losses bit for bit: the case's
    ``fsdp_only`` twin (``fsdp_tp`` computes tensor-parallel now, which
    sums the row-parallel outputs in another order:
    ``test_fsdp_tp_matches_replicated``).  Each sharded rank gathers every
    step, and K1, K6 and K3 run once per bucket each."""
    tmp, only = runs, FSDP_ONLY[case]
    a = np.load(tmp / f"torch_{only}.npz")
    b = np.load(tmp / f"torch_{BITWISE[case]}.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], k)
    view = _view(case, 0, "fsdp_only")[0]
    steps = K * STEPS
    for s, r in zip(_counts(tmp, only), _counts(tmp, BITWISE[case])):
        assert not s["tp_compute"] and not r["tp_compute"]
        assert s["collectives"]["tp"] == 0 == r["collectives"]["tp"]
        assert s["collectives"]["gather"] > 0 == r["collectives"]["gather"]
        assert s["calls"]["local_step"] == steps * len(view.trainable_groups)


@pytest.mark.parametrize("case", BITWISE)
def test_fsdp_tp_matches_replicated(runs, case):
    """On (2, 2) the tensor-parallel step gives the replicated layout's
    params and losses within the JAX comparison's tolerances (losses
    rtol 1e-5, params atol 2e-5); each rank holds a quarter of the
    frozen base (LoRA) and gathers it every step over ``data`` only
    where it keeps its ``model`` tile, and K1, K6 and K3 run once per
    bucket each (two trainable buckets sharded, one replicated)."""
    tmp = runs
    a = np.load(tmp / f"torch_{case}.npz")
    b = np.load(tmp / f"torch_{BITWISE[case]}.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for k in a.files:
        if k != "loss":
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0,
                                       err_msg=k)
    sharded, replicated = _counts(tmp, case), _counts(tmp, BITWISE[case])
    gathered = _counts(tmp, FSDP_ONLY[case])
    view, _ = _view(case, 0)
    n_train = len(view.trainable_groups)
    n_rep = len(_view(case, 0, "replicated")[0].trainable_groups)
    steps = K * STEPS
    for s, r, o in zip(sharded, replicated, gathered):
        assert s["tp_compute"] and s["collectives"]["tp"] > 0
        assert s["collectives"]["gather"] > 0 == r["collectives"]["gather"]
        # tensor parallelism gathers fewer bytes than the whole leaves
        assert s["bytes"]["gather"] < o["bytes"]["gather"]
        assert s["calls"]["local_step"] == steps * n_train
        assert r["calls"]["local_step"] == steps * n_rep
        if CASES[case]["kind"] == "train":
            assert s["calls"]["delta_accum"] == K * n_train
            # K3 applies the round's delta, then FedAvgM's step
            assert s["calls"]["server_update"] == 2 * n_train
    if CASES[case].get("peft"):
        # the frozen base: a rank holds its rows only — a quarter of the
        # replicated run's bucket, but for the few leaves sharded over
        # one axis or none
        for s, r in zip(sharded, replicated):
            fs, fr = s["resident"]["frozen"], r["resident"]["frozen"]
            assert fs == sum(g.size * 4 for g in view.frozen_groups)
            assert fr == sum(g.size * g.n_shards * 4
                             for g in view.frozen_groups)
            assert fs < fr / 3.9


@pytest.mark.parametrize("case", BITWISE)
def test_sharded_run_checkpoints_as_the_replicated_one(runs, case):
    """Every rank saves the gathered result: one file, written once, with
    the replicated run's leaves, dtypes and manifest (the bitwise
    ``fsdp_only`` twin's files)."""
    a_dir = runs / f"ckpt_{FSDP_ONLY[case]}"
    b_dir = runs / f"ckpt_{BITWISE[case]}"
    assert os.listdir(a_dir) == os.listdir(b_dir) == ["ckpt_1.npz"]
    a, b = load_pytree(str(a_dir / "ckpt_1.npz")), \
        load_pytree(str(b_dir / "ckpt_1.npz"))
    assert load_metadata(str(a_dir / "ckpt_1.npz")) == \
        load_metadata(str(b_dir / "ckpt_1.npz"))
    assert tm.tree_paths(a) == tm.tree_paths(b)
    for x, y in zip(tm.tree_leaves(a), tm.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_vocab_parallel_embedding_and_xent_on_four_ranks(runs):
    """On four gloo ranks, each holding a quarter of a tied vocabulary:
    the vocabulary-parallel lookup equals ``embed[tokens]`` exactly, the
    cross-entropy (two labels ignored) ``_xent``'s within f32 rounding,
    and each rank's gradient rows the whole-vocabulary gradient's; five
    ``"tp"`` all-reduces (the lookup, the max, Σexp, the gold logit, the
    logits' input gradient)."""
    for r in range(4):
        got = json.loads((runs / f"vocab_vocab_{r}.json").read_text())
        assert got["embed"] == 0.0
        assert got["loss"] <= 1e-6 * abs(got["loss_value"])
        assert got["grad"] <= 1e-6 * got["grad_max"]
        assert got["tp"] == 5


def test_tensor_parallel_prefill_and_decode_on_four_ranks(runs):
    """The reduced tinyllama-1.1b on (1, 4) under ``fsdp_tp``: prefill
    and two greedy decode steps on each rank's model-local tree (one q
    pair and its one kv head, a quarter of the vocabulary, the logits
    gathered whole) equal the whole tree's, and the rank's cache holds
    its kv head of the whole cache, within the params' tolerance (the
    row-parallel outputs sum in another order)."""
    for r in range(4):
        got = json.loads((runs / f"vocab_vocab_{r}.json").read_text())
        serve = got["serve"]
        assert serve["kv_heads"] == 1 and serve["logits_shape"][-1] == 512
        assert len(serve["logits"]) == 3
        assert max(serve["logits"]) <= ATOL and serve["cache"] <= ATOL


def test_train_cli_runs_fsdp_tp_on_four_ranks(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2x2`` on four CPU
    ranks (gloo over a ``file://`` store) trains under the default
    ``fsdp_tp`` layout and exits 0 on every rank."""
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [_spawn([sys.executable, "-m", "repro_torch.launch.train",
                     "--device", "cpu", "--arch", ARCH, "--rounds", "1",
                     "--cyclic-rounds", "1", "--clients", "8",
                     "--local-steps", "2", "--seq", "16", "--batch", "4",
                     "--peft", "lora:4", "--mesh", "2x2", "--rank", str(r),
                     "--world-size", "4", "--init-method",
                     f"file://{tmp_path / 'store'}"], env)
             for r in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert "[train] qwen1.5-0.5b: loss" in outs[0][0]
    assert all("[train]" not in out for out, _ in outs[1:])


def _model_tiles(view, tree, m: int):
    """``tree`` with each leaf that a tensor-parallel step keeps local cut
    to its tile at ``model`` coordinate ``m`` (the model-local tree)."""
    from repro_torch.sharding import tensor_parallel
    cfg = with_peft(get_reduced(ARCH), "lora:4")
    tp = tensor_parallel.TPContext(
        mesh=None, size=2, rank=m, plan=tensor_parallel.plan(cfg, 2),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_size=cfg.vocab_size)
    leaves, treedef = tm.tree_flatten(tree)
    out = []
    for path, leaf, slot in zip(tm.tree_paths(tree), leaves, view.slots):
        for d, entry in enumerate(slot.dim_axes):
            if "model" in entry and tp.local(path):
                blk = leaf.shape[d] // 2
                leaf = leaf.narrow(d, m * blk, blk)
        out.append(leaf)
    return [tp.local(p) for p in tm.tree_paths(tree)], \
        tm.tree_unflatten(treedef, out)


def test_row_gradient_sums_once_over_data_never_over_model():
    """The gather's backward on four simulated ranks of a (2, 2) mesh:
    each rank's leaf gradient (the two ``model`` ranks of a ``data`` row
    compute the same batch part) reduces to its row as the replicated
    layout's all-reduce over ``data`` and batch mean would, element for
    element — a sum over ``model`` as well would double it.  With
    ``tensor_parallel`` the leaves are the step's model-local ones: a
    local leaf's gradient is the rank's tile, and a leaf gathered over
    ``model`` (the row-parallel ``lora_b``, whole on both ``model``
    ranks with the same gradient) is sliced at the rank's ``model``
    coordinate, part by part of each bucket."""
    for tensor_parallel in (False, True):
        _check_row_gradient(tensor_parallel)


def _check_row_gradient(tensor_parallel: bool):
    view, _ = _view("tp-lora-fedavgm", 0)
    whole = view.whole_view()
    gen = torch.Generator().manual_seed(0)
    # the whole-leaf gradient buffers of data row d (shared by its model
    # ranks)
    grads = [{n: torch.randn(k, generator=gen)
              for n, k in whole.buffer_sizes.items()} for _ in range(2)]
    mean = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    if tensor_parallel:
        local, _ = _model_tiles(view, whole.unflatten(grads[0]), 0)
        lview, parts = view.model_local(local)
        # the model-local gradient buffers of rank (d, m)
        tiles = {(d, m): lview.whole_view().flatten(_model_tiles(
            view, whole.unflatten(grads[d]), m)[1])
            for d in range(2) for m in range(2)}
        assert any(n.endswith("|whole") and "model" in
                   lview.group_map[n].axes for n in lview.group_map)
    else:
        lview = view
        parts = {g.name: ((g.name, None),) for g in view.groups}
        tiles = {(d, m): grads[d] for d in range(2) for m in range(2)}
    checked = 0
    for g in view.trainable_groups:
        for r in range(4):
            coords = {"data": r // 2, "model": r % 2}
            mesh = types.SimpleNamespace(
                axis_names=("data", "model"), devices=np.zeros((2, 2)),
                shape={"data": 2, "model": 2}, coords=coords,
                device=torch.device("cpu"),
                axis_size=lambda a: 2)
            fops = pod.ShardedFlatOps(view=view.local_view(),
                                      interpret=True, device=mesh.device,
                                      sharded=view, mesh=mesh,
                                      split_batch=True)
            want = view.whole_to_rows(g.name, mean)[
                view.local_rows(coords)[g.name]]
            for part, runs in parts[g.name]:
                # reduce-scatter over data, emulated: rank (d', m)'s
                # block d
                total, own = None, ()
                for d in range(2):
                    own, rows = fops._batch_rows(lview, part, lview
                                                 .whole_to_rows(
                                                     part, tiles[d, r % 2]))
                    blk = rows[coords["data"]] if own else rows[0]
                    total = blk if total is None else total + blk
                assert own == (("data",) if "data" in
                               lview.group_map[part].axes else ())
                got = total / 2
                w = want if runs is None else take_runs(want, runs)
                torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-7)
                # summing over the model ranks too would give twice the
                # mean
                assert not torch.allclose(2 * got, w)
                checked += 1
    assert checked >= 4 * len(view.trainable_groups)


@pytest.mark.parametrize("layout,shape,peft", [
    ("fsdp_tp", (2, 2), "lora:4"), ("fsdp_tp", (2, 2), None),
    ("fsdp_only", (4, 1), None), ("fsdp_only", (2, 2), "lora:4")])
def test_per_shard_layout_round_trips(layout, shape, peft):
    """Each rank's rows (``flatten_local``) are its rows of the packed
    buckets; ``local_view`` gives per-shard sizes and tile shapes;
    ``normal_local`` keeps the rank's tiles of the per-leaf draws; the
    whole-leaf layout is the host FlatView, and rows → whole → rows is
    exact."""
    task = lm_task(with_peft(get_reduced(ARCH), peft))
    tree = task.init(torch.Generator().manual_seed(1))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros(shape),
                                 shape=dict(zip(("data", "model"), shape)))
    filt = "lora" if peft else None
    view = rules.sharded_flat_view(tree, mesh, layout, filt)
    assert any(g.n_shards > 1 for g in view.groups)
    local = view.local_view()
    assert {**local.buffer_sizes, **local.frozen_sizes} == \
        {g.name: g.size for g in view.groups}
    whole = view.whole_view()
    assert whole == FlatView.of(tree, filter=rules.trainable_mask(tree, filt))
    full = {**view.flatten(tree), **view.flatten_frozen(tree)}
    zn = whole.normal(7)            # the per-leaf draws, whole leaves
    zleaves = tm.tree_leaves(whole.unflatten(zn))
    ztree = tm.tree_unflatten(tm.tree_flatten(tree)[1], [
        z if m else torch.zeros(s.shape) for z, m, s in zip(
            zleaves, rules.trainable_mask(tree, filt) or
            [True] * len(zleaves), whole.slots)])
    zrows = view.flatten(ztree)
    for r in range(int(np.prod(shape))):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        rows = view.local_rows(coords)
        mine = {**view.flatten_local(tree, coords),
                **view.flatten_local(tree, coords, frozen=True)}
        for name, b in mine.items():
            assert torch.equal(b, full[name][rows[name]]), name
        for name, b in view.normal_local(7, coords).items():
            assert torch.equal(b, zrows[name][rows[name]]), name
    bufs = {n: torch.empty(k) for n, k in whole.all_sizes.items()}
    for name, b in full.items():
        view.rows_to_whole(name, b, bufs)
    ref = {**whole.flatten(tree), **whole.flatten_frozen(tree)}
    for n in ref:
        assert torch.equal(bufs[n], ref[n]), n
    for name, b in full.items():
        assert torch.equal(view.whole_to_rows(name, bufs), b)
        padded = view.whole_to_rows(name, bufs, b.shape[1] + 3)
        assert torch.equal(padded[:, :b.shape[1]], b)
        assert not padded[:, b.shape[1]:].any()


def test_client_store_keeps_data_sharded_buckets_whole():
    """A per-client stack whose rows differ over ``data`` (``whole``, as
    the pod passes ``ShardedFlatOps.varies_over("data")``) keeps its
    client axis whole on every rank, in the dense and the sparse store
    (a gather is a local index, no collective); without ``whole`` the
    client axis shards over ``data`` as before."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 2)),
                                 shape={"data": 2, "model": 2},
                                 coords={"data": 1, "model": 0},
                                 axis_size=lambda a: 2)
    tmpl = {"float32@data": torch.zeros(6), "float32@model": torch.zeros(4)}
    ids = torch.tensor([3, 0])
    rows = {k: torch.arange(2 * t.numel(), dtype=torch.float32)
            .reshape(2, -1) for k, t in tmpl.items()}
    store = pod.ShardedClientStateStore(mesh=mesh)
    st = store.init(tmpl, 4, whole=True)
    assert not st.sharded and st.rows["float32@data"].shape == (4, 6)
    store.scatter(st, ids, rows)
    pod.reset_collective_counts()
    back = store.gather(st, ids)
    assert pod.COLLECTIVES["store_gather"] == 0
    for k in rows:
        assert torch.equal(back[k], rows[k])
    assert store.population(st) == 4
    st = store.init(tmpl, 4)
    assert st.sharded and st.lo == 2 and st.per == 2
    sparse = pod.ShardedSparseClientStateStore(capacity=4, mesh=mesh)
    st = sparse.init(tmpl, 4, whole=True)
    assert not sparse._meta["sharded"]
    assert st["table"]["float32@data"].shape == (4, 6)
    sparse.init(tmpl, 4)
    assert sparse._meta["sharded"] and sparse._meta["lo"] == 2


def test_row_reduced_buckets_skip_the_grad_reducer():
    """``ShardedFlatOps.row_reduced`` names the trainable buckets sharded
    over mesh axes when the batch is split (their gather's backward
    reduced them), nothing when every rank computes the batch."""
    view, _ = _view("tp-lora-fedavgm", 0)
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    kw = dict(view=view.local_view(), interpret=True, device=mesh.device,
              sharded=view, mesh=mesh)
    split = pod.ShardedFlatOps(split_batch=True, **kw)
    assert split.row_reduced == {g.name for g in view.trainable_groups
                                 if g.axes} == {"float32@data",
                                                "float32@model"}
    assert split.varies_over("data") and split.varies_over("model")
    assert pod.ShardedFlatOps(split_batch=False, **kw).row_reduced == set()


@pytest.mark.parametrize("noise", [False, True])
def test_fused_dp_clip_noise_matches_jax(noise):
    rng = np.random.default_rng(3)
    d = rng.standard_normal(1000).astype(np.float32)
    z = rng.standard_normal(1000).astype(np.float32) if noise else None
    want = jops.fused_dp_clip_noise(
        jnp.asarray(d), None if z is None else jnp.asarray(z), 0.37,
        0.25 if noise else 0.0, interpret=True)
    got = ops.fused_dp_clip_noise(
        torch.from_numpy(d), None if z is None else torch.from_numpy(z),
        0.37, torch.tensor(0.25 if noise else 0.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert got.dtype == torch.float32
