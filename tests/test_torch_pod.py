"""The pod backend (``repro_torch.fl.pod``) against the port's host engine
and against the JAX package's pod, on the CPU.

One rank: a gloo process group of one (``make_host_mesh("cpu")``).  The
pod relay equals the host relay bitwise; the pod aggregate (the
sequential K6 accumulation) equals the host aggregate (one K2 pass)
within rtol 1e-5.  Against the JAX pod on its one-device mesh
(``repro.launch.mesh.make_host_mesh``): the small ``mlp`` and LeNet-5,
tree and fused, sequential and hierarchical (``n_pods=2``: the lanes
are not sharded on one rank), compressed uploads with error feedback,
DP + secure aggregation on the JAX package's draws (injected through
``RoundSchedule.noise_draws``), and the server optimizers (adam at
``server_lr=1e-3``: Adam's normalization turns a last-bit difference
in a near-zero pseudo-gradient into a step of up to the lr), and
scaffold and moon, whose client state is compared too (scaffold's
control variates at the params' tolerance over S·lr: c_i⁺ divides the
param change by it).  Both
sides start from the same JAX-initialized params and train on the JAX
engine's threefry batch indices (injected), with ``sampling="host"``.
Tolerances: losses rtol 1e-5, params atol 2e-5 (2 rounds; conv and
matmul reductions sum in another order); adam at atol 1e-4, as in
``tests/test_torch_pipeline.py``.  Compressed uploads as in
``tests/test_torch_compression.py``: params and error-feedback rows at
atol 1e-4, except that an element whose delta sits within that
difference of a rounding edge (the top-k threshold or a quantization
midpoint) may land on the other side — at most 0.1% of the elements may
then differ, each by no more than twice the largest residual.

Four ranks: ``tests/torch_pod_worker.py`` runs in four processes over a
``file://`` gloo store, on ``(2, 2)`` and ``(4, 1)`` meshes, against the
JAX pod in a subprocess with 4 fake CPU devices on the same meshes
(``repro.launch.mesh._make_mesh``).  The hierarchical cases take the
``lane_psum`` branch (n_pods = |data|), with and without DP clipping;
each round's lane combine is exactly one ``all_reduce`` per bucket.
The data-parallel runs equal the one-rank port run within 1e-5 and the
JAX pod within atol 2e-5.  The compressed cases (int8 + top-k 25% +
error feedback, sequential and hierarchical on ``(2, 2)``) shard the
error-feedback rows over ``data``: each round gathers them with one
``all_reduce`` per bucket, and the rows gathered from every rank, like
the params, match the JAX pod and the one-rank run at the compressed
tolerance above.  The scaffold case (sequential on ``(2, 2)``) shards
the control variates over ``data`` the same way: one ``all_reduce``
gathers the round's rows, and ``c`` matches the one-rank run and the
JAX pod.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import (index_source, jax_engine_indices, jax_leaves,
                          jax_noise_draws, jax_numpy_params, torch_leaves)

import jax
from repro.data.synthetic import DATASETS as J_DATASETS
from repro.fl import compression as jcomp
from repro.fl import privacy as jpriv
from repro.fl import pod as jpod
from repro.fl.engine import run_rounds as j_run_rounds
from repro.fl.task import vision_task as j_vision_task
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro_torch import bridge
from repro_torch.core.cyclic import CyclicConfig, cyclic_pretrain
from repro_torch.core.pipeline import Phase, run_phase_schedule
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl import compression, pod, privacy
from repro_torch.fl.engine import run_rounds
from repro_torch.fl.simulation import FLConfig, run_federated
from repro_torch.fl.task import vision_task
from repro_torch.kernels import fused_update as fu
from repro_torch.launch import mesh as tmesh

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
N_CLIENTS, N_TRAIN, N_TEST = 8, 256, 64
STEPS, BATCH, K, ROUNDS = 3, 8, 4, 2
MODELS = {"mlp": {"img": 32}, "lenet5": None}
ATOL = 2e-5


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_host_mesh("cpu")
    yield m
    tmesh.destroy()


@pytest.fixture(scope="module")
def sides():
    """Per model: the JAX task/data/init and the port's task/data."""
    out = {}
    for model, kw in MODELS.items():
        jtask = j_vision_task(model, n_classes=10, in_ch=3, seed_kwargs=kw)
        jdata = J_DATASETS.get("cifar10-like")(
            n_clients=N_CLIENTS, beta=0.5, seed=SEED, n_train=N_TRAIN,
            n_test=N_TEST)
        ttask = vision_task(model, n_classes=10, in_ch=3, seed_kwargs=kw)
        tdata = DATASETS.get("cifar10-like")(
            n_clients=N_CLIENTS, beta=0.5, seed=SEED, n_train=N_TRAIN,
            n_test=N_TEST)
        # a numpy copy: the JAX pod donates its carries
        jinit = jax.tree_util.tree_map(
            np.array, jtask.init(jax.random.PRNGKey(SEED)))
        out[model] = (jtask, jdata, jinit, ttask, tdata)
    return out


def _indices(rounds, k):
    return jax_engine_indices(SEED, rounds, k, STEPS, BATCH,
                              N_TRAIN // N_CLIENTS)


def _spec_kw(impl, **kw):
    return dict(local_steps=STEPS, batch_size=BATCH, lr=0.05,
                update_impl=impl, **kw)


def _assert_params(t_tree, j_tree, atol=ATOL):
    for a, b in zip(torch_leaves(t_tree), jax_leaves(j_tree)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _assert_compressed_close(pairs, bound):
    """Compressed uploads: within 1e-4, except at most 0.1% of the
    elements, each by no more than ``bound`` (twice the largest
    residual), where a delta sat on a rounding edge."""
    for a, b in pairs:
        off = np.abs(a - b) > 1e-4
        assert off.sum() <= max(1, a.size // 1000), int(off.sum())
        assert np.all(np.abs(a - b)[off] <= bound)


# ---------------------------------------------------------------------------
# one rank: the pod against the port's host engine
# ---------------------------------------------------------------------------

def test_pod_relay_equals_host_relay_bitwise(mesh, sides):
    _, _, jinit, task, data = sides["mlp"]
    init = bridge.params_from_numpy(jax_numpy_params(jinit))
    idx = index_source(_indices(2, 2))
    host = cyclic_pretrain(task, data, CyclicConfig(
        rounds=2, participation=0.25, local_steps=STEPS, batch_size=BATCH,
        lr=0.05, lr_decay=1.0, update_impl="fused", sampling="host",
        eval_every=1, batch_indices=idx), init_params=init, device="cpu")
    p = pod.run_pod_rounds(task, data, pod.PodCyclicConfig(
        mesh, rounds=2, clients_per_round=2, spec=pod.PodFLSpec(
            **_spec_kw("fused")), sampling="host", eval_every=1,
        batch_indices=idx), init_params=init)
    assert [h["local_loss"] for h in p.history] == \
        [h["local_loss"] for h in host.history]
    assert [h["acc"] for h in p.history] == [h["acc"] for h in host.history]
    for a, b in zip(torch_leaves(p.params), torch_leaves(host.params)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("impl", ["tree", "fused"])
@pytest.mark.parametrize("server_opt", ["none", "momentum"])
def test_pod_aggregate_matches_host(mesh, sides, impl, server_opt):
    _, _, jinit, task, data = sides["mlp"]
    init = bridge.params_from_numpy(jax_numpy_params(jinit))
    idx = index_source(_indices(ROUNDS, K))
    fu.reset_launch_counts()
    host = run_federated(task, data, FLConfig(
        rounds=ROUNDS, participation=K / N_CLIENTS, local_steps=STEPS,
        batch_size=BATCH, lr=0.05, lr_decay=1.0, server_opt=server_opt,
        update_impl=impl, sampling="host", eval_every=1, batch_indices=idx),
        init_params=init, device="cpu")
    p = pod.run_pod_rounds(task, data, pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K, spec=pod.PodFLSpec(
            server_opt=server_opt, **_spec_kw(impl)), sampling="host",
        eval_every=1, batch_indices=idx), init_params=init)
    np.testing.assert_allclose([h["local_loss"] for h in p.history],
                               [h["local_loss"] for h in host.history],
                               rtol=1e-5)
    for a, b in zip(torch_leaves(p.params), torch_leaves(host.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # CPU tensors: the plain versions run and no launch is counted
    assert fu.delta_accum.launches == 0


@pytest.mark.parametrize("impl", ["tree", "fused"])
@pytest.mark.parametrize("algorithm", ["scaffold", "moon"])
def test_pod_algorithm_matches_host(mesh, sides, algorithm, impl):
    """The pod's per-client scaffold and moon steps and its client-state
    update after the aggregate equal the host engine's: params within
    rtol 1e-5 (atol 1e-7), the control variates within atol
    1e-7/(S·lr) (c_i⁺ divides the param change by S·lr), the moon rows
    as the params."""
    _, _, jinit, task, data = sides["mlp"]
    init = bridge.params_from_numpy(jax_numpy_params(jinit))
    idx = index_source(_indices(ROUNDS, K))
    fu.reset_launch_counts()
    host = run_federated(task, data, FLConfig(
        algorithm=algorithm, mu=0.5, rounds=ROUNDS,
        participation=K / N_CLIENTS, local_steps=STEPS, batch_size=BATCH,
        lr=0.05, lr_decay=1.0, update_impl=impl, sampling="host",
        eval_every=1, batch_indices=idx), init_params=init, device="cpu")
    p = pod.run_pod_rounds(task, data, pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K, spec=pod.PodFLSpec(
            algorithm=algorithm, mu=0.5, **_spec_kw(impl)), sampling="host",
        eval_every=1, batch_indices=idx), init_params=init)
    np.testing.assert_allclose([h["local_loss"] for h in p.history],
                               [h["local_loss"] for h in host.history],
                               rtol=1e-5)
    for a, b in zip(torch_leaves(p.params), torch_leaves(host.params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    if algorithm == "scaffold":
        pairs = [(p.algo_state["c_global"], host.state.c_global),
                 (p.algo_state["c_clients"].rows, host.state.c_clients)]
        atol = 1e-7 / (STEPS * 0.05)
    else:
        pairs = [(p.algo_state["w_prev"].rows, host.state.w_prev)]
        atol = 1e-7
    for got, want in pairs:
        for a, b in zip(torch_leaves(got), torch_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    assert np.any(torch_leaves(pairs[-1][0])[0] != 0)
    assert fu.local_step.c_launches == 0        # CPU: the plain versions


def test_pod_runs_through_the_phase_schedule(mesh, sides):
    """``Phase(cfg=Pod*Config)`` runs through ``run_phase_schedule`` on
    the mesh's device, under one ledger."""
    _, _, _, task, data = sides["mlp"]
    spec = pod.PodFLSpec(**_spec_kw("fused"))
    res = run_phase_schedule(task, data, [
        Phase("P1", pod.PodCyclicConfig(mesh, rounds=1, clients_per_round=2,
                                        spec=spec)),
        Phase("P2", pod.PodFLConfig(mesh, rounds=2, clients_per_round=K,
                                    spec=spec, eval_every=1))])
    assert [h["phase"] for h in res.history] == ["P1", "P2", "P2"]
    assert all(np.isfinite(h["local_loss"]) for h in res.history)
    assert res.ledger.total_bytes > 0
    with pytest.raises(ValueError, match="mesh's device"):
        pod.run_pod_rounds(task, data, pod.PodFLConfig(mesh, rounds=1),
                           device="meta")


class _FourRankMesh:
    """What the rules and the strategy read of a (2, 2) mesh, for the
    rank at (0, 0): no process group is needed to build its views."""
    axis_names = ("data", "model")
    devices = np.zeros((2, 2))
    shape = {"data": 2, "model": 2}
    coords = {"data": 0, "model": 0}
    device = torch.device("cpu")

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axes):
        return 0


def test_unported_pod_options_raise_naming_their_items(mesh):
    # M10 is ported: the sparse store builds on the mesh
    assert isinstance(pod.PodFLConfig(mesh, store="sparse").strategy()
                      .state_store, pod.ShardedSparseClientStateStore)
    # M11 is ported: the knobs need the fused path and reach the local
    # spec; M13b is ported: four ranks build ShardedFlatOps over sharded
    # groups, each rank's view the per-shard layout
    with pytest.raises(ValueError, match="fused flat path"):
        pod.PodFLSpec(peft="lora:8")
    assert pod.PodFLSpec(peft="lora:8", update_impl="fused").local_spec() \
        .peft == "lora:8"
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.fl.task import lm_task
    task = lm_task(with_peft(get_reduced("qwen1.5-0.5b"), "lora:4"))
    four = _FourRankMesh()
    for layout in ("fsdp_tp", "fsdp_only"):
        strat = pod.PodAggregateStrategy(
            spec=pod.PodFLSpec(update_impl="fused", peft="lora:4")
            .local_spec(), mesh=four, layout=layout)
        fops = strat.flat_ops(task, torch.device("cpu"))
        assert isinstance(fops, pod.ShardedFlatOps) and fops.split_batch
        view = fops.sharded
        assert any(g.n_shards > 1 for g in view.trainable_groups)
        assert any(g.n_shards == 4 for g in view.frozen_groups)
        assert fops.view.buffer_sizes == {g.name: g.size
                                          for g in view.trainable_groups}
        assert fops.view.frozen_sizes == {g.name: g.size
                                          for g in view.frozen_groups}
    strat = pod.PodAggregateStrategy(
        spec=pod.PodFLSpec(update_impl="fused", peft="lora:4").local_spec(),
        mesh=four, layout="replicated")
    assert strat.flat_ops(task, torch.device("cpu")).view.frozen_sizes
    with pytest.raises(ValueError, match="fused flat path"):
        pod.PodFLSpec(compression=compression.CompressionSpec(8, 0.25, True))
    with pytest.raises(ValueError, match="requires a mesh"):
        pod.PodAggregateStrategy(spec=pod.PodFLSpec().local_spec())


# ---------------------------------------------------------------------------
# one rank: the pod against the JAX pod
# ---------------------------------------------------------------------------

CASES = {
    # name: (model, impl, PodFLConfig kwargs, PodFLSpec kwargs)
    "mlp-tree": ("mlp", "tree", {}, {}),
    "mlp-fused": ("mlp", "fused", {}, {}),
    "lenet5-tree": ("lenet5", "tree", {}, {}),
    "lenet5-fused": ("lenet5", "fused", {}, {"server_opt": "momentum"}),
    "hierarchical-tree": ("mlp", "tree",
                          {"aggregation": "hierarchical", "n_pods": 2}, {}),
    "hierarchical-fused": ("mlp", "fused",
                           {"aggregation": "hierarchical", "n_pods": 2}, {}),
    "compressed-ef": ("mlp", "fused", {}, {"compression": "int8-topk-ef"}),
    "compressed-ef-hierarchical": ("mlp", "fused",
                                   {"aggregation": "hierarchical",
                                    "n_pods": 2},
                                   {"compression": "int8-topk-ef"}),
    "dp-secure-agg": ("mlp", "fused", {}, {"dp": (1.0, 0.1),
                                           "secure_agg": True}),
    "dp-hierarchical-tree": ("mlp", "tree",
                             {"aggregation": "hierarchical", "n_pods": 2},
                             {"dp": (0.5, 0.0)}),
    "momentum": ("mlp", "fused", {}, {"server_opt": "momentum"}),
    "adam": ("mlp", "fused", {}, {"server_opt": "adam", "server_lr": 1e-3}),
    "scaffold-tree": ("mlp", "tree", {}, {"algorithm": "scaffold"}),
    "scaffold-fused": ("mlp", "fused", {}, {"algorithm": "scaffold"}),
    "moon-fused": ("mlp", "fused", {}, {"algorithm": "moon", "mu": 0.5}),
}


def _spec_objects(skw, comp_mod, priv_mod):
    skw = dict(skw)
    if skw.pop("compression", None):
        skw["compression"] = comp_mod.CompressionSpec(8, 0.25, True)
    if "dp" in skw:
        skw["dp"] = priv_mod.DPSpec(*skw["dp"])
    return skw


@pytest.mark.parametrize("case", CASES)
def test_pod_matches_jax_pod(mesh, sides, case):
    model, impl, cfg_kw, spec_kw = CASES[case]
    jtask, jdata, jinit, task, data = sides[model]
    jcfg = jpod.PodFLConfig(
        mesh=j_make_host_mesh(), rounds=ROUNDS, clients_per_round=K,
        spec=jpod.PodFLSpec(**_spec_kw(
            "fused_interpret" if impl == "fused" else "tree",
            **_spec_objects(spec_kw, jcomp, jpriv))),
        sampling="host", eval_every=1, chunk_size=1, **cfg_kw)
    jres = j_run_rounds(jtask, jdata, jcfg.strategy(), jcfg.schedule(),
                        init_params=jax.tree_util.tree_map(jax.numpy.array,
                                                           jinit))

    tcfg = pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K,
        spec=pod.PodFLSpec(**_spec_kw(
            impl, **_spec_objects(spec_kw, compression, privacy))),
        sampling="host", eval_every=1,
        batch_indices=index_source(_indices(ROUNDS, K)), **cfg_kw)
    schedule = tcfg.schedule()
    if "dp" in spec_kw or spec_kw.get("secure_agg"):
        schedule = dataclasses.replace(schedule, noise_draws=jax_noise_draws(
            SEED, ROUNDS, jinit))
    res = run_rounds(task, data, tcfg.strategy(), schedule,
                     init_params=bridge.params_from_numpy(
                         jax_numpy_params(jinit)), device="cpu")
    np.testing.assert_allclose([h["local_loss"] for h in res.history],
                               [h["local_loss"] for h in jres.history],
                               rtol=1e-5)
    for jh, th in zip(jres.history, res.history):
        assert abs(jh["acc"] - th["acc"]) * N_TEST <= 1 + 1e-6
    if spec_kw.get("algorithm") == "scaffold":
        # the control variates: the params' tolerance over S·lr
        for key in ("c_global", "c_clients"):
            got = res.algo_state[key]
            got = torch_leaves(got.rows if key == "c_clients" else got)
            want = jax_leaves(jres.algo_state[key])
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b.reshape(a.shape),
                                           atol=ATOL / (STEPS * 0.05), rtol=0)
    if "compression" not in spec_kw:
        _assert_params(res.params, jres.params,
                       1e-4 if spec_kw.get("server_opt") == "adam" else ATOL)
        return
    jr = np.asarray(jres.algo_state["ef_residuals"]["float32"])
    tr = res.algo_state["ef_residuals"].rows["float32"].numpy()
    jr = jr.reshape(tr.shape)
    assert np.any(jr != 0)
    _assert_compressed_close(
        list(zip(torch_leaves(res.params), jax_leaves(jres.params)))
        + [(tr, jr)], 2 * np.abs(jr).max())


# ---------------------------------------------------------------------------
# the round's K6 coefficients: one division per round, the same bits
# ---------------------------------------------------------------------------

COEFF_CASES = {
    # name: (PodFLConfig kwargs, PodFLSpec kwargs)
    "sequential": ({}, {}),
    "hierarchical": ({"aggregation": "hierarchical", "n_pods": 2}, {}),
    "compressed-ef": ({}, {"compression": "int8-topk-ef"}),
    "dp-clip": ({}, {"dp": (0.5, 0.0)}),
    "dp-clip-hierarchical": ({"aggregation": "hierarchical", "n_pods": 2},
                             {"dp": (0.5, 0.0)}),
}


@pytest.mark.parametrize("case", COEFF_CASES)
def test_pod_k6_coefficients_keep_their_bits(mesh, sides, monkeypatch,
                                             case):
    """The pod computes every client's coefficient as one vector
    ``w / Σw`` per round and hands K6 a view of it; each coefficient K6
    receives is bit-equal to the per-client division ``w_j / Σw`` it
    received before, and under DP clipping to ``(w_j·scale_j)/Σw``, in
    that order."""
    from repro_torch.fl.local import FlatParamOps
    cfg_kw, spec_kw = COEFF_CASES[case]
    _, _, jinit, task, data = sides["mlp"]
    seen = {"w": [], "coeff": [], "scale": []}
    build = pod.PodAggregateStrategy.build_round

    def build_round(self, task, device):
        body = build(self, task, device)

        def recording(params, inputs, lr_scale, algo_state):
            seen["w"].append(inputs.weights.to(torch.float32).clone())
            return body(params, inputs, lr_scale, algo_state)
        return recording
    accum = FlatParamOps.delta_accum

    def delta_accum(self, delta_bufs, w_bufs, p_bufs, coeff):
        seen["coeff"].append(coeff.clone())
        return accum(self, delta_bufs, w_bufs, p_bufs, coeff)
    clip_scale = privacy.clip_scale

    def recording_clip_scale(dp, sqnorm):
        out = clip_scale(dp, sqnorm)
        seen["scale"].append(out.clone())
        return out
    monkeypatch.setattr(pod.PodAggregateStrategy, "build_round", build_round)
    monkeypatch.setattr(FlatParamOps, "delta_accum", delta_accum)
    monkeypatch.setattr(privacy, "clip_scale", recording_clip_scale)
    cfg = pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K, spec=pod.PodFLSpec(
            **_spec_kw("fused", **_spec_objects(spec_kw, compression,
                                                privacy))),
        sampling="host", eval_every=1,
        batch_indices=index_source(_indices(ROUNDS, K)), **cfg_kw)
    res = pod.run_pod_rounds(task, data, cfg, init_params=bridge.
                             params_from_numpy(jax_numpy_params(jinit)))
    assert all(np.isfinite(t).all() for t in torch_leaves(res.params))
    assert len(seen["w"]) == ROUNDS and len(seen["coeff"]) == ROUNDS * K
    scales = iter(seen["scale"])
    for rnd, w in enumerate(seen["w"]):
        wsum = torch.sum(w)
        for j in range(K):
            got = seen["coeff"][rnd * K + j].reshape(())
            want = (w[j] * next(scales)) / wsum if "dp" in spec_kw \
                else w[j] / wsum
            assert got.view(torch.int32) == want.view(torch.int32), (rnd, j)
    assert next(scales, None) is None


# ---------------------------------------------------------------------------
# four ranks: data-parallel steps and the one-all-reduce lane combine
# ---------------------------------------------------------------------------

MR_CASES = {
    # name: (mesh shape, PodFLConfig kwargs, DP clip or None,
    #        int8 + top-k 25% + EF uploads, algorithm)
    "2x2-sequential": ((2, 2), {}, None, False, "fedavg"),
    "2x2-lanes": ((2, 2), {"aggregation": "hierarchical"}, None, False,
                  "fedavg"),
    "2x2-lanes-dp": ((2, 2), {"aggregation": "hierarchical"}, 0.5, False,
                     "fedavg"),
    "4x1-lanes": ((4, 1), {"aggregation": "hierarchical"}, None, False,
                  "fedavg"),
    "4x1-lanes-dp": ((4, 1), {"aggregation": "hierarchical"}, 0.5, False,
                     "fedavg"),
    "2x2-compressed-ef": ((2, 2), {}, None, True, "fedavg"),
    "2x2-compressed-ef-lanes": ((2, 2), {"aggregation": "hierarchical"},
                                None, True, "fedavg"),
    "2x2-scaffold": ((2, 2), {}, None, False, "scaffold"),
    # the LM slice: reduced qwen1.5-0.5b with lora:4 adapters on the token
    # stream, params replicated (sharded groups are M13b), the batch
    # split over data; only the adapter bucket trains and all-reduces
    "2x2-lora": ((2, 2), {"layout": "replicated"}, None, False, "fedavg"),
}
# the MR_CASES entries that train the LoRA model (the others the mlp)
LORA_CASES = ("2x2-lora",)
LORA_ARCH, LORA_SEQ, LORA_N_SEQ = "qwen1.5-0.5b", 16, 8

_JAX_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from repro.data.synthetic import DATASETS
    from repro.fl import compression, pod, privacy
    from repro.fl.engine import run_rounds
    from repro.fl.task import lm_task, vision_task
    from repro.configs import get_reduced, with_peft
    from repro.data.synthetic import make_synthetic_tokenlm
    from repro.launch.mesh import _make_mesh
    cfg = json.load(open(sys.argv[1]))
    task = vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs={"img": 32})
    data = DATASETS.get("cifar10-like")(n_clients=cfg["n_clients"],
        beta=0.5, seed=cfg["seed"], n_train=cfg["n_train"],
        n_test=cfg["n_test"])
    init = task.init(jax.random.PRNGKey(cfg["seed"]))
    lm = cfg["lora"]
    lcfg = with_peft(get_reduced(lm["arch"]), "lora:4")
    ltask = lm_task(lcfg)
    ldata = make_synthetic_tokenlm(n_clients=cfg["n_clients"],
        seq_len=lm["seq"], n_seq_per_client=lm["n_seq"],
        vocab=lcfg.vocab_size, seed=cfg["seed"])
    linit = ltask.init(jax.random.PRNGKey(cfg["seed"]))
    out = {}
    for name, case in cfg["cases"].items():
        mesh = _make_mesh(tuple(case["shape"]), ("data", "model"))
        dp = privacy.DPSpec(case["dp"]) if case["dp"] else None
        comp = (compression.CompressionSpec(8, 0.25, True)
                if case["compressed"] else None)
        lora = case["task"] == "lora"
        c = pod.PodFLConfig(mesh=mesh, rounds=cfg["rounds"],
            clients_per_round=cfg["K"], spec=pod.PodFLSpec(
                update_impl="fused_interpret", dp=dp, compression=comp,
                algorithm=case["algorithm"],
                peft="lora:4" if lora else None, **cfg["spec"]),
            sampling="host", eval_every=1, chunk_size=1, **case["kw"])
        res = run_rounds(ltask if lora else task, ldata if lora else data,
                         c.strategy(), c.schedule(),
                         init_params=linit if lora else init)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(res.params)):
            out[f"{name}/p{i}"] = np.asarray(leaf, np.float32)
        out[f"{name}/loss"] = np.array([h["local_loss"]
                                        for h in res.history])
        if comp is not None:
            out[f"{name}/ef"] = np.asarray(
                res.algo_state["ef_residuals"]["float32"], np.float32)
        if "c_global" in res.algo_state:
            out[f"{name}/c"] = np.asarray(
                res.algo_state["c_global"]["float32"], np.float32)
    np.savez(cfg["out"], **out)
""")


def _run_jax_reference(cfg_path: Path) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", _JAX_REFERENCE,
                             str(cfg_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _run_workers(cfg_path: Path, world: int):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = cfg_path.parent / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_pod_worker.py"),
         str(cfg_path), str(rank), str(world), f"file://{store}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    return procs


def _wait(procs, what, timeout=240):
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"{what} failed:\n{out}\n{err[-4000:]}"


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory, sides):
    """The four-rank port runs and the four-device JAX runs of every
    ``MR_CASES`` entry, side by side (the two subprocess groups run at
    the same time)."""
    tmp = tmp_path_factory.mktemp("pod4")
    _, _, jinit, _, _ = sides["mlp"]
    np.savez(tmp / "init.npz", *[np.asarray(x, np.float32)
                                 for x in jax.tree_util.tree_leaves(jinit)])
    np.save(tmp / "indices.npy", _indices(ROUNDS, K))
    np.savez(tmp / "init_lora.npz", *[
        np.asarray(x, np.float32)
        for x in jax.tree_util.tree_leaves(_lora_side()[0])])
    np.save(tmp / "indices_lora.npy", _lora_indices())
    cases = {name: {"shape": list(shape), "kw": kw, "dp": dp,
                    "compressed": comp, "algorithm": algorithm,
                    "task": "lora" if name in LORA_CASES else "mlp"}
             for name, (shape, kw, dp, comp, algorithm) in MR_CASES.items()}
    cfg = dict(seed=SEED, n_clients=N_CLIENTS, n_train=N_TRAIN,
               n_test=N_TEST, rounds=ROUNDS, K=K,
               spec=dict(local_steps=STEPS, batch_size=BATCH, lr=0.05),
               lora=dict(arch=LORA_ARCH, seq=LORA_SEQ, n_seq=LORA_N_SEQ),
               cases=cases, out=str(tmp / "jax.npz"), dir=str(tmp))
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    jproc = _run_jax_reference(tmp / "cfg.json")
    workers = _run_workers(tmp / "cfg.json", 4)
    _wait(workers, "torch_pod_worker.py")
    _wait([jproc], "the JAX reference")
    return cfg, tmp


@functools.lru_cache(maxsize=None)
def _lora_side():
    """The LoRA cases' JAX init params (numpy), the port's task and
    data."""
    from repro.configs import get_reduced as jget_reduced
    from repro.configs import with_peft as jwith_peft
    from repro.fl.task import lm_task as j_lm_task
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    from repro_torch.fl.task import lm_task
    jtask = j_lm_task(jwith_peft(jget_reduced(LORA_ARCH), "lora:4"))
    jinit = jax.tree_util.tree_map(np.array,
                                   jtask.init(jax.random.PRNGKey(SEED)))
    cfg = with_peft(get_reduced(LORA_ARCH), "lora:4")
    data = make_synthetic_tokenlm(n_clients=N_CLIENTS, seq_len=LORA_SEQ,
                                  n_seq_per_client=LORA_N_SEQ,
                                  vocab=cfg.vocab_size, seed=SEED)
    return jinit, lm_task(cfg), data


def _lora_indices():
    return jax_engine_indices(SEED, ROUNDS, K, STEPS, BATCH, LORA_N_SEQ)


def _one_rank_lora(mesh, case_kw):
    jinit, task, data = _lora_side()
    cfg = pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K,
        spec=pod.PodFLSpec(peft="lora:4", **_spec_kw("fused")),
        sampling="host", eval_every=1,
        batch_indices=index_source(_lora_indices()), **case_kw)
    return pod.run_pod_rounds(task, data, cfg, init_params=bridge.
                              params_from_numpy(jax_numpy_params(jinit)))


def _one_rank(mesh, sides, case_kw, dp, comp, algorithm):
    """The same case on the one-rank mesh (the hierarchical lanes and the
    client store are then unsharded)."""
    _, _, jinit, task, data = sides["mlp"]
    cfg = pod.PodFLConfig(
        mesh, rounds=ROUNDS, clients_per_round=K, spec=pod.PodFLSpec(
            algorithm=algorithm, dp=privacy.DPSpec(dp) if dp else None,
            compression=(compression.CompressionSpec(8, 0.25, True)
                         if comp else None), **_spec_kw("fused")),
        sampling="host", eval_every=1,
        batch_indices=index_source(_indices(ROUNDS, K)),
        **dict(case_kw, n_pods=2) if case_kw else {})
    return pod.run_pod_rounds(task, data, cfg, init_params=bridge.
                              params_from_numpy(jax_numpy_params(jinit)))


# four ranks, the sparse store against the dense one: 4 rounds of one
# round a dispatch, capacity K = 4 over 8 clients (2 slots a rank on the
# data axis), so rows spill to every rank and refault into slots that
# another rank may own
SPARSE_ROUNDS = 4
SPARSE_CASES = {"scaffold": ("scaffold", False),
                "compressed-ef": ("fedavg", True)}


@pytest.fixture(scope="module")
def sparse_ranks(tmp_path_factory, sides):
    tmp = tmp_path_factory.mktemp("pod4sparse")
    _, _, jinit, _, _ = sides["mlp"]
    np.savez(tmp / "init.npz", *[np.asarray(x, np.float32)
                                 for x in jax.tree_util.tree_leaves(jinit)])
    np.save(tmp / "indices.npy", _indices(SPARSE_ROUNDS, K))
    cases = {}
    for name, (algorithm, comp) in SPARSE_CASES.items():
        for store in ("dense", "sparse"):
            kw = {"chunk_size": 1}
            if store == "sparse":
                kw.update(store="sparse", store_capacity=K)
            cases[f"{name}-{store}"] = {
                "shape": [2, 2], "kw": kw, "dp": None, "compressed": comp,
                "algorithm": algorithm, "rounds": SPARSE_ROUNDS}
    cfg = dict(seed=SEED, n_clients=N_CLIENTS, n_train=N_TRAIN,
               n_test=N_TEST, rounds=SPARSE_ROUNDS, K=K,
               spec=dict(local_steps=STEPS, batch_size=BATCH, lr=0.05),
               cases=cases, dir=str(tmp))
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    _wait(_run_workers(tmp / "cfg.json", 4), "torch_pod_worker.py")
    return tmp


@pytest.mark.parametrize("case", SPARSE_CASES)
def test_four_ranks_sparse_store_matches_dense_bitwise(sparse_ranks, case):
    """The pod's sparse store on four gloo ranks: params, losses,
    ``c_global`` and every client's rows bitwise the dense store's; the
    sparse table spilled and refaulted rows, and gathers once a round
    like the dense one."""
    tmp = sparse_ranks
    algorithm, comp = SPARSE_CASES[case]
    dense = np.load(tmp / f"torch_{case}-dense.npz")
    sparse = np.load(tmp / f"torch_{case}-sparse.npz")
    assert sorted(dense.files) == sorted(sparse.files)
    for k in dense.files:
        np.testing.assert_array_equal(sparse[k], dense[k], k)
    tag, key = ("ef", "ef_residuals") if comp else ("c_clients", "c_clients")
    parts = [np.load(tmp / f"{tag}_{case}-dense_{r}.npz") for r in range(4)]
    rows = np.zeros((N_CLIENTS,) + parts[0]["rows"].shape[1:], np.float32)
    for part in parts:
        lo = int(part["lo"])
        rows[lo:lo + len(part["rows"])] = part["rows"]
    assert np.any(rows != 0)
    for r in range(4):
        np.testing.assert_array_equal(
            np.load(tmp / f"{tag}_{case}-sparse_{r}.npz")["rows"], rows)
    for r in range(4):
        cd, cs = (json.loads((tmp / f"counts_{case}-{s}_{r}.json")
                             .read_text()) for s in ("dense", "sparse"))
        assert cs["store_gather"] == cd["store_gather"] == SPARSE_ROUNDS
        assert cd["store_spill"] == 0 and cs["store_spill"] > 0
        assert cs[f"{key}_spilled"] > 0 and cs[f"{key}_refaulted"] > 0
        assert cs["grad"] == cd["grad"] == SPARSE_ROUNDS * K * STEPS


@pytest.mark.parametrize("case", MR_CASES)
def test_four_ranks_match_jax_and_one_rank(mesh, sides, multi_rank, case):
    cfg, tmp = multi_rank
    shape, kw, dp, comp, algorithm = MR_CASES[case]
    got = np.load(tmp / f"torch_{case}.npz")
    want = np.load(tmp / "jax.npz")
    n = len([k for k in want if k.startswith(f"{case}/p")])
    one = (_one_rank_lora(mesh, kw) if case in LORA_CASES else
           _one_rank(mesh, sides, kw, dp, comp, algorithm))
    np.testing.assert_allclose(got["loss"], want[f"{case}/loss"], rtol=1e-5)
    per_rank = [json.loads((tmp / f"counts_{case}_{r}.json").read_text())
                for r in range(4)]
    if comp:
        # the EF rows: each client's row from the rank that owns it (its
        # block of the data axis; the model axis replicates)
        ef = np.zeros_like(one.algo_state["ef_residuals"].rows["float32"]
                           .numpy())
        for r in range(4):
            part = np.load(tmp / f"ef_{case}_{r}.npz")
            lo, rows = int(part["lo"]), part["rows"]
            assert len(rows) == N_CLIENTS // shape[0]
            ef[lo:lo + len(rows)] = rows
        jr = want[f"{case}/ef"].reshape(ef.shape)
        assert np.any(jr != 0)
        bound = 2 * np.abs(jr).max()
        _assert_compressed_close(
            [(got[f"p{i}"], want[f"{case}/p{i}"]) for i in range(n)]
            + [(ef, jr)], bound)
        _assert_compressed_close(
            [(got[f"p{i}"], leaf)
             for i, leaf in enumerate(torch_leaves(one.params))]
            + [(ef, one.algo_state["ef_residuals"].rows["float32"].numpy())],
            bound)
    else:
        for i in range(n):
            np.testing.assert_allclose(got[f"p{i}"], want[f"{case}/p{i}"],
                                       atol=ATOL, rtol=0)
        for i, leaf in enumerate(torch_leaves(one.params)):
            np.testing.assert_allclose(got[f"p{i}"], leaf, atol=1e-5, rtol=0)
    if case in LORA_CASES:
        # the frozen base comes back bitwise on every rank's result; the
        # adapters (one f32 bucket: one all-reduce per step) moved
        from repro_torch.sharding import rules as trules
        jinit = jax.tree_util.tree_leaves(_lora_side()[0])
        mask = trules.trainable_mask(_lora_side()[1].shapes(), "lora")
        assert len(mask) == n
        for i, (leaf0, m) in enumerate(zip(jinit, mask)):
            assert np.array_equal(got[f"p{i}"], leaf0) != m, i
    if algorithm == "scaffold":
        # c: the gathered rows of the client store sharded over data
        c_one = one.algo_state["c_global"]["float32"].numpy()
        np.testing.assert_allclose(got["c"], c_one, atol=1e-5 / (STEPS * 0.05),
                                   rtol=0)
        np.testing.assert_allclose(got["c"], want[f"{case}/c"].reshape(
            c_one.shape), atol=ATOL / (STEPS * 0.05), rtol=0)
    # every rank: one all-reduce per bucket per round in the lane combine
    # and in the sharded EF store's gather (the mlp has one f32 bucket),
    # and one per bucket per SGD step for the gradients
    lanes = kw.get("aggregation") == "hierarchical"
    for c in per_rank:
        assert c["lane_combine"] == (ROUNDS if lanes else 0)
        assert c["grad"] == ROUNDS * K * STEPS
        # one sharded store gathers per round: the EF rows or scaffold's
        assert c["store_gather"] == (ROUNDS if comp or
                                     algorithm == "scaffold" else 0)
        assert c["delta_accum"] == ROUNDS * (K // shape[0] if lanes else K)
