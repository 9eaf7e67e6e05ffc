"""The compile analysis (``repro_torch.launch.dryrun``,
``launch.hlo_analysis``, the configs' specs, the batch and cache
partition rules) and the pre-sampled pod rounds of
``repro_torch.launch.train`` against the JAX package's, on the CPU.

  * the configs: ``param_count`` and ``active_param_count`` of every
    assigned arch at full width, exactly; ``batch_specs`` of every
    applicable (arch × shape) pair, key for key, shape and dtype;
    ``ASSIGNED``, ``LONG_CONTEXT_OK`` and ``shape_applicable``;
  * ``batch_pspecs`` (both layouts) and ``cache_pspecs`` on stand-in
    16×16 and 2×16×16 meshes, spec for spec;
  * ``model_flops_estimate`` against the closed form from the JAX
    package's counts (``repro.launch.dryrun`` is not imported: it sets
    ``XLA_FLAGS`` to 512 devices at import);
  * ``RooflineTerms`` with the H100's constants;
  * the counter: the FLOPs of a reduced tinyllama-1.1b and a reduced
    deepseek-v2-lite-16b train step equal the closed form exactly, and
    a capture on fake tensors equals the real run in FLOPs and bytes;
    a kernel wrapper counts its kernel's work, not its plain version's;
  * ``make_pod_cyclic_round`` and ``make_pod_fl_round`` on the reduced
    tinyllama-1.1b against the JAX functions on the same numpy-seeded
    batches, params carried by the bridge (FedProx with momentum, decay
    and a binding clip included): losses rtol 1e-5, params atol 2e-5;
  * the CLI in a subprocess (the fake process group needs a process of
    its own): a reduced arch at one shape of each kind.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
import repro.configs as jconfigs
from repro.launch import train as jtrain
from repro.sharding import rules as jrules
import repro_torch.configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import fused_update as fu
from repro_torch.launch import train
from repro_torch.launch.dryrun import model_flops_estimate
from repro_torch.launch.hlo_analysis import RooflineTerms, StepCounter
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.steps import TrainSpec, init_momentum, make_train_step
from repro_torch.models.transformer import init_lm
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm

ROOT = Path(__file__).resolve().parent.parent
ATOL = 2e-5


def _pairs(arch):
    return [s for s in jconfigs.SHAPES if jconfigs.shape_applicable(arch, s)]


def _spec_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _jax_pspec_leaves(tree):
    return [_spec_tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _torch_pspec_leaves(tree):
    return [_spec_tuple(s) for s in tm.tree_flatten(
        tree, is_leaf=rules.is_pspec)[0]]


class _StandIn:
    """What the JAX rules read of a mesh: axis names and a device array."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.zeros(mesh.devices.shape)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

def test_assigned_and_long_context_match():
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for arch in tconfigs.list_archs():
        for s in tconfigs.SHAPES:
            assert tconfigs.shape_applicable(arch, s) == \
                jconfigs.shape_applicable(arch, s)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_param_counts_match(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tconfigs.param_count(tc) == jconfigs.param_count(jc)
    assert tconfigs.active_param_count(tc) == jconfigs.active_param_count(jc)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_batch_specs_match(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for s in _pairs(arch):
        want = jconfigs.batch_specs(jc, jconfigs.SHAPES[s])
        got = tconfigs.batch_specs(tc, tconfigs.SHAPES[s])
        assert sorted(got) == sorted(want), s
        jl = jax.tree_util.tree_leaves(want)
        tl = tm.tree_leaves(got)
        assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
        assert [str(x.dtype).replace("torch.", "") for x in tl] == \
            [str(x.dtype) for x in jl]
        assert all(x.device.type == "meta" for x in tl)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b",
                                  "hymba-1.5b", "mamba2-1.3b",
                                  "musicgen-medium"])
def test_batch_and_cache_pspecs_match(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    stand_in = _StandIn(mesh)
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for s in _pairs(arch):
        shape = tconfigs.SHAPES[s]
        jb = jconfigs.batch_specs(jc, jconfigs.SHAPES[s])
        tb = tconfigs.batch_specs(tc, shape)
        for layout in ("fsdp_tp", "fsdp_only"):
            assert _torch_pspec_leaves(rules.batch_pspecs(tb, mesh, layout)) \
                == _jax_pspec_leaves(jrules.batch_pspecs(jb, stand_in,
                                                         layout)), (s, layout)
        if shape.kind == "decode":
            B = shape.global_batch
            assert _torch_pspec_leaves(rules.cache_pspecs(
                tb["cache"], mesh, B)) == _jax_pspec_leaves(
                jrules.cache_pspecs(jb["cache"], stand_in, B)), s


def test_production_mesh_and_card_constants():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.devices.shape == (16, 16)
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert rules.batch_axes(mp) == ("pod", "data")
    assert rules.batch_axes(mp, "fsdp_only") == ("pod", "data", "model")
    # the H100 SXM's rates, as chip_smoke.py's _PEAKS
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_model_flops_estimate_is_the_closed_form(arch):
    jc = jconfigs.get_config(arch)
    n = (jconfigs.active_param_count(jc) if jc.is_moe
         else jconfigs.param_count(jc))
    for s in _pairs(arch):
        sh = jconfigs.SHAPES[s]
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        want = (6.0 if sh.kind == "train" else 2.0) * n * tokens
        assert model_flops_estimate(tconfigs.get_config(arch),
                                    tconfigs.SHAPES[s]) == want


def test_roofline_terms_on_the_card():
    t = RooflineTerms(arch="a", shape="s", mesh="m", n_chips=256,
                      hlo_flops=989e12,            # exactly 1 s of compute
                      hlo_bytes=3.35e12 * 2,       # 2 s of memory
                      collective_bytes=int(450e9 * 3),  # 3 s of NVLink
                      collective_detail={"gather": int(450e9 * 3),
                                         "_counts": {"gather": 1}},
                      model_flops=989e12 * 256)
    assert abs(t.t_compute - 1.0) < 1e-9
    assert abs(t.t_memory - 2.0) < 1e-9
    assert abs(t.t_collective - 3.0) < 1e-9
    assert t.bottleneck == "collective"
    np.testing.assert_allclose(t.useful_flops_ratio, 1.0)
    d = t.to_dict()
    assert d["bottleneck"] == "collective"
    assert d["collective_detail"] == {"gather": int(450e9 * 3)}
    assert d["collective_counts"] == {"gather": 1}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _closed_form_train_flops(cfg, B, S):
    """The matmul FLOPs of one train step: 3 × the forward (the backward
    takes a product for each operand) of every linear weight (the tied
    or untied head included, the embedding gather not), the attention's
    full S² products, and the MoE's capacity-padded expert GEMMs."""
    p = init_lm(cfg, device="meta")
    lin = experts = 0
    for path, t in zip(tm.tree_paths(p), tm.tree_leaves(p)):
        if path == "embed" and not cfg.tie_embeddings:
            continue
        if "experts" in path:
            experts += t.numel()
        elif path.endswith("/w") or path in ("lm_head", "embed"):
            lin += t.numel()
    flops = 6 * B * S * lin
    if cfg.attention == "mla":
        flops += 6 * cfg.n_layers * B * cfg.n_heads * S * S * (
            cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
    else:
        flops += 12 * cfg.n_layers * B * S * S * cfg.n_heads * \
            cfg.resolved_head_dim
    if cfg.is_moe:
        C = max(math.ceil(cfg.top_k * B * S / cfg.n_experts
                          * cfg.capacity_factor), 1)
        flops += 6 * C * experts
    return flops


def _count_train_step(cfg, B, S, fake: bool):
    step = make_train_step(cfg, TrainSpec())
    if not fake:
        params = init_lm(cfg, 0, "cpu")
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        mom = init_momentum(params)
        with StepCounter() as c:
            step(params, mom, batch)
        return c
    with FakeTensorMode():
        params = tm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                             tconfigs.params_specs(cfg))
        batch = {k: torch.empty((B, S), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        mom = init_momentum(params)
        with StepCounter() as c:
            step(params, mom, batch)
    return c


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b"])
def test_train_step_flops_are_the_closed_form(arch):
    cfg = tconfigs.get_reduced(arch)
    B, S = 2, 16
    real = _count_train_step(cfg, B, S, fake=False)
    assert real.flops == _closed_form_train_flops(cfg, B, S)
    fake = _count_train_step(cfg, B, S, fake=True)
    assert fake.flops == real.flops
    assert real.collectives == dict.fromkeys(real.collectives, 0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b",
                                  "hymba-1.5b", "mamba2-1.3b"])
def test_capture_equals_the_real_run(arch):
    """FLOPs and bytes of a capture on fake tensors equal a real run's
    (the dense, SSM and hybrid archs: MLA's in-place logits take another
    path through autograd on fake tensors, see ROADMAP.md §3)."""
    cfg = tconfigs.get_reduced(arch)
    real = _count_train_step(cfg, 2, 16, fake=False)
    fake = _count_train_step(cfg, 2, 16, fake=True)
    assert (fake.flops, fake.bytes) == (real.flops, real.bytes)
    assert real.bytes > 0


def test_kernel_wrappers_count_their_kernels_work():
    """A wrapper adds its kernel's operations and bytes once and nothing
    of the plain version it runs on the CPU; with no counter it only
    forwards the call."""
    n = 4096
    p, g = torch.randn(n), torch.randn(n)
    sc = torch.tensor([1.0, 0.1])
    with StepCounter() as c:
        fu.local_step(p, g, None, None, sc)
    assert c.kernels == {"local_step": {"calls": 1, "ops": 3 * n,
                                        "bytes": 12 * n + 8}}
    assert (c.flops, c.bytes) == (3 * n, 12 * n + 8)
    d = torch.randn(n)
    with StepCounter() as c:
        fu.topk_compress(d, n // 4, bits=8, with_residual=True)
    assert c.kernels["topk_compress"]["calls"] == 1
    assert set(c.kernels) == {"topk_compress"}       # nested: its own
    assert c.bytes == 4 * n + 8 * n + 4
    fu.local_step(p, g, None, None, sc)              # no counter: no error


# ---------------------------------------------------------------------------
# the pre-sampled pod rounds
# ---------------------------------------------------------------------------

ROUND_CASES = {
    "cyclic": dict(kind="cyclic"),
    "cyclic-momentum-clip": dict(kind="cyclic", momentum=0.9, grad_clip=0.5),
    "fl": dict(kind="fl"),
    "fl-fedprox-momentum-decay-clip": dict(
        kind="fl", algorithm="fedprox", mu=0.1, momentum=0.9,
        weight_decay=1e-3, grad_clip=0.5),
}


@pytest.mark.parametrize("case", ROUND_CASES)
def test_pod_rounds_match_jax(case):
    kw = dict(ROUND_CASES[case])
    kind = kw.pop("kind")
    arch, K, steps, B, S, seed = "tinyllama-1.1b", 2, 2, 3, 8, 0
    jcfg = jconfigs.get_reduced(arch)
    tcfg = tconfigs.get_reduced(arch)
    common = dict(local_steps=steps, batch_size=B, lr=0.05, **kw)
    jspec = jtrain.PodFLSpec(**common)
    tspec = train.PodFLSpec(**common)
    from repro.models.transformer import init_lm as jinit
    jparams = jinit(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (K, steps, B, S + 1))
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32)}
    if kw.get("grad_clip"):     # the clip binds at the first step
        from repro_torch.launch.steps import _value_and_grad
        _, g0 = _value_and_grad(tcfg, tparams, {
            k: torch.from_numpy(v[0, 0]) for k, v in batches.items()})
        assert float(tm.norm(g0)) > kw["grad_clip"]
    lr_scale = np.float32(0.9)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    jb = {k: jnp.asarray(v) for k, v in batches.items()}
    if kind == "cyclic":
        want, wm = jax.jit(jtrain.make_pod_cyclic_round(jcfg, jspec))(
            jparams, jb, jnp.float32(lr_scale))
        got, gm = train.make_pod_cyclic_round(tcfg, tspec)(
            tparams, tb, torch.tensor(lr_scale))
    else:
        w = np.array([3.0, 5.0], np.float32)
        want, wm = jax.jit(jtrain.make_pod_fl_round(jcfg, jspec))(
            jparams, jb, jnp.asarray(w), jnp.float32(lr_scale))
        got, gm = train.make_pod_fl_round(tcfg, tspec)(
            tparams, tb, torch.from_numpy(w), torch.tensor(lr_scale))
    np.testing.assert_allclose(float(gm["local_loss"]),
                               float(wm["local_loss"]), rtol=1e-5)
    jl = jax.tree_util.tree_leaves(want)
    tl = tm.tree_leaves(got)
    assert len(jl) == len(tl)
    moved = 0
    for a, b, p0 in zip(tl, jl, tm.tree_leaves(tparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)
        moved += int(not torch.equal(a, p0))
    assert moved > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_runs_a_reduced_arch(tmp_path):
    """One shape of each kind (train, prefill, decode) on the reduced
    qwen1.5-0.5b, in a process of its own; every row is ok and holds the
    terms."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--reduced", "--shape", "train_4k", "prefill_32k",
         "decode_32k", "--no-correct-scan", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "3/3 pairs OK" in proc.stdout
    rows = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(rows) == 3
    for row in rows:
        assert row["ok"] and row["mesh"] == "16x16" and row["n_chips"] == 256
        assert row["hlo_flops_per_chip"] > 0 and row["hlo_bytes_per_chip"] > 0
        assert row["collective_counts"]["gather"] > 0
        assert row["bottleneck"] in ("compute", "memory", "collective")
    train_row = next(r for r in rows if r["shape"] == "train_4k")
    assert train_row["collective_counts"]["grad"] > 0


# ---------------------------------------------------------------------------
# per-rank FLOPs against XLA's SPMD partitioner
# ---------------------------------------------------------------------------

TP_ARCHS = ("qwen1.5-0.5b", "tinyllama-1.1b", "deepseek-v2-lite-16b",
            "deepseek-v3-671b", "internvl2-1b", "musicgen-medium",
            "mamba2-1.3b", "hymba-1.5b")
TP_MESHES = ((1, 1), (2, 2), (1, 4))
TP_B, TP_S = 8, 16
# below XLA's count: on (2, 2) XLA computes the reduced mamba2-1.3b's
# in_proj weight gradient for all 1,104 of its columns on both model
# ranks of a data row (its HLO: a [1104, 64] x [64, 128] dot per layer,
# 0.862 read); the port computes each rank's columns, a quarter of the
# one-rank step's FLOPs, which the test then holds to 1%
TP_LOW = {("mamba2-1.3b", (2, 2)): 0.85}

# each side in a process of its own: the JAX side on 4 fake CPU devices
# (the backend comes up before repro.launch.dryrun sets its 512), the
# port's over a fake process group
_XLA_FLOPS = """
import dataclasses, json, sys
import jax
jax.devices()
import numpy as np
from repro.configs import get_reduced
from repro.configs.common import ShapeSpec
from repro.launch.dryrun import build_lowered
from repro.launch.mesh import _make_mesh
archs, meshes, (B, S) = json.loads(sys.argv[1])
out = {}
for arch in archs:
    cfg = dataclasses.replace(get_reduced(arch), scan_unroll=True)
    for shape in meshes:
        mesh = (jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                  ("data", "model")) if shape == [1, 1]
                else _make_mesh(tuple(shape), ("data", "model")))
        cost = build_lowered(cfg, ShapeSpec("t", "train", S, B),
                             mesh).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[f"{arch}/{shape}"] = float(cost["flops"])
print(json.dumps(out))
"""

_PORT_FLOPS = """
import json, sys
from repro_torch.configs import get_reduced
from repro_torch.configs.common import ShapeSpec
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.dryrun import build_lowered
archs, meshes, (B, S) = json.loads(sys.argv[1])
out = {}
for arch in archs:
    for shape in meshes:
        mesh = meshlib.make_fake_mesh(shape, ("data", "model"))
        c = build_lowered(get_reduced(arch), ShapeSpec("t", "train", S, B),
                          mesh)
        out[f"{arch}/{shape}"] = float(c.flops)
meshlib.destroy()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tp_flops():
    """Per-rank FLOPs of the reduced train step (8 × 16, ``fsdp_tp``):
    XLA's per-device ``cost_analysis`` (layer scan unrolled) and the
    port's capture, on each mesh of TP_MESHES."""
    arg = json.dumps([TP_ARCHS, TP_MESHES, [TP_B, TP_S]])
    src = str(ROOT / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, arg], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=dict(env, **extra))
        for code, extra in (
            (_XLA_FLOPS, {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                          "--xla_force_host_platform_device_count=4"}),
            (_PORT_FLOPS, {}))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES)
def test_per_rank_flops_match_xla_spmd(tp_flops, arch, shape):
    """A rank of a (data, model) mesh computes its share of the step as
    XLA's partitioner splits it: its batch rows over ``data``, its heads
    (GQA or MLA), MLP columns, experts, SSM heads and vocabulary (of
    every codebook) over ``model`` (the 2 kv heads of the reduced
    tinyllama and internvl2 on 4 ranks from the rank's columns of the kv
    projections), an MoE layer's expert GEMMs on its share of the
    batch's slots, within 10% of XLA's per-device FLOPs (XLA also counts
    elementwise FLOPs; the port's counter counts the matmul class), or
    at TP_LOW's bound an ideal quarter of the one-rank step."""
    xla, port = tp_flops
    key = f"{arch}/{list(shape)}"
    low = TP_LOW.get((arch, tuple(shape)), 0.9)
    assert low <= port[key] / xla[key] <= 1.1, (port[key], xla[key])
    if low < 0.9:       # the port's share is then the ideal quarter
        whole = port[f"{arch}/[1, 1]"]
        assert abs(port[key] * 4 / whole - 1) <= 0.01, (port[key], whole)


# the plans of the assigned archs on 16 model ranks (attn, kv, mlp, vocab,
# experts, ssm, kv_cols)
TP_PLANS_16 = {
    "qwen3-32b": (True, False, True, True, False, False, True),
    "qwen1.5-0.5b": (True, True, True, True, False, False, False),
    "qwen2-1.5b": (False, False, True, True, False, False, False),
    "tinyllama-1.1b": (True, False, True, True, False, False, True),
    "deepseek-v2-lite-16b": (True, True, True, True, True, False, False),
    "deepseek-v3-671b": (True, True, True, True, True, False, False),
    "internvl2-1b": (False, False, True, False, False, False, False),
    "musicgen-medium": (False, False, True, True, False, False, False),
    "mamba2-1.3b": (False, False, False, False, False, True, False),
    "hymba-1.5b": (False, False, True, False, False, False, False)}


@pytest.mark.parametrize("arch", tconfigs.ASSIGNED)
def test_tensor_parallel_plans_on_the_pod(arch):
    """On the 16×16 pod's ``model`` axis: qwen2-1.5b's 12 heads stay
    whole, tinyllama-1.1b's 4 and qwen3-32b's 8 kv heads do not split
    (each rank computes its columns of the kv projections and gathers
    them), the MLP and the vocabulary split everywhere they divide; the
    deepseek archs split their MLA heads (the latent whole), their
    dense-FFN prefix, their experts (4 and 16 a rank) and the
    vocabulary; internvl2-1b (14 heads, 151,655 words) and hymba-1.5b
    (25 heads, 50 SSM heads, 32,001 words) split their MLP only;
    musicgen-medium its MLP and a quarter of a codebook a rank;
    mamba2-1.3b its 64 SSM heads (4 a rank).  One rank never has a
    plan."""
    from repro_torch.sharding.tensor_parallel import plan
    cfg = tconfigs.get_config(arch)
    p = plan(cfg, 16)
    assert (p.attn, p.kv, p.mlp, p.vocab, p.experts, p.ssm, p.kv_cols) == \
        TP_PLANS_16[arch]
    assert plan(cfg, 1) is None
