"""Multi-pod dry run: the per-rank work of every arch × shape on the
production meshes (the counterpart of ``repro/launch/dryrun.py``).

For every (architecture × input shape) pair, capture the step a rank of
the 16×16 single-pod mesh or the 2×16×16 multi-pod mesh runs, on fake
tensors over a fake process group (``launch.mesh.make_fake_mesh`` of
the production mesh's shape: nothing is allocated, no collective moves
data),
and read its roofline terms (``launch.hlo_analysis``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # single pod, all pairs
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # the pod axis

Rows are written as JSON to ``experiments/dryrun_torch/<stem>.json``.

The port has no SPMD partitioner, so the program captured is the pod's
(``fl.pod.ShardedFlatOps``): the rank holds its rows of the params (and
of the f32 momentum for train) as ``rules.param_pspecs`` shards them
under ``--layout``; the leaves are all-gathered through the pod's own
collectives — whole, or under ``fsdp_tp`` for every arch whose plan
splits a part the model-local tree of a tensor-parallel step
(``sharding.tensor_parallel``, ``"tp_compute": true`` in the row); the
step
(``make_train_step``, ``make_prefill_step`` or ``make_serve_step``) runs
on the rank's rows of the batch and cache, split over the pod's batch
group (pod, data) as ``rules.batch_pspecs`` and ``rules.cache_pspecs``
place them (a dim they shard otherwise — the cache's ``model`` dim — is
held sharded and gathered whole before the step); for train the
gradient is reduce-scattered back to the rows and all-reduced over the
batch group.  A tensor-parallel step splits the heads (GQA or MLA),
the MLP, the experts, the SSM heads and the vocabulary (of every
codebook) over ``model`` as XLA's partitioner does, and a GQA decode
cache keeps the kv heads the rank reads, an SSM state its heads and
conv channels (MLA's latent cache stays whole).  A train step's MoE layer
dispatches over the batch group, whose whole batch sets its capacity;
its expert GEMMs run on the rank's share of the slots
(``models.layers.moe``).  Where
the step gathers whole leaves, the ``model`` axis splits no compute:
every rank of a ``model`` group computes the same batch rows, so
``useful_flops_ratio`` falls by the ``model`` size against an SPMD
program.

No scan correction: the capture runs every layer eagerly, so the JAX
package's 1-/2-layer extrapolation (XLA counts a scanned body once) has
nothing to correct; ``--no-correct-scan`` is accepted and changes
nothing.

The fake process group needs a process of its own: run this module as a
program, not from a process that holds another group.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch.configs import (
    ASSIGNED, SHAPES, active_param_count, batch_specs, get_config,
    get_reduced, list_archs, param_count, params_specs, shape_applicable,
)
from repro_torch.fl import pod
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.hlo_analysis import StepCounter, analyze_captured
from repro_torch.launch.steps import (
    TrainSpec, make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.models.ssm import local_channels
from repro_torch.models.transformer import lm_loss
from repro_torch.sharding import rules, tensor_parallel
from repro_torch.sharding.batch_group import batch_group
from repro_torch.sharding.tensor_parallel import context_of
from repro_torch.utils import tree_math as tm

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode D = B·1."""
    n = active_param_count(cfg) if cfg.is_moe else param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _rank_leaf(spec: tm.Pytree, meta: torch.Tensor, mesh, batch: int):
    """This rank's part of a batch or cache leaf under ``spec``: its batch
    dim split over the batch group's axes of the spec, every other
    sharded dim held as a block and gathered whole before the step.
    Returns ``(local, dims)``: a fake tensor, and ``[(dim, axes)]`` to
    gather."""
    baxes = set(rules.batch_axes(mesh))
    shape, gathers = list(meta.shape), []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        shape[d] //= math.prod(mesh.axis_size(a) for a in axes)
        if not (set(axes) <= baxes and meta.shape[d] == batch):
            gathers.append((d, axes))
    return torch.zeros(shape, dtype=meta.dtype), gathers


def _rank_tree(tree, specs, mesh, batch: int, local=None):
    """The rank's leaves of ``tree`` (meta) under ``specs``, and a
    function that gathers each held block whole through the pod's
    all-gather (run inside the capture: the gathers are the step's).
    ``local(path, leaf)`` (see :func:`_cache_local`) then takes a whole
    leaf's part the rank computes with, after the gather."""
    leaves, treedef = tm.tree_flatten(tree)
    spec_leaves = tm.tree_flatten(specs, is_leaf=rules.is_pspec)[0]
    paths = tm.tree_paths(tree)
    held = [_rank_leaf(s, t, mesh, batch)
            for s, t in zip(spec_leaves, leaves)]

    def whole():
        out = []
        for path, (leaf, gathers) in zip(paths, held):
            for d, axes in gathers:
                leaf = pod.gather_dim(leaf, mesh, axes, d)
            out.append(leaf if local is None else local(path, leaf))
        return tm.tree_unflatten(treedef, out)
    return whole


def _cache_local(cfg, tp):
    """Under a ``tp`` that splits the heads, a GQA kv cache leaf ``(...,
    KH, hd)`` keeps the kv heads this rank reads, and where it splits the
    SSM heads the SSM state ``(..., h, p, n)`` and conv history
    ``(..., conv_dim)`` keep the rank's heads and channels, each taken
    from the gathered whole leaf (``rules.cache_pspecs`` shards the
    cache's largest dim it divides over ``model``, not its heads);
    MLA's latent cache stays whole.  None without a ``tp``."""
    if tp is None:
        return None
    scfg = cfg.ssm_cfg() if cfg.has_ssm else None

    def local(path, t):
        if tp.plan.attn and cfg.attention != "mla" and "kv/" in path:
            return t.narrow(t.dim() - 2, *tp.kv_range)
        if tp.plan.ssm and "ssm/" in path:
            if path.endswith("/0"):
                return t.narrow(t.dim() - 3, *tp.ssm_range)
            return local_channels(t, scfg, tp)
        return t
    return local


def _row_value_and_grad(fops: pod.ShardedFlatOps, group=None):
    """``value_and_grad`` over this rank's rows of the flat buckets: the
    loss on the gathered whole leaves (an MoE layer dispatching over the
    batch group ``group``), the gradient back to the rows through the
    gather's backward (``ShardedFlatOps._row_grad``), the replicated
    buckets averaged over the batch group."""

    def value_and_grad(cfg, rows: Dict[str, torch.Tensor], batch):
        leaves, treedef = tm.tree_flatten(rows)
        live = [r.detach().requires_grad_(True) for r in leaves]
        with torch.enable_grad():
            tree = fops.unflatten(tm.tree_unflatten(treedef, live))
            loss, _ = lm_loss(tree, cfg, batch, tp=context_of(tree),
                              group=group)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = {name: torch.zeros_like(r) if g is None else g
                 for name, r, g in zip(sorted(rows), live, grads)}
        pod.batch_mean_([g for name, g in grads.items()
                         if name not in fops.row_reduced], fops.mesh)
        return loss.detach(), [grads[name] for name in sorted(rows)]

    return value_and_grad


def build_lowered(cfg, shape, mesh, *, n_micro: int = 1,
                  layout: str = "fsdp_tp") -> StepCounter:
    """Capture the step rank 0 runs for (cfg, shape) on ``mesh`` (a Mesh
    over a fake process group) and return its counts (a capture here,
    not a lowering: it runs the program once on fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    p_specs = params_specs(cfg)
    sharded = rules.sharded_flat_view(p_specs, mesh, layout)
    tp = (tensor_parallel.context(cfg, mesh) if layout == "fsdp_tp"
          else None)
    fops = pod.ShardedFlatOps(view=sharded.local_view(), interpret=False,
                              device=mesh.device, sharded=sharded,
                              mesh=mesh, split_batch=True, tp=tp)
    tree = fops.unflatten if tp is None else fops.tp_tree
    b_specs = batch_specs(cfg, shape)
    B = shape.global_batch
    with FakeTensorMode(allow_non_fake_inputs=True):
        rows = fops.zeros()
        if shape.kind == "train":
            mom = fops.zeros(torch.float32)
            batch = _rank_tree(b_specs, rules.batch_pspecs(b_specs, mesh),
                               mesh, B)
            step = make_train_step(cfg, TrainSpec(n_micro=n_micro),
                                   _row_value_and_grad(
                                       fops, batch_group(mesh)
                                       if cfg.is_moe else None))
            with StepCounter() as counter:
                step(rows, mom, batch())
            return counter
        if shape.kind == "prefill":
            batch = _rank_tree(b_specs, rules.batch_pspecs(b_specs, mesh),
                               mesh, B)
            step = make_prefill_step(cfg, max_len=shape.seq_len)
            with torch.no_grad(), StepCounter() as counter:
                step(tree(rows), batch())
            return counter
        tok = _rank_tree(b_specs["token"],
                         rules.batch_pspecs(b_specs["token"], mesh), mesh, B)
        cache = _rank_tree(b_specs["cache"], rules.cache_pspecs(
            b_specs["cache"], mesh, B), mesh, B, _cache_local(cfg, tp))
        step = make_serve_step(cfg)
        with torch.no_grad(), StepCounter() as counter:
            step(tree(rows), tok(), cache(), shape.seq_len - 1)
        return counter


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             n_micro: int = 1, verbose: bool = True, save: bool = True,
             cfg_override=None, correct_scan: bool = True,
             layout: str = "fsdp_tp", tag: str = "",
             out_dir: pathlib.Path = OUT_DIR) -> dict:
    """One pair's row (``correct_scan`` is accepted and changes nothing:
    see the module doc)."""
    del correct_scan
    shape = SHAPES[shape_name]
    cfg = cfg_override or get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_chips = 512 if multi_pod else 256
    t0 = time.time()
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "layout": layout}
    spec = meshlib.MULTI_POD if multi_pod else meshlib.SINGLE_POD
    # tensor-parallel compute over model (fsdp_tp, where the arch's plan
    # splits a part), or the pod's gather-then-compute
    row["tp_compute"] = layout == "fsdp_tp" and tensor_parallel.plan(
        cfg, dict(zip(spec.axes, spec.shape))[rules.MODEL]) is not None
    try:
        mesh = meshlib.make_fake_mesh(spec.shape, spec.axes)
        counter = build_lowered(cfg, shape, mesh, n_micro=n_micro,
                                layout=layout)
        t_capture = time.time() - t0
        terms = analyze_captured(
            counter, arch=arch, shape=shape_name, mesh_name=mesh_name,
            n_chips=n_chips, model_flops=model_flops_estimate(cfg, shape))
        row.update(terms.to_dict())
        row.update(ok=True, kernels=counter.kernels,
                   t_capture_s=round(t_capture, 1))
        if verbose:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:8s} OK  "
                  f"flops={terms.hlo_flops:.3e} bytes={terms.hlo_bytes:.3e} "
                  f"coll={terms.collective_bytes:.3e}B "
                  f"bottleneck={terms.bottleneck} "
                  f"(capture {t_capture:.0f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        row["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:8s} FAIL "
                  f"{row['error'][:200]}", flush=True)
            traceback.print_exc()
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{arch}_{shape_name}_{mesh_name}".replace("/", "-")
        if tag:
            stem += f"_{tag}"
        (out_dir / f"{stem}.json").write_text(json.dumps(row, indent=1))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id (see --list)")
    ap.add_argument("--shape", default=None, nargs="+", choices=list(SHAPES),
                    help="one input shape, or several")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable (arch × shape) pair")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2×16×16 pod-axis mesh (512 ranks)")
    ap.add_argument("--n-micro", type=int, default=1,
                    help="gradient-accumulation microbatches for train shapes")
    ap.add_argument("--layout", default="fsdp_tp",
                    choices=("fsdp_tp", "fsdp_only"),
                    help="parameter layout")
    ap.add_argument("--no-correct-scan", action="store_true",
                    help="accepted for the JAX CLI's sake: the capture "
                         "runs every layer, there is nothing to correct")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (a quick check)")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="the directory the rows are written to")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a)
        return 0

    if args.all:
        pairs = [(arch, s) for arch in ASSIGNED for s in SHAPES
                 if shape_applicable(arch, s)]
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        pairs = [(args.arch, s) for s in args.shape]

    failures = 0
    for arch, s in pairs:
        row = run_pair(arch, s, multi_pod=args.multi_pod,
                       n_micro=args.n_micro, layout=args.layout,
                       correct_scan=not args.no_correct_scan, tag=args.tag,
                       cfg_override=get_reduced(arch) if args.reduced
                       else None, out_dir=pathlib.Path(args.out))
        failures += 0 if row["ok"] else 1
    print(f"[dryrun] {len(pairs) - failures}/{len(pairs)} pairs OK")
    meshlib.destroy()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
