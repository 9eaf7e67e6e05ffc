"""Pod-scale federated training driver (the counterpart of
``repro/launch/train.py``): CyclicFL's two phases on the pod backend.

``run_pod_training`` builds a P1 relay (``PodCyclicConfig``) and a P2
round phase (``PodFLConfig``) over one mesh and hands them to
``core.pipeline.run_phase_schedule``, so the pod shares the host
engine's round loop, sampling, lr schedule and in-loop evaluation.  P1
relays the full model client to client: it runs with ``dp``,
``secure_agg``, ``compression``, ``peft`` and ``trainable_filter``
stripped.  P2 draws from the seed offset by ``HOST_RNG_OFFSET_P2`` when
a P1 phase precedes it, so it does not replay P1's client and batch
draws.  The mesh defaults to the one-rank mesh on the card
(``launch.mesh.make_host_mesh``); ``device="cpu"`` runs it on the CPU.

CLI (reduced configs):

    PYTHONPATH=src python -m repro_torch.launch.train --arch \\
        tinyllama-1.1b --rounds 4 --cyclic-rounds 2 --clients 8

On a mesh of several ranks, each rank runs the CLI with ``--mesh DxM``
and its ``--rank``, the ``--world-size`` and one ``--init-method`` (a
``file://`` path or ``tcp://localhost:<port>``); it joins the process
group itself (nccl on CUDA, gloo on the CPU), and the layout
(``--layout``, default ``fsdp_tp``) shards the model's buckets over the
mesh.

The pre-sampled round bodies ``make_pod_cyclic_round`` and
``make_pod_fl_round`` (clients in order over batches sampled up front,
plain tree math) are the JAX package's per-round baseline;
``lower_pod_round`` captures one pod round as a rank runs it, on fake
tensors over a fake process group, for the compile analysis
(``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import Phase, ScheduleResult, run_phase_schedule
from repro_torch.fl.compression import CompressionSpec
from repro_torch.fl.pod import (
    POD_ALGORITHMS,
    PodCyclicConfig,
    PodFLConfig,
    PodFLSpec,
)
from repro_torch.fl.privacy import DPSpec
from repro_torch.fl.simulation import HOST_RNG_OFFSET_P2
from repro_torch.fl.task import lm_task
from repro_torch.models.transformer import (TransformerConfig, init_lm,
                                            lm_loss)
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device

Pytree = Any

__all__ = ["sample_round_batches", "sequence_loss_metric",
           "PodTrainResult", "run_pod_training", "make_pod_cyclic_round",
           "make_pod_fl_round", "lower_pod_round", "main"]


def _local_sgd(cfg: TransformerConfig, spec: PodFLSpec) -> Callable:
    """t_i SGD steps on one client's pre-sampled batches.

    ``(params, batches, lr_scale, anchor) -> (params, mean_loss)``;
    ``batches`` leaves ``(t_i, B, S)``; ``anchor`` is fedprox's anchor
    (the round's global params) or None.  Per step, in the reference's
    order: clip the raw gradient, then weight decay, then momentum; the
    FedProx term is in the loss.  The step is taken in f32 and cast to
    each leaf's dtype."""

    def loss_fn(params, mb, anchor):
        loss, _ = lm_loss(params, cfg, mb)
        if spec.algorithm == "fedprox" and anchor is not None:
            loss = loss + 0.5 * spec.mu * tm.squared_norm(tm.tree_map(
                lambda p, a: (p - a).float(), params, anchor))
        return loss

    def value_and_grad(w, mb, anchor):
        leaves, treedef = tm.tree_flatten(w)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(tm.tree_unflatten(treedef, live), mb, anchor)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), tm.tree_unflatten(treedef, list(grads))

    def run(params, batches, lr_scale, anchor):
        mom = tm.zeros_like(params) if spec.momentum else None
        step_size = spec.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
        w, losses = params, []
        for t in range(next(iter(batches.values())).shape[0]):
            loss, grads = value_and_grad(w, {k: v[t] for k, v in
                                             batches.items()}, anchor)
            if spec.grad_clip:
                grads = tm.global_clip(grads, spec.grad_clip)
            if spec.weight_decay:
                grads = tm.add_scaled(grads, w, spec.weight_decay)
            if spec.momentum:
                mom = tm.add_scaled(grads, mom, spec.momentum)
                eff = mom
            else:
                eff = grads
            w = tm.tree_map(lambda p, g: (p.float() - step_size * g.float()
                                          ).to(p.dtype), w, eff)
            losses.append(loss)
        return w, torch.stack(losses).mean()

    return run


def make_pod_cyclic_round(cfg: TransformerConfig, spec: PodFLSpec
                          ) -> Callable:
    """P1: the sequential relay over K clients (Algorithm 1, one round).

    ``(params, batches, lr_scale) -> (params, metrics)``; ``batches``
    leaves ``(K, t_i, B, S)``, client-major.  The model hops client to
    client; there is deliberately no aggregation."""
    local = _local_sgd(cfg, spec)

    def round_fn(params, batches, lr_scale):
        losses = []
        for i in range(next(iter(batches.values())).shape[0]):
            params, loss = local(params, {k: v[i] for k, v in
                                          batches.items()}, lr_scale, None)
            losses.append(loss)
        return params, {"local_loss": torch.stack(losses).mean()}

    return round_fn


def make_pod_fl_round(cfg: TransformerConfig, spec: PodFLSpec) -> Callable:
    """P2: one federated round, the clients' local runs one after another
    and their weighted delta accumulated in f32.

    ``(params, batches, weights, lr_scale) -> (params, metrics)``;
    ``batches`` leaves ``(K, t_i, B, S)``; ``weights`` ``(K,)`` the
    clients' sample counts N_i.  Client i adds ``(w_i/Σw)·(w_end − p)``
    to the accumulator, so the peak is 2×params (+ momentum) whatever K;
    the new params are ``p + delta`` cast to each leaf's dtype."""
    local = _local_sgd(cfg, spec)

    def round_fn(params, batches, weights, lr_scale):
        weights = torch.as_tensor(weights).float()
        wsum = torch.sum(weights)
        anchor = params if spec.algorithm == "fedprox" else None
        delta = tm.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        losses = []
        for i in range(weights.shape[0]):
            w_end, loss = local(params, {k: v[i] for k, v in
                                         batches.items()}, lr_scale, anchor)
            coeff = weights[i] / wsum
            delta = tm.tree_map(lambda a, we, p: a + coeff * (we - p).float(),
                                delta, w_end, params)
            losses.append(loss)
        new_params = tm.tree_map(lambda p, d: (p.float() + d).to(p.dtype),
                                 params, delta)
        return new_params, {"local_loss": torch.stack(losses).mean()}

    return round_fn


def relay_spec(spec: PodFLSpec) -> PodFLSpec:
    """P1's spec: privacy, compression and the trainable slice apply at
    the P2 aggregate only — the relay hops the full model."""
    return dataclasses.replace(spec, dp=None, secure_agg=False,
                               compression=None, peft=None,
                               trainable_filter=None)


def lower_pod_round(cfg: TransformerConfig, mesh, *, kind: str = "fl",
                    spec: Optional[PodFLSpec] = None, K: int = 8,
                    batch: int = 32, seq: int = 512,
                    layout: str = "fsdp_tp", seed: int = 0):
    """Capture one pod round on ``mesh`` as rank 0 runs it: the engine's
    round of ``PodCyclicConfig`` (``kind="cyclic"``, with
    :func:`relay_spec`, as ``run_pod_training``'s P1) or ``PodFLConfig``
    (``"fl"``) with ``spec`` at batch ``batch``, K clients of ``seq``
    tokens, ``sampling="host"``, one round in one chunk, the final
    gather of the result included — the program a real run of that
    phase issues, collective for collective.  ``mesh`` is a
    ``launch.mesh.Mesh`` over a fake process group
    (``launch.mesh.make_fake_mesh``): every tensor is fake and nothing
    is allocated.  Returns the ``hlo_analysis.StepCounter`` of the
    round: FLOPs, bytes, the pod's collectives and the kernels' work.

    The port has no SPMD partitioner: what a rank runs is the pod's
    program (``fl.pod.ShardedFlatOps``), tensor-parallel where the pod's
    step is (its ``"tp"`` collectives counted as the run counts them),
    and an MoE arch's layers dispatching over the batch group where the
    batch is split (the ``"moe"`` kind)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fl.engine import run_rounds
    from repro_torch.launch.hlo_analysis import StepCounter
    if kind not in ("cyclic", "fl"):
        raise ValueError(f"kind must be 'cyclic' or 'fl', got {kind!r}")
    spec = dataclasses.replace(spec or PodFLSpec(), batch_size=batch)
    task = lm_task(cfg)
    tokens = np.zeros((K, batch, seq), np.int32)
    data = FederatedDataset(x=tokens, y=tokens, n_real=np.full(K, batch),
                            test_x=tokens[0], test_y=tokens[0],
                            n_classes=cfg.vocab_size, name="capture")
    common = dict(rounds=1, clients_per_round=K, layout=layout, seed=seed,
                  sampling="host", chunk_size=1)
    phase = (PodCyclicConfig(mesh, spec=relay_spec(spec), **common)
             if kind == "cyclic" else PodFLConfig(mesh, spec=spec, **common))
    with FakeTensorMode(allow_non_fake_inputs=True):
        init = tm.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=mesh.device), task.shapes())
        with StepCounter() as counter:
            run_rounds(task, data, phase.strategy(), phase.schedule(),
                       init_params=init, device=mesh.device, history=False,
                       phase="P1" if kind == "cyclic" else "P2")
    return counter


def sample_round_batches(data, ids: np.ndarray, steps: int, batch: int,
                         rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """Pre-sample ``(K, steps, batch, S)`` token and label batches for the
    clients ``ids`` from the host ``rng`` (the per-round baseline; the
    engine samples on the device)."""
    toks, labs = [], []
    for cid in ids:
        bidx = rng.integers(0, data.n_per_client, size=(steps, batch))
        toks.append(data.x[cid][bidx])
        labs.append(data.y[cid][bidx])
    return {"tokens": torch.from_numpy(np.stack(toks)),
            "labels": torch.from_numpy(np.stack(labs))}


def sequence_loss_metric(cfg: TransformerConfig) -> Callable:
    """The per-sample eval metric of LM training: each sequence's mean
    next-token loss over its kept positions (label −1 ignored),
    ``metric(params, bx, by) -> (B,)``, the log-sum-exp in f32."""
    from repro_torch.models.transformer import lm_forward

    def metric(params, bx, by):
        logits, _, _ = lm_forward(params, cfg, {"tokens": bx})
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(
            by.long(), min=0)[..., None])[..., 0]
        valid = (by >= 0).float()
        per_tok = (logz - gold) * valid
        return per_tok.sum(dim=-1) / torch.clamp(valid.sum(dim=-1), min=1.0)

    return metric


@dataclasses.dataclass
class PodTrainResult:
    params: Pytree
    history: list
    # the phase schedule's result: each phase's end params and the
    # communication ledger of the run
    schedule: Optional[ScheduleResult] = None


def run_pod_training(cfg: TransformerConfig, data, *,
                     cyclic_rounds: int = 2, fl_rounds: int = 4,
                     clients_per_round: int = 4,
                     spec: Optional[PodFLSpec] = None,
                     mesh=None, seed: int = 0,
                     eval_fn: Optional[Callable] = None,
                     eval_every: Optional[int] = None,
                     eval_batch: int = 64,
                     verbose: bool = False,
                     chunk_size: int = 4,
                     sampling: str = "device",
                     layout: str = "fsdp_tp",
                     aggregation: str = "sequential",
                     n_pods: Optional[int] = None,
                     store: str = "dense",
                     store_capacity: int = 1024,
                     overlap: str = "on",
                     init_params: Optional[Pytree] = None,
                     batch_indices: Optional[Dict[str, Callable]] = None,
                     device: Device = None) -> PodTrainResult:
    """CyclicFL end to end on the pod backend: a P1 → P2 phase schedule
    through the shared round engine, on ``mesh`` (default: the one-rank
    mesh on ``device``, CUDA unless the caller asks for the CPU).

    ``eval_fn(params, bx, by) -> (B,)`` is a per-sample metric (the
    engine weights the padded eval stream with it); ``eval_every=None``
    evaluates every round when a metric is given and never otherwise,
    and evaluated rounds carry ``eval`` in their history row.
    ``init_params`` (a tree) starts P1, else ``init_lm`` seeded with
    ``seed`` on the mesh's device; ``batch_indices`` maps a phase name
    ("P1", "P2") to a ``(round, slot, step) -> (B,)`` index source in
    place of the engine's draws."""
    from repro_torch.launch.mesh import make_host_mesh
    spec = spec or PodFLSpec()
    mesh = mesh if mesh is not None else make_host_mesh(device)
    task = lm_task(cfg)
    batch_indices = batch_indices or {}
    if eval_every is None:
        eval_every = 1 if eval_fn is not None else 0
    if overlap not in ("on", "off"):
        raise ValueError(f"--overlap must be on|off, got {overlap!r}")
    if init_params is None:
        init_params = init_lm(cfg, seed, mesh.device)

    common = dict(mesh=mesh, clients_per_round=clients_per_round, spec=spec,
                  layout=layout, chunk_size=chunk_size, sampling=sampling,
                  eval_every=eval_every, eval_batch=eval_batch)
    phases = []
    if cyclic_rounds > 0:
        phases.append(Phase("P1", PodCyclicConfig(
            rounds=cyclic_rounds, seed=seed, **dict(common, spec=relay_spec(spec)),
            batch_indices=batch_indices.get("P1")), eval_fn=eval_fn))
    if fl_rounds > 0:
        # each phase restarts its streams from its own seed: offset P2's
        # so that it does not replay P1's client and batch draws
        p2_seed = seed + HOST_RNG_OFFSET_P2 if phases else seed
        phases.append(Phase("P2", PodFLConfig(
            rounds=fl_rounds, seed=p2_seed, aggregation=aggregation,
            n_pods=n_pods, store=store, store_capacity=store_capacity,
            overlap=(overlap == "on"), batch_indices=batch_indices.get("P2"),
            **common), eval_fn=eval_fn))
    if not phases:
        return PodTrainResult(params=init_params, history=[])

    sched = run_phase_schedule(task, data, phases, verbose=verbose,
                               device=mesh.device, init_params=init_params)
    history = []
    for h in sched.history:
        row = {"phase": h["phase"], "round": h["round"],
               "loss": h["local_loss"]}
        if "acc" in h:
            row["eval"] = h["acc"]
        history.append(row)
    return PodTrainResult(params=sched.params, history=history,
                          schedule=sched)


def main(argv=None) -> int:
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import make_synthetic_tokenlm

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--cyclic-rounds", type=int, default=2)
    ap.add_argument("--clients", "--n-clients", dest="clients", type=int,
                    default=16, help="population size N (synthetic shards)")
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8,
                    help="per-step local batch size B")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--algorithm", default="fedavg", choices=POD_ALGORITHMS)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--server-opt", default="none",
                    choices=("none", "momentum", "adam"),
                    help="server-side optimizer on the aggregated "
                         "pseudo-gradient (FedAvgM / FedAdam)")
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--server-momentum", type=float, default=0.9)
    ap.add_argument("--update-impl", default="fused",
                    choices=("tree", "fused", "fused_interpret"),
                    help="step tail and aggregation: the hand-written "
                         "kernels over flat buffers (fused; their plain "
                         "versions on the CPU), their plain versions "
                         "anywhere (fused_interpret), or per-leaf tree "
                         "algebra")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="test-accuracy cadence in rounds (0 = none)")
    ap.add_argument("--chunk-size", type=int, default=4,
                    help="rounds per engine dispatch")
    ap.add_argument("--sampling", default="device",
                    choices=("device", "host"))
    ap.add_argument("--layout", default="fsdp_tp", choices=rules.LAYOUTS)
    ap.add_argument("--aggregation", default="sequential",
                    choices=("sequential", "hierarchical"))
    ap.add_argument("--n-pods", type=int, default=None,
                    help="pod count for --aggregation hierarchical "
                         "(must divide clients-per-round)")
    ap.add_argument("--store", default="dense", choices=("dense", "sparse"))
    ap.add_argument("--store-capacity", type=int, default=1024)
    ap.add_argument("--overlap", default="on", choices=("on", "off"))
    ap.add_argument("--dp-clip", type=float, default=None,
                    help="DP-FedAvg per-client delta clip bound C")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="DP-FedAvg noise multiplier (needs --dp-clip)")
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--compress-bits", type=int, default=32,
                    choices=(8, 16, 32))
    ap.add_argument("--compress-density", type=float, default=1.0)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--peft", default=None, metavar="lora:<r>",
                    help="build the model with rank-r LoRA adapters and "
                         "train only them in P2 (P1 relays the full "
                         "model)")
    ap.add_argument("--trainable-filter", default=None,
                    choices=sorted(rules.TRAINABLE_FILTERS),
                    help="named trainable-leaf filter (overrides the one "
                         "--peft implies); needs a fused --update-impl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the mesh's device: CUDA by default, or cpu")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh over --world-size ranks "
                         "(default: the one-rank mesh)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--init-method", default=None,
                    help="the process group's rendezvous: file:///path "
                         "or tcp://localhost:<port>")
    args = ap.parse_args(argv)

    cfg = with_peft(get_reduced(args.arch), args.peft)
    if cfg.input_mode != "tokens":
        print(f"[train] {args.arch}: pod driver trains token-mode archs; "
              f"{cfg.input_mode}-mode archs train via the same round fns "
              "with embedding batches (see examples/)", file=sys.stderr)
        return 2
    data = make_synthetic_tokenlm(
        n_clients=args.clients, seq_len=args.seq, n_seq_per_client=64,
        vocab=cfg.vocab_size, beta=0.5, seed=args.seed)
    dp = (DPSpec(args.dp_clip, args.dp_sigma)
          if args.dp_clip is not None else None)
    comp = CompressionSpec(bits=args.compress_bits,
                           density=args.compress_density,
                           error_feedback=args.error_feedback)
    spec = PodFLSpec(local_steps=args.local_steps, batch_size=args.batch,
                     lr=args.lr, algorithm=args.algorithm,
                     server_opt=args.server_opt, server_lr=args.server_lr,
                     server_momentum=args.server_momentum,
                     update_impl=args.update_impl, dp=dp,
                     secure_agg=args.secure_agg,
                     compression=None if comp.identity else comp,
                     peft=args.peft, trainable_filter=args.trainable_filter)
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import destroy, make_mesh
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        if args.world_size > 1:
            import torch.distributed as dist
            cuda = resolve_device(args.device).type == "cuda"
            dist.init_process_group("nccl" if cuda else "gloo",
                                    init_method=args.init_method,
                                    world_size=args.world_size,
                                    rank=args.rank)
        mesh = make_mesh(shape, ("data", "model"), args.device)
    t0 = time.time()
    res = run_pod_training(
        cfg, data, cyclic_rounds=args.cyclic_rounds, fl_rounds=args.rounds,
        clients_per_round=args.clients_per_round, spec=spec,
        seed=args.seed, verbose=args.rank == 0, chunk_size=args.chunk_size,
        eval_every=args.eval_every, sampling=args.sampling,
        layout=args.layout, aggregation=args.aggregation,
        n_pods=args.n_pods, store=args.store,
        store_capacity=args.store_capacity, overlap=args.overlap,
        mesh=mesh, device=args.device)
    first, last = res.history[0]["loss"], res.history[-1]["loss"]
    if args.rank == 0:
        print(f"[train] {args.arch}: loss {first:.4f} -> {last:.4f} "
              f"({time.time() - t0:.1f}s)")
    if mesh is not None:
        destroy()
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
