"""One rank of the sharded four-rank pod runs of
``tests/test_torch_pod_sharded.py`` (not a test module).

    python tests/torch_pod_sharded_worker.py CFG.json RANK WORLD file:///path/store

Joins a gloo process group over the ``file://`` store, then for every
case of the config builds its mesh and runs the reduced LM (the case's
``arch``, else the config's; with ``lora:4`` adapters when the case
names ``peft``) from the given init params on the given batch indices:
through ``run_pod_training`` (kind "train": P2 only), the P1 relay
(kind "relay"), P2 rounds (kind "rounds") or the relay then P2 rounds
from its end (kind "p1p2"), at the case's ``capacity_factor``,
``update_impl`` (default "fused") and ``spec`` fields when it names
them; with ``"control"`` the SSM's gated norm sums its Σx² through
``reduce_from_model`` (an identity backward) in place of
``sum_over_model``.  Kind "vocab" holds the
vocabulary-parallel embedding and cross-entropy (tied embedding, ignore
labels) against the whole-vocabulary functions on the case's mesh and
writes their largest differences; kind "xent" the codebook
cross-entropy (``n_codebooks`` 1, 2 and 4) against ``_xent``; kind
"serve" holds the case's arch's tensor-parallel prefill and decode
against the whole model's; kind "steps" ``launch.steps.make_train_step``
on the model-local tree against the whole tree's (with ``"control"``
also under the planted norm fault).  Rank 0
writes the final params, the losses and the eval accuracies; every rank
writes its rows of scaffold's ``c`` and of the error-feedback store, its
collective counts and bytes, its K1/K6/K3 call counts, DP's clip scales,
each step's global gradient norm, the bytes of the buffers it carried
(``EngineResult.resident_bytes``), whether it computed
tensor-parallel (``EngineResult.tp_compute``) and the MoE layers' routed
and dropped pairs (``record_routing``); a case with ``"checkpoint"`` saves
its final params through a ``CheckpointManager`` on every rank.
Imports torch and ``repro_torch`` only.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# the kinds that run no pod round (no init, no data)
PORT_ONLY = ("vocab", "serve", "steps", "xent")


def main(cfg_path: str, rank: int, world: int, init_method: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    from repro_torch.fl import compression, pod, privacy
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.task import lm_task
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import record_routing
    from repro_torch.sharding import tensor_parallel as tpl
    from repro_torch.utils import tree_math as tm

    sum_over_model = tpl.sum_over_model
    cfg = json.loads(Path(cfg_path).read_text())
    out = Path(cfg["dir"])

    def load_init(task, path):
        saved = np.load(path)
        _, treedef = tm.tree_flatten(task.shapes())
        return tm.tree_unflatten(treedef, [
            torch.from_numpy(saved[f"arr_{i}"])
            for i in range(len(saved.files))])

    def source(idx):
        def indices(rnd, slot, step):
            return torch.from_numpy(np.asarray(idx[rnd, slot, step],
                                               np.int64))
        return indices

    def side_key(case):
        return (case.get("arch", cfg["arch"]), case.get("peft"),
                case.get("capacity_factor"))

    sides, datas = {}, {}
    for case in cfg["cases"].values():
        if case["kind"] in PORT_ONLY or side_key(case) in sides:
            continue
        arch, peft, cf = side_key(case)
        mcfg = with_peft(get_reduced(arch), peft)
        if cf is not None:
            mcfg = dataclasses.replace(mcfg, capacity_factor=cf)
        task = lm_task(mcfg)
        tag = "lora" if peft else "full"
        sides[arch, peft, cf] = (mcfg, task, load_init(
            task, out / f"init_{arch}_{tag}.npz"))
        if mcfg.vocab_size not in datas:
            datas[mcfg.vocab_size] = make_synthetic_tokenlm(
                n_clients=cfg["n_clients"], seq_len=cfg["seq"],
                n_seq_per_client=cfg["n_seq"], vocab=mcfg.vocab_size,
                seed=cfg["seed"])
    indices = source(np.load(out / "indices.npy"))

    calls = {"local_step": 0, "delta_accum": 0, "server_update": 0}

    def counting(name):
        fn = getattr(ops, f"fused_{name}")

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        setattr(ops, f"fused_{name}", counted)
    for name in calls:
        counting(name)
    # DP's per-client clip scales (they show whether the clip binds)
    scales = []
    clip_scale = privacy.clip_scale

    def recording_clip_scale(dp, sq):
        out = clip_scale(dp, sq)
        scales.append(float(out))
        return out
    privacy.clip_scale = recording_clip_scale
    # each step's global gradient norm (the clip norm, when grad_clip)
    norms = []
    grad_sqsum = pod.ShardedFlatOps.grad_sqsum

    def recording_grad_sqsum(self, g_bufs):
        out = grad_sqsum(self, g_bufs)
        norms.append(float(out) ** 0.5)
        return out
    pod.ShardedFlatOps.grad_sqsum = recording_grad_sqsum

    for name, case in cfg["cases"].items():
        mesh = make_mesh(case["shape"], ("data", "model"), "cpu")
        if case["kind"] == "vocab":
            (out / f"vocab_{name}_{rank}.json").write_text(json.dumps(dict(
                vocab_check(mesh, cfg["seed"]),
                serve=serve_check(mesh, cfg["seed"]))))
            dist.barrier()
            continue
        if case["kind"] == "serve":
            (out / f"serve_{name}_{rank}.json").write_text(json.dumps(
                serve_check(mesh, cfg["seed"], case["arch"],
                            case.get("ssd_impl"), case.get("overrides"))))
            dist.barrier()
            continue
        if case["kind"] in ("steps", "xent"):
            check = steps_check(mesh, cfg["seed"], case["arch"],
                                case.get("control", False),
                                case.get("overrides")) \
                if case["kind"] == "steps" else xent_check(mesh, cfg["seed"])
            (out / f"{case['kind']}_{name}_{rank}.json").write_text(
                json.dumps(check))
            dist.barrier()
            continue
        peft = case.get("peft")
        mcfg, task, init = sides[side_key(case)]
        data = datas[mcfg.vocab_size]
        spec = pod.PodFLSpec(
            update_impl=case.get("update_impl", "fused"),
            algorithm=case.get("algorithm", "fedavg"),
            server_opt=case.get("server_opt", "none"), peft=peft,
            dp=privacy.DPSpec(case["dp"]) if case.get("dp") else None,
            compression=(compression.CompressionSpec(8, 0.25, True)
                         if case.get("compressed") else None),
            grad_clip=case.get("grad_clip"),
            **dict(cfg["spec"], **case.get("spec", {})))
        common = dict(rounds=1, clients_per_round=cfg["K"], spec=spec,
                      layout=case["layout"], sampling="host",
                      batch_indices=indices)
        pod.reset_collective_counts()
        for k in calls:
            calls[k] = 0
        scales.clear()
        norms.clear()
        algo_state, fops, tp_compute = {}, None, []
        routing = record_routing()
        log = routing.__enter__()
        if case.get("control"):
            tpl.sum_over_model = tpl.reduce_from_model
        if case["kind"] == "train":
            res = train.run_pod_training(
                mcfg, data, cyclic_rounds=0, fl_rounds=1,
                clients_per_round=cfg["K"], spec=spec, mesh=mesh,
                seed=cfg["seed"], sampling="host", layout=case["layout"],
                init_params=init, batch_indices={"P2": indices})
            losses = [h["loss"] for h in res.history]
            params = res.params
            res = res.schedule.phases[-1].result
        else:
            phases = {"relay": ("P1",), "rounds": ("P2",),
                      "p1p2": ("P1", "P2")}[case["kind"]]
            losses, params, tp_compute = [], init, []
            for phase in phases:
                if phase == "P1":
                    c = pod.PodCyclicConfig(mesh, **dict(
                        common, spec=train.relay_spec(spec)))
                else:
                    c = pod.PodFLConfig(mesh, **common, **case.get("kw", {}))
                strategy = c.strategy()
                fops = strategy.flat_ops(task, mesh.device)
                res = run_rounds(task, data, strategy, c.schedule(),
                                 init_params=params, device=mesh.device,
                                 phase=phase)
                losses += [h["local_loss"] for h in res.history]
                params, algo_state = res.params, res.algo_state
                tp_compute.append(res.tp_compute)
        tpl.sum_over_model = sum_over_model
        routing.__exit__(None, None, None)
        counts = {"collectives": dict(pod.COLLECTIVES),
                  "bytes": dict(pod.COLLECTIVE_BYTES), "calls": dict(calls),
                  "resident": res.resident_bytes, "clip_scales": scales,
                  "grad_norms": norms, "tp_compute": res.tp_compute,
                  "tp_compute_phases": tp_compute,
                  "routed": sum(e["pairs"] for e in log),
                  "dropped": sum(int(e["dropped"]) for e in log),
                  "capacity": sorted({e["capacity"] for e in log})}
        if fops is not None:
            arrays = {}
            if "c_global" in algo_state:
                for b, t in algo_state["c_global"].items():
                    arrays[f"c/{b}"] = t.numpy()
            if "ef_residuals" in algo_state:
                st = algo_state["ef_residuals"]
                if isinstance(st, pod.ClientRows):
                    assert not st.sharded  # data-sharded buckets: whole
                    rows = st.rows
                else:                       # the sparse store's table
                    assert not strategy._ef_store._meta["sharded"]
                    slot = st["slot_of"]
                    seen = (slot >= 0)[:, None]
                    rows = {b: torch.where(seen, t[slot.clamp(min=0)], 0.0)
                            for b, t in st["table"].items()}
                for b, t in rows.items():
                    arrays[f"ef/{b}"] = t.numpy()
            np.savez(out / f"rows_{name}_{rank}.npz", **arrays)
        (out / f"counts_{name}_{rank}.json").write_text(json.dumps(counts))
        if case.get("checkpoint"):
            CheckpointManager(str(out / f"ckpt_{name}")).save(1, params)
        if rank == 0:
            arrays = {f"p{i}": leaf.detach().float().numpy()
                      for i, leaf in enumerate(tm.tree_leaves(params))}
            arrays["loss"] = np.array(losses)
            arrays["acc"] = np.array([h["acc"] for h in res.history
                                      if "acc" in h])
            np.savez(out / f"torch_{name}.npz", **arrays)
        dist.barrier()
    dist.destroy_process_group()


def vocab_check(mesh, seed: int) -> dict:
    """The vocabulary-parallel embedding lookup and cross-entropy on this
    rank's columns of a tied (V, d) table against ``embed[tokens]`` and
    ``models.transformer._xent`` over the whole vocabulary, forward and
    gradient (labels −1 ignored; tokens and labels on every rank's
    columns): the largest absolute differences."""
    from repro_torch.fl import pod
    from repro_torch.models.transformer import _xent
    from repro_torch.sharding import tensor_parallel as tpl
    V, d, B, S = 64, 8, 2, 6
    cfg = _vocab_cfg(V)
    tp = tpl.context(cfg, mesh)
    assert tp is not None and tp.plan.vocab
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, V, (B, S)))
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    labels[0, :2] = -1
    lo, n = tp.vocab_range

    def run(local: bool):
        t = (table[lo:lo + n] if local else table).clone().requires_grad_()
        if local:
            x = tpl.vocab_embedding(t, tokens, tp)
            logits = tpl.copy_to_model(x, tp) @ t.t()
            loss, _ = tpl.vocab_cross_entropy(logits, labels, tp)
        else:
            x = t[tokens]
            loss, _ = _xent(x @ t.t(), labels)
        (g,) = torch.autograd.grad(loss, [t])
        return x.detach(), loss.detach(), g[lo:lo + n] if not local else g
    xw, lw, gw = run(False)
    pod.reset_collective_counts()
    xl, ll, gl = run(True)
    return {"embed": float((xl - xw).abs().max()),
            "loss": float((ll - lw).abs()), "loss_value": float(lw),
            "grad": float((gl - gw).abs().max()),
            "grad_max": float(gw.abs().max()),
            "tp": pod.COLLECTIVES["tp"]}


def serve_check(mesh, seed: int, arch: str = "tinyllama-1.1b",
                ssd_impl=None, overrides=None) -> dict:
    """The reduced ``arch``'s prefill and two greedy decode steps on the
    model-local tree of the ``fsdp_tp`` layout (tinyllama-1.1b's 2 kv
    heads on 4 ``model`` ranks: one each; an MLA arch's heads and experts
    split, its latent cache whole; an SSM's heads split, its state the
    rank's heads and conv channels) against the whole tree's: the largest
    differences of the logits, whether the greedy tokens agree, and of
    the rank's kv heads of the cache (MLA: of every layer's whole latent
    cache) and of its part of the SSM state (``ssd_impl`` overrides the
    config's SSD core: "pallas_interpret" is K8's plain version;
    ``overrides``, fields of the reduced config)."""
    import dataclasses
    from repro_torch.fl import pod
    from repro_torch.fl.task import lm_task
    from repro_torch.models.ssm import local_ssm_state
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.utils import tree_math as tm
    cfg = _reduced(arch, overrides)
    if ssd_impl is not None:
        cfg = dataclasses.replace(cfg, ssd_impl=ssd_impl)
    params = init_lm(cfg, seed, "cpu")
    fops = pod._sharded_flat_ops(lm_task(cfg), mesh, "fsdp_tp", True)
    with torch.no_grad():
        tree = fops.tp_tree(fops.flatten(params))
        tp = tree.tp
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 6)))
        lw, cw, S = prefill(params, cfg, {"tokens": tokens}, 9)
        lt, ct, _ = prefill(tree, cfg, {"tokens": tokens}, 9, tp=tp)
        logits = [float((lt - lw).abs().max())]
        greedy = [bool(torch.equal(torch.argmax(lt, -1),
                                   torch.argmax(lw, -1)))]
        for t in range(2):
            tok = torch.argmax(lw[:, -1:], dim=-1)
            lw, cw = decode_step(params, cfg, tok, cw, S + t)
            lt, ct = decode_step(tree, cfg, tok, ct, S + t, tp=tp)
            logits.append(float((lt - lw).abs().max()))
            greedy.append(bool(torch.equal(torch.argmax(lt, -1),
                                           torch.argmax(lw, -1))))
    out = {"logits": logits, "greedy_equal": greedy,
           "logits_shape": list(lt.shape), "tp_experts": tp.plan.experts,
           "tp_heads": tp.plan.attn, "tp_ssm": tp.plan.ssm,
           "tp_vocab": tp.plan.vocab, "cache": 0.0}
    if cfg.attention == "mla":
        out["kv_heads"] = cfg.n_heads // tp.size
        out["cache"] = max(float((a - b).abs().max()) for a, b in
                           zip(tm.tree_leaves(ct), tm.tree_leaves(cw)))
    elif cfg.has_attn:
        lo, n = tp.kv_range if tp.plan.attn else (0, cfg.n_kv_heads)
        out["kv_heads"] = n
        out["cache"] = max(float((a - b.narrow(-2, lo, n)).abs().max())
                           for a, b in zip(ct["scan"]["kv"],
                                           cw["scan"]["kv"]))
    if cfg.has_ssm:
        want = local_ssm_state(cw["scan"]["ssm"], cfg.ssm_cfg(), tp)
        out["ssm_shapes"] = [list(t.shape) for t in ct["scan"]["ssm"]]
        out["ssm_state"] = [float((a.float() - b.float()).abs().max())
                            for a, b in zip(ct["scan"]["ssm"], want)]
        out["ssm_state_max"] = [float(b.float().abs().max()) for b in want]
    return out


def steps_check(mesh, seed: int, arch: str, control: bool = False,
                overrides=None) -> dict:
    """``launch.steps.make_train_step`` on the reduced ``arch``'s
    model-local tree (``fsdp_tp``) against the whole tree's, two steps
    on one batch (vlm: 8 patch embeddings + 8 tokens; audio: 8 frames of
    4 codebooks; tokens: 8): the losses, the largest gap of the first
    step's gradient (each leaf against the rank's part of the whole
    gradient) over its largest magnitude, and of the params after two
    steps; with ``control`` the first gradient's gap again with the SSM's
    gated norm summing Σx² through ``reduce_from_model`` (``overrides``:
    fields of the reduced config)."""
    from repro_torch.fl import pod
    from repro_torch.fl.task import lm_task
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import tensor_parallel as tpl
    from repro_torch.utils import tree_math as tm
    cfg = _reduced(arch, overrides)
    params = init_lm(cfg, seed, "cpu")
    fops = pod._sharded_flat_ops(lm_task(cfg), mesh, "fsdp_tp", True)
    rng = np.random.default_rng(seed)
    B, S, P = 4, 8, 8

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    def ints(hi, *shape):
        return torch.from_numpy(rng.integers(0, hi, shape))
    if cfg.input_mode == "vlm":
        batch = {"patch_embeds": randn(B, P, cfg.d_model),
                 "tokens": ints(cfg.vocab_size, B, S),
                 "labels": ints(cfg.vocab_size, B, S)}
    elif cfg.input_mode == "embeddings":
        batch = {"frame_embeds": randn(B, S, cfg.d_model),
                 "labels": ints(cfg.vocab_size, B, S, cfg.n_codebooks)}
    else:
        batch = {"tokens": ints(cfg.vocab_size, B, S),
                 "labels": ints(cfg.vocab_size, B, S)}
    batch["labels"][0, :2] = -1

    def local(tree):
        """The rank's model-local view of a whole tree."""
        with torch.no_grad():
            return fops.tp_tree(fops.flatten(tree))

    def gap(got, want):
        return max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(tm.tree_leaves(got),
                                        tm.tree_leaves(want)))
    tree = local(params)
    _, treedef = tm.tree_flatten(params)
    lw, gw = steps._value_and_grad(cfg, params, batch)
    lt, gt = steps._value_and_grad(cfg, tree, batch)
    out = {"tp_ssm": tree.tp.plan.ssm, "tp_vocab": tree.tp.plan.vocab,
           "tp_heads": tree.tp.plan.attn, "tp_mlp": tree.tp.plan.mlp,
           "first_loss": [float(lt), float(lw)],
           "grad": gap(tm.tree_unflatten(treedef, gt),
                       local(tm.tree_unflatten(treedef, gw)))}
    pod.reset_collective_counts()
    step = steps.make_train_step(cfg, steps.TrainSpec(lr=0.05))
    pw, mw, pt, mt = params, steps.init_momentum(params), tree, \
        steps.init_momentum(tree)
    losses = []
    for _ in range(2):
        pw, mw, a = step(pw, mw, batch)
        pt, mt, b = step(pt, mt, batch)
        losses.append([float(b["loss"]), float(a["loss"])])
    out.update(losses=losses, params=gap(pt, local(pw)),
               still_local=tpl.context_of(pt) is tree.tp,
               tp=pod.COLLECTIVES["tp"])
    if control:
        sound = tpl.sum_over_model
        tpl.sum_over_model = tpl.reduce_from_model
        try:
            _, gc = steps._value_and_grad(cfg, tree, batch)
        finally:
            tpl.sum_over_model = sound
        out["control_grad"] = gap(tm.tree_unflatten(treedef, gc),
                                  local(tm.tree_unflatten(treedef, gw)))
    return out


def _xent_one_codebook(logits, labels, tp, ignore=-1):
    """The vocabulary-parallel cross-entropy's forward for one codebook
    as it stood before the codebook form (the max, Σexp and gold logit
    all-reduced over the whole last dim): the bitwise reference."""
    from repro_torch.sharding.tensor_parallel import _all_reduce
    logits = logits.float()
    lo, n = tp.vocab_range
    m = _all_reduce(torch.amax(logits, dim=-1), tp, dist.ReduceOp.MAX)
    e = torch.exp(logits - m[..., None])
    s = _all_reduce(torch.sum(e, dim=-1), tp)
    ids = labels.long() - lo
    inside = (ids >= 0) & (ids < n) & (labels != ignore)
    ids = torch.where(inside, ids, torch.zeros_like(ids))
    gold = torch.gather(logits, -1, ids[..., None])[..., 0]
    gold = _all_reduce(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return torch.log(s) + m - gold


def xent_check(mesh, seed: int) -> dict:
    """The vocabulary-parallel cross-entropy over this rank's columns of
    the flattened ``(codebook, vocab)`` dim against
    ``models.transformer._xent`` over the whole, for 1, 2 and 4 codebooks
    of 16 words (labels −1 ignored, on every rank's columns): the largest
    differences of the loss and its gradient; and for one codebook,
    whether the per-position nll is bitwise the pre-codebook form's."""
    import dataclasses
    from repro_torch.fl import pod
    from repro_torch.models.transformer import _xent
    from repro_torch.sharding import tensor_parallel as tpl
    V, d, B, S = 16, 8, 2, 6
    rng = np.random.default_rng(seed)
    out = {}
    for ncb in (1, 2, 4):
        cfg = dataclasses.replace(_vocab_cfg(V), n_codebooks=ncb,
                                  tie_embeddings=False, arch_type="audio",
                                  input_mode="embeddings")
        tp = tpl.context(cfg, mesh)
        assert tp is not None and tp.plan.vocab
        head = torch.from_numpy(rng.standard_normal((d, V * ncb)).astype(
            np.float32))
        x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(
            np.float32))
        labels = torch.from_numpy(rng.integers(0, V, (B, S, ncb)))
        labels[0, :2] = -1
        if ncb == 1:
            labels = labels[..., 0]
        lo, n = tp.vocab_range

        def run(split: bool):
            h = (head[:, lo:lo + n] if split else head).clone(
            ).requires_grad_()
            logits = x @ h
            if split:
                loss, _ = tpl.vocab_cross_entropy(logits, labels, tp)
            else:
                if ncb > 1:
                    logits = logits.reshape(B, S, ncb, V)
                loss, _ = _xent(logits, labels)
            (g,) = torch.autograd.grad(loss, [h])
            return loss.detach(), g if split else g[:, lo:lo + n]
        lw, gw = run(False)
        pod.reset_collective_counts()
        lt, gt = run(True)
        out[str(ncb)] = {"loss": float((lt - lw).abs()),
                         "loss_value": float(lw),
                         "grad": float((gt - gw).abs().max()),
                         "grad_max": float(gw.abs().max()),
                         "tp": pod.COLLECTIVES["tp"], "cols": [lo, n]}
        if ncb == 1:
            logits = x @ head[:, lo:lo + n]
            nll = tpl._VocabCrossEntropy.apply(logits, labels, tp, -1)
            out["bitwise_one_codebook"] = bool(torch.equal(
                nll, _xent_one_codebook(logits, labels, tp)))
    return out


def _reduced(arch: str, overrides=None):
    """The reduced config of ``arch`` with ``overrides`` (a dict of its
    fields) replaced."""
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), **(overrides or {}))


def _vocab_cfg(vocab: int):
    """A dense token config of ``vocab`` words (its plan splits the
    vocabulary on any |model| that divides it)."""
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(name="vocab", arch_type="dense", n_layers=1,
                             d_model=8, vocab_size=vocab, n_heads=4,
                             n_kv_heads=4, d_ff=8, tie_embeddings=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
