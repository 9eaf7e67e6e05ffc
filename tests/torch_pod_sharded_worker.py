"""One rank of the sharded four-rank pod runs of
``tests/test_torch_pod_sharded.py`` (not a test module).

    python tests/torch_pod_sharded_worker.py CFG.json RANK WORLD file:///path/store

Joins a gloo process group over the ``file://`` store, then for every
case of the config builds its mesh and runs the reduced LM (the case's
``arch``, else the config's; with ``lora:4`` adapters when the case
names ``peft``) from the given init params on the given batch indices:
through ``run_pod_training`` (kind "train": P2 only), the P1 relay
(kind "relay") or P2 rounds (kind "rounds"), at the case's
``capacity_factor`` and ``update_impl`` (default "fused") when it names
them.  Kind "vocab" holds the
vocabulary-parallel embedding and cross-entropy (tied embedding, ignore
labels) against the whole-vocabulary functions on the case's mesh and
writes their largest differences; kind "serve" holds the case's arch's
tensor-parallel prefill and decode against the whole model's.  Rank 0
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
    from repro_torch.utils import tree_math as tm

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
        if case["kind"] in ("vocab", "serve") or side_key(case) in sides:
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
                serve_check(mesh, cfg["seed"], case["arch"])))
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
            grad_clip=case.get("grad_clip"), **cfg["spec"])
        common = dict(rounds=1, clients_per_round=cfg["K"], spec=spec,
                      layout=case["layout"], sampling="host",
                      batch_indices=indices)
        pod.reset_collective_counts()
        for k in calls:
            calls[k] = 0
        scales.clear()
        norms.clear()
        algo_state, fops = {}, None
        routing = record_routing()
        log = routing.__enter__()
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
            if case["kind"] == "relay":
                c = pod.PodCyclicConfig(mesh, **common)
            else:
                c = pod.PodFLConfig(mesh, **common, **case.get("kw", {}))
            strategy = c.strategy()
            fops = strategy.flat_ops(task, mesh.device)
            res = run_rounds(task, data, strategy, c.schedule(),
                             init_params=init, device=mesh.device,
                             phase="P1" if case["kind"] == "relay" else "P2")
            losses = [h["local_loss"] for h in res.history]
            params, algo_state = res.params, res.algo_state
        routing.__exit__(None, None, None)
        counts = {"collectives": dict(pod.COLLECTIVES),
                  "bytes": dict(pod.COLLECTIVE_BYTES), "calls": dict(calls),
                  "resident": res.resident_bytes, "clip_scales": scales,
                  "grad_norms": norms, "tp_compute": res.tp_compute,
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


def serve_check(mesh, seed: int, arch: str = "tinyllama-1.1b") -> dict:
    """The reduced ``arch``'s prefill and two greedy decode steps on the
    model-local tree of the ``fsdp_tp`` layout (tinyllama-1.1b's 2 kv
    heads on 4 ``model`` ranks: one each; an MLA arch's heads and experts
    split, its latent cache whole) against the whole tree's: the largest
    differences of the logits and of the rank's kv heads of the cache
    (MLA: of every layer's whole latent cache)."""
    from repro_torch.configs import get_reduced
    from repro_torch.fl import pod
    from repro_torch.fl.task import lm_task
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.utils import tree_math as tm
    cfg = get_reduced(arch)
    params = init_lm(cfg, seed, "cpu")
    fops = pod._sharded_flat_ops(lm_task(cfg), mesh, "fsdp_tp", True,
                                 None, False, True)
    with torch.no_grad():
        tree = fops.tp_tree(fops.flatten(params))
        tp = tree.tp
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 6)))
        lw, cw, S = prefill(params, cfg, {"tokens": tokens}, 9)
        lt, ct, _ = prefill(tree, cfg, {"tokens": tokens}, 9, tp=tp)
        logits = [float((lt - lw).abs().max())]
        for t in range(2):
            tok = torch.argmax(lw[:, -1:], dim=-1)
            lw, cw = decode_step(params, cfg, tok, cw, S + t)
            lt, ct = decode_step(tree, cfg, tok, ct, S + t, tp=tp)
            logits.append(float((lt - lw).abs().max()))
    if cfg.attention == "mla":
        n = cfg.n_heads // tp.size
        cache = max(float((a - b).abs().max()) for a, b in
                    zip(tm.tree_leaves(ct), tm.tree_leaves(cw)))
    else:
        lo, n = tp.kv_range
        cache = max(float((a - b.narrow(-2, lo, n)).abs().max())
                    for a, b in zip(ct["scan"]["kv"], cw["scan"]["kv"]))
    return {"logits": logits, "cache": cache, "kv_heads": n,
            "logits_shape": list(lt.shape), "tp_experts": tp.plan.experts,
            "tp_heads": tp.plan.attn}


def _vocab_cfg(vocab: int):
    """A dense token config of ``vocab`` words (its plan splits the
    vocabulary on any |model| that divides it)."""
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(name="vocab", arch_type="dense", n_layers=1,
                             d_model=8, vocab_size=vocab, n_heads=4,
                             n_kv_heads=4, d_ff=8, tie_embeddings=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
