"""One rank of the sharded four-rank pod runs of
``tests/test_torch_pod_sharded.py`` (not a test module).

    python tests/torch_pod_sharded_worker.py CFG.json RANK WORLD file:///path/store

Joins a gloo process group over the ``file://`` store, then for every
case of the config builds its mesh and runs the reduced LM (with
``lora:4`` adapters when the case names ``peft``) from the given init
params on the given batch indices: through ``run_pod_training`` (kind
"train": P2 only), the P1 relay (kind "relay") or P2 rounds (kind
"rounds").  Rank 0 writes the final params and the losses; every rank
writes its rows of scaffold's ``c`` and of the error-feedback store, its
collective counts and bytes, its K1/K6/K3 call counts, DP's clip scales,
each step's global gradient norm and the bytes of the buffers it carried
(``EngineResult.resident_bytes``); a case with ``"checkpoint"`` saves
its final params through a ``CheckpointManager`` on every rank.
Imports torch and ``repro_torch`` only.
"""
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

    sides = {}
    for peft in (None, "lora:4"):
        mcfg = with_peft(get_reduced(cfg["arch"]), peft)
        task = lm_task(mcfg)
        tag = "lora" if peft else "full"
        sides[peft] = (mcfg, task, load_init(task, out / f"init_{tag}.npz"))
    data = make_synthetic_tokenlm(
        n_clients=cfg["n_clients"], seq_len=cfg["seq"],
        n_seq_per_client=cfg["n_seq"], vocab=sides[None][0].vocab_size,
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
        peft = case.get("peft")
        mcfg, task, init = sides[peft]
        spec = pod.PodFLSpec(
            update_impl="fused", algorithm=case.get("algorithm", "fedavg"),
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
        counts = {"collectives": dict(pod.COLLECTIVES),
                  "bytes": dict(pod.COLLECTIVE_BYTES), "calls": dict(calls),
                  "resident": res.resident_bytes, "clip_scales": scales,
                  "grad_norms": norms}
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
            np.savez(out / f"torch_{name}.npz", **arrays)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
