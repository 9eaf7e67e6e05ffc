"""One rank of the multi-rank pod runs of ``tests/test_torch_pod.py`` (not
a test module).

    python tests/torch_pod_worker.py CFG.json RANK WORLD file:///path/store

Joins a gloo process group over the ``file://`` store, then for every
case of the config builds its mesh, runs the case's P2 rounds on the
pod backend from the given init params and batch indices, and writes
the final params and losses (rank 0, with scaffold's ``c_global``;
a case with ``"task": "lora"`` trains the reduced LM with LoRA adapters
on the token stream instead of the mlp),
this rank's rows of the error-feedback store (compressed cases) and of
scaffold's control variates — all of them, through ``to_dense``, when
the case's store is sparse — and its collective and K6 call counts
(with the sparse stores' spilled and refaulted rows).  A case may set
its own ``rounds``.  Imports torch and ``repro_torch`` only.
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
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import DATASETS, make_synthetic_tokenlm
    from repro_torch.fl import compression, pod, privacy
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.task import lm_task, vision_task
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import tree_math as tm

    cfg = json.loads(Path(cfg_path).read_text())
    out = Path(cfg["dir"])

    def load_init(task, path):
        saved = np.load(path)
        _, treedef = tm.tree_flatten(
            task.init(torch.Generator().manual_seed(0)))
        return tm.tree_unflatten(treedef, [
            torch.from_numpy(saved[f"arr_{i}"])
            for i in range(len(saved.files))])

    def source(idx):
        def indices(rnd, slot, step):
            return torch.from_numpy(np.asarray(idx[rnd, slot, step],
                                               np.int64))
        return indices

    task = vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs={"img": 32})
    data = DATASETS.get("cifar10-like")(
        n_clients=cfg["n_clients"], beta=0.5, seed=cfg["seed"],
        n_train=cfg["n_train"], n_test=cfg["n_test"])
    init = load_init(task, out / "init.npz")
    indices = source(np.load(out / "indices.npy"))
    # the LoRA cases: a reduced LM with adapters on the token stream
    lm = cfg.get("lora")
    if lm:
        lcfg = with_peft(get_reduced(lm["arch"]), "lora:4")
        ltask = lm_task(lcfg)
        ldata = make_synthetic_tokenlm(
            n_clients=cfg["n_clients"], seq_len=lm["seq"],
            n_seq_per_client=lm["n_seq"], vocab=lcfg.vocab_size,
            seed=cfg["seed"])
        linit = load_init(ltask, out / "init_lora.npz")
        lindices = source(np.load(out / "indices_lora.npy"))

    calls = {"delta_accum": 0}
    accum = ops.fused_delta_accum

    def counted(*args, **kwargs):
        calls["delta_accum"] += 1
        return accum(*args, **kwargs)
    ops.fused_delta_accum = counted

    for name, case in cfg["cases"].items():
        mesh = make_mesh(case["shape"], ("data", "model"), "cpu")
        dp = privacy.DPSpec(case["dp"]) if case["dp"] else None
        comp = (compression.CompressionSpec(8, 0.25, True)
                if case["compressed"] else None)
        lora = case.get("task") == "lora"
        c = pod.PodFLConfig(
            mesh, rounds=case.get("rounds", cfg["rounds"]),
            clients_per_round=cfg["K"],
            spec=pod.PodFLSpec(update_impl="fused", dp=dp, compression=comp,
                               algorithm=case["algorithm"],
                               peft="lora:4" if lora else None,
                               **cfg["spec"]),
            sampling="host", eval_every=1,
            batch_indices=lindices if lora else indices, **case["kw"])
        pod.reset_collective_counts()
        calls["delta_accum"] = 0
        strategy = c.strategy()
        res = run_rounds(ltask if lora else task, ldata if lora else data,
                         strategy, c.schedule(),
                         init_params=linit if lora else init,
                         label=f"pod-{strategy.name}", device=mesh.device)
        counts = dict(pod.COLLECTIVES, **calls)
        stores = dict(strategy._residency_entries())
        for key, store in stores.items():
            st = res.algo_state[key]
            if isinstance(st, pod.ClientRows):
                lo, rows = st.lo, st.rows["float32"][:st.per].numpy()
            else:                       # sparse: every rank, all rows
                lo, rows = 0, store.to_dense(st)["float32"].numpy()
                counts[f"{key}_spilled"] = store.spilled_rows
                counts[f"{key}_refaulted"] = store.refaulted_rows
            tag = "ef" if key == "ef_residuals" else key
            np.savez(out / f"{tag}_{name}_{rank}.npz", lo=lo, rows=rows)
        (out / f"counts_{name}_{rank}.json").write_text(json.dumps(counts))
        if rank == 0:
            arrays = {f"p{i}": leaf.detach().float().numpy()
                      for i, leaf in enumerate(tm.tree_leaves(res.params))}
            arrays["loss"] = np.array([h["local_loss"] for h in res.history])
            if "c_global" in res.algo_state:
                arrays["c"] = res.algo_state["c_global"]["float32"].numpy()
            np.savez(out / f"torch_{name}.npz", **arrays)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
