"""Quickstart on the PyTorch/CUDA port — CyclicFL's headline pipeline.

The port's twin of ``examples/quickstart.py``: cyclic pre-training (P1)
on Dirichlet-non-IID synthetic vision data, then FedAvg (P2) from the
pre-trained model, against FedAvg from random init under the SAME total
round budget.  Runs on the GPU by default (the fused update kernels);
``--device cpu`` runs their plain versions on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --clients 4 --n-train 128 --n-test 32 --cyclic-rounds 1 \\
        --fl-rounds 1 --local-steps 2
"""
import argparse
import time

from repro_torch.core.cyclic import CyclicConfig
from repro_torch.core.pipeline import run_cyclic_then_federated
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.simulation import FLConfig
from repro_torch.fl.task import vision_task


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--cyclic-rounds", type=int, default=4)
    ap.add_argument("--fl-rounds", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--update-impl", default="fused",
                    choices=("tree", "fused", "fused_interpret"))
    args = ap.parse_args()

    t0 = time.time()
    # strongly non-IID (Dirichlet beta=0.1)
    data = DATASETS.get("cifar10-like")(n_clients=args.clients, beta=0.1,
                                        seed=0, n_train=args.n_train,
                                        n_test=args.n_test)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    common = dict(participation=0.25, local_steps=args.local_steps,
                  eval_every=2, seed=0, update_impl=args.update_impl)
    cyc = CyclicConfig(rounds=args.cyclic_rounds, **common)
    fed = FLConfig(algorithm="fedavg", rounds=args.fl_rounds, **common)

    print(f"== Cyclic+FedAvg (P1: {cyc.rounds} rounds relay, "
          f"P2: {fed.rounds} rounds FedAvg) on {args.device} ==")
    with_cyclic = run_cyclic_then_federated(task, data, cyc, fed,
                                            verbose=True, device=args.device)

    total = cyc.rounds + fed.rounds
    print(f"== FedAvg from random init ({total} rounds, same total "
          "budget) ==")
    baseline = run_cyclic_then_federated(
        task, data, None,
        FLConfig(algorithm="fedavg", rounds=total, **common),
        verbose=True, device=args.device)

    a, b = with_cyclic.best_acc(), baseline.best_acc()
    print(f"\nCyclic+FedAvg best acc : {a.get('acc', 0):.4f} "
          f"(round {a.get('round')})")
    print(f"FedAvg        best acc : {b.get('acc', 0):.4f} "
          f"(round {b.get('round')})")
    print(f"communication (bytes)  : "
          f"cyclic={with_cyclic.ledger.total_bytes:.2e} "
          f"baseline={baseline.ledger.total_bytes:.2e}")
    print(f"total {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
