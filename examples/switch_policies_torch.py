"""RQ3 on the PyTorch/CUDA port: adaptive P1→P2 switch policies.

The port's twin of ``examples/switch_policies.py``: the three switch
policies of ``repro_torch.core.switch`` on the same round budget, where
each one switches and where it ends up.  Runs on the GPU by default;
``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/switch_policies_torch.py
    PYTHONPATH=src python examples/switch_policies_torch.py --device cpu \\
        --clients 4 --n-train 128 --n-test 32 --local-steps 2 --total 4
"""
import argparse
import time

from repro_torch.core.cyclic import CyclicConfig
from repro_torch.core.pipeline import run_cyclic_then_federated
from repro_torch.core.switch import (AccuracyPlateau, BudgetFraction,
                                     FixedRounds)
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
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--total", type=int, default=14,
                    help="the round budget of P1 + P2")
    ap.add_argument("--update-impl", default="fused",
                    choices=("tree", "fused", "fused_interpret"))
    args = ap.parse_args()
    total = args.total

    t0 = time.time()
    data = DATASETS.get("cifar10-like")(n_clients=args.clients, beta=0.5,
                                        seed=0, n_train=args.n_train,
                                        n_test=args.n_test)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    common = dict(participation=0.25, local_steps=args.local_steps,
                  eval_every=1, seed=0, update_impl=args.update_impl)

    policies = {
        "fixed(4)": FixedRounds(t_cyc=4),
        "plateau": AccuracyPlateau(patience=2, min_delta=0.005, min_rounds=2),
        "budget(25%)": BudgetFraction(total_rounds=total, fraction=0.25),
    }
    for name, policy in policies.items():
        probe = run_cyclic_then_federated(
            task, data, CyclicConfig(rounds=total - 2, **common),
            FLConfig(algorithm="fedavg", rounds=2, **common),
            switch_policy=policy, device=args.device)
        switched_at = len(probe.cyclic.history)
        # rerun with the discovered split so P2 gets the remaining budget
        res = run_cyclic_then_federated(
            task, data, CyclicConfig(rounds=switched_at, **common),
            FLConfig(algorithm="fedavg", rounds=total - switched_at,
                     **common), device=args.device)
        best = res.best_acc()
        print(f"[switch] {name:12s} switched@{switched_at:2d} "
              f"best={best.get('acc', 0):.4f}")
    print(f"total {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
