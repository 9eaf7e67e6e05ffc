"""Declarative phase schedules on the PyTorch/CUDA port.

The port's twin of ``examples/phase_schedules.py``: the paper's
two-phase pipeline against a multi-cycle P1↔P2 alternation and an
adaptive relay (a plateau policy ends each relay early) under the SAME
total round budget and one ledger.  Runs on the GPU by default;
``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/phase_schedules_torch.py
    PYTHONPATH=src python examples/phase_schedules_torch.py --device cpu \\
        --clients 4 --n-train 128 --n-test 32 --local-steps 2
"""
import argparse

from repro_torch.core.cyclic import CyclicConfig
from repro_torch.core.pipeline import Phase, run_phase_schedule
from repro_torch.core.switch import AccuracyPlateau
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.simulation import FLConfig
from repro_torch.fl.task import vision_task


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--update-impl", default="fused",
                    choices=("tree", "fused", "fused_interpret"))
    args = ap.parse_args()

    data = DATASETS.get("cifar10-like")(n_clients=args.clients, beta=args.beta,
                                        seed=args.seed, n_train=args.n_train,
                                        n_test=args.n_test)
    task = vision_task("lenet5", n_classes=10, in_ch=3)
    common = dict(participation=0.25, local_steps=args.local_steps,
                  eval_every=2, seed=args.seed, update_impl=args.update_impl)

    def p1(rounds):
        return CyclicConfig(rounds=rounds, **common)

    def p2(rounds):
        return FLConfig(algorithm="fedavg", rounds=rounds, **common)

    schedules = {
        # the paper's protocol: one pre-training phase, one FL phase
        "paper (P1×4 → P2×12)": [
            Phase("P1", p1(4)), Phase("P2", p2(12))],
        # multi-cycle alternation, same 16-round budget
        "alternating (×2)": [
            Phase("P1", p1(2)), Phase("P2", p2(6)),
            Phase("P1'", p1(2)), Phase("P2'", p2(6))],
        # adaptive: plateau policy ends each relay early, remainder to FL
        "adaptive relay": [
            Phase("P1", p1(6), switch_policy=AccuracyPlateau(
                patience=2, min_delta=0.005, min_rounds=2)),
            Phase("P2", p2(12))],
    }

    print(f"{'schedule':24s} {'best acc':>9s} {'rounds':>7s} {'GiB':>7s}")
    for name, phases in schedules.items():
        res = run_phase_schedule(task, data, phases, device=args.device)
        led = res.ledger.summary()
        rounds = led["p1_rounds"] + led["p2_rounds"]
        print(f"{name:24s} {res.best_acc().get('acc', 0.0):9.4f} "
              f"{rounds:7d} {led['total_bytes'] / 2**30:7.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
