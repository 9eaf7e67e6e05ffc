"""CyclicFL federated next-token training on the PyTorch/CUDA port.

The port's twin of ``examples/federated_llm.py``: a ~100M llama-family
transformer (tinyllama-1.1b cut in depth and width) on the synthetic
federated token stream (a Dirichlet topic mixture per client, so the
split is non-IID), through ``repro_torch.launch.train.run_pod_training``
on the pod backend: P1 relay, then P2 FedAvg.

The default run is parameter-efficient: ``--peft lora:8`` builds the
model with rank-8 LoRA adapters and P2 trains only them — the frozen
leaves never enter a kernel, the round carry or the upload, so a
client's upload is the adapter slice.  ``--peft none`` asks for full
fine-tuning, which the example refuses with a clear message when the
round's working set would not fit the device's memory.  Runs on the
card by default; ``--device cpu`` runs the kernels' plain versions on
the CPU.

    PYTHONPATH=src python examples/federated_llm_torch.py
    PYTHONPATH=src python examples/federated_llm_torch.py --tiny \\
        --device cpu --local-steps 2 --seq 32
"""
import argparse
import dataclasses
import os
import sys
import time

import torch

from repro_torch.configs import get_config, get_reduced, param_count, with_peft
from repro_torch.data.synthetic import make_synthetic_tokenlm
from repro_torch.launch.train import (PodFLSpec, run_pod_training,
                                      sequence_loss_metric)
from repro_torch.models.transformer import init_lm
from repro_torch.sharding import rules
from repro_torch.utils import tree_math as tm


def model_100m():
    """~100M-param llama-family config (tinyllama cut in depth/width)."""
    base = get_config("tinyllama-1.1b")
    return dataclasses.replace(
        base, name="tinyllama-100m", n_layers=6, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        dtype=torch.float32, param_dtype=torch.float32, remat=False)


def memory_bytes(device: str) -> int:
    """The memory a round lives in: the card's, or the host's."""
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).total_memory
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 1 << 34                          # unknown platform: 16 GiB


def check_fits(cfg, peft, device: str) -> None:
    """Refuse a full fine-tune that will not fit.  A P2 round holds the
    params, the working params, the f32 delta and one client's gradient
    and activations at once: ~6x the param bytes is the honest floor.
    With a trainable filter only the slice pays that; the frozen
    constant is held once."""
    if peft is not None:
        return
    n_params = param_count(cfg)
    need = 6 * n_params * 4
    have = memory_bytes(device)
    if need > 0.8 * have:
        sys.exit(
            f"[llm] full fine-tune of {cfg.name} needs ~{need / 1e9:.1f} GB "
            f"of round working set (~6x {n_params / 1e6:.0f}M f32 params) "
            f"but {device} has {have / 1e9:.1f} GB — run the default "
            f"--peft lora:8 (trains the adapter slice only) or --tiny")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (seconds on the CPU)")
    ap.add_argument("--peft", default="lora:8", metavar="lora:<r>|none",
                    help="P2 trainable slice: rank-r LoRA adapters "
                         "(default lora:8) or 'none' for full fine-tuning")
    ap.add_argument("--cyclic-rounds", type=int, default=1)
    ap.add_argument("--fl-rounds", type=int, default=1)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    peft = None if args.peft in ("none", "") else args.peft
    cfg = with_peft(get_reduced("tinyllama-1.1b") if args.tiny
                    else model_100m(), peft)
    check_fits(cfg, peft, args.device)
    n_params = param_count(cfg)
    msg = f"[llm] {cfg.name}: {n_params / 1e6:.1f}M params"
    if peft is not None:
        shapes = init_lm(cfg, device="meta")
        mask = rules.trainable_mask(shapes, "lora")
        n_train = sum(t.numel() for t, m in zip(tm.tree_leaves(shapes), mask)
                      if m)
        msg += (f", {n_train / 1e6:.2f}M trainable ({peft}) — "
                f"{n_params / n_train:.0f}x smaller uploads")
    print(msg)

    data = make_synthetic_tokenlm(
        n_clients=16, seq_len=args.seq, n_seq_per_client=32,
        vocab=cfg.vocab_size, beta=0.5, seed=args.seed)

    # the trainable slice rides the fused flat path; P1 relays the full
    # model (run_pod_training strips the filter for that phase)
    spec = PodFLSpec(local_steps=args.local_steps, lr=0.03,
                     update_impl="fused" if peft else "tree", peft=peft)
    t0 = time.time()
    res = run_pod_training(
        cfg, data, cyclic_rounds=args.cyclic_rounds, fl_rounds=args.fl_rounds,
        clients_per_round=4, spec=spec, seed=args.seed,
        eval_fn=sequence_loss_metric(cfg), eval_batch=16, verbose=True,
        device=args.device)
    print(f"[llm] eval loss trajectory: "
          f"{[round(h['eval'], 4) for h in res.history]}")
    first, last = res.history[0]["eval"], res.history[-1]["eval"]
    print(f"[llm] eval loss {first:.4f} -> {last:.4f} "
          f"({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
