"""Batched serving on the PyTorch/CUDA port: one engine per model, all
three input modalities (text, VLM, audio) through the same decode loop.

The port's twin of ``examples/serve_batch.py``: the reduced qwen2-1.5b
(dense GQA), mamba2-1.3b (SSM, O(1)-state decode), internvl2-1b (VLM
backbone, patch-embedding prefix) and musicgen-medium (audio decoder,
4 codebooks) through ``Engine.generate`` on the kernel path: the
hand-written attention and SSD-scan kernels on the card, their plain
versions on the CPU.  Runs on the card by default; ``--device cpu``
runs on the CPU.

    PYTHONPATH=src python examples/serve_batch_torch.py
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu \\
        --batch 2 --prompt-len 8 --new-tokens 2
"""
import argparse
import dataclasses
import sys
import time

from repro_torch.configs import get_reduced
from repro_torch.launch.serve import Engine, prompt_batch
from repro_torch.utils.device import seeded_generator

ARCHS = ("qwen2-1.5b",        # dense GQA
         "mamba2-1.3b",       # SSM (O(1)-state decode)
         "internvl2-1b",      # VLM backbone (patch-embed prefix)
         "musicgen-medium")   # audio decoder (4 codebooks)


def demo(arch: str, batch: int, prompt_len: int, new_tokens: int,
         device=None):
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="pallas",
                              ssd_impl="pallas")
    eng = Engine(cfg, seed=0, device=device)
    prompt = prompt_batch(cfg, batch, prompt_len,
                          seeded_generator(1, eng.device))
    toks, stats = eng.generate(prompt, new_tokens)
    print(f"[{arch:16s}] mode={cfg.input_mode:10s} "
          f"prefill={stats.prefill_s * 1e3:5.0f}ms "
          f"decode={stats.tok_per_s:6.1f} tok/s "
          f"out_shape={tuple(toks.shape)}")
    return toks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.time()
    for arch in ARCHS:
        demo(arch, args.batch, args.prompt_len, args.new_tokens, args.device)
    print(f"total {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
