"""Batched serving driver: prefill + greedy decode (the counterpart of
``repro/launch/serve.py``).

  1. ``prefill``  a full-prompt forward that builds the KV/SSM cache;
  2. ``decode``   one token per step against the cache, in place.

The engine runs on CUDA unless the caller asks for the CPU, and raises
without a card.  With ``attn_impl``/``ssd_impl`` ``"pallas"`` every layer
runs the hand-written attention kernel in prefill and in every decode
step, and the SSD scan kernel in prefill.  The cache length is a host
int, so the decode loop never waits on the device until the end.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 4 --prompt-len 32 --new-tokens 16
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.models.transformer import (
    TransformerConfig, decode_step, init_lm, prefill)
from repro_torch.utils import tree_math as tm
from repro_torch.utils.device import Device, resolve_device, seeded_generator

Pytree = Any


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


class Engine:
    """Minimal batched-serving engine over one model instance.

    ``params=None`` draws the model's params on the device from ``seed``;
    given params are moved to the device (a no-op when already there)."""

    def __init__(self, cfg: TransformerConfig, params: Optional[Pytree] = None,
                 seed: int = 0, device: Device = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_lm(cfg, seed=seed, device=self.device)
        self.params = tm.tree_map(lambda t: t.to(self.device), params)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, batch: Dict[str, torch.Tensor], new_tokens: int,
                 greedy: bool = True,
                 generator: Optional[torch.Generator] = None):
        """Greedy (or, with ``greedy=False`` and a ``generator`` on the
        device, sampled) continuation.  Returns (tokens (B, new_tokens),
        stats)."""
        cfg = self.cfg
        tokens_in = batch["tokens"].to(self.device)
        prompt_len = tokens_in.shape[1]
        max_len = prompt_len + new_tokens
        outs = []

        def pick(lg: torch.Tensor) -> torch.Tensor:
            last = lg[:, -1]
            if greedy or generator is None:
                ids = torch.argmax(last, dim=-1)
            else:
                probs = torch.softmax(last.float(), dim=-1)
                ids = torch.multinomial(probs, 1, generator=generator)[:, 0]
            return ids[:, None]

        with torch.inference_mode():
            self._sync()
            t0 = time.perf_counter()
            logits, cache, _ = prefill(self.params, cfg,
                                       {"tokens": tokens_in}, max_len)
            self._sync()
            t_prefill = time.perf_counter() - t0

            t0 = time.perf_counter()
            nxt = pick(logits)
            for i in range(new_tokens):
                outs.append(nxt)
                logits, cache = decode_step(self.params, cfg, nxt, cache,
                                            prompt_len + i)
                nxt = pick(logits)
            self._sync()
            t_decode = time.perf_counter() - t0
            tokens = (torch.cat(outs, dim=1) if outs else
                      tokens_in.new_zeros(tokens_in.shape[0], 0))
        stats = ServeStats(prefill_s=t_prefill, decode_s=t_decode,
                           tokens_out=int(tokens.numel()))
        return tokens, stats


def main(argv=None) -> int:
    from repro_torch.configs import get_reduced

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # the kernel path: the CUDA kernels on the card, their plain versions
    # on the CPU
    cfg = dataclasses.replace(get_reduced(args.arch), attn_impl="pallas",
                              ssd_impl="pallas")
    eng = Engine(cfg, seed=args.seed, device=args.device)
    gen = seeded_generator(args.seed, eng.device)
    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=eng.device)}
    toks, stats = eng.generate(batch, args.new_tokens,
                               greedy=not args.sample,
                               generator=gen if args.sample else None)
    print(f"[serve] {args.arch}: batch={B} prompt={S} new={args.new_tokens}  "
          f"prefill {stats.prefill_s * 1e3:.0f}ms  "
          f"decode {stats.tok_per_s:.1f} tok/s")
    print(f"[serve] first sequence: {toks[0, :16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
