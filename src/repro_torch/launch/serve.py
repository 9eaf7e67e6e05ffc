"""Batched serving driver: prefill + greedy decode (the counterpart of
``repro/launch/serve.py``).

  1. ``prefill``  a full-prompt forward that builds the KV/SSM cache;
  2. ``decode``   one token per step against the cache, in place.

The engine runs on CUDA unless the caller asks for the CPU, and raises
without a card.  It serves every input mode of the zoo: token prompts,
vlm prompts (``patch_embeds`` then ``tokens``) and audio prompts
(``frame_embeds``), whose decode steps are fed a stand-in of the
generated codes (``decode_input``).  With ``attn_impl``/``ssd_impl``
``"pallas"`` every GQA layer runs the hand-written attention kernel in
prefill and in every decode step, and the SSD scan kernel in prefill;
MLA layers (deepseek) run their plain attention, as in the JAX package.
The cache length is a host int, so the decode loop never waits on the
device until the end.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 32 --new-tokens 16

The CLI serves an arch's reduced config, on the card unless ``--device
cpu`` asks for the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

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


def prompt_length(cfg: TransformerConfig, batch: Dict[str, torch.Tensor]
                  ) -> int:
    """Positions a prompt fills: its tokens, the ``n_prefix_tokens``
    patches before them in vlm mode, or its frames in audio mode."""
    if cfg.input_mode == "tokens":
        return batch["tokens"].shape[1]
    if cfg.input_mode == "vlm":
        return cfg.n_prefix_tokens + batch["tokens"].shape[1]
    return batch["frame_embeds"].shape[1]


def decode_input(cfg: TransformerConfig, ids: torch.Tensor) -> torch.Tensor:
    """Generated ids -> what the next decode step consumes: the ids
    themselves, or for the audio decoder, which consumes frame
    embeddings, the JAX package's stand-in for the stubbed codec
    embedding: a one-hot of ``ids % d_model``, averaged over the
    codebooks (MusicGen sums its codebook embeddings)."""
    if cfg.input_mode != "embeddings":
        return ids
    oh = F.one_hot(ids % cfg.d_model, cfg.d_model).to(cfg.dtype)
    if cfg.n_codebooks > 1:
        oh = oh.mean(dim=2)
    return oh.reshape(ids.shape[0], 1, cfg.d_model)


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
        device, sampled) continuation of a prompt batch of the config's
        input mode.  Returns (tokens (B, new_tokens) — (B, new_tokens,
        n_codebooks) for audio —, stats)."""
        cfg = self.cfg
        batch = {k: v.to(self.device) for k, v in batch.items()}
        prompt_len = prompt_length(cfg, batch)
        max_len = prompt_len + new_tokens
        outs = []

        def pick(lg: torch.Tensor) -> torch.Tensor:
            """logits -> next ids: (B, 1), or (B, 1, n_codebooks)."""
            last = lg[:, -1]
            if greedy or generator is None:
                ids = torch.argmax(last, dim=-1)
            else:
                probs = torch.softmax(last.float(), dim=-1)
                ids = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                                        1, generator=generator)
                ids = ids.reshape(probs.shape[:-1])
            return ids[:, None]

        with torch.inference_mode():
            self._sync()
            t0 = time.perf_counter()
            logits, cache, _ = prefill(self.params, cfg, batch, max_len)
            self._sync()
            t_prefill = time.perf_counter() - t0

            t0 = time.perf_counter()
            nxt = pick(logits)
            for i in range(new_tokens):
                outs.append(nxt)
                logits, cache = decode_step(self.params, cfg,
                                            decode_input(cfg, nxt), cache,
                                            prompt_len + i)
                nxt = pick(logits)
            self._sync()
            t_decode = time.perf_counter() - t0
            tokens = torch.cat(outs, dim=1) if outs else nxt[:, :0]
        stats = ServeStats(prefill_s=t_prefill, decode_s=t_decode,
                           tokens_out=int(tokens.numel()))
        return tokens, stats


def prompt_batch(cfg: TransformerConfig, B: int, S: int,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random prompt batch of the config's input mode on ``gen``'s
    device: ``S`` tokens, ``n_prefix_tokens`` patch embeddings and ``S``
    tokens (vlm), or ``S`` frame embeddings (audio)."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)

    def tokens():
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=dev)
    if cfg.input_mode == "tokens":
        return {"tokens": tokens()}
    if cfg.input_mode == "vlm":
        return {"patch_embeds": normal(B, cfg.n_prefix_tokens, cfg.d_model),
                "tokens": tokens()}
    return {"frame_embeds": normal(B, S, cfg.d_model)}


def main(argv=None) -> int:
    from repro_torch.configs import get_reduced

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
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
    batch = prompt_batch(cfg, B, S, gen)
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
