"""``repro_torch.launch.serve.Engine`` against ``repro.launch.serve.Engine``
on reduced hymba-1.5b: the same params (carried across with the bridge)
and the same numpy prompt give the same greedy tokens.  Batch 2, prompt
40 (longer than the window, 32, and not a multiple of the chunk, 32), 8
new tokens.  The JAX engine runs its Pallas kernels in interpret mode;
the port's engine runs ``"pallas"``, i.e. the kernel wrappers, which take
their plain versions on CPU tensors.

The rest of the zoo the same way: reduced deepseek-v2-lite-16b (MoE +
MLA; the JAX engine's plain attention, the port's MLA takes no kernel),
internvl2-1b (16 patch embeddings + 24 tokens) and musicgen-medium (40
frame embeddings; 4 codes a step, fed back as the stand-in frames).

The sampled path draws from a ``torch.Generator``, whose bits cannot
match ``jax.random.categorical``'s; it is checked for seeding only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_reduced as jget_reduced
from repro.launch.serve import Engine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.serve import (Engine, ServeStats, decode_input,
                                      main, prompt_batch)
from torch_parity import to_torch_params, torch_config

B, S, NEW = 2, 40, 8


def _prompt(vocab):
    return np.random.default_rng(0).integers(0, vocab, (B, S))


def test_greedy_tokens_match_jax_engine():
    jc = dataclasses.replace(jget_reduced("hymba-1.5b"),
                             attn_impl="pallas_interpret",
                             ssd_impl="pallas_interpret")
    jeng = JEngine(jc, seed=0)
    toks = _prompt(jc.vocab_size)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, NEW)

    tc = dataclasses.replace(torch_config(jc), attn_impl="pallas",
                             ssd_impl="pallas")
    eng = Engine(tc, params=to_torch_params(jeng.params), device="cpu")
    launches = (flash_attention.launches, ssd_scan.launches)
    got, stats = eng.generate({"tokens": torch.from_numpy(toks)}, NEW)
    assert got.shape == (B, NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert isinstance(stats, ServeStats) and stats.tokens_out == B * NEW
    assert stats.prefill_s > 0 and stats.decode_s > 0
    # CPU tensors take the plain versions: no kernel launched
    assert (flash_attention.launches, ssd_scan.launches) == launches


def _zoo_prompt(cfg):
    """A numpy prompt of 40 positions in the config's input mode."""
    rng = np.random.default_rng(0)
    if cfg.input_mode == "vlm":
        P = cfg.n_prefix_tokens
        return {"patch_embeds": rng.standard_normal(
                    (B, P, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - P))}
    if cfg.input_mode == "embeddings":
        return {"frame_embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "internvl2-1b",
                                  "musicgen-medium"])
def test_zoo_greedy_tokens_match_jax_engine(arch):
    impl = "xla" if arch.startswith("deepseek") else "pallas_interpret"
    jc = dataclasses.replace(jget_reduced(arch), attn_impl=impl)
    jeng = JEngine(jc, seed=0)
    prompt = _zoo_prompt(jc)
    want, _ = jeng.generate({k: jnp.asarray(v) for k, v in prompt.items()},
                            NEW)
    tc = dataclasses.replace(torch_config(jc), attn_impl="pallas")
    eng = Engine(tc, params=to_torch_params(jeng.params), device="cpu")
    got, stats = eng.generate({k: torch.from_numpy(v)
                               for k, v in prompt.items()}, NEW)
    shape = (B, NEW) + ((tc.n_codebooks,) if tc.n_codebooks > 1 else ())
    assert got.shape == shape and stats.tokens_out == got.numel()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_input_is_the_jax_engines_stand_in():
    """Audio: a one-hot of ``id % d_model`` averaged over the codebooks,
    in the config's dtype; other modes: the ids."""
    cfg = get_reduced("musicgen-medium")
    ids = torch.tensor([[[3, 3, 260, 7]], [[0, 1, 2, 255]]])
    x = decode_input(cfg, ids)
    assert x.shape == (2, 1, cfg.d_model) and x.dtype == cfg.dtype
    assert float(x[0, 0, 3]) == 0.5 and float(x[0, 0, 4]) == 0.25
    assert float(x[0, 0, 7]) == 0.25 and float(x.sum()) == 2.0
    tok = torch.tensor([[5], [6]])
    assert decode_input(get_reduced("internvl2-1b"), tok) is tok


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_prompt_batch_fills_the_input_mode(arch):
    cfg = get_reduced(arch)
    batch = prompt_batch(cfg, 2, 12, torch.Generator().manual_seed(0))
    if cfg.input_mode == "vlm":
        assert batch["patch_embeds"].shape == (2, cfg.n_prefix_tokens,
                                               cfg.d_model)
        assert batch["tokens"].shape == (2, 12)
    else:
        assert set(batch) == {"frame_embeds"}
        assert batch["frame_embeds"].shape == (2, 12, cfg.d_model)


def test_sampled_path_is_seeded():
    cfg = get_reduced("hymba-1.5b")
    eng = Engine(cfg, seed=1, device="cpu")
    prompt = {"tokens": torch.from_numpy(_prompt(cfg.vocab_size))}

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return eng.generate(prompt, NEW, greedy=False, generator=gen)[0]

    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    greedy, _ = eng.generate(prompt, NEW)
    assert not torch.equal(a, greedy)   # random weights: a flat softmax


def test_engine_defaults_to_cuda():
    cfg = get_reduced("qwen1.5-0.5b")
    if torch.cuda.is_available():
        assert Engine(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b",
                                  "deepseek-v3-671b", "internvl2-1b",
                                  "musicgen-medium"])
def test_cli_serves_each_family(arch, capsys):
    assert main(["--arch", arch, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "12", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}: batch=2 prompt=12 new=3" in out


def test_cli_default_arch_is_the_jax_clis(capsys):
    """Without ``--arch`` both CLIs serve qwen2-1.5b (the port on its
    kernel path) and return 0."""
    from repro.launch.serve import main as jmain
    argv = ["--batch", "2", "--prompt-len", "8", "--new-tokens", "2"]
    assert jmain(argv) == 0
    want = capsys.readouterr().out.splitlines()[0]
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()[0]
    assert got.split("  ")[0] == want.split("  ")[0] == \
        "[serve] qwen2-1.5b: batch=2 prompt=8 new=2"
