"""``repro_torch.launch.serve.Engine`` against ``repro.launch.serve.Engine``
on reduced hymba-1.5b: the same params (carried across with the bridge)
and the same numpy prompt give the same greedy tokens.  Batch 2, prompt
40 (longer than the window, 32, and not a multiple of the chunk, 32), 8
new tokens.  The JAX engine runs its Pallas kernels in interpret mode;
the port's engine runs ``"pallas"``, i.e. the kernel wrappers, which take
their plain versions on CPU tensors.

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
from repro_torch.launch.serve import Engine, ServeStats, main
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


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_cli_serves_each_family(arch, capsys):
    assert main(["--arch", arch, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "12", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {arch}: batch=2 prompt=12 new=3" in out
