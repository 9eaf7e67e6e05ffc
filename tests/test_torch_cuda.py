"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  The file
imports torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import layers as L


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_bitwise(gen):
    """Every kernel bit-equal to its plain version, on the 16-byte
    vector path (N a multiple of 1024) and the one-element path."""
    n = 137_216 + 3                    # the vector path and the tail path

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        for nn in (n - 3, n):
            p, g, m = r(nn, dtype=dtype), r(nn, dtype=dtype), r(nn, dtype=dtype)
            sc = torch.tensor([0.7, 0.05], device="cuda")
            a, am = p.clone(), m.clone()
            b, bm = p.clone(), m.clone()
            fu.local_step(a, g, am, None, sc, weight_decay=1e-3, momentum=0.9)
            fu.local_step_plain(b, g, bm, None, sc, weight_decay=1e-3,
                                momentum=0.9)
            assert torch.equal(a, b) and torch.equal(am, bm)
            st = r(10, nn, dtype=dtype)
            w = torch.full((10,), 0.1, device="cuda")
            assert torch.equal(fu.weighted_delta(st, p, w),
                               fu.weighted_delta_plain(st, p, w))
            d = r(nn) * 1e-2
            mu, nu = r(nn, dtype=dtype).abs(), r(nn, dtype=dtype).abs()
            sc3 = torch.tensor([0.5, 0.19, 0.0199], device="cuda")
            a, amu, anu = p.clone(), mu.clone(), nu.clone()
            fu.server_update(a, d, (amu, anu), sc3, opt="adam")
            fu.server_update_plain(p, d, (mu, nu), sc3, opt="adam")
            assert torch.equal(a, p) and torch.equal(amu, mu)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, 137_216 + 3))
def test_weighted_delta_f32_deltas_over_bf16_params_bitwise(gen, n):
    """The compressed and materialized DP uploads: an f32 stack of client
    deltas over bf16 params, with and without ``extra``."""
    p = torch.randn(n, generator=gen, device="cuda").bfloat16()
    st = torch.randn(10, n, generator=gen, device="cuda") * 1e-2
    w = torch.rand(10, generator=gen, device="cuda")
    w = w / w.sum()
    e = torch.randn(n, generator=gen, device="cuda") * 1e-3
    for extra in (None, e):
        got = fu.weighted_delta(st, p, w, extra=extra, deltas=True)
        want = fu.weighted_delta_plain(st, p, w, extra=extra, deltas=True)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(TypeError):
        fu.weighted_delta(st, p, w)             # f32 stack of end states
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
def test_local_step_reads_what_the_op_before_it_wrote(gen, write):
    """K1 is launched with programmatic dependent launch: its blocks may
    start while the op before it drains, and must not read an operand
    before that op is done.  A sleep holds the stream, fresh g, m and
    scalars are written into K1's operands (a copy, or a kernel), and K1
    follows at once at N 16.8 M; it must see the fresh values."""
    n = 16_777_216
    p = torch.randn(n, generator=gen, device="cuda")
    g_new = torch.randn(n, generator=gen, device="cuda")
    m_new = torch.randn(n, generator=gen, device="cuda")
    sc_new = torch.tensor([0.7, 0.05], device="cuda")
    g, m = torch.zeros_like(g_new), torch.zeros_like(m_new)
    sc = torch.zeros(2, device="cuda")
    want, want_m = p.clone(), m_new.clone()
    fu.local_step_plain(want, g_new, want_m, None, sc_new, weight_decay=1e-3,
                        momentum=0.9)
    a = p.clone()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for dst, src in ((g, g_new), (m, m_new), (sc, sc_new)):
        if write == "copy_":
            dst.copy_(src)
        else:
            torch.mul(src, 1.0, out=dst)
    fu.local_step(a, g, m, None, sc, weight_decay=1e-3, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(a, want) and torch.equal(m, want_m)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, 16_777_216))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_local_step_chain_under_graph_capture(gen, dtype, n):
    """A chain of PDL-launched K1 steps, each reading the p and m the
    step before it wrote (K1 triggers its dependents early, so a read
    above griddepcontrol.wait would race here): run eagerly, and captured
    by torch.cuda.graph and replayed twice, both bit-equal to the same
    chain of plain steps."""
    steps = 6
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda").to(dtype)
    gs = [torch.randn(n, generator=gen, device="cuda").to(dtype)
          for _ in range(steps)]
    sc = torch.tensor([0.7, 0.05], device="cuda")
    kw = dict(weight_decay=1e-3, momentum=0.9)
    plain_p, plain_m = p.clone(), m.clone()
    for _ in range(2):
        for g in gs:
            fu.local_step_plain(plain_p, g, plain_m, None, sc, **kw)
    eager_p, eager_m = p.clone(), m.clone()
    for _ in range(2):
        for g in gs:
            fu.local_step(eager_p, g, eager_m, None, sc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(eager_p, plain_p) and torch.equal(eager_m, plain_m)
    cap_p, cap_m = p.clone(), m.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for g in gs:
            fu.local_step(cap_p, g, cap_m, None, sc, **kw)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap_p, plain_p) and torch.equal(cap_m, plain_m)


@pytest.mark.cuda
def test_launch_counts_and_checks(gen):
    fu.reset_launch_counts()
    p = torch.randn(4096, generator=gen, device="cuda")
    sc = torch.tensor([1.0, 0.1], device="cuda")
    fu.local_step(p, p.clone(), None, None, sc)
    fu.weighted_delta(torch.stack([p, p]), p,
                      torch.full((2,), 0.5, device="cuda"))
    fu.server_update(p, torch.zeros_like(p), (), sc[:1], opt="none")
    assert [k.launches for k in fu.KERNELS] == [1, 1, 1]
    with pytest.raises(ValueError):
        fu.local_step(p, p.cpu(), None, None, sc)
    torch.cuda.synchronize()


# K7 / K8 against their plain versions at small odd shapes.  Tolerances:
# both sides compute in f32 from the same inputs but sum in another order
# (the kernel's online softmax and sequential cumsum against dense torch
# ops), so f32 agrees to ~1e-5 and a bf16 output to one bf16 ulp.

def _close(got, want, f32_tol):
    a, b = got.float(), want.float()
    tol = (f32_tol + f32_tol * b.abs() if got.dtype == torch.float32
           else 2.0 ** -7 * b.abs() + f32_tol)
    bad = (a - b).abs() > tol
    assert torch.isfinite(a).all()
    assert not bad.any(), (float((a - b).abs().max()), int(bad.sum()))


FA_CASES = [
    # B, S, T, H, KH, hd, window, q_offset, kv_len
    (2, 100, 100, 25, 5, 64, None, 0, None),      # hymba heads, prefill
    (2, 100, 130, 25, 5, 64, 16, 0, None),        # SWA against a longer cache
    (3, 1, 300, 25, 5, 64, None, 200, None),      # decode
    (3, 1, 300, 25, 5, 64, 64, 299, None),        # decode, window, last slot
    (1, 77, 77, 6, 2, 32, None, 0, None),         # ragged S, G = 3
    (1, 9, 40, 4, 4, 128, None, 31, None),        # hd 128, MHA, 9 queries
    (2, 33, 50, 2, 1, 16, 7, 10, 45),             # hd 16, kv_len < T
    (1, 20, 20, 4, 2, 64, 0, 0, None),            # window 0: all zero
    # the split decode (S * G <= 16 rows per kv head)
    (8, 1, 2112, 25, 5, 64, None, 2111, None),    # hymba, global, full cache
    (8, 1, 2112, 25, 5, 64, 1024, 2048, None),    # hymba, SWA at 2048
    (2, 1, 2112, 25, 5, 64, 40, 1500, None),      # window < a chunk: most
                                                  # splits see no key
    (2, 3, 300, 25, 5, 64, 20, 250, None),        # S * G = 15, rows' own qpos
    (2, 4, 300, 8, 2, 64, None, 200, None),       # S * G = 16, the boundary
    (2, 17, 300, 2, 2, 64, None, 250, None),      # S * G = 17: prefill path
    (2, 1, 300, 25, 5, 64, None, 280, 200),       # kv_len < T, past q_offset
    (2, 2, 300, 10, 5, 128, 100, 150, 131),       # kv_len inside a chunk
    (1, 4, 70, 4, 4, 32, 0, 10, None),            # window 0, S > 1: all zero
    # the wgmma prefill
    (1, 100, 130, 6, 2, 128, None, 30, None),     # hd 128, 300 rows (not a
                                                  # multiple of 128), offset
    (2, 150, 300, 25, 5, 64, 100, 140, None),     # offset, window edge
                                                  # inside a tile
    (1, 200, 230, 10, 5, 128, 37, 10, 190),       # hd 128, window, kv_len
    # internvl2-1b (14 heads on 2: G 7) and musicgen-medium (24 on 24:
    # G 1), hd 64: prefill (wgmma) and the split decode
    (2, 300, 300, 14, 2, 64, None, 0, None),
    (8, 1, 2080, 14, 2, 64, None, 2079, None),
    (2, 2, 300, 14, 2, 64, None, 150, None),      # S * G = 14
    (2, 300, 300, 24, 24, 64, None, 0, None),
    (8, 1, 2080, 24, 24, 64, None, 2048, None),
    # qwen2-1.5b (12 heads on 2: G 6, hd 128), no window: its decode
    # after a 2048-position prompt and 8 tokens (the split decode)
    (8, 1, 2056, 12, 2, 128, None, 2055, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KH,hd,window,q_offset,kv_len", FA_CASES)
def test_flash_attention_matches_plain(gen, dtype, B, S, T, H, KH, hd, window,
                                       q_offset, kv_len):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = r(B, S, H, hd), r(B, T, KH, hd), r(B, T, KH, hd)
    kw = dict(window=window, q_offset=q_offset, kv_len=kv_len)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, fa.flash_attention_plain(q, k, v, **kw), 2e-5)
    if window == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_reuses_its_workspace(gen, dtype):
    """Two decode calls in a row on one workspace: the merging blocks
    reset their tickets, so the second call merges as the first did."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = r(4, 1, 25, 64), r(4, 700, 5, 64), r(4, 700, 5, 64)
    q2 = r(4, 1, 25, 64)
    before = fa.flash_attention.launches
    first = fa.flash_attention(q, k, v, window=300, q_offset=650)
    second = fa.flash_attention(q2, k, v, q_offset=699)
    again = fa.flash_attention(q, k, v, window=300, q_offset=650)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == 3
    _close(first, fa.flash_attention_plain(q, k, v, window=300,
                                           q_offset=650), 2e-5)
    _close(second, fa.flash_attention_plain(q2, k, v, q_offset=699), 2e-5)
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_across_batch_sizes(gen, dtype):
    """Decode at B·KH = 80, then 40, then 80 again on one workspace (a
    server's batch shrinking and growing back): the smaller call's
    partials must not land on the larger call's tickets."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    big = r(16, 1, 25, 64), r(16, 700, 5, 64), r(16, 700, 5, 64)
    small = r(8, 1, 25, 64), r(8, 700, 5, 64), r(8, 700, 5, 64)
    kw = dict(window=300, q_offset=650)
    for q, k, v in (big, small, big):
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        _close(got, fa.flash_attention_plain(q, k, v, **kw), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_two_streams(gen, dtype):
    """Two decodes in flight at once on two streams of one device, each
    against the plain version: each stream has its own partials and
    tickets, so neither merges the other's."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    kw = dict(window=300, q_offset=650)
    calls = [(r(16, 1, 25, 64), r(16, 700, 5, 64), r(16, 700, 5, 64)),
             (r(8, 1, 25, 64), r(8, 700, 5, 64), r(8, 700, 5, 64))]
    want = [fa.flash_attention_plain(q, k, v, **kw) for q, k, v in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, (st, (q, k, v)) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                outs[i].append(fa.flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    for got, ref in zip(outs, want):
        for o in got:
            _close(o, ref, 2e-5)


SSD_CASES = [
    # b, s, h, p, n, g, chunk
    (2, 300, 6, 64, 16, 1, 128),     # hymba-like n, s not a chunk multiple
    (1, 200, 4, 64, 128, 2, 128),    # mamba2's n = 128, grouped B/C
    (2, 70, 3, 32, 16, 3, 32),       # g = h, padded
    (2, 128, 4, 64, 16, 1, 128),     # s exactly one chunk
    (3, 50, 5, 64, 16, 1, 128),      # s < chunk
    (1, 16 * 64 + 1, 4, 64, 16, 2, 64),   # 16 chunks + 1 step
    (1, 96, 4, 128, 32, 4, 32),      # g = h, head_dim 128
    (2, 200, 12, 64, 16, 2, 64),     # 6 heads per group at n = 16
    (1, 2048, 50, 64, 16, 1, 128),   # hymba-1.5b's layer at b = 1
    (1, 40, 3, 32, 8, 1, 40),        # d_state 8, a chunk not a multiple of 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SSD_CASES)
def test_ssd_scan_matches_plain(gen, dtype, b, s, h, p, n, g, chunk):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, B, C = r(b, s, h, p).to(dtype), r(b, s, g, n).to(dtype), \
        r(b, s, g, n).to(dtype)
    dt = torch.nn.functional.softplus(r(b, s, h) - 3.0)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    y, final = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    y_p, f_p = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    _close(y, y_p, 1e-4)
    _close(final, f_p, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_across_shapes(gen, dtype):
    """A large, a small, then the large call again, each against the plain
    version: no workspace or flag state outlives a call."""
    def case(b, s, h, p, n, g, chunk):
        def r(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")
        x, B, C = (r(b, s, h, p).to(dtype), r(b, s, g, n).to(dtype),
                   r(b, s, g, n).to(dtype))
        dt = torch.nn.functional.softplus(r(b, s, h) - 3.0)
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        return x, dt, A, B, C, chunk
    big = case(2, 1000, 8, 64, 32, 2, 128)
    small = case(1, 100, 2, 64, 16, 1, 64)
    for x, dt, A, B, C, chunk in (big, small, big):
        y, final = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        y_p, f_p = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        _close(y, y_p, 1e-4)
        _close(final, f_p, 1e-4)


@pytest.mark.cuda
def test_attention_and_scan_count_launches_and_check(gen):
    q = torch.randn(1, 4, 4, 64, generator=gen, device="cuda")
    fa.flash_attention.launches = ssd.ssd_scan.launches = 0
    fa.flash_attention(q, q, q)
    x = torch.randn(1, 8, 2, 64, generator=gen, device="cuda")
    Bm = torch.randn(1, 8, 1, 16, generator=gen, device="cuda")
    dt = torch.rand(1, 8, 2, generator=gen, device="cuda")
    A = -torch.ones(2, device="cuda")
    ssd.ssd_scan(x, dt, A, Bm, Bm, chunk=4)
    assert (fa.flash_attention.launches, ssd.ssd_scan.launches) == (1, 1)
    with pytest.raises(ValueError):        # no kernel for head_dim 48
        q48 = torch.randn(1, 4, 4, 48, device="cuda")
        fa.flash_attention(q48, q48, q48)
    with pytest.raises(ValueError):        # non-contiguous
        fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):        # too much shared memory
        xb = torch.randn(1, 8, 2, 256, device="cuda")
        Bb = torch.randn(1, 8, 1, 256, device="cuda")
        ssd.ssd_scan(xb, dt, A, Bb, Bb, chunk=128)
    assert (fa.flash_attention.launches, ssd.ssd_scan.launches) == (1, 1)
    torch.cuda.synchronize()


# The client-upload kernels (K4 compress_delta, the top-k threshold, K5
# dp_clip_noise) against their plain versions, bitwise: both round every
# step the same way (_rn intrinsics, rintf, bf16 round-to-nearest-even),
# and the threshold is an exact selection.

UPLOAD_SIZES = (1, 127, 1000, 4099, 137_216)


def _delta(gen, n):
    d = torch.randn(n, generator=gen, device="cuda")
    if n >= 256:
        d[128:256] = 0.0                # an all-zero row
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("n", UPLOAD_SIZES)
@pytest.mark.parametrize("bits", [8, 16, 32])
def test_compress_delta_matches_plain_bitwise(gen, n, bits):
    d = _delta(gen, n)
    k = max(1, -(-n // 4))
    tau = fu.topk_threshold(d, k)
    for topk in (False, True):
        for res in (False, True):
            got = fu.compress_delta(d, tau, bits=bits, topk=topk,
                                    with_residual=res)
            want = fu.compress_delta_plain(d, tau, bits=bits, topk=topk,
                                           with_residual=res)
            got, want = (got, want) if res else ((got,), (want,))
            for g, w in zip(got, want):
                assert torch.equal(g, w), float((g - w).abs().max())
    torch.cuda.synchronize()


def _threshold_inputs(gen, n):
    d = _delta(gen, n)
    ties = torch.randint(-3, 4, (n,), generator=gen, device="cuda") / 4.0
    sub = d * 1e-39                                     # subnormals
    return d, ties, sub, torch.zeros(n, device="cuda")


# the threshold's cut between its one-launch cluster kernel and its four
# radix passes, and the lengths around it
CUT = fu.topk_cut()


@pytest.mark.cuda
@pytest.mark.parametrize("n", UPLOAD_SIZES + (4096 + 3, 4096 + 4, CUT - 1,
                                              CUT, CUT + 1, CUT + 4))
def test_topk_threshold_matches_plain_bitwise(gen, n):
    """Bitwise against the plain bit search, with one launch per call
    up to the cut and four above it."""
    for x in _threshold_inputs(gen, n):
        for k in sorted({1, max(1, n // 4), max(1, n // 2), n}):
            before = fu.topk_threshold.launches
            got = fu.topk_threshold(x, k)
            assert fu.topk_threshold.launches - before == \
                fu.topk_launches(n) == (1 if n <= CUT else 4)
            want = fu.topk_threshold_plain(x, k)
            assert got.view(torch.int32) == want.view(torch.int32), (k, n)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_topk_cluster_kernel_shapes_bitwise(gen):
    """The cluster kernel at lengths up to its cut (16 CTAs × the largest
    slice, which the library's shared-memory size agrees with), bitwise
    against the plain bit search and its own plain twin."""
    smem = fu._lib().up_topk_cluster_smem_bytes
    assert smem(CUT) == 4 * (256 + 2 * 16 * 256 + fu.TOPK_SLICE_MAX)
    assert smem(CUT + 1) == 0
    for n in (1, 4099, 137_216, CUT):
        assert smem(n) == 4 * (256 + 2 * 16 * 256 + fu.topk_slice(n))
        for x in _threshold_inputs(gen, n):
            for k in sorted({1, max(1, n // 4), n}):
                got = fu.topk_threshold(x, k)
                want = fu.topk_threshold_plain(x, k)
                assert got.view(torch.int32) == want.view(torch.int32), (k, n)
                assert fu.topk_cluster_plain(x, k).view(torch.int32) \
                    == want.view(torch.int32)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_topk_threshold_two_streams(gen):
    """Thresholds in flight at once on two streams, one held back by a
    sleep, on both paths: each equals the plain version."""
    xs = [_delta(gen, n) for n in (137_216, 4099, CUT + 1, 137_216)]
    ks = [-(-x.shape[0] // 4) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    taus = []
    for i, (x, k) in enumerate(zip(xs, ks)):
        with torch.cuda.stream(streams[i % 2]):
            if i == 0:
                torch.cuda._sleep(5_000_000)
            taus.append(fu.topk_threshold(x, k))
    torch.cuda.synchronize()
    for x, k, tau in zip(xs, ks, taus):
        want = fu.topk_threshold_plain(x, k)
        assert tau.view(torch.int32) == want.view(torch.int32)


# the top-k compressed upload: one launch of the cluster threshold with
# K4 as its epilogue up to the cut, the threshold's passes then K4 above it

def _same_bits(got, want):
    """(c, r, tau) triples bit for bit (r may be None on both sides)."""
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                float((a - b).abs().max())


def _chain(d, k, bits, res):
    tau = fu.topk_threshold(d, k)
    out = fu.compress_delta(d, tau, bits=bits, topk=True, with_residual=res)
    return (*(out if res else (out, None)), tau)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, CUT, 1000))
@pytest.mark.parametrize("bits", (8, 16, 32))
def test_topk_compress_matches_plain_and_chain_bitwise(gen, n, bits):
    """One fused launch, bit-equal (c, r and τ) to topk_compress_plain
    and to the two-launch chain: the main path's bucket, the cut (each
    CTA's largest slice) and 1,000 (a partial last row, CTAs with empty
    slices, one cluster), an all-zero row and a -0.0; the library sizes
    the launch as stated (shared memory, 1 to rows-per-slice clusters)."""
    lib, slice_ = fu._lib(), fu.topk_slice(n)
    assert lib.up_topk_compress_smem_bytes(n) == \
        4 * (256 + 2 * 16 * 256 + slice_ + slice_ // 32)
    assert 1 <= lib.up_topk_compress_clusters(n) <= slice_ // 128
    d = _delta(gen, n)
    d[5] = -0.0
    for k in sorted({1, max(1, n // 4), n}):
        for res in (False, True):
            before = fu.topk_compress.launches
            got = fu.topk_compress(d, k, bits=bits, with_residual=res)
            assert fu.topk_compress.launches - before == 1
            _same_bits(got, fu.topk_compress_plain(d, k, bits=bits,
                                                   with_residual=res))
            _same_bits(got, _chain(d, k, bits, res))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_topk_compress_past_the_cut_takes_the_chain(gen):
    """One element past the cut: the threshold's four passes, then K4
    (4 + 1 launches, counted by those two), bit-equal to the plain
    version."""
    n = CUT + 1
    d = _delta(gen, n)
    counts = [fu.topk_compress.launches, fu.topk_threshold.launches,
              fu.compress_delta.launches]
    got = fu.topk_compress(d, n // 4, bits=8, with_residual=True)
    assert [fu.topk_compress.launches - counts[0],
            fu.topk_threshold.launches - counts[1],
            fu.compress_delta.launches - counts[2]] == [0, 4, 1]
    _same_bits(got, fu.topk_compress_plain(d, n // 4, bits=8,
                                           with_residual=True))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_topk_compress_two_streams(gen):
    """Fused uploads in flight at once on two streams, one held back by a
    sleep: each equals the plain version."""
    xs = [_delta(gen, n) for n in (137_216, 1000, CUT, 137_216)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            if i == 0:
                torch.cuda._sleep(5_000_000)
            outs.append(fu.topk_compress(x, -(-x.shape[0] // 4), bits=8,
                                         with_residual=True))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        _same_bits(got, fu.topk_compress_plain(x, -(-x.shape[0] // 4),
                                               bits=8, with_residual=True))


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
@pytest.mark.parametrize("with_p", (True, False))
def test_delta_accum_reads_what_the_op_before_it_wrote(gen, write, with_p):
    """K6 is launched with programmatic dependent launch: it must not read
    coeff, d, w or p before the op before it is done.  A sleep holds the
    stream, fresh values are written into all four (a copy, or a kernel),
    and K6 follows at once at N 16.8 M; it must see them."""
    n = 16_777_216
    srcs = {"d": torch.randn(n, generator=gen, device="cuda"),
            "w": torch.randn(n, generator=gen, device="cuda"),
            "p": torch.randn(n, generator=gen, device="cuda"),
            "coeff": torch.tensor([0.37], device="cuda")}
    dst = {k: torch.zeros_like(v) for k, v in srcs.items()}
    want = srcs["d"].clone()
    fu.delta_accum_plain(want, srcs["w"], srcs["p"] if with_p else None,
                         srcs["coeff"])
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for name in ("coeff", "w", "p", "d"):
        if write == "copy_":
            dst[name].copy_(srcs[name])
        else:
            torch.mul(srcs[name], 1.0, out=dst[name])
    fu.delta_accum(dst["d"], dst["w"], dst["p"] if with_p else None,
                   dst["coeff"])
    torch.cuda.synchronize()
    assert torch.equal(dst["d"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
@pytest.mark.parametrize("topk", (True, False))
def test_compress_delta_reads_what_the_op_before_it_wrote(gen, write, topk):
    """K4 is launched with programmatic dependent launch: it must not read
    d or τ before the op before it is done.  A sleep holds the stream,
    fresh values are written into both (a copy, or a kernel), and K4
    follows at once at N 16.8 M; it must see them."""
    n = 16_777_216
    src_d = _delta(gen, n)
    src_tau = fu.topk_threshold(src_d, n // 4).reshape(1)
    d, tau = torch.zeros_like(src_d), torch.zeros_like(src_tau)
    kw = dict(bits=8, topk=topk, with_residual=True)
    want = fu.compress_delta_plain(src_d, src_tau, **kw)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for dst, src in ((tau, src_tau), (d, src_d)):
        if write == "copy_":
            dst.copy_(src)
        else:
            torch.mul(src, 1.0, out=dst)
    got = fu.compress_delta(d, tau, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, 1000))
def test_topk_compress_then_delta_accum_under_graph_capture(gen, n):
    """The compressed pod aggregate's chain: per client the fused upload,
    then the accum-only K6 (PDL) reading the c it wrote, with the
    coefficient a view into one vector.  Run eagerly, and captured by
    torch.cuda.graph and replayed twice, both bit-equal to the plain
    chain."""
    clients = 4
    ds = [_delta(gen, n) for _ in range(clients)]
    w = torch.rand(clients, generator=gen, device="cuda") + 0.5
    coef = w / w.sum()
    k = -(-n // 4)

    def run(acc, compress, accum):
        for j, d in enumerate(ds):
            c, _, _ = compress(d, k, bits=8, with_residual=True)
            accum(acc, c, None, coef[j])
        return acc
    plain = torch.zeros(n, device="cuda")
    for _ in range(2):
        run(plain, fu.topk_compress_plain, fu.delta_accum_plain)
    eager = torch.zeros(n, device="cuda")
    for _ in range(2):
        run(eager, fu.topk_compress, fu.delta_accum)
    torch.cuda.synchronize()
    assert torch.equal(eager, plain)
    cap = torch.zeros(n, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(cap, fu.topk_compress, fu.delta_accum)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 1001, 137_216))
def test_dp_clip_noise_matches_plain_bitwise(gen, n):
    d = torch.randn(n, generator=gen, device="cuda")
    z = torch.randn(n, generator=gen, device="cuda")
    sc = torch.tensor([0.37, 0.11], device="cuda")
    for zz in (None, z):
        assert torch.equal(fu.dp_clip_noise(d, zz, sc),
                           fu.dp_clip_noise_plain(d, zz, sc))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_upload_kernels_count_launches_and_check(gen):
    fu.reset_launch_counts()
    d = torch.randn(4096, generator=gen, device="cuda")
    tau = fu.topk_threshold(d, 100)
    fu.compress_delta(d, tau, bits=8, topk=True)
    fu.dp_clip_noise(d, None, torch.ones(2, device="cuda"))
    assert [k.launches for k in fu.KERNELS] == [0, 0, 0]
    c, r, t2 = fu.topk_compress(d, 100, bits=8, with_residual=True)
    assert [k.launches for k in fu.UPLOAD_KERNELS] == [
        1, fu.topk_launches(4096), 1, 1]
    assert torch.equal(t2, tau) and r is not None
    assert fu.topk_launches(4096) == 1
    with pytest.raises(ValueError):
        fu.topk_threshold(d, 0)
    with pytest.raises(ValueError):
        fu.compress_delta(d, None, bits=8, topk=True)
    with pytest.raises(ValueError):
        fu.compress_delta(d, tau, bits=4)
    with pytest.raises(TypeError):
        fu.dp_clip_noise(d.bfloat16(), None, torch.ones(2, device="cuda"))
    with pytest.raises(ValueError):
        fu.topk_compress(d, 0, bits=8)
    with pytest.raises(ValueError):
        fu.topk_compress(d, 100, bits=4)
    assert fu.compress_delta.launches == 1
    assert fu.topk_compress.launches == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("with_p", (True, False))
@pytest.mark.parametrize("n", (137_216, 137_216 + 5, 7, 0))
def test_delta_accum_matches_plain_bitwise(gen, dtype, with_p, n):
    """K6 bit-equal to its plain version: the vector path, a tail of
    n % V elements, a length under one vector, and N 0; in place on d,
    w and p untouched."""
    d = torch.randn(n, generator=gen, device="cuda") * 1e-2
    w = torch.randn(n, generator=gen, device="cuda").to(dtype)
    p = torch.randn(n, generator=gen, device="cuda").to(dtype) \
        if with_p else None
    c = torch.tensor([0.1234], device="cuda")
    w0, p0 = w.clone(), (p.clone() if with_p else None)
    a, b = d.clone(), d.clone()
    assert fu.delta_accum(a, w, p, c) is a
    fu.delta_accum_plain(b, w, p, c)
    assert torch.equal(a, b)
    assert torch.equal(w, w0) and (not with_p or torch.equal(p, p0))
    # an unaligned view takes the one-element path
    if n > 8:
        a2, b2 = d.clone(), d.clone()
        fu.delta_accum(a2[1:], w[1:], None if p is None else p[1:], c)
        fu.delta_accum_plain(b2[1:], w[1:], None if p is None else p[1:], c)
        assert torch.equal(a2, b2)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_delta_accum_counts_launches_and_checks(gen):
    fu.reset_launch_counts()
    d = torch.zeros(4096, device="cuda")
    w = torch.randn(4096, generator=gen, device="cuda")
    c = torch.tensor([0.5], device="cuda")
    fu.delta_accum(d, w, w, c)
    fu.delta_accum(d, w, None, c)
    assert fu.delta_accum.launches == 2
    assert [k.launches for k in fu.KERNELS + fu.UPLOAD_KERNELS] == [0] * 7
    with pytest.raises(TypeError):
        fu.delta_accum(d, w, w.bfloat16(), c)
    with pytest.raises(TypeError):
        fu.delta_accum(d.bfloat16(), w, None, c)
    assert fu.delta_accum.launches == 2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pod_round_on_a_one_rank_nccl_mesh(gen):
    """One pod P2 round (sequential FedAvg, 4 clients) on the one-rank
    NCCL mesh: one K6 launch per client, one gradient all-reduce per
    SGD step, finite results."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl import pod
    from repro_torch.fl.task import vision_task
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_host_mesh()
    try:
        task = vision_task("mlp", n_classes=10, in_ch=3,
                           seed_kwargs={"img": 32})
        data = DATASETS.get("cifar10-like")(n_clients=8, beta=0.5, seed=0,
                                            n_train=256, n_test=64)
        cfg = pod.PodFLConfig(mesh, rounds=1, clients_per_round=4,
                              spec=pod.PodFLSpec(local_steps=2, batch_size=8,
                                                 update_impl="fused"),
                              sampling="host", eval_every=1)
        fu.reset_launch_counts()
        pod.reset_collective_counts()
        res = pod.run_pod_rounds(task, data, cfg)
        torch.cuda.synchronize()
        assert fu.delta_accum.launches == 4
        assert fu.local_step.launches == 8 and fu.weighted_delta.launches == 0
        assert pod.COLLECTIVES["grad"] == 8
        assert all(bool(torch.isfinite(t).all())
                   for t in res.params.values() for t in t.values())
    finally:
        tmesh.destroy()


# K3's aggregate form and K5's rows form (one launch for a round's
# clients), both launched with programmatic dependent launch: bitwise
# against their plain versions and the chains they replace, and the PDL
# hazards (a read or a store before the op before is done)

@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, 137_216 + 3))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("opt", ("none", "momentum", "adam"))
def test_server_update_aggregate_form_matches_plain_bitwise(gen, n, dtype,
                                                            opt):
    """``server_update(p, None, …, avg=avg)`` bit-equal to its plain
    version and to the torch subtraction followed by the delta form's
    kernel, on the vector path and the one-element path."""
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    avg = (p.float() + 1e-2 * torch.randn(n, generator=gen,
                                          device="cuda")).to(dtype)
    n_m = {"none": 0, "momentum": 1, "adam": 2}[opt]
    moms = [torch.randn(n, generator=gen, device="cuda").abs().to(dtype)
            for _ in range(n_m)]
    sc = torch.tensor([0.5, 0.19, 0.0199][:3 if opt == "adam" else 1],
                      device="cuda")
    runs = []
    for how in ("kernel", "plain", "chain"):
        pp, mm = p.clone(), tuple(m.clone() for m in moms)
        if how == "kernel":
            fu.server_update(pp, None, mm, sc, avg=avg, opt=opt)
        elif how == "plain":
            fu.server_update_plain(pp, None, mm, sc, avg=avg, opt=opt)
        else:
            fu.server_update(pp, avg.float() - pp.float(), mm, sc, opt=opt)
        runs.append((pp, mm))
    torch.cuda.synchronize()
    for pp, mm in runs[1:]:
        assert torch.equal(runs[0][0], pp)
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], mm))


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
@pytest.mark.parametrize("form,opt", [("avg", "momentum"), ("avg", "adam"),
                                      ("delta", "momentum")])
def test_server_update_reads_what_the_op_before_it_wrote(gen, write, form,
                                                         opt):
    """K3 is launched with programmatic dependent launch: it must not read
    scalars, avg (or d), p or the moments before the op before it is
    done, nor write p before that op has read it.  A sleep holds the
    stream; fresh values are written into every operand (a copy, or a
    kernel), a kernel then reads p into a snapshot, and K3 follows at
    once at N 16.8 M, in place on p: it must see the fresh values and
    leave the snapshot whole."""
    n = 16_777_216
    n_m = 2 if opt == "adam" else 1
    srcs = {"p": torch.randn(n, generator=gen, device="cuda"),
            "x": torch.randn(n, generator=gen, device="cuda") * 1e-2,
            "sc": torch.tensor([0.5, 0.19, 0.0199][:3 if opt == "adam"
                                                    else 1], device="cuda")}
    for i in range(n_m):
        srcs[f"m{i}"] = torch.randn(n, generator=gen, device="cuda").abs()
    if form == "avg":
        srcs["x"] = srcs["x"] + srcs["p"]
    dst = {k: torch.zeros_like(v) for k, v in srcs.items()}
    want_p = srcs["p"].clone()
    want_m = tuple(srcs[f"m{i}"].clone() for i in range(n_m))
    x = srcs["x"]
    fu.server_update_plain(want_p, None if form == "avg" else x, want_m,
                           srcs["sc"], avg=x if form == "avg" else None,
                           opt=opt)
    snap = torch.empty_like(srcs["p"])
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for name in srcs:
        if write == "copy_":
            dst[name].copy_(srcs[name])
        else:
            torch.mul(srcs[name], 1.0, out=dst[name])
    torch.mul(dst["p"], 1.0, out=snap)
    moms = tuple(dst[f"m{i}"] for i in range(n_m))
    if form == "avg":
        fu.server_update(dst["p"], None, moms, dst["sc"], avg=dst["x"],
                         opt=opt)
    else:
        fu.server_update(dst["p"], dst["x"], moms, dst["sc"], opt=opt)
    torch.cuda.synchronize()
    assert torch.equal(snap, srcs["p"])
    assert torch.equal(dst["p"], want_p)
    assert all(torch.equal(a, b) for a, b in zip(moms, want_m))


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ("momentum", "adam"))
def test_weighted_delta_then_server_update_under_graph_capture(gen, opt):
    """The P2 round's tail: K2 builds the aggregate, K3 (PDL, aggregate
    form) reads it and updates p and the moments in place, over four
    rounds.  Run eagerly, and captured by torch.cuda.graph and replayed
    twice, both bit-equal to the same chain of plain versions."""
    n, K, rounds = 137_216, 10, 4
    p = torch.randn(n, generator=gen, device="cuda")
    moms = [torch.zeros(n, device="cuda") for _ in range(
        2 if opt == "adam" else 1)]
    stacks = [p[None] + 1e-2 * torch.randn(K, n, generator=gen,
                                           device="cuda")
              for _ in range(rounds)]
    w = torch.rand(K, generator=gen, device="cuda") + 0.5
    w = w / w.sum()
    sc = torch.tensor([0.5, 0.19, 0.0199][:3 if opt == "adam" else 1],
                      device="cuda")

    def run(pp, mm, agg, update):
        for st in stacks:
            avg = agg(st, pp, w)
            update(pp, None, mm, sc, avg=avg, opt=opt)

    plain_p, plain_m = p.clone(), tuple(m.clone() for m in moms)
    for _ in range(2):
        run(plain_p, plain_m, fu.weighted_delta_plain, fu.server_update_plain)
    eager_p, eager_m = p.clone(), tuple(m.clone() for m in moms)
    for _ in range(2):
        run(eager_p, eager_m, fu.weighted_delta, fu.server_update)
    torch.cuda.synchronize()
    assert torch.equal(eager_p, plain_p)
    assert all(torch.equal(a, b) for a, b in zip(eager_m, plain_m))
    cap_p, cap_m = p.clone(), tuple(m.clone() for m in moms)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(cap_p, cap_m, fu.weighted_delta, fu.server_update)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap_p, plain_p)
    assert all(torch.equal(a, b) for a, b in zip(cap_m, plain_m))


def _rows_inputs(gen, K, n, dtype):
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    w = (p.float()[None] + 1e-2 * torch.randn(K, n, generator=gen,
                                              device="cuda")).to(dtype)
    z = torch.randn(K, n, generator=gen, device="cuda")
    scales = torch.rand(K, generator=gen, device="cuda") * 0.8 + 0.2
    return w, p, z, scales, torch.tensor([0.11], device="cuda")


def _per_client(w, p, z, scales, ns):
    """The chain the rows form replaces: per client a subtraction and
    one K5 launch, then the stack."""
    return torch.stack([
        fu.dp_clip_noise(w[k].float() - p.float(),
                         None if z is None else z[k],
                         torch.stack([scales[k], ns.reshape(())]))
        for k in range(w.shape[0])])


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 1001, 137_216))
@pytest.mark.parametrize("K", (1, 10, 25))
def test_dp_clip_noise_rows_matches_plain_and_per_client_bitwise(gen, n, K):
    """One rows-form launch bit-equal to its plain version and to K
    per-client K5 launches, f32 and bf16 end states, with and without
    noise; one launch counted per call."""
    for dtype in (torch.float32, torch.bfloat16):
        w, p, z, scales, ns = _rows_inputs(gen, K, n, dtype)
        for zz in (None, z):
            before = fu.dp_clip_noise.launches
            got = fu.dp_clip_noise_rows(w, p, zz, scales, ns)
            assert fu.dp_clip_noise.launches == before + 1
            assert got.shape == (K, n) and got.dtype == torch.float32
            assert torch.equal(got, fu.dp_clip_noise_rows_plain(
                w, p, zz, scales, ns))
            assert torch.equal(got, _per_client(w, p, zz, scales, ns))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
def test_dp_clip_noise_rows_reads_what_the_op_before_it_wrote(gen, write):
    """The rows form must not read w, p, z or the scales before the op
    before it is done: a sleep, fresh values written into all of them (a
    copy, or a kernel), then the launch at once, K 10 × N 1,677,824."""
    srcs = dict(zip(("w", "p", "z", "scales", "ns"),
                    _rows_inputs(gen, 10, 1_677_824, torch.float32)))
    want = fu.dp_clip_noise_rows_plain(*srcs.values())
    dst = {k: torch.zeros_like(v) for k, v in srcs.items()}
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for name in srcs:
        if write == "copy_":
            dst[name].copy_(srcs[name])
        else:
            torch.mul(srcs[name], 1.0, out=dst[name])
    got = fu.dp_clip_noise_rows(*dst.values())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["copy_", "kernel"])
def test_dp_clip_noise_reads_what_the_op_before_it_wrote(gen, write):
    """The per-client K5 likewise: fresh d, z and scalars behind a
    sleep, then K5 at once at N 16.8 M."""
    n = 16_777_216
    srcs = {"d": torch.randn(n, generator=gen, device="cuda"),
            "z": torch.randn(n, generator=gen, device="cuda"),
            "sc": torch.tensor([0.37, 0.11], device="cuda")}
    want = fu.dp_clip_noise_plain(*srcs.values())
    dst = {k: torch.zeros_like(v) for k, v in srcs.items()}
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for name in srcs:
        if write == "copy_":
            dst[name].copy_(srcs[name])
        else:
            torch.mul(srcs[name], 1.0, out=dst[name])
    got = fu.dp_clip_noise(*dst.values())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["per_client", "rows"])
def test_dp_clip_noise_stores_after_the_op_before_is_done(gen, form):
    """K5's output may be a block the caching allocator has just taken
    back from a tensor the op before still reads: a sleep, a kernel
    reading ``src`` into ``dst``, ``src`` freed, then K5, whose output
    takes ``src``'s block.  K5 must not store before that kernel is
    done, so ``dst`` comes out whole.  The sizes are this test's own, so
    the freed block is the one reused."""
    K, n = (1, 16_777_216 + 2048) if form == "per_client" else \
        (10, 1_677_824 + 1024)
    torch.cuda.empty_cache()            # no cached block of these sizes
    w, p, z, scales, ns = _rows_inputs(gen, K, n, torch.float32)
    d = w[0].float() - p.float()
    src = torch.randn(K * n, generator=gen, device="cuda")
    want_dst = src.clone()
    dst = torch.empty_like(src)
    src_ptr = src.data_ptr()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    torch.mul(src, 1.0, out=dst)
    del src
    if form == "per_client":
        out = fu.dp_clip_noise(d, z[0], torch.stack([scales[0], ns[0]]))
    else:
        out = fu.dp_clip_noise_rows(w, p, z, scales, ns)
    assert out.data_ptr() == src_ptr
    torch.cuda.synchronize()
    assert torch.equal(dst, want_dst)


@pytest.mark.cuda
def test_new_forms_count_launches_and_check(gen):
    """The aggregate form counts on ``server_update.launches``, the rows
    form on ``dp_clip_noise.launches``; both reject what they do not
    take before launching."""
    fu.reset_launch_counts()
    p = torch.randn(4096, generator=gen, device="cuda")
    m = torch.zeros_like(p)
    sc = torch.tensor([0.5], device="cuda")
    fu.server_update(p, None, (m,), sc, avg=p.clone(), opt="momentum")
    w, pp, z, scales, ns = _rows_inputs(gen, 3, 4096, torch.float32)
    fu.dp_clip_noise_rows(w, pp, z, scales, ns)
    assert [k.launches for k in fu.KERNELS] == [0, 0, 1]
    assert [k.launches for k in fu.UPLOAD_KERNELS] == [0, 0, 1, 0]
    with pytest.raises(ValueError):
        fu.server_update(p, torch.zeros_like(p), (m,), sc, avg=p.clone(),
                         opt="momentum")
    with pytest.raises(ValueError):
        fu.server_update(p, None, (m,), sc, opt="momentum")
    with pytest.raises(TypeError):
        fu.server_update(p, None, (m,), sc, avg=p.bfloat16(),
                         opt="momentum")
    with pytest.raises(ValueError):
        fu.dp_clip_noise_rows(w, pp, z, scales[:2], ns)
    with pytest.raises(ValueError):
        fu.dp_clip_noise_rows(w, pp, z[:, :100], scales, ns)
    with pytest.raises(TypeError):
        fu.dp_clip_noise_rows(w.bfloat16(), pp, z, scales, ns)
    assert fu.server_update.launches == 1 and fu.dp_clip_noise.launches == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", (137_216, 1001))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_local_step_c_as_a_row_view_bitwise(gen, dtype, n):
    """SCAFFOLD's K1: ``c`` is row k of the round's (K, N) ``c − c_i``
    stack.  At N 137,216 every row is 16-byte aligned (the vector path);
    at N 1,001 only row 0 is, and K1 takes its one-element path for the
    others.  Each row bit-equal to the plain version, with and without
    momentum, and counted in ``local_step.c_launches``."""
    K = 4
    stack = torch.randn(K, n, generator=gen, device="cuda").to(dtype)
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    g = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda").to(dtype)
    sc = torch.tensor([0.7, 0.05], device="cuda")
    fu.reset_launch_counts()
    for k in range(K):
        c = stack[k]
        assert c.is_contiguous()
        for beta in (0.0, 0.9):
            mk = m.clone() if beta else None
            mp = m.clone() if beta else None
            a, b = p.clone(), p.clone()
            fu.local_step(a, g, mk, c, sc, weight_decay=1e-3, momentum=beta)
            fu.local_step_plain(b, g, mp, c, sc, weight_decay=1e-3,
                                momentum=beta)
            assert torch.equal(a, b)
            if beta:
                assert torch.equal(mk, mp)
    fu.local_step(p.clone(), g, None, None, sc)
    assert fu.local_step.launches == 2 * K + 1
    assert fu.local_step.c_launches == 2 * K
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scaffold_host_round_fused_matches_plain_bitwise():
    """Two SCAFFOLD rounds of the host engine on the card (a small mlp,
    no convolution): the fused path's kernels against the plain twins
    (``fused_interpret``) from the same init and batch indices, bitwise
    in the params and the control variates; K1 launched with ``c`` at
    every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.simulation import FLConfig, run_federated
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import tree_leaves
    task = vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs={"img": 32})
    data = DATASETS.get("cifar10-like")(n_clients=8, beta=0.5, seed=0,
                                        n_train=256, n_test=64)
    init = task.init(torch.Generator().manual_seed(0))

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1009 * rnd + 31 * slot + step)
        return torch.randint(0, data.n_per_client, (8,), generator=g)
    out = {}
    for impl in ("fused", "fused_interpret"):
        fu.reset_launch_counts()
        res = run_federated(task, data, FLConfig(
            algorithm="scaffold", rounds=2, participation=0.5, local_steps=3,
            batch_size=8, lr=0.05, update_impl=impl, sampling="host",
            eval_every=1, batch_indices=indices), init_params=init)
        out[impl] = (tree_leaves(res.params) +
                     tree_leaves(res.state.c_global) +
                     tree_leaves(res.state.c_clients), res.history,
                     fu.local_step.c_launches)
    torch.cuda.synchronize()
    assert out["fused"][2] == 2 * 4 * 3 and out["fused_interpret"][2] == 0
    assert out["fused"][1] == out["fused_interpret"][1]
    for a, b in zip(out["fused"][0], out["fused_interpret"][0]):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_charlm_compressed_round_takes_the_radix_route_bitwise():
    """A compressed P2 round of CharLSTM-256 (one f32 bucket of 814,080,
    above ``topk_cut()``) on the card: each upload is the threshold's
    four radix launches and K4 alone with top-k and the residual, and
    the fused path equals the plain twins (``fused_interpret``) from the
    same init and batch indices, bitwise in the params and the EF rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.compression import CompressionSpec
    from repro_torch.fl.engine import run_rounds
    from repro_torch.fl.simulation import FLConfig
    from repro_torch.fl.task import charlm_task
    from repro_torch.utils.tree_math import tree_leaves
    task = charlm_task()
    data = DATASETS.get("shakespeare-like")(n_clients=4, seq_len=16,
                                            n_seq_per_client=8, n_test=8)
    init = task.init(torch.Generator().manual_seed(0))

    def indices(rnd, slot, step):
        g = torch.Generator().manual_seed(1009 * rnd + 31 * slot + step)
        return torch.randint(0, data.n_per_client, (4,), generator=g)
    out = {}
    for impl in ("fused", "fused_interpret"):
        cfg = FLConfig(rounds=1, participation=0.5, local_steps=2,
                       batch_size=4, lr=0.5, update_impl=impl,
                       sampling="host", eval_every=1, batch_indices=indices,
                       compression=CompressionSpec(bits=8, density=0.25,
                                                   error_feedback=True))
        fu.reset_launch_counts()
        res = run_rounds(task, data, cfg.strategy(), cfg.schedule(),
                         init_params=init)
        out[impl] = (tree_leaves(res.params) +
                     list(res.algo_state["ef_residuals"].values()),
                     res.history, {f.__name__: f.launches
                                   for f in fu.UPLOAD_KERNELS})
    torch.cuda.synchronize()
    assert out["fused"][2] == {"compress_delta": 2, "topk_threshold": 8,
                               "dp_clip_noise": 0, "topk_compress": 0}
    assert out["fused"][1] == out["fused_interpret"][1]
    for a, b in zip(out["fused"][0], out["fused_interpret"][0]):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_cnn_fashion_draws_dropout_on_the_card(gen):
    """A CUDA generator draws CNN-Fashion's keep-mask on the card: the
    same seed repeats the logits, another changes them, and the drawn
    mask equals ``torch.rand < 0.5`` from the same seed."""
    from repro_torch.models import paper_models as pm
    p = pm.cnn_fashion_init(gen)
    x = torch.randn(8, 28, 28, 1, generator=gen, device="cuda")

    def run(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return pm.cnn_fashion_apply(p, x, train=True, rng=g)
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    keep = torch.rand((8, 32 * 7 * 7), device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(3)) < 0.5
    assert torch.equal(run(3), pm.cnn_fashion_apply(p, x, train=True,
                                                    rng=keep))


# --- the sparse client store and the overlapped pipeline (M10) --------------

def _store_rows(ids, n, value):
    """Rows of ``n`` floats per client, each filled with ``value(cid)``."""
    return {"w": torch.stack([torch.full((n,), float(value(int(c))),
                                         device="cuda") for c in ids])}


@pytest.mark.cuda
def test_sparse_store_rewrites_a_staging_buffer_only_after_its_copy(gen):
    """Three plans staged back to back while a sleep holds the store's
    side stream: the third reuses the first's pinned staging buffer, and
    must wait for the first's copy to the card before writing it.  Each
    refilled client must then hold its own spilled row."""
    from repro_torch.fl.engine import SparseClientStateStore
    n = 1 << 20
    store = SparseClientStateStore(capacity=2)
    state = store.init({"w": torch.zeros(n, device="cuda")}, 8)
    for pair in ([0, 1], [2, 3], [4, 5]):
        state = store.prepare_chunk(state, pair)
        store.scatter(state, torch.tensor(pair, device="cuda"),
                      _store_rows(pair, n, lambda c: c + 1))
    torch.cuda.synchronize()                    # 0-3 spilled, 4-5 resident
    with torch.cuda.stream(store._meta["side"]):
        torch.cuda._sleep(50_000_000)
    staged = [store.stage_chunk(ids) for ids in ([0, 1], [6, 7], [2, 3])]
    for s in staged:
        state = store.commit_chunk(state, s)
    dense = store.to_dense(state)["w"]
    want = [1, 2, 3, 4, 5, 6, 0, 0]
    assert [float(dense[c, 0]) for c in range(8)] == want
    for c in range(8):
        assert bool((dense[c] == want[c]).all())
    assert store.refaulted_rows == 4


@pytest.mark.cuda
def test_sparse_store_spills_the_rows_the_previous_dispatch_wrote(gen):
    """The last writes of the dispatch before a commit sit behind a sleep
    on the main stream; the commit's spill gathers the evicted rows after
    them on the main stream and copies them to the host on the side
    stream behind an event, so the spilled rows are the new ones."""
    from repro_torch.fl.engine import SparseClientStateStore
    n = 1 << 20
    store = SparseClientStateStore(capacity=2)
    state = store.prepare_chunk(store.init(
        {"w": torch.zeros(n, device="cuda")}, 6), [0, 1])
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    store.scatter(state, torch.tensor([0, 1], device="cuda"),
                  _store_rows([0, 1], n, lambda c: 100 + c))
    state = store.prepare_chunk(state, [2, 3])  # evicts and spills 0, 1
    state = store.prepare_chunk(state, [0, 1])  # faults them back in
    got = store.gather(state, torch.tensor([0, 1], device="cuda"))["w"]
    assert bool((got[0] == 100).all()) and bool((got[1] == 101).all())
    assert store.spilled_rows == 4 and store.refaulted_rows == 2


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["host", "device"])
def test_sparse_overlap_matches_dense_sync_on_the_card(sampling):
    """SCAFFOLD with int8 + top-k + error-feedback uploads on the card
    (a small mlp: no convolution, so every op repeats bitwise): the
    sparse stores with the overlapped loop against the dense store with
    the synchronous one, bitwise, with rows spilled and faulted back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    import dataclasses
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.fl.compression import CompressionSpec
    from repro_torch.fl.engine import SparseClientStateStore, run_rounds
    from repro_torch.fl.simulation import FLConfig
    from repro_torch.fl.task import vision_task
    from repro_torch.utils.tree_math import tree_leaves
    task = vision_task("mlp", n_classes=10, in_ch=3, seed_kwargs={"img": 32})
    data = DATASETS.get("cifar10-like")(n_clients=16, beta=0.5, seed=0,
                                        n_train=512, n_test=64)
    init = task.init(torch.Generator().manual_seed(0))
    fed = FLConfig(algorithm="scaffold", rounds=8, participation=0.25,
                   local_steps=3, batch_size=8, lr=0.05, update_impl="fused",
                   sampling=sampling, chunk_size=2,
                   compression=CompressionSpec(8, 0.25, True))
    out = {}
    for name, store, overlap in (("dense", None, False),
                                 ("sparse", SparseClientStateStore(8), True)):
        strategy = fed.strategy()
        if store is not None:
            strategy = dataclasses.replace(strategy, state_store=store)
        res = run_rounds(task, data, strategy, dataclasses.replace(
            fed.schedule(), overlap=overlap), init_params=init)
        rows = []
        for key, st in strategy._residency_entries():
            state = res.algo_state[key]
            rows += tree_leaves(st.to_dense(state) if store is not None
                                else state)
        out[name] = (tree_leaves(res.params) + rows +
                     tree_leaves(res.algo_state["c_global"]),
                     [h["local_loss"] for h in res.history], strategy)
    torch.cuda.synchronize()
    assert out["dense"][1] == out["sparse"][1]
    for a, b in zip(out["dense"][0], out["sparse"][0]):
        assert a.is_cuda and torch.equal(a, b)
    stores = out["sparse"][2].residency_stores
    assert len(stores) == 2
    assert all(s.spilled_rows > 0 and s.refaulted_rows > 0 for s in stores)


# ---------------------------------------------------------------------------
# the LM slice: the bf16 instances at tinyllama-1.1b + lora:8's buckets
# ---------------------------------------------------------------------------

N_LORA = 6_307_840              # tinyllama-1.1b's rank-8 adapters, bf16
N_TINYLLAMA = 1_106_356_224     # its base and adapters in one bf16 bucket


@pytest.mark.cuda
@pytest.mark.parametrize("n", (N_LORA, N_LORA + 3))
def test_bf16_kernels_at_the_lora_bucket_bitwise(gen, n):
    """K1 (clip 1, no decay, no momentum: the LM path's step), K2 (bf16
    stack, and f32 deltas over bf16 p), K3 (aggregate form under
    momentum, and the pod's ``none`` apply of an f32 delta) and K6 (bf16
    w and p, f32 d) at the LoRA bucket, each bitwise its plain version."""
    bf16 = torch.bfloat16

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    p, g = r(n, dtype=bf16), r(n, dtype=bf16)
    sc = torch.tensor([1.0, 0.03], device="cuda")
    a, b = p.clone(), p.clone()
    fu.local_step(a, g, None, None, sc)
    fu.local_step_plain(b, g, None, None, sc)
    assert torch.equal(a, b)
    w = torch.full((4,), 0.25, device="cuda")
    st = r(4, n, dtype=bf16)
    assert torch.equal(fu.weighted_delta(st, p, w),
                       fu.weighted_delta_plain(st, p, w))
    d32 = r(4, n) * 1e-2
    assert torch.equal(fu.weighted_delta(d32, p, w, deltas=True),
                       fu.weighted_delta_plain(d32, p, w, deltas=True))
    avg = (p.float() + r(n) * 1e-2).to(bf16)
    m = r(n, dtype=bf16)
    one = torch.tensor([1.0], device="cuda")
    a, am, b, bm = p.clone(), m.clone(), p.clone(), m.clone()
    fu.server_update(a, None, (am,), one, avg=avg, opt="momentum", beta=0.9)
    fu.server_update_plain(b, None, (bm,), one, avg=avg, opt="momentum",
                           beta=0.9)
    assert torch.equal(a, b) and torch.equal(am, bm)
    delta = r(n) * 1e-2
    a, b = p.clone(), p.clone()
    fu.server_update(a, delta, (), one, opt="none")
    fu.server_update_plain(b, delta, (), one, opt="none")
    assert torch.equal(a, b)
    acc = r(n) * 1e-2
    c = torch.tensor([0.25], device="cuda")
    x, y = acc.clone(), acc.clone()
    fu.delta_accum(x, g, p, c)
    fu.delta_accum_plain(y, g, p, c)
    assert torch.equal(x, y)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_local_step_bf16_at_the_whole_model_bitwise():
    """K1 over tinyllama-1.1b + lora:8's whole bucket (~1.1e9 bf16
    elements, 2.2 GB a buffer; P1's step) when the card holds it and the
    plain version's f32 temporaries (~6 buffers of 4.4 GB), else at the
    largest N that fits; elements past 2^31 index right (64-bit
    offsets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    free, _ = torch.cuda.mem_get_info()
    per_elem = 2 * 3 + 4 * 6            # p, g, a clone; f32 temporaries
    n = min(N_TINYLLAMA, (int(0.8 * free) // per_elem) // 1024 * 1024)
    assert n >= 1 << 28, f"only {free} bytes free"
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.randn(n, generator=gen, device="cuda").bfloat16()
    g = torch.randn(n, generator=gen, device="cuda").bfloat16()
    sc = torch.tensor([1.0, 0.03], device="cuda")
    tail = p[-1024:].clone()
    a = p.clone()
    fu.local_step(a, g, None, None, sc)
    fu.local_step_plain(p, g, None, None, sc)
    assert torch.equal(a, p)
    # the last elements were written (no 32-bit wrap of the offsets)
    assert not torch.equal(a[-1024:], tail)
    del a, p, g
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_lora_round_fused_matches_plain_bitwise():
    """Two P2 rounds of the reduced tinyllama-1.1b with lora:4 adapters
    in bf16 on the one-rank NCCL pod: the kernels against their plain
    versions from the same init and draws, bitwise; the frozen leaves
    bitwise the init, every adapter leaf moved; K1 on the adapter bucket
    only (4 per client), K6 per client, K3 per round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    import dataclasses
    from repro_torch.configs import get_reduced, with_peft
    from repro_torch.data.synthetic import make_synthetic_tokenlm
    from repro_torch.fl.pod import PodFLConfig, PodFLSpec, run_pod_rounds
    from repro_torch.fl.task import lm_task
    from repro_torch.launch.mesh import destroy, make_host_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import rules
    from repro_torch.utils.tree_math import tree_leaves
    cfg = dataclasses.replace(
        with_peft(get_reduced("tinyllama-1.1b"), "lora:4"),
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    task = lm_task(cfg)
    data = make_synthetic_tokenlm(n_clients=8, seq_len=32,
                                  n_seq_per_client=8, vocab=cfg.vocab_size)
    init = init_lm(cfg, 0, "cuda")
    mask = rules.trainable_mask(init, "lora")
    mesh = make_host_mesh()
    out = {}
    try:
        for impl in ("fused", "fused_interpret"):
            fu.reset_launch_counts()
            res = run_pod_rounds(task, data, PodFLConfig(
                mesh, rounds=2, clients_per_round=2, spec=PodFLSpec(
                    local_steps=4, batch_size=4, lr=0.05, update_impl=impl,
                    peft="lora:4")), init_params=init)
            out[impl] = (tree_leaves(res.params), res.history,
                         fu.local_step.launches, fu.delta_accum.launches,
                         fu.server_update.launches)
    finally:
        destroy()
    assert out["fused"][2:] == (2 * 2 * 4, 2 * 2, 2)
    assert out["fused_interpret"][2:] == (0, 0, 0)
    assert out["fused"][1] == out["fused_interpret"][1]
    for a, b, i0, m in zip(out["fused"][0], out["fused_interpret"][0],
                           tree_leaves(init), mask):
        assert a.is_cuda and a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert torch.equal(a, i0) != m


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(8, 1), (2, 256)])
def test_moe_is_bitwise_repeatable_in_bf16(gen, B, S):
    """deepseek-v2-lite-16b's MoE layer at full width in bf16, at its
    decode (T 8: C = 1, most pairs dropped) and a prefill-like T 512:
    dispatch writes unique slots and the combine sums the top-6 in k
    order, so with no atomics two calls give the same bits."""
    cfg = L.MoEConfig(d_model=2048, n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, d_ff_shared=2816)
    p = L.init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn(B, S, 2048, generator=gen, device="cuda").bfloat16()
    with L.record_routing() as log:
        a, aux_a = L.moe(p, x, cfg)
        b, aux_b = L.moe(p, x, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert torch.equal(log[0]["topk_idx"], log[1]["topk_idx"])
    if B * S == 8:
        assert log[0]["capacity"] == 1 and int(log[0]["dropped"]) > 0


@pytest.mark.cuda
def test_checkpoint_round_trip_of_cuda_tensors_bitwise(gen, tmp_path):
    """Card tensors (bf16 with its odd bit patterns, f32, int) saved once
    per leaf through the host and restored onto the card, bitwise."""
    from repro_torch.checkpoint import CheckpointManager, load_pytree
    bits = torch.randint(-2 ** 15, 2 ** 15, (3, 1001), generator=gen,
                         device="cuda", dtype=torch.int32).to(torch.int16)
    tree = {"w": bits.view(torch.bfloat16),
            "m": torch.randn(1001, generator=gen, device="cuda"),
            "step": torch.tensor(7, device="cuda"),
            "seq": [torch.randn(4, generator=gen, device="cuda").bfloat16()]}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for r in (1, 2, 3):
        path = mgr.save(r, tree)
    back = mgr.restore(device="cuda")
    host = load_pytree(path)
    def raw(t):         # bf16 NaN patterns compare by their bytes
        return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
    for key in ("w", "m", "step"):
        assert back[key].device.type == "cuda"
        assert back[key].dtype == tree[key].dtype
        assert torch.equal(raw(back[key]), raw(tree[key]))
        assert host[key].device.type == "cpu"
    assert torch.equal(back["seq"][0], tree["seq"][0])
    assert mgr._rounds() == [2, 3]


@pytest.mark.cuda
def test_moe_backward_is_bitwise_repeatable_deterministic(gen):
    """deepseek-v2-lite-16b's MoE layer at full width, bf16, 2 x 256
    tokens: under torch.use_deterministic_algorithms the backward's index
    writes (the dispatch and combine gathers' gradients) sort instead of
    adding with atomics, so two backward passes give the same bits."""
    cfg = L.MoEConfig(d_model=2048, n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, d_ff_shared=2816)
    p = L.init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn(2, 256, 2048, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(2, 256, 2048, generator=gen, device="cuda").bfloat16()
    leaves = [p["router"]["w"], p["experts"]["w_up"]]

    def grads():
        xs = x.clone().requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        y, aux = L.moe(p, xs, cfg)
        out = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                  [xs] + leaves)
        for t in leaves:
            t.requires_grad_(False)
        return out
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = grads(), grads()
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    for ga, gb in zip(a, b):
        assert torch.isfinite(ga.float()).all()
        assert torch.equal(ga, gb)
    assert a[0].abs().sum() > 0 and a[1].abs().sum() > 0
