"""The CUDA kernels against their plain PyTorch versions on the card, at
ragged shapes the main path does not reach (odd dims, query rows spanning
the kernel's row groups and tiles, docs of 1 or more than 256 tokens, one
doc, any L, strided q/k/v), at ``bench.py``'s query batch, a doc's total
independent of the launch it falls in, and the int8 serving path
on the card: streamed search against the device-resident one, and
``Int8Linear`` (``torch._int_mm``) against its CPU result, alone and in a
W8A8 Flan-T5-XL-width block.

Marked ``cuda``; every test skips without a CUDA device. This file imports
no JAX, so it runs on a GPU machine that has none. There, from the
repository root (``--noconftest`` skips ``tests/conftest.py``, which imports
JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention,
    fused_self_attention_reference,
)
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import (  # noqa: E402
    maxsim_scores,
    maxsim_scores_reference,
)
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (  # noqa: E402
    maxsim_scores_int8,
    maxsim_scores_int8_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine, see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(gen, *shape):
    x = torch.randn(*shape, device="cuda", generator=gen)
    return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("B,LQ,N,LD,DIM,masked,score_dtype", [
    (3, 7, 37, 50, 24, True, torch.float32),    # dim % 16 != 0, ragged token tiles
    (3, 7, 37, 50, 24, False, torch.float32),   # unpadded corpus: no mask
    (2, 300, 19, 33, 128, True, torch.float32),  # one query spans three row groups
    (8, 113, 300, 256, 128, True, torch.bfloat16),  # bf16 token scores
    (2, 50, 40, 300, 128, True, torch.float32),  # L_d > 256: a doc spans three token tiles
    (3, 7, 9, 1, 128, True, torch.float32),      # L_d = 1
    (3, 7, 1, 40, 128, False, torch.float32),    # N = 1
    (2, 32, 37, 50, 128, True, torch.float32),   # B * L_q = 64: one whole row tile
    (1, 65, 37, 50, 128, True, torch.float32),   # B * L_q = 65: one row past it
    (128, 96, 300, 256, 128, True, torch.float32),  # bench.py's query batch
    (2, 600, 19, 33, 128, True, torch.float32),  # a query longer than a block's 512 rows
])
def test_k1_matches_plain(gen, B, LQ, N, LD, DIM, masked, score_dtype):
    Q, D = _unit(gen, B, LQ, DIM), _unit(gen, N, LD, DIM)
    mask = None
    if masked:
        lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
        mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
        mask[N // 2] = False  # a whole-padding doc
    launches = maxsim_scores.launches
    got = maxsim_scores(Q, D, mask, score_dtype=score_dtype)
    torch.cuda.synchronize()
    assert maxsim_scores.launches == launches + 1
    ref = maxsim_scores_reference(Q, D, mask, score_dtype=score_dtype)
    # fp32: summation order only, sums of <= 300 maxima of unit dot products
    # (1e-3 abs); whole-padding docs near -9999 * L_q (1e-6 rel). bf16 token
    # scores: a score may round to the neighbouring bf16 value (2^-8 of a
    # unit score) for each of the L_q maxima
    atol = 1e-3 if score_dtype == torch.float32 else LQ * 2 ** -8
    torch.testing.assert_close(got, ref, atol=atol, rtol=1e-6)


def test_k1_rejects_fp32_and_bad_masks(gen):
    Q, D = _unit(gen, 2, 5, 16), _unit(gen, 4, 6, 16)
    with pytest.raises(TypeError):
        maxsim_scores(Q.float(), D.float())
    with pytest.raises(ValueError):
        maxsim_scores(Q, D, torch.ones(4, 5, dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError):
        maxsim_scores(Q, D[:, :, :12])


@pytest.mark.parametrize("B,L,H,masked,strided", [
    (2, 37, 2, True, False),    # L below one tile
    (2, 37, 2, False, True),    # q/k/v as views of one fused projection
    (3, 130, 12, True, False),  # a ragged last tile of queries and keys
    (1, 1, 1, False, False),    # a single token
    (2, 128, 2, True, False),   # exactly one 128-row query block and key tile
    (2, 129, 2, True, False),   # one row past it: a second block with one row
    (2, 256, 3, False, False),  # two whole blocks, two key tiles
    (2, 129, 2, False, True),   # fused-projection views at the block edge
])
def test_k2_matches_plain(gen, B, L, H, masked, strided):
    if strided:
        qkv = torch.randn(B, L, 3 * H * 64, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv.split(H * 64, dim=-1)
    else:
        q, k, v = (torch.randn(B, L, H * 64, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
    bias = None
    if masked:
        lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, num_heads=H, sm_scale=0.125)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, num_heads=H, sm_scale=0.125)
    # bf16 outputs of order 1: the kernel rounds unnormalised probabilities
    # to bf16 and sums in another order (a few bf16 spacings)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


def test_k2_rejects_other_head_dims_and_dtypes(gen):
    # head_dim 104 over 16 heads (ViT-G's) and 256: geometries the JAX gate
    # admits that the per-width kernels do not take run the generic kernel;
    # a width that does not split into the heads and other dtypes raise
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_any)

    for heads, hd in ((16, 104), (2, 256)):
        x = torch.randn(1, 8, heads * hd, device="cuda", generator=gen).to(torch.bfloat16)
        launches = fused_self_attention_any.launches
        got = fused_self_attention(x, x, x, num_heads=heads, sm_scale=0.1)
        assert fused_self_attention_any.launches == launches + 1
        ref = fused_self_attention_reference(x, x, x, num_heads=heads, sm_scale=0.1)
        torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)
    x = torch.randn(1, 8, 100, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError, match="heads"):
        fused_self_attention(x, x, x, num_heads=3, sm_scale=0.1)
    y = torch.randn(1, 8, 128, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        fused_self_attention(*(y.half(),) * 3, num_heads=2, sm_scale=0.125)  # fp16
    z = y.to(torch.bfloat16)
    for hb, err in ((torch.zeros(2, 8, 8, device="cuda", dtype=torch.float16), TypeError),
                    (torch.zeros(2, 8, 9, device="cuda"), ValueError),
                    (torch.zeros(2, 8, 8), ValueError),  # on the CPU
                    (torch.zeros(2, 8, 16, device="cuda")[:, :, :8], ValueError)):
        with pytest.raises(err):
            fused_self_attention(z, z, z, head_bias=hb, num_heads=2, sm_scale=1.0)


@pytest.mark.parametrize("B,L,H,HD,bias_dtype,causal,padded", [
    (2, 37, 2, 64, torch.bfloat16, False, True),   # T5: bf16 head bias, L below one tile
    (3, 130, 4, 64, torch.float32, False, True),   # fp32 head bias, ragged last tiles
    (2, 200, 2, 64, None, True, False),            # causal
    (3, 130, 2, 64, None, True, True),             # causal with right padding
    (2, 100, 3, 80, None, False, True),            # head_dim 80, key padding
    (3, 150, 4, 80, None, True, True),             # OPT: head_dim 80, causal, padding
    (2, 70, 2, 80, torch.bfloat16, True, True),    # every option at once
    (2, 136, 2, 64, torch.bfloat16, False, True),  # bf16 head bias at L % 8 == 0: by TMA
    (2, 256, 3, 64, torch.bfloat16, False, False), # by TMA over two blocks and two key tiles
    (2, 136, 2, 64, torch.float32, False, True),   # fp32 head bias at L % 8 == 0: direct loads
    (3, 136, 2, 80, torch.bfloat16, True, True),   # TMA head bias with every option
    (2, 300, 2, 80, None, True, False),            # causal hd 80: partial diagonal, 3 key tiles
    (3, 129, 2, 80, None, True, True),             # causal hd 80, one row past a block
])
def test_k2_variants_match_plain(gen, B, L, H, HD, bias_dtype, causal, padded):
    q, k, v = (torch.randn(B, L, H * HD, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    bias = None
    if padded:  # right padding, as the rerankers' prompts are padded
        lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    hb = None
    if bias_dtype is not None:
        hb = torch.randn(H, L, L, device="cuda", generator=gen).to(bias_dtype)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5, causal=causal)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    # bf16 outputs of order 1: the kernel rounds unnormalised probabilities
    # to bf16 and sums in another order (a few bf16 spacings)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


NEW_HEAD_DIMS = (16, 32, 48, 96, 112, 128)
# (B, L, heads, head-bias dtype, causal, key padding, strided q/k/v)
WIDTH_CASES = [
    (2, 200, 8, None, False, True, False),            # key bias, two key tiles
    (2, 136, 4, torch.bfloat16, False, True, False),  # bf16 head bias at L % 8 == 0
    (2, 70, 4, torch.bfloat16, True, True, False),    # bf16 head bias read directly, causal
    (2, 130, 2, torch.float32, False, True, True),    # fp32 head bias, strided, ragged tiles
    (3, 257, 2, None, True, False, True),             # causal over three blocks, strided
    (2, 1, 3, None, True, True, False),               # L = 1
]


@pytest.mark.parametrize("HD", NEW_HEAD_DIMS)
@pytest.mark.parametrize("B,L,H,bias_dtype,causal,padded,strided", WIDTH_CASES)
def test_k2_head_widths_match_plain(gen, HD, B, L, H, bias_dtype, causal, padded, strided):
    """K2 bf16 at every head_dim it takes beyond 64 and 80 (the column boxes
    of 64, 32 and 16, and the head bias by TMA up to hd 96 and read
    directly beyond) against its plain version."""
    width = H * HD
    if strided:  # views of one [B, L, 3 * width] projection
        qkv = torch.randn(B, L, 3 * width, device="cuda", generator=gen).to(torch.bfloat16)
        q, k, v = qkv.split(width, dim=-1)
    else:
        q, k, v = (torch.randn(B, L, width, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
    bias = None
    if padded:
        lens = torch.randint(max(1, L // 2), L + 1, (B,), device="cuda", generator=gen)
        bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    hb = None
    if bias_dtype is not None:
        hb = torch.randn(H, L, L, device="cuda", generator=gen).to(bias_dtype)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5, causal=causal)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    # bf16 outputs of order 1, as in test_k2_matches_plain
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("HD", NEW_HEAD_DIMS)
@pytest.mark.parametrize("B,L,H,bias_dtype,causal,padded,strided", WIDTH_CASES + [
    (3, 24, 12, None, False, True, False),            # 2 heads an item
    (3, 16, 5, torch.float32, True, True, False),     # 4 heads an item, a partial group
])
def test_k2_f32_head_widths_match_plain(gen, HD, B, L, H, bias_dtype, causal, padded, strided):
    """K2's fp32 path at every head_dim it takes beyond 64 and 80 (copy
    passes of 16, 8 and 4 chunks; Q read from two alternating buffers from
    hd 96) against its plain version, within the fp32 path's tolerance."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    width = H * HD
    if strided:
        qkv = torch.randn(B, L, 3 * width, device="cuda", generator=gen)
        q, k, v = qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]
    else:
        q, k, v = (torch.randn(B, L, width, device="cuda", generator=gen) for _ in range(3))
    bias = None
    if padded:
        keep = torch.rand(B, L, device="cuda", generator=gen) > 0.3
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e9)
    hb = None
    if bias_dtype is not None:
        hb = torch.randn(H, L, L, device="cuda", generator=gen).to(bias_dtype)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5, causal=causal)
    launches = fused_self_attention_f32.launches
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    torch.cuda.synchronize()
    assert fused_self_attention_f32.launches == launches + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unpackable_head_geometry_takes_the_unfused_path(gen, dtype):
    """BERT, the T5 encoder and OPT at 4 heads x 16 (evqa_flmr.json's
    geometry) with use_pallas_attention on the card: the JAX gate refuses
    it, so neither K2 kernel launches, and the output matches the CPU's on
    the same weights."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig, BertModel
    from reranking_multimodal_retrievers_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import (
        T5Config, T5ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    models = [
        (BertModel(BertConfig.tiny(use_pallas_attention=True, hidden_size=64,
                                   num_attention_heads=4, intermediate_size=128),
                   dtype=dtype, generator=gen),
         lambda m, ids, am: m(ids, am)["last_hidden_state"]),
        (T5ForConditionalGeneration(
            T5Config(use_pallas_attention=True, vocab_size=96, d_model=64, d_kv=16, d_ff=128,
                     num_layers=2, num_decoder_layers=1, num_heads=4),
            dtype=dtype, generator=gen),
         lambda m, ids, am: m.encode(ids, am)),
        (OPTForCausalLM(OPTConfig.tiny(use_pallas_attention=True, hidden_size=64,
                                       num_attention_heads=4, ffn_dim=128),
                        dtype=dtype, generator=gen),
         lambda m, ids, am: m.hidden_states(ids, am)),
    ]
    ids = torch.randint(2, 64, (3, 40), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, 25:] = 0
    for model, run in models:
        launches = (fused_self_attention.launches, fused_self_attention_f32.launches)
        with torch.inference_mode():
            got = run(model, ids, am).float()
        assert (fused_self_attention.launches, fused_self_attention_f32.launches) == launches
        with torch.inference_mode():
            want = run(model.cpu(), ids.cpu(), am.cpu()).float()
        # bf16: two layers of activations of order 1 on two devices; fp32:
        # the same sums in another order
        tol = dict(atol=6e-2, rtol=0) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.parametrize("L,causal", [(45, False), (200, True)])
def test_k2_strided_views_at_head_dim_80(gen, L, causal):
    """q, k and v as views of one fused [B, L, 3 * H * 80] projection: the
    kernel's tensor maps take the row stride 3 * H * 80 and the offsets."""
    B, H, HD = 2, 2, 80
    qkv = torch.randn(B, L, 3 * H * HD, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * HD, dim=-1)
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5, causal=causal)
    got = fused_self_attention(q, k, v, bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, **kw)
    # bf16 outputs of order 1, as in test_k2_matches_plain
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("HD,causal,bias_dtype", [
    (64, False, None),
    (80, True, None),
    (64, False, torch.bfloat16),
])
def test_k2_row_with_every_key_masked(gen, HD, causal, bias_dtype):
    """A batch row whose key bias is -1e9 everywhere: -1e9 swamps the scores
    in fp32, so JAX and the plain version average V uniformly (under the
    causal mask, over the keys up to the query); the kernel's running max
    stays finite and it must do the same."""
    B, L, H = 3, 200, 2
    q, k, v = (torch.randn(B, L, H * HD, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    bias[1] = -1e9
    hb = None
    if bias_dtype is not None:
        hb = torch.randn(H, L, L, device="cuda", generator=gen).to(bias_dtype)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5, causal=causal)
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    assert bool(torch.isfinite(got).all())
    # bf16 outputs of order 1, as in test_k2_matches_plain
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


def test_k2_head_bias_at_large_scores(gen):
    """T5's launch shape with unscaled q (T5 takes sm_scale 1): scores of
    std 8, near-argmax attention, plus a bf16 head bias and padded keys."""
    B, L, H, HD = 10, 544, 32, 64
    q, k, v = (torch.randn(B, L, H * HD, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 2, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    hb = torch.randn(H, L, L, device="cuda", generator=gen).to(torch.bfloat16)
    got = fused_self_attention(q, k, v, bias, hb, num_heads=H, sm_scale=1.0)
    ref = fused_self_attention_reference(q, k, v, bias, hb, num_heads=H, sm_scale=1.0)
    # near-argmax rows output about one row of v, up to |v| ~ 5, where one
    # bf16 spacing is 2^-5 > 3e-2: the bound at scores of order 1 plus half
    # a bf16 spacing of the output (2^-8 relative)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=2 ** -8)


@pytest.mark.parametrize("L,heads,hd,fuses", [(45, 8, 80, True), (37, 2, 64, True),
                                              (45, 2, 80, False), (37, 3, 64, False),
                                              (37, 4, 16, False)])
def test_opt_kernel_path_at_any_length_and_head_grouping(gen, L, heads, hd, fuses):
    """OPT on the card fuses a masked self-attention at any L, also one that
    is not a multiple of 8, where the JAX gate admits the head grouping
    (8 x 80, 2 x 64); at a grouping the TPU kernel cannot pack into 128
    lanes (2 x 80, 3 x 64, 4 x 16) it takes the unfused path, as the JAX
    package does. The same weights without use_pallas_attention take the
    plain path."""
    from reranking_multimodal_retrievers_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

    kw = dict(hidden_size=heads * hd, num_attention_heads=heads, ffn_dim=256)
    fused = OPTForCausalLM(OPTConfig.tiny(use_pallas_attention=True, **kw),
                           dtype=torch.bfloat16, generator=gen)
    plain = OPTForCausalLM(OPTConfig.tiny(**kw), dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(2, 64, (3, L), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, L - 9:] = 0
    launches = fused_self_attention.launches
    with torch.inference_mode():
        a = fused.hidden_states(ids, am).float()
        b = plain.hidden_states(ids, am).float()
    assert fused_self_attention.launches == launches + (2 if fuses else 0)  # one per layer
    # two bf16 pre-LN layers and the final LayerNorm: activations of order 1
    torch.testing.assert_close(a, b, atol=6e-2, rtol=0)


def test_t5_kernel_path_at_odd_head_count(gen):
    """T5's encoder on the card does not fuse at 3 heads x 64, which the TPU
    kernel cannot pack: it takes the unfused path, as the JAX package does,
    and agrees with the plain path on the same weights."""
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import (
        T5Config, T5ForConditionalGeneration)

    kw = dict(vocab_size=96, d_model=192, d_kv=64, d_ff=256, num_layers=2,
              num_decoder_layers=1, num_heads=3)
    fused = T5ForConditionalGeneration(
        T5Config(use_pallas_attention=True, position_bias_bf16=True, **kw),
        dtype=torch.bfloat16, generator=gen)
    plain = T5ForConditionalGeneration(T5Config(**kw), dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(2, 96, (3, 45), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[2, 30:] = 0
    launches = fused_self_attention.launches
    with torch.inference_mode():
        a = fused.encode(ids, am).float()
        b = plain.encode(ids, am).float()
    assert fused_self_attention.launches == launches
    # two bf16 blocks and the final RMS norm (the bias in bf16 on one side)
    torch.testing.assert_close(a, b, atol=6e-2, rtol=0)


def test_bert_kernel_path_matches_plain_path(gen):
    """A bf16 BERT with use_pallas_attention routes self-attention through
    K2; the same weights without it take the plain path."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig, BertModel

    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
    fused = BertModel(BertConfig.tiny(use_pallas_attention=True, **kw),
                      dtype=torch.bfloat16, generator=gen)
    plain = BertModel(BertConfig.tiny(**kw), dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(1, 1000, (3, 45), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, 30:] = 0
    launches = fused_self_attention.launches
    with torch.inference_mode():
        a = fused(ids, am)["last_hidden_state"].float()
        b = plain(ids, am)["last_hidden_state"].float()
    assert fused_self_attention.launches == launches + 2  # one per layer
    # two bf16 layers of LayerNorm'd activations of order 1
    torch.testing.assert_close(a, b, atol=6e-2, rtol=0)


def test_bert_fp32_kernel_path_matches_plain_path(gen):
    """An fp32 BERT with use_pallas_attention, as the executors build it,
    routes self-attention through K2's fp32 kernel (before it existed, K2
    raised TypeError on fp32); the same weights without the flag take the
    plain path. TF32 is off: the JAX package's tolerance for the same
    comparison (tests/test_maxsim_pallas.py)."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig, BertModel
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
    fused = BertModel(BertConfig.tiny(use_pallas_attention=True, **kw), generator=gen)
    plain = BertModel(BertConfig.tiny(**kw))
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(1, 1000, (3, 45), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, 30:] = 0
    launches = fused_self_attention_f32.launches
    with torch.inference_mode():
        a = fused(ids, am)["last_hidden_state"]
        b = plain(ids, am)["last_hidden_state"]
    assert a.dtype == torch.float32
    assert fused_self_attention_f32.launches == launches + 2  # one per layer
    torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


def test_t5_fp32_kernel_path_matches_plain_path(gen):
    """An fp32 T5 encoder under use_pallas_attention, as an executor would
    build it, fuses each encoder self-attention into K2's fp32 path with the
    relative-position bias as an fp32 head bias (before the fp32 kernel took
    one, the wrapper raised NotImplementedError); the same weights without
    the flag take the plain path. TF32 off, as in the BERT case."""
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import (
        T5Config, T5ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    kw = dict(vocab_size=96, d_model=128, d_kv=64, d_ff=256, num_layers=2,
              num_decoder_layers=1, num_heads=2)
    fused = T5ForConditionalGeneration(T5Config(use_pallas_attention=True, **kw), generator=gen)
    plain = T5ForConditionalGeneration(T5Config(**kw))
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(2, 96, (3, 45), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[2, 30:] = 0
    launches = fused_self_attention_f32.launches
    with torch.inference_mode():
        a = fused.encode(ids, am)
        b = plain.encode(ids, am)
    assert a.dtype == torch.float32
    assert fused_self_attention_f32.launches == launches + 2  # one per encoder layer
    torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("L,heads,hd", [(45, 8, 80), (37, 2, 64), (37, 4, 32)])
def test_opt_fp32_kernel_path_matches_plain_path(gen, L, heads, hd):
    """An fp32 OPT under use_pallas_attention fuses each masked
    self-attention into K2's fp32 path with the causal mask (before, the
    wrapper raised NotImplementedError); the same weights without the flag
    take the plain path."""
    from reranking_multimodal_retrievers_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    kw = dict(hidden_size=heads * hd, num_attention_heads=heads, ffn_dim=256)
    fused = OPTForCausalLM(OPTConfig.tiny(use_pallas_attention=True, **kw), generator=gen)
    plain = OPTForCausalLM(OPTConfig.tiny(**kw))
    plain.load_state_dict(fused.state_dict())
    ids = torch.randint(2, 64, (3, L), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, L - 9:] = 0
    launches = fused_self_attention_f32.launches
    with torch.inference_mode():
        a = fused.hidden_states(ids, am)
        b = plain.hidden_states(ids, am)
    assert a.dtype == torch.float32
    assert fused_self_attention_f32.launches == launches + 2  # one per layer
    torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("B,L,H,HD,masked,strided,hb_dtype,causal,scale", [
    (3, 24, 12, 64, True, False, None, False, None),   # the FLMR doc encoder's L: 2 heads an item
    (2, 45, 2, 80, True, True, None, False, None),     # head_dim 80, strided q/k/v
    (5, 80, 12, 64, True, False, None, False, None),   # two key tiles
    (1, 1, 4, 64, False, False, None, False, None),    # L = 1: 4 heads an item
    (2, 130, 3, 80, False, False, None, False, None),  # three key tiles, no mask
    (2, 1, 3, 80, True, False, None, True, None),      # L = 1, causal, one row all masked
    (3, 16, 5, 64, True, False, torch.float32, True, None),  # 4 heads an item, a partial group
    (3, 24, 3, 80, True, True, torch.bfloat16, False, None),  # 2 heads an item, bf16 head bias
    (3, 24, 12, 64, True, False, torch.float32, True, None),  # every option at the doc encoder's L
    (2, 37, 2, 80, True, False, torch.bfloat16, True, None),  # hd 80, every option, ragged tiles
    (2, 37, 3, 64, True, True, None, True, None),      # causal, strided
    (3, 130, 2, 64, True, False, torch.float32, False, None),  # fp32 head bias, ragged key tile
    (2, 130, 2, 80, True, True, None, True, None),     # causal hd 80 across three query blocks
    (4, 161, 12, 64, True, False, None, False, None),  # the cross-encoder's L
    (2, 161, 4, 64, True, False, torch.float32, False, 1.0),  # T5's sm_scale 1: |scores| ~ 30
    (8, 48, 32, 64, True, False, torch.float32, False, 1.0),  # the captioner's encoder, prompted
    (2, 161, 2, 80, True, True, torch.bfloat16, True, None),  # every option at 161
    (2, 300, 2, 64, True, False, None, True, None),    # causal: tiles above the diagonal skipped
    (2, 300, 2, 80, False, False, torch.float32, False, None),  # five key tiles, fp32 head bias
    (2, 300, 3, 64, True, True, torch.bfloat16, True, None),  # every option, five query blocks
])
def test_k2_f32_matches_plain(gen, B, L, H, HD, masked, strided, hb_dtype, causal, scale):
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    width = H * HD
    if strided:  # q/k/v as views of one [B, L, 3 * width] projection
        qkv = torch.randn(B, L, 3 * width, device="cuda", generator=gen)
        q, k, v = qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]
    else:
        q, k, v = (torch.randn(B, L, width, device="cuda", generator=gen) for _ in range(3))
    bias = None
    if masked:
        keep = torch.rand(B, L, device="cuda", generator=gen) > 0.3
        keep[:, 0] = True
        keep[-1] = False  # a row whose keys are all masked
        bias = torch.where(keep, 0.0, -1e9)
    hb = None
    if hb_dtype is not None:
        hb = torch.randn(H, L, L, device="cuda", generator=gen).to(hb_dtype)
    kw = dict(num_heads=H, sm_scale=HD ** -0.5 if scale is None else scale, causal=causal)
    launches = fused_self_attention_f32.launches
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    torch.cuda.synchronize()
    assert fused_self_attention_f32.launches == launches + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-5)


def test_k2_f32_refuses_layouts_its_copies_cannot_read(gen):
    """K2's fp32 path copies q/k/v in 16-byte pieces: a view 4 bytes into
    its storage, or a row stride that is not a multiple of 4 elements, is
    refused with ValueError, not copied; other dtypes and head dims raise
    as the bf16 path does."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    x = torch.randn(2, 8, 128, device="cuda", generator=gen)
    buf = torch.randn(2 * 8 * 128 + 1, device="cuda", generator=gen)
    moved = buf[1:].view(2, 8, 128)
    assert moved.data_ptr() % 16 != 0
    wide = torch.randn(2, 8, 130, device="cuda", generator=gen)[..., :128]  # row stride 130
    for bad in (moved, wide):
        with pytest.raises(ValueError, match="16-byte"):
            fused_self_attention(bad, x, x, num_heads=2, sm_scale=0.125)
    with pytest.raises(TypeError):
        fused_self_attention_f32(*(x.to(torch.bfloat16),) * 3, num_heads=2, sm_scale=0.125)
    for heads, hd in ((16, 104), (2, 256)):  # admitted by the JAX gate: the generic kernel
        y = torch.randn(1, 8, heads * hd, device="cuda", generator=gen)
        torch.testing.assert_close(
            fused_self_attention(y, y, y, num_heads=heads, sm_scale=0.1),
            fused_self_attention_reference(y, y, y, num_heads=heads, sm_scale=0.1),
            rtol=1e-4, atol=2e-5)
    launches = fused_self_attention_f32.launches
    fused_self_attention(x, x, x, num_heads=2, sm_scale=0.125)
    assert fused_self_attention_f32.launches == launches + 1


@pytest.mark.parametrize("L", [640, 369])
def test_k2_at_the_interaction_launch_shapes(gen, L):
    """K2 at the interaction reranker's launch shapes: [100, 128 + 512,
    12 x 64] (bench.py's traffic) and [100, 113 + 256, 12 x 64] (FLMR's
    query rows and an index's doc rows), doc tails padded."""
    B, H = 100, 12
    q, k, v = (torch.randn(B, L, H * 64, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(L // 3, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, num_heads=H, sm_scale=0.125)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, num_heads=H, sm_scale=0.125)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


def test_k2_at_the_monopreflmr_l_joint_length(gen):
    """K2 at monoPreFLMR-L's cross-encoder length, [4, 512 + 32 + 256, 12 x
    64]: text tails padded within the first 512 keys (one row unpadded),
    the 288 vision rows after them always valid."""
    B, L, H = 4, 800, 12
    q, k, v = (torch.randn(B, L, H * 64, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    tlen = torch.tensor([512, 37, 300, 511], device="cuda")
    pos = torch.arange(L, device="cuda")[None, :]
    bias = torch.where((pos < tlen[:, None]) | (pos >= 512), 0.0, -1e9)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, num_heads=H, sm_scale=0.125)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, num_heads=H, sm_scale=0.125)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


def test_w8a8_t5_xl_block_on_card_equals_cpu(gen):
    """One Flan-T5-XL-width encoder block (d_model 2048, 32 heads x 64, d_ff
    5120) with quantize_int8 in bf16 on the card, K2 with its bf16 head
    bias: each W8A8 layer's output is bitwise the same layer's on the CPU
    for the card's input (the quantizers and ``_int_mm`` are exact on both),
    and the encoder's output is the CPU's (plain attention) up to bf16
    round-off."""
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import (
        T5Config, T5ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear

    cfg = T5Config.flan_t5_xl(vocab_size=512, num_layers=1, num_decoder_layers=1,
                              quantize_int8=True, use_pallas_attention=True,
                              position_bias_bf16=True)
    card = T5ForConditionalGeneration(cfg, dtype=torch.bfloat16, generator=gen).eval()
    cpu = T5ForConditionalGeneration(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, assign=True)
    layers = {n: m for n, m in card.encoder.named_modules() if isinstance(m, Int8Linear)}
    assert len(layers) == 7  # q, k, v, o, wi_0, wi_1, wo
    seen = {}

    def keep(name):
        def hook(module, args, out):
            seen.setdefault(name, (args[0].clone(), out.clone()))
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in layers.items()]
    ids = torch.randint(2, 512, (3, 96), device="cuda", generator=gen)
    am = torch.ones_like(ids)
    am[1, 40:] = 0
    launches = fused_self_attention.launches
    try:
        with torch.inference_mode():
            got = card.encode(ids, am).float().cpu()
    finally:
        for h in hooks:
            h.remove()
    assert fused_self_attention.launches == launches + 1
    assert set(seen) == set(layers)
    cpu_layers = dict(cpu.encoder.named_modules())
    with torch.inference_mode():
        for n, (x, y) in seen.items():
            assert torch.equal(y.cpu(), cpu_layers[n](x.cpu())), n
        want = cpu.eval().encode(ids.cpu(), am.cpu()).float()
    # one bf16 block and the final RMS norm, values of order 1 and up to
    # ~16: two bf16 spacings of each value (2^-8 relative each), and an
    # additive 0.1 where the two attention paths' bf16 outputs differ by a
    # spacing and a W8A8 code of the next layer moves by one (a code step
    # is 1/127 of its row's largest value, 0.06 at one output here)
    torch.testing.assert_close(got, want, atol=0.1, rtol=2 ** -7)


@pytest.mark.parametrize("interaction_type,launches_per_call", [("CrossEncoder", 2),
                                                                ("MORES", 0)])
def test_interaction_kernel_path_matches_plain_path(gen, interaction_type, launches_per_call):
    """The interaction reranker in bf16 with use_pallas_attention: the
    CrossEncoder type routes each layer's self-attention through K2 (any
    L: here 45 + 60), MORES launches nothing; the same weights without the
    flag take the plain path."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        InteractionRerankConfig, InteractionRerankModel)

    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=512)
    fused = InteractionRerankModel(InteractionRerankConfig(
        cross_encoder=BertConfig.tiny(use_pallas_attention=True, **kw),
        interaction_type=interaction_type), dtype=torch.bfloat16, generator=gen)
    plain = InteractionRerankModel(InteractionRerankConfig(
        cross_encoder=BertConfig.tiny(**kw), interaction_type=interaction_type),
        dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    nway = 3
    q = torch.randn(2, 45, 128, device="cuda", generator=gen).to(torch.bfloat16)
    d = torch.randn(2 * nway, 60, 128, device="cuda", generator=gen).to(torch.bfloat16)
    qm = torch.ones(2, 45, dtype=torch.int32, device="cuda")
    dm = torch.ones(2 * nway, 60, dtype=torch.int32, device="cuda")
    qm[1, 30:], dm[2, 40:] = 0, 0
    launches = fused_self_attention.launches
    with torch.inference_mode():
        a = fused(q, d, nway - 1, qm, dm).logits.float()
        b = plain(q, d, nway - 1, qm, dm).logits.float()
    assert fused_self_attention.launches == launches + launches_per_call
    # two bf16 layers of LayerNorm'd activations of order 1, then a head
    # with weights of std 0.02 over 128 of them: logits of std ~0.2
    torch.testing.assert_close(a, b, atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_path_matches_its_plain_version(gen, dtype):
    """``segment_attention`` on the card (``scaled_dot_product_attention``
    with the segment mask) against its plain version on the CPU, and a
    BERT with use_flash_attention at L = 384 against the same weights on
    the unfused path with the segment bias, every row."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import (
        BertConfig, BertModel, segment_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, L, hd = 3, 2, 384, 64
    q, k, v = (torch.randn(B, H, L, hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    seg = torch.ones(B, L, dtype=torch.int32, device="cuda")
    seg[1, 300:], seg[2, 100:] = 0, 0
    got = segment_attention(q, k, v, seg, sm_scale=hd ** -0.5).float().cpu()
    want = segment_attention(q.cpu(), k.cpu(), v.cpu(), seg.cpu(), sm_scale=hd ** -0.5).float()
    # fp32: another order of fp32 sums; bf16: the library's bf16 roundings
    atol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, atol=atol, rtol=0)

    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=512)
    model = BertModel(BertConfig.tiny(use_flash_attention=True, **kw), dtype=dtype,
                      generator=gen)
    ids = torch.randint(1, 1000, (B, L), device="cuda", generator=gen) * seg
    same = seg.bool()[:, :, None] == seg.bool()[:, None, :]
    with torch.inference_mode():
        a = model(ids, seg)["last_hidden_state"].float()
        b = model(ids, None, attention_adj=torch.where(same, 0.0, -1e9))["last_hidden_state"]
    torch.testing.assert_close(a, b.float(), atol=1e-4 if dtype == torch.float32 else 6e-2,
                               rtol=0)


def _codes(gen, *shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, device="cuda", generator=gen, dtype=torch.int8)


@pytest.mark.parametrize("B,LQ,N,LD,DIM,masked", [
    (3, 7, 37, 50, 32, True),     # ragged token tiles, the smallest dim
    (3, 7, 37, 50, 64, False),    # unpadded corpus: no mask
    (2, 300, 19, 33, 128, True),  # one query spans three row groups
    (8, 113, 300, 256, 128, True),  # the main path's query batch
    (2, 50, 40, 300, 128, True),   # L_d > 256: a doc spans three token tiles
    (3, 7, 9, 1, 64, True),        # L_d = 1
    (3, 7, 1, 40, 128, False),     # N = 1
    (2, 32, 37, 50, 128, True),    # B * L_q = 64: one whole row tile
    (1, 65, 37, 50, 128, True),    # B * L_q = 65: one row past it
    (128, 96, 300, 256, 128, True),  # bench.py's query batch
    (2, 1100, 19, 33, 128, True),  # a query longer than a block's 1,024 rows
])
def test_k3_matches_plain(gen, B, LQ, N, LD, DIM, masked):
    Qq, Dq = _codes(gen, B, LQ, DIM), _codes(gen, N, LD, DIM)
    qs = torch.rand(B, LQ, device="cuda", generator=gen) / 127
    ds = torch.rand(N, device="cuda", generator=gen) / 127
    mask = None
    if masked:
        lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
        mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
        mask[N // 2] = False  # a whole-padding doc
    launches = maxsim_scores_int8.launches
    got = maxsim_scores_int8(Qq, qs, Dq, ds, mask)
    torch.cuda.synchronize()
    assert maxsim_scores_int8.launches == launches + 1
    ref = maxsim_scores_int8_reference(Qq, qs, Dq, ds, mask)
    # exact int32 maxima; fp32 sums of <= 300 scaled maxima in another order
    # (1e-5 relative), the whole-padding doc included
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_k3_bitwise_on_crafted_codes(gen):
    """Small codes and unit scales: the totals are integers below 2^24, so
    the kernel and the plain version agree bitwise."""
    B, LQ, N, LD, DIM = 8, 113, 500, 256, 128
    Qq, Dq = _codes(gen, B, LQ, DIM, lo=-8, hi=9), _codes(gen, N, LD, DIM, lo=-8, hi=9)
    qs = torch.ones(B, LQ, device="cuda")
    ds = torch.ones(N, device="cuda")
    lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
    mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    for m in (mask, None):
        assert torch.equal(maxsim_scores_int8(Qq, qs, Dq, ds, m),
                           maxsim_scores_int8_reference(Qq, qs, Dq, ds, m))


def test_k3_rejects_bad_inputs(gen):
    Qq, Dq = _codes(gen, 2, 5, 48), _codes(gen, 4, 6, 48)
    qs, ds = torch.ones(2, 5, device="cuda"), torch.ones(4, device="cuda")
    with pytest.raises(ValueError):
        maxsim_scores_int8(Qq, qs, Dq, ds)  # dim 48: not a multiple of 32
    Qq, Dq = _codes(gen, 2, 5, 64), _codes(gen, 4, 6, 64)
    with pytest.raises(TypeError):
        maxsim_scores_int8(Qq.float(), qs, Dq.float(), ds)
    with pytest.raises(ValueError):
        maxsim_scores_int8(Qq, qs.double(), Dq, ds)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_slab_scores_equal_whole_index_scores(gen, kernel):
    """A doc's total does not depend on the launch it falls in: the docs
    D[s:e] scored alone give, bitwise, the same columns as one launch over
    all of D, at an s that is a multiple of no tile or group size."""
    B, LQ, N, LD, DIM, s, e = 8, 113, 700, 70, 128, 37, 611
    lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
    mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    if kernel == "K1":
        Q, D = _unit(gen, B, LQ, DIM), _unit(gen, N, LD, DIM)
        whole = maxsim_scores(Q, D, mask)
        part = maxsim_scores(Q, D[s:e], mask[s:e])
    else:
        Qq, Dq = _codes(gen, B, LQ, DIM), _codes(gen, N, LD, DIM)
        qs = torch.rand(B, LQ, device="cuda", generator=gen) / 127
        ds = torch.rand(N, device="cuda", generator=gen) / 127
        whole = maxsim_scores_int8(Qq, qs, Dq, ds, mask)
        part = maxsim_scores_int8(Qq, qs, Dq[s:e], ds[s:e], mask[s:e])
    assert torch.equal(part, whole[:, s:e])


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("which", ["Q", "D"])
def test_misaligned_pointer_raises(gen, kernel, which):
    """The kernels read Q and D by TMA, which needs 16-byte-aligned data: a
    view that starts 2 bytes into its storage is refused, not copied."""
    B, LQ, N, LD, DIM = 2, 5, 4, 6, 64
    if kernel == "K1":
        Q, D = _unit(gen, B, LQ, DIM), _unit(gen, N, LD, DIM)
        off = 1  # one bf16 element
    else:
        Q, D = _codes(gen, B, LQ, DIM), _codes(gen, N, LD, DIM)
        off = 2  # two int8 codes
    x = Q if which == "Q" else D
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device="cuda")
    moved = buf[off:].view(x.shape)
    moved.copy_(x)
    assert moved.is_contiguous() and moved.data_ptr() % 16 != 0
    Q, D = (moved, D) if which == "Q" else (Q, moved)
    with pytest.raises(ValueError, match="16-byte"):
        if kernel == "K1":
            maxsim_scores(Q, D)
        else:
            maxsim_scores_int8(Q, torch.ones(B, LQ, device="cuda"), D,
                               torch.ones(N, device="cuda"))


@pytest.mark.parametrize("quantized", [True, False])
def test_streamed_search_equals_resident_search(gen, quantized):
    """The pinned, double-buffered stream over a host index gives the
    device-resident search's values bitwise (each doc scores the same in any
    slab), with a partial last slab."""
    import numpy as np

    from reranking_multimodal_retrievers_tpu_torch.engine import (
        HostQuantizedTokenIndex, HostTokenIndex, QuantizedTokenIndex, StreamingSearcher,
        TokenIndex, make_search_fn, make_search_fn_int8)

    n, LD, DIM, slab = 5000, 64, 128, 1024
    emb = _unit(gen, n, LD, DIM)
    lens = torch.randint(1, LD + 1, (n,), device="cuda", generator=gen)
    mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    Q = _unit(gen, 4, 40, DIM).float()
    ids = [str(i) for i in range(n)]
    if quantized:
        index = QuantizedTokenIndex.from_arrays(emb, mask, ids)
        host = HostQuantizedTokenIndex(codes=index.codes.cpu().numpy(),
                                       scales=index.scales.cpu().numpy(),
                                       mask=mask.cpu().numpy(), doc_ids=ids)
        want_v, want_i = make_search_fn_int8(n, k=50)(Q, index.codes, index.scales, index.mask)
        counter = maxsim_scores_int8
    else:
        index = TokenIndex.from_arrays(emb, mask, ids)
        host = HostTokenIndex(embeddings=emb.cpu().half().numpy(), mask=mask.cpu().numpy(),
                              doc_ids=ids)
        want_v, want_i = make_search_fn(n, k=50)(Q.bfloat16(), index.embeddings, index.mask)
        counter = maxsim_scores
    searcher = StreamingSearcher(host, k=50, slab_docs=slab)
    for _ in range(2):  # the second pass reuses the staging buffers
        launches = counter.launches
        vals, idx = searcher.search(Q)
        assert counter.launches == launches + 5
        np.testing.assert_array_equal(vals, want_v.cpu().numpy())
        # ids may differ only between docs of exactly equal value
        for b, p in zip(*np.nonzero(idx != want_i.cpu().numpy())):
            assert (vals[b] == vals[b, p]).sum() > 1


def test_int8_linear_on_card_equals_cpu(gen):
    """``_int_mm`` on the card (with its row, k and n padding) gives the CPU's
    exact int32 product, so the layer's output matches bitwise."""
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import Int8Linear

    for rows, k, n in ((3, 20, 13), (40, 768, 3072), (17, 64, 8)):
        lin = Int8Linear(k, n, device="cuda")
        x = torch.randn(rows, k, device="cuda", generator=gen)
        with torch.no_grad():
            got = lin(x).cpu()
            want = lin.cpu()(x.cpu())
        assert torch.equal(got, want), (rows, k, n)


def test_quantizers_on_card_equal_cpu(gen):
    """Per-row and per-doc int8 codes and scales made on the card are bitwise
    the CPU's (which the CPU tests hold bitwise to the JAX package's)."""
    from reranking_multimodal_retrievers_tpu_torch.engine.index import quantize_docs
    from reranking_multimodal_retrievers_tpu_torch.ops.quant import quantize_rows

    x = torch.randn(512, 3072, device="cuda", generator=gen) * 3
    for a, b in zip(quantize_rows(x), quantize_rows(x.cpu())):
        assert torch.equal(a.cpu(), b)
    emb = _unit(gen, 300, 64, 128)
    mask = torch.rand(300, 64, device="cuda", generator=gen) > 0.2
    for a, b in zip(quantize_docs(emb, mask), quantize_docs(emb.cpu(), mask.cpu())):
        assert torch.equal(a.cpu(), b)


def test_wrappers_raise_under_grad_on_card(gen):
    """On CUDA as on the CPU, K1, K2 and K3 refuse an input that requires
    grad while grad mode is on (they have no backward, and a kernel output
    without a ``grad_fn`` would cut the graph silently); under no_grad they
    launch."""
    q, k, v = (torch.randn(2, 64, 128, device="cuda", generator=gen).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    Q = _unit(gen, 2, 9, 128).requires_grad_(True)
    D = _unit(gen, 5, 40, 128)
    Qq = torch.randint(-127, 128, (2, 9, 128), dtype=torch.int8, device="cuda", generator=gen)
    Dq = torch.randint(-127, 128, (5, 40, 128), dtype=torch.int8, device="cuda", generator=gen)
    qs = torch.rand(2, 9, device="cuda", generator=gen).requires_grad_(True)
    ds = torch.rand(5, device="cuda", generator=gen)
    calls = [lambda: fused_self_attention(q, k, v, num_heads=2, sm_scale=0.125),
             lambda: maxsim_scores(Q, D), lambda: maxsim_scores_int8(Qq, qs, Dq, ds)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
    launches = (fused_self_attention.launches, maxsim_scores.launches,
                maxsim_scores_int8.launches)
    with torch.no_grad():
        for call in calls:
            assert call().grad_fn is None
    assert (fused_self_attention.launches, maxsim_scores.launches,
            maxsim_scores_int8.launches) == tuple(n + 1 for n in launches)


def test_tiny_train_step_on_card_matches_cpu(gen):
    """One FLMR train step (tiny config, fp32, TF32 off for cuBLAS and
    cuDNN) on the card against the same step on the CPU from the same
    weights. The loss within 1e-5; each gradient, as the step's backward
    left it, within 1e-4 of its leaf's largest |g| (floor 1e-7 of the
    model's largest, for leaves 0 in exact arithmetic). Adam's first step
    moves an element by ``-lr * g / (|g| + eps)``, so each element's update
    may differ between the two by what their gradients imply, plus one fp32
    rounding of ``p + update`` a side; frozen leaves stay bitwise."""
    from reranking_multimodal_retrievers_tpu_torch.models import FLMRConfig, FLMRModelForRetrieval
    from reranking_multimodal_retrievers_tpu_torch.training import (
        TrainState, make_optimizer, make_train_step)

    torch.backends.cudnn.allow_tf32 = False  # the ViT's patch convolution in fp32
    cfg = FLMRConfig.tiny()
    cpu = FLMRModelForRetrieval(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = FLMRModelForRetrieval(cfg, device="meta")
    card.load_state_dict({k: v.cuda() for k, v in before.items()}, assign=True)
    g = torch.Generator().manual_seed(1)
    B, nway = 4, 2
    batch = dict(query_input_ids=torch.randint(10, 1000, (B, 8), generator=g),
                 query_attention_mask=torch.ones(B, 8, dtype=torch.long),
                 query_pixel_values=torch.randn(B, 3, 32, 32, generator=g),
                 context_input_ids=torch.randint(10, 1000, (B * nway, 12), generator=g),
                 context_attention_mask=torch.ones(B * nway, 12, dtype=torch.long))
    grads, metrics, labels = [], [], None
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        seen = {}
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: seen.__setitem__(n, p.grad.detach().cpu().clone()))
            for n, p in model.named_parameters()]
        opt, sched, labels = make_optimizer(model, lr=1e-3, mapping_network_lr=1e-2,
                                            frozen_patterns=("vision_encoder",),
                                            group_patterns=("vision_projection",))
        _, m = make_train_step(model, opt, sched)(TrainState.create(model, opt, sched),
                                                 {k: v.to(dev) for k, v in batch.items()})
        for h in hooks:
            h.remove()
        grads.append(seen)
        metrics.append({k: float(v) for k, v in m.items()})
    for k, v in metrics[0].items():
        assert metrics[1][k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
    assert set(grads[0]) == set(grads[1])
    floor = 1e-3 * max(float(x.abs().max()) for x in grads[0].values())
    for n, want in grads[0].items():
        assert (grads[1][n] - want).abs().max() <= 1e-4 * max(float(want.abs().max()), floor), n
    lrs = {"main": 1e-3, "mapping": 1e-2}
    on_card = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        got, b = on_card[n].detach().cpu().double(), before[n].double()
        if labels[n] == "frozen":
            assert torch.equal(on_card[n].detach().cpu(), before[n])
            assert torch.equal(p.detach(), before[n]), n
            continue
        lr = lrs[labels[n]]
        zero = torch.zeros_like(b)
        adam = [-lr * x / (x.abs() + 1e-8) for x in
                (grads[0].get(n, zero).double(), grads[1].get(n, zero).double())]
        rounding = 2 * torch.finfo(torch.float32).eps * b.abs().max() + 1e-5 * lr
        excess = ((got - p.detach().double()).abs() - (adam[1] - adam[0]).abs() - rounding)
        assert excess.max() <= 0, n


def _compressed_corpus(gen, N=300, LD=50, DIM=128):
    """Unit doc tokens with ragged padding and a whole-padding doc (7)."""
    emb = _unit(gen, N, LD, DIM)
    lens = torch.randint(1, LD + 1, (N,), device="cuda", generator=gen)
    mask = torch.arange(LD, device="cuda")[None, :] < lens[:, None]
    mask[7] = False
    return emb * mask[..., None], mask


def test_stage1_through_k1_matches_plain_stage1(gen):
    """Compressed search's stage 1 on the card: each slab decompressed,
    rounded to bf16 and scored by K1 under its mask, whole-padding docs
    given JAX's -9999 * L_q, against the JAX einsum's plain version on the
    card. Queries of norm ~11 (bench.py's normal draws), so totals reach
    ~100: fp32 sums of exact bf16 products in another order, within 2e-3 +
    2e-5 relative; the padding doc bitwise."""
    from reranking_multimodal_retrievers_tpu_torch.engine import codec, plaid

    emb, mask = _compressed_corpus(gen)
    idx = codec.compress(emb, mask, list(range(300)), num_centroids=64, sample_size=4096,
                         device="cuda")
    Q = torch.randn(4, 40, 128, device="cuda", generator=gen)
    args = (Q, idx.codes, idx.residuals, idx.centroids, idx.scales, idx.mask)
    launches = maxsim_scores.launches
    with torch.inference_mode():
        got = plaid.stage1_k1(*args, slab=128)
        want = plaid.stage1_plain(*args, chunk=50, bf16=True)
    assert maxsim_scores.launches == launches + 3  # three slabs
    assert torch.equal(want[:, 7], torch.full_like(want[:, 7], -9999.0 * 40))
    assert torch.equal(got[:, 7], want[:, 7])
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-5)


def test_kmeans_on_card_is_deterministic(gen):
    """Lloyd's sums as a one-hot product (not a scatter-add): two runs on the
    card give the same bits, and the CPU's centroids within 1e-5 and its
    assignments."""
    from reranking_multimodal_retrievers_tpu_torch.engine.kmeans import kmeans

    x = _unit(gen, 16384, 128).float()
    runs = [kmeans(x, x[:256], k=256, n_iters=10) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    c, a = kmeans(x.cpu(), x[:256].cpu(), k=256, n_iters=10)
    torch.testing.assert_close(runs[0][0].cpu(), c, atol=1e-5, rtol=0)
    assert torch.equal(runs[0][1].cpu(), a)


def test_compress_on_card_matches_cpu(gen):
    """``compress`` on the card against the CPU on the same tokens: the same
    centroids within 1e-5, the same codes, and residuals that differ only
    where the two unrounded residual / scale values straddle a rounding
    boundary less than 5% of a step apart."""
    from reranking_multimodal_retrievers_tpu_torch.engine import codec

    emb, mask = _compressed_corpus(gen, N=256, LD=64)
    kw = dict(num_centroids=128, sample_size=8192, token_chunk=4096)
    card = codec.compress(emb, mask, list(range(256)), device="cuda", **kw)
    cpu = codec.compress(emb.cpu(), mask.cpu(), list(range(256)), device="cpu", **kw)
    torch.testing.assert_close(card.centroids.cpu(), cpu.centroids, atol=1e-5, rtol=0)
    assert torch.equal(card.codes.cpu(), cpu.codes)
    torch.testing.assert_close(card.scales.cpu(), cpu.scales, atol=4e-7 / 127, rtol=1e-6)
    flips = card.residuals.cpu() != cpu.residuals
    e = emb.cpu().float()
    q = [(e - c.centroids.cpu()[c.codes.cpu().long()]) / c.scales.cpu() for c in (card, cpu)]
    assert ((q[0] - q[1]).abs()[flips] < 0.05).all()


def test_k2_at_sixteen_heads(gen):
    """K2 at the condenser reader's launch shape (ELECTRA-large: [25, 512,
    16 x 64]), a head count no other path launches, with padded key tails."""
    B, L, H = 25, 512, 16
    q, k, v = (torch.randn(B, L, H * 64, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(40, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    launches = fused_self_attention.launches
    got = fused_self_attention(q, k, v, bias, num_heads=H, sm_scale=0.125)
    assert fused_self_attention.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, num_heads=H, sm_scale=0.125)
    torch.testing.assert_close(got.float(), ref.float(), atol=3e-2, rtol=0)


def test_compress_keeps_a_card_tensor_on_the_card(gen, monkeypatch):
    """``compress`` of a tensor already on the card samples and slices it
    there (no host copy of the index), for ``device="cuda"`` as for
    ``"cuda:0"``."""
    from reranking_multimodal_retrievers_tpu_torch.device import is_on, resolve_device
    from reranking_multimodal_retrievers_tpu_torch.engine import codec

    emb, mask = _compressed_corpus(gen, N=64, LD=16)
    for name in ("cuda", f"cuda:{torch.cuda.current_device()}"):
        assert is_on(emb, resolve_device(name))
    assert not is_on(emb.cpu(), resolve_device("cuda"))
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(t.shape) or cpu(t, *a, **k))
    codec.compress(emb, mask, list(range(64)), num_centroids=16, sample_size=512, device="cuda")
    # the mask and the centroids come to the host; the embeddings never do
    assert tuple(emb.shape) not in [tuple(s) for s in copies]


@pytest.mark.parametrize("config,text_opts,variant", [
    # the config's own 4 heads x 32: the head bias
    ("synth_rerank_decoder_blip2_t5.json", (), (True, False)),
    # 8 heads x 80: the causal mask at OPT-2.7b's head_dim (2 x 80 does not pack)
    ("synth_rerank_decoder_blip2_opt.json", ("hidden_size=640", "num_attention_heads=8"),
     (False, True)),
    # the config's own 4 heads x 32
    ("synth_rerank_decoder_blip2_opt.json", (), (False, True)),
])
def test_decoder_executor_kernel_path_matches_plain_path(gen, tmp_path, monkeypatch, config,
                                                         text_opts, variant):
    """An fp32 decoder reranker executor on the card, its language model's
    self-attention through K2's fp32 path (``use_pallas_attention``: the
    T5 encoder with its relative-position head bias, or OPT with the causal
    mask), against the same executor without the flag: the rerank logits
    within rtol 1e-4 / atol 2e-5, and every launch of that variant."""
    from pathlib import Path

    from reranking_multimodal_retrievers_tpu_torch.data import ops  # noqa: F401
    from reranking_multimodal_retrievers_tpu_torch.executors import RerankerExecutor
    from reranking_multimodal_retrievers_tpu_torch.ops import attention_cuda
    from reranking_multimodal_retrievers_tpu_torch.utils.config_system import (apply_opts,
                                                                               load_config)

    root = Path(__file__).resolve().parents[1]
    monkeypatch.chdir(tmp_path)

    def build(pallas):
        cfg = load_config(str(root / "configs" / config))
        apply_opts(cfg, [f"data_pipeline.cache_dir='{tmp_path}/cache'",
                         f"meta.experiment_dir='{tmp_path}/exp{int(pallas)}'",
                         "model_config.docs_to_rerank=20", "valid.batch_size=4",
                         "valid.trainer_paras.limit_val_batches=1",
                         "model_config.modules=['decoder_reranker','train_with_retrieved_docs',"
                         "'neg_sample_retrieved','full_validation']",
                         *(f"model_config.decoder.text_config.{o}" for o in text_opts),
                         f"model_config.decoder.text_config.use_pallas_attention={pallas}"])
        cfg.set_path("mode", "train")
        return RerankerExecutor(cfg, use_dummy_data=True, device="cuda")

    def scores(ex):
        out = ex.evaluate("valid")["batch_retrieval_result"]
        return torch.tensor([[p["score"] for p in sorted(r["top_ranking_passages"],
                                                         key=lambda p: p["passage_id"])]
                             for r in out])

    seen = []
    launch = attention_cuda._launch_f32

    def record(q, k, v, mask_bias, head_bias, num_heads, sm_scale, causal):
        seen.append((head_bias is not None, bool(causal)))
        return launch(q, k, v, mask_bias, head_bias, num_heads, sm_scale, causal)

    fused, plain = build(True), build(False)
    for a, b in zip(fused.reranker.state_dict().values(), plain.reranker.state_dict().values()):
        assert torch.equal(a, b)  # drawn on the card from the same seed
    monkeypatch.setattr(attention_cuda, "_launch_f32", record)
    launches = attention_cuda.fused_self_attention_f32.launches
    got = scores(fused)
    n = attention_cuda.fused_self_attention_f32.launches - launches
    assert n > 0 and len(seen) == n and set(seen) == {variant}
    want = scores(plain)
    assert attention_cuda.fused_self_attention_f32.launches == launches + n
    assert got.shape == want.shape and got.numel() > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


def test_captioner_kernel_path_matches_plain_path(gen, tmp_path, monkeypatch):
    """``CaptionImageWithBLIP2``'s captioner with ``use_pallas_attention``
    in its T5 config (K2's fp32 head-bias path in the encoder) from an
    HF-named checkpoint directory: its greedy tokens equal the same
    checkpoint's through the plain path, step by step up to near-ties."""
    import numpy as np

    from reranking_multimodal_retrievers_tpu_torch.data.ops.infoseek_ops import (
        blip2_greedy_captions, build_captioner)
    from reranking_multimodal_retrievers_tpu_torch.models.blip2 import Blip2Config
    from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import write_safetensors
    from reranking_multimodal_retrievers_tpu_torch.models.t5 import T5Config
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        tiny_wordpiece_tokenizer)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    monkeypatch.delenv("RMRT_PLATFORM", raising=False)
    text = T5Config(vocab_size=300, d_model=128, d_kv=64, d_ff=256, num_layers=2,
                    num_decoder_layers=2, num_heads=2)
    cfg = Blip2Config.tiny(text_config=text)
    (tmp_path / "ckpt").mkdir()
    write_safetensors(str(tmp_path / "ckpt" / "model.safetensors"),
                      build_captioner(_asdict(cfg)).state_dict())
    tok = tiny_wordpiece_tokenizer(str(tmp_path / "tok"), ["a", "photo", "of"])
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (40, 48, 3), dtype=np.uint8) for _ in range(4)]
    out = {}
    for pallas in (True, False):
        conf = _asdict(cfg)
        conf["text_config"]["use_pallas_attention"] = pallas
        model = build_captioner(conf, str(tmp_path / "ckpt"))
        steps, decode = [], model.decode_logits
        model.decode_logits = lambda *a: steps.append(decode(*a)) or steps[-1]
        launches = fused_self_attention_f32.launches
        blip2_greedy_captions(model, tok, images, max_new_tokens=6, image_size=32)
        out[pallas] = (torch.stack([s[:, t] for t, s in enumerate(steps)], 1),
                       fused_self_attention_f32.launches - launches)
    (k_logits, k_launches), (p_logits, p_launches) = out[True], out[False]
    assert k_launches == 2 and p_launches == 0  # the encoder's layers, once
    torch.testing.assert_close(k_logits, p_logits, rtol=1e-4, atol=2e-5)
    top2 = torch.topk(p_logits, 2).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert torch.equal(k_logits.argmax(-1)[clear], p_logits.argmax(-1)[clear])


def _asdict(cfg):
    import dataclasses

    conf = {k: dataclasses.asdict(getattr(cfg, k))
            for k in ("vision_config", "qformer_config", "text_config")}
    conf["num_query_tokens"] = cfg.num_query_tokens
    return conf


def test_teacher_kernel_path_matches_plain_path(gen, monkeypatch):
    """``PrepareDistillationScores``'s live teacher with
    ``use_pallas_attention`` in its text config (K2's fp32 key-bias path in
    BERT) scores a batch of questions and 1 + 4 documents as the same
    weights do through the plain path."""
    from reranking_multimodal_retrievers_tpu_torch.data.ops.distillation_ops import (
        PrepareDistillationScores)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import make_dummy_m2kr
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    monkeypatch.delenv("RMRT_PLATFORM", raising=False)
    text = {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 256}
    out = {}
    for pallas in (True, False):
        f = PrepareDistillationScores()
        f.setup(flmr_config={"text_config": {**text, "use_pallas_attention": pallas},
                             "dim": 32, "use_vision_encoder": False},
                num_negatives=4, query_maxlen=32, doc_maxlen=64, seed=3)
        launches = fused_self_attention_f32.launches
        data = f(make_dummy_m2kr(num_rows=12, num_passages=20))
        out[pallas] = (data["train"], fused_self_attention_f32.launches - launches)
    (k_rows, k_launches), (p_rows, p_launches) = out[True], out[False]
    assert k_launches > 0 and p_launches == 0
    assert k_rows["neg_item_ids"] == p_rows["neg_item_ids"]
    torch.testing.assert_close(torch.tensor(k_rows["scores"]), torch.tensor(p_rows["scores"]),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("method", ["bicubic", "linear", "lanczos3", "nearest"])
def test_preprocess_on_card_matches_cpu(gen, method):
    """``ops/preprocess.py`` on the card against the same function on the
    CPU (fp32 products, TF32 off), at 3d's resolutions: max |diff| <= 1e-4."""
    import numpy as np

    from reranking_multimodal_retrievers_tpu_torch.ops.preprocess import (
        CLIPImageProcessorDevice)

    rng = np.random.default_rng(0)
    card = CLIPImageProcessorDevice(224, method, device="cuda")
    cpu = CLIPImageProcessorDevice(224, method, device="cpu")
    for h, w in ((480, 640), (640, 480), (240, 320), (200, 300), (224, 224)):
        imgs = rng.integers(0, 256, size=(3, h, w, 3)).astype(np.uint8)
        got, want = card(imgs), cpu(imgs)
        assert got.is_cuda and got.dtype == torch.float32
        assert (got.cpu() - want).abs().max().item() <= 1e-4, (h, w)


def test_bem_scorer_on_card_matches_cpu(gen, tmp_path):
    """The BEM scorer at BERT-base width in fp32 on the card (K2's fp32
    path, 12 launches an example) against the same weights on the CPU."""
    from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig
    from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import (
        write_safetensors)
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
        WordPieceTokenizer, write_test_vocab)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)
    from reranking_multimodal_retrievers_tpu_torch.tools.eval_evqa import (
        BEMClassifier, BEMScorer)

    model = BEMClassifier(BertConfig(type_vocab_size=4), device="cpu",
                          generator=torch.Generator().manual_seed(1))
    (tmp_path / "bem").mkdir()
    write_safetensors(str(tmp_path / "bem" / "model.safetensors"), model.state_dict())
    tok = WordPieceTokenizer(write_test_vocab(str(tmp_path / "vocab.txt"),
                                              ["cat", "dog", "what", "animal"]))
    kw = dict(checkpoint_dir=str(tmp_path / "bem"))  # BEMScorer's default 512 tokens
    card, cpu = BEMScorer(tok, device="cuda", **kw), BEMScorer(tok, device="cpu", **kw)
    fused_self_attention_f32.launches = 0
    for ex in ({"question": "what animal", "reference": "cat", "candidate": "dog"},
               {"question": "what", "reference": "cat && dog", "candidate": "dog, cat",
                "question_type": "multi_answer"}):
        assert abs(card(ex, threshold_score=False) - cpu(ex, threshold_score=False)) <= 1e-4
    assert fused_self_attention_f32.launches == 24


@pytest.mark.parametrize("kernel", ["K1", "K2", "K2f32", "K3"])
def test_kernels_launch_on_the_tensors_card(gen, kernel):
    """With the current device 0, each kernel launches on the card its
    tensors lie on (the second card) and agrees with its plain version
    there; the current device stays 0."""
    from reranking_multimodal_retrievers_tpu_torch.engine.index import quantize_docs
    from reranking_multimodal_retrievers_tpu_torch.engine.search import quantize_queries
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_f32)

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(1)
    if kernel in ("K1", "K3"):
        Q = torch.nn.functional.normalize(torch.randn(4, 32, 128, device=dev, generator=g), dim=-1)
        D = torch.nn.functional.normalize(torch.randn(300, 64, 128, device=dev, generator=g),
                                          dim=-1)
        M = torch.rand(300, 64, device=dev, generator=g) > 0.3
        if kernel == "K1":
            got = maxsim_scores(Q.bfloat16(), D.bfloat16(), M)
            want = maxsim_scores_reference(Q.bfloat16(), D.bfloat16(), M)
            tol = 2e-3
        else:
            Qq, qs = quantize_queries(Q)
            Dq, ds = quantize_docs(D, M)
            got = maxsim_scores_int8(Qq, qs, Dq, ds, M)
            want = maxsim_scores_int8_reference(Qq, qs, Dq, ds, M)
            tol = 2e-3
    else:
        dtype = torch.bfloat16 if kernel == "K2" else torch.float32
        q, k, v = (torch.randn(3, 96, 4 * 64, device=dev, generator=g).to(dtype)
                   for _ in range(3))
        bias = torch.where(torch.rand(3, 96, device=dev, generator=g) > 0.2, 0.0, -1e9)
        fn = fused_self_attention if kernel == "K2" else fused_self_attention_f32
        got = fn(q, k, v, bias, num_heads=4, sm_scale=0.125)
        want = fused_self_attention_reference(q, k, v, bias, num_heads=4, sm_scale=0.125)
        tol = 3e-2 if kernel == "K2" else 1e-4
    assert got.device == dev and torch.cuda.current_device() == 0
    assert (got.float() - want.float()).abs().max().item() <= tol


# the geometries the JAX gate admits outside the per-width kernels' widths
# (C9 in ROADMAP.md): (heads, head_dim); each runs csrc/attention_any.cu
# (128, 3): 6-byte rows, copied 2 bytes at a time in bf16; (64, 6), (32, 4),
# (32, 20): 12, 8 and 40-byte rows; (16, 136) and (1, 512): Q K^T summed in
# chunks of a row, two and four column blocks
C9_GEOMETRIES = [(16, 8), (16, 24), (16, 40), (16, 104), (32, 12), (2, 256), (2, 192), (1, 384),
                 (16, 120), (4, 36), (128, 3), (64, 6), (32, 4), (32, 20), (16, 136), (1, 512)]

# the tolerances of the generic kernel's card tests: bf16 outputs of order 1,
# the kernel rounding unnormalised probabilities to bf16 where the plain
# version rounds normalised ones and summing in another order (a few bf16
# spacings, chip_smoke.py's K2_TOL); fp32 in 3xTF32 against the plain fp32
# version, the JAX package's tolerance for the same comparison
# (tests/test_maxsim_pallas.py)
BF16_ATOL, F32_RTOL, F32_ATOL = 3e-2, 1e-4, 2e-5


def _assert_k2_close(got, ref):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd", C9_GEOMETRIES)
def test_k2_generic_kernel_matches_plain(gen, dtype, heads, hd):
    """K2 at every head geometry the JAX gate admits and the per-width
    kernels do not take: the generic kernel, with a key bias over ragged
    rows (L = 130, three query and key tiles), against the plain version
    (bf16 within 3e-2, fp32 within 1e-4 / 2e-5)."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_any, kernel_library)

    fp32 = dtype == torch.float32
    assert kernel_library(hd, fp32) == ("attention_any_f32" if fp32 else "attention_any")
    B, L = 3, 130
    q, k, v = (torch.randn(B, L, heads * hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    kw = dict(num_heads=heads, sm_scale=hd ** -0.5)
    launches = fused_self_attention_any.launches
    got = fused_self_attention(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert fused_self_attention_any.launches == launches + 1
    ref = fused_self_attention_reference(q, k, v, bias, **kw)
    _assert_k2_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd,hb_dtype,causal,strided", [
    (16, 24, torch.bfloat16, False, False),  # bf16 head bias with the key bias
    (16, 24, torch.float32, False, True),    # fp32 head bias, fused-projection views
    (16, 24, None, True, False),             # causal with the key bias
    (2, 256, torch.float32, False, False),   # two output column blocks
    (2, 256, None, True, True),
    (1, 384, torch.bfloat16, True, False),   # head bias and causal together
    # the thirds of one fused projection at 32 x 12: head offsets of 24 bytes
    # in bf16 (8-byte copies), rows 2,304 bytes apart
    (32, 12, None, False, True),
])
def test_k2_generic_kernel_options_match_plain(gen, dtype, heads, hd, hb_dtype, causal,
                                               strided):
    """The generic kernel's head bias, causal mask and strided views (the
    q/k/v thirds of one projection) against the plain version, with
    right-padded keys."""
    B, L = 2, 100
    if strided:
        qkv = torch.randn(B, L, 3 * heads * hd, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.split(heads * hd, dim=-1)
    else:
        q, k, v = (torch.randn(B, L, heads * hd, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
    lens = torch.tensor([L, L // 2], device="cuda")
    bias = torch.where(torch.arange(L, device="cuda")[None, :] < lens[:, None], 0.0, -1e9)
    hb = None
    if hb_dtype is not None:
        hb = torch.randn(heads, L, L, device="cuda", generator=gen).to(hb_dtype)
    kw = dict(num_heads=heads, sm_scale=hd ** -0.5, causal=causal)
    got = fused_self_attention(q, k, v, bias, hb, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, hb, **kw)
    _assert_k2_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_generic_kernel_at_a_per_width_head_dim(gen, dtype):
    """Called directly, the generic kernel takes the per-width kernels'
    widths too (head_dim 64 and 16), and agrees with the plain version."""
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention_any)

    for heads, hd in ((12, 64), (8, 16)):
        q, k, v = (torch.randn(2, 70, heads * hd, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        kw = dict(num_heads=heads, sm_scale=hd ** -0.5)
        got = fused_self_attention_any(q, k, v, **kw)
        ref = fused_self_attention_reference(q, k, v, **kw)
        _assert_k2_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd", [(16, 24), (2, 256), (128, 3)])
def test_k2_generic_kernel_causal_with_left_padded_keys(gen, dtype, heads, hd):
    """Under the causal mask, batch row 1's first 70 keys are padded: its
    query rows 0..69 see only padded keys, so each of their visible keys and
    each later unpadded key sits at the same -1e9 level, and the plain
    version averages V over all of them (the kernel visits every key tile
    for this); L = 100 spans two key tiles."""
    B, L = 2, 100
    q, k, v = (torch.randn(B, L, heads * hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    bias = torch.zeros(B, L, device="cuda")
    bias[1, :70] = -1e9
    kw = dict(num_heads=heads, sm_scale=hd ** -0.5, causal=True)
    got = fused_self_attention(q, k, v, bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, **kw)
    _assert_k2_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L", [1, 17])
@pytest.mark.parametrize("heads,hd", [(16, 24), (2, 192), (32, 12)])
def test_k2_generic_kernel_short_rows(gen, dtype, L, heads, hd):
    """L neither a multiple of 16 nor of 64 (one query block, one key tile,
    rows past L zero-filled), with the key bias (L = 17, the last key
    dropped) and without any bias (L = 1)."""
    B = 3
    q, k, v = (torch.randn(B, L, heads * hd, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    bias = None
    if L > 1:
        bias = torch.zeros(B, L, device="cuda")
        bias[:, -1] = -1e9
    kw = dict(num_heads=heads, sm_scale=hd ** -0.5)
    got = fused_self_attention(q, k, v, bias, **kw)
    ref = fused_self_attention_reference(q, k, v, bias, **kw)
    _assert_k2_close(got, ref)
