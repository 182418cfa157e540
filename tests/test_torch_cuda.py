"""The CUDA kernels against their plain PyTorch versions on the card, at
ragged shapes the main path does not reach (odd dims, query rows spanning
the kernel's row groups, any L, strided q/k/v).

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
    x = torch.randn(1, 8, 160, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fused_self_attention(x, x, x, num_heads=2, sm_scale=0.1)  # head_dim 80
    y = torch.randn(1, 8, 128, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        fused_self_attention(y, y, y, num_heads=2, sm_scale=0.125)  # fp32


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
