"""Kernel K2's plain version against the JAX package's
``fused_self_attention`` (interpret mode) and
``fused_self_attention_reference``, on the same numpy inputs.

head_dim 64 with 2 heads, so the JAX kernel packs a 128-lane head group;
L = 40 is not a multiple of 128 (the JAX kernel pads it internally).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.ops.attention_pallas import (  # noqa: E402
    fused_self_attention as jfused,
    fused_self_attention_reference as jreference,
)
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention,
    fused_self_attention_reference,
)

B, L, HEADS, HD = 2, 40, 2, 64
SCALE = HD ** -0.5


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, HEADS * HD)).astype(np.float32) for _ in range(3))
    bias = None
    if masked:  # key padding: row 1 keeps its first 23 keys
        bias = np.zeros((B, L), np.float32)
        bias[1, 23:] = -1e9
    return q, k, v, bias


def _port(q, k, v, bias, dtype):
    launches = fused_self_attention.launches
    out = fused_self_attention(
        *(torch.tensor(x).to(dtype) for x in (q, k, v)),
        None if bias is None else torch.tensor(bias),
        num_heads=HEADS, sm_scale=SCALE)
    assert fused_self_attention.launches == launches  # CPU tensors: plain version
    assert out.dtype == dtype and out.shape == (B, L, HEADS * HD)
    return out.float().numpy()


@pytest.mark.parametrize("masked", [True, False])
def test_plain_k2_matches_pallas_fp32(masked):
    """fp32 softmax of 40 keys over 64-term dot products: 1e-5 abs/rel."""
    q, k, v, bias = _inputs(0, masked)
    jb = None if bias is None else jnp.asarray(bias)
    args = [jnp.asarray(x) for x in (q, k, v)]
    want_kernel = np.asarray(jfused(*args, jb, num_heads=HEADS, sm_scale=SCALE,
                                    interpret=True))
    want_ref = np.asarray(jreference(*args, jb, num_heads=HEADS, sm_scale=SCALE))
    got = _port(q, k, v, bias, torch.float32)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=1e-5)


def test_plain_k2_matches_pallas_bf16():
    """bf16 q/k/v with fp32 softmax and accumulation on both sides. The
    probabilities are rounded to bf16 before P.V on both sides and the output
    is rounded to bf16, so results may differ by a bf16 rounding of the
    output or of one probability: 1e-2 abs / 1e-2 rel for outputs of order 1."""
    q, k, v, bias = _inputs(1, masked=True)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jfused(*args, jnp.asarray(bias), num_heads=HEADS,
                             sm_scale=SCALE, interpret=True).astype(jnp.float32))
    got = _port(*(np.asarray(a.astype(jnp.float32)) for a in args), bias, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_plain_k2_masked_keys_get_no_weight():
    """Keys under the -1e9 bias do not move the output of any query row."""
    q, k, v, bias = _inputs(2, masked=True)
    base = _port(q, k, v, bias, torch.float32)
    v2 = v.copy()
    v2[1, 23:] += 100.0
    np.testing.assert_array_equal(_port(q, k, v2, bias, torch.float32)[1], base[1])


def test_plain_k2_chunks_over_batch(monkeypatch):
    from reranking_multimodal_retrievers_tpu_torch.ops import attention_cuda

    q, k, v, bias = _inputs(3, masked=True)
    whole = _port(q, k, v, bias, torch.float32)
    monkeypatch.setattr(attention_cuda, "_PLAIN_CHUNK_BYTES", 1)  # one row a chunk
    np.testing.assert_allclose(_port(q, k, v, bias, torch.float32), whole,
                               atol=1e-6, rtol=1e-6)


def test_unported_arguments_raise():
    """head_bias and causal are ported (tests/test_torch_attention_variants.py);
    a head bias of another shape, and a device that is neither CPU nor CUDA,
    raise."""
    x = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError):
        fused_self_attention(x, x, x, head_bias=torch.zeros(2, 8, 9),
                             num_heads=2, sm_scale=SCALE)
    with pytest.raises(ValueError):
        fused_self_attention(x, x, x, head_bias=torch.zeros(1, 8, 8),
                             num_heads=2, sm_scale=SCALE, causal=True)
    m = torch.empty(1, 8, 128, device="meta")  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        fused_self_attention(m, m, m, num_heads=2, sm_scale=SCALE)


def test_reference_matches_jax_reference_directly():
    q, k, v, bias = _inputs(4, masked=True)
    want = np.asarray(jreference(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias),
                                 num_heads=HEADS, sm_scale=SCALE))
    got = fused_self_attention_reference(
        *(torch.tensor(x) for x in (q, k, v)), torch.tensor(bias),
        num_heads=HEADS, sm_scale=SCALE).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("heads,hd", [(32, 12), (1, 384), (128, 3), (16, 136)])
def test_plain_k2_matches_pallas_at_generic_geometries(heads, hd):
    """Geometries the JAX gate admits that the card runs on the generic
    kernel (csrc/attention_any.cu): 32 heads of 12 (the JAX kernel packs
    32 heads into 384 lanes), one head of 384, 128 heads of 3 (an odd
    width: 2-byte copies in bf16 on the card) and 16 heads of 136 (rows
    summed in chunks, two column blocks), fp32 with right-padded keys,
    1e-5 abs/rel as above; on CPU tensors the port's wrapper is the plain
    version."""
    rng = np.random.default_rng(hd)
    b, l = 2, 24
    q, k, v = (rng.normal(size=(b, l, heads * hd)).astype(np.float32) for _ in range(3))
    bias = np.zeros((b, l), np.float32)
    bias[1, 17:] = -1e9
    scale = hd ** -0.5
    want = np.asarray(jfused(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias),
                             num_heads=heads, sm_scale=scale, interpret=True))
    got = fused_self_attention(*(torch.tensor(x) for x in (q, k, v)), torch.tensor(bias),
                               num_heads=heads, sm_scale=scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
