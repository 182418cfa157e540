"""K2's plain version with the per-head bias (T5), the causal mask (OPT) and
head_dim 80 (OPT-2.7b), against the JAX package's ``fused_self_attention``
in interpret mode, on the same numpy inputs. These mirror the JAX package's
own kernel tests (``tests/test_maxsim_pallas.py``: the head-bias test, the
two causal tests and the head_dim-80 packing test).

fp32 inputs: tolerance 1e-5 abs / 1e-4 rel, fp32 round-off of softmaxes over
at most 128 keys of dot products of up to 80 terms (the JAX kernel pads L
to a multiple of 128 and sums in its own order). bf16 inputs: 1e-2, a bf16
rounding of the output or of one probability, as in
``tests/test_torch_attention.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.ops.attention_pallas import (  # noqa: E402
    fused_self_attention as jfused,
)
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    causal_bias,
    fused_self_attention,
    fused_self_attention_reference,
)

FP32_TOL = dict(atol=1e-5, rtol=1e-4)


def _qkv(rng, B, L, heads, hd):
    return [rng.normal(size=(B, L, heads * hd)).astype(np.float32) for _ in range(3)]


def _key_bias(B, L, keep):
    """[B, L]: row b keeps its first keep[b] keys."""
    bias = np.zeros((B, L), np.float32)
    for b, n in enumerate(keep):
        bias[b, n:] = -1e9
    return bias


def _both(q, k, v, bias, head_bias, *, heads, scale, causal, dtype=torch.float32):
    """(JAX interpret-mode kernel, the port's wrapper on CPU tensors) as
    fp32 numpy; the port's launch count must not move."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    hb_j = None if head_bias is None else jnp.asarray(head_bias[0], head_bias[1])
    want = jfused(*(jnp.asarray(x, jd) for x in (q, k, v)),
                  None if bias is None else jnp.asarray(bias), hb_j, num_heads=heads,
                  sm_scale=scale, causal=causal, interpret=True)
    launches = fused_self_attention.launches
    got = fused_self_attention(
        *(torch.as_tensor(x).to(dtype) for x in (q, k, v)),
        None if bias is None else torch.as_tensor(bias),
        None if head_bias is None else torch.tensor(np.asarray(hb_j.astype(jnp.float32))).to(
            torch.float32 if head_bias[1] == jnp.float32 else torch.bfloat16),
        num_heads=heads, sm_scale=scale, causal=causal)
    assert fused_self_attention.launches == launches  # CPU tensors: plain version
    assert got.dtype == dtype
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("bias_dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("padded", [False, True])
def test_head_bias_matches_pallas(bias_dtype, padded):
    """The T5 relative-position bias as K2's per-head bias, in fp32 and in
    bf16 (the JAX kernel upcasts either inside), with and without key
    padding; sm_scale 1 as T5 calls it."""
    rng = np.random.default_rng(3)
    B, L, H, HD = 3, 40, 2, 64
    q, k, v = _qkv(rng, B, L, H, HD)
    q *= 0.125
    bias = _key_bias(B, L, [40, 31, 9]) if padded else None
    hb = rng.normal(size=(H, L, L)).astype(np.float32)
    got, want = _both(q, k, v, bias, (hb, bias_dtype), heads=H, scale=1.0, causal=False)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_head_bias_bf16_inputs_match_pallas():
    """bf16 q/k/v and a bf16 head bias, the serving configuration."""
    rng = np.random.default_rng(4)
    B, L, H, HD = 2, 24, 2, 64
    q, k, v = _qkv(rng, B, L, H, HD)
    q *= 0.125
    hb = rng.normal(size=(H, L, L)).astype(np.float32)
    got, want = _both(q, k, v, _key_bias(B, L, [24, 13]), (hb, jnp.bfloat16), heads=H,
                      scale=1.0, causal=False, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("padded", [False, True])
def test_causal_matches_pallas(padded):
    """The in-kernel causal mask (-1e9 where key > query), alone and with
    right padding; every query row is compared, the padded ones included
    (each still sees real keys at or before itself)."""
    rng = np.random.default_rng(1 + padded)
    B, L, H, HD = 4, 64, 4, 32
    q, k, v = _qkv(rng, B, L, H, HD)
    bias = _key_bias(B, L, [64, 48, 17, 1]) if padded else None
    got, want = _both(q, k, v, bias, None, heads=H, scale=HD ** -0.5, causal=True)
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_80_matches_pallas(causal):
    """OPT-2.7b's head_dim 80 (the JAX kernel packs 8 heads to 640 lanes),
    with right padding."""
    rng = np.random.default_rng(2)
    B, L, H, HD = 2, 16, 8, 80
    q, k, v = _qkv(rng, B, L, H, HD)
    got, want = _both(q, k, v, _key_bias(B, L, [16, 11]), None, heads=H, scale=HD ** -0.5,
                      causal=causal)
    np.testing.assert_allclose(got, want, **FP32_TOL)


def test_causal_plain_version_is_the_head_bias_form():
    """``causal=True`` equals the same call with the causal mask as a head
    bias, as the JAX package's tests state it."""
    rng = np.random.default_rng(5)
    B, L, H, HD = 2, 21, 3, 16
    q, k, v = (torch.as_tensor(x) for x in _qkv(rng, B, L, H, HD))
    bias = torch.as_tensor(_key_bias(B, L, [21, 7]))
    kw = dict(num_heads=H, sm_scale=0.25)
    a = fused_self_attention_reference(q, k, v, bias, causal=True, **kw)
    b = fused_self_attention_reference(q, k, v, bias, causal_bias(L).expand(H, L, L), **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert causal_bias(3).tolist() == [[0, -1e9, -1e9], [0, 0, -1e9], [0, 0, 0]]
