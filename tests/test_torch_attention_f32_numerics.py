"""The arithmetic of K2's fp32 kernel (``csrc/attention_f32.cu``), on the CPU.

The kernel runs only on the card, so its design is checked here in plain
PyTorch: every product of Q K^T and of P V in 3xTF32 (each fp32 operand split
into a TF32 high part and a TF32 low part, ``lo*hi + hi*lo + hi*hi`` summed
in fp32), the scores scaled and biased in fp32, an online softmax once per
64-key tile. The split is the kernel's, bit for bit: ``hi`` is x rounded to
TF32, ``lo`` is ``x - hi`` rounded to TF32; as in the kernel, the small
terms of Q K^T are summed apart from the large one, and each tile's P V
from zero before it is added to the running output. The emulation is held against the JAX package's
``fused_self_attention`` in interpret mode on the same numpy inputs, at the
tolerance the card tests hold the kernel to (``rtol=1e-4, atol=2e-5``, the
JAX package's for fp32 attention). Single-pass TF32 (one product of the
rounded operands) must fail that tolerance: the control shows the
tolerance has teeth, as ``chip_smoke.py`` phase 8's TF32 control does.

TF32 rounding is ``cvt.rna.tf32.f32``'s: the 13 low mantissa bits rounded to
nearest, ties away from zero, by integer arithmetic on the fp32 bits (the
kernel's too).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from reranking_multimodal_retrievers_tpu.ops.attention_pallas import (  # noqa: E402
    fused_self_attention as jfused,
)

TOL = dict(rtol=1e-4, atol=2e-5)
NEG_INF = -1e9
LOG2E = 1.4426950408889634
KEY_TILE = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (kept in fp32): add half of the dropped bits' weight to
    the magnitude bits, then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo, both TF32 values: hi is x rounded to TF32, lo the
    remainder rounded to TF32."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh  # the small terms summed apart, first


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def emulate(q, k, v, bias, head_bias, *, heads, scale, causal, mm):
    """The kernel's arithmetic on fp32 [B, L, heads * hd] numpy inputs."""
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    B, L, HD = q.shape
    hd = HD // heads
    qh, kh, vh = (x.view(B, L, heads, hd).permute(0, 2, 1, 3) for x in (q, k, v))
    rows = torch.arange(L)[:, None]
    m = torch.full((B, heads, L), -torch.inf)
    l = torch.zeros(B, heads, L)
    o = torch.zeros(B, heads, L, hd)
    for k0 in range(0, L, KEY_TILE):
        k1 = min(L, k0 + KEY_TILE)
        s = mm(qh, kh[:, :, k0:k1].transpose(-1, -2)) * scale
        if bias is not None:
            s = s + torch.as_tensor(bias)[:, None, None, k0:k1]
        if head_bias is not None:
            s = s + torch.as_tensor(head_bias)[None, :, :, k0:k1]
        if causal:
            s = s + torch.where(torch.arange(k0, k1)[None, :] > rows, NEG_INF, 0.0)
        ms = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - ms) * LOG2E)
        p = torch.exp2((s - ms[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vh[:, :, k0:k1])
        m = ms
    return (o / l[..., None]).permute(0, 2, 1, 3).reshape(B, L, HD).numpy()


def _inputs(seed, B, L, heads, hd, *, masked, head_bias):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, heads * hd)).astype(np.float32) for _ in range(3))
    bias = None
    if masked:
        # every row keeps a key: the JAX kernel pads L to a multiple of 128
        # with masked keys, so a row with every key masked averages V over
        # the padding too (the card tests hold such rows to the plain version)
        keep = rng.random((B, L)) > 0.3
        keep[:, 0] = True
        bias = np.where(keep, 0.0, NEG_INF).astype(np.float32)
    hb = rng.normal(size=(heads, L, L)).astype(np.float32) if head_bias else None
    return q, k, v, bias, hb


def _jax(q, k, v, bias, hb, *, heads, scale, causal):
    return np.asarray(jfused(*(jnp.asarray(x) for x in (q, k, v)),
                             None if bias is None else jnp.asarray(bias),
                             None if hb is None else jnp.asarray(hb),
                             num_heads=heads, sm_scale=scale, causal=causal, interpret=True))


@pytest.mark.parametrize("B,L,heads,hd,masked,head_bias,causal,scale", [
    (2, 161, 2, 64, True, False, False, None),  # the cross-encoder's L: three key tiles
    (3, 24, 2, 64, True, False, False, None),   # the doc encoder's L
    (2, 37, 8, 80, True, False, True, None),    # hd 80 (8 heads, JAX's packing) with causal
    (2, 161, 8, 80, False, False, True, None),  # causal across three key tiles
    (3, 24, 2, 64, True, True, False, None),    # an fp32 head bias
    (2, 161, 2, 64, True, True, False, 1.0),    # T5's sm_scale 1: |scores| ~ 30
    (2, 130, 8, 80, True, True, True, None),    # every option at once
])
def test_3xtf32_design_matches_pallas(B, L, heads, hd, masked, head_bias, causal, scale):
    q, k, v, bias, hb = _inputs(L + hd, B, L, heads, hd, masked=masked, head_bias=head_bias)
    kw = dict(heads=heads, scale=hd ** -0.5 if scale is None else scale, causal=causal)
    want = _jax(q, k, v, bias, hb, **kw)
    got = emulate(q, k, v, bias, hb, mm=mm_3xtf32, **kw)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("B,L,heads,hd", [(2, 161, 2, 64), (3, 24, 2, 64)])
def test_single_pass_tf32_fails_the_tolerance(B, L, heads, hd):
    """The control: the same design with one TF32 product in place of three
    misses rtol 1e-4 / atol 2e-5 by far, while 3xTF32 meets it."""
    q, k, v, bias, hb = _inputs(L + hd, B, L, heads, hd, masked=True, head_bias=False)
    kw = dict(heads=heads, scale=hd ** -0.5, causal=False)
    want = _jax(q, k, v, bias, hb, **kw)
    np.testing.assert_allclose(emulate(q, k, v, bias, hb, mm=mm_3xtf32, **kw), want, **TOL)
    one = emulate(q, k, v, bias, hb, mm=mm_tf32, **kw)
    excess = np.abs(one - want) - (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert excess.max() > 10 * TOL["atol"], excess.max()


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The emulated ``cvt.rna.tf32.f32``: 10 explicit mantissa bits kept,
    the rest rounded to nearest with ties away from zero, either sign."""
    one_ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2 ** -23,
                      1 + 3 * one_ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp, 3.0, 0.0]
    assert tf32(x).tolist() == want
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - hi).abs() <= hi.abs() * 2.0 ** -11).all())


def test_split_parts_are_tf32_and_sum_to_x():
    """Both parts are TF32 values, the remainder x - hi is at most half a
    TF32 spacing of x, and the rounded low part leaves x - (hi + lo) below
    2^-22 |x|."""
    r = torch.cat([torch.randn(4096, generator=torch.Generator().manual_seed(1)),
                   torch.rand(4096, generator=torch.Generator().manual_seed(2)),
                   torch.tensor([1.0, -3.0, 1 + 2.0 ** -11, 65504.0, 1e-20])])
    hi, lo = split(r)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    rest = r.double() - hi.double()
    assert bool((rest.abs() <= r.double().abs() * 2.0 ** -11).all())
    assert bool(((rest - lo.double()).abs() <= r.double().abs() * 2.0 ** -22).all())
