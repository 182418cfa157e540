"""The port's T5 (``models/t5.py``) and LoRA (``models/lora.py``) against the
JAX package, on the same numpy inputs and the same weights (carried over by
``models/weights.py::t5_state_dict``).

Both sides run in fp32 on the CPU (JAX at matmul precision "highest", set by
conftest). Every LoRA ``lora_b`` is set non-zero before the weights cross,
so the adapters compute. Tolerance 1e-4 abs / 1e-4 rel on logits and hidden
states: fp32 round-off of a few RMS-normed layers of order-1 activations,
summed in another order on each side. The fused configuration (2 heads x
64) runs the JAX Pallas kernel in interpret mode against the port's K2
wrapper, which takes its plain version for CPU tensors.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import lora as jlora  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import t5 as jt5  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import lora as tlora  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import t5 as tt5  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention,
)

TOL = dict(atol=1e-4, rtol=1e-4)
# d_kv 64 with 2 heads: the JAX gate fuses the encoder's self-attention
FUSED = dict(vocab_size=96, d_model=128, d_kv=64, d_ff=256, num_layers=2,
             num_decoder_layers=2, num_heads=2, use_pallas_attention=True)


def _np(x):
    return x.detach().float().numpy()


def nonzero_lora(tree, rng):
    """``tree`` with every ``lora_b`` drawn from N(0, 0.1), so that the
    adapters change the outputs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = nonzero_lora(v, rng)
        elif k == "lora_b":
            out[k] = rng.normal(0.0, 0.1, size=np.shape(v)).astype(np.float32)
        else:
            out[k] = v
    return out


def _inputs(rng, B=2, L=13, Ld=3, vocab=60):
    ids = rng.integers(2, vocab, size=(B, L)).astype(np.int32)
    am = np.ones((B, L), np.int32)
    am[1, L - 4:] = 0  # right padding
    dec = rng.integers(2, vocab, size=(B, Ld)).astype(np.int32)
    return ids, am, dec


def t5_pair(seed=0, B=2, L=13, Ld=3, **kw):
    """A JAX T5 and the port's with the same weights (non-zero LoRA)."""
    jcfg = jt5.T5Config.tiny(**kw)
    rng = np.random.default_rng(seed)
    ids, am, dec = _inputs(rng, B, L, Ld, min(60, jcfg.vocab_size))
    jm = jt5.T5ForConditionalGeneration(jcfg)
    params = nonzero_lora(jax.device_get(jm.init(jax.random.PRNGKey(seed), ids, am, dec)
                                         ["params"]), rng)
    tm = tt5.T5ForConditionalGeneration(tt5.T5Config(**dataclasses.asdict(jcfg)), device="cpu")
    tm.load_state_dict(weights.t5_state_dict(params))
    return jm, params, tm, (ids, am, dec)


def _compare(jm, params, tm, ids, am, dec, tol=TOL):
    want_logits, want_hidden = jm.apply({"params": params}, ids, am, dec)
    want_enc = jm.apply({"params": params}, ids, am, method=jt5.T5ForConditionalGeneration.encode)
    t = [torch.as_tensor(x).long() for x in (ids, am, dec)]
    with torch.no_grad():
        enc = tm.encode(t[0], t[1])
        logits, hidden = tm(t[0], t[1], t[2])
    np.testing.assert_allclose(_np(enc), np.asarray(want_enc), **tol)
    np.testing.assert_allclose(_np(hidden), np.asarray(want_hidden), **tol)
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **tol)
    return logits


@pytest.mark.parametrize("Ld", [3, 1])
def test_t5_tiny_matches_jax(Ld):
    """Gated Flan-T5 form, untied head; Ld = 1 takes the single-query
    cross-attention reorder, Ld = 3 the standard cross-attention."""
    jm, params, tm, io = t5_pair(Ld=Ld)
    _compare(jm, params, tm, *io)


def test_t5_tied_ungated_matches_jax():
    jm, params, tm, io = t5_pair(seed=1, is_gated_act=False, dense_act_fn="relu",
                                 tie_word_embeddings=True)
    assert tm.lm_head is None
    _compare(jm, params, tm, *io)


@pytest.mark.parametrize("Ld", [1, 4])
def test_t5_lora_matches_jax(Ld):
    """LoRA on q and v of self- and cross-attention with non-zero lora_b;
    Ld = 1 is the single-query reorder with the LoRA term on the pooled
    states."""
    jm, params, tm, io = t5_pair(seed=2, Ld=Ld, lora_r=2)
    assert "lora_a" in params["decoder"]["block_0"]["cross_attn"]["v"]
    assert "lora_a" not in params["decoder"]["block_0"]["cross_attn"]["k"]
    assert isinstance(tm.decoder.block[0].layer[1].EncDecAttention.v, tlora.LoRALinear)
    logits = _compare(jm, params, tm, *io)
    # the adapters move the result: zeroing them changes the logits
    sd = {k: (torch.zeros_like(v) if k.endswith("lora_b") else v)
          for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd)
    with torch.no_grad():
        base = tm(*(torch.as_tensor(x).long() for x in io))[0]
    assert (base - logits).abs().max() > 1e-3


@pytest.mark.parametrize("bias_bf16", [False, True])
def test_t5_fused_encoder_matches_jax(bias_bf16):
    """use_pallas_attention at 2 heads x 64: both sides fuse the encoder's
    self-attention (JAX: the interpret-mode Pallas kernel; the port: K2's
    wrapper, plain on the CPU) with the mask-free position bias as the head
    bias, in bf16 under position_bias_bf16."""
    jm, params, tm, io = t5_pair(seed=3, L=20, position_bias_bf16=bias_bf16, **FUSED)
    launches = fused_self_attention.launches
    _compare(jm, params, tm, *io)
    assert fused_self_attention.launches == launches  # CPU tensors: plain version


def test_t5_unpackable_heads_match_jax_off_the_card():
    """use_pallas_attention at 3 heads x 64, a geometry the TPU kernel cannot
    pack: off the card both sides take the unfused path (the mask folded
    into the position bias, no bf16 rounding of the bias)."""
    jm, params, tm, io = t5_pair(seed=4, L=20, position_bias_bf16=True,
                                 **{**FUSED, "num_heads": 3, "d_model": 192})
    _compare(jm, params, tm, *io)


def test_t5_fused_gate_follows_jax():
    """On the card as off it the port fuses exactly where the JAX package
    does: encoder self-attention with a packable head geometry."""
    tm = tt5.T5ForConditionalGeneration(tt5.T5Config(**FUSED), device="meta")
    assert tm.encoder.block[0].layer[0].SelfAttention._can_fuse(None)
    assert not tm.decoder.block[0].layer[0].SelfAttention._can_fuse(None)
    assert not tm.decoder.block[0].layer[1].EncDecAttention._can_fuse(torch.empty(1))
    tiny = tt5.T5ForConditionalGeneration(
        tt5.T5Config.tiny(use_pallas_attention=True), device="meta")
    assert not tiny.encoder.block[0].layer[0].SelfAttention._can_fuse(None)  # 4 x 4
    odd = tt5.T5ForConditionalGeneration(
        tt5.T5Config(**{**FUSED, "num_heads": 3}), device="meta")
    assert not odd.encoder.block[0].layer[0].SelfAttention._can_fuse(None)  # 3 x 64


@pytest.mark.parametrize("tied", [False, True])
def test_t5_int8_matches_jax(tied):
    """quantize_int8: every projection, FFN and the head (the tied head
    through int8_dot) W8A8 on both sides; the quantizers agree bitwise and
    the int32 products are exact, so fp32 round-off remains."""
    jm, params, tm, io = t5_pair(seed=4, quantize_int8=True, tie_word_embeddings=tied)
    _compare(jm, params, tm, *io)


def test_t5_int8_with_lora_raises():
    with pytest.raises(ValueError, match="lora_r == 0"):
        tt5.T5Config.tiny(quantize_int8=True, lora_r=4)


def test_relative_position_buckets_match_jax():
    """Bucket tables of both directions, over the distances of a 544-token
    encoder (the logs sit near integer boundaries at powers of 2)."""
    rel = np.arange(-600, 601)[None, :]
    for bidirectional in (True, False):
        want = np.asarray(jt5.relative_position_bucket(rel, bidirectional, 32, 128))
        got = tt5.relative_position_bucket(torch.as_tensor(rel), bidirectional, 32, 128)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lora_linear_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    jl = jlora.LoRADense(6, r=2, alpha=32.0)
    params = nonzero_lora(jax.device_get(jl.init(jax.random.PRNGKey(5), x)["params"]), rng)
    want = np.asarray(jl.apply({"params": params}, x))
    tl = tlora.LoRALinear(8, 6, r=2, alpha=32.0)
    sd = {}
    weights._linear(sd, "l", params)
    tl.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        np.testing.assert_allclose(_np(tl(torch.as_tensor(x))), want, atol=1e-5, rtol=1e-5)
    assert tlora.LORA_PARAM_PATTERNS == jlora.LORA_PARAM_PATTERNS


def test_fresh_lora_and_rms_norm_init():
    """models/init.py: lora_b and every bias start at 0 (a fresh adapter is
    a no-op), the RMS norms at 1."""
    gen = torch.Generator().manual_seed(0)
    tm = tt5.T5ForConditionalGeneration(tt5.T5Config.tiny(lora_r=2), device="cpu",
                                        generator=gen)
    for name, p in tm.named_parameters():
        if name.endswith("lora_b"):
            assert not p.any(), name
        elif name.endswith("layer_norm.weight"):
            assert (p == 1).all(), name
        else:
            assert p.std() > 0, name
