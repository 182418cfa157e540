"""The port's OPT (``models/opt.py``) against the JAX package, on the same
numpy inputs and the same weights (``models/weights.py::opt_state_dict``).

Both sides run in fp32 on the CPU (JAX at matmul precision "highest"), each
on its unfused path: the JAX package fuses OPT's attention only on a TPU and
the port only on the card. Every LoRA ``lora_b`` is set non-zero first.
Tolerance 1e-4 abs / 1e-4 rel on logits and hidden states: fp32 round-off
of a few LayerNorm'd layers of order-1 activations. Right padding is in
every batch, so the position ids, the key mask and the causal mask all see
it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import opt as jopt  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import opt as topt  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from test_torch_t5 import nonzero_lora  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.detach().float().numpy()


def _io(seed, B=3, L=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 62, size=(B, L)).astype(np.int32)
    am = np.ones((B, L), np.int32)
    am[0, 8:] = 0  # right padding
    am[2, 5:] = 0
    ids[am == 0] = 1
    return rng, ids, am


def opt_pair(seed=0, **kw):
    jcfg = jopt.OPTConfig.tiny(**kw)
    rng, ids, am = _io(seed)
    jm = jopt.OPTForCausalLM(jcfg)
    params = nonzero_lora(jax.device_get(jm.init(jax.random.PRNGKey(seed), ids, am)["params"]),
                          rng)
    tm = topt.OPTForCausalLM(topt.OPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    tm.load_state_dict(weights.opt_state_dict(params))
    return jm, params, tm, ids, am


def _compare(jm, params, tm, ids, am):
    want_logits, want_hidden = jm.apply({"params": params}, ids, am)
    with torch.no_grad():
        logits, hidden = tm(torch.as_tensor(ids).long(), torch.as_tensor(am))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(hidden), np.asarray(want_hidden), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)


def test_opt_positions_match_jax():
    _, _, am = _io(0)
    want = np.asarray(jopt.opt_positions(am))
    got = topt.opt_positions(torch.as_tensor(am))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 8:].eq(-1).all()  # padded rows -> embedding row 1 after the +2 offset


def test_opt_pre_ln_matches_jax():
    _compare(*opt_pair())


def test_opt_post_ln_projected_matches_jax():
    """opt-350m's form: post-LN blocks and project_in/project_out around a
    narrower word-embedding width."""
    jm, params, tm, ids, am = opt_pair(seed=1, do_layer_norm_before=False,
                                       word_embed_proj_dim=8)
    assert tm.model.decoder.project_in is not None and tm.model.decoder.final_layer_norm is None
    _compare(jm, params, tm, ids, am)


def test_opt_lora_matches_jax():
    jm, params, tm, ids, am = opt_pair(seed=2, lora_r=2)
    assert "lora_b" in params["layer_0"]["self_attn"]["v_proj"]
    _compare(jm, params, tm, ids, am)


def test_opt_int8_matches_jax():
    """quantize_int8: projections, FFN and the tied head (int8_dot) W8A8 on
    both sides; bitwise quantizers and exact int32 products leave fp32
    round-off."""
    _compare(*opt_pair(seed=3, quantize_int8=True))


def test_opt_int8_with_lora_raises():
    with pytest.raises(ValueError, match="lora_r == 0"):
        topt.OPTConfig.tiny(quantize_int8=True, lora_r=8)


def test_opt_causal_bias_matches_jax():
    _, _, am = _io(4)
    jm = jopt.OPTForCausalLM(jopt.OPTConfig.tiny())
    want = np.asarray(jm.apply({}, am, method=jopt.OPTForCausalLM.causal_bias))
    np.testing.assert_array_equal(topt.OPTForCausalLM.causal_bias(torch.as_tensor(am)).numpy(),
                                  want)


def test_opt_fused_gate_stays_unfused_on_cpu():
    """use_pallas_attention changes nothing on the CPU (the JAX package fuses
    only on a TPU, the port only on the card)."""
    jm, params, tm, ids, am = opt_pair(seed=5, hidden_size=32, num_attention_heads=2,
                                       use_pallas_attention=True)
    from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (
        fused_self_attention)

    launches = fused_self_attention.launches
    _compare(jm, params, tm, ids, am)
    assert fused_self_attention.launches == launches
