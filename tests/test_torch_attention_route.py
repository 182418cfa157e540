"""One gate for every fused-attention route: the port's BERT
(``models/bert.py::attention_route``), T5 encoder (``T5Attention._can_fuse``)
and OPT (``OPTAttention.forward``, on the card only) take K2 exactly where the
JAX package's ``head_pack_feasible`` admits the head geometry, whatever the
device (the port's copy, ``ops/attention_cuda.py::head_pack_feasible``, is
the gate on the card). And BERT, T5 and OPT under ``use_pallas_attention``
at 4 heads x 16 (refused by the gate), 4 x 32 and 2 x 128 (admitted) match
the JAX package on the same numpy weights, on the CPU: fp32, tolerance 1e-4
abs / 1e-4 rel (fp32 round-off of two layers of order-1 activations, summed
in another order on each side; JAX runs its Pallas kernel in interpret mode where it fuses, the
port K2's plain version)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import t5 as jt5  # noqa: E402
from reranking_multimodal_retrievers_tpu.ops.platform import (  # noqa: E402
    head_pack_feasible as jax_gate,
)
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import t5 as tt5  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import attention_cuda  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = range(1, 17)
HEAD_DIMS = (8, 16, 24, 32, 48, 64, 80, 96, 104, 112, 128, 256)


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bert_route_equals_the_jax_gate(use_pallas):
    cfg = tbert.BertConfig.tiny(use_pallas_attention=use_pallas)
    for nh in HEADS:
        for hd in HEAD_DIMS:
            want = "k2" if use_pallas and jax_gate(nh, hd) else "unfused"
            assert tbert.attention_route(cfg, 64, True, False, nh, hd) == want, (nh, hd)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_t5_encoder_route_equals_the_jax_gate(use_pallas):
    for nh in HEADS:
        for hd in HEAD_DIMS:
            cfg = tt5.T5Config(vocab_size=32, d_model=32, d_kv=hd, d_ff=32, num_layers=1,
                               num_decoder_layers=1, num_heads=nh,
                               use_pallas_attention=use_pallas)
            jcfg = jt5.T5Config(**dataclasses.asdict(cfg))
            enc = tt5.T5ForConditionalGeneration(cfg, device="meta").encoder
            attn = enc.block[0].layer[0].SelfAttention
            want = jt5.T5Attention(jcfg, has_relative_bias=True)._can_fuse(None, None)
            assert want == (use_pallas and jax_gate(nh, hd))
            assert attn._can_fuse(None) == want, (nh, hd)


def test_the_card_gate_equals_the_jax_gate():
    """What OPT (and BERT and T5) ask on the card: the port's copy of the
    gate decides every geometry as the JAX package's does."""
    for nh in HEADS:
        for hd in HEAD_DIMS:
            assert attention_cuda.head_pack_feasible(nh, hd) == jax_gate(nh, hd), (nh, hd)


def test_opt_never_fuses_on_the_cpu(monkeypatch):
    """OPT's JAX gate also asks for a TPU: off the card the port takes the
    unfused path at admitted and refused geometries alike."""
    from reranking_multimodal_retrievers_tpu_torch.models import opt as topt

    calls = []
    monkeypatch.setattr(topt, "fused_self_attention", lambda *a, **k: calls.append(a))
    for nh, hd in ((4, 16), (4, 32), (2, 128)):
        cfg = topt.OPTConfig.tiny(hidden_size=nh * hd, num_attention_heads=nh,
                                  use_pallas_attention=True)
        attn = topt.OPTAttention(cfg)
        x = torch.zeros(1, 8, nh * hd)
        with torch.no_grad():
            out = attn(x, torch.zeros(1, 1, 8, 8), torch.ones(1, 8))
        assert out.shape == x.shape
    assert calls == []


@pytest.mark.parametrize("fp32", [False, True])
def test_every_admitted_geometry_maps_to_a_kernel(fp32):
    """Every (heads <= 128, head_dim <= 512) the JAX gate admits runs a
    hand-written kernel on the card: the per-width instance for a head_dim
    in ``KERNEL_HEAD_DIMS``, the generic kernel for any other (ViT-G's
    16 x 104, 32 x 12, 2 x 256, 1 x 384, ...); none raises."""
    from reranking_multimodal_retrievers_tpu_torch.ops import _build

    generic = 0
    for nh in range(1, 129):
        for hd in range(1, 513):
            if not jax_gate(nh, hd):
                continue
            assert attention_cuda._head_dim(nh * hd, nh) == hd
            lib = attention_cuda.kernel_library(hd, fp32)
            assert lib in _build.SOURCES, (nh, hd)
            if hd in attention_cuda.KERNEL_HEAD_DIMS:
                kind = "attention_f32" if fp32 else "attention"
                assert lib == attention_cuda._library(kind, hd), (nh, hd)
                assert _build.SOURCES[lib] == kind + ".cu", (nh, hd)
            else:
                assert _build.SOURCES[lib] == "attention_any.cu", (nh, hd)
                generic += 1
    assert generic > 0
    for nh, hd in ((16, 104), (32, 12), (2, 256), (1, 384), (16, 8)):
        assert jax_gate(nh, hd) and attention_cuda.kernel_library(hd, fp32) == (
            "attention_any_f32" if fp32 else "attention_any")
    with pytest.raises(ValueError, match="heads"):
        attention_cuda._head_dim(100, 3)


GEOMETRIES = [(4, 16), (4, 32), (2, 128)]


@pytest.mark.parametrize("nh,hd", GEOMETRIES)
def test_bert_under_use_pallas_attention_matches_jax(nh, hd):
    kw = dict(hidden_size=nh * hd, num_attention_heads=nh, intermediate_size=64,
              use_pallas_attention=True)
    rng = np.random.default_rng(hd)
    ids = rng.integers(1, 1000, size=(2, 16)).astype(np.int32)
    am = np.ones((2, 16), np.int32)
    am[1, 11:] = 0
    ids[1, 11:] = 0
    jm = jbert.BertModel(jbert.BertConfig.tiny(**kw))
    params = jax.device_get(jm.init(jax.random.PRNGKey(hd), ids, am)["params"])
    want = np.asarray(jm.apply({"params": params}, ids, am)["last_hidden_state"])
    tm = tbert.BertModel(tbert.BertConfig.tiny(**kw), device="cpu")
    tm.load_state_dict(weights.bert_state_dict(params))
    fused = tbert.attention_route(tm.config, 16, True, False, nh, hd) == "k2"
    assert fused == jax_gate(nh, hd)
    with torch.no_grad():
        got = tm(torch.as_tensor(ids).long(), torch.as_tensor(am))["last_hidden_state"]
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("nh,hd", GEOMETRIES)
def test_t5_under_use_pallas_attention_matches_jax(nh, hd):
    from test_torch_t5 import _compare, t5_pair

    jm, params, tm, io = t5_pair(seed=hd, L=16, num_heads=nh, d_kv=hd, d_model=64,
                                 use_pallas_attention=True)
    assert tm.encoder.block[0].layer[0].SelfAttention._can_fuse(None) == jax_gate(nh, hd)
    _compare(jm, params, tm, *io)


@pytest.mark.parametrize("nh,hd", GEOMETRIES)
def test_opt_under_use_pallas_attention_matches_jax(nh, hd):
    from test_torch_opt import _compare, opt_pair

    jm, params, tm, ids, am = opt_pair(seed=hd, hidden_size=nh * hd, num_attention_heads=nh,
                                       use_pallas_attention=True)
    _compare(jm, params, tm, ids, am)
