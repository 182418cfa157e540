"""The port's W8A8 layer (``ops/quant.py``, ``BertConfig.quantize_int8``)
against the JAX package's ``ops/quant.py`` on the same numpy inputs, and a
tiny quantized ``FullContextRerankModel`` against JAX's on the same bridged
weights. Everything runs on the CPU, where ``torch._int_mm`` gives the exact
int32 product.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine.rerank_eval import (  # noqa: E402
    make_chunked_rerank_fn as jmake_rerank,
)
from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import vit as jvit  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import (  # noqa: E402
    rerank_model as jrerank,
)
from reranking_multimodal_retrievers_tpu.ops import quant as jquant  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import make_chunked_rerank_fn  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    rerank_model as trerank,
)
from reranking_multimodal_retrievers_tpu_torch.ops import quant as tquant  # noqa: E402


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.lognormal(size=shape[:-1] + (1,))).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 96), (16,)])
def test_quantize_rows_bitwise_equal_to_jax(shape):
    x = _x(0, *shape)
    x[..., 0] = 0.0
    if len(shape) > 1:
        x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_cols_bitwise_equal_to_jax():
    w = _x(1, 16, 32).T.copy()  # [in, out] with a scale per output column
    jq, js = jquant.quantize_cols(jnp.asarray(w))
    tq, ts = tquant.quantize_cols(torch.as_tensor(w))
    assert tuple(ts.shape) == (1, 16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_and_cols_roundtrip():
    """Symmetric int8: per-element error at most half a quantization step."""
    x = torch.as_tensor(_x(2, 5, 64))
    q, s = tquant.quantize_rows(x)
    assert ((q.float() * s - x).abs() <= s * 0.5 + 1e-7).all()
    w = torch.as_tensor(_x(3, 16, 32).T.copy())
    q, s = tquant.quantize_cols(w)
    assert ((q.float() * s - w).abs() <= s * 0.5 + 1e-7).all()


@pytest.mark.parametrize("xshape", [(4, 7, 96), (96,), (3, 96)])
def test_int8_dot_matches_jax(xshape):
    x = _x(4, *xshape)
    w = np.random.default_rng(5).normal(size=(96, 48)).astype(np.float32)
    want = np.asarray(jquant.int8_dot(jnp.asarray(x), jnp.asarray(w)))
    got = tquant.int8_dot(torch.as_tensor(x), torch.as_tensor(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == xshape[:-1] + (48,)
    # the same int32 products and the same fp32 rescale (acc * xs) * ws:
    # 1e-6 relative covers a last-bit difference in the rescale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # and W8A8 on gaussian data tracks the fp32 product to ~1%
    oracle = x @ w
    assert np.linalg.norm(got.numpy() - oracle) / np.linalg.norm(oracle) < 0.02


def test_int8_dot_raises_on_grad_requiring_input():
    x = torch.randn(3, 16, requires_grad=True)
    w = torch.randn(16, 8)
    with pytest.raises(NotImplementedError, match="backward"):
        tquant.int8_dot(x, w)
    lin = tquant.Int8Linear(16, 8)
    with pytest.raises(NotImplementedError):
        lin(torch.randn(3, 16))  # the weight requires grad
    with torch.no_grad():
        assert lin(torch.randn(3, 16)).shape == (3, 8)


def test_int8linear_loads_linear_state_dict():
    """Same parameters as nn.Linear: a float state dict loads unchanged and
    the W8A8 output tracks the float one; dtypes promote as nn.Linear's."""
    torch.manual_seed(0)
    ref = torch.nn.Linear(8, 4)
    lin = tquant.Int8Linear(8, 4)
    assert lin.state_dict().keys() == ref.state_dict().keys()
    lin.load_state_dict(ref.state_dict())
    x = torch.ones(2, 8)
    with torch.no_grad():
        np.testing.assert_allclose(lin(x).numpy(), ref(x).numpy(), rtol=0.05, atol=0.02)
        assert lin(x.bfloat16()).dtype == torch.float32  # bf16 x over fp32 weights
        assert lin.bfloat16()(x.bfloat16()).dtype == torch.bfloat16


def test_bert_int8_matches_jax():
    """Every dense layer of BERT W8A8 on both sides, the same weights."""
    kw = dict(hidden_size=64, num_attention_heads=2, intermediate_size=128,
              quantize_int8=True)
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 1000, size=(2, 12)).astype(np.int32)
    am = np.ones((2, 12), np.int32)
    am[1, 8:] = 0
    jm = jbert.BertModel(jbert.BertConfig.tiny(**kw))
    params = jax.device_get(jm.init(jax.random.PRNGKey(6), ids, am)["params"])
    want = jm.apply({"params": params}, ids, am)

    tm = tbert.BertModel(tbert.BertConfig.tiny(**kw), device="cpu")
    assert isinstance(tm.encoder.layer[0].attention.self.query, tquant.Int8Linear)
    assert isinstance(tm.pooler.dense, tquant.Int8Linear)
    tm.load_state_dict(weights.bert_state_dict(params))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids).long(), torch.as_tensor(am))
    # fp32 on both sides with identical int8 codes: fp32 round-off of
    # LayerNorm'd activations of order 1
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-4)


def test_full_context_rerank_int8_matches_jax():
    """The tiny monoPreFLMR cross-encoder with quantize_int8 in both BERT
    configs, JAX and port on the same bridged weights."""
    K, L, LQ = 4, 24, 6

    def cfgs(bert, flmr, vit, rerank):
        text = bert.BertConfig.tiny(quantize_int8=True)
        fcfg = flmr.FLMRConfig(text_config=text, vision_config=vit.CLIPVisionConfig.tiny(),
                               dim=8, mapping_network_prefix_length=2,
                               use_transformer_mapping_network=True,
                               transformer_mapping_num_hidden_layers=1)
        return rerank.RerankConfig(
            flmr=fcfg, cross_encoder=bert.BertConfig.tiny(
                num_hidden_layers=1, max_position_embeddings=128, quantize_int8=True),
            loss_fn="BCE", max_query_length=LQ, max_decoder_source_length=L)

    rng = np.random.default_rng(7)
    ids = rng.integers(10, 1000, size=(2 * K, L)).astype(np.int32)
    am = np.ones((2 * K, L), np.int32)
    am[1, 18:] = 0
    tt = np.repeat([[0] * LQ + [1] * (L - LQ)], 2 * K, axis=0).astype(np.int32)
    pix = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)

    jr = jrerank.FullContextRerankModel(cfgs(jbert, jflmr, jvit, jrerank))
    init = jax.jit(jr.init, static_argnames="num_negative_examples")
    params = jax.device_get(init(jax.random.PRNGKey(7), ids[:K], am[:K], tt[:K], pix[:1],
                                 num_negative_examples=K - 1)["params"])
    want = np.asarray(jmake_rerank(jr, nway=K, chunk_size=K, jit=False)(
        params, ids, am, tt, pix))

    tr = trerank.FullContextRerankModel(cfgs(tbert, tflmr, tvit, trerank), device="cpu")
    tr.load_state_dict(weights.rerank_state_dict(params))
    got = make_chunked_rerank_fn(tr, nway=K, chunk_size=K)(
        torch.as_tensor(ids).long(), torch.as_tensor(am), torch.as_tensor(tt).long(),
        torch.as_tensor(pix)).numpy()
    assert got.shape == (2, K) and np.isfinite(got).all()
    # fp32 on both sides through 2 + 1 + 1 W8A8 BERT layers and the ViT
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
