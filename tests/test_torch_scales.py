"""The port at the published retrievers' larger scales and the W8A8 decoder
rerankers, against the JAX package on the same numpy inputs and weights
(carried across by ``models/weights.py``). Both sides run in fp32 on the CPU
(JAX at matmul precision "highest", set by ``tests/conftest.py``).

- FLMR ``query``/``doc`` with PreFLMR-L's and PreFLMR-G's vision towers at
  their published widths and heads (ViT-L/14: 1024 wide, head_dim 64;
  ViT-G/14: 1664 wide, head_dim 104), patch 14, at a depth of 2 layers and
  56 px (16 patches).
- monoPreFLMR's ``FullContextRerankModel`` through ``make_chunked_rerank_fn``
  at a joint length past 512 (500 text + 4 prefix + 16 patch rows) with the
  cross-encoder's ``max_position_embeddings`` at 1024, as ``bench.py``'s L
  model has it.
- ``make_decoder_rerank_fn`` over tiny BLIP-2 Flan-T5 and OPT rerankers with
  ``quantize_int8``: p(yes), and the int8 codes and scales of the LM's first
  W8A8 layer, against the JAX package's ``Int8Dense``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine.rerank_eval import (  # noqa: E402
    make_chunked_rerank_fn as jmake_rerank,
)
from reranking_multimodal_retrievers_tpu.models import bert as jbert  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import blip2 as jblip2  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import opt as jopt  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import t5 as jt5  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import vit as jvit  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import decoder as jdec  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.rerankers import (  # noqa: E402
    rerank_model as jrerank,
)
from reranking_multimodal_retrievers_tpu.ops import quant as jquant  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import (  # noqa: E402
    make_chunked_rerank_fn,
    make_decoder_rerank_fn,
)
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    decoder as tdec,
)
from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (  # noqa: E402
    rerank_model as trerank,
)
from reranking_multimodal_retrievers_tpu_torch.ops import quant as tquant  # noqa: E402
from test_torch_blip2 import NWAY, port_blip2_config, rerank_io  # noqa: E402

# fp32 on both sides: round-off through the ViT, 2 BERT layers, the mapping
# network and the L2 normalisation of order-1 rows
TOL = dict(atol=1e-4, rtol=1e-4)

# configs/okvqa_flmr_{L,G}.json's vision towers at 2 layers and 56 px
VISION = {
    "L": dict(hidden_size=1024, intermediate_size=4096, num_attention_heads=16),
    "G": dict(hidden_size=1664, intermediate_size=8192, num_attention_heads=16),
}
PATCH14 = dict(num_hidden_layers=2, image_size=56, patch_size=14)
TEXT = dict(use_pallas_attention=True, max_position_embeddings=512)


def _configs(vision, **flmr_kw):
    """The same FLMR config on both sides: a tiny BERT, ``vision`` at
    patch 14, dim 16, a 4-token prefix and the transformer mapping network."""
    both = []
    for bert, vit, flmr in ((jbert, jvit, jflmr), (tbert, tvit, tflmr)):
        both.append(flmr.FLMRConfig.tiny(
            text_config=bert.BertConfig.tiny(**TEXT),
            vision_config=vit.CLIPVisionConfig(**vision, **PATCH14), **flmr_kw))
    return both


def _tokens(rng, B, L, min_len):
    ids = rng.integers(8, 1000, size=(B, L)).astype(np.int32)
    lens = rng.integers(min_len, L + 1, size=B)
    am = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return ids * am, am


@pytest.mark.parametrize("scale", ["L", "G"])
def test_flmr_query_and_doc_at_patch_14(scale):
    """Query rows are 8 text + 4 prefix + 16 mapped patch rows; the head_dim
    (64 for L, 104 for G) and the patch-14 convolution are carried across."""
    jcfg, tcfg = _configs(VISION[scale], context_concat_output_from_vision_encoder=True)
    assert tcfg.vision_config.head_dim == (64 if scale == "L" else 104)
    rng = np.random.default_rng(11)
    q_ids, q_am = _tokens(rng, 2, 8, 8)
    d_ids, d_am = _tokens(rng, 2, 12, 4)
    d_ids[0, 2] = 5  # a punctuation id: masked on the doc side
    pix = rng.normal(size=(2, 3, 56, 56)).astype(np.float32)
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    params = jax.device_get(jax.jit(jm.init, static_argnames="num_negative_examples")(
        jax.random.PRNGKey(11), q_ids, q_am, d_ids, d_am, query_pixel_values=pix,
        context_pixel_values=pix, num_negative_examples=0)["params"])
    tm = tflmr.FLMRModelForRetrieval(tcfg, device="meta")
    tm.load_state_dict(weights.flmr_state_dict(params), assign=True)

    @jax.jit
    def jquery_doc(p):
        run = jflmr.FLMRModelForRetrieval
        return (jm.apply({"params": p}, q_ids, q_am, pix, method=run.query),
                jm.apply({"params": p}, d_ids, d_am, pix, method=run.doc))

    jq, jd = jquery_doc(params)
    with torch.no_grad():
        tq = tm.query(torch.as_tensor(q_ids).long(), torch.as_tensor(q_am),
                      pixel_values=torch.as_tensor(pix))
        td = tm.doc(torch.as_tensor(d_ids).long(), torch.as_tensor(d_am),
                    pixel_values=torch.as_tensor(pix))
    assert tq.late_interaction_output.shape == (2, 8 + 4 + 16, 16)
    np.testing.assert_allclose(tq.late_interaction_output.numpy(),
                               np.asarray(jq.late_interaction_output), **TOL)
    np.testing.assert_array_equal(tq.query_mask.numpy(), np.asarray(jq.query_mask))
    assert td.late_interaction_output.shape == (2, 4 + 12, 16)
    np.testing.assert_allclose(td.late_interaction_output.numpy(),
                               np.asarray(jd.late_interaction_output), **TOL)
    np.testing.assert_array_equal(td.context_mask.numpy(), np.asarray(jd.context_mask))
    assert not td.context_mask[0, 4 + 2]


def test_full_context_rerank_past_512_joint_rows():
    """2 queries x 3 candidates of 24-63 text tokens padded to 500; the
    cross-encoder sees 500 + 4 + 16 = 520 rows (positions up to 519 of a
    1024-row table), in chunks of 3 rows (the ViT once a query). The short
    texts leave the 20 vision rows a large share of the attention, so the
    logits see them and their positions."""
    B, K, L, LQ = 2, 3, 500, 16
    vision = dict(hidden_size=128, intermediate_size=256, num_attention_heads=2)
    jf, tf = _configs(vision)
    jcfg, tcfg = (
        m.RerankConfig(flmr=f, cross_encoder=b.BertConfig.tiny(
            num_hidden_layers=1, max_position_embeddings=1024, use_pallas_attention=True),
            max_query_length=LQ, max_decoder_source_length=L)
        for m, b, f in ((jrerank, jbert, jf), (trerank, tbert, tf)))
    rng = np.random.default_rng(12)
    ids = rng.integers(8, 1000, size=(B * K, L)).astype(np.int32)
    am = (np.arange(L)[None, :] < rng.integers(24, 64, size=B * K)[:, None]).astype(np.int32)
    ids *= am
    tt = np.concatenate([np.zeros((B * K, LQ), np.int32),
                         np.ones((B * K, L - LQ), np.int32)], axis=1)
    pix = rng.normal(size=(2 * B, 3, 56, 56)).astype(np.float32)
    jr = jrerank.FullContextRerankModel(jcfg)
    params = jax.device_get(jax.jit(jr.init, static_argnames="num_negative_examples")(
        jax.random.PRNGKey(12), ids[:K], am[:K], tt[:K], pix[:1],
        num_negative_examples=K - 1)["params"])
    want = np.asarray(jmake_rerank(jr, nway=K, chunk_size=3)(params, ids, am, tt, pix[:B]))
    tr = trerank.FullContextRerankModel(tcfg, device="meta")
    tr.load_state_dict(weights.rerank_state_dict(params), assign=True)
    fn = make_chunked_rerank_fn(tr, nway=K, chunk_size=3)
    rows = []
    hook = tr.reranker.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[1]))
    try:
        got = fn(*(torch.as_tensor(x) for x in (ids, am, tt, pix[:B])))
    finally:
        hook.remove()
    assert rows == [L + 4 + 16] * (B * K // 3)
    assert got.shape == (B, K) and np.isfinite(got.numpy()).all()
    # fp32 on both sides through 2 + 1 BERT layers, the ViT and the mapping
    # network: round-off of a few 1e-7 on logits of order 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # other images move the logits by far more than that tolerance
    other = fn(*(torch.as_tensor(x) for x in (ids, am, tt, pix[B:])))
    assert (other - got).abs().max() > 1e-4


def _first_int8_input_jax(jm, params, ids, am, pix):
    """The JAX reranker's output, and the input and module path of the
    first ``Int8Dense`` it calls (one jitted program)."""
    paths = []

    def run(params):
        seen = []

        def grab(next_fun, args, kwargs, context):
            if isinstance(context.module, jquant.Int8Dense) and not seen:
                seen.append(args[0])
                paths.append(context.module.path)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(grab):
            out = jm.apply({"params": params}, ids, am, pix, num_negative_examples=NWAY - 1)
        return out.logits, seen[0]

    logits, x = jax.jit(run)(params)
    return np.asarray(logits), np.asarray(x), paths[0]


@pytest.mark.parametrize("opt", [False, True], ids=["t5", "opt"])
def test_w8a8_decoder_rerank_fn_matches_jax(opt):
    """p(yes) of NWAY prompts (two right-padded) through the port's chunked
    program, every LM dense layer and the head W8A8, against the JAX
    reranker with the same weights; and the first W8A8 layer's int8 codes
    and scales, activations and weights, against the JAX quantizers."""
    text = jopt.OPTConfig.tiny() if opt else jt5.T5Config.tiny()
    jcfg = jdec.Blip2RerankConfig(blip2=jblip2.Blip2Config.tiny(text_config=text),
                                  yes_token_id=10, no_token_id=11)
    _, ids, am, pix = rerank_io(6)
    # Int8Dense keeps nn.Dense's parameters: the bf16 model's init gives the
    # W8A8 model's weights (and compiles in a fifth of the time)
    jm = jdec.Blip2DecoderRerankModel(jcfg)
    params = jax.device_get(jax.jit(jm.init, static_argnames="num_negative_examples")(
        jax.random.PRNGKey(6), ids, am, pix, num_negative_examples=NWAY - 1)["params"])
    jcfg = dataclasses.replace(jcfg, blip2=dataclasses.replace(
        jcfg.blip2, text_config=dataclasses.replace(text, quantize_int8=True)))
    jm = jdec.Blip2DecoderRerankModel(jcfg)
    tcfg = tdec.Blip2RerankConfig(blip2=port_blip2_config(jcfg.blip2), yes_token_id=10,
                                  no_token_id=11)
    assert tcfg.blip2.text_config.quantize_int8 and tcfg.blip2.text_config.lora_r == 0
    tm = tdec.Blip2DecoderRerankModel(tcfg, device="meta")
    tm.load_state_dict(weights.blip2_rerank_state_dict(params), assign=True)
    int8_layers = [(n, m) for n, m in tm.named_modules() if isinstance(m, tquant.Int8Linear)]
    assert int8_layers and all(".language_model." in f".{n}" for n, _ in int8_layers)

    want, jx, jpath = _first_int8_input_jax(jm, params, ids, am, pix)
    seen = []

    def keep_first(name):
        def hook(module, args, out):
            if not seen:
                seen.append((name, args[0].detach().clone(), module))
        return hook

    hooks = [m.register_forward_hook(keep_first(n)) for n, m in int8_layers]
    try:
        got = make_decoder_rerank_fn(tm, chunk_size=NWAY)(
            torch.as_tensor(ids).long(), torch.as_tensor(am), torch.as_tensor(pix))
    finally:
        for h in hooks:
            h.remove()
    assert got.shape == (NWAY,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want[:, 0], **TOL)

    # the same layer on both sides: the LM's first projection
    name, tx, layer = seen[0]
    assert name.split(".")[-1] == jpath[-1], (name, jpath)
    tx = tx.reshape(-1, tx.shape[-1])
    jx = jx.reshape(-1, jx.shape[-1])
    assert tx.shape == jx.shape
    tq, ts = tquant.quantize_rows(tx)
    jq, js = jquant.quantize_rows(jx)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    # the activations differ by fp32 round-off: a code may differ only by one,
    # and only where the unrounded value lies within 1e-3 of a half step
    diff = tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
    frac = np.abs(np.abs(jx / np.asarray(js)) % 1.0 - 0.5)
    assert np.abs(diff).max() <= 1 and (frac[diff != 0] < 1e-3).all()
    assert (diff == 0).mean() > 0.99
    # the weights, carried across, quantize to the JAX kernel's codes and
    # scales bitwise
    jkernel = params
    for key in jpath:
        jkernel = jkernel[key]
    wq, ws = tquant.quantize_cols(layer.weight.detach().t())
    jwq, jws = jquant.quantize_cols(jkernel["kernel"])
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
