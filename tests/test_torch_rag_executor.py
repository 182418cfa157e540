"""The port's RAG executor (``executors/rag_executor.py``) and its
checkpoint-directory reader (``models/checkpoint_dir.py``) against the JAX
package's, in fp32 on the CPU (JAX at matmul precision "highest").

- ``greedy_decode_with_nll`` on fixed logits functions: the same tokens and
  the same losses (within 1e-6 of each other on a table lookup, 1e-5
  through a model).
- ``RagExecutor`` with the BLIP-2 Flan-T5 and the native generators on
  ``configs/okvqa_rag_blip2.json``, JAX's initial weights carried in
  (``models/weights.py``): each doc's generated tokens equal up to the
  first step whose top-2 logit gap is under ``NEAR_TIE`` (past it two fp32
  programs may take either token; the step is printed), each doc's loss of
  its own generation within 1e-5 where the tokens agree, the metrics equal
  when no near tie was met, one RAG-sequence train step's loss within 1e-5.
- A BLIP-2 state dict written as ``.safetensors`` (fp32 and bf16) and as
  ``.bin``: read bitwise into the decoder reranker's backbone, the heads
  keeping their init, and p(yes) within 1e-5 of the JAX executor's, which
  bridges the same directory through ``hf_bridge.blip2_params``.
"""

import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reranking_multimodal_retrievers_tpu.executors import rag_executor as jrag  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import hf_bridge  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.executors import rag_executor as trag  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import checkpoint_dir  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402
from test_torch_executors import J, T, _executor  # noqa: E402

NEAR_TIE = 1e-5
RAG_CONFIG = "okvqa_rag_blip2.json"
RAG_OPTS = ("train.batch_size=2", "valid.batch_size=2", "valid.trainer_paras.limit_val_batches=1")
NATIVE = ("model_config.decoder={'backbone': 'native', 'text_config': {'vocab_size': 30522, "
          "'hidden_size': 64, 'num_hidden_layers': 2, 'num_attention_heads': 4, "
          "'intermediate_size': 128}, 'num_decoder_layers': 1, 'vision_prefix_length': 4, "
          "'lora_r': 8}")


# ---- greedy decoding ----------------------------------------------------------

def _table_logits(pkg_np, table, pos):
    """logits[b, t] = table[tokens[b, t]] + pos[t]: a fixed function of each
    position's own token, as a causal decoder's position t depends on
    positions <= t."""
    def fn(tokens):
        return table[tokens] + pos[None, :tokens.shape[1]]
    return fn


@pytest.mark.parametrize("start_id,pad_id,L", [(2, 0, 6), (1, 3, 5), (0, 0, 1)])
def test_greedy_decode_with_nll_matches_jax_on_a_table(start_id, pad_id, L):
    rng = np.random.default_rng(start_id * 10 + L)
    V = 11
    table = rng.normal(size=(V, V)).astype(np.float32)
    table[:, pad_id] += 0.8  # some rows generate pad, whose positions the loss masks
    pos = rng.normal(size=(L, V)).astype(np.float32)
    enc = np.zeros((4, 3, 8), np.float32)
    jl, jloss = jrag.greedy_decode_with_nll(
        _table_logits(jnp, jnp.asarray(table), jnp.asarray(pos)), jnp.asarray(enc),
        None, start_id, pad_id, L)
    tl, tloss = trag.greedy_decode_with_nll(
        _table_logits(torch, torch.as_tensor(table), torch.as_tensor(pos)),
        torch.as_tensor(enc), None, start_id, pad_id, L)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-6, atol=1e-6)


def test_greedy_decode_with_nll_matches_jax_through_a_decoder():
    """JAX ``tests/test_engine_extras.py:330``'s VisionSeq2SeqLM case, the
    port's model holding JAX's weights: the same tokens and losses, and the
    rescoring pass reproduces each token as the argmax at its position."""
    from reranking_multimodal_retrievers_tpu.models.rerankers import decoder as jdec
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import decoder as tdec
    from test_torch_decoder_reranker import _port_compact_config

    cfg = jdec.DecoderRerankConfig.tiny()
    model = jdec.VisionSeq2SeqLM(cfg)
    B, Ls, L = 3, 7, 6
    ids = np.random.default_rng(0).integers(1, cfg.text_config.vocab_size, (B, Ls))
    mask = np.ones((B, Ls), np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                        jnp.ones((B, 1), jnp.int32))["params"]
    j_enc, j_mask = model.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                jnp.asarray(mask), method=jdec.VisionSeq2SeqLM.encode)
    jl, jloss = jrag.greedy_decode_with_nll(
        lambda t: model.apply({"params": params}, t, j_enc, j_mask,
                              method=jdec.VisionSeq2SeqLM.decode)[0],
        j_enc, j_mask, 2, 0, L)

    tm = tdec.VisionSeq2SeqLM(_port_compact_config(cfg), device="cpu")
    # flax made no vision tower where init saw no pixels; this decode reads none
    missing, _ = tm.load_state_dict(weights.vision_seq2seq_state_dict(jax.device_get(params)),
                                    strict=False)
    assert missing and all(k.startswith("vision_") for k in missing)
    with torch.no_grad():
        t_enc, t_mask = tm.encode(torch.as_tensor(ids), torch.as_tensor(mask))
        np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), rtol=1e-5, atol=1e-5)
        steps = []

        def decode(t):
            logits = tm.decode(t, t_enc, t_mask)[0]
            steps.append(logits)
            return logits

        tl, tloss = trag.greedy_decode_with_nll(decode, t_enc, t_mask, 2, 0, L)
        gaps = torch.stack([torch.topk(s[:, t], 2).values.diff(dim=-1).abs()[:, 0]
                            for t, s in enumerate(steps[:L])], dim=1)
        assert bool((gaps > NEAR_TIE).all()), gaps  # no near tie on this seed
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-5)
        # the rescoring pass's conditioning is the generation's
        dec_in = torch.cat([torch.full((B, 1), 2), tl[:, :-1]], dim=1)
        assert torch.equal(tm.decode(dec_in, t_enc, t_mask)[0].argmax(-1), tl)


# ---- the executor -------------------------------------------------------------

def _rag_pair(tmp_path, monkeypatch, *opts):
    monkeypatch.chdir(tmp_path)
    jex = _executor(J, RAG_CONFIG, tmp_path / "jax", "train", *RAG_OPTS, *opts)
    tex = _executor(T, RAG_CONFIG, tmp_path / "port", "train", *RAG_OPTS, *opts)
    params = jax.device_get(jex.params)
    carry = (weights.blip2_state_dict if jex.backbone == "blip2"
             else weights.vision_seq2seq_state_dict)
    tex.lm.load_state_dict(carry(params))
    # the dummy OK-VQA images are resized, and the port's bicubic lies within
    # two 8-bit levels of PIL's (test_torch_data.py): both read JAX's batches
    tex.data_loaders = jex.data_loaders
    return jex, tex


def _first_near_tie(tex, query, docs, pix):
    """Per doc: the first greedy step of the port's decode whose top-2 logit
    gap is under NEAR_TIE (None: none)."""
    tok = tex.tokenizers["decoder_tokenizer"].tok
    enc = tok([f"question: {query} context: {d['content']}" for d in docs],
              padding="max_length", truncation=True, max_length=tex.max_source_length,
              return_tensors="np")
    steps = []
    orig = tex._decode_logits

    def record(*args):
        logits = orig(*args)
        steps.append(logits)
        return logits

    tex._decode_logits = record
    try:
        tex.generate_with_losses(torch.as_tensor(enc["input_ids"]),
                                 torch.as_tensor(enc["attention_mask"]), pix)
    finally:
        tex._decode_logits = orig
    L = tex.max_answer_length
    gaps = torch.stack([torch.topk(s[:, t].float(), 2).values.diff(dim=-1).abs()[:, 0]
                        for t, s in enumerate(steps[:L])], dim=1)
    out = []
    for row in gaps:
        low = torch.nonzero(row < NEAR_TIE)
        out.append(None if len(low) == 0 else int(low[0]))
    return out


@pytest.mark.parametrize("backbone", ["blip2", "native"])
def test_rag_executor_matches_jax(tmp_path, monkeypatch, backbone):
    jex, tex = _rag_pair(tmp_path, monkeypatch, *((NATIVE,) if backbone == "native" else ()))
    assert tex.backbone == jex.backbone == backbone
    assert tex.questionId2topPassages == jex.questionId2topPassages
    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    wr, gr = want["batch_retrieval_result"], got["batch_retrieval_result"]
    assert len(gr) == len(wr) > 0
    tok = tex.tokenizers["decoder_tokenizer"].tok
    batch = next(iter(next(iter(tex.eval_dataloaders("valid").values()))))
    ties = 0
    for qi, (w, g) in enumerate(zip(wr, gr)):
        assert g["question_id"] == w["question_id"] and g["doc_scores"] == w["doc_scores"]
        assert len(g["per_doc_predictions"]) == len(w["per_doc_predictions"])
        if g["per_doc_predictions"] == w["per_doc_predictions"]:
            np.testing.assert_allclose(g["loss_with_doc_scores"], w["loss_with_doc_scores"],
                                       rtol=1e-5, atol=1e-5)
            continue
        pix = torch.as_tensor(np.asarray(batch["pixel_values"])[qi:qi + 1])
        first_tie = _first_near_tie(tex, batch["questions"][qi], g["retrieved_docs"], pix)
        for d, (a, b) in enumerate(zip(w["per_doc_predictions"], g["per_doc_predictions"])):
            if a == b:
                np.testing.assert_allclose(g["loss_with_doc_scores"][d],
                                           w["loss_with_doc_scores"][d], rtol=1e-5, atol=1e-5)
                continue
            ta, tb = tok.encode(a, add_special_tokens=False), tok.encode(b, add_special_tokens=False)
            differ = next(i for i in range(max(len(ta), len(tb)))
                          if i >= min(len(ta), len(tb)) or ta[i] != tb[i])
            assert first_tie[d] is not None and first_tie[d] <= differ, (qi, d, a, b)
            print(f"query {qi} doc {d}: near tie at step {first_tie[d]}, tokens differ "
                  f"from {differ}")
            ties += 1
    if not ties:
        assert dict(got.metrics) == dict(want.metrics)
    assert "exact_match_at_1" in got.metrics

    jb = next(iter(jex.train_dataloader()))
    jex.prepare_training(10)
    tex.prepare_training(10)
    assert tex.training_step(jb)["loss"] == pytest.approx(jex.training_step(jb)["loss"],
                                                         rel=1e-5, abs=1e-5)


# ---- the checkpoint directory ---------------------------------------------------

ST_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16"}


def _write_safetensors(path, sd):
    """The safetensors package's writer where it is installed, else the
    format by hand: header length, JSON header, raw little-endian bytes."""
    try:
        from safetensors.torch import save_file
    except ImportError:
        header, blobs, off = {}, [], 0
        for k, v in sd.items():
            raw = v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            header[k] = {"dtype": ST_NAMES[v.dtype], "shape": list(v.shape),
                         "data_offsets": [off, off + len(raw)]}
            blobs.append(raw)
            off += len(raw)
        text = json.dumps(header).encode()
        text += b" " * (-len(text) % 8)
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(text)) + text + b"".join(blobs))
        return
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path))


def fresh_jax_config(cfg):
    return _executor(J, cfg, "jax_cfg", "train", *CKPT_OPTS).reranker_config.blip2


CKPT_OPTS = ("valid.batch_size=2", "valid.trainer_paras.limit_val_batches=1",
             "model_config.modules=['decoder_reranker','train_with_retrieved_docs',"
             "'neg_sample_retrieved','full_validation']")


@pytest.mark.parametrize("fmt,dtype", [("safetensors", torch.float32),
                                       ("safetensors", torch.bfloat16),
                                       ("bin", torch.float32)])
def test_decoder_checkpoint_dir(tmp_path, monkeypatch, fmt, dtype):
    monkeypatch.chdir(tmp_path)
    cfg = "okvqa_rerank_decoder_blip2.json"
    fresh = _executor(T, cfg, tmp_path / "fresh", "train", *CKPT_OPTS,
                      "model_config.decoder_head=True")
    g = torch.Generator().manual_seed(5)
    # an HF checkpoint: no LoRA adapters
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g)).to(dtype)
          for k, v in fresh.reranker.model.state_dict().items() if ".lora_" not in k}
    # an HF tensor the port does not build (the Q-Former's text branch)
    sd["qformer.embeddings.layernorm.weight"] = torch.ones(64, dtype=dtype)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    if fmt == "safetensors":
        _write_safetensors(ckpt / "model.safetensors", sd)
    else:
        torch.save(sd, ckpt / "pytorch_model.bin")
    read = checkpoint_dir.load_checkpoint_dir(str(ckpt))
    assert read.keys() == sd.keys()
    for k in sd:
        assert read[k].dtype == dtype and torch.equal(read[k], sd[k]), k

    opt = f"model_config.decoder_checkpoint_dir='{ckpt}'"
    head = _executor(T, cfg, tmp_path / "head", "train", *CKPT_OPTS,
                     "model_config.decoder_head=True", opt)
    # the adapters as the JAX bridge makes them: lora_a from its seeded
    # draw, lora_b zero
    bridged = weights.blip2_state_dict(hf_bridge.blip2_params(
        hf_bridge.load_torch_checkpoint_dir(str(ckpt)), fresh_jax_config(cfg)))
    for k, v in head.reranker.model.state_dict().items():
        want = sd[k].float() if k in sd else bridged[k]
        assert torch.equal(v, want), k
    for n in ("classifier1", "classifier2"):  # the heads keep their init
        assert torch.equal(getattr(head.reranker, n).weight, getattr(fresh.reranker, n).weight)

    # Model A's p(yes) against the JAX executor bridging the same directory
    jex = _executor(J, cfg, tmp_path / "jax", "train", *CKPT_OPTS, opt)
    tex = _executor(T, cfg, tmp_path / "port", "train", *CKPT_OPTS, opt)
    tex.data_loaders = jex.data_loaders  # resized dummy images: JAX's batches
    want, got = jex.evaluate("valid"), tex.evaluate("valid")
    for w, gg in zip(want["batch_retrieval_result"], got["batch_retrieval_result"]):
        ws = {p["passage_id"]: p["score"] for p in w["top_ranking_passages"]}
        gs = {p["passage_id"]: p["score"] for p in gg["top_ranking_passages"]}
        assert ws.keys() == gs.keys()
        np.testing.assert_allclose([gs[k] for k in ws], list(ws.values()), rtol=1e-5, atol=1e-5)


def test_checkpoint_dir_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    from torch import nn

    model = nn.Linear(3, 2)
    with pytest.raises(KeyError, match="lacks"):
        checkpoint_dir.load_into(model, {"weight": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shapes"):
        checkpoint_dir.load_into(model, {"weight": torch.zeros(3, 2), "bias": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        checkpoint_dir.load_checkpoint_dir(str(tmp_path))
    os.makedirs(tmp_path / "cut")
    _write_safetensors(tmp_path / "cut" / "m.safetensors", {"w": torch.ones(4)})
    data = (tmp_path / "cut" / "m.safetensors").read_bytes()
    (tmp_path / "cut" / "m.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="cut short"):
        checkpoint_dir.load_checkpoint_dir(str(tmp_path / "cut"))
