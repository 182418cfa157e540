"""ModuleParser: declarative per-sample feature assembly.

Parity with the reference ModuleParser
(`src/data_ops/custom_datasets/module_parser.py:36-1008`): a sample's model
inputs are declared in config as ``input_modules`` / ``decoder_input_modules``
/ ``output_modules`` — lists of ``{type, option, separation_tokens, ...}``
modules. Each input parser contributes text segments and/or images; the
post-processors tokenize/process the assembled segments into fixed-shape
NumPy arrays. Images are read by ``data/image_io.py`` as ``uint8 [H, W, 3]``
arrays (the JAX package's parsers hand PIL images on).

Implemented parsers: QuestionInput (`:36`), InstructionInput (`:54`),
EmptyTextInput (`:79`), TextBasedVisionInput (`:88`), VisionInput (`:167`),
KnowledgeInput (`:233`), PassageVisionInput (`:247`), SimilarityOutput
(`:269`), GenerationOutput (`:154`).
Post-processors: PostProcessInputTokenization (`:351`),
PostProcessDecoderInputTokenization (`:374`),
PostProcessOutputTokenization (`:398`, pad→−100 label masking),
PostProcessBlipOutputTokenization (`:439`),
PostProcessColBERT{Question,Item}InputTokenization (`:484,620`),
PostProcessFLMRQuestionInputTokenization (`:506`),
PostProcessLLaVAQuestionInputTokenization (`:530`, prompt template +
image/instruction/question masks),
PostProcessFLMRItemInputTokenization (`:641`),
PostProcessQWenQuestionInputTokenization (`:663`, chat-template prompt),
PostProcessVisionInputProcessing (`:922`),
PostProcessBlip2VisionInputProcessing (`:933`),
PostProcessVisionInputFromEmbeddings (`:949`),
PostProcessItemVisionInputFromEmbeddings (`:969`),
PostProcessConcatenateLabels (`:906`).
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

from .image_io import read_image

logger = logging.getLogger(__name__)


class ModuleParser:
    """Mixin over objects exposing ``self.config`` (with ``input_modules``
    etc.) and tokenizer/processor attributes set by the dataloader layer:
    ``tokenizer``, ``decoder_tokenizer``, ``image_processor``."""

    # ------------------------------------------------------ input parsers
    def QuestionInput(self, sample, module) -> Dict:
        """text sequence from the question; option 'default' or
        'add_OCR'/'add_caption' variants append those fields when present."""
        text = sample.get("question", "") or ""
        if module.get("option") == "add_OCR" and sample.get("ocr_text"):
            text = f"{text} {sample['ocr_text']}"
        if module.get("option") == "add_caption" and sample.get("caption"):
            text = f"{text} {sample['caption']}"
        sep = module.get("separation_tokens", {})
        return {"text_sequence": _wrap(text, sep)}

    def InstructionInput(self, sample, module) -> Dict:
        return {"text_sequence": _wrap(sample.get("instruction", "") or "", module.get("separation_tokens", {}))}

    def TextBasedVisionInput(self, sample, module) -> Dict:
        """Verbalized vision: caption and/or object tags as text
        (reference `:88-152`)."""
        option = module.get("option", "caption")
        parts = []
        if option in ("caption", "combine") and sample.get("caption"):
            parts.append(str(sample["caption"]))
        if option in ("object", "combine") and sample.get("objects"):
            objects = sample["objects"]
            if isinstance(objects, (list, tuple)):
                names = [o.get("class", str(o)) if isinstance(o, dict) else str(o) for o in objects]
                parts.append(" ".join(names))
            else:
                parts.append(str(objects))
        return {"text_sequence": _wrap(" ".join(parts), module.get("separation_tokens", {}))}

    def VisionInput(self, sample, module) -> Dict:
        """Image input: an RGB array read from ``img_path``, precomputed
        ``image_features``, or stacked ROI images (reference `:167-231`)."""
        option = module.get("option", "from_file")
        if option == "from_embeddings" and sample.get("image_features") is not None:
            return {"image_features": np.asarray(sample["image_features"], np.float32)}
        image = sample.get("image")
        if image is None and sample.get("img_path"):
            image = read_image(sample["img_path"])
        images = [image] if image is not None else []
        if module.get("use_ROI") and sample.get("ROIs"):
            images.extend(sample["ROIs"])
        return {"images": images}

    def EmptyTextInput(self, sample, module) -> Dict:
        """Reference `:79-86` — a no-text placeholder module."""
        return {"text_sequence": ""}

    def KnowledgeInput(self, sample, module) -> Dict:
        return {"text_sequence": _wrap(sample.get("passage_content", "") or "", module.get("separation_tokens", {}))}

    def PassageVisionInput(self, sample, module) -> Dict:
        """Passage-side image (multimodal docs, reference `:247-267`)."""
        option = module.get("option", "from_file")
        if option == "from_embeddings" and sample.get("passage_image_features") is not None:
            return {"image_features": np.asarray(sample["passage_image_features"], np.float32)}
        path = sample.get("passage_img_path")
        if path:
            return {"images": [read_image(path)]}
        return {"images": []}

    # ----------------------------------------------------- output parsers
    def GenerationOutput(self, sample, module) -> Dict:
        return {"text_sequence": sample.get("gold_answer", "") or ""}

    def SimilarityOutput(self, sample, module) -> Dict:
        """Positive + negative passage contents for contrastive training
        (reference `:269-280`)."""
        sep = module.get("separation_tokens", {})
        contents = [_wrap(c, sep) for c in sample.get("passage_contents", [])]
        return {"text_sequences": contents}

    # ------------------------------------------------------- dispatching
    def parse_modules(self, sample, modules, type_="input") -> Dict[str, Any]:
        """Run each module's parser and concatenate text segments
        (reference `parse_modules`, `:282-349`)."""
        out: Dict[str, Any] = {"text_sequence": "", "images": [],
                               "image_features": None, "text_sequences": None}
        parts = []
        for module in modules:
            fn = getattr(self, module["type"], None)
            if fn is None:
                raise ValueError(f"Unknown module type: {module['type']}")
            res = fn(sample, module)
            if res.get("text_sequence"):
                parts.append(res["text_sequence"])
            if res.get("images"):
                out["images"].extend(res["images"])
            if res.get("image_features") is not None:
                out["image_features"] = res["image_features"]
            if res.get("text_sequences") is not None:
                out["text_sequences"] = res["text_sequences"]
        out["text_sequence"] = " ".join(p for p in parts if p).strip()
        return out

    # --------------------------------------------------- post-processors
    def PostProcessInputTokenization(self, data, module):
        enc = self.tokenizer(
            data["text_sequences"],
            padding="max_length",
            truncation=True,
            max_length=module.get("max_length", self.config.get("max_source_length", 512)),
            return_tensors="np",
        )
        return {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }

    def PostProcessFLMRQuestionInputTokenization(self, data, module):
        """Sets query_maxlen from config then tokenizes with the FLMR query
        tokenizer ([Q] marker + [MASK] padding) — reference `:506-639`."""
        maxlen = module.get("max_length", getattr(self.tokenizer, "query_maxlen", 32))
        enc = self.tokenizer(data["text_sequences"], max_length=maxlen)
        return {
            "input_ids": enc["input_ids"],
            "attention_mask": enc["attention_mask"],
        }

    def PostProcessFLMRItemInputTokenization(self, data, module):
        enc = self.decoder_tokenizer(
            data["text_sequences"],
            max_length=module.get("max_length", None),
        )
        return {
            "input_ids": enc["input_ids"],
            "attention_mask": enc["attention_mask"],
        }

    def PostProcessVisionInputProcessing(self, data, module):
        """images → pixel_values via the image processor (reference `:922-1006`)."""
        images = data["images"]
        if not images:
            return {}
        pixel_values = self.image_processor(images)
        return {"pixel_values": pixel_values}

    def PostProcessConcatenateLabels(self, data, module):
        enc = self.decoder_tokenizer(
            data["text_sequences"],
            max_length=module.get("max_length", self.config.get("max_target_length", 32)),
        )
        return {"labels": enc["input_ids"]}

    # --- decoder/output tokenization (reference `:374-483`) ---------------
    def _plain_tokenizer(self, tok):
        """HF tokenizer behind our marker-wrapping tokenizers."""
        return getattr(tok, "tok", None) or getattr(tok, "tokenizer", None) or tok

    def PostProcessDecoderInputTokenization(self, data, module):
        """Reference `:374-396` — context sequences for a seq2seq decoder."""
        tok = self._plain_tokenizer(self.decoder_tokenizer)
        enc = tok(
            data["text_sequences"],
            padding="max_length",
            truncation=True,
            max_length=module.get(
                "max_length", self.config.get("max_decoder_source_length", 512)
            ),
            return_tensors="np",
        )
        return {
            "decoder_input_ids": enc["input_ids"].astype(np.int32),
            "decoder_input_attention_mask": enc["attention_mask"].astype(np.int32),
        }

    def PostProcessOutputTokenization(self, data, module):
        """Reference `:398-437`: teacher-forcing targets with pad→−100 label
        masking (HF loss-ignore convention)."""
        tok = self._plain_tokenizer(self.decoder_tokenizer)
        enc = tok(
            data["text_sequences"],
            padding="max_length",
            truncation=True,
            max_length=module.get(
                "max_length", self.config.get("max_target_length", 32)
            ),
            return_tensors="np",
        )
        ids = enc["input_ids"].astype(np.int32)
        pad_id = tok.pad_token_id if tok.pad_token_id is not None else 0
        labels = np.where(ids == pad_id, -100, ids).astype(np.int32)
        return {
            "labels": labels,
            "output_sequence_ids": ids,
            "output_sequence_attention_mask": enc["attention_mask"].astype(np.int32),
        }

    def PostProcessBlipOutputTokenization(self, data, module):
        """Reference `:439-483` — same as output tokenization but through the
        processor's nested tokenizer (Blip2Processor.tokenizer)."""
        return self.PostProcessOutputTokenization(data, module)

    # ColBERT-marker tokenization: our FLMR tokenizers ARE the ColBERT
    # tensorize path ([Q]/[D] markers + [MASK] padding), so these are exact
    # role equivalents (reference `:484-505,620-639`).
    def PostProcessColBERTQuestionInputTokenization(self, data, module):
        return self.PostProcessFLMRQuestionInputTokenization(data, module)

    def PostProcessColBERTItemInputTokenization(self, data, module):
        return self.PostProcessFLMRItemInputTokenization(data, module)

    LLAVA_TASK_PREFIX = (
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite answers "
        "to the human's questions. USER: "
    )

    def PostProcessLLaVAQuestionInputTokenization(self, data, module):
        """Reference `:530-618`: LLaVA conversation-template prompt plus
        image/instruction/question span masks. Tokenizer-agnostic: the
        separator and ``<image>`` token ids are derived from the tokenizer
        instead of hard-coding the LLaMA vocab (`sep_id=29901`)."""
        tok = self._plain_tokenizer(self.tokenizer)
        img_token_span = module.get("img_token_span", 1176)
        texts = [
            s.replace(".:", ":").replace("?:", ":") + " <image>\n"
            for s in data["text_sequences"]
        ]
        if "<image>" not in tok.get_vocab():
            # LLaVA tokenizers ship with <image>; adding it here grows the
            # vocab AFTER any embedding table sized from it — on TPU an
            # out-of-range gather clamps silently, so surface it loudly
            logger.warning(
                "tokenizer lacks '<image>': adding it at collate time; "
                "models initialized from the original vocab_size will "
                "mis-embed the image token — resize embeddings or use a "
                "LLaVA tokenizer")
            tok.add_tokens(["<image>"])
        enc = tok(
            [self.LLAVA_TASK_PREFIX + s for s in texts],
            padding="max_length",
            truncation=True,
            max_length=module.get(
                "max_length", self.config.get("max_source_length", 128)
            ),
            return_tensors="np",
        )
        ids = enc["input_ids"].astype(np.int32)
        sep_id = tok.convert_tokens_to_ids(":")
        img_id = tok.convert_tokens_to_ids("<image>")
        max_len = ids.shape[1]
        image_mask, instruction_mask, question_mask = [], [], []
        for row in ids:
            # seps[1]: the first ':' ends the task prefix, the second ends
            # the instruction — faithful to the reference
            # (`module_parser.py:577` torch.where(Q==sep_id)[0][1]),
            # including its known fragility when the question text itself
            # contains a standalone ':'
            seps = np.where(row == sep_id)[0]
            sep_index = int(seps[1]) if len(seps) > 1 else (int(seps[0]) if len(seps) else 0)
            imgs = np.where(row == img_id)[0]
            img_index = int(imgs[0]) if len(imgs) else max_len - 1
            # all masks cover the image-expanded sequence (the <image> token
            # position is replaced by img_token_span vision positions); the
            # reference's three masks have inconsistent lengths
            # (`module_parser.py:578-592`) — normalized here
            total = max_len + img_token_span - 1
            image_mask.append(
                [0] * img_index + [1] * img_token_span
                + [0] * (total - img_index - img_token_span)
            )
            instruction_mask.append(
                [1] * (sep_index + 1) + [0] * (total - sep_index - 1)
            )
            q_start = sep_index + 1
            q_len = max(img_index - sep_index - 1, 0)
            question_mask.append(
                [0] * q_start + [1] * q_len + [0] * (total - q_start - q_len)
            )
        return {
            "input_ids": ids,
            "attention_mask": enc["attention_mask"].astype(np.int32),
            "image_mask": np.asarray(image_mask, np.int32),
            "instruction_mask": np.asarray(instruction_mask, np.int32),
            "question_mask": np.asarray(question_mask, np.int32),
        }

    def PostProcessQWenQuestionInputTokenization(self, data, module):
        """Reference `:663-904` — QWen-VL chat-template prompts. Rebuilt
        tokenizer-agnostically: the im_start/im_end chat markers are used when
        the tokenizer defines them, else plain text."""
        tok = self._plain_tokenizer(self.tokenizer)
        system = module.get("system_message", "You are a helpful assistant.")
        has_chat = hasattr(tok, "im_start_id")
        if has_chat:
            prompts = [
                f"<|im_start|>system\n{system}<|im_end|>\n"
                f"<|im_start|>user\n{s}<|im_end|>\n<|im_start|>assistant\n"
                for s in data["text_sequences"]
            ]
        else:
            prompts = [f"{system} {s}" for s in data["text_sequences"]]
        enc = tok(
            prompts,
            padding="max_length",
            truncation=True,
            max_length=module.get(
                "max_length", self.config.get("max_source_length", 128)
            ),
            return_tensors="np",
        )
        return {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }

    def PostProcessBlip2VisionInputProcessing(self, data, module):
        """Reference `:933-948` — passage/decoder-side pixel values."""
        images = data.get("images", [])
        if not images:
            return {}
        return {"decoder_pixel_values": self.image_processor(images)}

    def PostProcessVisionInputFromEmbeddings(self, data, module):
        """Reference `:949-967` — stack precomputed image features."""
        feats = data.get("image_features")
        if feats is None:
            return {}
        return {"image_features": np.stack([np.asarray(f, np.float32) for f in feats])
                if isinstance(feats, (list, tuple)) else np.asarray(feats, np.float32)}

    def PostProcessItemVisionInputFromEmbeddings(self, data, module):
        """Reference `:969-987` — passage-side feature stack."""
        feats = data.get("image_features")
        if feats is None:
            return {}
        stacked = (
            np.stack([np.asarray(f, np.float32) for f in feats])
            if isinstance(feats, (list, tuple))
            else np.asarray(feats, np.float32)
        )
        return {"item_image_features": stacked}


def _wrap(text: str, sep: Dict) -> str:
    start = sep.get("start", "")
    end = sep.get("end", "")
    return f"{start}{text}{end}" if (start or end) else text
