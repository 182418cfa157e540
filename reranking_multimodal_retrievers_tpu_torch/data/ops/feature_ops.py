"""Image-feature pre-extraction (port of the JAX package's
``data/ops/feature_ops.py``).

Reference `src/data_ops/vqa_data_ops.py:946-1761`
(``ExtractImageFeaturesWithViT{,v2,v3}``, ``ProcessImageWithViTProcessor``):
the reference runs a torch ViT over all images inside the data pipeline and
caches the CLS features so training can use ``image_features`` instead of raw
pixels. Here the same nodes run the port's ``CLIPVisionModel`` (and a small
convolutional VAE encoder) in fixed-size batches on the device
``device.py::platform_device`` gives: the CUDA card, or the CPU under
``RMRT_PLATFORM=cpu``. Images are read by ``data/image_io.py`` (PNG and
baseline JPEG without PIL).

Without a checkpoint the JAX nodes draw their weights from
``jax.random.PRNGKey(0)``, which the port cannot reproduce: the port draws
them from a ``torch.Generator`` seeded 0 on the node's device (so features
agree with the JAX package's only with the weights carried across:
``models/weights.py::clip_vision_state_dict`` / ``vae_encoder_state_dict``).
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch
from torch import nn

from ...device import platform_device
from ...utils.registries import register_transform_functor
from ..image_io import CLIPImageProcessor, read_image
from ..table import Table
from ..transforms import HFDatasetTransform

logger = logging.getLogger(__name__)


def _read_or_blank(path, size: int) -> np.ndarray:
    """The image at ``path``, or a black ``size x size`` one when the path
    is empty or missing (the JAX nodes' ``Image.new("RGB", ...)``)."""
    if path and os.path.exists(path):
        return read_image(path)
    return np.zeros((size, size, 3), np.uint8)


def _in_batches(encode, pix: np.ndarray, bs: int) -> np.ndarray:
    """``encode`` over fixed ``bs``-row batches, the last padded with copies
    of its last row (the JAX nodes' static shapes)."""
    feats = []
    for i in range(0, len(pix), bs):
        chunk = pix[i:i + bs]
        real = len(chunk)
        if real < bs:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - real, 0)])
        feats.append(encode(chunk)[:real])
    return np.concatenate(feats)


@register_transform_functor
class ProcessImageWithViTProcessor(HFDatasetTransform):
    """Attach preprocessed pixel arrays (reference `:1763-1813`)."""

    def setup(self, image_size: int = 224, **kwargs):
        self.processor = CLIPImageProcessor(image_size)
        return self

    def _call(self, data):
        proc = self.processor

        def process(example):
            if example.get("img_path") and os.path.exists(example["img_path"]):
                example["pixel_values"] = proc([read_image(example["img_path"])])[0]
            return example

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            data[split] = data[split].map(process)
        return data


@register_transform_functor
class ExtractImageFeaturesWithViT(HFDatasetTransform):
    """Run a (random-init or HF-checkpoint) CLIP-ViT over all images and
    store CLS features in ``image_features`` (reference `:946-1621`, three
    versions — this one covers their shared contract with a fixed-batch
    loop on the device)."""

    def setup(self, vision_config=None, checkpoint_dir=None, batch_size: int = 16,
              image_size: int = 224, **kwargs):
        self.vision_config = vision_config or {}
        self.checkpoint_dir = checkpoint_dir
        self.batch_size = batch_size
        self.image_size = image_size
        return self

    def _build_encoder(self):
        """Build (once) the CLS-feature encoder: ``(encode, processor,
        config)``; the model is ``self._model``."""
        if getattr(self, "_encoder", None) is not None:
            return self._encoder
        from ...models.checkpoint_dir import load_checkpoint_dir, load_into
        from ...models.vit import CLIPVisionConfig, CLIPVisionModel

        cfg = (CLIPVisionConfig(**self.vision_config) if self.vision_config
               else CLIPVisionConfig.tiny())
        dev = platform_device()
        model = CLIPVisionModel(cfg, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0)).eval()
        if self.checkpoint_dir:
            # HF CLIPVisionModel names, with or without the outer prefix
            sd = load_checkpoint_dir(self.checkpoint_dir)
            load_into(model, {(k if k.startswith("vision_model.") else f"vision_model.{k}"): v
                              for k, v in sd.items()})
        self._model = model

        def encode(pix: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                x = torch.as_tensor(pix, device=dev)
                return model(x)["last_hidden_state"][:, 0].float().cpu().numpy()

        self._encoder = (encode, CLIPImageProcessor(cfg.image_size), cfg)
        return self._encoder

    def _encode_batch(self, examples):
        """``examples['img_path']`` -> ``examples['image_features']`` in
        fixed-size padded batches."""
        encode, proc, cfg = self._build_encoder()
        pix = proc([_read_or_blank(p, cfg.image_size) for p in examples["img_path"]])
        examples["image_features"] = _in_batches(encode, pix, self.batch_size).tolist()
        return examples

    def _call(self, data):
        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            if "img_path" in data[split].column_names:
                data[split] = data[split].map(self._encode_batch, batched=True, batch_size=64)
        return data


@register_transform_functor
class ExtractImageFeaturesWithViTv2(ExtractImageFeaturesWithViT):
    """v1 + a persistent embedding cache (reference `:1112-1311` keeps an
    ``embedding_cache`` folder so interrupted extraction passes resume):
    features already in the :class:`FeatureStore` are read back; only the
    missing images are encoded, and every fresh embedding is published to the
    store keyed by ``image_id``."""

    def setup(self, cache_folder="./embedding_cache", index_name="vit_features",
              **kwargs):
        from ..feature_store import FeatureStore

        self.store = FeatureStore(cache_folder, index_name=index_name)
        return super().setup(**kwargs)

    def _call(self, data):
        store = self.store
        fresh = {}

        def restore(examples):
            key_col = "image_id" if "image_id" in examples else "question_id"
            missing_idx, missing_paths, ids = [], [], examples[key_col]
            feats = [None] * len(examples["img_path"])
            for i, key in enumerate(ids):
                cached = store.get(str(key))
                if cached is not None:
                    feats[i] = cached.tolist()
                else:
                    missing_idx.append(i)
                    missing_paths.append(examples["img_path"][i])
            if missing_idx:
                sub = self._encode_batch({"img_path": missing_paths})
                for j, i in enumerate(missing_idx):
                    feats[i] = sub["image_features"][j]
                    store.put(str(ids[i]), np.asarray(feats[i], np.float32))
                    fresh[str(ids[i])] = True
            examples["image_features"] = feats
            return examples

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            if "img_path" in data[split].column_names:
                data[split] = data[split].map(restore, batched=True, batch_size=64)
        logger.info("ViTv2: %d embeddings computed fresh, rest cache hits", len(fresh))
        return data


@register_transform_functor
class ExtractImageFeaturesWithViTv3(ExtractImageFeaturesWithViT):
    """v3 publishes the features as a standalone lookup corpus (reference
    `:1313-1621` "saves tensors to ES"): every image is encoded (resuming
    from the store like v2) and the output carries an
    ``image_dataset_with_embeddings`` table keyed by ``image_id`` — the shape
    the ``ConcatenateImageCorpus`` / multimodal-docs nodes consume."""

    def setup(self, cache_folder="./embedding_cache",
              index_name="encoded_image_features", **kwargs):
        from ..feature_store import FeatureStore

        self.store = FeatureStore(cache_folder, index_name=index_name)
        return super().setup(**kwargs)

    def _call(self, data):
        data = ExtractImageFeaturesWithViTv2._call(self, data)
        ids, feats, seen = [], [], set()
        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            cols = data[split].column_names
            if "image_features" not in cols:
                continue
            key_col = "image_id" if "image_id" in cols else "question_id"
            for key, feat in zip(data[split][key_col], data[split]["image_features"]):
                if key not in seen:
                    seen.add(key)
                    ids.append(key)
                    feats.append(feat)
        data["image_dataset_with_embeddings"] = Table.from_dict(
            {"image_id": ids, "image_features": feats})
        return data


def _same_pad(size: int, kernel: int = 3, stride: int = 2):
    """flax ``padding="SAME"``: (before, after) of one dimension; 0 before
    and 1 after at an even size with stride 2, where ``Conv2d(padding=1)``
    would pad one on each side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class VAEEncoder(nn.Module):
    """Minimal convolutional VAE encoder (stride-2 3x3 conv stack 16/32/64
    with tanh-GELU, flatten in NHWC order, dense mean/logvar heads), the
    JAX package's flax ``_VAEEncoder`` (`:217-245`). Stands in for the
    reference's pretrained VAE (`vqa_data_ops.py:1622-1761`); the latent
    *mean* is the stored feature. Weights drawn from ``generator``
    (lecun-normal kernels, zero biases, as flax initialises them, from
    another generator)."""

    FEATURES = (16, 32, 64)

    def __init__(self, latent_dim: int, image_size: int, *, device, generator=None):
        super().__init__()
        self.image_size = image_size
        convs, c_in, size = [], 3, image_size
        for feat in self.FEATURES:
            convs.append(nn.Conv2d(c_in, feat, 3, stride=2, padding=0, device=device))
            c_in, size = feat, -(-size // 2)
        self.convs = nn.ModuleList(convs)
        self.mean = nn.Linear(c_in * size * size, latent_dim, device=device)
        self.logvar = nn.Linear(c_in * size * size, latent_dim, device=device)
        with torch.no_grad():
            for m in [*self.convs, self.mean, self.logvar]:
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
                m.bias.zero_()

    def forward(self, x):  # x: [B, 3, H, W]
        for conv in self.convs:
            ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = torch.nn.functional.gelu(conv(torch.nn.functional.pad(x, (*pw, *ph))),
                                         approximate="tanh")
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        return self.mean(x), self.logvar(x)


@register_transform_functor
class ExtractImageFeaturesWithVAE(HFDatasetTransform):
    """VAE latent features (reference `vqa_data_ops.py:1622-1761`): encode
    each image to a compact latent and store the posterior mean in
    ``vae_features``, in fixed-size batches on the device. Weights from a
    ``torch.Generator`` seeded 0 (the JAX node's from ``PRNGKey(0)``)."""

    def setup(self, latent_dim: int = 64, image_size: int = 64,
              batch_size: int = 16, **kwargs):
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.batch_size = batch_size
        return self

    def _build_encoder(self) -> VAEEncoder:
        if getattr(self, "_model", None) is None:
            dev = platform_device()
            self._model = VAEEncoder(self.latent_dim, self.image_size, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(0)).eval()
        return self._model

    def _call(self, data):
        model = self._build_encoder()
        dev = next(model.parameters()).device
        proc = CLIPImageProcessor(self.image_size)

        def encode(pix: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                return model(torch.as_tensor(pix, device=dev))[0].float().cpu().numpy()

        def add_features(examples):
            pix = proc([_read_or_blank(p, self.image_size) for p in examples["img_path"]])
            examples["vae_features"] = _in_batches(encode, pix, self.batch_size).tolist()
            return examples

        for split in [s for s in data.keys() if not s.endswith("_passages")]:
            if "img_path" in data[split].column_names:
                data[split] = data[split].map(add_features, batched=True, batch_size=64)
        return data
