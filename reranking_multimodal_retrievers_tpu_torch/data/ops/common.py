"""Common terminal transforms: dataloader preparation.

Parity with `src/data_ops/common_data_opts.py:66-324`.
"""

from __future__ import annotations

import logging
import os

from ...utils.config_system import ConfigDict
from ...utils.registries import register_transform_functor
from ..transforms import BaseTransform
from ..image_io import CLIPImageProcessor
from ..loaders import DataLoader
from .. import datasets as dataset_classes

logger = logging.getLogger(__name__)


def build_tokenizer(tk_config, use_dummy_data=False):
    """Instantiate a tokenizer from config (reference `:87-136`).

    ``TokenizerClass``: FLMRQueryTokenizer | FLMRContextTokenizer |
    BertTokenizerFast (here the port's pure-Python WordPiece tokenizer,
    ``models/tokenization.py::WordPieceTokenizer``, which gives the same ids).
    ``TokenizerModelVersion``: a local path with vocab.txt (no hub); when
    absent/dummy a tiny offline test vocab is built so pipelines run
    end-to-end.
    """
    from ...models import tokenization as tok

    cls = tk_config.get("TokenizerClass", "FLMRQueryTokenizer")
    version = tk_config.get("TokenizerModelVersion")
    if use_dummy_data and version:
        # match the generator-side redirect (synthetic vocabs live under
        # cache/dummy/ in dummy mode so they never clobber real artifacts)
        from ..cache_system import dummy_scoped_path

        scoped = dummy_scoped_path(version)
        if os.path.exists(scoped) or not os.path.exists(version):
            version = scoped
        else:
            # Stale dummy dataset cache can skip the generator so the
            # dummy-scoped side artifact was never written; falling back to
            # the REAL vocab gives dummy runs inconsistent token ids across
            # cache states — say so loudly.
            logger.warning(
                "dummy mode: dummy-scoped vocab %s missing, falling back to "
                "REAL vocab %s (delete cache/dummy to regenerate)",
                scoped, version,
            )
        logger.info("dummy mode tokenizer vocab: %s", version)
    kwargs = {
        k: v
        for k, v in tk_config.items()
        if k in ("query_maxlen", "doc_maxlen", "attend_to_mask_tokens")
    }
    if version and os.path.exists(version):
        base = tok.WordPieceTokenizer.from_pretrained(version)
    else:
        if version:
            logger.warning(
                "Tokenizer version %s not found locally; using offline test vocab",
                version,
            )
        import tempfile

        base = tok.tiny_wordpiece_tokenizer(tempfile.mkdtemp())
    special = tk_config.get("SPECIAL_TOKENS")
    if special:
        base.add_special_tokens(dict(special))
    if cls == "FLMRQueryTokenizer":
        return tok.FLMRQueryTokenizer(base, **kwargs)
    if cls == "FLMRContextTokenizer":
        return tok.FLMRContextTokenizer(base, **kwargs)
    return base


@register_transform_functor
class PrepareDataloaders(BaseTransform):
    """Terminal node every experiment consumes (reference `:66-301`):
    instantiates tokenizers + image processors, wraps each configured split
    in its dataset class, and yields per-split loaders keyed
    ``"{mode}/{DatasetType}.{split}"``."""

    def setup(
        self,
        datasets_config,
        tokenizer_config,
        extra_columns=None,
        pass_columns=None,
        image_processor_config=None,
        feature_extractor_config=None,
        **kwargs,
    ):
        self.datasets_config = datasets_config
        self.tokenizer_config = tokenizer_config or {}
        self.image_processor_config = image_processor_config or {}
        self.extra_columns = extra_columns or []
        self.pass_columns = pass_columns or {}
        return self

    def _call(self, inputs):
        input_data = ConfigDict()
        if isinstance(inputs, list):
            for i in inputs:
                input_data.update(i)
        elif inputs is not None:
            input_data = ConfigDict(inputs)

        tokenizers = {
            name: build_tokenizer(cfg, self.use_dummy_data)
            for name, cfg in self.tokenizer_config.items()
        }
        image_processors = {
            name: CLIPImageProcessor(cfg.get("image_size", 224))
            for name, cfg in self.image_processor_config.items()
        } or {"vit_image_processor": CLIPImageProcessor()}

        gc = self.global_config or ConfigDict()
        run_mode = gc.get("mode", "train")
        prepared = ConfigDict()
        for mode, entries in self.datasets_config.items():
            prepared.setdefault(mode, {})
            # train mode builds train/valid loaders; test mode builds test
            # loaders only (reference `:201-208`)
            if run_mode in ("train", "prepare_data") and mode not in ("train", "valid"):
                continue
            if run_mode not in ("train", "prepare_data") and mode != "test":
                continue
            for data_config in entries:
                dc = dict(data_config)
                use_column = dc.pop("use_column")
                use_split = dc.pop("split")
                dataset_type = dc.pop("dataset_type")
                table = input_data[use_column][use_split]

                ds_cls = getattr(dataset_classes, dataset_type)
                ds_kwargs = dict(
                    config=gc,
                    dataset=table,
                    modules_config=dc.pop("modules_config", gc.get("modules_config", {})),
                    tokenizer=tokenizers.get("tokenizer"),
                    decoder_tokenizer=tokenizers.get("decoder_tokenizer"),
                    image_processor=list(image_processors.values())[0],
                    mode=mode,
                )
                if issubclass(ds_cls, dataset_classes.CommonDatasetForDPR):
                    passages = dc.pop("passages_column", "passages")
                    ds_kwargs["passages"] = input_data.get(passages) or _passages_from(
                        input_data, use_column
                    )
                    ds_kwargs["num_negative_samples"] = dc.pop(
                        "num_negative_samples",
                        gc.get_path("model_config.num_negative_samples", 1)
                        if hasattr(gc, "get_path") else 1,
                    )
                    ds_kwargs["use_self_negatives"] = (
                        "use_self_negatives"
                        in (gc.get_path("model_config.modules", [])
                            if hasattr(gc, "get_path") else [])
                    )
                ds_kwargs.update(dc)
                dataset = ds_cls(**ds_kwargs)

                mode_cfg = gc.get(mode, {})
                loader = DataLoader(
                    dataset,
                    batch_size=mode_cfg.get("batch_size", 2),
                    shuffle=(mode == "train"),
                    drop_last=(mode == "train"),
                    pad_last=(mode != "train"),
                    seed=gc.get_path("meta.seed", 42) if hasattr(gc, "get_path") else 42,
                )
                key = f"{mode}/{dataset_type}.{use_split}"
                prepared[mode][key] = loader
                logger.info("[Data Statistics]: %s loader: %s (%d batches)",
                            mode, key, len(loader))

        out = ConfigDict(
            data_loaders=prepared,
            tokenizers=tokenizers,
            image_processors=image_processors,
        )
        for extra_column, from_column in dict(self.pass_columns).items():
            out[extra_column] = input_data.get(from_column)
        return out


def _passages_from(input_data, use_column):
    """Build {'id2doc', 'id2source'} from a '{split}_passages' table when
    present (`id2source` feeds use_self_negatives and
    validation_indexing_source)."""
    col = input_data.get(use_column, {})
    id2doc = {}
    id2source = {}
    id2feat = {}
    for split_name, table in (col.items() if hasattr(col, "items") else []):
        if split_name.endswith("_passages"):
            for row in table:
                id2doc[row["passage_id"]] = row["passage_content"]
                if "source_name" in row:
                    id2source[row["passage_id"]] = row["source_name"]
                if "image_features" in row:
                    # per-passage precomputed vision features — feeds the
                    # 'multimodal_docs' indexing path
                    id2feat[row["passage_id"]] = row["image_features"]
    out = {"id2doc": id2doc, "id2source": id2source}
    if id2feat:
        out["id2doc_image_features"] = id2feat
    return out


@register_transform_functor
class WrapOutputIntoKeys(BaseTransform):
    """Wrap upstream outputs under declared keys (reference `:306-324`)."""

    def setup(self, output_keys, **kwargs):
        self.output_keys = output_keys
        return self

    def _call(self, inputs):
        if not isinstance(inputs, list):
            inputs = [inputs]
        return ConfigDict({k: v for k, v in zip(self.output_keys, inputs)})
