"""Executor base: config-driven train/eval engine (port of
``executors/base.py``).

The replacement for the reference's PyTorch-Lightning executor stack
(`runway_for_ml/executors/base_executor.py:27-372`): one process, one
device, explicit loops. Responsibilities kept at parity with the JAX
package — data-pipeline construction from ``use_data_node``,
optimizer/scheduler factory from ``train.optimizer_config``, dataloader
plumbing, EvalRecorder lifecycle, checkpoint save/restore (``torch.save``,
the same ``index.json``). An executor runs on ``device`` (CUDA unless the
caller asks for the CPU); several devices (a mesh) are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

import torch

from ..data.pipeline import DataPipeline
from ..device import DeviceLike, resolve_device
from ..metrics import EvalRecorder, MetricsProcessor
from ..training.checkpointing import CheckpointManager
from ..training.optimization import make_optimizer
from ..utils.config_system import ConfigDict
from ..utils.seed import set_seed

MULTI_DEVICE_TODO = ("several devices (a mesh) are not ported yet: ROADMAP.md, "
                     "queue A item 4")

logger = logging.getLogger(__name__)


class BaseExecutor(MetricsProcessor):
    def __init__(self, config: ConfigDict, use_dummy_data: bool = False, mesh=None,
                 device: DeviceLike = "cuda"):
        if mesh is not None:
            raise NotImplementedError(MULTI_DEVICE_TODO)
        self.config = config
        self.use_dummy_data = use_dummy_data
        self.mesh = None
        self.device = resolve_device(device)
        self.global_step = 0
        # model weights are drawn on the CPU from this generator, then moved
        # to the device: the same seed gives the same weights on any device
        self.generator = set_seed(config.get_path("meta.seed", 42) or 42)

        self.experiment_dir = config.get_path("meta.experiment_dir", "experiments/default")
        os.makedirs(self.experiment_dir, exist_ok=True)
        self.ckpt_manager = CheckpointManager(
            os.path.join(self.experiment_dir, "ckpts"),
            monitor=config.get_path("train.monitor"),
            mode=config.get_path("train.monitor_mode", "max"),
            save_top_k=config.get_path("train.save_top_k", 1),
        )
        self.metrics_history: list = []

        self._build_data()
        self._init_model()

    # ------------------------------------------------------------- data
    def _build_data(self):
        dp_config = self.config.data_pipeline
        self.data_pipeline = DataPipeline(
            dp_config,
            use_dummy_data=self.use_dummy_data,
            global_config=self.config,
        )
        node = self.config.get_path("executor.use_data_node", "output:PrepareDataloaders")
        self.prepared_data = self.data_pipeline.get_data([node], explode=True)
        self.data_loaders = self.prepared_data["data_loaders"]
        self.tokenizers = self.prepared_data.get("tokenizers", {})

    def device_generator(self) -> torch.Generator:
        """A generator on the executor's device seeded with ``meta.seed``,
        for a model drawn where it runs: the decoder rerankers and the RAG
        generators, billions of weights that a serial host draw makes slowly
        (their weights then depend on the device)."""
        seed = self.config.get_path("meta.seed", 42) or 42
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_dataloader(self):
        loaders = self.data_loaders.get("train", {})
        return next(iter(loaders.values())) if loaders else None

    def eval_dataloaders(self, mode: str):
        return self.data_loaders.get(mode, {})

    # ------------------------------------------------------------ model
    def _init_model(self):
        raise NotImplementedError

    def training_step(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def evaluate(self, mode: str = "test") -> ConfigDict:
        raise NotImplementedError

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Numpy arrays of a batch as tensors on the executor's device."""
        return {k: (torch.as_tensor(v).to(self.device) if isinstance(v, np.ndarray) else v)
                for k, v in batch.items()}

    # --------------------------------------------------------- optimizer
    def build_optimizer(self, model, num_training_steps: int):
        """``(optimizer, lr_scheduler, labels)`` over ``model``'s parameters
        from ``train.optimizer_config``."""
        oc = self.config.get_path("train.optimizer_config", ConfigDict())
        op = oc.get("optimizer_params", {})
        return make_optimizer(
            model,
            optimizer_name=oc.get("optimizer_name", "AdamW"),
            lr=op.get("lr", 1e-3),
            mapping_network_lr=oc.get("mapping_network_lr"),
            scheduler=oc.get("scheduler"),
            num_warmup_steps=oc.get("scheduler_params", {}).get("num_warmup_steps", 0),
            num_training_steps=num_training_steps,
            weight_decay=op.get("weight_decay", 0.0),
            group_patterns=tuple(
                self.config.get_path("model_config.mapping_group_patterns",
                                     ["late_interaction_adapter"])
            ),
            frozen_patterns=tuple(self.frozen_patterns()),
            grad_clip=op.get("gradient_clipping"),
        )

    def frozen_patterns(self):
        """Vision encoders frozen by default (reference
        `FLMR_base_executor.py:185-189`); extended via model_config.modules.
        ``vision_model`` covers the BLIP-2 tower (`models/blip2.py:252`),
        whose module name differs from the FLMR/CLIP ``vision_encoder``."""
        modules = self.config.get_path("model_config.modules", []) or []
        patterns = []
        if "freeze_vision_encoders" in modules or not modules:
            patterns.append("vision_encoder")
        if "freeze_reranker_vision_encoder" in modules:
            patterns.extend(["vision_encoder", "vision_model"])
        return patterns

    # -------------------------------------------------------------- train
    def train(self):
        tc = self.config.get_path("train", ConfigDict())
        trainer = tc.get("trainer_paras", {})
        max_epochs = trainer.get("max_epochs", 1)
        limit_train_batches = trainer.get("limit_train_batches")
        val_interval_epochs = trainer.get("check_val_every_n_epoch", 1)
        log_interval = trainer.get("log_every_n_steps", 10)
        save_interval = tc.get("save_interval")

        loader = self.train_dataloader()
        assert loader is not None, "no train dataloader configured"
        steps_per_epoch = limit_train_batches or len(loader)

        # resume: explicit path, or the last checkpoint when train.resume is
        # set (reference: ckpt_path to Trainer.fit + optimizer-state reload,
        # `experiment.py:351-353` / `FLMR_base_executor.py:354-359`)
        resume_path = tc.get("load_model_path") or (
            self.ckpt_manager.resolve() if tc.get("resume") else None
        )
        if resume_path and os.path.exists(str(resume_path)):
            logger.info("resuming training from %s", resume_path)
            self.load_checkpoint(str(resume_path))

        self.prepare_training(steps_per_epoch * max_epochs)

        for epoch in range(max_epochs):
            loader.set_epoch(epoch)
            t0 = time.time()
            for i, batch in enumerate(loader):
                if limit_train_batches and i >= limit_train_batches:
                    break
                metrics = self.training_step(batch)
                self.global_step += 1
                if self.global_step % log_interval == 0:
                    self.log_metrics({"epoch": epoch, **metrics})
                if save_interval and self.global_step % save_interval == 0:
                    self.save_checkpoint()
            logger.info(
                "epoch %d done in %.1fs (step=%d)", epoch, time.time() - t0,
                self.global_step,
            )
            limit_val = self.config.get_path("valid.trainer_paras.limit_val_batches")
            if limit_val == 0:  # validation disabled (Lightning semantics)
                self.save_checkpoint()
                continue
            if (epoch + 1) % val_interval_epochs == 0 and self.data_loaders.get("valid"):
                self.on_eval_start("valid")
                val_metrics = self.evaluate("valid")
                self.on_eval_end("valid", val_metrics)
                self.log_metrics({f"valid/{k}": v for k, v in val_metrics.metrics.items()})
                self.save_checkpoint(val_metrics.metrics)
        # ALWAYS leave a final checkpoint (Lightning save_last role). Without
        # this, a run whose validation interval never fired (max_epochs <
        # check_val_every_n_epoch) ended with no checkpoint at all and test
        # mode silently evaluated random weights.
        self.save_checkpoint()
        return self.metrics_history

    def prepare_training(self, total_steps: int):
        """Hook: build train step/optimizer once steps are known."""

    def test(self):
        load_path = self.config.get_path("test.load_model_path") or None
        ckpt = self.ckpt_manager.resolve(load_path)
        if ckpt:
            self.load_checkpoint(ckpt)
        self.on_eval_start("test")
        results = self.evaluate("test")
        self.on_eval_end("test", results)
        self.logging_results(results, prefix="test")
        return results

    # --------------------------------------------- EvalRecorder lifecycle
    def on_eval_start(self, mode: str):
        """Open a fresh EvalRecorder for this eval pass (reference
        `base_executor.py:335-357`: ``validation-{cnt}-{step}`` per valid
        run, ``test-evaluation`` for tests)."""
        if mode == "valid":
            self.valid_cnt = getattr(self, "valid_cnt", 0) + 1
            name = f"validation-{self.valid_cnt}-{self.global_step}"
        else:
            name = f"{mode}-evaluation"
        self.eval_recorder = EvalRecorder(name=name, base_dir=self.experiment_dir)
        self.eval_recorder.meta.update({"mode": mode, "global_step": self.global_step})
        return self.eval_recorder

    def record_sample(self, sample: Dict[str, Any]):
        """Per-sample hook executors call during evaluate(); rows land in the
        live recorder and flow into the configured eval pipeline."""
        if getattr(self, "eval_recorder", None) is not None:
            self.eval_recorder.log_sample_dict(sample)

    def on_eval_end(self, mode: str, results: Optional[ConfigDict] = None):
        """Save the recorder and run the configured eval pipeline over it
        (reference `base_executor.py:341-352`: save json → reset pipeline →
        ``get_data(out_ops, input_data_dict={'input:GetEvaluationRecorder':
        recorder})`` → rename + save the post-pipeline recorder)."""
        rec = getattr(self, "eval_recorder", None)
        if rec is None:
            return None
        # executors that did not log per-sample rows: populate the recorder
        # from the evaluation results so the pipeline always has data
        if len(rec) == 0 and results is not None:
            for row in results.get("batch_retrieval_result", []) or []:
                rec.log_sample_dict(dict(row))
        if results is not None and results.get("metrics"):
            rec.log_stats_dict({k: _to_float(v)
                                for k, v in results.metrics.items()})
        rec.save_to_disk(file_format="json")
        rec_name = rec.name

        ep_cfg = (self.config.get_path(f"{mode}.eval_pipeline")
                  or self.config.get_path("eval_pipeline"))
        if not ep_cfg:
            return rec
        # a fresh pipeline per eval pass — its in-memory cache starts empty,
        # so every pass re-runs all transforms (the reference resets a
        # long-lived pipeline to get the same effect, `base_executor.py:344`)
        pipeline = DataPipeline(
            ep_cfg, use_dummy_data=self.use_dummy_data,
            global_config=self.config,
        )
        out_ops = list(ep_cfg.get("out_ops", []) or [
            n for n in ep_cfg.get("transforms", {}) if n.startswith("output:")
        ])
        out = pipeline.get_data(
            out_ops, explode=(len(out_ops) == 1),
            input_data_dict={"input:GetEvaluationRecorder": rec},
        )
        if isinstance(out, EvalRecorder):
            out.rename(f"{rec_name}-after_eval_pipeline")
            out.save_to_disk(file_format="json")
        return out

    # ----------------------------------------------------- logging/ckpt
    def log_metrics(self, metrics: Dict[str, Any]):
        entry = {"step": self.global_step, **{k: _to_float(v) for k, v in metrics.items()}}
        self.metrics_history.append(entry)
        logger.info("metrics %s", entry)
        path = os.path.join(self.experiment_dir, "metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def save_checkpoint(self, metrics: Optional[Dict[str, float]] = None):
        # a metric-less save at a step that already has a checkpoint (e.g.
        # the unconditional final save right after the last epoch's
        # validation save) would rewrite the same step_N dir and append a
        # duplicate empty-metrics index entry — skip it. A metrics-carrying
        # save still goes through (it upgrades the entry's bookkeeping).
        if metrics is None and getattr(self, "_last_saved_step", None) == self.global_step:
            return
        state = self.state_to_save()
        if state is not None:
            self.ckpt_manager.save(state, self.global_step, metrics=_floats(metrics))
            self._last_saved_step = self.global_step

    def state_to_save(self):
        return None

    def load_checkpoint(self, path: str):
        raise NotImplementedError

    def logging_results(self, results: ConfigDict, prefix: str = "test"):
        """Write predictions + metrics (reference
        `FLMR_base_executor.py:1108-1168` writes
        ``{prefix}_predictions_rank_{rank}.json``; one process has rank 0)."""
        out = {
            "metrics": {k: _to_float(v) for k, v in results.metrics.items()},
            "predictions": results.get("batch_retrieval_result", []),
        }
        path = os.path.join(self.experiment_dir, f"{prefix}_predictions_rank_0.json")
        with open(path, "w") as f:
            json.dump(out, f, default=_to_float)
        logger.info("wrote %s", path)
        self.log_metrics({f"{prefix}/{k}": v for k, v in results.metrics.items()})
        # rich wandb prediction table (reference `FLMR_base_executor.py:1043-1083`)
        from ..utils.observability import maybe_wandb, log_prediction_table

        if not hasattr(self, "_wandb_run"):
            self._wandb_run = maybe_wandb(self.config)
        run = self._wandb_run
        log_prediction_table(
            run, out["predictions"],
            self.config.get_path("model_config.Ks", [5]), prefix=prefix,
        )
        run.log({f"{prefix}/{k}": _to_float(v) for k, v in results.metrics.items()})
        return path


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _floats(metrics):
    if not metrics:
        return {}
    return {k: _to_float(v) for k, v in metrics.items() if isinstance(_to_float(v), float)}
