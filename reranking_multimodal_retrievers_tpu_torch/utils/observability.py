"""Observability: metrics history, profiling, wandb gating, device stats.

Parity with the reference's aux subsystems (SURVEY.md §5):
- ``MetricsHistoryLogger`` — in-memory metric history
  (`runway_for_ml/utils/metrics_log_callback.py:7-51`);
- ``profile_trace`` — systematic tracing the reference lacks (it had ad-hoc
  wall-clock prints, `Reranker_base_executor.py:898,937-939`): a
  ``torch.profiler`` trace (host and CUDA activity) written as a Chrome
  trace, viewable in Perfetto;
- ``maybe_wandb`` — wandb is optional and absent offline; this returns a
  no-op recorder in that case (reference gates on ``meta.logger_enable``);
- ``device_memory_stats`` — the `cuda_stats.py` role: ``torch.cuda``'s
  memory statistics of each visible card.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class MetricsHistoryLogger:
    """In-memory metric history keyed by name (PTL-logger role)."""

    def __init__(self):
        self.history: Dict[str, List] = defaultdict(list)

    def log_metrics(self, metrics: Dict, step: Optional[int] = None):
        for k, v in metrics.items():
            self.history[k].append((step, v))

    def series(self, name: str):
        return self.history.get(name, [])

    def latest(self, name: str):
        s = self.series(name)
        return s[-1][1] if s else None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None, label: str = "trace"):
    """Profile a region: a torch.profiler trace (CPU, and CUDA when a card
    is visible) written to ``<log_dir>/<label>.json`` when a log_dir is
    given; always wall-clock timing."""
    t0 = time.perf_counter()
    if log_dir:
        import os

        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{label}.json"))
    else:
        yield
    logger.info("%s took %.3fs", label, time.perf_counter() - t0)


class _NoOpRun:
    def log(self, *a, **k):
        pass

    def finish(self):
        pass


def maybe_wandb(config) -> object:
    """Return a live wandb run when enabled+installed, else a no-op."""
    enabled = "wandb" in (config.get_path("meta.logger_enable", []) or [])
    if not enabled:
        return _NoOpRun()
    try:
        import wandb

        name = config.get_path("meta.experiment_name", "run")
        # Store experiment_name at the top level of the run config: it is the
        # key manage_wandb_runs filters on (reference runway_for_ml
        # experiment.py:100-129 does the same).
        stored = dict(config.to_dict(), experiment_name=name)
        kwargs = dict(
            project=config.get_path("meta.WANDB.project", "rmr-tpu"),
            name=name,
            config=stored,
        )
        # Honor the resume id manage_wandb_runs planted in meta.WANDB.
        for key in ("entity", "id", "resume", "tags"):
            val = config.get_path(f"meta.WANDB.{key}", None)
            if val:
                kwargs[key] = val
        return wandb.init(**kwargs)
    except Exception as e:
        logger.warning("wandb unavailable (%s); metrics go to jsonl only", e)
        return _NoOpRun()


def manage_wandb_runs(config, mode: str = "train", reset: bool = False):
    """Run lifecycle via the wandb API (reference
    `runway_for_ml/experiment.py:100-129,368-377`): find prior runs for this
    experiment name; on train+reset delete them, otherwise resume the latest
    (id + resume='must'). Mutates ``meta.WANDB`` in place like the reference.
    No-ops quietly when wandb or the network is unavailable."""
    if "wandb" not in (config.get_path("meta.logger_enable", []) or []):
        return None
    try:
        import wandb

        wconf = config.get_path("meta.WANDB", None)
        if wconf is None:
            return None
        entity = wconf.get("entity", "")
        project = wconf.get("project", "rmr-tpu")
        runs = wandb.Api(timeout=19).runs(
            path=f"{entity}/{project}",
            filters={"config.experiment_name": config.get_path("meta.experiment_name")},
        )
        if len(runs) > 0 and mode == "train" and reset:
            for run in runs:
                run.delete()
            logger.info("deleted %d prior wandb runs", len(runs))
        elif len(runs) > 0:
            wconf["id"] = runs[0].id
            wconf["resume"] = "must"
            logger.info("resuming wandb run %s", runs[0].id)
        return wconf
    except Exception as e:
        logger.warning("wandb run management unavailable (%s)", e)
        return None


def log_prediction_table(run, batch_results, Ks, prefix: str = "test",
                         max_rows: int = 200):
    """Rich prediction table (reference `FLMR_base_executor.py:1043-1083`):
    one row per question with image path, positive ids, and the top-K passage
    contents. No-op on the offline recorder."""
    if isinstance(run, _NoOpRun) or run is None:
        return
    try:
        import wandb

        k = max(Ks) if Ks else 5
        columns = ["question_id", "input_image", "pos_item_ids"] + [
            f"p_{i}" for i in range(k)
        ]
        table = wandb.Table(columns=columns)
        for re_ in batch_results[:max_rows]:
            row = [
                str(re_.get("question_id")),
                str(re_.get("img_path", "")),
                str(re_.get("pos_item_ids", [])),
            ]
            tops = re_.get("top_ranking_passages", [])
            row += [
                (tops[i]["content"] if i < len(tops) else "") for i in range(k)
            ]
            table.add_data(*row)
        run.log({f"{prefix}/prediction_table": table})
    except Exception as e:
        logger.warning("prediction table not logged (%s)", e)


def device_memory_stats() -> Dict[str, float]:
    """Per-card memory in GB (the `cuda_stats.py` role): bytes allocated by
    tensors, their peak, and the card's total; empty without a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": torch.cuda.memory_allocated(i) / 1e9,
            "peak_bytes_in_use_gb": torch.cuda.max_memory_allocated(i) / 1e9,
            "bytes_limit_gb": torch.cuda.get_device_properties(i).total_memory / 1e9,
        }
    return out
