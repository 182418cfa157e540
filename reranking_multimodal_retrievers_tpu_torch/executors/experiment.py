"""Experiment / run management (port of ``executors/experiment.py``).

Parity with the reference ``RunwayExperiment``
(`runway_for_ml/experiment.py:77-514`): versioned experiment directories,
config snapshots, logger setup (jsonl metrics history standing in for
csv/tensorboard/wandb — wandb is gated on availability), train/test/eval
dispatch through the executor registry, and checkpoint resolution delegated
to the executor's :class:`CheckpointManager`. The executor runs on
``device`` (CUDA unless the caller asks for the CPU), or on the rank's device
of ``mesh``; over a mesh rank 0 picks the experiment directory, wipes it on
``reset`` and writes the run log and config snapshot.
"""

from __future__ import annotations

import json
import logging
import os

from ..device import DeviceLike, resolve_device
from ..utils.config_system import ConfigDict
from ..utils.registries import Executor_Registry

logger = logging.getLogger(__name__)


def _next_version(base: str) -> str:
    """Versioned experiment dirs (reference `experiment.py:77-96`)."""
    v = 0
    while os.path.exists(os.path.join(base, f"version_{v}")):
        v += 1
    return os.path.join(base, f"version_{v}")


class Experiment:
    def __init__(self, config: ConfigDict, use_dummy_data: bool = False,
                 mesh=None, reset: bool = False, device: DeviceLike = "cuda"):
        from ..parallel.mesh import check_mesh

        check_mesh(mesh)
        self.config = config
        self.use_dummy_data = use_dummy_data
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        main = mesh is None or mesh.is_main

        folder = config.get_path("meta.EXPERIMENT_FOLDER", "experiments")
        name = config.get_path("meta.experiment_name", "default")
        base = os.path.join(folder, name)
        if main and reset and os.path.exists(base):
            import shutil

            shutil.rmtree(base)
        existing = config.get_path("meta.experiment_dir")
        self.experiment_dir = existing or (_next_version(base) if main else None)
        if mesh is not None:
            from ..parallel.mesh import broadcast_object

            self.experiment_dir = broadcast_object(self.experiment_dir, mesh)
        if main:
            os.makedirs(self.experiment_dir, exist_ok=True)
        config.set_path("meta.experiment_dir", self.experiment_dir)

        if main:
            self._setup_logging()
            self._save_config_snapshot()
            # wandb run lifecycle: delete prior runs on train+reset, else
            # resume (reference `experiment.py:100-129,368-377`); offline-safe
            from ..utils.observability import manage_wandb_runs

            manage_wandb_runs(config, mode=config.get_path("mode", "train"),
                              reset=reset)
        if mesh is not None:
            mesh.barrier()
        self.executor = self._init_executor()

    def _setup_logging(self):
        """Per-run file log (reference `experiment.py:195-231`).

        Earlier Experiments' run.log handlers are removed first: a program
        constructing several Experiments in one process (train→test sweeps,
        tools/synth_accuracy_run.py) would otherwise write every line into
        ALL previous run.log files and leak open file descriptors."""
        log_path = os.path.join(self.experiment_dir, "run.log")
        root = logging.getLogger()
        for h in list(root.handlers):
            if isinstance(h, logging.FileHandler) and getattr(
                    h, "baseFilename", "").endswith(os.sep + "run.log"):
                root.removeHandler(h)
                h.close()
        handler = logging.FileHandler(log_path)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
        if root.level > logging.INFO:
            root.setLevel(logging.INFO)

    def _save_config_snapshot(self):
        with open(os.path.join(self.experiment_dir, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=1, default=str)

    def _init_executor(self):
        name = self.config.get_path("executor.ExecutorClass", "FLMRExecutor")
        if name not in Executor_Registry:
            raise KeyError(
                f"executor {name!r} not registered; known: {list(Executor_Registry)}"
            )
        cls = Executor_Registry[name]
        return cls(self.config, use_dummy_data=self.use_dummy_data, mesh=self.mesh,
                   device=self.device)

    # --------------------------------------------------------------- modes
    def train(self):
        logger.info("=== train: %s ===", self.experiment_dir)
        return self.executor.train()

    def test(self):
        logger.info("=== test: %s ===", self.experiment_dir)
        return self.executor.test()

    def eval(self):
        """Post-hoc evaluation over saved predictions (reference
        `experiment.py:431-481`)."""
        logger.info("=== eval: %s ===", self.experiment_dir)
        pred_path = self.config.get_path("eval.predictions_path") or os.path.join(
            self.experiment_dir, "test_predictions_rank_0.json"
        )
        with open(pred_path) as f:
            dump = json.load(f)
        data_dict = {
            "batch_retrieval_result": dump["predictions"],
            "Ks": self.config.get_path("model_config.Ks", [5, 10, 20, 50, 100]),
        }
        results = self.executor.compute_metrics(data_dict)
        self.executor.logging_results(
            ConfigDict({**results, "batch_retrieval_result": dump["predictions"]}),
            prefix="eval",
        )
        return results
