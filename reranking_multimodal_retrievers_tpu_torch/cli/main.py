"""CLI entry point (port of ``cli/main.py``).

Parity with the reference `src/main.py:20-224`: ``--config`` (jsonnet/json/py)
+ ``--mode prepare_data|train|test|eval`` + dot-path ``--opts`` overrides +
``--use_dummy_data``; user modules named in the config are imported so their
registries populate.

The executors, and in ``--mode prepare_data`` the data nodes that run a model
(captioner, ViT and VAE features, the distillation teacher), run on the CUDA
card, or on the CPU when ``RMRT_PLATFORM=cpu`` is set (the JAX CLI's own
switch; ``device.py::platform_device``); without a card and without that
variable they raise rather than run on the CPU.

Usage:
  python -m reranking_multimodal_retrievers_tpu_torch.cli.main \
      --config configs/okvqa_flmr.json --mode train \
      --opts train.trainer_paras.max_epochs=1
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..device import platform_device


def parse_sys_args(argv=None):
    p = argparse.ArgumentParser(description="reranking-multimodal-retrievers (PyTorch/CUDA)")
    p.add_argument("--config", required=True, help="path to .json/.py/.jsonnet config")
    p.add_argument("--mode", required=True,
                   choices=["prepare_data", "train", "test", "eval"])
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--use_dummy_data", action="store_true")
    p.add_argument("--reset", action="store_true",
                   help="wipe the experiment folder before running")
    p.add_argument("--n_devices", type=int, default=None,
                   help="number of devices (only 1 is ported)")
    p.add_argument("--opts", nargs="*", default=[],
                   help="dot-path overrides: a.b.c=value")
    return p.parse_args(argv)


def build_config(args):
    from ..utils.config_system import apply_opts, import_user_modules, load_config

    config = load_config(args.config)
    apply_opts(config, args.opts)
    config.set_path("mode", args.mode)
    if args.experiment_name:
        config.set_path("meta.experiment_name", args.experiment_name)
    import_user_modules(config.get_path("meta.user_modules", []))
    return config


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = parse_sys_args(argv)
    config = build_config(args)

    # side-effect imports: register executors and data ops
    from .. import executors  # noqa: F401
    from ..data import ops  # noqa: F401

    if args.mode == "prepare_data":
        from ..data.pipeline import DataPipeline

        dp = DataPipeline(
            config.data_pipeline,
            use_dummy_data=args.use_dummy_data,
            global_config=config,
        )
        outputs = dp.apply_transforms()
        print(f"prepared {len(outputs)} output nodes: {list(outputs)}")
        return 0

    if args.n_devices and args.n_devices > 1:
        from ..executors.base import MULTI_DEVICE_TODO

        raise NotImplementedError(MULTI_DEVICE_TODO)
    device = platform_device()

    from ..executors.experiment import Experiment

    exp = Experiment(config, use_dummy_data=args.use_dummy_data, reset=args.reset,
                     device=device)
    if args.mode == "train":
        exp.train()
    elif args.mode == "test":
        results = exp.test()
        print("test metrics:", dict(results.metrics))
    elif args.mode == "eval":
        results = exp.eval()
        print("eval metrics:", dict(results.metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
