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

``--n_devices N`` (N > 1) runs the mode data-parallel over N ranks, one a
device (``parallel/launch.py``): N cards over NCCL, or with
``RMRT_PLATFORM=cpu`` N CPU ranks over gloo. Under an outside launcher
(``torchrun``: ``WORLD_SIZE`` set) the process joins that launcher's group
instead of starting ranks. N above the visible cards raises the mesh's
overask error.

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
                   help="mesh size: ranks to start, one a device (default 1)")
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

    mesh = None
    if args.n_devices and args.n_devices > 1:
        mesh = _join_mesh(args, argv)
        if mesh is None:  # the ranks ran the mode
            return 0
        device = mesh.device
        if not mesh.is_main:  # rank 0 speaks for all
            logging.getLogger().setLevel(logging.WARNING)
    else:
        device = platform_device()

    from ..executors.experiment import Experiment

    exp = Experiment(config, use_dummy_data=args.use_dummy_data, reset=args.reset,
                     device=device, mesh=mesh)
    speak = mesh is None or mesh.is_main
    if args.mode == "train":
        exp.train()
    elif args.mode == "test":
        results = exp.test()
        if speak:
            print("test metrics:", dict(results.metrics))
    elif args.mode == "eval":
        results = exp.eval()
        if speak:
            print("eval metrics:", dict(results.metrics))
    return 0


def _join_mesh(args, argv):
    """The mesh of this rank when the process runs under a launcher (ours
    or ``torchrun``); else start ``--n_devices`` ranks that run ``main``
    themselves, wait for them, and return None."""
    import os

    import torch

    from ..parallel.launch import init_from_env, spawn
    from ..parallel.mesh import check_fits, make_mesh

    n = args.n_devices
    plat = os.environ.get("RMRT_PLATFORM")
    if plat and plat != "cpu":
        platform_device()  # raises, naming the variable
    device_type = "cpu" if plat == "cpu" else "cuda"
    if device_type == "cuda":
        check_fits(n, 1, torch.cuda.device_count())
    if "WORLD_SIZE" in os.environ:
        init_from_env(device_type)
        return make_mesh(n_data=n)
    env = {}
    if device_type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
    spawn(main, n, (list(sys.argv[1:]) if argv is None else list(argv),),
          device_type=device_type, env=env, timeout=None)
    return None


if __name__ == "__main__":
    sys.exit(main())
