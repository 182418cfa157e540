"""Job-script generation (port of ``tools/submit_jobs.py``).

Parity with the reference's SLURM job generators (`submit_train_jobs.py:37-80`,
`submit_test_jobs.py`, `dummy_*_job.py`): render launchable shell scripts per
experiment config. The reference wraps ``torchrun --nproc_per_node={gpus}``;
here a job is one process on one CUDA card running the port's
``cli.main``, with the smoke-test variant capping work via
``limit_test_batches`` exactly as the reference's dummy jobs do.
"""

from __future__ import annotations

import argparse
import os
import stat
from typing import List, Optional

TRAIN_TEMPLATE = """#!/bin/bash
# auto-generated CUDA job: {name}
set -euo pipefail
cd {workdir}
python -m reranking_multimodal_retrievers_tpu_torch.cli.main \\
    --config {config} \\
    --mode {mode} \\
    --experiment_name {name} {extra_flags} \\
    --opts {opts}
"""


def render_job(
    config: str,
    mode: str,
    name: str,
    workdir: str = ".",
    opts: Optional[List[str]] = None,
    dummy: bool = False,
    out_dir: str = "jobs",
) -> str:
    opts = list(opts or [])
    extra = []
    if dummy:
        extra.append("--use_dummy_data")
        if mode == "test":
            # the reference's smoke cap (`dummy_test_job.py:37-60`)
            opts += ["test.trainer_paras.limit_test_batches=1", "test.batch_size=3"]
        else:
            opts += ["train.trainer_paras.limit_train_batches=2",
                     "train.trainer_paras.max_epochs=1"]
    script = TRAIN_TEMPLATE.format(
        name=name,
        workdir=os.path.abspath(workdir),
        config=config,
        mode=mode,
        extra_flags=" ".join(extra),
        opts=" ".join(opts) if opts else '""',
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}_{mode}.sh")
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--mode", default="train")
    p.add_argument("--name", required=True)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--out_dir", default="jobs")
    p.add_argument("--opts", nargs="*", default=[])
    args = p.parse_args(argv)
    print(render_job(args.config, args.mode, args.name, opts=args.opts,
                     dummy=args.dummy, out_dir=args.out_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
