"""HF-hub model upload CLI (port of ``tools/upload_model_to_hub.py``).

Parity with the reference's `tools/upload_model_to_hub.py` (create a model
repo, push a saved checkpoint folder) and `tools/save_model.py` (re-export a
hub checkpoint locally). Here the local folder is whatever
``FLMRExecutor.save_hf_model`` / ``tools/convert_checkpoint.py`` produced (a
state dict plus config JSON) or any directory the user points at.

Network-gated: the ``huggingface_hub`` import and the API calls happen only
at invocation, so the module imports cleanly offline; the tool exists for
deployments that have network access.

Usage:
  python -m reranking_multimodal_retrievers_tpu_torch.tools.upload_model_to_hub \
      --folder ./flmr_port --repo_id your-org/FLMR [--private]
"""

from __future__ import annotations

import argparse
import os


def upload_folder(folder: str, repo_id: str, private: bool = True,
                  api=None) -> str:
    """Create ``repo_id`` (idempotent) and upload ``folder`` to its root.

    ``api`` is injectable for tests; defaults to ``huggingface_hub.HfApi``.
    Returns the repo id.
    """
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"not a directory: {folder}")
    if api is None:
        try:
            from huggingface_hub import HfApi
        except ImportError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "huggingface_hub is not installed; install it (network "
                "required) to upload models") from e
        api = HfApi()
    api.create_repo(repo_id=repo_id, repo_type="model", private=private,
                    exist_ok=True)
    api.upload_folder(folder_path=folder, repo_id=repo_id, repo_type="model")
    return repo_id


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--folder", required=True,
                   help="local checkpoint folder to push")
    p.add_argument("--repo_id", required=True, help="e.g. your-org/FLMR")
    p.add_argument("--private", action="store_true")
    args = p.parse_args(argv)
    repo = upload_folder(args.folder, args.repo_id, private=args.private)
    print(f"uploaded {args.folder} -> {repo}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
