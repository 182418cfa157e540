"""Shrink static-retrieval prediction dumps for reranker training (port of
``tools/reduce_retrieval_file.py``; standard library only).

Parity with the reference's `src/tools/reduce_retrieval_result_file_size.py`
(:1-35): drop the bulky ``content`` field from every entry of
``top_ranking_passages`` (the reranker re-resolves contents from its own
passage corpus via ``id2doc``) and re-save the JSON dump as a pickle, which
`RerankerExecutor.init_retrieve` loads directly (either format, by suffix).
Unlike the reference's hard-coded path list, this is a CLI over any number
of dumps.

Usage::

    python -m reranking_multimodal_retrievers_tpu_torch.tools.reduce_retrieval_file \
        experiments/*/version_*/test_predictions_rank_0.json
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def reduce_retrieval_file(path: str, target: str | None = None,
                          keep_fields: tuple = ("passage_id", "score")) -> str:
    """Strip per-passage payloads from one dump and pickle it.

    Returns the written path (``target`` or ``path`` with a ``.pkl``
    suffix). The dump's structure — top-level ``output`` list (reference
    layout) or the executors' ``predictions`` list — is preserved; only
    the per-passage dicts inside ``top_ranking_passages`` (and
    ``raw_top_ranking_passages`` when present) are slimmed to
    ``keep_fields``.
    """
    with open(path) as f:
        data = json.load(f)
    if "output" in data:
        entries = data["output"]
    elif "predictions" in data:
        entries = data["predictions"]
    else:
        entries = data
    for prediction in entries:
        for key in ("top_ranking_passages", "raw_top_ranking_passages"):
            if key not in prediction:
                continue
            prediction[key] = [
                {k: p[k] for k in keep_fields if k in p}
                for p in prediction[key]
            ]
    target = target or os.path.splitext(path)[0] + ".pkl"
    with open(target, "wb") as f:
        pickle.dump(data, f)
    return target


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="prediction JSON dumps")
    ap.add_argument("--keep", nargs="*", default=["passage_id", "score"],
                    help="per-passage fields to keep")
    args = ap.parse_args(argv)
    for path in args.paths:
        target = reduce_retrieval_file(path, keep_fields=tuple(args.keep))
        print(f"{path} -> {target} "
              f"({os.path.getsize(path)} -> {os.path.getsize(target)} bytes)")


if __name__ == "__main__":
    main()
