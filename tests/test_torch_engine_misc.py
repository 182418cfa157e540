"""The port's engine infra, data and utility modules (``engine/infra.py``,
``engine/data.py``, ``engine/utility.py``) under the JAX package's own test
cases: each case of ``tests/test_engine_infra.py``,
``tests/test_engine_utility.py`` and the data round-trips of
``tests/test_engine_extras.py`` and ``tests/test_engine_trainer.py`` runs
once more with its imports pointed at
the port (one parametrised test, so that every case counts), plus checks
that the port's copies give the JAX package's results on the same seeded
inputs. No tolerance: these modules compute no floating-point arrays.
"""

import inspect
import os
import random

import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.engine import utility as jutility  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import infra, utility  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.data import Ranking  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _port_cases(filename):
    """The test functions of a JAX-package test file, compiled with every
    import of ``reranking_multimodal_retrievers_tpu.engine`` pointed at the
    port's engine (under the file's own name, so stack traces read as it)."""
    path = os.path.join(HERE, filename)
    with open(path) as f:
        src = f.read().replace("reranking_multimodal_retrievers_tpu.engine",
                               "reranking_multimodal_retrievers_tpu_torch.engine")
    namespace = {"__name__": f"port_{filename[:-3]}"}
    exec(compile(src, path, "exec"), namespace)
    return namespace


CASES = {
    "test_engine_infra.py": [
        "test_config_defaults_match_reference_vocabulary",
        "test_from_existing_explicit_fields_win",
        "test_config_save_load_roundtrip",
        "test_run_context_nesting_and_paths",
        "test_run_open_refuses_overwrite",
        "test_provenance",
        "test_plain_constructor_counts_as_fully_explicit",
        "test_plain_config_auto_name_does_not_clobber_on_merge",
    ],
    "test_engine_utility.py": [
        "test_sample_negatives_biased_split",
        "test_sample_triples_positive_rules",
        "test_sample_triples_permissive_tail_negatives",
        "test_sample_triples_cap_and_shuffle",
        "test_self_training_triples",
        "test_has_answer_word_span",
        "test_annotate_em_metrics",
        "test_merge_rankings_resorts_by_score",
        "test_ranking_splits_partition",
        "test_split_ranking_by_offset_gap_unmerge",
        "test_merge_rankings_tolerates_trailing_fields",
        "test_subsample_and_split_queries",
        "test_pick_best_run",
        "test_docs2passages_wraparound",
        "test_msmarco_eval",
    ],
    "test_engine_extras.py": [
        "test_queries_collection_ranking_roundtrip",
        "test_static_retrieval_rank_only_has_no_score",
    ],
    "test_engine_trainer.py": [
        "test_examples_roundtrip_and_shard",
        "test_lazy_batcher_shapes",
    ],
}


@pytest.fixture(autouse=True)
def fresh_run():
    """``tests/test_engine_infra.py``'s fixture, on the port's ``Run``."""
    infra.Run._reset_for_tests()
    yield
    infra.Run._reset_for_tests()


@pytest.mark.parametrize("filename,case", [(f, c) for f, cases in CASES.items() for c in cases])
def test_jax_case_on_port(filename, case, tmp_path):
    fn = _port_cases(filename)[case]
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(fn).parameters else {}
    fn(**kwargs)


def test_cases_import_the_port():
    """Every engine name the rewritten cases import comes from the port."""
    for filename in CASES:
        ns = _port_cases(filename)
        mods = {getattr(v, "__module__", "") for v in ns.values() if callable(v)}
        engine = {m for m in mods if ".engine" in m}
        assert engine and all(m.startswith("reranking_multimodal_retrievers_tpu_torch.")
                              for m in engine), engine


def test_run_rank_without_process_group():
    assert not torch.distributed.is_initialized()
    assert infra.Run().rank == 0


def _ranking(seed):
    rng = random.Random(seed)
    return {f"q{q}": [(100 * q + r, r, -float(r), int(rng.random() < 0.2))
                      for r in range(1, 151)] for q in range(6)}


@pytest.mark.parametrize("biased,permissive", [(None, False), (100, False), (None, True)])
def test_sample_triples_same_as_jax(biased, permissive):
    """The same seeded draws: equal triples, in the same order."""
    kw = dict(positives=[(5, 50), (1, 150)], depth=150, biased=biased, permissive=permissive,
              max_triples=400, seed=3)
    assert utility.sample_triples(_ranking(1), **kw) == jutility.sample_triples(_ranking(1), **kw)


def test_self_training_and_splits_same_as_jax():
    ranking = {q: [(pid, rank) for pid, rank, *_ in rows] for q, rows in _ranking(2).items()}
    kw = dict(npositives=2, depth_positive=5, depth_negative=150, cutoff_negative=20, seed=9)
    assert (utility.self_training_triples(ranking, **kw)
            == jutility.self_training_triples(ranking, **kw))
    qids = list(ranking)
    assert utility.split_queries(qids, 2, seed=4) == jutility.split_queries(qids, 2, seed=4)
    assert utility.subsample_queries(qids, 3, seed=4) == jutility.subsample_queries(qids, 3, seed=4)


def test_ranking_json_roundtrip(tmp_path):
    """The static-retrieval json the reranker executor reads: written by the
    port, read back with scores and ranks."""
    r = Ranking(data=[(1, "P0", 0, 9.5), (1, "P7", 1, 8.0), (2, "P3", 0, 7.7)])
    path = str(tmp_path / "static.json")
    r.save(path)
    assert sorted(Ranking.cast(path).tolist()) == sorted(r.tolist())
