"""The port's per-rank input pipeline (``data/multihost.py``) against the
JAX package's: ``ProcessShardDataset``'s rows over a grid of dataset sizes
and process counts (empty shards included), and ``MultiHostDataLoader``'s
per-rank batches, with an explicit ``process_index``/``process_count`` (no
ranks started), equal to the process-local batches of the JAX loader, whose
union in process order is the JAX loader's global batch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.data import multihost as jmh  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.data import multihost as tmh  # noqa: E402


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "qid": f"q{i}"}


def _rows(shard):
    return [shard[i]["qid"] for i in range(len(shard))]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 22, 64])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_process_shard_rows_match_jax(n, P):
    for i in range(P):
        got = tmh.ProcessShardDataset(_Rows(n), i, P)
        want = jmh.ProcessShardDataset(_Rows(n), i, P)
        assert len(got) == len(want)
        assert _rows(got) == _rows(want)


@pytest.mark.parametrize("P,batch", [(1, 8), (2, 8), (4, 16), (4, 4)])
def test_rank_batches_are_jax_process_local_batches(P, batch):
    ds = _Rows(45)
    union = {}
    for pi in range(P):
        got = tmh.MultiHostDataLoader(ds, batch_size=batch, shuffle=True, seed=3,
                                      process_index=pi, process_count=P)
        want = jmh.MultiHostDataLoader(ds, batch_size=batch, mesh=None, shuffle=True, seed=3,
                                       process_index=pi, process_count=P)
        assert len(got) == len(want)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            for step, (g, w) in enumerate(zip(got, want.local_loader)):
                assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
                assert g["x"].shape == (batch // P, 3)
                np.testing.assert_array_equal(g["x"].numpy(), w["x"])
                assert list(g["qid"]) == list(w["qid"])
                union.setdefault((epoch, step), []).append(g["x"].numpy())
    for parts in union.values():  # the global batch: every rank's rows, disjoint
        rows = np.concatenate(parts)[:, 0]
        assert rows.shape == (batch,) and len(set(rows.tolist())) == batch
