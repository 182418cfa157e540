"""``data/arrow_io.py`` against HF ``datasets``: the reader equals
``datasets.load_from_disk`` on ``save_to_disk`` directories of every Arrow
type the port takes (several record batches, several shards, nulls
everywhere), ``datasets.load_from_disk`` reads the writer's output equal to
its input, the reader raises on what it does not take, ``_load_hf`` keeps
the JAX package's ``///`` rule, and the port's pipeline reads a ``.hf``
cache entry the JAX pipeline wrote. Then the port's ``LoadHFDataset``,
``SplitHFDatasetToTrainTestValidation`` and ``HFDatasetTokenizeTransform``
against the JAX package's on the same directory."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
datasets = pytest.importorskip("datasets")
pa = pytest.importorskip("pyarrow")

from reranking_multimodal_retrievers_tpu_torch.data import arrow_io  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.data.table import Table  # noqa: E402


def _rows(ds):
    return [dict(r) for r in ds]


def _typed_table(n=37, seed=0):
    """A pyarrow table with a column of every type the reader takes, nulls
    in each, and nested lists and structs."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2

    def nullify(values):
        return [v if ok else None for v, ok in zip(values, valid)]

    cols = {"null": pa.array([None] * n, pa.null()),
            "bool": pa.array(nullify((rng.random(n) > 0.5).tolist()), pa.bool_())}
    for bits in (8, 16, 32, 64):
        for signed in (True, False):
            t = getattr(pa, f"{'int' if signed else 'uint'}{bits}")()
            hi = 2 ** (bits - 1) - 1 if signed else 2 ** bits - 1
            lo = -(2 ** (bits - 1)) if signed else 0
            vals = [int(v) for v in rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
                    ] if bits < 64 else [int(v) for v in rng.integers(-2**62, 2**62, n)]
            if not signed and bits == 64:
                vals = [abs(v) * 2 + 1 for v in vals]
            cols[str(t)] = pa.array(nullify(vals), t)
    for t in (pa.float16(), pa.float32(), pa.float64()):
        vals = rng.normal(size=n).astype(t.to_pandas_dtype())
        cols[str(t)] = pa.array(nullify(vals.tolist()), t)
    words = [f"w{i}é" * (i % 4) for i in range(n)]
    cols["string"] = pa.array(nullify(words), pa.string())
    cols["large_string"] = pa.array(nullify(words[::-1]), pa.large_string())
    cols["binary"] = pa.array(nullify([w.encode() for w in words]), pa.binary())
    cols["large_binary"] = pa.array(nullify([w.encode()[::-1] for w in words]), pa.large_binary())
    lists = [[float(x) for x in rng.normal(size=i % 5).astype(np.float32)] for i in range(n)]
    cols["list_f32"] = pa.array(nullify(lists), pa.list_(pa.float32()))
    nested = [[[f"a{j}" for j in range(k)] for k in range(i % 3)] for i in range(n)]
    cols["large_list_of_lists"] = pa.array(nullify(nested),
                                           pa.large_list(pa.list_(pa.string())))
    structs = [{"class": f"c{i}", "rect": [i, i + 1.5, None, 2.0], "conf": None if i % 3 else 0.5}
               for i in range(n)]
    cols["struct"] = pa.array(nullify(structs), pa.struct(
        [("class", pa.string()), ("rect", pa.list_(pa.float64())), ("conf", pa.float32())]))
    cols["objects"] = pa.array([[s, s] if ok else [] for s, ok in zip(structs, valid)],
                               pa.list_(cols["struct"].type))
    cols["fixed"] = pa.array(nullify([[i, -i, 2 * i] for i in range(n)]),
                             pa.list_(pa.int32(), 3))
    return pa.table(cols)


def test_reader_equals_datasets_on_every_type(tmp_path):
    table = _typed_table()
    ds = datasets.Dataset(table)
    dd = datasets.DatasetDict({"train": ds, "test": ds.select([5, 3, 3, 0, 30])})
    dd.save_to_disk(str(tmp_path / "d"))
    want = datasets.load_from_disk(str(tmp_path / "d"))
    got = arrow_io.load_from_disk(str(tmp_path / "d"))
    assert list(got) == list(want) == ["train", "test"]
    for split in want:
        assert isinstance(got[split], Table)
        assert got[split].column_names == want[split].column_names
        assert list(got[split]) == _rows(want[split]), split


@pytest.mark.parametrize("shards,batch", [(3, 7), (1, 1000), (2, 1)])
def test_reader_takes_shards_and_record_batches(tmp_path, shards, batch):
    ds = datasets.Dataset(_typed_table(n=23, seed=1))
    ds.save_to_disk(str(tmp_path / "d"), num_shards=shards)
    with open(tmp_path / "d" / "state.json") as f:
        assert len(json.load(f)["_data_files"]) == shards
    got = arrow_io.load_from_disk(str(tmp_path / "d"))
    assert isinstance(got, Table)
    assert list(got) == _rows(datasets.load_from_disk(str(tmp_path / "d")))
    # a stream of several record batches, written directly
    table = _typed_table(n=23, seed=2)
    path = str(tmp_path / "s.arrow")
    with pa.OSFile(path, "wb") as sink, pa.ipc.new_stream(sink, table.schema) as w:
        for b in table.to_batches(max_chunksize=batch):
            w.write_batch(b)
    cols = arrow_io.read_arrow_stream(path)
    assert Table(cols) == Table.from_dict(table.to_pydict())


class _OffsetWriter(arrow_io._BodyWriter):
    """Writes string and list columns as a producer may write a slice of a
    longer array: offsets that start past 0 into data with a prefix no row
    uses (pyarrow's own writer rebases offsets to 0)."""

    SKIP = 3

    def array(self, f, values):
        if f.kind not in ("utf8", "list"):
            return super().array(f, values)
        self.validity(values)
        if f.kind == "utf8":
            parts = [b"" if v is None else v.encode() for v in values]
            data = b"\xee" * self.SKIP + b"".join(parts)
        else:
            parts = [[] if v is None else list(v) for v in values]
        off = np.cumsum([0] + [len(p) for p in parts]) + self.SKIP
        self.add(off.astype("<i4").tobytes())
        if f.kind == "utf8":
            self.add(data)
        else:
            self.array(f.children[0], [None] * self.SKIP + [x for p in parts for x in p])


def test_reader_takes_offsets_that_do_not_start_at_zero(tmp_path, monkeypatch):
    t = Table.from_dict({"s": ["ab", None, "", "cdé"], "l": [[1, 2], [], None, [3]],
                         "n": [1, 2, 3, 4]})
    monkeypatch.setattr(arrow_io, "_BodyWriter", _OffsetWriter)
    arrow_io.write_arrow_stream(str(tmp_path / "o.arrow"), t,
                                [arrow_io._infer(k, t[k]) for k in t.column_names])
    cols = arrow_io.read_arrow_stream(str(tmp_path / "o.arrow"))
    assert Table(cols) == t
    with pa.OSFile(str(tmp_path / "o.arrow")) as f:
        assert pa.ipc.open_stream(f).read_all().to_pydict() == {k: t[k] for k in t.column_names}


def test_writer_output_reads_back_in_datasets(tmp_path, monkeypatch):
    monkeypatch.setattr(arrow_io, "BATCH_ROWS", 4)  # several record batches a shard
    t = Table.from_dict({
        "question_id": [f"q{i}" for i in range(9)],
        "n": [1, None, 3, 4, 5, 6, 7, 8, -9],
        "x": [0.5, 1, None, 2.25, 3, 4, 5, 6, 7],
        "ok": [True, False, None, True, True, False, True, True, False],
        "nothing": [None] * 9,
        "pos_item_ids": [[f"p{i}", f"p{i + 1}"] for i in range(8)] + [None],
        "objects": [[{"class": "cat", "rect": [1.0, 2.0, 3.0, 4.0]}]] * 4 + [[]] * 5,
        "caption": [{"caption": "a cat", "score": 1}] + [None] * 8,
        "raw": [b"\x00\xff"] * 9,
    })
    arrow_io.save_to_disk({"train": t, "test": t.select([8, 0])}, str(tmp_path / "w"))
    back = datasets.load_from_disk(str(tmp_path / "w"))
    assert _rows(back["train"]) == list(t)
    assert _rows(back["test"]) == list(t.select([8, 0]))
    assert arrow_io.load_from_disk(str(tmp_path / "w"))["train"] == t
    arrow_io.save_to_disk(t, str(tmp_path / "one"))
    assert _rows(datasets.load_from_disk(str(tmp_path / "one"))) == list(t)


def _stream(path, table, **options):
    with pa.OSFile(str(path), "wb") as sink, pa.ipc.new_stream(
            sink, table.schema, options=pa.ipc.IpcWriteOptions(**options)) as w:
        w.write_table(table)


def test_reader_raises_on_what_it_does_not_take(tmp_path):
    plain = pa.table({"a": pa.array(["x", "y"])})
    _stream(tmp_path / "c.arrow", plain, compression="zstd")
    with pytest.raises(NotImplementedError, match="compressed"):
        arrow_io.read_arrow_stream(str(tmp_path / "c.arrow"))
    _stream(tmp_path / "d.arrow", pa.table({"cat": pa.array(["x", "y", "x"]).dictionary_encode()}))
    with pytest.raises(NotImplementedError, match="'cat' is dictionary-encoded"):
        arrow_io.read_arrow_stream(str(tmp_path / "d.arrow"))
    _stream(tmp_path / "t.arrow", pa.table({"when": pa.array([1, 2], pa.timestamp("s"))}))
    with pytest.raises(NotImplementedError, match="'when' has Arrow type 'timestamp'"):
        arrow_io.read_arrow_stream(str(tmp_path / "t.arrow"))
    img = datasets.Dataset.from_dict({"picture": [{"bytes": b"\x89PNG", "path": None}]},
                                     features=datasets.Features({"picture": datasets.Image()}))
    img.save_to_disk(str(tmp_path / "img"))
    with pytest.raises(NotImplementedError, match="'picture' is a datasets Image"):
        arrow_io.load_from_disk(str(tmp_path / "img"))


def test_load_hf_keeps_the_subfolder_rule(tmp_path):
    from reranking_multimodal_retrievers_tpu.data.ops import m2kr_ops as jax_ops
    from reranking_multimodal_retrievers_tpu_torch.data.ops import m2kr_ops

    d = datasets.DatasetDict({"train": datasets.Dataset.from_dict({"q": ["a", "b"]})})
    d.save_to_disk(str(tmp_path / "m2kr"))
    for path in (str(tmp_path / "m2kr"), f"{tmp_path / 'm2kr'}///EVQA_data"):
        want = jax_ops._load_hf(path)
        got = m2kr_ops._load_hf(path)
        assert list(got) == list(want) and list(got["train"]) == _rows(want["train"])
    with pytest.raises(NotImplementedError, match="BByrneLab/M2KR"):
        m2kr_ops._load_hf("BByrneLab/M2KR///EVQA_data")
    from reranking_multimodal_retrievers_tpu_torch.data.ops.generic import LoadHFDataset

    with pytest.raises(NotImplementedError, match="'BByrneLab/M2KR' is not a save_to_disk"):
        LoadHFDataset().setup(dataset_name="BByrneLab/M2KR")(None)


def _pipeline(pkg, cache_dir, data_path):
    __import__(f"{pkg}.data.ops")
    pipe = __import__(f"{pkg}.data.pipeline", fromlist=["x"])
    cfgmod = __import__(f"{pkg}.utils.config_system", fromlist=["x"])
    cfg = cfgmod.ConfigDict({"cache_dir": str(cache_dir), "transforms": {
        "input:Load": {"transform_name": "LoadHFDataset", "cache": True,
                       "setup_kwargs": {"dataset_name": os.path.basename(data_path),
                                        "dataset_path": os.path.dirname(data_path),
                                        "fields": ["question", "label"]}},
        "process:Split": {"transform_name": "SplitHFDatasetToTrainTestValidation",
                          "input_node": "input:Load", "cache": True,
                          "setup_kwargs": {"test_size": 0.2, "valid_size": 0.1,
                                           "train_test_split_kwargs": {"seed": 7}}}}})
    return pipe.DataPipeline(cfg, global_config=cfg)


def test_hf_nodes_and_a_jax_cache_entry(tmp_path):
    """``LoadHFDataset`` and the double ``train_test_split`` equal the JAX
    package's; the JAX pipeline's ``.hf`` cache entries are then read by the
    port's pipeline (the same cache names), which runs no node."""
    n = 53
    src = datasets.DatasetDict({"train": datasets.Dataset.from_dict(
        {"question": [f"question {i}" for i in range(n)], "label": list(range(n)),
         "extra": [[i] for i in range(n)]})})
    src.save_to_disk(str(tmp_path / "data" / "toy"))
    jax_pipe = _pipeline("reranking_multimodal_retrievers_tpu", tmp_path / "cache",
                         str(tmp_path / "data" / "toy"))
    want = jax_pipe.get_data(["process:Split"], explode=True)
    port = _pipeline("reranking_multimodal_retrievers_tpu_torch", tmp_path / "port_cache",
                     str(tmp_path / "data" / "toy"))
    got = port.get_data(["process:Split"], explode=True)
    assert list(got) == list(want) == ["train", "test", "validation"]
    for split in want:
        assert list(got[split]) == _rows(want[split]), split
    assert any(f.endswith(".hf") for f in os.listdir(tmp_path / "cache"))
    from reranking_multimodal_retrievers_tpu_torch.data.ops import generic

    calls = []
    orig = generic.SplitHFDatasetToTrainTestValidation._call
    generic.SplitHFDatasetToTrainTestValidation._call = lambda self, d: calls.append(1)
    try:
        again = _pipeline("reranking_multimodal_retrievers_tpu_torch", tmp_path / "cache",
                          str(tmp_path / "data" / "toy")).get_data(["process:Split"],
                                                                   explode=True)
    finally:
        generic.SplitHFDatasetToTrainTestValidation._call = orig
    assert calls == []
    assert {k: list(v) for k, v in again.items()} == {k: list(v) for k, v in got.items()}


def test_hf_tokenize_transform_equals_jax(tmp_path):
    from reranking_multimodal_retrievers_tpu.data.ops.generic import (
        HFDatasetTokenizeTransform as JTok)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.generic import (
        HFDatasetTokenizeTransform)
    from reranking_multimodal_retrievers_tpu_torch.models.tokenization import tiny_bert_tokenizer

    tiny_bert_tokenizer(str(tmp_path / "tok"), ["what", "is", "the", "dog", "here"])
    rows = {"question": ["what is the dog", "here is a dog ?", "the"], "id": [1, 2, 3]}
    cfg = {"TokenizerClass": "BertTokenizerFast", "TokenizerModelVersion": str(tmp_path / "tok"),
           "tokenize_kwargs": {"padding": "max_length", "truncation": True, "max_length": 8}}
    out = {}
    for cls, make in ((JTok, datasets.Dataset.from_dict), (HFDatasetTokenizeTransform,
                                                          Table.from_dict)):
        f = cls(use_dummy_data=False)
        f.setup(tokenizer_config=cfg, tokenize_fields_list=["question"],
                splits_to_process=["train"])
        out[cls] = f({"train": make(rows), "train_passages": make({"p": ["x"]})})
    want, got = out[JTok], out[HFDatasetTokenizeTransform]
    assert list(got["train"]) == _rows(want["train"])
    assert list(got["train_passages"]) == _rows(want["train_passages"])
