"""``data/parquet_io.py`` against pyarrow and the JAX package, on the CPU.

The reader equals ``pyarrow.parquet.read_table(...).to_pylist()`` on files
pyarrow writes here (every codec it reads, dictionary on and off, data
page v1 and v2, one or several row groups with small pages; strings, ints
of each width, unsigned ints, floats, bools, nulls, binary, lists of
strings with empty and null lists, a struct, a list of structs, a list of
lists) and on random tables (a ``hypothesis`` property); it raises on a
codec (LZO), encoding or feature it does not take. The YAML front-matter reader
equals ``yaml.safe_load``. On the committed M2KR snapshot
(``tests/fixtures/m2kr_snapshot``, written by
``tests/fixtures/make_m2kr_parquet.py``), ``_load_hf`` and the
``LoadPreprocessedData`` node give the JAX package's splits and rows
(the JAX package reads it through ``datasets.load_dataset``), in the YAML
layout and in the sub-folder layout; ``prepare_cc_images`` reads a parquet
file as ``datasets.Dataset.from_parquet`` does; and a process in which
pyarrow, ``datasets``, PyYAML and PIL cannot be imported reads every
committed fixture to its committed digest."""

import itertools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")
datasets = pytest.importorskip("datasets")
yaml = pytest.importorskip("yaml")
from hypothesis import given, settings, strategies as st  # noqa: E402

from reranking_multimodal_retrievers_tpu_torch.data import parquet_io  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures")
SNAPSHOT = os.path.join(FIXTURES, "m2kr_snapshot")
sys.path.insert(0, FIXTURES)
try:
    import make_m2kr_parquet as fixtures  # noqa: E402
finally:
    sys.path.pop(0)

with open(fixtures.DIGESTS) as _f:
    DIGESTS = json.load(_f)


def _rows(table):
    return [table[i] for i in range(len(table))]


def _hf_rows(ds):
    return [dict(r) for r in ds]


@pytest.fixture
def offline_datasets(monkeypatch, tmp_path):
    """``datasets`` reading local files only, its cache under ``tmp_path``."""
    import huggingface_hub.constants as hub_constants

    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    return tmp_path


# ---------------------------------------------------------------- variants
def _typed_table(n=120, seed=0):
    rng = np.random.default_rng(seed)

    def maybe(v, p=0.2):
        return None if rng.random() < p else v

    return pa.table({
        "s": pa.array([maybe(f"str{i % 37}é") for i in range(n)], pa.string()),
        "s_required": pa.array([f"u{i}" * (i % 5) for i in range(n)], pa.string()),
        "i8": pa.array([maybe(int(x)) for x in rng.integers(-128, 128, n)], pa.int8()),
        "i16": pa.array([maybe(int(x)) for x in rng.integers(-2**15, 2**15, n)], pa.int16()),
        "i32": pa.array([maybe(int(x)) for x in rng.integers(-2**31, 2**31, n)], pa.int32()),
        "i64": pa.array([maybe(int(x)) for x in rng.integers(-2**62, 2**62, n)], pa.int64()),
        "u8": pa.array([maybe(int(x)) for x in rng.integers(0, 256, n)], pa.uint8()),
        "u32": pa.array([int(x) for x in rng.integers(0, 2**32, n)], pa.uint32()),
        "u64": pa.array([int(x) * 2 + 1 for x in rng.integers(0, 2**62, n)], pa.uint64()),
        "f32": pa.array([maybe(float(x)) for x in rng.normal(size=n)], pa.float32()),
        "f64": pa.array([maybe(float(x)) for x in rng.normal(size=n)], pa.float64()),
        "bool": pa.array([maybe(bool(x)) for x in rng.integers(0, 2, n)], pa.bool_()),
        "bool_required": pa.array([bool(x) for x in rng.integers(0, 2, n)], pa.bool_()),
        "null": pa.array([None] * n, pa.null()),
        "binary": pa.array([maybe(bytes(rng.integers(0, 256, i % 7).astype(np.uint8)))
                            for i in range(n)], pa.binary()),
        "list_str": pa.array([maybe([maybe(f"x{j}", 0.1) for j in range(i % 4)])
                              for i in range(n)], pa.list_(pa.string())),
        "struct": pa.array([maybe({"a": maybe(i), "b": f"b{i}"}) for i in range(n)],
                           pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "list_struct": pa.array([maybe([maybe({"x": maybe(j), "y": maybe(f"y{j}")}, 0.1)
                                        for j in range(i % 3)]) for i in range(n)],
                                pa.list_(pa.struct([("x", pa.int32()), ("y", pa.string())]))),
        "list_list": pa.array([maybe([maybe([j, j + 1]) for j in range(i % 3)])
                               for i in range(n)], pa.list_(pa.list_(pa.int64()))),
    })


@pytest.mark.parametrize("codec,dictionary,version,groups", list(itertools.product(
    ["none", "snappy", "gzip", "zstd", "lz4"], [True, False], ["1.0", "2.0"],
    ["one", "several"])))
def test_reader_equals_pyarrow(tmp_path, codec, dictionary, version, groups):
    table = _typed_table()
    path = str(tmp_path / "t.parquet")
    small = {"row_group_size": 23, "data_page_size": 256, "write_batch_size": 8}
    pq.write_table(table, path, compression=codec, use_dictionary=dictionary,
                   data_page_version=version, **(small if groups == "several" else {}))
    meta = pq.ParquetFile(path).metadata
    assert (meta.num_row_groups > 1) == (groups == "several")
    got = parquet_io.read_parquet(path)
    assert got.column_names == table.column_names
    assert _rows(got) == table.to_pylist()


def test_legacy_two_level_lists_equal_pyarrow(tmp_path):
    """``use_compliant_nested_type=False``: lists whose element is named
    ``item``, and a bare repeated field written by hand in the schema."""
    table = _typed_table().select(["list_str", "list_struct", "list_list"])
    path = str(tmp_path / "legacy.parquet")
    pq.write_table(table, path, use_compliant_nested_type=False)
    assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


_VALUES = {
    "string": st.text(max_size=6),
    "int64": st.integers(-2**63, 2**63 - 1),
    "int32": st.integers(-2**31, 2**31 - 1),
    "uint8": st.integers(0, 255),
    "float64": st.floats(allow_nan=False),
    "bool": st.booleans(),
}


@st.composite
def _tables(draw):
    n = draw(st.integers(0, 40))
    cols = {}
    for k in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(sorted(_VALUES) + ["list", "struct"]))
        if kind == "list":
            item = draw(st.sampled_from(["string", "int64"]))
            vals = draw(st.lists(st.none() | st.lists(st.none() | _VALUES[item], max_size=4),
                                 min_size=n, max_size=n))
            cols[f"c{k}"] = pa.array(vals, pa.list_(getattr(pa, item)()))
        elif kind == "struct":
            vals = draw(st.lists(st.none() | st.fixed_dictionaries(
                {"x": st.none() | _VALUES["int32"], "y": st.none() | _VALUES["string"]}),
                min_size=n, max_size=n))
            cols[f"c{k}"] = pa.array(vals, pa.struct([("x", pa.int32()), ("y", pa.string())]))
        else:
            vals = draw(st.lists(st.none() | _VALUES[kind], min_size=n, max_size=n))
            cols[f"c{k}"] = pa.array(vals, getattr(pa, kind)() if kind != "bool" else pa.bool_())
    options = draw(st.fixed_dictionaries({
        "compression": st.sampled_from(["none", "snappy", "gzip"]),
        "use_dictionary": st.booleans(), "data_page_version": st.sampled_from(["1.0", "2.0"]),
        "row_group_size": st.integers(1, 50)}))
    return pa.table(cols), options


@settings(max_examples=40, deadline=None)
@given(_tables())
def test_reader_property_random_tables(tmp_path_factory, case):
    table, options = case
    path = str(tmp_path_factory.mktemp("prop") / "p.parquet")
    pq.write_table(table, path, **options)
    assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


def test_snappy_overlapping_copies_and_long_literals():
    rng = np.random.default_rng(3)
    raw = b"ab" * 40 + bytes(rng.integers(0, 256, 70000, dtype=np.uint8)) + b"xyz" * 3000
    assert parquet_io.snappy_decompress(pa.compress(raw, "snappy", asbytes=True)) == raw


@pytest.mark.parametrize("codec,level", [("zstd", 1), ("zstd", 19), ("lz4", None)])
def test_zstd_and_lz4_files_equal_pyarrow(tmp_path, codec, level):
    """A ZSTD file (pyarrow's default level and level 19) and an LZ4_RAW one
    (pyarrow's ``lz4``) of the typed table, one page a column chunk."""
    table = _typed_table(n=400, seed=5)
    path = str(tmp_path / "z.parquet")
    pq.write_table(table, path, compression=codec, compression_level=level)
    assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


_ENCODED = {"DELTA_BINARY_PACKED": ["i8", "i16", "i32", "i64", "u8", "u32", "u64"],
            "DELTA_LENGTH_BYTE_ARRAY": ["s", "s_required", "binary"],
            "DELTA_BYTE_ARRAY": ["s", "s_required", "binary"],
            "BYTE_STREAM_SPLIT": ["i32", "i64", "u32", "u64", "f32", "f64"]}


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("encoding", sorted(_ENCODED))
def test_other_encodings_equal_pyarrow(tmp_path, encoding, version):
    """Each delta encoding and BYTE_STREAM_SPLIT on every type pyarrow writes
    it for, with nulls, in the typed table's flat columns and inside its
    list and struct columns, on data pages v1 and v2 (several pages and row
    groups)."""
    table = _typed_table(n=300, seed=6)
    leaves = {"DELTA_BINARY_PACKED": ["struct.a", "list_struct.list.element.x",
                                      "list_list.list.element.list.element"],
              "BYTE_STREAM_SPLIT": ["struct.a", "list_struct.list.element.x",
                                    "list_list.list.element.list.element"]}.get(
        encoding, ["list_str.list.element", "struct.b", "list_struct.list.element.y"])
    columns = {c: encoding for c in _ENCODED[encoding] + leaves}
    path = str(tmp_path / "e.parquet")
    pq.write_table(table, path, use_dictionary=False, column_encoding=columns,
                   data_page_version=version, row_group_size=120, data_page_size=512)
    meta = pq.ParquetFile(path).metadata
    written = {meta.row_group(0).column(i).path_in_schema: meta.row_group(0).column(i).encodings
               for i in range(meta.num_columns)}
    assert all(encoding in written[c] for c in columns)
    assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


def test_fixed_len_byte_arrays_by_delta_and_split_equal_pyarrow(tmp_path):
    table = fixtures.fixed_table()
    for enc in ("DELTA_BYTE_ARRAY", "BYTE_STREAM_SPLIT", "PLAIN"):
        path = str(tmp_path / f"{enc}.parquet")
        pq.write_table(table, path, use_dictionary=False, data_page_version="2.0",
                       column_encoding={"fixed": enc, "fixed_list.list.element": enc})
        assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


def test_delta_binary_packed_extremes(tmp_path):
    """Deltas of 64 bits (the int64 range end to end), a single value, an
    empty page and runs of equal values (bit width 0)."""
    values = [-2**63, 2**63 - 1, -2**63, 0, 0, 0, 5, 2**62, -1] * 40
    table = pa.table({"x": pa.array(values, pa.int64()),
                      "y": pa.array([2**31 - 1, -2**31] * 180, pa.int32()),
                      "one": pa.array([7] + [None] * 359, pa.int64())})
    path = str(tmp_path / "d.parquet")
    pq.write_table(table, path, use_dictionary=False, column_encoding="DELTA_BINARY_PACKED")
    assert _rows(parquet_io.read_parquet(path)) == table.to_pylist()


def test_lz4_block_equals_pyarrow_and_hadoop_framing():
    """The LZ4 block decoder against pyarrow's ``lz4_raw`` compressor
    (overlapping matches, long literals, long matches), and parquet's LZ4
    codec in Hadoop's framing and as its raw fallback."""
    rng = np.random.default_rng(4)
    raw = (b"ab" * 40 + bytes(rng.integers(0, 256, 70000, dtype=np.uint8)) + b"xyz" * 3000
           + bytes(300))
    block = pa.compress(raw, "lz4_raw", asbytes=True)
    assert parquet_io.lz4_block(block) == raw
    assert parquet_io.lz4_block(fixtures.lz4_compress(raw)) == raw
    half = len(raw) // 2
    framed = b"".join(__import__("struct").pack(">II", len(p), len(c)) + c
                      for p in (raw[:half], raw[half:]) for c in [fixtures.lz4_compress(p)])
    assert parquet_io.lz4_hadoop(framed, len(raw)) == raw
    assert parquet_io.lz4_hadoop(block, len(raw)) == raw


@pytest.mark.parametrize("name,what", [("refused_lzo.parquet", "LZO")])
def test_refused_codecs_and_types_raise_naming_them(name, what):
    """LZO, a codec pyarrow cannot read either (``pa.Codec.is_available("lzo")``
    raises), raises ``NotImplementedError`` naming it and the file (BROTLI
    and INT96 are read: ``tests/test_torch_brotli_temporal.py``)."""
    path = os.path.join(FIXTURES, "parquet_variants", name)
    with pytest.raises(NotImplementedError, match=what) as e:
        parquet_io.read_parquet(path)
    assert name in str(e.value)


def test_an_image_feature_raises_as_arrow_io_does(tmp_path):
    """An ``Image`` column whose bytes are no image raises as ``arrow_io``'s
    decoding of the same value raises; an ``Audio`` column raises naming
    it (``Image`` columns are decoded: ``tests/test_torch_image_formats.py``)."""
    from reranking_multimodal_retrievers_tpu_torch.data import arrow_io

    for kind in ("Image", "Audio"):
        features = {"picture": {"_type": kind}, "q": {"dtype": "string", "_type": "Value"}}
        table = pa.table({"picture": [{"bytes": b"x", "path": None}], "q": ["a"]})
        table = table.replace_schema_metadata(
            {"huggingface": json.dumps({"info": {"features": features}})})
        path = str(tmp_path / f"{kind}.parquet")
        pq.write_table(table, path)
        if kind == "Audio":
            with pytest.raises(NotImplementedError, match="'picture' is a datasets Audio"):
                parquet_io.read_parquet(path)
            continue
        with pytest.raises(Exception) as want:
            arrow_io.decode_feature(features["picture"], {"bytes": b"x", "path": None}, "picture")
        with pytest.raises(type(want.value)):
            parquet_io.read_parquet(path)


# -------------------------------------------------------------------- YAML
_README_EXTRA = """
tags:
- "quoted: with colon"
- 'it''s'
- plain # a comment
flow: [a, "b, c", 3]
mapping_flow: {k: v, n: 2}
numbers:
  int: -12
  float: 2.5
  exp: 1.0e+3
  not_float: 1e3
  yes_bool: yes
  off_bool: off
  nothing: ~
  empty:
nested_list:
-
  - 1
  - 2
- - x
  - y
"""


@pytest.mark.parametrize("extra", ["committed", "extended"])
def test_front_matter_equals_yaml_safe_load(extra):
    with open(os.path.join(SNAPSHOT, "README.md")) as f:
        readme = f.read()
    if extra == "extended":
        readme = readme.replace("\nconfigs:", _README_EXTRA.rstrip() + "\nconfigs:", 1)
    body = readme.split("---\n")[1]
    want = yaml.safe_load(body)
    assert parquet_io.front_matter(readme) == want
    assert [c["config_name"] for c in want["configs"]] == ["EVQA_data", "EVQA_passages"]
    assert len(want["dataset_info"]) == 2


def test_infer_splits_follows_datasets_rule():
    files = ["train-00000-of-00002.parquet", "train-00001-of-00002.parquet",
             "valid-00000-of-00001.parquet", "test_passages.parquet", "notes.parquet"]
    assert parquet_io.infer_splits(files) == {
        "train": files[:2], "validation": files[2:3], "test": files[3:4]}
    assert parquet_io.infer_splits(["data/foo-00000-of-00001.parquet"]) == {
        "foo": ["data/foo-00000-of-00001.parquet"]}
    assert parquet_io.infer_splits(["dev/a.parquet", "x/train.parquet"]) == {
        "validation": ["dev/a.parquet"]}
    assert parquet_io.infer_splits(["a.parquet", "b.parquet"]) == {
        "train": ["a.parquet", "b.parquet"]}


# ------------------------------------------------------- committed fixtures
@pytest.mark.parametrize("rel", sorted(DIGESTS["tables"]))
def test_committed_tables_equal_pyarrow_and_their_digest(rel):
    path = os.path.join(FIXTURES, rel)
    rows = _rows(parquet_io.read_parquet(path))
    assert rows == pq.read_table(path).to_pylist()
    assert fixtures.rows_digest(rows) == DIGESTS["tables"][rel]


@pytest.mark.parametrize("config", ["EVQA_data", "EVQA_passages"])
def test_load_hf_yaml_layout_equals_jax(offline_datasets, config):
    from reranking_multimodal_retrievers_tpu.data.ops import m2kr_ops as jax_ops
    from reranking_multimodal_retrievers_tpu_torch.data.ops import m2kr_ops

    path = f"{SNAPSHOT}///{config}"
    want, got = jax_ops._load_hf(path), m2kr_ops._load_hf(path)
    assert list(got) == list(want)
    for split in want:
        assert _rows(got[split]) == _hf_rows(want[split]), split
    if config == "EVQA_data":
        assert [len(got[s]) for s in got] == [1024, 256, 256]


def test_load_hf_subfolder_layout_equals_jax(offline_datasets):
    """Without README configs the text after ``///`` is a sub-directory
    whose files are named into splits by ``datasets``' rule, as the JAX
    package's ``_load_hf`` loads that sub-directory."""
    from reranking_multimodal_retrievers_tpu.data.ops import m2kr_ops as jax_ops
    from reranking_multimodal_retrievers_tpu_torch.data.ops import m2kr_ops

    root = offline_datasets / "snap"
    shutil.copytree(SNAPSHOT, root, ignore=shutil.ignore_patterns("README.md"))
    for config in ("EVQA_data", "EVQA_passages"):
        want = jax_ops._load_hf(str(root / config))
        got = m2kr_ops._load_hf(f"{root}///{config}")
        assert list(got) == list(want) == ["train", "validation", "test"]
        for split in want:
            assert _rows(got[split]) == _hf_rows(want[split]), (config, split)
        again = m2kr_ops._load_hf(str(root / config))
        assert {k: _rows(v) for k, v in again.items()} == {k: _rows(v) for k, v in got.items()}
    with pytest.raises(NotImplementedError, match="hub ids need the network"):
        m2kr_ops._load_hf(f"{root}///EVQA_missing")


def test_load_preprocessed_data_equals_jax(offline_datasets):
    """configs/evqa_flmr.json's LoadM2KR node over the snapshot, with
    shuffling, row selection, sampled instructions and an image root."""
    from reranking_multimodal_retrievers_tpu.data.ops.m2kr_ops import (
        LoadPreprocessedData as JaxLoad)
    from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import LoadPreprocessedData

    kwargs = dict(data_path=f"{SNAPSHOT}///EVQA_data", passage_path=f"{SNAPSHOT}///EVQA_passages",
                  image_root_folder=fixtures.IMAGES, shuffle_splits=["train"],
                  num_data={"train": 300, "valid": -1}, num_passages=1000,
                  add_instruction=["Look at the image:", "Answer this."])
    out = {}
    for cls in (JaxLoad, LoadPreprocessedData):
        node = cls(use_dummy_data=False)
        node.setup(**kwargs)
        out[cls] = node(None)
    want, got = out[JaxLoad], out[LoadPreprocessedData]
    assert list(got) == list(want)
    for split in want:
        assert _rows(got[split]) == _hf_rows(want[split]), split
    assert len(got["train"]) == 300 and len(got["test_passages"]) == 1000
    assert all(os.path.exists(p) for p in got["test"]["img_path"])


def test_prepare_cc_images_reads_parquet_as_datasets(offline_datasets, monkeypatch):
    from reranking_multimodal_retrievers_tpu.tools import prepare_cc_images as jax_tool
    from reranking_multimodal_retrievers_tpu_torch.tools import prepare_cc_images

    path = str(offline_datasets / "cc.parquet")
    table = pa.table({"image_id": [f"im{i}" for i in range(57)],
                      "image_url": [None if i % 9 == 4 else f"https://example.invalid/{i}.jpg"
                                    for i in range(57)],
                      "caption": [f"a photo {i}" for i in range(57)]})
    pq.write_table(table, path, row_group_size=20)
    seen = {}
    for mod in (jax_tool, prepare_cc_images):
        def record(rows, images_dir, mod=mod, **kw):
            seen[mod] = list(rows)
            return {"saved": [], "failed": [], "skipped": 0}

        monkeypatch.setattr(mod, "fetch_images", record)
        mod.main([path, str(offline_datasets / "images")])
    assert seen[prepare_cc_images] == seen[jax_tool]
    assert len(seen[jax_tool]) == 57 and seen[jax_tool][4][1] is None


def test_fixtures_read_with_pyarrow_datasets_yaml_and_pil_blocked():
    """Every committed table (the ZSTD, LZ4 and delta/BSS ones too) and
    image (the WebPs too) read to its committed digest, and the snapshot's
    configs loaded (also from its re-encoded copy), in a process that
    cannot import pyarrow, ``datasets``, PyYAML, PIL or ``zstandard``."""
    code = (
        "import json, os, sys\n"
        "for m in ('pyarrow', 'datasets', 'yaml', 'PIL', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {FIXTURES!r})\n"
        "import make_m2kr_parquet as fx\n"
        "from reranking_multimodal_retrievers_tpu_torch.data import image_io, parquet_io\n"
        "from reranking_multimodal_retrievers_tpu_torch.data.ops.m2kr_ops import _load_hf\n"
        "d = json.load(open(fx.DIGESTS))\n"
        "for rel, want in d['tables'].items():\n"
        "    t = parquet_io.read_parquet(os.path.join(fx.HERE, rel))\n"
        "    assert fx.rows_digest([t[i] for i in range(len(t))]) == want, rel\n"
        "for name, want in d['images'].items():\n"
        "    got = image_io.read_image(os.path.join(fx.IMAGES, name))\n"
        "    assert fx.pixels_digest(got) == want, name\n"
        "for key, root in (('webp_images', fx.WEBP), ('m2kr_images_webp', fx.IMAGES_WEBP)):\n"
        "    for name, want in d[key].items():\n"
        "        got = image_io.read_image(os.path.join(root, name))\n"
        "        assert fx.pixels_digest(got) == want, name\n"
        "assert _load_hf(fx.SNAPSHOT_V2 + '///EVQA_data') == _load_hf(fx.SNAPSHOT + '///EVQA_data')\n"
        "q = _load_hf(fx.SNAPSHOT + '///EVQA_data')\n"
        "p = _load_hf(fx.SNAPSHOT + '///EVQA_passages')\n"
        "print(json.dumps({k: len(v) for k, v in {**q, **p}.items()}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "train": 1024, "valid": 256, "test": 256, "train_passages": 4096,
        "valid_passages": 2048, "test_passages": 2048}
