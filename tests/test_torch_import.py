"""The port stands alone: it imports no JAX, flax, optax, orbax, transformers,
datasets, pyarrow, pandas, PIL, safetensors (``models/checkpoint_dir.py``
reads and writes the format itself), tests or the JAX package, it imports
with those modules blocked, with them blocked it reads a ``save_to_disk``
directory, decodes a baseline JPEG and runs the tiny ``prepare_data``
pipeline of ``tests/test_torch_data_ops_real.py``, and its entry points
(the CLI, ``Experiment`` and the executors among them) refuse to fall back
to the CPU when CUDA is absent. The exceptions are imports inside a
function: ``transformers`` in ``models/tokenization.py``, where a test's
HF tokenizer is built (the port builds its own WordPiece tokenizer), and
``PIL`` in ``data/image_io.py``, for an image format other than the PNGs
and sequential JPEGs it reads itself, and in ``data/ops/wit_ops.py``, for
the offline re-encoding of ``ConvertWITImagePixels`` and the header check
of a format other than PNG and JPEG, and in ``tools/prepare_cc_images.py``,
which writes the fetched images as JPEGs. Every ``tools/`` module runs
with ``jax``, ``flax`` and ``transformers`` blocked, the network tools with
an injected fetcher and hub API."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "reranking_multimodal_retrievers_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = {"jax", "flax", "optax", "orbax", "transformers", "tests",
             "reranking_multimodal_retrievers_tpu", "datasets", "pyarrow", "pandas", "PIL",
             "safetensors"}
BLOCKED = ("jax", "flax", "optax", "orbax", "transformers", "datasets", "pyarrow", "pandas",
           "PIL", "safetensors", "reranking_multimodal_retrievers_tpu")
# imports allowed inside a function body (not at module level) of a file
LAZY_ALLOWED = {PORT / "models" / "tokenization.py": {"transformers"},
                PORT / "data" / "image_io.py": {"PIL"},
                PORT / "data" / "ops" / "wit_ops.py": {"PIL"},
                PORT / "tools" / "prepare_cc_images.py": {"PIL"}}


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _roots(nodes):
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _imported_roots(path):
    """The roots a file imports, less those it may import lazily, which
    count only where they are imported outside a function body."""
    tree = ast.parse(path.read_text(), str(path))
    roots = _roots(ast.walk(tree))
    lazy = LAZY_ALLOWED.get(path, set())
    if lazy:
        in_functions = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_functions |= {id(n) for n in ast.walk(fn)}
        outside = _roots(n for n in ast.walk(tree) if id(n) not in in_functions)
        roots -= lazy - outside
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def _modules():
    return [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in sorted(PORT.rglob("*.py"))]


def test_port_and_chip_smoke_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print('imported')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "imported"


def test_real_data_path_runs_with_those_modules_blocked(tmp_path, monkeypatch):
    """An Arrow directory read, a baseline JPEG decoded and the tiny
    phase-13 ``prepare_data`` pipeline run (captioner, ViT features, the
    live teacher) in a process where none of them can be imported; the
    inputs are written here, with ``datasets``, PIL and JAX."""
    pytest.importorskip("jax")
    pytest.importorskip("datasets")
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from test_torch_data_ops_real import _slice_config
    finally:
        sys.path.pop(0)
    monkeypatch.setenv("RMRT_PLATFORM", "cpu")
    config = _slice_config(tmp_path)
    work = tmp_path / "work"
    work.mkdir()
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from reranking_multimodal_retrievers_tpu_torch.data import arrow_io, image_io\n"
        f"d = arrow_io.load_from_disk({str(tmp_path / 'm2kr' / 'EVQA_data')!r})\n"
        "jpg = [p for p in d['train']['img_path'] if p.endswith('.jpg')][0]\n"
        "assert image_io._jpeg_frame(open(jpg, 'rb').read()) is not None\n"
        "assert image_io.read_image(jpg).shape == (32, 32, 3)\n"
        f"fx = np.load({str(ROOT / 'tests' / 'fixtures' / 'baseline_420_rst.pil.npy')!r})\n"
        f"assert (image_io.read_image({str(ROOT / 'tests' / 'fixtures' / 'baseline_420_rst.jpg')!r})"
        " == fx).all()\n"
        "from reranking_multimodal_retrievers_tpu_torch.cli.main import main\n"
        f"assert main(['--config', {config!r}, '--mode', 'prepare_data']) == 0\n"
        "print('ran', len(d['train']))\n"
    )
    env = {**os.environ, "RMRT_PLATFORM": "cpu", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=work, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ran 6"
    assert any(n.startswith("process__Distill-") for n in os.listdir(work / "cache"))


TOOLS_RUN = r"""
import json, os, pickle, sys
for m in ("jax", "flax", "optax", "orbax", "transformers", "reranking_multimodal_retrievers_tpu"):
    sys.modules[m] = None
import numpy as np
import torch
from reranking_multimodal_retrievers_tpu_torch.models import FLMRConfig, FLMRModelForRetrieval
from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig
from reranking_multimodal_retrievers_tpu_torch.models.checkpoint_dir import write_safetensors
from reranking_multimodal_retrievers_tpu_torch.models.tokenization import (
    WordPieceTokenizer, write_test_vocab)
from reranking_multimodal_retrievers_tpu_torch.tools import (
    analysis, convert_checkpoint, eval_evqa, prepare_cc_images, reduce_retrieval_file,
    submit_jobs, upload_model_to_hub)

work = sys.argv[1]
tok = WordPieceTokenizer(write_test_vocab(os.path.join(work, "vocab.txt"), ["cat", "dog"]))
bem = eval_evqa.BEMScorer(tok, bert_config=BertConfig.tiny(type_vocab_size=4), device="cpu")
ex = {"question": "what", "reference": "cat", "candidate": "dog", "question_type": "automatic"}
assert 0.0 <= bem(ex, threshold_score=False) <= 1.0
assert eval_evqa.evqa_scores(["paris", "roma"], ["paris", "rome"])["evqa_accuracy"] == 0.5

entry = {"question_id": "q", "pos_item_ids": ["a"], "answers": ["a"],
         "top_ranking_passages": [{"passage_id": "a", "content": "x a", "score": 1.0}],
         "raw_top_ranking_passages": [{"passage_id": "b", "content": "x b", "score": 1.0}]}
assert analysis.mcnemar_test([entry], k=1)["c"] == 1
dump = os.path.join(work, "dump.json")
with open(dump, "w") as f:
    json.dump({"predictions": [entry]}, f)
with open(reduce_retrieval_file.reduce_retrieval_file(dump), "rb") as f:
    assert "content" not in pickle.load(f)["predictions"][0]["top_ranking_passages"][0]

cfg = FLMRConfig.tiny()
hf = os.path.join(work, "hf")
os.makedirs(hf)
write_safetensors(os.path.join(hf, "model.safetensors"),
                  FLMRModelForRetrieval(cfg, device="cpu").state_dict())
config = os.path.join(work, "flmr.json")
with open(config, "w") as f:
    json.dump({"model_config": {"flmr": {"text_config": {"vocab_size": 1024, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
        "max_position_embeddings": 128}, "vision_config": {"hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "image_size": 32, "patch_size": 16}, "dim": 16, "mapping_network_prefix_length": 4,
        "use_transformer_mapping_network": True}}}, f)
out = convert_checkpoint.convert_torch_to_port(hf, os.path.join(work, "port"), config)
npz = convert_checkpoint.export_npz(os.path.join(out, "params"), os.path.join(work, "p.npz"))
assert "context_text_encoder/embeddings/word_embeddings/embedding" in np.load(npz).files

job = submit_jobs.render_job("configs/okvqa_flmr.json", "test", "smoke", dummy=True,
                             out_dir=os.path.join(work, "jobs"))
assert "reranking_multimodal_retrievers_tpu_torch.cli.main" in open(job).read()

calls = []
class Api:
    def create_repo(self, **kw):
        calls.append(kw)
    def upload_folder(self, **kw):
        calls.append(kw)
assert upload_model_to_hub.upload_folder(work, "org/m", api=Api()) == "org/m" and len(calls) == 2
got = prepare_cc_images.fetch_images([("a", "u/a"), ("b", "u/b")], os.path.join(work, "img"),
                                     num_threads=2, fetch_fn=lambda url: None)
assert got["failed"] == ["a", "b"]
print("tools ran")
"""


def test_tools_run_with_jax_flax_and_transformers_blocked(tmp_path):
    """Every ``tools/`` module in a process where JAX, flax, optax, orbax,
    transformers and the JAX package cannot be imported: the EVQA scores and
    a tiny BEM scorer (the port's own WordPiece tokenizer), the analysis of
    a dump, its reduction, a tiny FLMR directory converted and exported to
    ``.npz``, a job script, and the hub and image tools with injected
    fakes."""
    out = subprocess.run([sys.executable, "-c", TOOLS_RUN, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "RMRT_PLATFORM": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "tools ran"


def test_default_device_entry_points_refuse_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    monkeypatch.delenv("RMRT_PLATFORM", raising=False)
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main
    from reranking_multimodal_retrievers_tpu_torch.executors import (FLMRExecutor, RagExecutor,
                                                                     RerankerExecutor)
    from reranking_multimodal_retrievers_tpu_torch.executors.experiment import Experiment
    from reranking_multimodal_retrievers_tpu_torch.utils import ConfigDict
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        HostTokenIndex, QuantizedTokenIndex, StreamingSearcher, TokenIndex, encode_corpus)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, BertModel, CLIPVisionConfig, CLIPVisionModel, FLMRConfig,
        FLMRModelForRetrieval)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        Blip2Config, Blip2ForConditionalGeneration, OPTConfig, OPTForCausalLM, T5Config,
        T5ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.models import legacy_retrievers as leg
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        Blip2DecoderHeadRerankModel, Blip2DecoderRerankModel, Blip2RerankConfig,
        DecoderHeadRerankModel, DecoderRerankConfig, DecoderRerankModel,
        FullContextRerankModel, InteractionRerankConfig, InteractionRerankModel,
        RerankConfig)
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers.decoder import (
        VisionSeq2SeqLM)
    from reranking_multimodal_retrievers_tpu_torch.serving import RerankService
    from reranking_multimodal_retrievers_tpu_torch.ops.preprocess import (
        CLIPImageProcessorDevice, preprocess_images)
    from reranking_multimodal_retrievers_tpu_torch.tools.eval_evqa import BEMScorer

    calls = [
        lambda: BertModel(BertConfig.tiny()),
        lambda: CLIPVisionModel(CLIPVisionConfig.tiny()),
        lambda: FLMRModelForRetrieval(FLMRConfig.tiny()),
        lambda: FullContextRerankModel(RerankConfig.tiny()),
        lambda: TokenIndex.from_arrays(torch.zeros(2, 3, 8), torch.ones(2, 3, dtype=torch.bool),
                                       ["a", "b"]),
        lambda: encode_corpus(lambda b: b, [], []),
        lambda: QuantizedTokenIndex.from_arrays(np.zeros((2, 3, 32)), np.ones((2, 3), bool),
                                                ["a", "b"]),
        lambda: StreamingSearcher(HostTokenIndex(np.zeros((2, 3, 32), np.float16), None)),
        lambda: RerankService(lambda *a: None, nway=2),
        lambda: T5ForConditionalGeneration(T5Config.tiny()),
        lambda: OPTForCausalLM(OPTConfig.tiny()),
        lambda: Blip2ForConditionalGeneration(Blip2Config.tiny()),
        lambda: DecoderRerankModel(DecoderRerankConfig.tiny()),
        lambda: DecoderHeadRerankModel(DecoderRerankConfig.tiny()),
        lambda: Blip2DecoderRerankModel(Blip2RerankConfig.tiny()),
        lambda: Blip2DecoderHeadRerankModel(Blip2RerankConfig.tiny()),
        lambda: InteractionRerankModel(InteractionRerankConfig.tiny()),
        lambda: InteractionRerankModel(InteractionRerankConfig.tiny(interaction_type="MORES")),
        lambda: leg.VisualColBERT.build(BertConfig.tiny(), CLIPVisionConfig.tiny()),
        lambda: leg.VisualDPR(leg.DPRConfig.tiny(use_vision=True)),
        lambda: leg.RetrieverDPR(leg.DPRConfig.tiny()),
        lambda: leg.RetrieverT5(leg.DPRConfig.tiny()),
        lambda: leg.VisualColBERTMultipleMapping(leg.MultiMappingConfig.tiny()),
        lambda: leg.VisualColBERTMAE(leg.MAERetrieverConfig.tiny()),
        lambda: leg.VisualDPRForRAG(leg.DPRConfig.tiny(), 24),
        lambda: main(["--config", str(ROOT / "configs" / "okvqa_flmr.json"), "--mode", "train",
                      "--use_dummy_data"]),
        lambda: Experiment(ConfigDict()),
        lambda: FLMRExecutor(ConfigDict()),
        lambda: RerankerExecutor(ConfigDict()),
        lambda: RagExecutor(ConfigDict()),
        lambda: VisionSeq2SeqLM(DecoderRerankConfig.tiny()),
        lambda: CLIPImageProcessorDevice(),
        lambda: preprocess_images(np.zeros((1, 8, 8, 3), np.uint8), image_size=4),
        lambda: BEMScorer(None, bert_config=BertConfig.tiny(type_vocab_size=4)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    """With no CUDA device, and alone in a directory, the script exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, SMOKE), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_lazy_import_exception_is_narrow(tmp_path):
    """Only a function-level import of ``transformers`` in the tokenization
    module is let through: a module-level one there is still caught."""
    tok = PORT / "models" / "tokenization.py"
    assert "transformers" not in _imported_roots(tok)
    assert "transformers" in _roots(ast.walk(ast.parse(tok.read_text())))
    moved = "from transformers import BertTokenizerFast\n" + tok.read_text()
    LAZY_ALLOWED[tmp_path / "t.py"] = LAZY_ALLOWED[tok]
    try:
        (tmp_path / "t.py").write_text(moved)
        assert "transformers" in _imported_roots(tmp_path / "t.py")
    finally:
        del LAZY_ALLOWED[tmp_path / "t.py"]


def test_lazy_pil_import_is_narrow(tmp_path):
    """Only a function-level import of ``PIL`` in ``data/image_io.py`` is
    let through: a module-level one there is still caught, and the synthetic
    data (its own PNGs) is read without PIL."""
    img = PORT / "data" / "image_io.py"
    assert "PIL" not in _imported_roots(img)
    assert "PIL" in _roots(ast.walk(ast.parse(img.read_text())))
    LAZY_ALLOWED[tmp_path / "i.py"] = LAZY_ALLOWED[img]
    try:
        (tmp_path / "i.py").write_text("from PIL import Image\n" + img.read_text())
        assert "PIL" in _imported_roots(tmp_path / "i.py")
    finally:
        del LAZY_ALLOWED[tmp_path / "i.py"]
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from reranking_multimodal_retrievers_tpu_torch.data import image_io\n"
        f"p = {str(tmp_path / 'k.png')!r}\n"
        "a = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)\n"
        "image_io.write_png(p, a)\n"
        "assert (image_io.read_image(p) == a).all()\n"
        "print(image_io.CLIPImageProcessor(4)([a]).shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "(1, 3, 4, 4)"
