"""The port stands alone: it imports no JAX, flax, optax, orbax, transformers,
datasets, PIL, safetensors (``models/checkpoint_dir.py`` reads the format
itself), tests or the JAX package, it imports with those modules
blocked, and its entry points (the CLI, ``Experiment`` and the executors
among them) refuse to fall back to the CPU when CUDA is absent. The two
exceptions are imports inside a function: ``transformers`` in
``models/tokenization.py``, where an HF tokenizer is built (the data
pipeline builds the port's own WordPiece tokenizer), and ``PIL`` in
``data/image_io.py``, for an image format other than the PNGs it reads
itself."""

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
             "reranking_multimodal_retrievers_tpu", "datasets", "PIL", "safetensors"}
# imports allowed inside a function body (not at module level) of a file
LAZY_ALLOWED = {PORT / "models" / "tokenization.py": {"transformers"},
                PORT / "data" / "image_io.py": {"PIL"}}


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
        "for m in ('jax', 'flax', 'optax', 'orbax', 'transformers', 'datasets', 'PIL',\n"
        "          'safetensors', 'reranking_multimodal_retrievers_tpu'):\n"
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
