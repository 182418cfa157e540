"""The port stands alone: it imports no JAX, flax, transformers, tests or the
JAX package, it imports with those modules blocked, and its entry points
refuse to fall back to the CPU when CUDA is absent."""

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
FORBIDDEN = {"jax", "flax", "transformers", "tests", "reranking_multimodal_retrievers_tpu"}


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
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
        "for m in ('jax', 'flax', 'transformers', 'reranking_multimodal_retrievers_tpu'):\n"
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


def test_default_device_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from reranking_multimodal_retrievers_tpu_torch.engine import (
        HostTokenIndex, QuantizedTokenIndex, StreamingSearcher, TokenIndex, encode_corpus)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        BertConfig, BertModel, CLIPVisionConfig, CLIPVisionModel, FLMRConfig,
        FLMRModelForRetrieval)
    from reranking_multimodal_retrievers_tpu_torch.models import (
        Blip2Config, Blip2ForConditionalGeneration, OPTConfig, OPTForCausalLM, T5Config,
        T5ForConditionalGeneration)
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        Blip2DecoderHeadRerankModel, Blip2DecoderRerankModel, Blip2RerankConfig,
        DecoderHeadRerankModel, DecoderRerankConfig, DecoderRerankModel,
        FullContextRerankModel, RerankConfig)
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
