"""The kernels refuse a gradient they cannot give. K1, K2 and K3 have no
backward (the JAX package's Pallas kernels have none: ``jax.grad`` through
them raises), so each wrapper raises ``NotImplementedError`` when grad mode
is on and an input requires grad, on the CPU (where it would take its
differentiable plain version) as on the card, and runs under
``torch.no_grad()`` / ``inference_mode()``. A model with
``use_pallas_attention`` therefore trains only with it off, as in the JAX
package. The card's side is in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig, BertModel  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.attention_cuda import (  # noqa: E402
    fused_self_attention)
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_cuda import maxsim_scores  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops.maxsim_int8_cuda import (  # noqa: E402
    maxsim_scores_int8)


def _calls(requires_grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 128, generator=g, requires_grad=requires_grad)
               for _ in range(3))
    Q = torch.randn(2, 5, 16, generator=g, requires_grad=requires_grad)
    D = torch.randn(3, 7, 16, generator=g)
    Qq = torch.randint(-127, 128, (2, 5, 32), dtype=torch.int8, generator=g)
    Dq = torch.randint(-127, 128, (3, 7, 32), dtype=torch.int8, generator=g)
    qs = torch.rand(2, 5, generator=g, requires_grad=requires_grad)
    return {
        "K2 fused_self_attention": lambda: fused_self_attention(q, k, v, num_heads=2,
                                                                sm_scale=0.125),
        "K1 maxsim_scores": lambda: maxsim_scores(Q, D),
        "K3 maxsim_scores_int8": lambda: maxsim_scores_int8(Qq, qs, Dq, torch.rand(3)),
    }


@pytest.mark.parametrize("kernel", list(_calls(False)))
def test_wrapper_raises_under_grad_and_runs_without(kernel):
    with pytest.raises(NotImplementedError, match="no backward"):
        _calls(True)[kernel]()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert _calls(True)[kernel]().grad_fn is None
    # inputs that need no gradient pass with grad mode on
    assert _calls(False)[kernel]().grad_fn is None


def test_bert_with_the_kernel_trains_only_with_it_off():
    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
    ids = torch.randint(1, 1000, (2, 9))
    am = torch.ones(2, 9, dtype=torch.long)
    fused = BertModel(BertConfig.tiny(use_pallas_attention=True, **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="use_pallas_attention=False"):
        fused(ids, am)
    plain = BertModel(BertConfig.tiny(**kw), device="cpu")
    plain.load_state_dict(fused.state_dict())
    plain(ids, am)["last_hidden_state"].sum().backward()
    assert plain.encoder.layer[0].attention.self.query.weight.grad.abs().sum() > 0
    with torch.no_grad():
        assert torch.allclose(fused(ids, am)["last_hidden_state"],
                              plain(ids, am)["last_hidden_state"], atol=1e-5)
