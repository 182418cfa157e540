"""The port's FLMR training forward (``FLMRModelForRetrieval.forward``: the
aligned CE loss, the in-batch-negative loss and their gradients) against the
JAX package's, at the flagship config of ``__graft_entry__.py`` and its
example batch (B = 2, nway 2, L_q 16, L_d 32, 64-px images), the same
weights carried by ``models/weights.py``.

Both sides in fp32 on the CPU (JAX at matmul precision "highest").
Tolerances: ``loss``, ``ib_loss`` and ``scores`` within 1e-5 (relative and
absolute): fp32 round-off through two BERT layers, two ViT layers and the
mapping network, summed over ~40 query tokens in another order. Gradients of
``ib_loss`` per parameter within 1e-4 of that parameter's largest |g|: the
backward doubles the depth the round-off runs through, and small entries of
a leaf carry the round-off of its large ones. A leaf whose gradient is 0 in
exact arithmetic (a key bias: the softmax ignores a shift shared by every
key) holds round-off alone, of the size of its neighbours' gradients times
fp32's 1e-7: its floor is 1e-4 of 1e-3 of the model's largest |g|.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from reranking_multimodal_retrievers_tpu.models import flmr as jflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu.ops import maxsim as jmaxsim  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import bert as tbert  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import vit as tvit  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models import weights  # noqa: E402

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


def port_config(jcfg):
    """The port's FLMRConfig with every field of the JAX one."""
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["text_config"] = tbert.BertConfig(**dataclasses.asdict(jcfg.text_config))
    d["vision_config"] = tvit.CLIPVisionConfig(**dataclasses.asdict(jcfg.vision_config))
    return tflmr.FLMRConfig(**d)


def flagship_pair(mask_doc=None):
    """JAX model, its params, the port model with the same weights, and the
    example batch as numpy arrays. ``mask_doc``: a context row made all
    padding (ids 0, mask 0)."""
    jcfg = graft._flagship_config()
    batch = {k: np.array(v) for k, v in graft._example_batch().items()}
    if mask_doc is not None:
        batch["context_input_ids"][mask_doc] = 0
        batch["context_attention_mask"][mask_doc] = 0
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch)["params"])
    tm = tflmr.FLMRModelForRetrieval(port_config(jcfg), device="cpu")
    tm.load_state_dict(weights.flmr_state_dict(params))
    return jm, params, tm, batch


def torch_batch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind in "iu" else torch.tensor(v)
            for k, v in batch.items()}


def assert_grads_match(model, jax_grads, rel=GRAD_REL):
    """Every parameter's gradient (a parameter the loss does not reach has
    none on the port's side, 0 on JAX's) within ``rel`` of its leaf's max."""
    want = {k: v.numpy() for k, v in weights.flmr_state_dict(jax_grads).items()}
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = named[name].grad
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), floor),
                                   err_msg=name)


@pytest.mark.parametrize("mask_doc", [None, 1], ids=["example_batch", "fully_masked_doc"])
def test_flmr_training_forward_and_grads_match_jax(mask_doc):
    jm, params, tm, batch = flagship_pair(mask_doc)
    want = jm.apply({"params": params}, **batch, num_negative_examples=1)
    jgrads = jax.grad(lambda p: jm.apply({"params": p}, **batch, num_negative_examples=1)
                      .in_batch_negative_loss)(params)

    out = tm(**torch_batch(batch), num_negative_examples=1)
    D = out.context_late_interaction_output
    D.retain_grad()
    out.in_batch_negative_loss.backward()
    for got, w in ((out.loss, want.loss), (out.in_batch_negative_loss,
                                           want.in_batch_negative_loss),
                   (out.scores, want.scores)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), **VALUE_TOL)
    assert out.scores.shape == (2, 2) and out.scores_raw.shape == want.scores_raw.shape
    np.testing.assert_array_equal(out.context_mask.numpy(), np.asarray(want.context_mask))
    assert_grads_match(tm, jgrads)
    if mask_doc is not None:
        # the doc's rows are zero before normalisation; nothing reaches them,
        # on either side
        assert not out.context_mask[mask_doc].any()
        assert torch.equal(D.grad[mask_doc], torch.zeros_like(D.grad[mask_doc]))
        labels = jnp.arange(2) * 2

        def head(d):
            s = jmaxsim.in_batch_maxsim_scores(want.query_late_interaction_output, d,
                                               want.context_mask)
            return jflmr._softmax_ce(s, labels)

        jd = np.asarray(jax.grad(head)(want.context_late_interaction_output))
        assert (jd[mask_doc] == 0).all()
        np.testing.assert_allclose(D.grad.numpy(), jd, rtol=0,
                                   atol=GRAD_REL * float(np.abs(jd).max()))


def test_l2_normalize_zero_row_gradient():
    """A zero row stays zero and passes a zero upstream gradient as exactly
    0 (no NaN), as the JAX ``_l2_normalize``."""
    x = torch.zeros(3, 4)
    x[0] = torch.tensor([3.0, 4.0, 0.0, 0.0])
    x.requires_grad_(True)
    y = tflmr._l2_normalize(x)
    g = torch.zeros(3, 4)
    g[0] = 1.0
    y.backward(g)
    jx = jax.grad(lambda v: jnp.sum(jflmr._l2_normalize(v) * jnp.asarray(g.numpy())))(
        jnp.asarray(x.detach().numpy()))
    assert torch.equal(y[1:].detach(), torch.zeros(2, 4))
    assert torch.equal(x.grad[1:], torch.zeros(2, 4))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_in_batch_negatives", [True, False])
def test_forward_options(use_in_batch_negatives):
    _, _, tm, batch = flagship_pair()
    with torch.no_grad():
        out = tm(**torch_batch(batch), num_negative_examples=1,
                 use_in_batch_negatives=use_in_batch_negatives)
    assert (out.in_batch_negative_loss is not None) == use_in_batch_negatives
    with pytest.raises(TypeError):  # the port gathers over a process group: gather_group
        tm(**torch_batch(batch), gather_axis_name="data")
