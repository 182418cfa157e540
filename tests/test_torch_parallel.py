"""The port's several-device layer (``parallel/``: the mesh, the launcher,
tensor parallelism; the sharded train step, in-batch negatives, index,
search and rerank) against the JAX package's mesh programs, on 4 gloo ranks
of this CPU.

One module-scoped spawn of 4 ranks (``parallel/launch.py``, a ``file://``
store under ``tmp_path``, ``OMP_NUM_THREADS=1``, its own hard timeout) runs
every case; the parent holds the ranks' results against the JAX package on
the same numpy inputs and weights (``models/weights.py``). This module
imports JAX only inside the parent's functions, so that the ranks, which
import it to run :func:`_rank_cases`, never do.

Tolerances: the train steps as ``tests/test_tensor_parallel.py:85-98``
(losses rtol 2e-5, updated leaves atol 2e-5 / rtol 1e-4); the gathered
in-batch loss and its gradients as ``tests/test_torch_flmr_train.py`` (1e-5,
and 1e-4 of each leaf's largest gradient); the sharded search as
``__graft_entry__.py:258,285`` (ids equal, values atol 0.25 bf16 / 1e-4
int8); the rerank pad path as ``tests/test_rerank_eval.py:62-80`` (2e-4);
the decoder dp x tp scoring at 2e-5.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu_torch.parallel import launch  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore")
RANKS = 4
RANK_TIMEOUT = 240
CLIP = 3e-5  # small enough that Adam's eps makes the update depend on the clip
TRAIN_CASES = [  # (n_data, n_model, optimizer, grad_clip, frozen patterns)
    (4, 1, "AdamW", None, ()),
    (2, 2, "AdamW", None, ()),
    (2, 2, "AdamW", CLIP, ()),
    (2, 2, "Adafactor", None, ()),
    # the port only (the JAX package's TP placement refuses the frozen
    # leaves' optimizer state): the losses of case 1, the tower bitwise
    (2, 2, "AdamW", None, ("vision_encoder",)),
]
LEAVES = ("context_text_encoder_linear.weight",
          "context_text_encoder.bert_model.encoder.layer.0.attention.self.query.weight")


# ---------------------------------------------------------------- the ranks

def _flmr(inputs):
    from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr

    m = tflmr.FLMRModelForRetrieval(inputs["flmr_cfg"], device="cpu")
    m.load_state_dict(inputs["flmr_sd"])
    return m


def _train_case(inputs, mesh, opt, clip, frozen):
    from reranking_multimodal_retrievers_tpu_torch.parallel import (shard_batch,
                                                                    tp_shard_module)
    from reranking_multimodal_retrievers_tpu_torch.parallel.tensor_parallel import gather_param
    from reranking_multimodal_retrievers_tpu_torch.training import TrainState, make_train_step
    from reranking_multimodal_retrievers_tpu_torch.training.optimization import make_optimizer

    m = _flmr(inputs)
    o, s, _ = make_optimizer(m, optimizer_name=opt, lr=1e-3, scheduler="constant",
                             num_training_steps=10, frozen_patterns=frozen, grad_clip=clip)
    tp = mesh.n_model > 1
    if tp:
        tp_shard_module(mesh, m, o)
    before = {n: p.detach().clone() for n, p in m.named_parameters() if "vision_encoder" in n}
    step = make_train_step(m, o, s, mesh=mesh, tensor_parallel=tp)
    st, met = step(TrainState.create(m, o, s), shard_batch(mesh, inputs["flmr_batch"]))
    named = dict(m.named_parameters())
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "leaves": {n: gather_param(named[n]).detach().clone() for n in LEAVES},
           "frozen_bitwise": all(torch.equal(named[n], v) for n, v in before.items()),
           "query_local_rows": int(named[LEAVES[1]].shape[0])}
    # one NaN-pixel batch, on one data shard only: every rank skips it
    bad = dict(inputs["flmr_batch"])
    bad["query_pixel_values"] = bad["query_pixel_values"].copy()
    bad["query_pixel_values"][0] = np.nan
    snapshot = {n: p.detach().clone() for n, p in named.items()}
    st, met = step(st, shard_batch(mesh, bad))
    out["nan_skipped"] = float(met["grads_finite"]) == 0.0 and all(
        torch.equal(named[n], v) for n, v in snapshot.items())
    return out


def _gathered_ib(inputs, mesh):
    from reranking_multimodal_retrievers_tpu_torch.parallel import shard_batch
    from reranking_multimodal_retrievers_tpu_torch.training.train_state import average_grads

    m = _flmr(inputs)
    out = m(**shard_batch(mesh, inputs["flmr_batch"]), num_negative_examples=1,
            gather_group=mesh.data_group)
    out.in_batch_negative_loss.backward()
    average_grads(m, mesh)
    return {"ib_loss": float(out.in_batch_negative_loss.detach()),
            "grads": {n: p.grad.detach().clone() for n, p in m.named_parameters()
                      if p.grad is not None}}


def _search(inputs, mesh):
    from reranking_multimodal_retrievers_tpu_torch.engine import (QuantizedTokenIndex,
                                                                  TokenIndex)
    from reranking_multimodal_retrievers_tpu_torch.engine.search import (make_search_fn,
                                                                         make_search_fn_int8)

    s = inputs["search"]
    index = TokenIndex.from_arrays(s["emb"], s["mask"], s["doc_ids"], mesh=mesh)
    qindex = QuantizedTokenIndex.from_token_index(index)
    Q = torch.as_tensor(s["Q"])
    v, i = make_search_fn(index.num_padded_docs, s["k"], mesh=mesh)(
        Q.to(torch.bfloat16), *index.search_arrays)
    qv, qi = make_search_fn_int8(qindex.num_padded_docs, s["k"], mesh=mesh)(
        Q, *qindex.search_arrays)
    from reranking_multimodal_retrievers_tpu_torch.engine import Searcher, encode_corpus
    from reranking_multimodal_retrievers_tpu_torch.engine.compress import pool_index

    loaded = TokenIndex.load(s["dir"], device="cpu", mesh=mesh)
    qloaded = QuantizedTokenIndex.load(s["qdir"], device="cpu", mesh=mesh)
    n = len(s["doc_ids"])
    enc = encode_corpus(lambda b: (torch.as_tensor(s["emb"][b]), torch.as_tensor(s["mask"][b])),
                        [np.arange(i, min(i + 8, n)) for i in range(0, n, 8)], s["doc_ids"],
                        device="cpu", mesh=mesh)
    pooled = pool_index(index)
    index.save(s["dir"] + "_sharded")
    qindex.save(s["qdir"] + "_sharded")
    whole = index.gathered()
    return {"bf16": (v.numpy(), i.numpy()), "int8": (qv.numpy(), qi.numpy()),
            "gathered": (whole.embeddings.float().numpy(), whole.mask.numpy()),
            "local_docs": int(index.embeddings.shape[0]),
            "num_padded_docs": index.num_padded_docs,
            "block": (index.embeddings.float().numpy(), index.mask.numpy()),
            "loaded": (loaded.embeddings.float().numpy(), loaded.mask.numpy()),
            "qloaded": (qloaded.codes.numpy(), qloaded.scales.numpy(), qloaded.mask.numpy()),
            "encoded": (enc.embeddings.float().numpy(), enc.mask.numpy()),
            "pooled": (pooled.embeddings.float().numpy(), pooled.mask.numpy(),
                       pooled.mesh is mesh),
            "searcher": Searcher(index, k=s["k"]).search(Q.to(torch.bfloat16))[0]}


def _rerank(inputs, mesh):
    from reranking_multimodal_retrievers_tpu_torch.engine import make_chunked_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        FullContextRerankModel)

    r = inputs["rerank"]
    model = FullContextRerankModel(r["cfg"], device="cpu")
    model.load_state_dict(r["sd"])
    fn = make_chunked_rerank_fn(model.eval(), nway=r["K"], chunk_size=6, mesh=mesh)
    return fn(*(torch.as_tensor(x) for x in (r["ids"], r["am"], r["tt"], r["pix"]))).numpy()


def _decoder(inputs, key, mesh):
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        Blip2DecoderRerankModel)
    from reranking_multimodal_retrievers_tpu_torch.parallel import shard_batch, tp_shard_module
    from reranking_multimodal_retrievers_tpu_torch.parallel.mesh import all_gather, all_reduce
    from reranking_multimodal_retrievers_tpu_torch.parallel.tensor_parallel import gather_param
    from reranking_multimodal_retrievers_tpu_torch.training.train_state import average_grads

    d = inputs[key]
    model = Blip2DecoderRerankModel(d["cfg"], device="cpu")
    model.load_state_dict(d["sd"])
    tp_shard_module(mesh, model)
    local = shard_batch(mesh, {k: d[k] for k in ("ids", "am", "pix")})
    out = model(local["ids"].long(), local["am"], local["pix"],
                num_negative_examples=d["nway"] - 1)
    out.loss.backward()
    average_grads(model, mesh)
    grads = {n: gather_param(p, p.grad).clone() for n, p in model.named_parameters()
             if p.grad is not None}
    logits = all_gather(out.logits.detach().reshape(-1, d["nway"]), mesh.data_group)
    loss = all_reduce(out.loss.detach(), mesh.data_group) / mesh.n_data
    p_yes = make_decoder_rerank_fn(model.eval(), chunk_size=2, mesh=mesh)(
        *(torch.as_tensor(d[k]) for k in ("ids", "am")), torch.as_tensor(d["pix"][:1]))
    return {"logits": logits.numpy(), "loss": float(loss), "p_yes": p_yes.numpy(),
            "q_rows": _q_rows(model), "grads": grads}


def _q_rows(model):
    """The rows of the first decoder layer's q projection this rank holds."""
    return next(int(p.shape[0]) for n, p in model.named_parameters()
                if n.endswith(("self_attn.q_proj.weight", "SelfAttention.q.weight")))


def _rank_cases(path):
    """Every case, on one rank of the 4; the parent compares."""
    import torch.distributed as dist

    from reranking_multimodal_retrievers_tpu_torch.parallel import make_mesh

    with open(path, "rb") as f:
        inputs = pickle.load(f)
    res = {"rank": dist.get_rank()}
    overask = []
    for kw in ({"n_data": RANKS + 1}, {"n_data": RANKS, "n_model": 2}):
        try:
            make_mesh(**kw)
        except ValueError as e:
            overask.append(str(e))
    res["overask"] = overask
    dp, tp = make_mesh(n_data=RANKS), make_mesh(n_data=2, n_model=2)
    meshes = {(4, 1): dp, (2, 2): tp}
    res["train"] = [_train_case(inputs, meshes[(nd, nm)], opt, clip, frozen)
                    for nd, nm, opt, clip, frozen in TRAIN_CASES]
    res["ib"] = _gathered_ib(inputs, dp)
    res["search"] = _search(inputs, dp)
    res["rerank"] = _rerank(inputs, dp)
    res["dec_opt"] = _decoder(inputs, "dec_opt", tp)
    res["dec_t5"] = _decoder(inputs, "dec_t5", tp)
    if res["rank"]:  # rank 0 carries the large results; the others their checks
        for key in ("ib",):
            res.pop(key)
    return res


# ---------------------------------------------------------------- the parent

def _flagship():
    import jax

    import __graft_entry__ as graft
    from reranking_multimodal_retrievers_tpu.models import flmr as jflmr
    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from test_torch_flmr_train import port_config

    jcfg = graft._flagship_config()
    batch = {k: np.array(v) for k, v in graft._example_batch(B=4).items()}
    jm = jflmr.FLMRModelForRetrieval(jcfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), **batch)["params"])
    return jm, params, batch, port_config(jcfg), weights.flmr_state_dict(params)


def _decoder_inputs(opt: bool):
    import jax

    from reranking_multimodal_retrievers_tpu.models.blip2 import Blip2Config
    from reranking_multimodal_retrievers_tpu.models.opt import OPTConfig
    from reranking_multimodal_retrievers_tpu.models.rerankers import decoder as jdec
    from reranking_multimodal_retrievers_tpu.models.t5 import T5Config
    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import decoder as tdec
    from test_torch_blip2 import port_blip2_config
    from test_torch_t5 import nonzero_lora

    blip2 = (Blip2Config.tiny_opt(text_config=OPTConfig.tiny(lora_r=4)) if opt
             else Blip2Config.tiny(text_config=T5Config.tiny(lora_r=4)))
    jcfg = jdec.Blip2RerankConfig.tiny(blip2=blip2)
    jm = jdec.Blip2DecoderRerankModel(jcfg)
    B, nway, L = 4, 2, 10
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 60, size=(B * nway, L)).astype(np.int32)
    am = np.ones((B * nway, L), np.int32)
    am[1, 7:] = 0
    pix = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    params = nonzero_lora(jax.device_get(jm.init(
        jax.random.PRNGKey(0), ids, am, pix, num_negative_examples=nway - 1)["params"]), rng)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["blip2"] = port_blip2_config(jcfg.blip2)
    return jm, params, {"cfg": tdec.Blip2RerankConfig(**d),
                        "sd": weights.blip2_rerank_state_dict(params),
                        "ids": ids, "am": am, "pix": pix, "nway": nway}


def _rerank_inputs():
    import jax

    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from test_rerank_eval import _tiny_rerank_setup
    from test_torch_rerank_train import _port_rerank_config

    B, K, L = 3, 2, 16
    model, params, ids, am, tt, pix = _tiny_rerank_setup(B, K, L)
    params = jax.device_get(params)
    return model, params, {"cfg": _port_rerank_config(model.config),
                           "sd": weights.rerank_state_dict(params), "K": K,
                           "ids": np.asarray(ids), "am": np.asarray(am), "tt": np.asarray(tt),
                           "pix": np.asarray(pix)}


def _search_inputs():
    rng = np.random.default_rng(0)
    N, Ld, dim, B, Lq = 45, 12, 32, 3, 6  # 45 docs: padded to 48 over 4 ranks
    emb = rng.normal(size=(N, Ld, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    mask = rng.random((N, Ld)) < 0.8
    mask[:, 0] = True
    emb *= mask[..., None]
    Q = rng.normal(size=(B, Lq, dim)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    return {"emb": emb, "mask": mask, "doc_ids": [f"d{i}" for i in range(N)], "Q": Q, "k": 10}


def _save_search_index(s, tmp):
    """The one-process bf16 and int8 indexes of ``s`` saved for the ranks'
    ``load(mesh=...)`` (45 rows: the ranks pad them)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import QuantizedTokenIndex, TokenIndex

    index = TokenIndex.from_arrays(s["emb"], s["mask"], s["doc_ids"], device="cpu")
    s["dir"], s["qdir"] = str(tmp / "index"), str(tmp / "qindex")
    index.save(s["dir"])
    QuantizedTokenIndex.from_token_index(index).save(s["qdir"])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX models that made them, and the 4 ranks' results."""
    tmp = tmp_path_factory.mktemp("ranks")
    jm, params, batch, pcfg, psd = _flagship()
    rr_model, rr_params, rr = _rerank_inputs()
    jopt, popt, dopt = _decoder_inputs(opt=True)
    jt5, pt5, dt5 = _decoder_inputs(opt=False)
    inputs = {"flmr_cfg": pcfg, "flmr_sd": psd, "flmr_batch": batch,
              "search": _search_inputs(), "rerank": rr, "dec_opt": dopt, "dec_t5": dt5}
    _save_search_index(inputs["search"], tmp)
    path = str(tmp / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    results = launch.spawn(_rank_cases, RANKS, (path,), device_type="cpu",
                           timeout=RANK_TIMEOUT, env={"OMP_NUM_THREADS": "1"},
                           store_dir=str(tmp))
    return {"flmr": (jm, params, batch), "rerank": (rr_model, rr_params, rr),
            "dec_opt": (jopt, popt, dopt), "dec_t5": (jt5, pt5, dt5),
            "inputs": inputs, "results": results}


def test_make_mesh_rejects_overask_as_jax(world):
    for res in world["results"]:
        assert len(res["overask"]) == 2
        for msg in res["overask"]:
            assert "devices" in msg and "available" in msg


def test_pad_to_multiple_matches_jax():
    from reranking_multimodal_retrievers_tpu.parallel import pad_to_multiple as jpad
    from reranking_multimodal_retrievers_tpu_torch.parallel import pad_to_multiple

    rng = np.random.default_rng(0)
    for n, mult, axis in ((5, 4, 0), (8, 4, 0), (3, 8, 1), (1, 1, 0)):
        shape = [2, 3]
        shape[axis] = n
        x = rng.normal(size=shape)
        got, got_n = pad_to_multiple(x, mult, axis=axis, fill=-1)
        want, want_n = jpad(x, mult, axis=axis, fill=-1)
        assert got_n == want_n
        np.testing.assert_array_equal(got, np.asarray(want))


def _spec_markers(tree, spec_of):
    """Each leaf of a JAX params tree replaced by an array that counts along
    its model-split axis (zeros where it is replicated)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from reranking_multimodal_retrievers_tpu.parallel.mesh import MODEL_AXIS

    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        spec = spec_of(path, leaf)
        a = np.zeros(np.shape(leaf), np.float32)
        if spec != P():
            axis = list(spec).index(MODEL_AXIS)
            shape = [1] * a.ndim
            shape[axis] = a.shape[axis]
            a = a + np.arange(1, a.shape[axis] + 1, dtype=np.float32).reshape(shape)
        leaves.append(a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _split_dim(t):
    t = t.float()
    if not t.any():
        return None
    varying = [d for d in range(t.ndim) if t.shape[d] > 1 and not torch.equal(
        t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(varying) == 1, varying
    return varying[0]


@pytest.mark.parametrize("family", ["flmr", "opt_lora", "t5_lora"])
def test_partition_spec_matches_jax_leaf_by_leaf(family):
    """The port's split of every parameter is JAX ``tp_describe``'s, carried
    through the function that carries the weights across: a marker array
    counting along JAX's split axis lands on the port's split dim."""
    from reranking_multimodal_retrievers_tpu.parallel import tp_partition_spec
    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        Blip2DecoderRerankModel)
    from reranking_multimodal_retrievers_tpu_torch.parallel.tensor_parallel import split_dims

    if family == "flmr":
        _, params, _, pcfg, _ = _flagship()
        sd = weights.flmr_state_dict(_spec_markers(params, tp_partition_spec))
        from reranking_multimodal_retrievers_tpu_torch.models import flmr as tflmr

        model = tflmr.FLMRModelForRetrieval(pcfg, device="cpu")
    else:
        _, params, d = _decoder_inputs(opt=family == "opt_lora")
        sd = weights.blip2_rerank_state_dict(_spec_markers(params, tp_partition_spec))
        model = Blip2DecoderRerankModel(d["cfg"], device="cpu")
    dims = split_dims(model)
    assert set(sd) == set(dims)
    split = 0
    for name, marker in sd.items():
        want = _split_dim(marker)
        assert dims[name] == want, name
        split += want is not None
    assert split > 10


def test_dp_and_dp_tp_train_steps_match_jax(world):
    """dp 4 and dp 2 x tp 2, AdamW with and without the global-norm clip and
    Adafactor at dp x tp: the losses and updated leaves of the JAX package's
    ``make_train_step(mesh=...)``; the frozen vision tower bitwise; a
    NaN-pixel batch on one shard skipped by every rank."""
    import jax

    from reranking_multimodal_retrievers_tpu.parallel import (make_mesh, replicate,
                                                              shard_batch, tp_shard_tree)
    from reranking_multimodal_retrievers_tpu.training import (TrainState, make_optimizer,
                                                              make_train_step)
    from reranking_multimodal_retrievers_tpu_torch.models import weights

    jm, params, batch = world["flmr"]

    def apply_fn(p, **kw):
        return jm.apply({"params": p}, **kw)

    for case, (nd, nm, opt, clip, frozen) in enumerate(TRAIN_CASES):
        if frozen:  # the losses of the unfrozen step; the tower unchanged
            for res in world["results"]:
                got = res["train"][case]
                assert got["metrics"] == res["train"][1]["metrics"]
                assert got["frozen_bitwise"] and got["nan_skipped"], case
                assert not res["train"][1]["frozen_bitwise"]
            continue
        tx, _ = make_optimizer(params, optimizer_name=opt, lr=1e-3, scheduler="constant",
                               num_warmup_steps=0, num_training_steps=10, grad_clip=clip)
        if opt == "Adafactor":
            # the JAX package's tp_shard_tree cannot place optax.adafactor's
            # state (its (1,)-shaped placeholder moments of unfactored
            # leaves); its data-parallel step is the reference
            nd, nm = nd * nm, 1
        mesh = make_mesh(n_data=nd, n_model=nm)
        p0 = jax.tree_util.tree_map(np.asarray, params)
        step = make_train_step(apply_fn, tx, mesh=mesh, loss_key="ib_loss",
                               tensor_parallel=nm > 1)
        st = (tp_shard_tree(mesh, TrainState.create(p0, tx)) if nm > 1
              else replicate(mesh, TrainState.create(p0, tx)))
        st, m = step(st, shard_batch(mesh, batch))
        want = {k: v.numpy() for k, v in
                weights.flmr_state_dict(jax.device_get(st.params)).items()}
        for res in world["results"]:
            got = res["train"][case]
            for key in ("total_loss", "loss", "ib_loss"):
                np.testing.assert_allclose(got["metrics"][key], float(m[key]), rtol=2e-5,
                                           err_msg=f"{case} {key}")
            assert got["metrics"]["grads_finite"] == 1.0
            for name in LEAVES:
                np.testing.assert_allclose(got["leaves"][name].numpy(), want[name], atol=2e-5,
                                           rtol=1e-4, err_msg=f"{case} {name}")
            assert got["nan_skipped"], case
            full = want[LEAVES[1]].shape[0]
            assert got["query_local_rows"] == full // TRAIN_CASES[case][1]
    for res in world["results"]:  # the clip moves the update well past the tolerance
        a, b = (res["train"][c]["leaves"][LEAVES[0]] for c in (1, 2))
        assert float((a - b).abs().max()) > 1e-4


def test_gathered_in_batch_loss_and_grads_match_jax(world):
    """FLMR's in-batch loss over the 4 ranks' gathered Q, D and D_mask and
    its data-averaged gradients: JAX ``forward(gather_axis_name=...)`` under
    ``shard_map``, the gradients averaged over the axis."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from reranking_multimodal_retrievers_tpu.parallel import make_mesh
    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from test_torch_flmr_train import GRAD_REL, VALUE_TOL

    jm, params, batch = world["flmr"]
    mesh = make_mesh(n_data=RANKS)

    def per_shard(p, b):
        def loss(pp):
            return jm.apply({"params": pp}, **b, num_negative_examples=1,
                            gather_axis_name="data").in_batch_negative_loss
        value, grads = jax.value_and_grad(loss)(p)
        return value, jax.lax.pmean(grads, "data")

    value, grads = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P(), P("data")),
                                     out_specs=(P(), P()), check_vma=False))(params, batch)
    res = world["results"][0]["ib"]
    np.testing.assert_allclose(res["ib_loss"], float(value), **VALUE_TOL)
    want = {k: v.numpy() for k, v in weights.flmr_state_dict(jax.device_get(grads)).items()}
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = res["grads"].get(name)
        g = np.zeros(w.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * max(float(np.abs(w).max()), floor),
                                   err_msg=name)


def test_sharded_search_matches_jax(world):
    """The bf16 and int8 searches over a 45-doc index padded to 48 and
    sharded over 4 ranks: JAX ``make_search_fn(mesh, ...)`` with
    ``use_pallas=False``; every rank holds 12 docs and the same result."""
    import jax.numpy as jnp

    from reranking_multimodal_retrievers_tpu.engine.index import QuantizedTokenIndex as JQ
    from reranking_multimodal_retrievers_tpu.engine.index import TokenIndex as JT
    from reranking_multimodal_retrievers_tpu.engine.search import (make_search_fn,
                                                                   make_search_fn_int8)
    from reranking_multimodal_retrievers_tpu.parallel import make_mesh

    s = world["inputs"]["search"]
    mesh = make_mesh(n_data=RANKS)
    index = JT.from_arrays(s["emb"], s["mask"], s["doc_ids"], mesh=mesh)
    qindex = JQ.from_token_index(index)
    Q = jnp.asarray(s["Q"])
    v, i = make_search_fn(mesh, index.num_padded_docs, s["k"], use_pallas=False)(
        Q.astype(index.embeddings.dtype), index.embeddings, index.mask)
    qv, qi = make_search_fn_int8(mesh, qindex.num_padded_docs, s["k"], use_pallas=False)(
        Q.astype(jnp.float32), qindex.codes, qindex.scales, qindex.mask)
    for res in world["results"]:
        got = res["search"]
        assert got["num_padded_docs"] == index.num_padded_docs == 48
        assert got["local_docs"] == 12
        np.testing.assert_array_equal(got["bf16"][1], np.asarray(i))
        np.testing.assert_allclose(got["bf16"][0], np.asarray(v), rtol=0, atol=0.25)
        np.testing.assert_array_equal(got["int8"][1], np.asarray(qi))
        np.testing.assert_allclose(got["int8"][0], np.asarray(qv), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got["bf16"][1], world["results"][0]["search"]["bf16"][1])


def test_sharded_index_load_encode_pool_and_searcher(world):
    """Each rank's block of the index as ``from_arrays``, ``load`` (of a
    one-process save, 45 rows padded to 48), ``QuantizedTokenIndex.load``,
    ``encode_corpus`` over its batches and ``pool_index`` give it, against
    the rows of the one-process index; ``Searcher`` over the sharded index
    returns the one-process doc ids."""
    from reranking_multimodal_retrievers_tpu_torch.engine import (QuantizedTokenIndex, Searcher,
                                                                  TokenIndex, encode_corpus)
    from reranking_multimodal_retrievers_tpu_torch.engine.compress import pool_index

    s = world["inputs"]["search"]
    whole = TokenIndex.from_arrays(s["emb"], s["mask"], s["doc_ids"], device="cpu",
                                   pad_multiple=RANKS)
    qwhole = QuantizedTokenIndex.from_token_index(whole)
    pooled = pool_index(whole)
    n = len(s["doc_ids"])
    encoded = encode_corpus(lambda b: (torch.as_tensor(s["emb"][b]), torch.as_tensor(s["mask"][b])),
                            [np.arange(i, min(i + 8, n)) for i in range(0, n, 8)], s["doc_ids"],
                            device="cpu", pad_multiple=RANKS)
    ids = Searcher(whole, k=s["k"]).search(torch.as_tensor(s["Q"]).to(torch.bfloat16))[0]
    for res in world["results"]:
        got = res["search"]
        rows = slice(res["rank"] * 12, (res["rank"] + 1) * 12)
        for key, ref in (("block", whole), ("loaded", whole), ("encoded", encoded)):
            np.testing.assert_array_equal(got[key][0], ref.embeddings[rows].float().numpy(),
                                          err_msg=key)
            np.testing.assert_array_equal(got[key][1], ref.mask[rows].numpy(), err_msg=key)
        for g, w in zip(got["qloaded"], (qwhole.codes[rows], qwhole.scales[rows],
                                         qwhole.mask[rows])):
            np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(got["pooled"][0], pooled.embeddings[rows].float().numpy())
        np.testing.assert_array_equal(got["pooled"][1], pooled.mask[rows].numpy())
        assert got["pooled"][2] and got["searcher"] == ids


def test_sharded_save_and_gathered_match_one_process(tmp_path, world):
    """The 4 ranks' ``save`` of the sharded bf16 and int8 indexes (each
    rank writes its block) gives the files of the one-process index padded
    to 48 docs, byte for byte; ``gathered`` gives every rank that index in
    host memory."""
    import filecmp

    from reranking_multimodal_retrievers_tpu_torch.engine import QuantizedTokenIndex, TokenIndex

    s = world["inputs"]["search"]
    whole = TokenIndex.from_arrays(s["emb"], s["mask"], s["doc_ids"], device="cpu",
                                   pad_multiple=RANKS)
    whole.save(str(tmp_path / "index"))
    QuantizedTokenIndex.from_token_index(whole).save(str(tmp_path / "qindex"))
    for name, files in (("index", ("embeddings.npy", "mask.npy", "meta.json")),
                        ("qindex", ("codes.npy", "scales.npy", "mask.npy", "meta.json"))):
        sharded = s["dir" if name == "index" else "qdir"] + "_sharded"
        assert sorted(os.listdir(sharded)) == sorted(files)
        match, mismatch, errors = filecmp.cmpfiles(str(tmp_path / name), sharded, files,
                                                   shallow=False)
        assert (mismatch, errors) == ([], []), name
    for res in world["results"]:
        emb, mask = res["search"]["gathered"]
        np.testing.assert_array_equal(emb, whole.embeddings.float().numpy())
        np.testing.assert_array_equal(mask, whole.mask.numpy())


def test_rerank_pad_path_matches_jax(world):
    """B*K = 6 rows on 4 ranks: chunks of 4 rows, 2 of them padding, the
    logits of JAX's mesh program on ``tests/test_rerank_eval.py``'s model."""
    from reranking_multimodal_retrievers_tpu.engine.rerank_eval import (
        make_chunked_rerank_fn as jfn)
    from reranking_multimodal_retrievers_tpu.parallel import make_mesh

    model, params, r = world["rerank"]
    want = np.asarray(jfn(model, nway=r["K"], chunk_size=6, mesh=make_mesh(n_data=RANKS))(
        params, r["ids"], r["am"], r["tt"], r["pix"]))
    for res in world["results"]:
        assert res["rerank"].shape == (3, 2)
        np.testing.assert_allclose(res["rerank"], want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("key", ["dec_opt", "dec_t5"])
def test_decoder_dp_tp_scoring_matches_jax(world, key):
    """BLIP-2 over OPT and over Flan-T5 (LoRA r 4, non-zero adapters) split
    over 2 model ranks, rows over 2 data ranks: the logits and loss of the
    JAX model on one device; ``make_decoder_rerank_fn`` over the mesh gives
    the one-process p(yes)."""
    from reranking_multimodal_retrievers_tpu_torch.engine import make_decoder_rerank_fn
    from reranking_multimodal_retrievers_tpu_torch.models.rerankers import (
        Blip2DecoderRerankModel)

    jm, params, d = world[key]
    want = jm.apply({"params": params}, d["ids"], d["am"], d["pix"],
                    num_negative_examples=d["nway"] - 1)
    model = Blip2DecoderRerankModel(d["cfg"], device="cpu")
    model.load_state_dict(d["sd"])
    p_yes = make_decoder_rerank_fn(model.eval(), chunk_size=2)(
        *(torch.as_tensor(d[k]) for k in ("ids", "am")), torch.as_tensor(d["pix"][:1])).numpy()
    for res in world["results"]:
        got = res[key]
        np.testing.assert_allclose(got["logits"].reshape(-1), np.asarray(want.logits).reshape(-1),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got["loss"], float(want.loss), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got["p_yes"], p_yes, atol=2e-5, rtol=2e-5)
        assert got["q_rows"] * 2 == _q_rows(model)  # half the heads on each model rank


@pytest.mark.parametrize("key", ["dec_opt", "dec_t5"])
def test_decoder_dp_tp_grads_match_jax(world, key):
    """The gradients of the same dp 2 x tp 2 loss, averaged over the data
    ranks and gathered over the model ranks: ``jax.grad`` of the JAX
    model's loss over the global batch, on every rank. Flan-T5's one-row
    cross-attention reads its split K/V weights without their layers, so a
    missing all-reduce there shows in the encoder's and V LoRA's
    gradients."""
    import jax

    from reranking_multimodal_retrievers_tpu_torch.models import weights
    from test_torch_flmr_train import GRAD_REL

    jm, params, d = world[key]

    def loss(p):
        return jm.apply({"params": p}, d["ids"], d["am"], d["pix"],
                        num_negative_examples=d["nway"] - 1).loss

    want = {k: v.numpy() for k, v in
            weights.blip2_rerank_state_dict(jax.device_get(jax.grad(loss)(params))).items()}
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for res in world["results"]:
        got = res[key]["grads"]
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                       atol=GRAD_REL * max(float(np.abs(w).max()), floor),
                                       err_msg=f"rank {res['rank']} {name}")


# ---------------------------------------------------------------- the CLI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, n_devices, *opts):
    from reranking_multimodal_retrievers_tpu_torch.cli.main import main

    argv = ["--config", os.path.join(ROOT, "configs", "okvqa_flmr.json"), "--mode", "train",
            "--use_dummy_data", "--opts", f"meta.EXPERIMENT_FOLDER='{tmp_path}/experiments'",
            f"data_pipeline.cache_dir='{tmp_path}/cache'", "train.trainer_paras.max_epochs=1",
            "train.trainer_paras.limit_train_batches=2", "train.trainer_paras.log_every_n_steps=1",
            "valid.trainer_paras.limit_val_batches=0", *opts]
    if n_devices:
        argv += ["--n_devices", str(n_devices)]
    assert main(argv) == 0
    with open(os.path.join(tmp_path, "experiments", "okvqa_flmr", "version_0",
                           "metrics.jsonl")) as f:
        import json

        return [json.loads(line) for line in f]


def test_cli_n_devices_2_matches_one_process(tmp_path, monkeypatch):
    """``--n_devices 2`` on the CPU: 2 gloo ranks train 2 steps, with the
    first step's losses those of one process over the same global batch;
    only rank 0 writes (one metrics line a step, one checkpoint). Above the
    card count (none here) without ``RMRT_PLATFORM=cpu`` it raises. The
    CLI's run has no deadline; here its launch gets the test's."""
    monkeypatch.setenv("RMRT_PLATFORM", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spawn = launch.spawn
    monkeypatch.setattr(launch, "spawn",
                        lambda *a, **kw: spawn(*a, **{**kw, "timeout": RANK_TIMEOUT}))
    monkeypatch.chdir(tmp_path)
    one = _cli(tmp_path / "one", None)
    two = _cli(tmp_path / "two", 2)
    assert [m["step"] for m in two] == [1, 2]
    for key in ("loss", "ib_loss", "total_loss"):
        np.testing.assert_allclose(two[0][key], one[0][key], rtol=1e-5, err_msg=key)
    exp = tmp_path / "two" / "experiments" / "okvqa_flmr" / "version_0"
    assert sorted(os.listdir(exp / "ckpts")) == ["index.json", "step_2"]
    assert not (tmp_path / "two" / "experiments" / "okvqa_flmr" / "version_1").exists()
    monkeypatch.delenv("RMRT_PLATFORM")
    if torch.cuda.is_available():
        pytest.skip("cards are present: the overask needs more ranks than cards")
    with pytest.raises(ValueError, match="devices"):
        _cli(tmp_path / "three", 2)
