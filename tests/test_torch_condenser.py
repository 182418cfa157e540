"""The port's Baleen condenser (``engine/condenser.py``) against the JAX
package's, on the CPU, with the same weights (carried by
``models/weights.py::sentence_reader_state_dict``) and
``tests/test_condenser.py``'s whitespace ``[MASK]``-separator tokenizer.

Tolerances: ``SentenceReader`` scores within 1e-5 (relative and absolute):
fp32 round-off through one BERT layer and the head, as in the port's other
BERT parity tests; padded sentence slots are -inf on both sides. The
condenser's facts and the engine's pids are compared exactly: they follow
from the scores' order, and the scores of these seeded inputs lie far apart
(no near-tie).
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from reranking_multimodal_retrievers_tpu.engine import condenser as jcond  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine.index import TokenIndex as JTokenIndex  # noqa: E402
from reranking_multimodal_retrievers_tpu.engine.search import Searcher as JSearcher  # noqa: E402
from reranking_multimodal_retrievers_tpu.models.bert import BertConfig as JBertConfig  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine import condenser  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.index import TokenIndex  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.engine.search import Searcher  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.bert import BertConfig  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.models.weights import (  # noqa: E402
    sentence_reader_state_dict,
)
from test_condenser import MAX_SENTS, MAXLEN, _ws_tokenize  # noqa: E402

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=1024, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
           intermediate_size=64, max_position_embeddings=MAXLEN)
ROWS = [
    {"pid": 0, "title": "alpha", "text": ["fact one about cats", "irrelevant filler words here"]},
    {"pid": 1, "title": "beta", "text": ["fact two about dogs", "more filler text"]},
    {"pid": 2, "title": "gamma", "text": ["nothing useful at all"]},
    {"pid": 3, "title": "delta", "text": ["cats and dogs together", "a third line", "a fourth"]},
]


def reader_pair(learn_labels=False, seed=0):
    """JAX SentenceReader, its params, and the port's with the same weights."""
    jm = jcond.SentenceReader(JBertConfig(**CFG), learn_labels=learn_labels)
    ids, am, tt, sp = _ws_tokenize(["warm up"], ["a [MASK] b"])
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(am),
                                    jnp.asarray(tt), jnp.asarray(sp))["params"])
    tm = condenser.SentenceReader(BertConfig(**CFG), learn_labels=learn_labels, device="cpu")
    tm.load_state_dict(sentence_reader_state_dict(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    path = tmp_path_factory.mktemp("baleen") / "collectionX.jsonl"
    with open(path, "w") as f:
        for r in ROWS:
            f.write(json.dumps(r) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def condensers(collection):
    """The JAX condenser and the port's (stage 1 and stage 2 readers of
    different weights, as the reference's two checkpoints)."""
    j1, p1, t1 = reader_pair(seed=0)
    _, p2, _ = reader_pair(seed=1)
    cfg = dict(stage1_topk=4, max_sentences=MAX_SENTS, maxlen=MAXLEN)
    jc = jcond.Condenser(collection, p1, p2, j1, _ws_tokenize, jcond.CondenserConfig(**cfg))
    tc = condenser.Condenser(collection, sentence_reader_state_dict(p1),
                             sentence_reader_state_dict(p2), t1, _ws_tokenize,
                             condenser.CondenserConfig(**cfg))
    return jc, tc, (p1, p2)


@pytest.mark.parametrize("learn_labels", [False, True], ids=["sentences", "cls_labels"])
def test_sentence_reader_matches_jax(learn_labels):
    jm, params, tm = reader_pair(learn_labels)
    ids, am, tt, sp = _ws_tokenize(["what about cats", "q"],
                                   ["alpha [MASK] s1 [MASK] s2", "beta [MASK] one [MASK] two "
                                    "[MASK] three"])
    want = np.asarray(jm.apply({"params": params}, *(jnp.asarray(a) for a in (ids, am, tt, sp))))
    with torch.no_grad():
        got = tm(*(torch.as_tensor(a).long() for a in (ids, am, tt, sp))).numpy()
    assert got.shape == want.shape == ((2,) if learn_labels else (2, MAX_SENTS))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **SCORE_TOL)
    if not learn_labels:
        assert finite[0, :2].all() and finite[1, :3].all() and not finite[0, 2:].any()


def test_condenser_collections_match(condensers):
    jc, tc, _ = condensers
    assert tc.collectionX == jc.collectionX and tc.collectionY == jc.collectionY


@pytest.mark.parametrize("query,backs,ranking", [
    ("what about cats", [], [0, 1, 2, 3]),
    ("dogs", [(1, 0)], [0, 2]),
    ("cats and dogs", [(3, 2), (0, 1)], [3, 1, 0]),
])
def test_condense_matches_jax(condensers, query, backs, ranking):
    jc, tc, _ = condensers
    want = jc.condense(query, backs, ranking)
    got = tc.condense(query, backs, ranking)
    assert got == want
    stage1, _, l3x = got
    assert 0 < len(stage1) <= 4 and len(stage1) == len(set(stage1))
    assert len(condenser._dedupe([pid for pid, _ in l3x])) <= tc.config.max_docs
    assert stage1[:len(backs)] == [tuple(b) for b in backs]


def test_condenser_takes_modules(condensers, collection):
    """Readers passed as two modules give the state dicts' results (the
    state dicts are loaded into the condenser's ``model``, so each module
    here is a fresh one)."""
    _, tc, params = condensers
    t1, t2 = (condenser.SentenceReader(BertConfig(**CFG), device="cpu") for _ in params)
    for module, p in zip((t1, t2), params):
        module.load_state_dict(sentence_reader_state_dict(p))
    by_module = condenser.Condenser(collection, t1, t2, None, _ws_tokenize, tc.config)
    assert by_module.condense("what about cats", [], [0, 1, 2, 3]) == tc.condense(
        "what about cats", [], [0, 1, 2, 3])


def _indexes():
    """One token index of random unit vectors over the four pids, in each
    package, and one query matrix a hop."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(4, 6, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    mask = np.ones((4, 6), bool)
    ids = [str(r["pid"]) for r in ROWS]
    Qs = [rng.normal(size=(1, 3, 16)).astype(np.float32) for _ in range(2)]
    return (JTokenIndex.from_arrays(emb, mask, ids),
            TokenIndex.from_arrays(emb, mask, ids, device="cpu"), Qs)


def test_baleen_two_hops_match_jax(condensers):
    """Two hops over a real searcher on each side (exact MaxSim over the same
    index; the port's on the CPU), per-hop k (3 then 2): the same facts,
    positive facts and pids."""
    jc, tc, _ = condensers
    jindex, tindex, Qs = _indexes()
    hops = {"j": [], "t": []}

    def encoder(side, to):
        def encode(text, facts):
            hops[side].append(list(facts))
            return to(Qs[len(hops[side]) - 1])
        return encode

    hop_cfg = dict(per_hop_k=(3, 2))
    want = jcond.BaleenEngine(jcond.HopSearcher(JSearcher(jindex, k=4), jcond.HopConfig(**hop_cfg)),
                              jc, encoder("j", jnp.asarray), num_hops=2).search("cats and dogs")
    got = condenser.BaleenEngine(
        condenser.HopSearcher(Searcher(tindex, k=4), condenser.HopConfig(**hop_cfg)),
        tc, encoder("t", torch.as_tensor), num_hops=2).search("cats and dogs")
    assert got == want and hops["t"] == hops["j"]
    assert set(got) == {"facts", "positive_facts", "pids"} and got["pids"]
    assert all(k in tc.collectionY for k in got["facts"])


def test_hop_searcher_per_hop_k():
    class Fake:
        def search(self, Q):
            return [["1", "0", "2"]], np.asarray([[3.0, 2.0, 1.0]])

    hs = condenser.HopSearcher(Fake(), condenser.HopConfig(per_hop_k=(2, 1)))
    assert len(hs.search(None, hop=0)[0][0]) == 2 and len(hs.search(None, hop=5)[0][0]) == 1
    assert condenser.BaleenEngine._default_docid_to_pid("d12") == 12
    assert condenser.BaleenEngine._default_docid_to_pid("x") is None
