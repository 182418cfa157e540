"""Triples trainer for the retrieval engine (port of ``engine/trainer.py``).

The role of the ColBERT engine's trainer: train a late-interaction retriever
from ``Examples`` triples + ``Queries`` + ``Collection``, with

- softmax-CE over ``nway`` passages (positive first) when the triples carry
  bare pids, or KL-distillation against
  ``log_softmax(target_scores * distillation_alpha)`` when they carry
  ``[pid, score]`` pairs;
- an optional in-batch-negative loss added on top;
- the JAX package's schedule: a linear warmup over ``warmup or 1`` steps,
  then a linear decay to 0 over ``maxsteps - (warmup or 0)`` steps (the
  ``optax.join_schedules`` branch its optax takes; with ``warmup`` 0 or
  None the first step still runs at lr 0);
- AdamW as ``optax.adamw(schedule, eps=1e-8)``: weight decay 1e-4 on every
  parameter;
- an EMA-smoothed train loss with mu = 0.999, and periodic checkpoints
  through ``training.CheckpointManager``.

With ``mesh`` (``parallel/``) every rank reads the same triples, keeps its
rows of each batch, and steps data-parallel: the in-batch negatives span
the global batch, the gradients are averaged over the data group, and the
loss reported is the global batch's. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..training.checkpointing import CheckpointManager
from ..training.optimization import Schedule, _join, _linear
from ..training.train_state import TrainState, apply_update
from .data import Collection, Examples, Queries

logger = logging.getLogger(__name__)

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclasses.dataclass
class TriplesTrainerConfig:
    """The trainer-relevant slice of ColBERT's settings
    (`colbert/infra/config/settings.py:96-165`)."""

    bsize: int = 8
    nway: int = 2
    lr: float = 3e-6
    warmup: Optional[int] = 20
    maxsteps: int = 100
    use_ib_negatives: bool = False
    ignore_scores: bool = False
    distillation_alpha: float = 1.0
    query_maxlen: int = 32
    doc_maxlen: int = 180
    seed: int = 12345
    checkpoint_dir: Optional[str] = None
    save_every: Optional[int] = None


class LazyBatcher:
    """Assemble (query texts, passage texts, target scores) batches from
    triples — the reference ``LazyBatcher``
    (`colbert/training/lazy_batcher.py`) without its per-rank process split:
    pass ``shard/nshards`` only for multi-host input feeding."""

    def __init__(self, triples, queries, collection, bsize: int, nway: int,
                 shard: Optional[int] = None, nshards: Optional[int] = None):
        self.examples = Examples.cast(triples, nway=nway).tolist(shard, nshards)
        self.queries = Queries.cast(queries)
        self.collection = Collection.cast(collection)
        self.bsize = bsize
        self.nway = nway

    def __iter__(self) -> Iterator[Tuple[List[str], List[str], Optional[np.ndarray]]]:
        for start in range(0, len(self.examples) - self.bsize + 1, self.bsize):
            chunk = self.examples[start : start + self.bsize]
            q_texts: List[str] = []
            p_texts: List[str] = []
            scores: List[float] = []
            have_scores = True
            for ex in chunk:
                qid, passages = ex[0], ex[1 : self.nway + 1]
                q_texts.append(self.queries[qid])
                for p in passages:
                    if isinstance(p, (list, tuple)):
                        pid, s = p[0], float(p[1])
                        scores.append(s)
                    else:
                        pid, have_scores = p, False
                    p_texts.append(self.collection[int(pid)])
            target = (
                np.asarray(scores, np.float32).reshape(self.bsize, self.nway)
                if have_scores and scores
                else None
            )
            yield q_texts, p_texts, target

    def __len__(self):
        return len(self.examples) // self.bsize


def triples_schedule(lr: float, warmup: Optional[int], maxsteps: int) -> Schedule:
    """The JAX trainer's ``join_schedules`` branch: 0 -> ``lr`` over
    ``warmup or 1`` steps, then ``lr`` -> 0 over
    ``max(maxsteps - (warmup or 0), 1)`` steps."""
    boundary = warmup or 1
    return _join(_linear(0.0, lr, boundary),
                 _linear(lr, 0.0, max(maxsteps - (warmup or 0), 1)), boundary)


def default_model(seed: int, device: DeviceLike = "cuda"):
    """The compact text-only FLMR retriever the trainer defaults to (the
    stock-ColBERT role: no vision tower), weights drawn from ``seed``."""
    from ..models.flmr import FLMRConfig, FLMRModelForRetrieval

    dev = resolve_device(device)
    return FLMRModelForRetrieval(
        FLMRConfig.tiny(use_vision_encoder=False,
                        query_concat_output_from_vision_encoder=False,
                        use_transformer_mapping_network=False),
        device=dev, generator=torch.Generator(device=dev).manual_seed(seed))


def triples_loss(out, target, config: TriplesTrainerConfig):
    """KL-distillation against the target scores when there are any (and
    they are not ignored), else the CE over nway; plus the in-batch-negative
    loss when it is on."""
    if target is not None and not config.ignore_scores:
        t = F.log_softmax(target * config.distillation_alpha, dim=-1)
        s = F.log_softmax(out.scores, dim=-1)
        loss = (t.exp() * (t - s)).sum(dim=-1).mean()
    else:
        loss = out.loss
    if config.use_ib_negatives and out.in_batch_negative_loss is not None:
        loss = loss + out.in_batch_negative_loss
    return loss


def train(config: TriplesTrainerConfig, triples, queries, collection,
          model=None, params=None, tokenizers=None, mesh=None,
          device: DeviceLike = "cuda"):
    """Train a late-interaction retriever over triples on ``device``;
    returns ``(params, ema_loss)``, ``params`` being the model's state dict.

    ``model`` defaults to :func:`default_model`; ``params`` is a state dict
    loaded into it (e.g. ``models.weights.flmr_state_dict`` of the JAX
    package's parameters). With ``params`` None the model keeps its own
    weights, and two warm-up batches are drawn from the id stream first, as
    the JAX trainer draws them to initialise its parameters, so that both
    packages feed the same ids. ``tokenizers`` is an optional
    ``(query_tok, context_tok)`` pair with the FLMR marker conventions;
    without it ids are drawn from ``np.random.default_rng(config.seed)``.
    """
    from ..parallel.mesh import check_mesh

    check_mesh(mesh)
    dev = resolve_device(mesh.device if mesh is not None else device)
    rng = np.random.default_rng(config.seed)
    if model is None:
        model = default_model(config.seed, dev)
    if tokenizers is None:
        tokenize_q = tokenize_d = None
    else:
        tokenize_q, tokenize_d = tokenizers

    def encode(texts, tokenize, maxlen):
        if tokenize is not None:
            enc = tokenize(texts)
            return (np.asarray(enc["input_ids"], np.int32),
                    np.asarray(enc["attention_mask"], np.int32))
        ids = rng.integers(3, 50, size=(len(texts), maxlen))
        return ids.astype(np.int32), np.ones_like(ids, np.int32)

    def encode_queries(texts):
        return encode(texts, tokenize_q, config.query_maxlen)

    def encode_docs(texts):
        return encode(texts, tokenize_d, config.doc_maxlen)

    reader = LazyBatcher(triples, queries, collection, config.bsize, config.nway)

    if params is None:
        encode_queries(["warmup"] * 2)
        encode_docs(["warmup"] * (2 * config.nway))
    else:
        model.load_state_dict(params)
    model.train()
    gather = None
    if mesh is not None:
        from ..parallel.mesh import all_reduce, replicate, shard_batch

        replicate(mesh, model)
        gather = mesh.data_group if mesh.n_data > 1 else None

    schedule = triples_schedule(config.lr, config.warmup, config.maxsteps)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1.0, eps=1e-8,
                                  weight_decay=ADAMW_WEIGHT_DECAY)
    # lr 1.0: LambdaLR sets it to schedule(count), optax's value exactly
    state = TrainState.create(model, optimizer,
                              torch.optim.lr_scheduler.LambdaLR(optimizer, schedule))

    def to_dev(a):
        return torch.as_tensor(a, device=dev).long()

    nway = config.nway
    ema = None
    saver = (CheckpointManager(config.checkpoint_dir)
             if config.checkpoint_dir and (mesh is None or mesh.is_main) else None)
    for q_texts, p_texts, target in reader:
        if state.step >= config.maxsteps:
            break
        qi, qm = encode_queries(q_texts)
        di, dm = encode_docs(p_texts)
        arrays = [to_dev(qi), to_dev(qm), to_dev(di), to_dev(dm),
                  None if target is None else torch.as_tensor(target, device=dev)]
        if mesh is not None:
            arrays = shard_batch(mesh, arrays)
        out = model(*arrays[:4], use_in_batch_negatives=config.use_ib_negatives,
                    num_negative_examples=nway - 1,
                    **({"gather_group": gather} if gather is not None else {}))
        loss = triples_loss(out, arrays[4], config)
        apply_update(state, loss, guard=False, mesh=mesh)
        loss = loss.detach()
        if gather is not None:  # the mean of the ranks' means: the global batch's
            loss = all_reduce(loss, gather) / mesh.n_data
        loss = float(loss)
        ema = loss if ema is None else 0.999 * ema + 0.001 * loss
        step_idx = state.step
        if step_idx % 10 == 0 or step_idx == 1:
            logger.info("triples step %d loss=%.4f ema=%.4f", step_idx, loss, ema)
        if saver and config.save_every and step_idx % config.save_every == 0:
            saver.save({"params": model.state_dict()}, step_idx, {"train_loss": ema})
    if saver:
        saver.save({"params": model.state_dict()}, state.step, {"train_loss": ema or 0.0})
    return model.state_dict(), (ema if ema is not None else 0.0)
