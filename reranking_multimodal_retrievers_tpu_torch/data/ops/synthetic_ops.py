"""Deterministic synthetic M2KR-style retrieval task.

Purpose: demonstrate the accuracy half of the north star —
that a trained reranker *improves* PRRecall@5 over raw retrieval order, the
qualitative shape of the reference's OK-VQA result (raw 0.23 → reranked
0.28/0.40, `plots.ipynb` cell 16) — at a statistically meaningful scale
(≥10k passages, ≥500 eval queries) without network access to the real M2KR
data.

Task design — **tail evidence**: the mechanism that makes reranking help in
the reference is that the reranker reads more of the candidate than the
retriever's indexed representation (the reference's cross-encoder budget is
750 joint positions, `monoPreFLMR-B_pointwise.jsonnet:118`, vs the
retriever's truncated doc tokens). This task distills that into a
controlled structure:

- every query names a pair of key words ``(A, B)``: ``A`` from a head-key
  pool, ``B`` from a tail-key pool;
- the query's candidate group is ``group_size`` passages that ALL carry
  ``A`` in their HEAD (inside the retriever's ``doc_maxlen`` truncation);
- exactly one (the positive) carries ``B`` in its TAIL — beyond the
  retriever's doc budget but inside the reranker's joint-sequence budget;
  the other group members carry unrelated distractor keys there.

A retriever indexed at ``doc_maxlen ≤ head`` can learn to pull the group to
the top (``A`` matching) but is provably blind to the positive within it —
raw PRRecall@5 converges to ``5 / group_size``. A reranker that reads the
full passage only has to learn "the tail contains the query's second key",
so reranked PRRecall@5 → 1. Tail keys are globally unique to their
positive, so pseudo-relevance (answer-string containment,
`metrics_processors.py:712`) marks exactly the planted positive.

Output schema matches ``LoadPreprocessedData`` (M2KR): train/valid/test row
splits + ``{split}_passages`` tables (`merge_data_ops.py:200-366`), so the
standard FLMR/reranker configs consume it unchanged. A WordPiece vocab file
covering the synthetic words is written next to the cache so the offline
FLMR tokenizers see every word as a single token.

**Visual-key mode** (``visual_key='head'|'tail'``) — the multimodal variant:
the answer-bearing signal moves from the query *text* into
the query *image*, exercising the framework's namesake capability end to
end (the reference's ViT→MLP prefix + transformer mapping network,
`modeling_flmr.py:1285-1360`, and image-conditioned rerankers,
`rerank_model.py:227-319`):

- every pair gets a globally unique **visual key**: a tuple of
  ``visual_digits`` color indices in ``[0, visual_colors)``;
- the query IMAGE is a ``visual_digits``-block grid, block ``j`` filled with
  palette color ``key[j]`` (a deterministic PNG written per pair);
- the positive passage spells the key as a contiguous phrase of
  position-qualified words ``p{j}v{c:02d}`` — in its HEAD (inside the
  retriever's doc budget: *vision improves retrieval*) or TAIL (beyond it:
  *vision-reading reranker beats raw order*); distractor group members carry
  other combos in the same slot;
- the query TEXT names only the group key ``A`` — a text-only model is
  information-theoretically stuck at ``K / group_size`` PRRecall@K, while a
  multimodal one only has to learn the 64-ish (position, color) → word-token
  associations, a circuit that generalizes to unseen test-key combinations.

The answer string is the full visual phrase (contiguous in the positive and
globally unique to it), so pseudo-relevance containment marks exactly the
planted positive, as in the text-only mode.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...utils.registries import register_transform_functor
from ..image_io import write_png
from ..table import Table
from ..transforms import HFDatasetTransform


@register_transform_functor
class GenerateSyntheticM2KR(HFDatasetTransform):
    """Generate the tail-evidence corpus + query splits (seeded)."""

    def setup(
        self,
        num_pairs: int = 1500,
        num_test: int = 500,
        group_size: int = 20,
        head_len: int = 22,
        tail_len: int = 18,
        num_distractor_keys: int = 500,
        num_filler_words: int = 200,
        vocab_path: str = None,
        seed: int = 0,
        visual_key: str = None,
        visual_digits: int = 4,
        visual_colors: int = 16,
        images_dir: str = None,
        image_size: int = 32,
        emit_group_negatives: bool = False,
        **kwargs,
    ):
        self.num_pairs = num_pairs
        self.num_test = num_test
        self.group_size = group_size
        self.head_len = head_len
        self.tail_len = tail_len
        self.num_distractor_keys = num_distractor_keys
        self.num_filler_words = num_filler_words
        self.vocab_path = vocab_path
        self.seed = seed
        assert visual_key in (None, "head", "tail"), visual_key
        self.visual_key = visual_key
        self.visual_digits = visual_digits
        self.visual_colors = visual_colors
        self.images_dir = images_dir
        self.image_size = image_size
        # hard negatives: each query row lists its other group members as
        # `neg_item_ids`, so DPR sampling draws SAME-GROUP negatives (the
        # text-identical ones only the image separates) instead of random
        # corpus passages that the query text alone already rules out —
        # without this, the contrastive loss barely needs the image
        assert not (emit_group_negatives and not visual_key), (
            "group negatives exist only in visual-key mode")
        self.emit_group_negatives = emit_group_negatives
        return self

    # palette: 3 intensity levels per channel = 27 well-separated RGB colors
    @staticmethod
    def _palette(n: int) -> np.ndarray:
        levels = np.array([0, 128, 255], np.uint8)
        grid = np.stack(np.meshgrid(levels, levels, levels,
                                    indexing="ij"), -1).reshape(-1, 3)
        assert n <= len(grid), f"at most {len(grid)} visual colors"
        return grid[np.linspace(0, len(grid) - 1, n).round().astype(int)]

    def _write_key_image(self, key, path):
        """Deterministic PNG: a row-major grid of visual_digits blocks,
        block j filled with palette[key[j]]."""
        palette = self._palette(self.visual_colors)
        side = int(np.ceil(np.sqrt(self.visual_digits)))
        s = self.image_size
        block = s // side
        arr = np.zeros((s, s, 3), np.uint8)
        for j, c in enumerate(key):
            r, col = divmod(j, side)
            arr[r * block:(r + 1) * block,
                col * block:(col + 1) * block] = palette[int(c)]
        write_png(path, arr)

    def _call(self, data=None):
        import os

        if self.use_dummy_data:
            self.num_pairs = min(self.num_pairs, 24)
            self.num_test = min(self.num_test, 8)
            self.group_size = min(self.group_size, 4)
            # dummy runs must never clobber the real side artifacts: the
            # dummy vocab/images differ in content (dummy-sized pools), and
            # overwriting the shared paths silently invalidates every
            # checkpoint trained against the real vocab
            from ..cache_system import dummy_scoped_path

            if self.vocab_path:
                self.vocab_path = dummy_scoped_path(self.vocab_path)
            if self.images_dir:
                self.images_dir = dummy_scoped_path(self.images_dir)

        rng = np.random.default_rng(self.seed)
        head_keys = [f"a{i:04d}" for i in range(self.num_pairs)]
        tail_keys = [f"b{i:04d}" for i in range(self.num_pairs)]
        dis_keys = [f"c{i:04d}" for i in range(self.num_distractor_keys)]
        fillers = [f"f{i:03d}" for i in range(self.num_filler_words)]
        visual_words = [
            f"p{j}v{c:02d}"
            for j in range(self.visual_digits)
            for c in range(self.visual_colors)
        ] if self.visual_key else []

        if self.vocab_path:
            from ...models.tokenization import write_test_vocab

            write_test_vocab(
                self.vocab_path,
                words=head_keys + tail_keys + dis_keys + fillers
                + visual_words + ["pair", "find"],
            )

        # visual mode: a globally unique color-combo per pair, plus a
        # disjoint pool of distractor combos for the group members
        pos_combos, dis_combos = [], []
        if self.visual_key:
            total = self.visual_colors ** self.visual_digits
            need = self.num_pairs + self.num_distractor_keys
            assert need <= total, (
                f"{need} combos needed but only {total} exist — raise "
                "visual_digits/visual_colors")
            codes = rng.choice(total, size=need, replace=False)

            def decode(code: int) -> tuple:
                out = []
                for _ in range(self.visual_digits):
                    out.append(int(code % self.visual_colors))
                    code //= self.visual_colors
                return tuple(out)

            pos_combos = [decode(c) for c in codes[: self.num_pairs]]
            dis_combos = [decode(c) for c in codes[self.num_pairs:]]
            if self.images_dir:
                os.makedirs(self.images_dir, exist_ok=True)

        def phrase(combo) -> List[str]:
            return [f"p{j}v{c:02d}" for j, c in enumerate(combo)]

        passage_ids, passage_contents = [], []
        row_keys = ["question_id", "question", "instruction", "img_path",
                    "answers", "gold_answer", "pos_item_ids", "source_name"]
        if self.emit_group_negatives:
            row_keys.append("neg_item_ids")
        rows = {k: [] for k in row_keys}

        def fill(n: int) -> List[str]:
            return [fillers[i] for i in rng.integers(0, len(fillers), size=n)]

        def plant(words: List[str], sub: List[str], avoid=None) -> int:
            """Overwrite a contiguous slice of ``words`` with ``sub`` at a
            random start; returns the start index. ``avoid`` is a (start,
            len) span that must stay untouched."""
            assert len(sub) <= len(words)
            while True:
                start = int(rng.integers(0, len(words) - len(sub) + 1))
                if avoid is None or (start + len(sub) <= avoid[0]
                                     or start >= avoid[0] + avoid[1]):
                    words[start:start + len(sub)] = sub
                    return start

        def add_passage(A: str, tail_key: str, combo=None) -> str:
            head = fill(self.head_len)
            tail = fill(self.tail_len)
            if combo is not None and self.visual_key == "head":
                span = plant(head, phrase(combo))
                plant(head, [A], avoid=(span, self.visual_digits))
            else:
                plant(head, [A])
                if combo is not None:  # visual_key == "tail"
                    plant(tail, phrase(combo))
                elif tail_key is not None:
                    plant(tail, [tail_key])
            pid = f"sp{len(passage_ids)}"
            passage_ids.append(pid)
            passage_contents.append(" ".join(head + tail))
            return pid

        for qi in range(self.num_pairs):
            A, B = head_keys[qi], tail_keys[qi]
            if self.visual_key:
                combo = pos_combos[qi]
                pos_id = add_passage(A, None, combo=combo)
                group_negs = [
                    add_passage(A, None, combo=dis_combos[
                        int(rng.integers(0, len(dis_combos)))])
                    for _ in range(self.group_size - 1)
                ]
                if self.emit_group_negatives:
                    rows["neg_item_ids"].append(group_negs)
                img_path = ""
                if self.images_dir:
                    img_path = os.path.join(self.images_dir, f"sq{qi}.png")
                    self._write_key_image(combo, img_path)
                rows["question_id"].append(f"sq{qi}")
                # the query TEXT names only the group key: the positive
                # within the group is identifiable from the IMAGE alone
                rows["question"].append(f"find pair {A}")
                rows["instruction"].append("")
                rows["img_path"].append(img_path)
                answer = " ".join(phrase(combo))
                rows["answers"].append([answer])
                rows["gold_answer"].append(answer)
                rows["pos_item_ids"].append([pos_id])
                rows["source_name"].append("synthetic")
                continue

            pos_id = add_passage(A, B)
            for _ in range(self.group_size - 1):
                add_passage(A, dis_keys[int(rng.integers(0, len(dis_keys)))])

            rows["question_id"].append(f"sq{qi}")
            rows["question"].append(f"find pair {A} {B}")
            rows["instruction"].append("")
            rows["img_path"].append("")
            # B is globally unique to the positive passage: PR containment
            # marks exactly the planted positive
            rows["answers"].append([B])
            rows["gold_answer"].append(B)
            rows["pos_item_ids"].append([pos_id])
            rows["source_name"].append("synthetic")

        passages = Table.from_dict({
            "passage_id": passage_ids,
            "passage_content": passage_contents,
            "source_name": ["synthetic"] * len(passage_ids),
        })
        n_train = self.num_pairs - self.num_test
        train = Table.from_dict({k: v[:n_train] for k, v in rows.items()})
        test = Table.from_dict({k: v[n_train:] for k, v in rows.items()})
        return {
            "train": train,
            "valid": test,
            "test": test,
            "train_passages": passages,
            "valid_passages": passages,
            "test_passages": passages,
        }
