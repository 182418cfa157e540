"""Official VQA accuracy with full-fidelity answer normalization.

Behavior-exact re-implementation of the official OK-VQA evaluator the
reference vendors (`src/utils/vqaEval.py:1-324`, the VQA-API scoring rules),
including its quirks, so scores computed here are bit-identical:

- the full contraction table (~120 entries) including the reversed
  ``somebody'd → somebodyd`` entry and multi-apostrophe forms;
- ``processPunctuation``: each punctuation char is *deleted* when it touches
  a space in the original text (or the text has a digit,digit comma),
  otherwise replaced by a space; then the official period regex — whose
  ``(?!<=\\d)`` is a (faithfully kept) typo'd lookahead, not a lookbehind —
  strips periods not followed by a digit (`vqaEval.py:252-263`);
- normalization is applied only when the ground-truth answers are not all
  identical (`vqaEval.py:216-221`);
- accuracy per answer = ``min(1, matches/3)`` over leave-one-out subsets,
  averaged; overall is ``round(100·mean, 2)`` (`vqaEval.py:225-244,278`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id've": "I'd've",
    "I'dve": "I'd've", "Im": "I'm", "Ive": "I've", "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've", "itll": "it'll",
    "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "mightve": "might've", "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've", "oclock": "o'clock",
    "oughtnt": "oughtn't", "ow's'at": "'ow's'at", "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at", "shant": "shan't", "shed've": "she'd've",
    "she'dve": "she'd've", "she's": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyd've": "they'd've", "they'dve": "they'd've", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed've": "we'd've", "we'dve": "we'd've",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = ["a", "an", "the"]
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
         "-", ">", "<", "@", "`", ",", "?", "!"]
# the official evaluator's own (typo'd — lookahead, not lookbehind) regexes
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def _strip_ws(ans: str) -> str:
    return ans.replace("\n", " ").replace("\t", " ").strip()


def process_punctuation(in_text: str) -> str:
    """`vqaEval.py:252-262` verbatim semantics (conditions test the ORIGINAL
    text, not the partially-processed one)."""
    out_text = in_text
    for p in PUNCT:
        if (p + " " in in_text or " " + p in in_text) or (
            COMMA_STRIP.search(in_text) is not None
        ):
            out_text = out_text.replace(p, "")
        else:
            out_text = out_text.replace(p, " ")
    return PERIOD_STRIP.sub("", out_text, re.UNICODE)


def process_digit_article(in_text: str) -> str:
    """`vqaEval.py:264-277`."""
    out = []
    for word in in_text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    return process_digit_article(process_punctuation(_strip_ws(ans)))


class TextCleaner:
    """Reference ``src/utils/text_cleaner.py:12-215``: the same contraction /
    manual-map / article / punctuation normalization as the official VQA
    evaluator, exposed as a batch ``clean_texts``. The tables are shared with
    :func:`normalize_answer` (they are byte-identical in the reference too)."""

    def clean_texts(self, texts: List[str]) -> List[str]:
        return [normalize_answer(t) for t in texts]


def vqa_accuracy(prediction: str, human_answers: List[str]) -> float:
    """Official accuracy for one question: leave-one-out
    ``min(1, matches/3)`` averaged over the human answers. Normalization is
    applied only when the humans disagree (`vqaEval.py:216-221`)."""
    res_ans = _strip_ws(prediction)
    gts = [_strip_ws(a) for a in human_answers]
    if not gts:
        return 0.0
    if len(set(gts)) > 1:
        gts = [normalize_answer(a) for a in gts]
        res_ans = normalize_answer(res_ans)
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for g in others if g == res_ans)
        accs.append(min(1.0, matches / 3.0))
    return float(sum(accs) / len(accs))


def okvqa_scores(
    predictions: List[str],
    answer_lists: List[List[str]],
    question_types: Optional[List[str]] = None,
    answer_types: Optional[List[str]] = None,
) -> Dict[str, float]:
    """Overall + optional per-question/answer-type accuracies
    (`vqaEval.py:276-292`), in the official ×100, 2-decimal rounding."""
    accs = [vqa_accuracy(p, a) for p, a in zip(predictions, answer_lists)]
    out = {
        "accuracy_overall": round(
            100 * float(sum(accs)) / max(len(accs), 1), 2
        ),
    }
    for name, types in (("question_type", question_types),
                        ("answer_type", answer_types)):
        if not types:
            continue
        per: Dict[str, List[float]] = {}
        for t, a in zip(types, accs):
            per.setdefault(t, []).append(a)
        for t, vals in per.items():
            out[f"accuracy_{name}_{t}"] = round(
                100 * float(sum(vals)) / len(vals), 2
            )
    return out
