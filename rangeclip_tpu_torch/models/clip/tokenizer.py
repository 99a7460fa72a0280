"""CLIP byte-pair-encoding tokenizer: a copy of
``rangeclip_tpu/models/clip/tokenizer.py`` (standard library and numpy
only), kept beside the port so that it imports nothing of the JAX package.

Implements the tokenization CLIP's text tower expects: basic whitespace
cleanup + lowercasing, the CLIP token regex, byte-to-unicode mapping, BPE
with end-of-word ``</w>`` markers, and ``<|startoftext|> ... <|endoftext|>``
framing padded/truncated to the 77-token context.

Vocabulary files (vocab.json + merges.txt, the standard HF/openai artifacts)
are supplied by the user; there is no network access in this framework.
"""

from __future__ import annotations

import gzip
import json
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map bytes to printable unicode chars (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    # CLIP's token regex uses \p{L}+ / \p{N} (unicode letters / numerics).
    # Python's re has no \p classes; [^\W\d_] matches exactly the unicode
    # letters (word chars minus digits and underscore) and \d matches the
    # unicode decimal digits, so e.g. 'café' tokenizes as one word like the
    # HF tokenizer instead of splitting at the accent.  (The remaining
    # divergence — non-decimal \p{N} numerals like Ⅻ — does not occur in
    # label vocabularies.)
    PATTERN = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[^\W\d_]+|\d|(?:[^\w\s]|_)+""",
        re.IGNORECASE,
    )

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}

        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # skip the header line if present
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [m for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}

        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.sot = self.encoder.get("<|startoftext|>")
        self.eot = self.encoder.get("<|endoftext|>")

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = basic_clean(text).lower()
        for match in re.findall(self.PATTERN, text):
            token = "".join(self.byte_encoder[b] for b in match.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def __call__(
        self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        """Tokenize to a padded [N, context_length] int32 array with
        SOT/EOT framing (truncating long inputs, keeping the EOT)."""
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            result[i, : len(ids)] = ids
        return result
