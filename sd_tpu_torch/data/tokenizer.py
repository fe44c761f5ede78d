"""The CLIP BPE tokenizer and the vocabulary-free hash tokenizer (copies of
``CLIPTokenizer`` and ``HashTokenizer``, with the text cleanup they share,
from ``sd_tpu/data/tokenizer.py``).

:class:`CLIPTokenizer` is byte-level BPE with the openai CLIP semantics:
lowercase and whitespace cleanup, CLIP's token pattern, BPE with ``</w>``
word ends, ``<|startoftext|>``/``<|endoftext|>``, padded with the end id.
Its vocabulary is CLIP's merges table (``bpe_simple_vocab_16e6.txt.gz``,
:meth:`CLIPTokenizer.from_openai_gz`) or HF's ``vocab.json`` +
``merges.txt`` (:meth:`CLIPTokenizer.from_hf_files`); neither is in the
repository. ``sd_tpu`` matches the pattern with the third-party ``regex``
module's ``\\p{L}`` and ``\\p{N}``; the port builds both classes from the
``unicodedata`` categories (L*: Lu Ll Lt Lm Lo; N*: Nd Nl No) for stdlib
``re``, whose ``\\w`` and ``\\d`` are other sets (``\\d`` misses ``²`` and
``Ⅻ``). The two agree wherever their Unicode versions do.

:class:`HashTokenizer` gives deterministic word-hash ids with the same call
contract, ``<|startoftext|>`` and ``<|endoftext|>`` at the two top ids. It
lets the pipelines and the trainer run where no BPE vocabulary is present;
it is not compatible with released checkpoints' embeddings.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["bytes_to_unicode", "CLIPTokenizer", "HashTokenizer"]


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


@lru_cache()
def _category_classes() -> Tuple[str, str]:
    """The bodies of ``[...]`` character classes for ``\\p{L}`` and ``\\p{N}``:
    runs of code points by their ``unicodedata`` category."""
    runs: Dict[str, List[List[int]]] = {"L": [], "N": []}
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major in runs:
            r = runs[major]
            if r and r[-1][1] == cp - 1:
                r[-1][1] = cp
            else:
                r.append([cp, cp])
    esc = lambda cp: f"\\U{cp:08x}"
    body = lambda r: "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in r)
    return body(runs["L"]), body(runs["N"])


@lru_cache()
def _clip_pattern() -> "re.Pattern":
    letters, numbers = _category_classes()
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
        rf"[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+")


class CLIPTokenizer:
    """Byte-level BPE with CLIP semantics.

    ``merges``: the ordered merge pairs, e.g. ``[("i", "n"), ("in", "g</w>")]``.
    ``vocab``: an explicit token → id map (HF's); without one the vocabulary
    is built the openai way: the 256 byte symbols, their ``</w>`` forms, one
    token per merge, then the two specials.
    """

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 vocab: Optional[Dict[str, int]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = [tuple(m) for m in merges]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        if vocab is None:
            symbols = list(self.byte_encoder.values())
            toks = symbols + [s + "</w>" for s in symbols]
            toks += ["".join(m) for m in merges]
            toks += [self.SOT, self.EOT]
            vocab = {t: i for i, t in enumerate(toks)}
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]
        self.cache: Dict[str, str] = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.pat = _clip_pattern()

    @classmethod
    def from_openai_gz(cls, path: str) -> "CLIPTokenizer":
        """openai's ``bpe_simple_vocab_16e6.txt.gz`` (its first 48894 merges)."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        return cls([tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]])

    @classmethod
    def from_hf_files(cls, vocab_json: str, merges_txt: str) -> "CLIPTokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines
                  if m and not m.startswith("#version") and len(m.split()) == 2]
        return cls(merges, vocab=vocab)

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
        ids: List[int] = []
        for tok in self.pat.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids if i not in (self.sot_id, self.eot_id))
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        """Token ids ``[len(texts), context_length]`` int32: SOT, the text's
        ids (truncated), EOT, padded with EOT."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.eot_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)[: context_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """``tok(texts, context_length=77)`` → int32 ids ``[len(texts), context_length]``."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _clean(text).split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts, context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.eot_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)[: context_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out
