"""CLIP byte-pair-encoding tokenizer (pure Python, zero model deps).

The reference gets tokenization for free via embed_anything's bundled HF
``tokenizers`` crate (the upstream server's ``server/Cargo.toml:29`` ->
tokenizers 0.21.4 per Cargo.lock). This framework owns the full text path, so
the CLIP BPE scheme is implemented here from its definition:

- byte -> printable-unicode remapping (GPT-2 style ``bytes_to_unicode``)
- word-level regex pre-tokenization (contractions / letter runs / single
  digits / punctuation runs)
- greedy lowest-rank pair merging with a ``</w>`` end-of-word marker
- ``<|startoftext|>`` / ``<|endoftext|>`` specials; pad == EOS (so the model
  pools at the FIRST EOS position — see ``models.clip.encode_text``)

Vocab/merges files use the standard CLIP/GPT-2 format (``vocab.json`` +
``merges.txt``), so the stock ``openai/clip-vit-large-patch14`` tokenizer
files drop in unchanged. Parity vs ``transformers.CLIPTokenizer`` is tested
in ``tests/test_tokenizer.py``. A small BPE trainer is included so fully
self-contained deployments (and tests) can build their own vocab.
"""

from __future__ import annotations

import json
import os
import unicodedata
from collections import Counter
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

try:  # transformers dependency, present wherever HF is; fallback included
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )

    def _pre_tokenize(text: str) -> List[str]:
        return _PAT.findall(text)

except ImportError:  # pragma: no cover - exercised only without `regex`
    _CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

    def _pre_tokenize(text: str) -> List[str]:
        out: List[str] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch.isspace():
                i += 1
                continue
            if ch == "'":
                low = text[i:].lower()
                for c in _CONTRACTIONS:
                    if low.startswith(c):
                        out.append(text[i : i + len(c)])
                        i += len(c)
                        break
                else:
                    j = i + 1
                    while j < n and not (text[j].isspace() or text[j].isalpha() or text[j].isnumeric()):
                        j += 1
                    out.append(text[i:j])
                    i = j
                continue
            if ch.isalpha():
                j = i
                while j < n and text[j].isalpha():
                    j += 1
                out.append(text[i:j])
                i = j
                continue
            if ch.isnumeric():
                out.append(ch)
                i += 1
                continue
            j = i
            while j < n and not (text[j].isspace() or text[j].isalpha() or text[j].isnumeric()):
                j += 1
            out.append(text[i:j])
            i = j
        return out


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable unicode table."""
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


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


class CLIPBPETokenizer:
    """Drop-in equivalent of HF's slow ``CLIPTokenizer``.

    Args:
        vocab: token -> id mapping (or path to vocab.json).
        merges: ordered merge pairs (or path to merges.txt).
        context_length: model sequence length (77 for CLIP,
            ``server``'s fixed text shape).
    """

    def __init__(
        self,
        vocab,
        merges,
        context_length: int = 77,
    ):
        if isinstance(vocab, (str, os.PathLike)):
            with open(vocab, encoding="utf-8") as f:
                vocab = json.load(f)
        if isinstance(merges, (str, os.PathLike)):
            with open(merges, encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard format: "#version" header, one "a b" pair per line
            merges = [
                tuple(l.split()) for l in lines if l and not l.startswith("#version") and len(l.split()) == 2
            ]
        self.encoder: Dict[str, int] = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.bos_id = self.encoder[BOS]
        self.eos_id = self.encoder[EOS]
        self.unk_id = self.eos_id
        self._cache: Dict[str, str] = {BOS: BOS, EOS: EOS}

    @classmethod
    def from_dir(cls, path: str, context_length: int = 77) -> "CLIPBPETokenizer":
        return cls(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            context_length,
        )

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in sorted(self.bpe_ranks, key=self.bpe_ranks.get):
                f.write(f"{a} {b}\n")

    # -- core BPE ----------------------------------------------------------

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        joined = " ".join(word)
        self._cache[token] = joined
        return joined

    def tokenize(self, text: str) -> List[str]:
        text = whitespace_clean(unicodedata.normalize("NFC", text)).lower()
        out: List[str] = []
        for token in _pre_tokenize(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self._bpe(mapped).split(" "))
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> ids WITHOUT specials/padding."""
        return [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids]
        text = "".join(t for t in toks if t not in (BOS, EOS))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, context_length: Optional[int] = None) -> np.ndarray:
        """Batch encode -> int32 [B, context_length]: bos + ids + eos, eos-pad.

        Padding with EOS mirrors HF CLIPTokenizer (pad_token == eos_token),
        which is what makes first-EOS pooling correct.
        """
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.context_length
        out = np.full((len(texts), L), self.eos_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: L - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)


class HashTokenizer:
    """Deterministic fallback when no vocab files are present.

    Keeps the server end-to-end functional with random/self-trained
    checkpoints (e.g. on an offline machine); NOT semantically meaningful
    with real CLIP weights — supply vocab.json/merges.txt for those.
    """

    def __init__(
        self,
        vocab_size: int = 49408,
        context_length: int = 77,
        eos_id: Optional[int] = None,
    ):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.eos_id = vocab_size - 1 if eos_id is None else eos_id
        self.bos_id = (self.eos_id - 1) % vocab_size

    def __call__(self, texts, context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        L = context_length or self.context_length
        import zlib

        out = np.full((len(texts), L), self.eos_id, np.int32)
        reserved = {self.bos_id, self.eos_id}
        for i, text in enumerate(texts):
            words = whitespace_clean(text).lower().split()[: L - 2]
            ids = []
            for w in words:
                # crc32, NOT hash(): the builtin is salted per process, which
                # would tokenize the same text differently across restarts
                t = 2 + (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 4))
                if t in reserved:
                    t = (t + 1) % (self.vocab_size - 4) + 2
                ids.append(t)
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out


# ---------------------------------------------------------------------------
# Training (for self-contained deployments and tests)
# ---------------------------------------------------------------------------


def train_bpe(
    corpus: Sequence[str],
    vocab_size: int,
    context_length: int = 77,
) -> CLIPBPETokenizer:
    """Learn a CLIP-format BPE vocab from raw text.

    Classic greedy BPE over ``</w>``-terminated words; emits the same
    vocab.json/merges.txt layout as openai/clip-vit-large-patch14 (base byte
    alphabet + ``X</w>`` variants, then merges, then the two specials).
    """
    byte_enc = bytes_to_unicode()
    alphabet = sorted(byte_enc.values())
    base: List[str] = list(alphabet) + [c + "</w>" for c in alphabet]

    # word frequencies, pre-tokenized exactly like encode()
    words: Counter = Counter()
    for text in corpus:
        text = whitespace_clean(unicodedata.normalize("NFC", text)).lower()
        for token in _pre_tokenize(text):
            mapped = "".join(byte_enc[b] for b in token.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1

    merges: List[Tuple[str, str]] = []
    max_merges = max(0, vocab_size - len(base) - 2)
    if max_merges == 0:
        import logging

        logging.getLogger(__name__).warning(
            "train_bpe: vocab_size=%d leaves no room above the %d-entry "
            "base alphabet (+2 specials) — ZERO merges will be learned "
            "and every token is a single character. Captions tokenize "
            "~5x longer than word-level and may silently truncate at "
            "context_length. Use vocab_size > %d.",
            vocab_size, len(base), len(base) + 2,
        )
    word_list = [[list(w), f] for w, f in words.items()]
    for _ in range(max_merges):
        pair_counts: Counter = Counter()
        for w, f in word_list:
            for i in range(len(w) - 1):
                pair_counts[(w[i], w[i + 1])] += f
        if not pair_counts:
            break
        (a, b), cnt = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        merges.append((a, b))
        ab = a + b
        for w, _ in word_list:
            i = 0
            while i < len(w) - 1:
                if w[i] == a and w[i + 1] == b:
                    w[i : i + 2] = [ab]
                else:
                    i += 1

    vocab_tokens = base + [a + b for a, b in merges] + [BOS, EOS]
    vocab = {t: i for i, t in enumerate(vocab_tokens)}
    return CLIPBPETokenizer(vocab, merges, context_length)
