"""CLIP byte-pair-encoding tokenizer (counterpart of
``univs_tpu/models/tokenizer.py``, copied: the port imports nothing of
the JAX package).

Implements the public CLIP BPE scheme (SimpleTokenizer + 81 prompt
templates).  The merge table is data, not code: it is loaded at run
time from ``bpe_simple_vocab_16e6.txt.gz``, from an explicit
``vocab_path`` or the ``UNIVS_TPU_BPE_VOCAB`` variable, which both
packages read first.  The JAX package also looks in the reference
checkout when the variable is unset; the port names no path outside the
repository, so set the variable to give both the same vocabulary.

Without a vocabulary the tokenizer degrades to a hash fallback,
``hash(word) % (VOCAB_SIZE - 2)``: Python salts string hashes per
process (PYTHONHASHSEED), so its ids agree with the JAX package's inside
one process only, and differ between two.  Tokenize once and pass the
ids where two processes must agree.

``regex`` (for the ``\\p{L}`` word pattern) is imported only when a
vocabulary is loaded; the fallback needs only the standard library and
numpy.  No ftfy: NFC normalisation + html unescape only.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import List, Optional

import numpy as np

VOCAB_ENV = "UNIVS_TPU_BPE_VOCAB"

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def bytes_to_unicode():
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


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text).strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


class ClipTokenizer:
    def __init__(self, vocab_path: Optional[str] = None):
        path = vocab_path
        if path is None:
            env = os.environ.get(VOCAB_ENV, "")
            path = env if env and os.path.exists(env) else None
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.has_vocab = path is not None
        if not self.has_vocab:
            self.encoder = {"<|startoftext|>": VOCAB_SIZE - 2, "<|endoftext|>": VOCAB_SIZE - 1}
            self.bpe_ranks = {}
            return
        try:
            import regex
        except ImportError as e:
            raise ImportError(
                f"the BPE vocabulary {path} needs the 'regex' package for CLIP's word "
                "pattern; install it or tokenize without a vocabulary") from e
        self._re = regex
        self.pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )

        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @property
    def sot(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.encoder["<|endoftext|>"]

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
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        if not self.has_vocab:  # fallback: ids hold within one process only
            return [hash(w) % (VOCAB_SIZE - 2) for w in text.lower().split()][: CONTEXT_LENGTH - 2]
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self._re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to a padded [N, context_length] int array
        (sot + tokens + eot, zero padded; overlong inputs truncated)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int64)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            toks = toks[:context_length]
            if toks[-1] != self.eot:
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


# The 81 public CLIP prompt templates used for category/expression
# embedding averaging (reference: clip_prompt_utils.py:168-365 active
# list — '{}.'-prefixed ImageNet-80 set).
PROMPT_TEMPLATES = [
    "{}.", "a photo of a {}.", "a bad photo of a {}.", "a photo of many {}.",
    "a sculpture of a {}.", "a photo of the hard to see {}.",
    "a low resolution photo of the {}.", "a rendering of a {}.",
    "graffiti of a {}.", "a bad photo of the {}.", "a cropped photo of the {}.",
    "a tattoo of a {}.", "the embroidered {}.", "a photo of a hard to see {}.",
    "a bright photo of a {}.", "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "the origami {}.", "the {} in a video game.",
    "a sketch of a {}.", "a doodle of the {}.", "a origami {}.",
    "a low resolution photo of a {}.", "the toy {}.", "a rendition of the {}.",
    "a photo of the clean {}.", "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.", "a blurry photo of a {}.",
    "a cartoon {}.", "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]


def clean_category_string(s: str) -> str:
    """Category-name cleaning used for the frozen embedding bank —
    exact transcription of ``clean_strings`` + ``clean_string_exp``
    (reference: clip_prompt_utils.py:485-507): underscores -> spaces,
    digits and parens dropped, punctuation stripped, lowercased,
    '-'/'/' -> spaces.  Synonym rows like "tench, Tinca tinca," become
    one concatenated string ("tench tinca tinca")."""
    import re as _re

    s = " ".join(s.split("_"))
    s = "".join(ch for ch in s if ch not in "0123456789()")
    return _re.sub(r"([.,'!?\"()*#:;])", "", s.lower()).replace("-", " ").replace("/", " ")


def pre_tokenize(
    texts: List[str],
    tokenizer: Optional[ClipTokenizer] = None,
    text_type: str = "class_name",
) -> np.ndarray:
    """Each text x 81 templates -> [N, 81, 77] token ids.

    ``text_type='class_name'`` cleans the name like the reference's
    ``prompt_engineering`` ('/' and ',' removed, '+' -> space;
    clip_prompt_utils.py:332-333); ``'expression'`` substitutes the raw
    sentence (pre_tokenize_expression does a plain ``{}`` replace).
    """
    tok = tokenizer or ClipTokenizer()
    out = np.zeros((len(texts), len(PROMPT_TEMPLATES), CONTEXT_LENGTH), np.int64)
    for i, text in enumerate(texts):
        if text_type == "class_name":
            text = text.replace("/", "").replace(",", "").replace("+", " ")
        prompts = [t.replace("{}", text) for t in PROMPT_TEMPLATES]
        out[i] = tok(prompts)
    return out
