"""Self-contained CLIP BPE tokenizer (vocab.json + merges.txt backend).

The port's own copy of ``e4t_diffusion_tpu/utils/tokenizer.py``: point it
at the ``tokenizer/`` subfolder of a local SD v1 checkpoint. Supports added
tokens (the E4T placeholder token) and max-length padding with the eos/pad
token, as Hugging Face's CLIPTokenizer does.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import Dict, List, Sequence, Union

import regex as re

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    """BPE tokenizer with the CLIP end-of-word convention."""

    def __init__(self, vocab_file: str, merges_file: str,
                 model_max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        opener = gzip.open if merges_file.endswith(".gz") else open
        with opener(merges_file, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # skip the version header if present
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token_id = self.eos_token_id
        self.added_tokens: Dict[str, int] = {}
        self.cache = {self.bos_token: self.bos_token,
                      self.eos_token: self.eos_token}

    # -- vocabulary management -------------------------------------------
    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Register added tokens; returns how many were new."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for tok in tokens:
            if tok in self.encoder or tok in self.added_tokens:
                continue
            self.added_tokens[tok] = len(self.encoder) + len(self.added_tokens)
            added += 1
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.encoder[token]

    # -- BPE ---------------------------------------------------------------
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

    def _encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        # split on added tokens first (HF added-token semantics)
        segments = [text]
        for tok in self.added_tokens:
            new_segments = []
            for seg in segments:
                if isinstance(seg, int):
                    new_segments.append(seg)
                    continue
                parts = seg.split(tok)
                for pi, part in enumerate(parts):
                    if pi > 0:
                        new_segments.append(self.added_tokens[tok])
                    new_segments.append(part)
            segments = new_segments
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            for token in re.findall(_PAT, seg.strip()):
                mapped = "".join(self.byte_encoder[b]
                                 for b in token.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def __call__(self, text: Union[str, Sequence[str]],
                 padding: str = "max_length", truncation: bool = True,
                 max_length: int = None, add_special_tokens: bool = True):
        """Returns {"input_ids": list[list[int]]} (padding='max_length',
        truncation, max 77 by default)."""
        if max_length is None:
            max_length = self.model_max_length
        texts = [text] if isinstance(text, str) else list(text)
        out = []
        for t in texts:
            ids = self._encode_text(t)
            if add_special_tokens:
                ids = [self.bos_token_id] + ids + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[:max_length]
                if add_special_tokens:
                    ids[-1] = self.eos_token_id
            if padding == "max_length":
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}

    @classmethod
    def from_pretrained(cls, path: str, subfolder: str = "",
                        **kwargs) -> "CLIPTokenizer":
        d = os.path.join(path, subfolder) if subfolder else path
        return cls(os.path.join(d, "vocab.json"),
                   os.path.join(d, "merges.txt"), **kwargs)


def make_tiny_tokenizer_files(directory: str, extra_words: Sequence[str] = ()):
    """Write a minimal character-level vocab.json/merges.txt for tests:
    every byte-unicode char and its </w> form, plus whole-word entries for
    ``extra_words`` reachable via merges."""
    os.makedirs(directory, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {}
    for ch in chars:
        vocab[ch] = len(vocab)
    for ch in chars:
        vocab[ch + "</w>"] = len(vocab)
    merges = []
    for word in extra_words:
        # build the word by merging left to right: (a b), (ab c), ...
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        cur = pieces[0]
        for nxt in pieces[1:]:
            merges.append((cur, nxt))
            cur = cur + nxt
            if cur not in vocab:
                vocab[cur] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return directory
