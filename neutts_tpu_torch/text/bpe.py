"""Self-contained byte-level BPE tokenizer (no `transformers` dependency).

The reference backbone's tokenizer is the Qwen2.5 byte-level BPE extended
with 6 control tokens + 65,536 speech tokens (reference TRAINING.md:38-58;
its GGUF releases carry the same vocab in `tokenizer.ggml.tokens/merges`
metadata, consumed by llama.cpp at reference neutts/neutts.py:139-158).
This module implements that tokenizer first-party so prompt construction is
exact without the transformers runtime:

  * GPT-2 byte<->unicode table + greedy lowest-rank pair merging (the public
    byte-level BPE algorithm);
  * the Qwen2/GPT-4 pre-tokenization split pattern (read from tokenizer.json
    when present, defaulted otherwise);
  * added tokens (specials + speech tokens) split out before BPE, longest
    match first — HF `add_tokens` semantics.

Sources: a HF `tokenizer.json` (vocab/merges/added_tokens/pre_tokenizer) or
GGUF metadata (`tokenizer.ggml.tokens` / `.merges` / `.token_type`).
Equivalence with the HF `tokenizers` runtime is pinned by
tests/test_bpe.py against a tokenizers-built oracle.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Qwen2's split pattern (tokenizer.json pre_tokenizer; same family as the
# public GPT-4 pattern). Requires the `regex` module for \p classes.
QWEN2_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (public algorithm)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache(maxsize=None)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class ByteLevelBPE:
    """Encoder/decoder over a byte-level BPE vocab with added tokens."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        added_tokens: Optional[Dict[str, int]] = None,
        split_pattern: str = QWEN2_SPLIT,
    ):
        import regex

        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.added = dict(added_tokens or {})
        for t, i in self.added.items():
            self.ids_to_tokens.setdefault(i, t)
        self._split = regex.compile(split_pattern)
        if self.added:
            # the NeuTTS vocab carries 65,536 <|speech_N|> added tokens — a
            # literal alternation over all of them is pathological, so they
            # collapse into one numeric branch (membership still checked
            # against the added dict at match time)
            speech_like = {
                t for t in self.added if regex.fullmatch(r"<\|speech_\d+\|>", t)
            }
            others = sorted(
                (t for t in self.added if t not in speech_like),
                key=len, reverse=True,
            )
            branches = [regex.escape(t) for t in others]
            if speech_like:
                branches.append(r"<\|speech_\d+\|>")
            self._added_re = regex.compile("(" + "|".join(branches) + ")")
        else:
            self._added_re = None
        self._b2u = bytes_to_unicode()
        self._u2b = unicode_to_bytes()
        self._bpe_cache: Dict[str, List[str]] = {}

    # --- construction -------------------------------------------------------

    @classmethod
    def from_tokenizer_json(cls, path: str | Path) -> "ByteLevelBPE":
        """Build from a HF tokenizer.json (model.type == BPE, byte-level)."""
        blob = json.loads(Path(path).read_text())
        model = blob["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')}")
        vocab = model["vocab"]
        merges = [
            tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in model["merges"]
        ]
        added = {
            t["content"]: t["id"] for t in blob.get("added_tokens", [])
        }
        split = _find_split_pattern(blob.get("pre_tokenizer")) or QWEN2_SPLIT
        return cls(vocab, merges, added, split)

    @classmethod
    def from_gguf(cls, path: str | Path) -> "ByteLevelBPE":
        """Build from GGUF metadata (tokenizer.ggml.tokens/merges/token_type).

        token_type: 1 = normal, anything else (control/user-defined — the 6
        specials + speech tokens in NeuTTS GGUFs) becomes an added token."""
        from neutts_tpu_torch.models.convert import read_gguf_metadata

        return cls.from_gguf_metadata(read_gguf_metadata(path))

    @classmethod
    def from_gguf_metadata(cls, meta: Dict) -> "ByteLevelBPE":
        tokens = meta.get("tokenizer.ggml.tokens")
        merges_raw = meta.get("tokenizer.ggml.merges")
        if tokens is None or merges_raw is None:
            raise ValueError("GGUF metadata lacks tokenizer tokens/merges")
        types = meta.get("tokenizer.ggml.token_type")
        vocab: Dict[str, int] = {}
        added: Dict[str, int] = {}
        for i, t in enumerate(tokens):
            if types is not None and int(types[i]) != 1:
                added[t] = i
            else:
                vocab[t] = i
        merges = [tuple(m.split(" ", 1)) for m in merges_raw]
        return cls(vocab, merges, added)

    # --- core BPE -----------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        """Merge a pre-token (unicode-mapped bytes) by ascending merge rank."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token)
        while len(word) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            first, second = word[best_i], word[best_i + 1]
            # merge EVERY adjacent (first, second) left-to-right (HF behavior)
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        if len(self._bpe_cache) < 65_536:
            self._bpe_cache[token] = word
        return word

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        for pre in self._split.findall(text):
            mapped = "".join(self._b2u[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                i = self.vocab.get(piece)
                if i is None:
                    # unknown piece: fall back to single mapped bytes
                    for ch in piece:
                        j = self.vocab.get(ch)
                        if j is not None:
                            ids.append(j)
                else:
                    ids.append(i)
        return ids

    # --- public surface ------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        if self._added_re is None:
            return self._encode_text(text)
        ids: List[int] = []
        for part in self._added_re.split(text):
            if not part:
                continue
            hit = self.added.get(part)
            if hit is not None:
                ids.append(hit)
            else:
                ids.extend(self._encode_text(part))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                bs = bytes(self._u2b[c] for tok in buf for c in tok)
                out.append(bs.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            tok = self.ids_to_tokens.get(int(i))
            if tok is None:
                continue
            if int(i) in set(self.added.values()):
                flush()
                out.append(tok)
            else:
                buf.append(tok)
        flush()
        return "".join(out)

    @property
    def vocab_size(self) -> int:
        top = max(
            max(self.vocab.values(), default=-1),
            max(self.added.values(), default=-1),
        )
        return top + 1

    def convert_token_to_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        if token in self.vocab:
            return self.vocab[token]
        raise KeyError(token)


def _find_split_pattern(pre_tokenizer) -> Optional[str]:
    """Extract the Split regex from a tokenizer.json pre_tokenizer config
    (possibly nested in a Sequence)."""
    if not pre_tokenizer:
        return None
    t = pre_tokenizer.get("type")
    if t == "Sequence":
        for sub in pre_tokenizer.get("pretokenizers", []):
            pat = _find_split_pattern(sub)
            if pat:
                return pat
    if t == "Split":
        pat = pre_tokenizer.get("pattern", {})
        return pat.get("Regex") or pat.get("String")
    return None
