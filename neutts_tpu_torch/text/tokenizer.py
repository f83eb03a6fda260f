"""Host-side tokenization for the speech LM.

The reference uses the HF Qwen2.5 tokenizer extended with 6 control tokens and
65,536 `<|speech_N|>` tokens (reference TRAINING.md:38-58; prompt assembly at
neutts/neutts.py:303-332). Tokenization is pure host-side work — it runs before
device dispatch and never touches the TPU.

Two backends behind one interface:

* `HFTokenizer` — wraps a local `transformers` tokenizer directory (the real
  checkpoint path); used for parity with the reference when weights are
  available. Reads the true special/speech token ids from the tokenizer.
* `ByteTokenizer` — self-contained byte-level fallback with the same special
  -token layout (`config.TokenLayout`); deterministic, dependency-free, used
  by tests and synthetic models.

Both treat `<|speech_N|>` and the control tokens as atomic, mirroring HF
`add_tokens` semantics (added tokens are split out before BPE).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from neutts_tpu_torch.config import SPECIAL_TOKEN_NAMES, TokenLayout

_SPEECH_RE = re.compile(r"<\|speech_(\d+)\|>")
_SPECIAL_OR_SPEECH_RE = re.compile(
    r"(<\|speech_\d+\|>|" + "|".join(re.escape(s) for s in SPECIAL_TOKEN_NAMES) + r")"
)


class ByteTokenizer:
    """Byte-level text tokenizer + NeuTTS special/speech token layout.

    Text bytes map to ids [0, 256); ids [256, n_text_tokens) are unused
    padding of the text range so the layout math matches a larger tokenizer.
    """

    def __init__(self, layout: TokenLayout):
        assert layout.n_text_tokens >= 257, "need room for 256 bytes + pad id"
        self.layout = layout
        self.pad_id = 256  # first unused text id

    @property
    def vocab_size(self) -> int:
        return self.layout.vocab_size

    def convert_token_to_id(self, token: str) -> int:
        if token in SPECIAL_TOKEN_NAMES:
            return self.layout.n_text_tokens + SPECIAL_TOKEN_NAMES.index(token)
        m = _SPEECH_RE.fullmatch(token)
        if m:
            return self.layout.speech_token(int(m.group(1)))
        raise KeyError(token)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in _SPECIAL_OR_SPEECH_RE.split(text):
            if not part:
                continue
            if _SPECIAL_OR_SPEECH_RE.fullmatch(part):
                ids.append(self.convert_token_to_id(part))
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            nonlocal byte_buf
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf = bytearray()

        lay = self.layout
        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
            elif lay.n_text_tokens <= i < lay.speech_base:
                flush()
                out.append(SPECIAL_TOKEN_NAMES[i - lay.n_text_tokens])
            elif lay.speech_base <= i < lay.vocab_size:
                flush()
                out.append(f"<|speech_{i - lay.speech_base}|>")
            # pad range: dropped
        flush()
        return "".join(out)


class HFTokenizer:
    """Real-checkpoint tokenizer with the NeuTTS vocab, self-contained.

    `path` may be a checkpoint directory (containing `tokenizer.json`), a
    `tokenizer.json` file, or a `.gguf` file (vocab/merges read from
    `tokenizer.ggml.*` metadata). All three load through the first-party
    byte-level BPE (text/bpe.py, oracle-pinned vs the HF `tokenizers`
    runtime in tests/test_bpe.py) — no `transformers` dependency. A
    directory without tokenizer.json falls back to `transformers` if it is
    importable.

    The special/speech ids are read from the vocab itself so the layout is
    exact for real checkpoints (including non-contiguous speech bases).
    """

    def __init__(self, path: str):
        from pathlib import Path as _P

        p = _P(path)
        self._tok = None
        self._bpe = None
        if p.suffix == ".gguf":
            from neutts_tpu_torch.text.bpe import ByteLevelBPE

            self._bpe = ByteLevelBPE.from_gguf(p)
        elif (p / "tokenizer.json").exists() or p.name == "tokenizer.json":
            from neutts_tpu_torch.text.bpe import ByteLevelBPE

            jf = p if p.name == "tokenizer.json" else p / "tokenizer.json"
            self._bpe = ByteLevelBPE.from_tokenizer_json(jf)
        else:
            from transformers import AutoTokenizer  # lazy fallback

            self._tok = AutoTokenizer.from_pretrained(path)

        base = self.convert_token_to_id("<|speech_0|>")
        n_text = self.convert_token_to_id(SPECIAL_TOKEN_NAMES[0])
        unk = self._tok.unk_token_id if self._tok is not None else None
        if base is None or n_text is None or (unk is not None and base == unk):
            raise ValueError(f"tokenizer at {path} lacks NeuTTS speech tokens")
        layout = TokenLayout(n_text_tokens=n_text)
        if base != layout.speech_base:
            # Non-contiguous layout (speech tokens not right after the 6
            # specials): carry the TRUE base so speech_token()/code_of()
            # build correct ids (r1's dead _speech_base_override, fixed).
            layout = TokenLayout(n_text_tokens=n_text, speech_base_override=base)
        self.layout = layout
        self.pad_id = (
            (self._tok.pad_token_id or 0) if self._tok is not None else 0
        )

    @property
    def vocab_size(self) -> int:
        return len(self._tok) if self._tok is not None else self._bpe.vocab_size

    def convert_token_to_id(self, token: str) -> int:
        if self._bpe is not None:
            try:
                return self._bpe.convert_token_to_id(token)
            except KeyError:
                return None
        return self._tok.convert_tokens_to_ids(token)

    def encode(self, text: str) -> List[int]:
        if self._bpe is not None:
            return self._bpe.encode(text)
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        if self._bpe is not None:
            return self._bpe.decode(list(ids))
        return self._tok.decode(list(ids))


def extract_speech_codes(ids: Sequence[int], layout: TokenLayout) -> List[int]:
    """Direct integer-token flow: filter generated ids down to codec codes.

    Replaces the reference's detokenize-then-regex round trip
    (re.findall(r"<\\|speech_(\\d+)\\|>", ...), reference neutts/neutts.py:276)
    with id arithmetic — no string materialization on the hot path.
    """
    base, top = layout.speech_base, layout.vocab_size
    return [int(i) - base for i in ids if base <= int(i) < top]
