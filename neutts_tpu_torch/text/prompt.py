"""Prompt construction for voice-cloned synthesis.

Replicates the reference's two prompt layouts exactly at the token level —
this is the correctness-critical glue for bit-exact parity (SURVEY.md §7.2):

* torch path (reference neutts/neutts.py:303-332): tokenize the chat skeleton
  `"user: Convert the text to speech:<|TEXT_REPLACE|>\\nassistant:<|SPEECH_REPLACE|>"`,
  splice `<|TEXT_PROMPT_START|>` + phoneme ids + `<|TEXT_PROMPT_END|>` at the
  TEXT_REPLACE slot, then truncate at SPEECH_REPLACE and append
  `<|SPEECH_GENERATION_START|>` + the reference speaker's code tokens. Note
  the prompt *ends* with the ref codes — everything after SPEECH_REPLACE is
  dropped.
* GGUF path (reference neutts/neutts.py:354-371): the equivalent f-string;
  after tokenization both paths produce the same id sequence, so one function
  serves both.

Ref-speaker phonemes and input phonemes are concatenated with a single space
(reference neutts/neutts.py:307).
"""

from __future__ import annotations

from typing import List, Sequence

CHAT_TEMPLATE = "user: Convert the text to speech:<|TEXT_REPLACE|>\nassistant:<|SPEECH_REPLACE|>"


def build_prompt_ids(
    tokenizer,
    g2p,
    ref_codes: Sequence[int],
    ref_text: str,
    input_text: str,
) -> List[int]:
    """Token ids for the cloning prompt; generation continues with speech codes."""
    phones = g2p.phonemize(ref_text) + " " + g2p.phonemize(input_text)
    lay = tokenizer.layout

    text_replace = tokenizer.convert_token_to_id("<|TEXT_REPLACE|>")
    speech_replace = tokenizer.convert_token_to_id("<|SPEECH_REPLACE|>")
    text_start = tokenizer.convert_token_to_id("<|TEXT_PROMPT_START|>")
    text_end = tokenizer.convert_token_to_id("<|TEXT_PROMPT_END|>")
    speech_start = tokenizer.convert_token_to_id("<|SPEECH_GENERATION_START|>")

    ids = tokenizer.encode(CHAT_TEMPLATE)
    t_idx = ids.index(text_replace)
    ids = (
        ids[:t_idx]
        + [text_start]
        + tokenizer.encode(phones)
        + [text_end]
        + ids[t_idx + 1 :]
    )
    s_idx = ids.index(speech_replace)
    code_ids = [lay.speech_token(int(c)) for c in ref_codes]
    return ids[:s_idx] + [speech_start] + code_ids


def build_training_ids(
    tokenizer,
    g2p,
    codes: Sequence[int],
    text: str,
) -> List[int]:
    """Supervised sample layout used by the finetune path: same template with
    the target codes and a closing <|SPEECH_GENERATION_END|> (reference
    examples/finetune.py:66-76)."""
    phones = g2p.phonemize(text)
    lay = tokenizer.layout
    text_replace = tokenizer.convert_token_to_id("<|TEXT_REPLACE|>")
    speech_replace = tokenizer.convert_token_to_id("<|SPEECH_REPLACE|>")
    ids = tokenizer.encode(CHAT_TEMPLATE)
    t_idx = ids.index(text_replace)
    ids = (
        ids[:t_idx]
        + [tokenizer.convert_token_to_id("<|TEXT_PROMPT_START|>")]
        + tokenizer.encode(phones)
        + [tokenizer.convert_token_to_id("<|TEXT_PROMPT_END|>")]
        + ids[t_idx + 1 :]
    )
    s_idx = ids.index(speech_replace)
    return (
        ids[:s_idx]
        + [tokenizer.convert_token_to_id("<|SPEECH_GENERATION_START|>")]
        + [lay.speech_token(int(c)) for c in codes]
        + [tokenizer.convert_token_to_id("<|SPEECH_GENERATION_END|>")]
    )
