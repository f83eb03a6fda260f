"""Model and pipeline configuration for the PyTorch/CUDA port of NeuTTS.

A copy of `neutts_tpu.config`, kept here so the port imports nothing of the
JAX package (whose `__init__` pulls in jax). The two must stay equal; the
port's tests compare them field by field.

Capability parity notes (reference: neuphonic/neutts-air):
  * backbone sizes — reference README.md:42-45 (~360M Air / ~120M Nano active);
    the Air backbone derives from Qwen2.5-0.5B (reference TRAINING.md:33).
  * context window 2048 — reference neutts/neutts.py:85.
  * codec: 50 Hz, single 65,536-entry codebook, 16 kHz in / 24 kHz out —
    reference README.md:34, finetune_config.yaml:7, neutts/neutts.py:84-86.
  * vocab recipe (6 speech-control specials + 65,536 speech tokens appended to
    the text tokenizer) — reference TRAINING.md:38-58.

Everything here is static (hashable) so configs can be closed over by jit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --- Special-token layout -----------------------------------------------------
# The reference appends, in order, 6 control tokens then 65,536 speech tokens to
# the backbone tokenizer (reference TRAINING.md:38-56). Ids below follow that
# layout relative to `n_text_tokens`; when loading a real checkpoint the
# converter overrides them from tokenizer metadata.
SPECIAL_TOKEN_NAMES: Tuple[str, ...] = (
    "<|TEXT_REPLACE|>",
    "<|TEXT_PROMPT_START|>",
    "<|TEXT_PROMPT_END|>",
    "<|SPEECH_REPLACE|>",
    "<|SPEECH_GENERATION_START|>",
    "<|SPEECH_GENERATION_END|>",
)


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Where the speech-control and speech-code tokens live in the vocab."""

    n_text_tokens: int  # size of the underlying text tokenizer
    n_special_tokens: int = len(SPECIAL_TOKEN_NAMES)
    codebook_size: int = 65_536
    # Real checkpoints normally place <|speech_0|> right after the 6 control
    # tokens; a checkpoint with a different placement sets this so the layout
    # math (speech_token / code_of / vocab_size) uses the TRUE base instead of
    # the contiguous assumption (fixes the dead _speech_base_override of r1).
    speech_base_override: int | None = None

    @property
    def text_replace(self) -> int:
        return self.n_text_tokens + 0

    @property
    def text_prompt_start(self) -> int:
        return self.n_text_tokens + 1

    @property
    def text_prompt_end(self) -> int:
        return self.n_text_tokens + 2

    @property
    def speech_replace(self) -> int:
        return self.n_text_tokens + 3

    @property
    def speech_gen_start(self) -> int:
        return self.n_text_tokens + 4

    @property
    def speech_gen_end(self) -> int:
        return self.n_text_tokens + 5

    @property
    def speech_base(self) -> int:
        """Token id of <|speech_0|>."""
        if self.speech_base_override is not None:
            return self.speech_base_override
        return self.n_text_tokens + self.n_special_tokens

    @property
    def vocab_size(self) -> int:
        return self.speech_base + self.codebook_size

    def speech_token(self, code: int) -> int:
        return self.speech_base + code

    def code_of(self, token: int) -> int:
        return token - self.speech_base


# Qwen2.5 tokenizer length (151,643 BPE merges + 22 added specials); see
# reference TRAINING.md:33 for the Qwen2.5-0.5B provenance of the backbone.
QWEN25_TEXT_TOKENS = 151_665
DEFAULT_LAYOUT = TokenLayout(n_text_tokens=QWEN25_TEXT_TOKENS)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Qwen2.5-style causal LM (RMSNorm, SwiGLU, GQA, RoPE, QKV bias)."""

    name: str
    vocab_size: int
    hidden_size: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = True
    max_context: int = 2048  # reference neutts/neutts.py:85
    n_text_tokens: int = QWEN25_TEXT_TOKENS
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"  # "bfloat16" | "int8" (per-token scales) |
    # "int4" (nibble-packed pairs, per-token scales — 4x bf16 cache
    # capacity and half the int8 decode-attention bytes) | "auto"
    # (resolved per call site by expected total context: int8 below
    # KV_AUTO_CROSSOVER tokens, int4 at/above — see resolve_kv_dtype)
    # dtype of the decode-loop logits buffer (untrimmed LM-head path only).
    # bf16 halves the [B, 217k] logit HBM traffic; top-k candidates are
    # upcast to f32 before sampling. Greedy parity gates use the trimmed f32
    # path regardless.
    logits_dtype: str = "float32"

    @property
    def layout(self) -> TokenLayout:
        # codebook size derived from the vocab so custom layouts (e.g. the
        # 64-code test config) stay consistent with vocab_size
        return TokenLayout(
            n_text_tokens=self.n_text_tokens,
            codebook_size=self.vocab_size
            - self.n_text_tokens
            - len(SPECIAL_TOKEN_NAMES),
        )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Embedding rows rounded up to a lane multiple for MXU-friendly matmuls."""
        return round_up(self.vocab_size, 256)

    @property
    def n_cache_layers(self) -> int:
        """Layers that keep K/V in the cache: all of them in the Qwen2 block."""
        return self.n_layers

    def scaled(self, **kw) -> "BackboneConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Lfm2Config(BackboneConfig):
    """LFM2-MoE backbone (LiquidAI LFM2-8B-A1B, HF `lfm2_moe`): per layer
    either a gated short convolution or GQA attention with RMSNorm over each
    head's q and k and no QKV bias; a dense SwiGLU FFN (`intermediate_size`)
    in the first `n_dense_layers` layers and routed experts after them
    (sigmoid scores, top-k on score + expert bias, weights from the scores
    normalised to sum 1). A port-only architecture: the JAX package runs
    the Qwen2 block alone, and the port serves this one through the
    `Engine` (`models/lfm2.py`)."""

    layer_types: Tuple[str, ...] = ()  # "conv" | "full_attention", one per layer
    conv_kernel: int = 3  # conv_L_cache: taps of the causal depthwise convolution
    n_experts: int = 32
    n_experts_per_tok: int = 4
    moe_intermediate_size: int = 1792
    n_dense_layers: int = 2

    def __post_init__(self):
        if len(self.layer_types) != self.n_layers or not set(self.layer_types) <= {
                "conv", "full_attention"}:
            raise ValueError(f"{self.name}: layer_types must give 'conv' or 'full_attention' "
                             f"for each of {self.n_layers} layers")

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "full_attention")

    @property
    def conv_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == "conv")

    @property
    def n_cache_layers(self) -> int:
        return len(self.attn_layers)

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers


def require_qwen2(cfg: BackboneConfig, what: str) -> None:
    """Refuse an LFM2 config on a path that runs the Qwen2 block alone (the
    single-stream decode, tensor parallelism, training)."""
    if isinstance(cfg, Lfm2Config):
        raise NotImplementedError(
            f"{what} runs the Qwen2 block; {cfg.name} (conv and expert layers) is served by "
            f"serving.Engine and serving.MultiChipEngine alone")


# kv_dtype="auto" crossover (total context tokens): int8 below, int4 at or
# above. The JAX package set it to 0 from its own TPU v5e measurements
# (KV_AUTO_r05.json, which say nothing about this port); the port keeps the
# same value so that both packages resolve "auto" alike, to int4. int8
# stays the DEFAULT kv_dtype for its finer quantization (255 vs 15
# levels); "auto" is the explicit performance mode. The H100's int4 and
# int8 times are in PERF.md.
KV_AUTO_CROSSOVER = 0


def resolve_kv_dtype(cfg: "BackboneConfig", total_ctx: int) -> "BackboneConfig":
    """Resolve kv_dtype="auto" by the call site's expected TOTAL context
    (prompt + generation budget). No-op for explicit kv dtypes."""
    if cfg.kv_dtype != "auto":
        return cfg
    return cfg.scaled(
        kv_dtype="int8" if total_ctx < KV_AUTO_CROSSOVER else "int4"
    )


def _lm(name: str, layout: TokenLayout, **kw) -> BackboneConfig:
    return BackboneConfig(
        name=name,
        vocab_size=layout.vocab_size,
        n_text_tokens=layout.n_text_tokens,
        **kw,
    )


# NeuTTS-Air: Qwen2.5-0.5B geometry (hidden 896 / 24 layers / 14 heads / 2 KV
# heads / ffn 4864), extended vocab. ~358M non-embedding params, ~553M with the
# tied embedding — matches reference README.md:44 (~360M / ~552M incl. emb).
AIR = _lm(
    "neutts-air",
    DEFAULT_LAYOUT,
    hidden_size=896,
    n_layers=24,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    intermediate_size=4864,
)

# NeuTTS-Nano: ~120M active / ~229M incl. embeddings (reference README.md:45).
# GUESSED geometry (the real Nano checkpoint is not inspectable offline):
# 512-wide embedding gives 217k x 512 = 111M embedding params; 24 x (hidden
# 512, ffn 2816) blocks give ~109M active. Proportions follow the Qwen2.5
# family recipe the Air derives from; the converter overrides every field
# from a real checkpoint's config.json.
NANO = _lm(
    "neutts-nano",
    DEFAULT_LAYOUT,
    hidden_size=512,
    n_layers=24,
    n_heads=8,
    n_kv_heads=2,
    head_dim=64,
    intermediate_size=2816,
)

# Tiny config for unit tests (same layout logic on a toy vocab).
TEST_LAYOUT = TokenLayout(n_text_tokens=320, codebook_size=64)
TINY = _lm(
    "neutts-tiny",
    TEST_LAYOUT,
    hidden_size=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    max_context=512,
    dtype="float32",  # f32 activations keep the unit-test oracles tight
)


# LFM2-8B-A1B (huggingface.co/LiquidAI/LFM2-8B-A1B config.json): 18 conv and
# 6 attention layers, 32 experts of 1,792 (top 4) after 2 dense layers of
# 7,168. Its 65,536 text ids are extended by the 6 control tokens and 65,536
# speech codes, as NeuTTS-Air extended Qwen2.5's (vocab 131,078).
LFM2_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))
LFM2_LAYOUT = TokenLayout(n_text_tokens=65_536)
LFM2_8B_A1B = Lfm2Config(
    name="lfm2-8b-a1b",
    vocab_size=LFM2_LAYOUT.vocab_size,
    n_text_tokens=LFM2_LAYOUT.n_text_tokens,
    hidden_size=2048,
    n_layers=24,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    intermediate_size=7168,
    rms_norm_eps=1e-5,
    layer_types=LFM2_LAYER_TYPES,
)

# Tiny LFM2-MoE for unit tests: the conv/attention pattern, 2 dense layers,
# 8 experts, top 2.
LFM2_TINY = Lfm2Config(
    name="lfm2-tiny",
    vocab_size=TEST_LAYOUT.vocab_size,
    n_text_tokens=TEST_LAYOUT.n_text_tokens,
    hidden_size=64,
    n_layers=6,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    rms_norm_eps=1e-5,
    max_context=512,
    dtype="float32",
    layer_types=("conv", "conv", "full_attention", "conv", "full_attention", "conv"),
    n_experts=8,
    n_experts_per_tok=2,
    moe_intermediate_size=32,
)


@dataclasses.dataclass(frozen=True)
class SemanticConfig:
    """w2v-BERT 2.0 Conformer geometry for the codec's SEMANTIC encoder
    branch (models/semantic.py; defaults = the released facebook/
    w2v-bert-2.0 the public XCodec2 lineage consumes)."""

    input_dim: int = 160  # 80 log-mel bins x 2-frame stacking
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    intermediate: int = 4096
    conv_kernel: int = 31
    left_max: int = 64
    right_max: int = 8
    eps: float = 1e-5
    # which layer's OUTPUT feeds the codec (XCodec2 taps hidden_states[16];
    # index counts applied conformer layers, so 16 = after the 16th layer)
    output_layer: int = 16

    @property
    def head_dim(self) -> int:
        assert self.hidden % self.n_heads == 0
        return self.hidden // self.n_heads

    @property
    def n_positions(self) -> int:
        return self.left_max + self.right_max + 1


@dataclasses.dataclass(frozen=True)
class CodecEncConfig:
    """XCodec2-lineage acoustic CodecEncoder geometry (models/codecenc.py) —
    the REAL NeuCodec encoder family behind `encode_code` (reference
    neutts/neutts.py:266-271): DAC/EnCodec conv stack with snake
    activations, optional EnCodec-style stacked LSTM, WN convs. All fields
    are RECOVERED from checkpoint key layout + weight shapes by
    models/convert_codec.py; defaults mirror the public lineage
    (ngf 48, strides (2,2,4,4,5) -> hop 320, dilations (1,3,9))."""

    ngf: int = 48
    up_ratios: Tuple[int, ...] = (2, 2, 4, 4, 5)
    dilations: Tuple[int, ...] = (1, 3, 9)
    out_channels: int = 1024
    rnn_layers: int = 2  # 0 = no SLSTM stage
    # snake wrapped in BigVGAN alias-free up2/snake/down2 (kaiser-sinc)
    alias_free: bool = True
    act_kernel: int = 12  # kaiser-sinc filter taps for the alias-free path
    # SnakeBeta alpha_logscale (params are log alpha / log beta); plain DAC
    # Snake1d checkpoints (alpha only, linear scale) set this False
    snake_logscale: bool = True

    @property
    def hop(self) -> int:
        h = 1
        for s in self.up_ratios:
            h *= s
        return h


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """NeuCodec-equivalent: 16 kHz in -> 50 Hz FSQ codes -> 24 kHz out.

    Invariants pinned by the reference: frame rate 50 Hz, single codebook of
    65,536 entries, encoder input 16 kHz mono, decoder output 24 kHz, decoder
    hop 480 samples (reference neutts/neutts.py:84-86, README.md:34).
    FSQ with 8 dims x 4 levels gives exactly 4**8 = 65,536 codes.

    Architecture family: the reference's codec (the external `neucodec`
    package, reference neutts/neutts.py:186-214) derives from the public
    XCodec2 design — ResidualFSQ quantizer (lucidrains
    vector-quantize-pytorch conventions) with project_in/project_out around
    an acoustic+semantic encoder, and a Vocos-family decoder (sequence
    backbone + ISTFT head) rather than transposed convs. The decoder here
    implements that family with the backbone selectable ("transformer" |
    "convnext"); real-checkpoint hyperparameters are RECOVERED from weight
    shapes by models/convert_codec.py, these defaults cover synthetic runs.
    """

    name: str = "neucodec-tpu"
    sample_rate_in: int = 16_000
    sample_rate_out: int = 24_000
    frame_rate: int = 50
    codebook_size: int = 65_536
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4, 4, 4)
    # encoder: downsample 16000/50 = 320x (from-scratch trainable design);
    # when `semantic` is set the encoder ALSO carries the w2v-BERT semantic
    # branch of the real NeuCodec encode path (models/semantic.py): tower
    # features are projected to sem_proj_dim and concatenated with the
    # acoustic features before the fc_prior projection
    semantic: Optional[SemanticConfig] = None
    sem_proj_dim: int = 1024
    # semantic projection flavor: "linear" (our trainable design) | "conv"
    # (the real XCodec2 SemanticEncoder conv stack, models/codecenc.py)
    sem_encoder: str = "linear"
    # acoustic branch family: "ours" (from-scratch trainable residual
    # stages below) | "codecenc" (the real XCodec2/DAC stack, geometry in
    # `codecenc`, recovered from real checkpoints by convert_codec.py)
    enc_family: str = "ours"
    codecenc: Optional[CodecEncConfig] = None
    enc_strides: Tuple[int, ...] = (2, 4, 5, 8)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256)
    enc_hidden: int = 256
    # quantizer projections (ResidualFSQ family): features are projected
    # vq_dim -> len(fsq_levels) before quantization and back after
    vq_dim: int = 2048
    # decoder: Vocos family — backbone over 50 Hz frames + ISTFT head
    dec_backbone: str = "transformer"  # "transformer" | "convnext"
    dec_dim: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_intermediate: int = 3072
    dec_rope: bool = True  # rotary position embedding on attention q/k
    dec_rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # ISTFT head: hop 480 @24 kHz == one 50 Hz frame; n_fft = 4x hop
    n_fft: int = 1920
    hop_out: int = 480
    dtype: str = "float32"

    @property
    def hop_in(self) -> int:
        if self.enc_family == "codecenc" and self.codecenc is not None:
            return self.codecenc.hop
        h = 1
        for s in self.enc_strides:
            h *= s
        return h  # 320

    @property
    def fsq_dim(self) -> int:
        return len(self.fsq_levels)

    @property
    def head_dim(self) -> int:
        assert self.dec_dim % self.dec_heads == 0
        return self.dec_dim // self.dec_heads

    def scaled(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


CODEC = CodecConfig()
CODEC_TINY = CodecConfig(
    name="neucodec-tiny",
    enc_channels=(8, 8, 16, 16),
    enc_hidden=16,
    vq_dim=16,
    dec_dim=32,
    dec_layers=2,
    dec_heads=2,
    dec_intermediate=64,
)


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Chunked vocoder streaming windows (reference neutts/neutts.py:86-91)."""

    overlap_frames: int = 1
    frames_per_chunk: int = 25
    lookforward: int = 5
    lookback: int = 50
    hop_length: int = 480
    # Size of the FIRST emitted chunk, in frames. The reference waits for a
    # full 25+5 frames (~600 ms of decode) before any audio; a smaller first
    # chunk (e.g. 10) cuts time-to-first-audio proportionally at the cost of
    # one extra vocoder window. Default mirrors the reference cadence.
    first_chunk_frames: int = 25

    @property
    def stride_samples(self) -> int:
        return self.frames_per_chunk * self.hop_length


# Low-latency streaming preset: ~2.5x lower time-to-first-audio (first chunk
# after 10+5 frames instead of 25+5), then standard 25-frame cadence.
STREAMING_LOW_LATENCY_FIRST = 10


STREAMING = StreamingConfig()


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Decode-time sampling (reference neutts/neutts.py:338-346, 363-369)."""

    temperature: float = 1.0
    top_k: int = 50
    min_new_tokens: int = 50
    max_context: int = 2048
    greedy: bool = False
    exact_topk: bool = False  # exact lax.top_k (slow on TPU; parity only)
    # When set to (speech_base, speech_base + codebook_size), sampling is
    # restricted to speech tokens + EOS. The reference relies on the model to
    # stay in range and silently DROPS off-range picks in its regex extraction
    # (reference neutts/neutts.py:276); constraining instead keeps batched
    # serving robust to rare off-distribution picks. None = unconstrained.
    speech_range: Tuple[int, int] | None = None

    def constrained_to(self, layout: "TokenLayout") -> "SamplingConfig":
        """This config with sampling constrained to `layout`'s speech tokens."""
        return dataclasses.replace(
            self, speech_range=(layout.speech_base, layout.vocab_size)
        )


BY_NAME = {
    "air": AIR,
    "nano": NANO,
    "tiny": TINY,
    "neutts-air": AIR,
    "neutts-nano": NANO,
}
