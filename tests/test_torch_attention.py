"""Port attention (neutts_tpu_torch.ops.attention) against the JAX package.

The plain PyTorch versions run here on the CPU — the same functions the CUDA
kernels compute, and what chip_smoke.py holds the kernels against on the
card. They are compared with the TPU kernels in Pallas interpret mode and
with the XLA oracles, on the same numpy inputs. Cases mirror
tests/test_attention.py at reduced sizes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu.models import backbone as jbb
from neutts_tpu.ops import attention as jattn
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.ops import attention as tattn


def _mk(B, K, G, T, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    ck = rng.standard_normal((B, T, K * D)).astype(np.float32)
    cv = rng.standard_normal((B, T, K * D)).astype(np.float32)
    return q, ck, cv


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("lens_pad", [
    ([256, 256], [0, 0]),
    ([257 - 64, 100], [0, 3]),  # ragged rows crossing tile boundaries
    ([256, 7], [5, 0]),
    ([1, 1], [0, 0]),           # single-slot attention
])
def test_decode_f32_matches_kernel_and_oracle(lens_pad):
    """f32 cache: plain == XLA oracle and == Pallas kernel (interpret) to
    2e-5 (f32 summation order only)."""
    B, K, G, T, D = 2, 2, 7, 256, 64
    q, ck, cv = _mk(B, K, G, T, D)
    lens, pad = np.asarray(lens_pad[0], np.int32), np.asarray(lens_pad[1], np.int32)
    got = tattn.decode_attention(_t(q), _t(ck)[None], _t(cv)[None], 0, _t(lens), _t(pad))
    want = jattn.decode_attention_xla(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                      jnp.asarray(lens), jnp.asarray(pad))
    kern = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(lens), jnp.asarray(pad), block_t=128,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-5, atol=2e-5)


def test_decode_bf16_cache():
    """bf16 q and cache: the port keeps probabilities in f32 where the JAX
    paths cast them to bf16 before the PV product; bf16 rounding of inputs
    and output bounds the gap at 2e-2 (as tests/test_attention.py)."""
    B, K, G, T, D = 2, 2, 7, 256, 64
    q, ck, cv = _mk(B, K, G, T, D, seed=1)
    lens, pad = np.asarray([200, 256], np.int32), np.asarray([0, 2], np.int32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv))
    got = tattn.decode_attention(
        _t(q, torch.bfloat16), _t(ck, torch.bfloat16)[None], _t(cv, torch.bfloat16)[None], 0,
        _t(lens), _t(pad))
    assert got.dtype == torch.bfloat16
    for want in (
        jattn.decode_attention_xla(jq, jk, jv, jnp.asarray(lens), jnp.asarray(pad)),
        jattn.decode_attention(jq, jk, jv, jnp.asarray(lens), jnp.asarray(pad), block_t=128,
                               interpret=True),
    ):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_decode_int8_cache_stacked_layer():
    """int8 cache with per-token scales, read from layer 1 of a stacked
    [L, B, T, KD] cache: plain == XLA oracle on the dequantized cache to
    1e-5 (same f32 math), and == the Pallas int8 kernel to 2e-2 (it rounds
    probabilities to bf16)."""
    B, K, G, T, D = 2, 2, 7, 256, 64
    q, ck, cv = _mk(B, K, G, T, D, seed=2)
    kq, ks = jbb.quantize_kv(jnp.asarray(ck))
    vq, vs = jbb.quantize_kv(jnp.asarray(cv))
    lens, pad = np.asarray([150, 256], np.int32), np.asarray([0, 2], np.int32)
    # the port's own quantize_kv gives the same int8 values and scales
    tq, tks = tbb.quantize_kv(_t(ck))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(kq))
    np.testing.assert_allclose(tks.numpy(), np.asarray(ks), rtol=1e-7)
    stack = lambda a: np.stack([np.zeros_like(np.asarray(a)), np.asarray(a)])  # noqa: E731
    got = tattn.decode_attention(
        _t(q), _t(stack(kq)), _t(stack(vq)), 1, _t(lens), _t(pad),
        _t(stack(ks)), _t(stack(vs)))
    deq_k = kq.astype(jnp.float32) * ks[..., None]
    deq_v = vq.astype(jnp.float32) * vs[..., None]
    want = jattn.decode_attention_xla(jnp.asarray(q), deq_k, deq_v, jnp.asarray(lens),
                                      jnp.asarray(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kern = jattn.decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(stack(kq)), jnp.asarray(stack(vq)), jnp.int32(1),
        jnp.asarray(lens), jnp.asarray(pad), k_scale=jnp.asarray(stack(ks)),
        v_scale=jnp.asarray(stack(vs)), block_t=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-2, atol=2e-2)


def test_decode_ignores_tail():
    """Slots at or beyond lens never reach the output."""
    B, K, G, T, D = 1, 2, 3, 128, 16
    q, ck, cv = _mk(B, K, G, T, D, seed=3)
    lens, pad = _t(np.asarray([40], np.int32)), _t(np.asarray([0], np.int32))
    base = tattn.decode_attention(_t(q), _t(ck)[None], _t(cv)[None], 0, lens, pad)
    ck[:, 40:] = 1e6
    cv[:, 40:] = -1e6
    got = tattn.decode_attention(_t(q), _t(ck)[None], _t(cv)[None], 0, lens, pad)
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def _partial(qb, k, v):
    """One chunk's unnormalised partial (acc [K, G, D], m [K, G], l [K, G])
    of the query heads qb [K, G, D] over k/v [t, K, D]; an empty chunk gives
    (0, -1e30, 0)."""
    K, G, D = qb.shape
    if k.shape[0] == 0:
        return torch.zeros(K, G, D), torch.full((K, G), -1e30), torch.zeros(K, G)
    sc = torch.einsum("kgd,tkd->kgt", qb.float(), k) * D**-0.5
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    return torch.einsum("kgt,tkd->kgd", p, v), m, p.sum(-1)


def _chunk_partials(qb, k, v, lo, hi, nsplit, int4):
    """The partials of the `nsplit` chunks of [lo, hi) (csrc/flash_decode.cuh
    chunk_of): chunks of a multiple of 64 tokens counted from lo (int4: lo
    rounded down to even, a whole byte)."""
    base = lo & ~1 if int4 else lo
    n = max(hi - base, 0)
    chunk = -(-(-(-n // nsplit)) // 64) * 64
    parts = []
    for s in range(nsplit):
        cs = base + min(s * chunk, n)
        clo, chi = max(cs, lo), min(cs + chunk, base + n)
        parts.append(_partial(qb, k[clo:max(clo, chi)], v[clo:max(clo, chi)]))
    return parts


def _merge(parts):
    """The merge of partials in index order (the last block's, in the kernel)."""
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    o, total = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
    for acc, m, l in parts:
        w = torch.exp(m - mx)
        o += w[..., None] * acc
        total += w * l
    return o / total.clamp_min(1e-30)[..., None]


def _split_k_decode(q, ck, cv, lens, pad, nsplit, int4):
    """What csrc/decode_attention.cu does, in torch (f32): [pad, lens) is cut
    into `nsplit` chunks of a multiple of 64 tokens (int4: counted from pad
    rounded down to even, a whole byte), each chunk gives an unnormalised
    partial (acc, m, l) (an empty chunk: 0, -1e30, 0), and the partials are
    merged in index order. q [B, K, G, D]; ck/cv [B, T, K*D] dequantized."""
    B, K, G, D = q.shape
    T = ck.shape[1]
    k, v = ck.reshape(B, T, K, D).float(), cv.reshape(B, T, K, D).float()
    out = torch.zeros(B, K, G, D)
    for b in range(B):
        lo, hi = int(pad[b]), min(int(lens[b]), T)
        out[b] = _merge(_chunk_partials(q[b], k[b], v[b], lo, hi, nsplit, int4))
    return out


def _staged_split_decode(q, ck, cv, sk, sv, base, pad, step, nsplit, int4):
    """What csrc/staged_attention.cu does, in torch (f32): the `nsplit`
    chunks of the settled range [pad, min(base, T)), then one partial over
    the staging columns [0, step], merged in index order. ck/cv [B, T, K*D]
    and sk/sv [B, S, K*D] dequantized."""
    B, K, G, D = q.shape
    T, S = ck.shape[1], sk.shape[1]
    k, v = ck.reshape(B, T, K, D).float(), cv.reshape(B, T, K, D).float()
    stk, stv = sk.reshape(B, S, K, D).float(), sv.reshape(B, S, K, D).float()
    out = torch.zeros(B, K, G, D)
    for b in range(B):
        lo, hi = int(pad[b]), min(int(base[b]), T)
        parts = _chunk_partials(q[b], k[b], v[b], lo, hi, nsplit, int4)
        parts.append(_partial(q[b], stk[b, : step + 1], stv[b, : step + 1]))
        out[b] = _merge(parts)
    return out


# rows: odd pad and lens, shorter than one chunk, empty (lens == pad), full
_SPLIT_LENS, _SPLIT_PAD = [301, 37, 77, 512], [3, 30, 77, 0]


@functools.lru_cache(maxsize=None)
def _split_case(mode):
    """Inputs (torch, dequantized f32 [B, T, KD] of layer 1) and the Pallas
    kernel's output (interpret mode) for one cache mode."""
    B, K, G, T, D = 4, 2, 7, 512, 64
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    lens, pad = np.asarray(_SPLIT_LENS, np.int32), np.asarray(_SPLIT_PAD, np.int32)
    jl, jp = jnp.asarray(lens), jnp.asarray(pad)
    if mode == "int4":
        kp, ks = _int4_cache(rng, 2, B, T, K * D)
        vp, vs = _int4_cache(rng, 2, B, T, K * D)
        ck, cv = tbb.dequant_kv4(_t(kp[1]), _t(ks[1])), tbb.dequant_kv4(_t(vp[1]), _t(vs[1]))
        kern = jattn.decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1), jl, jp,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_t=256, interpret=True)
    elif mode == "int8":
        kq, ks = jbb.quantize_kv(jnp.asarray(rng.standard_normal((2, B, T, K * D)), jnp.float32))
        vq, vs = jbb.quantize_kv(jnp.asarray(rng.standard_normal((2, B, T, K * D)), jnp.float32))
        ck = _t(np.asarray(kq[1], np.float32) * np.asarray(ks[1])[..., None])
        cv = _t(np.asarray(vq[1], np.float32) * np.asarray(vs[1])[..., None])
        kern = jattn.decode_attention_stacked(jnp.asarray(q), kq, vq, jnp.int32(1), jl, jp,
                                              k_scale=ks, v_scale=vs, block_t=128,
                                              interpret=True)
    else:  # bf16 q and cache
        jq = jnp.asarray(q, jnp.bfloat16)
        jk, jv = (jnp.asarray(rng.standard_normal((2, B, T, K * D)), jnp.bfloat16)
                  for _ in range(2))
        q = np.asarray(jq, np.float32)
        ck, cv = _t(np.asarray(jk[1], np.float32)), _t(np.asarray(jv[1], np.float32))
        kern = jattn.decode_attention_stacked(jq, jk, jv, jnp.int32(1), jl, jp, block_t=128,
                                              interpret=True)
    oracle = jattn.decode_attention_xla(jnp.asarray(q), jnp.asarray(ck.numpy()),
                                        jnp.asarray(cv.numpy()), jl, jp)
    return _t(q), ck, cv, lens, pad, np.asarray(kern, np.float32), np.asarray(oracle)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_split_k_merge_matches_pallas_kernel(mode, nsplit):
    """The split-K decode kernel's chunking and index-order merge, written
    out in torch, against the XLA oracle on the same dequantized f32 cache
    to 1e-5 (the same function, summed in another order), and against the
    Pallas decode kernel (interpret): each value within 2e-2 of it (it
    rounds probabilities to bf16), or no farther from it than the exact
    oracle is (the int4 kernel's hi-only combine rounds P_o - 16 P_e to
    bf16, which on the 7-token row moves single values by ~0.03). The empty
    row has no defined output: the split kernel writes zeros, the JAX paths
    a softmax over masked slots."""
    q, ck, cv, lens, pad, kern, oracle = _split_case(mode)
    got = _split_k_decode(q, ck, cv, lens, pad, nsplit, int4=mode == "int4").numpy()
    live = lens > pad
    np.testing.assert_allclose(got[live], oracle[live], rtol=1e-5, atol=1e-5)
    gap = np.abs(got - kern)[live]
    limit = np.maximum(2e-2 + 2e-2 * np.abs(kern[live]), np.abs(oracle - kern)[live] + 1e-5)
    assert (gap <= limit).all(), float(gap.max())
    assert not got[~live].any()


def _prefill_inputs(S, pads, H=14, K=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    B = len(pads)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v, np.asarray(pads, np.int32)


def _dense_mask(S, pads):
    idx = np.arange(S)
    mask = (idx[None, None, :] <= idx[None, :, None]) & (idx[None, None, :] >= pads[:, None, None])
    valid = idx[None, :] >= pads[:, None]
    return mask, valid


@pytest.mark.parametrize("S,pads", [
    (128, (0, 3, 100, 127)),  # a row that is pad but for its last token
    (192, (0, 64, 130, 191)),
])
def test_prefill_f32_matches_dense(S, pads):
    """f32: plain == backbone._attend_block_dense on the real rows (1e-5)
    and zero on the pad rows, where the JAX dense path leaves finite garbage."""
    q, k, v, padv = _prefill_inputs(S, pads)
    mask, valid = _dense_mask(S, padv)
    got = tattn.prefill_attention(_t(q), _t(k), _t(v), _t(padv)).numpy()
    want = np.asarray(jbb._attend_block_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jnp.asarray(mask)))
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-5)
    assert not got[~valid].any()


def test_prefill_bf16_matches_pallas_kernel():
    """bf16: plain vs the Pallas prefill kernel (interpret), pad rows zeroed
    by both. The kernel rounds the normalised probabilities to bf16 before
    PV, the plain version keeps them f32: 2e-2, as tests/test_attention.py."""
    S, pads = 256, (0, 3, 100, 255)
    q, k, v, padv = _prefill_inputs(S, pads, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jattn.prefill_attention(jq, jk, jv, jnp.asarray(padv), interpret=True)
    got = tattn.prefill_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16), _t(padv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_dispatch_is_by_device():
    """A CPU tensor takes the plain version; the kernel path is reached only
    for CUDA tensors (and then launches or raises, never falls back)."""
    q, ck, cv = _mk(1, 2, 2, 64, 16)
    args = (_t(q), _t(ck)[None], _t(cv)[None], 0, _t(np.asarray([10], np.int32)),
            _t(np.asarray([0], np.int32)))
    np.testing.assert_array_equal(tattn.decode_attention(*args).numpy(),
                                  tattn.decode_attention_plain(*args).numpy())
    with pytest.raises(ValueError):
        tattn.decode_attention(args[0].to("meta"), *args[1:])


# --- serving: staged decode, segment reconcile, admission write ------------------


def _staged_inputs(seed=0, L=2, B=4, T=256, K=2, G=2, D=16, S=16):
    rng = np.random.default_rng(seed)
    KD = K * D
    return dict(
        q=rng.standard_normal((B, K, G, D)).astype(np.float32),
        all_k=rng.integers(-127, 128, (L, B, T, KD)).astype(np.int8),
        all_v=rng.integers(-127, 128, (L, B, T, KD)).astype(np.int8),
        k_scale=rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32),
        v_scale=rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32),
        stag_k=rng.integers(-127, 128, (L, B, S, KD)).astype(np.int8),
        stag_v=rng.integers(-127, 128, (L, B, S, KD)).astype(np.int8),
        stag_ks=rng.uniform(0.01, 0.1, (L, B, tattn.SEG_PAD)).astype(np.float32),
        stag_vs=rng.uniform(0.01, 0.1, (L, B, tattn.SEG_PAD)).astype(np.float32),
    )


@pytest.mark.parametrize("step", [0, 15])
def test_staged_decode_matches_oracle_and_kernel(step):
    """int8 staged decode, layer 1 of a stacked cache, ragged base/pad and a
    row with base == 0 (attends its staging columns alone): plain == the XLA
    oracle to 1e-5 (same f32 math), == the Pallas kernel (interpret) to 2e-2
    (it rounds probabilities to bf16 before PV; the port keeps f32)."""
    x = _staged_inputs()
    base = np.asarray([0, 64, 200, 256], np.int32)
    pad = np.asarray([0, 3, 17, 0], np.int32)
    names = ("q", "all_k", "all_v", "k_scale", "v_scale", "stag_k", "stag_v", "stag_ks",
             "stag_vs")
    got = tattn.decode_attention_staged(*(_t(x[n]) for n in names), 1, step, _t(base), _t(pad))
    assert got.shape == x["q"].shape and torch.isfinite(got).all()
    jargs = [jnp.asarray(x[n]) for n in names]
    want = jattn.decode_attention_staged_xla(*jargs, 1, step, jnp.asarray(base), jnp.asarray(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kern = jattn.decode_attention_staged(*jargs, jnp.int32(1), jnp.int32(step), jnp.asarray(base),
                                         jnp.asarray(pad), interpret=True, row_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-2, atol=2e-2)


def test_reconcile_matches_pallas_kernel_exactly():
    """Segment reconcile in place: plain == the JAX reconcile (Pallas copy in
    interpret mode + one-hot scale fold) on all four buffers, array-equal;
    inactive rows untouched byte for byte."""
    x = _staged_inputs(seed=1, B=4, S=8)
    base = np.asarray([8, 0, 120, 248], np.int32)  # the last row ends at T
    active = np.asarray([True, False, True, True])
    bufs = [x[n].copy() for n in ("all_k", "all_v", "k_scale", "v_scale")]
    stag = [x[n] for n in ("stag_k", "stag_v", "stag_ks", "stag_vs")]
    got = tattn.reconcile_segment(*(_t(b) for b in bufs), *(_t(s) for s in stag), _t(base),
                                  _t(active))
    want = jattn.reconcile_segment(*(jnp.asarray(b) for b in bufs),
                                   *(jnp.asarray(s) for s in stag), jnp.asarray(base),
                                   jnp.asarray(active), interpret=True, row_block=4)
    for g, w, before in zip(got, want, bufs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[:, 1], before[:, 1])  # inactive row
    np.testing.assert_array_equal(got[0].numpy()[:, 2, 120:128], x["stag_k"][:, 2])


def test_scatter_prefill_matches_pallas_kernel_exactly():
    """Admission write in place, with a duplicated slot (group padding) and
    rows not named: plain == the JAX scatter_prefill (Pallas copy in
    interpret mode + one-hot scale projection), array-equal."""
    rng = np.random.default_rng(2)
    L, B, T, KD, G, Lp = 2, 6, 256, 32, 4, 64
    bufs = [rng.integers(-127, 128, (L, B, T, KD)).astype(np.int8) for _ in range(2)]
    bufs += [rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32) for _ in range(2)]
    new = [rng.integers(-127, 128, (L, G, Lp, KD)).astype(np.int8) for _ in range(2)]
    new += [rng.uniform(0.01, 0.1, (L, G, Lp)).astype(np.float32) for _ in range(2)]
    for a in new:
        a[:, 3] = a[:, 2]  # the duplicate carries the same row
    slots = np.asarray([4, 0, 2, 2], np.int32)
    primary = np.asarray([True, True, True, False])
    got = tattn.scatter_prefill(*(_t(b.copy()) for b in bufs), *(_t(a) for a in new),
                                _t(slots), _t(primary))
    want = jattn.scatter_prefill(*(jnp.asarray(b) for b in bufs), *(jnp.asarray(a) for a in new),
                                 jnp.asarray(slots), jnp.asarray(primary), interpret=True)
    for g, w, before in zip(got, want, bufs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for untouched in (1, 3, 5):
            np.testing.assert_array_equal(g.numpy()[:, untouched], before[:, untouched])
    np.testing.assert_array_equal(got[0].numpy()[:, 2, :Lp], new[0][:, 2])


# --- int4 modes ------------------------------------------------------------------


def _int4_cache(rng, L, B, T, KD):
    """Packed int4 values [L, B, T/2, KD] and deinterleaved scales [L, B, T]
    of unit-normal K/V rows, quantized by the JAX helpers."""
    q, sc = jbb.quantize_kv4(jnp.asarray(rng.standard_normal((L, B, T, KD)).astype(np.float32)))
    return np.array(jbb.pack4_pairs(q)), np.array(jbb.scales4_block(sc))


@pytest.mark.parametrize("lens_pad", [
    ([301, 512], [0, 3]),    # odd lens and an odd pad: half-byte masks at both ends
    ([77, 130], [77 - 1, 5]),  # a single live token at an odd slot
])
def test_decode_int4_matches_oracle_and_kernel(lens_pad):
    """int4 cache (nibble pairs + deinterleaved scales), layer 1 of a
    stacked cache: plain == the XLA oracle on the dequantized cache to 1e-5
    (same f32 math), == the Pallas int4 kernel (interpret) to 2e-2 (it
    rounds probabilities to bf16 before PV; the port keeps f32)."""
    B, K, G, T, D = 2, 2, 7, 512, 64
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kp, ks = _int4_cache(rng, 2, B, T, K * D)
    vp, vs = _int4_cache(rng, 2, B, T, K * D)
    lens, pad = np.asarray(lens_pad[0], np.int32), np.asarray(lens_pad[1], np.int32)
    got = tattn.decode_attention(_t(q), _t(kp), _t(vp), 1, _t(lens), _t(pad), _t(ks), _t(vs))
    assert tattn.is_int4(_t(kp), _t(ks))
    want = jattn.decode_attention_xla(jnp.asarray(q), jbb.dequant_kv4(kp[1], ks[1]),
                                      jbb.dequant_kv4(vp[1], vs[1]), jnp.asarray(lens),
                                      jnp.asarray(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kern = jattn.decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.int32(1), jnp.asarray(lens),
        jnp.asarray(pad), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_t=256,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-2, atol=2e-2)


def _staged4_inputs():
    """The inputs of tests/test_attention.py::test_staged_int4_matches_oracle."""
    rng = np.random.default_rng(0)
    L, B, Tb, K, G, D, S = 2, 4, 512, 2, 2, 16, 16
    KD, T = K * D, 2 * Tb
    return dict(
        q=rng.normal(size=(B, K, G, D)).astype(np.float32),
        all_k=rng.integers(-119, 120, (L, B, Tb, KD)).astype(np.int8),
        all_v=rng.integers(-119, 120, (L, B, Tb, KD)).astype(np.int8),
        k_scale=rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32),
        v_scale=rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32),
        stag_k=rng.integers(-7, 8, (L, B, S, KD)).astype(np.int8),
        stag_v=rng.integers(-7, 8, (L, B, S, KD)).astype(np.int8),
        stag_ks=rng.uniform(0.01, 0.1, (L, B, tattn.SEG_PAD)).astype(np.float32),
        stag_vs=rng.uniform(0.01, 0.1, (L, B, tattn.SEG_PAD)).astype(np.float32),
    )


@pytest.mark.parametrize("layer,step", [(0, 0), (1, 7), (1, 15)])
def test_staged_int4_matches_oracle_and_kernel(layer, step):
    """int4 staged decode (packed settled cache + unpacked int4 staging),
    ragged even bases and odd pads: plain == decode_attention_staged_xla to
    1e-5, == the Pallas kernel (interpret) within tests/test_attention.py's
    bound for it (atol 0.02, rtol 0.05: bf16 probabilities there)."""
    x = _staged4_inputs()
    base = np.asarray([16, 64, 272, 640], np.int32)
    pad = np.asarray([3, 0, 5, 1], np.int32)
    names = ("q", "all_k", "all_v", "k_scale", "v_scale", "stag_k", "stag_v", "stag_ks",
             "stag_vs")
    got = tattn.decode_attention_staged(*(_t(x[n]) for n in names), layer, step, _t(base),
                                        _t(pad))
    jargs = [jnp.asarray(x[n]) for n in names]
    want = jattn.decode_attention_staged_xla(*jargs, layer, step, jnp.asarray(base),
                                             jnp.asarray(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    kern = jattn.decode_attention_staged(*jargs, jnp.int32(layer), jnp.int32(step),
                                         jnp.asarray(base), jnp.asarray(pad), interpret=True,
                                         row_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=0.05, atol=0.02)


# settled ranges: a row with base == 0 (staging alone), a row shorter than one
# chunk, rows crossing several 64-token tiles; int4 with odd pads
_STAGED_SPLIT_ROWS = {
    "int8": ([0, 64, 200, 256], [0, 3, 17, 0]),
    "int4": ([0, 64, 272, 640], [0, 3, 5, 1]),
}


@functools.lru_cache(maxsize=None)
def _staged_split_case(mode, step):
    """Inputs (torch; layer 1 of the cache and of the staging dequantized to
    f32), the XLA oracle's and the Pallas kernel's (interpret) outputs."""
    x = _staged_inputs() if mode == "int8" else _staged4_inputs()
    base, pad = (np.asarray(a, np.int32) for a in _STAGED_SPLIT_ROWS[mode])
    names = ("q", "all_k", "all_v", "k_scale", "v_scale", "stag_k", "stag_v", "stag_ks",
             "stag_vs")
    jargs = [jnp.asarray(x[n]) for n in names]
    oracle = jattn.decode_attention_staged_xla(*jargs, 1, step, jnp.asarray(base),
                                               jnp.asarray(pad))
    kern = jattn.decode_attention_staged(*jargs, jnp.int32(1), jnp.int32(step),
                                         jnp.asarray(base), jnp.asarray(pad), interpret=True,
                                         row_block=4)
    t = {n: _t(x[n]) for n in names}
    S = t["stag_k"].shape[2]
    if mode == "int4":
        ck = tbb.dequant_kv4(t["all_k"][1], t["k_scale"][1])
        cv = tbb.dequant_kv4(t["all_v"][1], t["v_scale"][1])
    else:
        ck = t["all_k"][1].float() * t["k_scale"][1][..., None]
        cv = t["all_v"][1].float() * t["v_scale"][1][..., None]
    sk = t["stag_k"][1].float() * t["stag_ks"][1][:, :S, None]
    sv = t["stag_v"][1].float() * t["stag_vs"][1][:, :S, None]
    return (t["q"], ck, cv, sk, sv, base, pad, np.asarray(oracle),
            np.asarray(kern, np.float32))


@pytest.mark.parametrize("nsplit", [1, 2, 3, 4])
@pytest.mark.parametrize("last_step", [False, True])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_staged_split_k_matches_pallas_kernel(mode, last_step, nsplit):
    """The staged kernel's split-K algebra (csrc/staged_attention.cu), written
    out in torch: the settled chunks, one more partial over the staging
    columns [0, step], the index-order merge. Against the XLA oracle on the
    same dequantized inputs to 1e-5 (the same function, summed in another
    order), and against the Pallas staged kernel (interpret) by the rule of
    test_split_k_merge_matches_pallas_kernel: within 2e-2 of it (it rounds
    probabilities to bf16), or no farther from it than the oracle is. Step 0
    and S - 1; the base == 0 row attends its staging columns alone."""
    step = 15 if last_step else 0
    q, ck, cv, sk, sv, base, pad, oracle, kern = _staged_split_case(mode, step)
    got = _staged_split_decode(q, ck, cv, sk, sv, base, pad, step, nsplit,
                               int4=mode == "int4").numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    limit = np.maximum(2e-2 + 2e-2 * np.abs(kern), np.abs(oracle - kern) + 1e-5)
    gap = np.abs(got - kern)
    assert (gap <= limit).all(), float(gap.max())


def test_reconcile4_matches_pallas_kernel_exactly():
    """int4 segment reconcile in place: plain == the JAX reconcile_segment4
    (Pallas copy in interpret mode + one-hot deinterleaved scale fold) on
    all four buffers, array-equal; the inactive row untouched byte for
    byte; the packed bytes are the staged pairs; the last row ends at T."""
    rng = np.random.default_rng(6)
    L, B, Tb, KD, S = 2, 4, 128, 32, 16
    T = 2 * Tb
    bufs = [rng.integers(-119, 120, (L, B, Tb, KD)).astype(np.int8) for _ in range(2)]
    bufs += [rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32) for _ in range(2)]
    stag = [rng.integers(-7, 8, (L, B, S, KD)).astype(np.int8) for _ in range(2)]
    stag += [rng.uniform(0.01, 0.1, (L, B, tattn.SEG_PAD)).astype(np.float32) for _ in range(2)]
    base = np.asarray([16, 0, 112, T - S], np.int32)
    active = np.asarray([True, False, True, True])
    got = tattn.reconcile_segment4(*(_t(b.copy()) for b in bufs), *(_t(a) for a in stag),
                                   _t(base), _t(active))
    want = jattn.reconcile_segment4(*(jnp.asarray(b) for b in bufs),
                                    *(jnp.asarray(a) for a in stag), jnp.asarray(base),
                                    jnp.asarray(active), interpret=True, row_block=4)
    for g, w, before in zip(got, want, bufs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[:, 1], before[:, 1])  # inactive row
    np.testing.assert_array_equal(got[0].numpy()[:, 2, 56:64],
                                  np.asarray(jbb.pack4_pairs(jnp.asarray(stag[0][:, 2]))))
    np.testing.assert_array_equal(got[2].numpy()[:, 2, Tb + 56:Tb + 64], stag[2][:, 2, 1:S:2])


def test_reconcile4_needs_even_base_and_segment():
    rng = np.random.default_rng(7)
    bufs = [_t(rng.integers(-7, 8, (1, 2, 32, 16)).astype(np.int8)) for _ in range(2)]
    bufs += [_t(np.ones((1, 2, 64), np.float32)) for _ in range(2)]
    scales = [_t(np.ones((1, 2, tattn.SEG_PAD), np.float32)) for _ in range(2)]
    active = _t(np.asarray([True, False]))
    for S, base in ((16, [3, 0]), (15, [0, 0])):
        stag = [_t(np.zeros((1, 2, S, 16), np.int8)) for _ in range(2)]
        with pytest.raises(ValueError):
            tattn.reconcile_segment4(*bufs, *stag, *scales, _t(np.asarray(base, np.int32)),
                                     active)
    # an odd base in an inactive row is never read
    stag = [_t(np.zeros((1, 2, 16, 16), np.int8)) for _ in range(2)]
    tattn.reconcile_segment4(*bufs, *stag, *scales, _t(np.asarray([0, 3], np.int32)), active)


def test_scatter_prefill4_matches_pallas_kernel_exactly():
    """int4 admission write in place, with a duplicated slot and rows not
    named: plain == the JAX scatter_prefill4 (Pallas copy in interpret mode
    + one-hot deinterleaved scale projection), array-equal."""
    rng = np.random.default_rng(8)
    L, B, Tb, KD, G, Lp = 2, 6, 128, 32, 4, 64
    T = 2 * Tb
    bufs = [rng.integers(-119, 120, (L, B, Tb, KD)).astype(np.int8) for _ in range(2)]
    bufs += [rng.uniform(0.01, 0.1, (L, B, T)).astype(np.float32) for _ in range(2)]
    new = [rng.integers(-119, 120, (L, G, Lp // 2, KD)).astype(np.int8) for _ in range(2)]
    new += [rng.uniform(0.01, 0.1, (L, G, Lp)).astype(np.float32) for _ in range(2)]
    for a in new:
        a[:, 3] = a[:, 2]  # the duplicate carries the same row
    slots = np.asarray([4, 0, 2, 2], np.int32)
    primary = np.asarray([True, True, True, False])
    got = tattn.scatter_prefill4(*(_t(b.copy()) for b in bufs), *(_t(a) for a in new),
                                 _t(slots), _t(primary))
    want = jattn.scatter_prefill4(*(jnp.asarray(b) for b in bufs),
                                  *(jnp.asarray(a) for a in new), jnp.asarray(slots),
                                  jnp.asarray(primary), interpret=True)
    for g, w, before in zip(got, want, bufs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for untouched in (1, 3, 5):
            np.testing.assert_array_equal(g.numpy()[:, untouched], before[:, untouched])
    np.testing.assert_array_equal(got[2].numpy()[:, 2, Tb:Tb + Lp // 2], new[2][:, 2, 1::2])
    with pytest.raises(ValueError):  # an odd bucket cannot hold whole pairs
        tattn.scatter_prefill4(*(_t(b) for b in bufs), _t(new[0][:, :, :15]),
                               _t(new[1][:, :, :15]), _t(new[2][:, :, :31]),
                               _t(new[3][:, :, :31]), _t(slots), _t(primary))
