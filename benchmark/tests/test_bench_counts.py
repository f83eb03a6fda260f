"""Operations and bytes against hand-worked shapes, and the roofline and
mfu shares they give."""

from __future__ import annotations

import pytest

from benchmark.harness import counts, manifest
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace, Spans

AIR = {"hidden_size": 896, "num_hidden_layers": 24, "num_attention_heads": 14,
       "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": 4864}


def test_dense_flops_per_token_air():
    # per layer: q 896x896, k and v 896x128 each, o 896x896, MLP 3 x 896x4864
    per_layer = 802_816 + 2 * 114_688 + 802_816 + 3 * 4_358_144
    assert counts.dense_flops_per_token(AIR, 0) == 2 * 24 * per_layer
    # the speech head adds 2 x 896 x 65,537 (EOS and the codes)
    assert counts.dense_flops_per_token(AIR, 65_537) - counts.dense_flops_per_token(AIR, 0) \
        == 2 * 896 * 65_537
    assert counts.dense_flops_per_token(AIR, 65_537) == pytest.approx(0.83e9, rel=0.01)


def test_attention_counts():
    assert counts.attention_flops(AIR, 1000) == 4 * 24 * 14 * 64 * 1000
    assert counts.prefill_attention_keys(4) == 10  # 1 + 2 + 3 + 4
    # staged: 1,000 attended tokens of int8 K and V (128 each) with two f32
    # scales, plus q and out of 3 rows in bf16 (14 x 64 each)
    assert counts.staged_attention_bytes(AIR, 1000, 3) == 1000 * 2 * (128 + 4) + 3 * 2 * 896 * 2
    assert counts.decode_attention_bytes(AIR, 1000, 1) == 1000 * 2 * 128 * 2 + 2 * 896 * 2


def test_fused_mlp_counts_and_bound():
    ops = counts.fused_mlp_ops(AIR, 32_768)  # one 64 x 512 admission group, one layer
    assert ops == 2 * 32_768 * 3 * 896 * 4864
    nbytes = counts.fused_mlp_bytes(AIR, 32_768)
    assert nbytes == 3 * 896 * 4864 + 4 * (2 * 4864 + 896) + 32_768 * 4 * 896
    # operations bound it: 856.8 GOP at 1,979 TOP/s is 0.433 ms
    assert counts.bound_s(ops, nbytes, counts.PEAK_INT8) == pytest.approx(ops / 1979e12)
    assert counts.bound_s(ops, nbytes, counts.PEAK_INT8) == pytest.approx(4.33e-4, rel=0.01)


def _traced(kernels, window_s, notes, weights="int8"):
    tr = DeviceTrace(Spans())
    tr.kernels = kernels
    tr.window_s = tr.unprofiled_s = window_s
    tr.busy_s = sum(e - s for _, s, e in kernels) / 1e9
    tr.notes = notes
    r = Run(cell="t", config={"weights": weights}, traffic={}, sizes=AIR)
    r.trace = tr
    return r


def test_roofline_mfu_and_idle_shares():
    # #2: 33.5 MB at 3.35 TB/s is 10 us; the kernels took 100 us: 10%
    k = [("void staged_attention_kernel<__nv_bfloat16>(...)", 0, 60_000),
         ("void staged_attention_kernel<__nv_bfloat16>(...)", 100_000, 140_000),
         ("void imma_gemm_kernel<128, 64, false, 3, EpiGateUpTC>(...)", 200_000, 700_000),
         ("void imma_gemm_kernel<64, 64, false, 3, EpiDownTC<__nv_bfloat16>>(...)",
          700_000, 900_000),
         ("void imma_gemm_kernel<64, 64, false, 3, EpiQKV<__nv_bfloat16>>(...)",
          900_000, 1_000_000)]
    ops = counts.fused_mlp_ops(AIR, 32_768)
    r = _traced(k, 0.01, {"staged_attention_bytes": 33.5e6, "fused_mlp_ops": ops,
                          "fused_mlp_bytes": 0.0, "model_flops": 989e12 * 0.01 * 0.002})
    rd = manifest.reader
    assert rd("kernel.staged_attention.roofline.backlog")(r) == pytest.approx(10.0)
    # #6: its gate/up and down kernels alone (700 us), not #7's QKV
    assert rd("kernel.fused_mlp.roofline.backlog")(r) == pytest.approx(
        100 * ops / 1979e12 / 700e-6)
    # busy 0.9 ms of a 10 ms sub-window
    assert rd("device.idle_share.backlog")(r) == pytest.approx(91.0)
    assert rd("model.mfu.backlog")(r) == pytest.approx(0.2 * 989 / 1979)
    r.config["weights"] = "bf16"  # a bf16 deployment is held to the bf16 peak
    assert rd("model.mfu.stream")(r) == pytest.approx(0.2)


def test_no_kernel_no_roofline():
    r = _traced([("void decode_attention_kernel<...>", 0, 10)], 1.0,
                {"staged_attention_bytes": 1e6})
    assert manifest.reader("kernel.staged_attention.roofline.backlog")(r) is None


def test_shares_are_of_the_sub_window_at_the_unprofiled_pace():
    sp = Spans()
    sp.seconds["engine.step_dispatch"] = [1.0, 2.0, 1.5]  # median 1.5 s
    sp.seconds["engine.submit"] = [0.001]
    ms = 1_000_000
    # two profiled dispatches of 2.0 s and 2.5 s; a submit inside the second
    sp.marks = [("engine.step_dispatch", 0, 2000 * ms),
                ("engine.step_dispatch", 2100 * ms, 4600 * ms),
                ("engine.submit", 2200 * ms, 2300 * ms)]
    tr = DeviceTrace(sp)
    assert tr.profiler_delay_s() == pytest.approx(0.5 + 1.0)  # the submit is inside
    tr.window_s = 4.7
    tr.unprofiled_s = tr.window_s - tr.profiler_delay_s()
    tr.busy_s = 0.8
    tr.notes = {"model_flops": 989e12 * 3.2 * 0.001}
    r = Run(cell="t", config={"weights": "bf16"}, traffic={}, sizes=AIR)
    r.trace = tr
    assert manifest.reader("device.idle_share.stream")(r) == pytest.approx(75.0)
    assert manifest.reader("model.mfu.stream")(r) == pytest.approx(0.1)
