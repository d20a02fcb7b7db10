"""Each kernel function's and model's work at a small shape, against a
count by hand."""
import math

from port_bench import catalog

CFG = {"model": None, "batch_size": 2, "node_dim": 3, "time_feat_dim": 2, "num_heads": 1,
       "num_neighbors": 2, "num_layers": 2, "max_input_sequence_length": 4, "patch_size": 2,
       "channel_embedding_dim": 1}


def cell(model, phase):
    return {"cfg": {**CFG, "model": model}, "phase": phase}


def test_dygformer_kernel_functions():
    w = catalog.work()
    # M = 3B = 6 rows of Lp = 4 entries, patches of 2: 12 patch rows
    c = cell("DyGFormer", "train")
    # time channel: K = 2 x 2, products 2 x 12 x 4 x 1; bytes: dt 4*24, valid 24,
    # w and b 4*4, W 4*4, bias 4, out 4*12
    assert w["time_channel"].calls(c) == [(96, 96 + 24 + 16 + 16 + 4 + 48)]
    assert w["time_channel_bwd"].calls(c) == [(192, 96 + 24 + 4 * (4 + 4 + 12) + 4 * (4 + 1 + 4))]
    # co-occurrence: self over 6 rows, cross over 8, Lk = 4
    assert w["cooccurrence"].calls(c) == [(3 * 6 * 4 * 2.0, 4 * 3 * 6 * 4),
                                          (3 * 8 * 4 * 2.0, 4 * 3 * 8 * 4)]
    # patch projection: K = 2 x 3; x 6 x 4 x 3 floats, W 6, bias 1, out 12
    assert w["patch_projection"].calls(c) == [(2 * 12 * 6, 4 * (72 + 6 + 1 + 12))] * 2
    assert w["patch_projection_bwd"].calls(c) == [(2 * 12 * 7, 4 * (72 + 12 + 7))] * 2
    assert w["patch_projection_bwd"].calls(cell("DyGFormer", "eval")) == []
    assert w["time_channel_bwd"].calls(cell("DyGFormer", "eval")) == []
    assert w["gathered_attention"].calls(c) == []


def test_tgat_kernel_functions():
    w = catalog.work()
    c = cell("TGAT", "train")
    # Dkv = 3 + 3 + 2 = 8, Dq = 5, H = 1, K = 2; layer 1 at hops 0 and 1
    # (M = 6 and 12), layer 2 at hop 0 (M = 6)
    fwd = lambda m: 4 * m * 5 * 8 + 4 * m * 1 * 2 * 8 + 6 * m * 2
    small = lambda m: 4 * (2 * m * 5 + 2 * m * 2 + m * 2 + 2 * 8 * 5)
    assert w["gathered_attention"].calls(c) == [
        (fwd(m) + 2 * m * 2 * 2, small(m) + 4 * (m * 2 * 6 + 4)) for m in (6, 12)]
    assert w["temporal_attention"].calls(c) == [(fwd(6), small(6) + 4 * 6 * 2 * 8)]
    bwd = lambda m, cols, phi: (10 * m * 5 * 8 + 8 * m * 2 * 8 + 4 * m * 2 * cols + 12 * m * 2
                                + 7 * m * 2 * phi)
    small_b = lambda m: 4 * (3 * m * 5 + 2 * m * 2 + m * 2 + 4 * 8 * 5)
    assert w["gathered_attention_bwd"].calls(c) == [
        (bwd(m, 2, 2), small_b(m) + 4 * (m * 2 * 7 + 8)) for m in (6, 12)]
    assert w["temporal_attention_bwd"].calls(c) == [(bwd(6, 8, 0), small_b(6) + 8 * 6 * 2 * 8)]
    assert w["temporal_attention_bwd"].calls(cell("TGAT", "eval")) == []
    assert w["time_channel"].calls(c) == []


def test_model_flops():
    w = catalog.work()
    # TGAT: per call 2 linears of 5x5 (x2 flops x2), attention, merge 8->3, 3->3
    per = lambda m: 2 * m * 25 * 2 + (4 * m * 5 * 8 + 4 * m * 2 * 8) + (2 * m * 8 * 3 + 2 * m * 9)
    head = 2 * (2 * 2 * 6 * 3 + 2 * 2 * 3)
    fwd = per(6) + per(12) + per(6) + head
    assert w["step_TGAT"].flops(cell("TGAT", "eval")["cfg"], "eval") == fwd
    assert w["step_TGAT"].flops(cell("TGAT", "train")["cfg"], "train") == 3 * fwd
    # DyGFormer: 12 patch rows, 4 pairs of 2 sides, d = 4, T = 4 tokens a pair
    mm = lambda n, a, c: 2 * n * a * c
    fwd = (2 * mm(12, 6, 1) + mm(12, 4, 1) + mm(64, 1, 1) + mm(64, 1, 1) + mm(16, 2, 1)
           + 2 * (mm(16, 4, 12) + mm(16, 4, 4) + mm(16, 4, 4) + mm(16, 4, 4) + mm(16, 4, 16)
                  + mm(16, 16, 4))
           + mm(8, 4, 3) + mm(4, 6, 3) + mm(4, 3, 1))
    no_dx = 2 * mm(12, 6, 1) + mm(64, 1, 1)
    f = w["step_DyGFormer"].flops
    assert f(cell("DyGFormer", "eval")["cfg"], "eval") == fwd
    assert f(cell("DyGFormer", "train")["cfg"], "train") == 3 * fwd - no_dx
    assert math.isclose(f(cell("DyGFormer", "train")["cfg"], "train") / fwd, 3 - no_dx / fwd)
