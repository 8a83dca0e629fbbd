"""Every per-layer reader on a recorded fake run, against hand arithmetic;
and a reader that finds nothing to read returns nothing."""
import json

import pytest

from bench.common import BENCH, ROOT, load_reader
from bench.roofline import counts
from bench.roofline.peaks import bound_s, peaks_of
from bench.trace import breakdown, busy_s, kernels_launched_in

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10}
PEAKS = peaks_of("NVIDIA H100 80GB HBM3")
S = 1_000_000_000           # ns


def serve_rec():
    kernels = [("void paged_attention_mma_kernel<bf16>(Args, float)",
                S + 10, 1000, 1),
               ("combine_splits_kernel", S + 2000, 500, 2),
               ("flash_attention_tc_kernel", S + 5000, 4000, 3),
               ("ampere_bf16_gemm", S + 9000, 1000, 4)]
    return {"kind": "serve", "cfg": CFG, "peaks": PEAKS, "window_s": 1.0,
            "t0_ns": S, "t1_ns": 2 * S,
            "counters": ({"steps": 10, "device_steps": 40,
                          "tokens_generated": 300},
                         {"steps": 14, "device_steps": 72,
                          "tokens_generated": 540}),
            "e2e": {"ttft_p95_ms": 812.5, "tpot_p95_ms": 61.25},
            # a block of 2 steps: slot 2 has one token left
            "blocks": [(S + 1, S + 2, 2, [(0, 10, 12, 5), (-1, 0, 7, 1)]),
                       (S - 5, S - 1, 8, [(0, 10, 12, 5)])],
            "waves": [(S + 3, S + 4, [(0, 10, 10, 4, True)])],
            "kernels": kernels, "launches": [], "busy_s": busy_s(kernels),
            "polls": [{"total": 100, "free": 40}, {"total": 100, "free": 25}],
            "cached": [2048, 0, 2048, 1024]}


def test_counter_readers():
    rec = serve_rec()
    assert load_reader("engine.decode_batch_mean")(rec) == 240 / 32
    assert load_reader("engine.host_syncs_per_token")(rec) == 4 / 240
    assert load_reader("prefix_cache.hit_share")(rec) == 75.0
    assert load_reader("ttft_p95_ms.host")(rec) == 812.5
    assert load_reader("tpot_p95_ms.host")(rec) == 61.25
    assert load_reader("kv_pages.used_share_max")(rec) == 75.0
    assert load_reader("device_idle_share.serve")(rec) == pytest.approx(
        100 * (1 - 6500e-9))


def test_roofline_and_mfu_readers():
    rec = serve_rec()
    s0 = counts.decode_step(CFG, [(0, 10, 12), (-1, 0, 7)])
    s1 = counts.decode_step(CFG, [(0, 10, 13)])
    bound = (bound_s(s0["attn_flops"], s0["attn_bytes"], PEAKS)
             + bound_s(s1["attn_flops"], s1["attn_bytes"], PEAKS))
    assert load_reader("paged_attention_roofline")(rec) == pytest.approx(
        100 * bound / 1500e-9)
    w = counts.prefill_wave(CFG, [(0, 10, 10, 4, True)])
    assert load_reader("flash_attention_roofline")(rec) == pytest.approx(
        100 * bound_s(w["attn_flops"], w["attn_bytes"], PEAKS) / 4000e-9)
    dec = s0["flops"] + s1["flops"]
    assert load_reader("mfu.serve")(rec) == pytest.approx(
        100 * (dec + w["flops"]) / 989e12)


def test_readers_find_nothing():
    rec = serve_rec()
    rec.update(blocks=[], waves=[], kernels=[], polls=[], busy_s=0.0,
               counters=({"steps": 0, "device_steps": 0,
                          "tokens_generated": 0},) * 2,
               cached=[], e2e={})
    for m in ("engine.decode_batch_mean", "engine.host_syncs_per_token",
              "prefix_cache.hit_share", "kv_pages.used_share_max",
              "paged_attention_roofline", "flash_attention_roofline",
              "mfu.serve", "device_idle_share.serve", "ttft_p95_ms.host",
              "tpot_p95_ms.host"):
        assert load_reader(m)(rec) is None, m


def train_rec():
    kernels = [("void dkdv_kernel<128>(CUtensorMap)", S + 100, 3000, 1),
               ("dq_kernel", S + 4000, 2000, 2),
               ("bwd_delta_kernel", S + 7000, 500, 3),
               ("elementwise_kernel", S + 9000, 700, 4),
               ("elementwise_kernel", S + 9800, 300, 5)]
    return {"kind": "train", "cfg": CFG, "traffic": {"batch": 2, "seq": 3},
            "peaks": PEAKS, "steps": 2, "window_s": 0.5, "t0_ns": S,
            "t1_ns": S + S // 2, "kernels": kernels,
            "launches": [(S + 8000, 4), (S + 8500, 5), (S + 50, 1)],
            "busy_s": busy_s(kernels), "adamw_spans": [(S + 7400, S + 8600)]}


def test_train_readers():
    rec = train_rec()
    w = counts.train_step(CFG, 2, 3)
    assert load_reader("flash_attention_bwd_roofline")(rec) == \
        pytest.approx(100 * 2 * bound_s(w["bwd_flops"], w["bwd_bytes"],
                                        PEAKS) / 5500e-9)
    assert load_reader("train.adamw_device_ms_per_step")(rec) == \
        pytest.approx(1000e-9 * 1e3)
    assert load_reader("mfu.train")(rec) == pytest.approx(
        100 * 2 * w["flops"] / (0.5 * 989e12))
    assert load_reader("device_idle_share.train")(rec) == pytest.approx(
        100 * (1 - 6500e-9 / 0.5))
    rec.update(launches=[], steps=0)
    for m in ("flash_attention_bwd_roofline",
              "train.adamw_device_ms_per_step", "mfu.train"):
        assert load_reader(m)(rec) is None, m


def test_breakdown_and_launch_matching():
    rec = train_rec()
    out = breakdown(rec["kernels"], [("optimizer update", S + 7400,
                                      S + 8600)], rec["t0_ns"], rec["t1_ns"])
    assert out["device_ops"][0] == ["dkdv_kernel<128>(CUtensorMap)", 3e-6]
    assert len(out["device_ops"]) == 4
    gaps = dict((round(d * 1e9), n) for n, d in out["idle_gaps"])
    assert gaps[1500] == "idle in optimizer update"      # 7500 .. 9000
    assert gaps[900] == "idle in host outside the benchmark's spans"
    assert kernels_launched_in(rec["kernels"], rec["launches"],
                               rec["adamw_spans"]) == pytest.approx(1e-6)


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(load_reader(m["name"]))
