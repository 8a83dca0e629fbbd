"""``tools/host_trace.py``'s readers of the program's spans and counters, on a
fake traced record against hand arithmetic; each returns nothing without
the record's ``program`` section.  The idle-gap labels come from the
launching thread's innermost span, never from an HTTP handler's or a
request's span over the same instant."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.tracing import Record

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "host_trace", ROOT / "tools" / "host_trace.py")
ht = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ht)

S = 1_000_000_000           # ns
LOOP, HANDLER = 11, 22


def _r(name, start, end, id, parent=-1, cpu=0, thread=LOOP, rid=-1, n=0):
    return Record(name, S + start, S + end, cpu, id, parent, thread, rid, n)


def serve_rec():
    records = [
        _r("engine.decode_dispatch", -100, -50, 90, n=8),   # before
        _r("engine.decode_dispatch", 1500, S + 10, 91, n=2),  # straddles
        _r("engine.decode_dispatch", 20, 220, 2, parent=1, cpu=50, n=4),
        _r("engine.decode_dispatch", 300, 400, 3, parent=1, cpu=100, n=1),
        _r("engine.block_sync", 500, 530, 4, parent=1),
        _r("engine.block_sync", 600, 610, 5, parent=1),
        _r("engine.emit", 700, 760, 6, parent=1, n=6),
        _r("engine.step", 10, 1900, 1, parent=0),
        _r("client.loop", 0, 2000, 0),
        _r("api.encode", 190, 260, 7, thread=HANDLER, n=3),
        _r("http.write", 800, 830, 8, thread=HANDLER, n=100),
        _r("request.prefill", 150, 250, 9, rid=8),
        _r("request.queue", -5000, 50, 10, rid=7),
        _r("request.queue", 10, 90, 12, rid=8),
        _r("request.queue", 10, S + 5, 13, rid=9),            # ends after
    ]
    return {"t0_ns": S, "t1_ns": 2 * S,
            "counters": ({"steps": 10, "blocks_collapsed": 4,
                          "prompt_tokens": 1000, "hit_tokens": 600,
                          "device_steps": 30, "decode_graph_steps": 28},
                         {"steps": 14, "blocks_collapsed": 7,
                          "prompt_tokens": 3000, "hit_tokens": 2200,
                          "device_steps": 70, "decode_graph_steps": 66}),
            "kernels": [("k", S + 100, 100, 0), ("k", S + 1000, 100, 1)],
            "program": {"records": records, "thread": LOOP}}


def train_rec():
    records = []
    for i, t in enumerate((0, 1000)):
        base = 10 * i
        records += [_r("train.forward", t + 10, t + 110, base + 1, base),
                    _r("train.backward", t + 110, t + 310, base + 2, base),
                    _r("train.optimizer", t + 310, t + 360, base + 3, base),
                    _r("train.metrics_sync", t + 360, t + 365, base + 4,
                       base),
                    _r("train.step", t, t + 400, base)]
    return {"t0_ns": S, "t1_ns": 2 * S, "kernels": [],
            "program": {"records": records, "thread": LOOP}}


@pytest.mark.parametrize("name,rec,want", [
    ("engine.dispatch_ms_per_step", serve_rec, 300e-6 / 5),
    ("engine.dispatch_offcpu_share", serve_rec, 50.0),
    ("engine.sync_wait_ms_per_block", serve_rec, 20e-6),
    ("engine.emit_ms_per_token", serve_rec, 60e-6 / 6),
    ("engine.blocks_collapsed_share", serve_rec, 75.0),
    ("engine.decode_graph_share", serve_rec, 95.0),
    ("engine.queue_wait_p95_ms", serve_rec, 5050e-6),
    ("serving.codec_ms_per_token", serve_rec, 100e-6 / 3),
    ("prefix_cache.hit_token_share", serve_rec, 80.0),
    ("train.dispatch_ms_per_step", train_rec, 350e-6),
    ("train.sync_wait_ms_per_step", train_rec, 5e-6),
])
def test_reader_against_hand_arithmetic(name, rec, want):
    assert ht.READERS[name](rec()) == pytest.approx(want)
    bare = rec()
    del bare["program"]
    bare["counters"] = ({}, {})
    assert ht.READERS[name](bare) is None


def test_untraced_readers_over_the_last_seconds():
    """``--always``: the span readers over the stretch ending where the last
    step ends; the counter readers give nothing."""
    rec = serve_rec()
    records = rec["program"]["records"]
    got = ht.untraced_readers(records, (1900 - 10) / 1e9)
    assert got["engine.dispatch_ms_per_step"] == pytest.approx(300e-6 / 5)
    assert got["engine.sync_wait_ms_per_block"] == pytest.approx(20e-6)
    assert "engine.decode_graph_share" not in got
    assert ht.untraced_readers([], 51.0) == {}


def test_gaps_named_by_the_launching_threads_innermost_span():
    """The gap at S+200 begins inside the handler's ``api.encode`` and a
    ``request.prefill`` too, both shorter than the loop thread's dispatch
    span: the dispatch names it."""
    assert ht.idle_gaps(serve_rec()) == [
        ["idle in engine.step", (S - 1100) / 1e9],
        ["idle in engine.decode_dispatch", 800 / 1e9],
        ["idle in client.loop", 100 / 1e9]]
    rec = serve_rec()
    del rec["program"]
    assert ht.idle_gaps(rec) is None


def test_span_table_self_time():
    table = ht.span_table(serve_rec())
    assert table["engine.step"] == pytest.approx(
        [1, 1890e-6, 0.0, (1890 - 200 - 100 - 30 - 10 - 60) * 1e-6])
    assert table["client.loop"][3] == pytest.approx((2000 - 1890) * 1e-6)
    assert table["engine.decode_dispatch"][0] == 2
