"""The traffic generator: the same seed gives the same requests and rows,
sizes stay in their ranges, and every stratum sends each quantile once."""
import numpy as np
import pytest

from bench import traffic as gen
from bench.common import load_json, BENCH

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


def mix(name):
    return load_json(BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["repo-context", "unique-context"])
@pytest.mark.parametrize("seed", SEEDS)
def test_requests_deterministic_and_in_range(name, seed):
    m = mix(name)
    a = [gen.request(m, seed, i, 92416) for i in range(0, 200, 7)]
    b = [gen.request(m, seed, i, 92416) for i in range(0, 200, 7)]
    assert a == b
    for r in a:
        assert m["suffix"]["min"] <= r["suffix"] <= m["suffix"]["max"]
        assert (m["max_tokens"]["min"] <= r["max_tokens"]
                <= m["max_tokens"]["max"])
        assert len(r["prompt"]) == m["context"]["tokens"] + r["suffix"]
        assert 0 <= min(r["prompt"]) and max(r["prompt"]) < 92416
        assert (r["context"] >= 0) == m["context"]["shared"]


def test_seeds_change_the_order_not_the_sizes():
    m = mix("repo-context")
    n = m["stratum"]
    sizes = []
    for seed in (3, 4):
        plans = [gen.request_plan(m, seed, i) for i in range(n)]
        sizes.append((sorted(p["suffix"] for p in plans),
                      sorted(p["max_tokens"] for p in plans),
                      sorted(p["context"] for p in plans)))
        assert [p["suffix"] for p in plans] != sorted(p["suffix"]
                                                      for p in plans)
    assert sizes[0] == sizes[1]


def test_shared_contexts_follow_zipf_and_repeat():
    m = mix("repo-context")
    n = m["stratum"]
    picks = [gen.request_plan(m, 11, i)["context"] for i in range(n)]
    counts = np.bincount(picks, minlength=m["context"]["count"])
    w = 1.0 / np.arange(1, m["context"]["count"] + 1)
    assert np.abs(counts - n * w / w.sum()).max() <= 1
    a = gen.request(m, 11, 0, 1000)
    b = next(gen.request(m, 11, i, 1000) for i in range(1, n)
             if gen.request_plan(m, 11, i)["context"] == a["context"])
    t = m["context"]["tokens"]
    assert a["prompt"][:t] == b["prompt"][:t]
    assert a["prompt"][t:] != b["prompt"][t:]


def test_unique_contexts_differ():
    m = mix("unique-context")
    t = m["context"]["tokens"]
    heads = {tuple(gen.request(m, 5, i, 92416)["prompt"][:t])
             for i in range(20)}
    assert len(heads) == 20


@pytest.mark.parametrize("seed", SEEDS)
def test_train_rows(seed):
    m = dict(mix("train-packed-1k"), batch=2, seq=64)
    m["doc_len"] = dict(m["doc_len"], median=16, min=2)
    a = gen.train_rows(m, seed, 3, 151936, 151643)
    assert a.shape == (3, 2, 65) and a.dtype == np.int64
    assert np.array_equal(a, gen.train_rows(m, seed, 3, 151936, 151643))
    assert 0 <= a.min() and a.max() < 151936
    assert (a == 151643).any()
    rows = a.reshape(6, 65)
    assert len({r.tobytes() for r in rows}) == 6


def test_train_rows_doc_lengths_in_range():
    m = dict(mix("train-packed-1k"), batch=8, seq=1024)
    stream = gen.train_rows(m, 9, 4, 100, 100).reshape(-1)
    ends = np.flatnonzero(stream == 100)
    lens = np.diff(ends) - 1
    d = m["doc_len"]
    assert lens.min() >= d["min"] and lens.max() <= d["max"]
    assert d["median"] / 2 < np.median(lens) < d["median"] * 2
