"""The benchmark's spans around the engine's calls record the work each
decode block and prefill wave was asked for, from host state alone."""
import torch

from bench.serve import Spans
from bench.tests.bench_small import small_cell
from bench.weights import make_params


def test_spans_record_blocks_and_waves():
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.request import Request, SamplingParams
    cell, pc = small_cell("codeqwen1.5-7b.repo-context")
    cfg = cell["config"]
    params = make_params(cfg, 5, torch.device("cpu"))
    eng = InferenceEngine(pc, params, device="cpu", **cfg["serve"])
    spans = Spans(eng, lambda i: (i % 2, 8))
    spans.on = True
    reqs = [Request(prompt_tokens=list(range(1, 20 + i)),
                    sampling=SamplingParams(max_tokens=5), tenant=f"bench-{i}")
            for i in range(3)]
    eng.generate(reqs)
    assert all(len(r.output_tokens) == 5 for r in reqs)
    waves = [row for _, _, rows in spans.waves for row in rows]
    assert sorted((ctx, start, take, last) for ctx, _, start, take, last
                  in waves) == [(0, 0, 19, True), (0, 0, 21, True),
                                (1, 0, 20, True)]
    steps = sum(k for _, _, k, _ in spans.blocks)
    assert steps >= 4
    first = spans.blocks[0][3]
    assert {(c, n, left) for c, _, n, left in first} <= {
        (0, 20, 4), (1, 21, 4), (0, 22, 4)}
    labels = {label for label, _, _ in spans.calls}
    assert {"decode block dispatch", "prefill wave",
            "admission planning"} <= labels
