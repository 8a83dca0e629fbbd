"""A training cell: the port's ``training/train_step.py make_train_step`` with
the configuration's AdamW, remat off (the launcher's default), called step
after step on packed batches from the benchmark's generator.

Set-up builds the one training state (weights from the seed, zero float32
moments), keeps a copy of the starting weights, and drives the step through
its first ``warm_steps`` steps with the window's own call and feed; those
steps are the ones the reference follows.  The same state then runs the
window: steps back to back for ``seconds``; ``train_tokens_per_s`` counts
the tokens of the steps finished inside it.  After the window the state is
freed and the reference runs the first steps again from the copy.

With ``--trace 1`` the profiler records ``trace_steps`` whole steps from
the second step of the window, and a span of the benchmark's own wraps
each call of the optimizer's update (``train_step.adamw_update``), so that
the device time of the kernels launched inside it can be read."""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from bench import correct, traffic as gen
from bench.roofline.peaks import peaks_of
from bench.trace import Profile, breakdown, busy_s
from bench.weights import leaves, make_params, program_config


def _norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(t.double().norm()) * scale for k, t in leaves(tree)}


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, port_cfg=None,
        keep: Optional[Dict[str, Any]] = None
        ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """One run; ``keep``, where given, receives the starting weights, the
    compared steps' batches, and the program's and the reference's
    readings (for the control's)."""
    from repro_torch.training import train_step as ts_mod
    from repro_torch.training.optimizer import AdamWConfig
    cfg, mix = cell["config"], cell["traffic"]
    if port_cfg is None:
        port_cfg = program_config(cfg)
    opt = cfg["train"]["adamw"]
    params = make_params(cfg, seed, device)
    start = {k: t.clone() for k, t in leaves(params)}
    state = ts_mod.init_train_state(port_cfg, params=params)
    step_fn = ts_mod.make_train_step(port_cfg, AdamWConfig(**opt),
                                     remat=False)
    b, s = mix["batch"], mix["seq"]
    n_rows = mix["max_steps"]
    rows = torch.from_numpy(gen.train_rows(
        mix, seed, n_rows, cfg["vocab_size"], cfg["eos_token_id"])).to(device)
    ones = torch.ones((b, s), dtype=torch.float32, device=device)

    def batch(i):
        r = rows[i % n_rows]
        return {"tokens": r[:, :-1], "labels": r[:, 1:], "mask": ones}

    prog: Dict[str, Any] = {"losses": []}
    warm = mix["warm_steps"]
    for i in range(warm):
        state, m = step_fn(state, batch(i))
        prog["losses"].append(m["loss"])
        if i == 0:
            prog["first_grad"] = _norms(state["opt"]["m"],
                                        1.0 / (1.0 - opt["beta1"]))
    prog["change"] = {k: float((t.float() - start[k].float()).double()
                               .norm()) for k, t in leaves(state["params"])}

    spans: List[Tuple[int, int]] = []
    if trace:
        inner = ts_mod.adamw_update

        def adamw_update(*a, **kw):
            t0 = time.time_ns()
            out = inner(*a, **kw)
            spans.append((t0, time.time_ns()))
            return out

        ts_mod.adamw_update = adamw_update
    t0 = time.monotonic()
    setup_s = t0 - t_start
    t1 = t0 + seconds
    done, i, prof, traced = 0, warm, None, 0
    try:
        while True:
            if trace and i == warm + 1:
                prof = Profile()
                prof.start()
            state, _ = step_fn(state, batch(i))
            i += 1
            now = time.monotonic()
            if prof is not None and prof.t1_ns == 0:
                traced += 1
                if traced == mix["trace_steps"]:
                    prof.stop()
            if now > t1:
                break
            done += 1
    finally:
        if trace:
            ts_mod.adamw_update = inner
    if prof is not None and prof.t1_ns == 0:
        prof.stop()
    if prof is not None:
        prof.collect()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"train: {done} steps in the window, {i - warm} run, losses "
          f"{prog['losses']}, peak {peak / 2**30:.2f} GiB, set-up "
          f"{setup_s:.2f} s", file=sys.stderr, flush=True)
    batches = [batch(j) for j in range(warm)]
    del state, step_fn, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = correct.reference_train(_unflatten(start), cfg, batches)
    checks = correct.check_train(prog, ref, cfg)
    if keep is not None:
        keep.update(start=_unflatten(start), batches=batches, prog=prog,
                    ref=ref)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": i - warm, "failed": 0, "peak": peak,
              "setup_s": setup_s}
    if not trace:
        result["metrics"] = {"train_tokens_per_s": done * b * s / seconds}
        return result, checks
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    rec = {"kind": "train", "cfg": cfg, "traffic": mix,
           "peaks": peaks_of(kind), "steps": traced,
           "window_s": prof.window_s, "t0_ns": prof.t0_ns,
           "t1_ns": prof.t1_ns, "kernels": prof.kernels,
           "launches": prof.launches, "busy_s": busy_s(prof.kernels),
           "adamw_spans": [sp for sp in spans
                           if prof.t0_ns <= sp[0] < prof.t1_ns]}
    result["per_layer_rec"] = rec
    result["busy_s"] = rec["busy_s"]
    result["window_s"] = rec["window_s"]
    result["breakdown"] = breakdown(
        prof.kernels, [("optimizer update", s0, s1)
                       for s0, s1 in rec["adamw_spans"]],
        prof.t0_ns, prof.t1_ns)
    return result, checks


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Paths back into a tree (the weights' layout)."""
    tree: Dict[str, Any] = {"prefix_layers": []}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
