"""The plain reference of a dense decoder of the Qwen family (RMSNorm, RoPE,
grouped-query attention with QKV bias, SwiGLU MLP, untied or tied head):
plain PyTorch in float32 with TF32 off.  It imports nothing of the program
and takes nothing it made, only the weights the benchmark drew and the
token ids it sent, in the port's parameter layout (``bench.weights``).

``quant="fp8"`` makes it the control: every matrix product of a linear
layer and of the head takes its operands rounded to float8 e4m3 (the input
per row, the weight per output column, each scaled to e4m3's largest
finite value), computed in float32; the backward sees the rounded
operands (a straight-through rounding).

Serving: :func:`served_logits` runs whole sequences layer by layer, each
layer's weights widened to float32 once, attention one sequence and a few
heads at a time, and keeps the head's logits of the rows asked for.
Training: :func:`train_steps` runs the configuration's AdamW from the same
weights on the same batches, each layer and each block of the loss under
checkpointing so that it fits beside the weights; the parameters are
stored in the configuration's dtype after each update, as the program
stores them."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from bench.weights import layer, leaves

E4M3_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = scale / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    if quant is None:
        return x @ w
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return _round_fp8(x, -1) @ _round_fp8(w, 0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [..., S, H, D]``, ``pos [S]``: rotate-half RoPE with frequencies
    ``theta ** (-2i / D)``."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv[None]).float()        # [S, half]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads_per_block: int = 0) -> torch.Tensor:
    """Causal softmax attention of one sequence: ``q [S, H, D]``, ``k``,
    ``v [S, Hkv, D]``; query head ``h`` reads kv head ``h // (H / Hkv)``."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    step = heads_per_block or h
    outs = []
    for h0 in range(0, h, step):
        qh, kh, vh = (t[:, h0:h0 + step].transpose(0, 1) for t in (q, k, v))
        sc = (qh @ kh.transpose(1, 2)) / math.sqrt(d)
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append((torch.softmax(sc, dim=-1) @ vh).transpose(0, 1))
    return torch.cat(outs, dim=1)


def block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: Dict[str, Any],
          pos: torch.Tensor, quant: Optional[str],
          heads_per_block: int = 0) -> torch.Tensor:
    """One layer over ``x [B, S, D]`` (rows attend within themselves)."""
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    b, s, _ = x.shape
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    hn = rmsnorm(x, p["ln"], eps)
    q, k, v = (matmul(hn, p[w], quant) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, h, hd), pos, theta)
    k = rope(k.reshape(b, s, hkv, hd), pos, theta)
    v = v.reshape(b, s, hkv, hd)
    att = torch.stack([attention(q[i], k[i], v[i], heads_per_block)
                       for i in range(b)])
    x = x + matmul(att.reshape(b, s, h * hd), p["wo"], quant)
    hn = rmsnorm(x, p["ffn_ln"], eps)
    gate = torch.nn.functional.silu(matmul(hn, p["w_gate"], quant))
    return x + matmul(gate * matmul(hn, p["w_up"], quant), p["w_down"],
                      quant)


def _head(params: Dict[str, Any], cfg: Dict[str, Any]) -> torch.Tensor:
    return (params["embed"].T if cfg["tie_word_embeddings"]
            else params["lm_head"])


@torch.no_grad()
def served_logits(params: Dict[str, Any], cfg: Dict[str, Any],
                  seqs: Sequence[Sequence[int]],
                  rows: Sequence[Sequence[int]],
                  quant: Optional[str] = None) -> List[torch.Tensor]:
    """Float32 logits ``[len(rows[i]), V]`` at the positions ``rows[i]`` of
    each whole sequence ``seqs[i]`` (prompt and served tokens)."""
    strict_float32()
    dev = params["embed"].device
    xs = [params["embed"][torch.as_tensor(list(t), device=dev)].float()[None]
          for t in seqs]
    for i in range(cfg["num_hidden_layers"]):
        p = {k: t.float() for k, t in layer(params, i).items()}
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[1], device=dev)
            xs[j] = block(x, p, cfg, pos, quant, heads_per_block=8)
        del p
    head = _head(params, cfg).float()
    fln = params["final_ln"].float()
    out = []
    for x, r in zip(xs, rows):
        hrow = rmsnorm(x[0, torch.as_tensor(list(r), device=dev)], fln,
                       cfg["rms_norm_eps"])
        out.append(matmul(hrow, head, quant))
    return out


def _loss(p: Dict[str, torch.Tensor], cfg: Dict[str, Any],
          tokens: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
          quant: Optional[str], rows_per_block: int = 1024) -> torch.Tensor:
    """Mean next-token NLL over ``mask`` of the model ``p`` (flat paths)."""
    b, s = tokens.shape
    n = cfg["num_hidden_layers"]
    x = p["embed"][tokens]
    pos = torch.arange(s, device=tokens.device)
    names = {k.split("/")[-1]: k for k in p if k.startswith("block/")}

    def run_layer(x, i):
        lp = {short: p[path][i] for short, path in names.items()}
        return block(x, lp, cfg, pos, quant)

    for i in range(n):
        x = torch.utils.checkpoint.checkpoint(run_layer, x, i,
                                              use_reentrant=False)
    head = p["embed"].T if cfg["tie_word_embeddings"] else p["lm_head"]
    xf = x.reshape(b * s, -1)
    lab, msk = labels.reshape(-1), mask.reshape(-1).float()

    def nll_sum(xb, lb, mb):
        h = rmsnorm(xb, p["final_ln"], cfg["rms_norm_eps"])
        logp = torch.log_softmax(matmul(h, head, quant), dim=-1)
        return -(logp.gather(-1, lb[:, None])[:, 0] * mb).sum()

    total = 0.0
    for r0 in range(0, b * s, rows_per_block):
        sl = slice(r0, r0 + rows_per_block)
        total = total + torch.utils.checkpoint.checkpoint(
            nll_sum, xf[sl], lab[sl], msk[sl], use_reentrant=False)
    return total / msk.sum().clamp(min=1.0)


def lr_at(opt: Dict[str, Any], step: int) -> float:
    """Linear warm-up to ``lr``, then cosine decay to ``lr * min_lr_ratio``
    at ``total_steps``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(1.0, max(0.0, (step - warm) / max(opt["total_steps"] - warm,
                                                 1)))
    return lr * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5
                 * (1 + math.cos(math.pi * prog)))


def train_steps(params: Dict[str, Any], cfg: Dict[str, Any],
                batches: Sequence[Dict[str, torch.Tensor]],
                opt: Dict[str, Any], quant: Optional[str] = None
                ) -> Dict[str, Any]:
    """The configuration's training steps from ``params`` over ``batches``:
    per step the loss; per leaf (by path) the norm of the first step's
    clipped gradient, and the norm of the change of the stored weights
    after the last step."""
    strict_float32()
    stored = {k: t.detach().clone() for k, t in leaves(params)}
    start = {k: t.to(torch.float32, copy=True) for k, t in stored.items()}
    m = {k: torch.zeros_like(t) for k, t in start.items()}
    v = {k: torch.zeros_like(t) for k, t in start.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    losses, first_grad = [], {}
    for t, batch in enumerate(batches, start=1):
        p = {k: s.to(torch.float32, copy=True).requires_grad_(True)
             for k, s in stored.items()}
        loss = _loss(p, cfg, batch["tokens"], batch["labels"],
                     batch["mask"], quant)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(p, grads))
            gnorm = torch.sqrt(sum(x.double().pow(2).sum()
                                   for x in g.values()))
            scale = min(1.0, opt["clip_norm"] / max(float(gnorm), 1e-9))
            lr = lr_at(opt, t)
            for k in p:
                gk = g[k] * scale
                if t == 1:
                    first_grad[k] = float(gk.double().norm())
                m[k].mul_(b1).add_((1 - b1) * gk)
                v[k].mul_(b2).add_((1 - b2) * gk * gk)
                delta = (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
                if p[k].dim() >= 2:
                    delta = delta + opt["weight_decay"] * p[k].detach()
                stored[k] = (p[k].detach() - lr * delta).to(stored[k].dtype)
        del p, grads, g
    change = {k: float((stored[k].float() - start[k]).double().norm())
              for k in stored}
    return {"losses": losses, "first_grad": first_grad, "change": change}
