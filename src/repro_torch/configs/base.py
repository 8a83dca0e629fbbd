"""Model configuration system.

Every assigned architecture gets one ``<id>.py`` module in this package that
builds a :class:`ModelConfig` with the exact published numbers (source cited in
the module docstring).  ``registry()`` collects them; ``get_config(name)`` is
the public lookup used by the launcher (``--arch <id>``).

Configs are *pure data* — no torch import — so the launcher can enumerate
them before any device is touched.  This package keeps its own copy of the
reference package's configs (same names, same numbers), so the port never
imports the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard-style capacity routing)."""

    num_experts: int
    experts_per_token: int
    num_shared_experts: int = 0
    expert_d_ff: int = 0            # per-expert hidden width (fine-grained MoE)
    capacity_factor: float = 1.25
    # layers that use a plain dense FFN instead of MoE (e.g. deepseek layer 0,
    # jamba every-other-layer).  ``moe_every``: MoE on layers where
    # ``layer_idx % moe_every == moe_offset``.
    first_k_dense: int = 0
    dense_d_ff: int = 0             # width of those dense layers
    moe_every: int = 1
    moe_offset: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD settings (arXiv:2405.21060)."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class VisionConfig:
    """Stubbed modality frontend: the backbone consumes precomputed patch
    embeddings of shape (num_image_tokens, embed_dim); a projector maps them
    to d_model.  cross_attn_every: one cross-attention layer per N layers."""

    embed_dim: int = 1280
    num_image_tokens: int = 576
    cross_attn_every: int = 0       # 0 => image tokens are inlined (not used here)
    max_images: int = 1


@dataclass(frozen=True)
class AudioConfig:
    """Stubbed audio frontend: precomputed frame embeddings feed an encoder;
    the decoder cross-attends to encoder output (enc-dec, seamless-style)."""

    embed_dim: int = 1024
    num_frames: int = 512           # mel-frame embeddings after conv stack
    encoder_layers: int = 12


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = False
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention variant: 0 = full causal.  >0 = sliding window size.  The
    # launcher overrides this per input-shape (long_500k forces a window on
    # full-attention archs — see DESIGN.md §6).
    sliding_window: int = 0
    # hybrid: one attention layer per ``attn_every`` layers, rest are SSM.
    attn_every: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    source: str = ""                # citation for the numbers
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decoder (audio is enc-dec)

    @property
    def supports_long_context_natively(self) -> bool:
        """Sub-quadratic per-step decode without an attention-variant switch."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string; drives the grouped-scan model builder.

        kinds: 'attn' (self-attn + ffn), 'moe' (self-attn + moe-ffn),
               'ssm' (mamba block), 'ssm_moe', 'xattn' (cross-attn + ffn).
        """
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
                continue
            if self.family == "hybrid":
                is_attn = self.attn_every > 0 and (i % self.attn_every == self.attn_every // 2)
                base = "attn" if is_attn else "ssm"
            elif self.family == "vlm" and self.vision and self.vision.cross_attn_every:
                base = "xattn" if (i % self.vision.cross_attn_every
                                   == self.vision.cross_attn_every - 1) else "attn"
            else:
                base = "attn"
            if self.moe is not None:
                use_moe = (i >= self.moe.first_k_dense
                           and i % self.moe.moe_every == self.moe.moe_offset)
                if use_moe:
                    base = {"attn": "moe", "ssm": "ssm_moe"}.get(base, base + "_moe")
            kinds.append(base)
        return tuple(kinds)

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        return _param_count(self, active_only=True)

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (≤2 layers,
        d_model≤512, ≤4 experts) — same code paths, toy sizes."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        head_dim = d_model // num_heads if num_heads else 1
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep the GQA ratio where possible
        if self.num_kv_heads < self.num_heads:
            num_kv = max(1, num_heads // max(1, self.num_heads // self.num_kv_heads))
        layers = min(self.num_layers, self.attn_every if self.attn_every else 2)
        if self.family == "hybrid":
            layers = self.attn_every  # one full group: 1 attn + (g-1) ssm
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(4, moe.num_experts),
                experts_per_token=min(2, moe.experts_per_token),
                num_shared_experts=min(1, moe.num_shared_experts),
                expert_d_ff=min(128, moe.expert_d_ff) if moe.expert_d_ff else 0,
                dense_d_ff=min(256, moe.dense_d_ff) if moe.dense_d_ff else 0,
                first_k_dense=min(1, moe.first_k_dense),
                capacity_factor=-1.0,   # no-drop: exact decode/train consistency
            )
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=min(32, ssm.state_dim),
                                      head_dim=32, chunk_size=32)
        vision = self.vision
        if vision is not None:
            vision = dataclasses.replace(vision, embed_dim=64, num_image_tokens=16,
                                         cross_attn_every=2 if vision.cross_attn_every else 0)
        audio = self.audio
        if audio is not None:
            audio = dataclasses.replace(audio, embed_dim=64, num_frames=16,
                                        encoder_layers=2)
        kw = dict(
            name=self.name + "-smoke", family=self.family, num_layers=layers,
            d_model=d_model, num_heads=num_heads, num_kv_heads=num_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0, vocab_size=min(self.vocab_size, 512),
            head_dim=head_dim, rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            sliding_window=0, attn_every=self.attn_every, moe=moe, ssm=ssm,
            vision=vision, audio=audio, source=self.source, dtype="float32",
        )
        kw.update(over)
        return ModelConfig(**kw)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    kinds = cfg.layer_kinds()
    hd = cfg.head_dim
    attn = d * (cfg.num_heads * hd) + 2 * d * (cfg.num_kv_heads * hd) + (cfg.num_heads * hd) * d
    ffn = 3 * d * cfg.d_ff if cfg.d_ff else 0
    ssm_p = 0
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * d
        nheads = d_in // cfg.ssm.head_dim
        # in_proj (x, z, B, C, dt), conv, out_proj, A, D
        d_bc = 2 * cfg.ssm.ngroups * cfg.ssm.state_dim
        ssm_p = d * (2 * d_in + d_bc + nheads) + (d_in + d_bc) * cfg.ssm.conv_width \
            + d_in * d + 2 * nheads
    for kind in kinds:
        if kind in ("attn", "xattn"):
            total += attn + ffn
        elif kind == "moe":
            m = cfg.moe
            e_ff = m.expert_d_ff or cfg.d_ff
            n_e = (m.experts_per_token if active_only else m.num_experts)
            total += attn + 3 * d * e_ff * (n_e + m.num_shared_experts) + d * m.num_experts
        elif kind == "ssm":
            total += ssm_p + ffn
        elif kind == "ssm_moe":
            m = cfg.moe
            e_ff = m.expert_d_ff or cfg.d_ff
            n_e = (m.experts_per_token if active_only else m.num_experts)
            total += ssm_p + 3 * d * e_ff * (n_e + m.num_shared_experts) + d * m.num_experts
    if cfg.audio is not None:  # encoder stack
        total += cfg.audio.encoder_layers * (attn + ffn)
        # decoder cross-attention blocks (every decoder layer)
        total += len(kinds) * attn
    if cfg.vision is not None:
        total += cfg.vision.embed_dim * d  # projector
    return total


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def registry() -> Dict[str, ModelConfig]:
    _load_all()
    return dict(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import repro_torch.configs as pkg
    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name not in ("base", "__init__"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")
    _LOADED = True
