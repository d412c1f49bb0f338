"""Config system: model architectures and input-shape cells.

A copy of the JAX package's ``configs/base.py``: the port keeps its own
copy and imports nothing of that package.

Every assigned architecture is a ``ModelConfig``; every workload shape is a
``ShapeConfig``. A (ModelConfig, ShapeConfig) pair is one dry-run /
roofline cell. Configs are plain frozen dataclasses so they can be hashed,
diffed and logged by the adviser.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def pad_to_multiple(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)


@dataclass(frozen=True)
class ShapeConfig:
    """One workload shape (the paper's 'granularity' axis at LM scale)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. ``family`` selects the block structure:

    dense  — pre-norm GQA transformer (llama-style RoPE/SwiGLU)
    moe    — dense attention + top-k routed expert MLP (EP over 'model')
    ssm    — Mamba2 / SSD, attention-free
    hybrid — Mamba2 backbone with a shared attention block every
             ``attn_every`` layers (Zamba2-style, shared weights)
    audio  — dense decoder over codec tokens (frontend stubbed)
    vlm    — dense decoder with prepended patch embeddings (frontend stubbed)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid ---
    attn_every: int = 0  # zamba2: shared attention block period
    # --- frontends (stubs) ---
    n_frontend_tokens: int = 0  # vlm: image patches prepended per sequence
    # --- numerics / structure ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # --- distribution policy (adviser-tunable) ---
    param_sharding: str = "tp"  # "tp" | "fsdp"
    train_accum: int = 1  # gradient-accumulation microbatches (train_4k)
    zero2: int = 0  # 1 = gather-once/reduce-once accumulation (§Perf #phi3)
    remat: str = "dots"  # "none" | "dots" | "full"
    attn_chunk: int = 512  # kv-block size for chunked attention
    causal_blocking: str = "masked"  # "masked" | "triangular" (hillclimbed)
    kv_quant: bool = False  # int8 KV cache (per-token/head scales) — §Perf
    attn_flat_tp: bool = False  # shard flattened q/kv projection dims when
    # n_heads ∤ mesh (keeps attn weights + grads sharded) — §Perf C.4
    sub_quadratic: bool = False  # may run long_500k
    moe_path: str = "dispatch"  # "dispatch" (a2a) | "dense" (masked+psum)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities ----------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def attn_layer_ids(self) -> Tuple[int, ...]:
        """Indices (in the layer stack) that run attention."""
        if self.family in ("dense", "moe", "audio", "vlm"):
            return tuple(range(self.num_layers))
        if self.family == "ssm":
            return ()
        if self.family == "hybrid":
            p = self.attn_every
            return tuple(i for i in range(self.num_layers) if (i + 1) % p == 0)
        raise ValueError(self.family)

    # ---- parameter counting (for MODEL_FLOPS and memory budgeting) -------
    def param_count(self) -> int:
        """Exact parameter count of the constructed model."""
        d, v = self.d_model, self.padded_vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += d * v  # lm head
        n += d  # final norm
        for i in range(self.num_layers):
            n += self._layer_params(i)
        if self.family == "hybrid" and self.attn_layer_ids():
            n += self._attn_params() + d  # one shared attention block + norm
        if self.family == "vlm":
            n += self.d_model * self.d_model  # patch-embedding projection stub
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU: w1, w3, w2

    def _ssm_params(self) -> int:
        d, di, ns = self.d_model, self.ssm_d_inner, self.ssm_state
        h = self.ssm_heads
        n = d * (2 * di + 2 * ns + h)  # in_proj → [x, z, B, C, dt]
        n += self.ssm_conv * (di + 2 * ns)  # causal depthwise conv on x,B,C
        n += h + h  # A_log, D (per head)
        n += di  # gated rmsnorm scale
        n += di * d  # out_proj
        return n

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        if self.family in ("dense", "audio", "vlm"):
            return self._attn_params() + self._mlp_params() + 2 * d
        if self.family == "moe":
            router = d * self.n_experts
            experts = self.n_experts * 3 * d * self.d_ff
            return self._attn_params() + router + experts + 2 * d
        if self.family == "ssm":
            return self._ssm_params() + d
        if self.family == "hybrid":
            return self._ssm_params() + d  # shared attn counted once, above
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dead = self.num_layers * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.param_count() - dead

    # ---- reduced config for CPU smoke tests ------------------------------
    def reduced(self) -> "ModelConfig":
        scale = {
            "num_layers": min(self.num_layers, 2),
            "d_model": 64,
            "n_heads": min(self.n_heads, 4) if self.n_heads else 0,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            "head_dim": 16 if self.n_heads else 0,
            "d_ff": 128,
            "vocab_size": 256,
            "n_experts": min(self.n_experts, 4) if self.n_experts else 0,
            "top_k": min(self.top_k, 2) if self.top_k else 0,
            "ssm_state": min(self.ssm_state, 16) if self.ssm_state else 0,
            "ssm_head_dim": 16 if self.ssm_state else 64,
            "ssm_chunk": 16 if self.ssm_state else 128,
            "attn_every": 2 if self.attn_every else 0,
            "n_frontend_tokens": 4 if self.n_frontend_tokens else 0,
            "attn_chunk": 32,
            "dtype": "float32",
            "name": self.name + "-smoke",
        }
        return replace(self, **scale)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (ensure arch modules import)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str) -> list[Tuple[ModelConfig, ShapeConfig]]:
    """All (arch, shape) cells; long_500k only for sub-quadratic archs."""
    cfg = get_config(arch)
    out = []
    for s in SHAPES.values():
        out.append((cfg, s))
    return out


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped: full-attention arch at 500k decode (see DESIGN.md §6.2)"
    return True, ""
