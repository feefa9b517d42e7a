"""Architecture configuration schema for the assigned model zoo.

Port of ``repro.configs.base``: the same dataclass, data only.  Which of
these families the port's model runs is said in ``repro_torch.models.lm``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM architecture.  A single schema covers all ten assigned archs:
    dense / MoE / SWA / enc-dec / SSM / hybrid / frontend-stub families.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int  # dense MLP hidden (or per-expert hidden for MoE)
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0  # always-on experts (llama4-style)
    capacity_factor: float = 1.25
    # --- attention ---
    window: Optional[int] = None  # sliding-window attention (SWA)
    rope_theta: float = 10_000.0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- hybrid (zamba2-style) ---
    attn_every: int = 0  # insert a (shared) attention block every k layers
    shared_attn: bool = False  # reuse ONE attention block's weights
    # --- encoder-decoder ---
    enc_layers: int = 0  # >0 => enc-dec; n_layers is then the decoder depth
    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # "audio" | "vision": inputs include embeddings
    n_prefix_tokens: int = 0  # vlm: patch tokens prepended to the text
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # citation / provenance string from the assignment table
    source: str = ""

    # ---------------- derived ----------------
    @property
    def hd(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.is_ssm else 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context?  SSM/hybrid/SWA only."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        return _param_count(self, active_only=True)

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if not self.attn_every else 2 * self.attn_every),
            d_model=256,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else self.n_kv_heads,
            d_ff=512 if self.d_ff else 0,
            vocab=512,
            head_dim=64 if self.n_heads else None,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=64 if self.window else None,
            ssm_state=min(self.ssm_state, 32),
            ssm_head_dim=32 if self.is_ssm else self.ssm_head_dim,
            attn_every=2 if self.attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            n_prefix_tokens=min(self.n_prefix_tokens, 16),
            dtype="float32",
            name=self.name + "-reduced",
        )
        small.update(over)
        return dataclasses.replace(self, **small)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    n = 0
    # embeddings (+ output head unless tied)
    n += cfg.vocab * d
    if not cfg.tie_embeddings:
        n += cfg.vocab * d

    def attn_params():
        hd = cfg.hd
        return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d

    def mlp_params(ff):
        return 3 * d * ff  # gate, up, down

    def moe_params():
        router = d * cfg.n_experts
        experts = cfg.top_k if active_only else cfg.n_experts
        shared = cfg.n_shared_experts
        return router + (experts + shared) * mlp_params(cfg.d_ff) // 1

    def mamba_params():
        di, s = cfg.d_inner, cfg.ssm_state
        in_proj = d * (2 * di + 2 * s + cfg.ssm_heads)  # z, x, B, C, dt
        conv = cfg.ssm_conv * (di + 2 * s)
        extra = 2 * cfg.ssm_heads + di  # A, D, gated-norm
        out = di * d
        return in_proj + conv + extra + out

    if cfg.family in ("dense", "vlm"):
        n += cfg.n_layers * (attn_params() + mlp_params(cfg.d_ff) + 2 * d)
    elif cfg.family == "moe":
        n += cfg.n_layers * (attn_params() + moe_params() + 2 * d)
    elif cfg.family == "ssm":
        n += cfg.n_layers * (mamba_params() + d)
    elif cfg.family == "hybrid":
        n += cfg.n_layers * (mamba_params() + d)
        blocks = 1 if cfg.shared_attn else max(cfg.n_layers // max(cfg.attn_every, 1), 1)
        n += blocks * (attn_params() + mlp_params(cfg.d_ff) + 2 * d)
    elif cfg.family == "encdec":
        n += cfg.enc_layers * (attn_params() + mlp_params(cfg.d_ff) + 2 * d)
        # decoder: self-attn + cross-attn + mlp
        n += cfg.n_layers * (2 * attn_params() + mlp_params(cfg.d_ff) + 3 * d)
    n += d  # final norm
    return n


# Shape cells assigned to every architecture.
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524_288, global_batch=1),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """long_500k only for sub-quadratic archs (see DESIGN.md skip notes)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return tuple(names)
