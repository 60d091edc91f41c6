"""Architecture configuration for the LM substrate.

One dataclass covers all ten assigned architectures; the `pattern` field
cycles layer kinds over depth (e.g. gemma3's 5 local : 1 global, or
recurrentgemma's rglru-rglru-local).  Layers with identical parameter
shapes inside a repeating unit are stacked along a leading axis (the
JAX package's scanned layout, kept so parameters and caches carry across
between the two packages); the forward pass loops over that axis.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    rope_theta: float = 10000.0
    window: int = 0                       # local-attention window
    # block pattern, cycled over n_layers: attn | local | ssm | rglru
    pattern: tuple = ("attn",)
    # mlp
    d_ff: int = 0
    mlp_act: str = "silu"                 # silu | gelu
    mlp_gated: bool = True                # False: classic 2-matrix MLP
    # moe
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # mla (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    conv_width: int = 4
    # rglru (recurrentgemma)
    lru_width: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    is_enc_dec: bool = False
    # modality frontend stub: None | vision | audio
    frontend: str | None = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def unit(self) -> tuple:
        return self.pattern

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail(self) -> tuple:
        """Layers left over after whole units (unrolled separately)."""
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """True if no layer kind holds a full-sequence KV cache, or only a
        bounded fraction does (local windows / recurrent state)."""
        return all(k in ("ssm", "rglru", "local") for k in self.pattern) or \
            self.pattern.count("attn") * 6 <= len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and reporting.  Counts follow init_params exactly."""
        d, V = self.d_model, self.vocab
        total = V * d                                  # embedding
        if not self.tie_embeddings:
            total += V * d
        kinds = [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]
        for kind in kinds:
            total += self._block_params(kind)
        total += d                                     # final norm
        if self.is_enc_dec:
            total += self.enc_layers * (self._attn_params() + self._mlp_params(self.d_ff) + 3 * d)
        return total

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: only routed-in experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full_moe = 3 * d * self.moe_d_ff * self.n_experts
        act_moe = 3 * d * self.moe_d_ff * (self.n_experts_per_tok + self.n_shared_experts)
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.pattern[i % len(self.pattern)] in ("attn", "local"))
        return self.param_count() - n_moe_layers * (full_moe - act_moe) \
            - n_moe_layers * d * self.n_experts  # router counted once

    # ---- per-kind parameter counts (mirrors lm.init exactly) ----
    def _attn_params(self) -> int:
        d, H, Hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        if self.use_mla:
            ql, kl, rd = self.q_lora_rank, self.kv_lora_rank, self.rope_head_dim
            n = d * ql + ql * H * (hd + rd)            # q lora
            n += d * (kl + rd)                          # kv down + shared rope
            n += kl * H * hd * 2                        # k_up, v_up
            n += H * hd * d                             # out
            n += ql + kl                                # lora norms
            return n
        n = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if self.qkv_bias:
            n += H * hd + 2 * Hkv * hd
        if self.qk_norm:
            n += 2 * hd
        return n

    def _mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "ssm":
            di = self.ssm_heads * self.ssm_head_dim
            n = d * (2 * di + 2 * self.ssm_state + self.ssm_heads)  # in_proj
            n += self.conv_width * (di + 2 * self.ssm_state)        # conv
            n += self.ssm_heads * 2 + di                            # A, D, dt_bias? (A,D per head + skip)
            n += di * d                                              # out
            return n + d                                             # norm
        if kind == "rglru":
            w = self.lru_width or d
            n = d * w * 2 + self.conv_width * w                      # in (x,gate) + conv
            n += 2 * w * (w // 8) * 8 if False else 2 * w * w // 4   # block-diag gates (w x w/4)
            n += w                                                   # Lambda
            n += w * d                                               # out
            return n + d
        # attention-ish kinds
        n = self._attn_params() + 2 * d                              # + 2 norms
        if self.is_moe:
            n += self.n_experts * 3 * d * self.moe_d_ff
            n += self.n_shared_experts * 3 * d * self.moe_d_ff
            n += d * self.n_experts
        else:
            n += self._mlp_params(self.d_ff)
        return n
