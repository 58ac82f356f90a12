"""Analytic implementation-FLOPs / bytes model per (arch x shape), a copy
of the reference package's ``utils/analytic.py`` over the port's configs.

XLA's ``cost_analysis`` counts while-loop bodies ONCE (scan trip counts are
invisible to it), so scanned-layer models under-report by ~L x. Rather than
unrolling every 80-layer model (compile-prohibitive on this host), the
roofline's compute/memory terms come from this closed-form model of what the
*implementation actually executes* (full masked attention matmuls, dense-all
MoE overcompute, remat recompute), validated against unrolled-scan
cost_analysis for the small architectures (see EXPERIMENTS.md §Roofline
methodology).

All counts are WHOLE-JOB totals; divide by chip count for per-device terms.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass
class CostBreakdown:
    flops: float          # executed FLOPs (whole job)
    weight_bytes: float   # parameter bytes touched (whole model, once)
    act_bytes: float      # activation/cache HBM traffic (whole job)
    model_flops: float    # 2*N_active*tokens (*3 train) — "useful" floor

    @property
    def total_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes


def _attn_layer_flops(cfg, T, S_kv, cross_len=0):
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * T * d * (Hq + 2 * Hkv) * Dh + 2 * T * Hq * Dh * d
    attn = 4 * T * S_kv * Hq * Dh          # scores + values (full masked)
    if cross_len:
        proj += 2 * T * d * Hq * Dh + 2 * T * Hq * Dh * d
        attn += 4 * T * cross_len * Hq * Dh
    return proj + attn


def _mlp_flops(cfg, T):
    mult = 6 if cfg.arch_type != "audio" and not cfg.name.startswith(
        "starcoder") else 4
    return mult * T * cfg.d_model * cfg.d_ff


def _moe_flops(cfg, T):
    per_expert_tok = 6 * cfg.d_model * cfg.d_ff      # FFN flops per token
    router = 2 * T * cfg.d_model * cfg.num_experts
    if cfg.moe_impl == "dropping":
        # capacity-activated compute + dispatch/combine einsums
        C_total = T * cfg.num_experts_per_tok * cfg.moe_capacity_factor
        disp = 4 * C_total * cfg.d_model
        return per_expert_tok * C_total + router + disp
    # dense-all: every expert on every token
    return per_expert_tok * T * cfg.num_experts + router


def _rwkv_layer_flops(cfg, T):
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.ssm_head_dim
    tm = 2 * T * d * d * 5 + 2 * T * d * 64 * 2       # r,k,v,g,o + lora
    rec = 6 * T * d * hd                              # state update/read
    cm = 2 * T * d * f * 2 + 2 * T * d * d
    return tm + rec + cm


def _mamba_layer_flops(cfg, T):
    d = cfg.d_model
    di, nh, hd, ds = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)
    conv_dim = di + 2 * ds
    proj = 2 * T * d * (di + conv_dim + nh) + 2 * T * di * d
    conv = 2 * T * cfg.ssm_conv * conv_dim
    rec = 8 * T * nh * hd * ds
    return proj + conv + rec


def param_count(cfg: ModelConfig) -> float:
    """Approximate parameter count N (attention + FFN + embeddings)."""
    d, L = cfg.d_model, cfg.num_layers
    Dh = cfg.resolved_head_dim
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * Dh
            + cfg.num_heads * Dh * d) if cfg.num_heads else 0
    if cfg.num_experts:
        ffn = 3 * d * cfg.d_ff * cfg.num_experts
    elif cfg.arch_type == "ssm":
        ffn = 5 * d * d + 3 * d * cfg.d_ff
        attn = 0
    else:
        ffn = 3 * d * cfg.d_ff
    if cfg.arch_type == "hybrid":
        di = cfg.d_inner
        conv_dim = di + 2 * cfg.ssm_state
        mamba = d * (di + conv_dim + cfg.ssm_heads) + di * d
        shared = attn + 3 * d * cfg.d_ff
        return n + L * mamba + shared
    if cfg.encoder_layers:
        return n + (L + cfg.encoder_layers) * (attn + ffn) + L * attn
    return n + L * (attn + ffn)


def active_param_count(cfg: ModelConfig) -> float:
    if not cfg.num_experts:
        return param_count(cfg)
    d, L = cfg.d_model, cfg.num_layers
    full = param_count(cfg)
    ffn_all = 3 * d * cfg.d_ff * cfg.num_experts * L
    ffn_act = 3 * d * cfg.d_ff * cfg.num_experts_per_tok * L
    return full - ffn_all + ffn_act


def param_bytes(cfg: ModelConfig, dtype_size=2) -> float:
    return param_count(cfg) * dtype_size


def forward_flops(cfg: ModelConfig, n_tokens: float, s_kv: float,
                  batch: float = 1.0, window_aware: bool = False,
                  include_encoder: bool = True) -> float:
    """One forward pass. n_tokens = new tokens TOTAL (B*S); s_kv = attended
    length per token (cache len for decode, S for prefill/train)."""
    T = n_tokens
    fl = 0.0
    for spec in cfg.layer_plan():
        n = spec.count
        if spec.kind in ("attn", "shared_attn"):
            for w in spec.layer_windows():
                # The baseline XLA path executes FULL masked matmuls, so the
                # executed attention FLOPs ignore the window. The optimized
                # window-aware path (block-skipping flash kernel / ring
                # cache) charges min(w, s_kv) — toggled by window_aware,
                # which is the §Perf "banded attention" iteration.
                eff = min(w, s_kv) if (w and window_aware) else s_kv
                fl += _attn_layer_flops(
                    cfg, T, eff,
                    cross_len=cfg.encoder_seq if spec.cross_attn else 0)
            if spec.moe:
                fl += n * _moe_flops(cfg, T)
            else:
                fl += n * _mlp_flops(cfg, T)
        elif spec.kind == "rwkv":
            fl += n * _rwkv_layer_flops(cfg, T)
        elif spec.kind == "mamba":
            fl += n * _mamba_layer_flops(cfg, T)
    if cfg.encoder_layers and include_encoder:
        # whisper encoder consumes frames once (prefill/train only)
        Tenc = batch * cfg.encoder_seq
        fl += cfg.encoder_layers * (
            _attn_layer_flops(cfg, Tenc, cfg.encoder_seq)
            + _mlp_flops(cfg, Tenc))
    fl += 2 * T * cfg.d_model * cfg.vocab_size      # logits
    return fl


def job_cost(cfg: ModelConfig, shape: InputShape) -> CostBreakdown:
    B, S = shape.global_batch, shape.seq_len
    dtype = 2  # bf16
    pb = param_bytes(cfg, dtype)
    n_act = active_param_count(cfg)

    if shape.mode == "train":
        T = B * S
        fwd = forward_flops(cfg, T, S, batch=B)
        # bwd = 2x fwd; remat adds ~1 extra fwd of the layer stack
        flops = fwd * (4 if cfg.remat else 3)
        act = T * cfg.d_model * cfg.total_layers * 12 * dtype \
            + T * cfg.vocab_size * 4
        wb = pb * 3          # params read fwd+bwd + optimizer state touch
        model = 6 * n_act * T
        return CostBreakdown(flops, wb, act, model)

    if shape.mode == "prefill":
        T = B * S
        flops = forward_flops(cfg, T, S, batch=B)
        act = T * cfg.d_model * cfg.total_layers * 6 * dtype \
            + 2 * T * cfg.num_kv_heads * cfg.resolved_head_dim \
            * cfg.attn_layer_count * dtype
        return CostBreakdown(flops, pb, act, 2 * n_act * T)

    # decode: one token per sequence over a seq_len cache
    T = B
    flops = forward_flops(cfg, T, S, batch=B, include_encoder=False)
    # cache read traffic dominates
    cache = 0.0
    for spec in cfg.layer_plan():
        if spec.kind in ("attn", "shared_attn"):
            for w in spec.layer_windows():
                eff = min(w, S) if w else S
                cache += 2 * B * eff * cfg.num_kv_heads \
                    * cfg.resolved_head_dim * dtype
        elif spec.kind == "rwkv":
            hd = cfg.ssm_head_dim
            cache += spec.count * B * cfg.d_model * hd * 4 * 2
        elif spec.kind == "mamba":
            cache += spec.count * B * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * 4 * 2
    return CostBreakdown(flops, pb, cache, 2 * n_act * T)
