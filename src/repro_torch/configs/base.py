"""Config system of the PyTorch port (a copy of the reference package's).

Every architecture is described by a single frozen ``ModelConfig``. Field
names are identical to the reference config, so a config built there
converts with ``ModelConfig(**dataclasses.asdict(cfg))``. The config fully
determines parameter shapes, the layer plan and the cache structure. A
field that only the reference's XLA path reads (``scan_unroll``) is kept
for that round trip; ``remat`` checkpoints each layer in training, as the
reference checkpoints each layer run.
``InputShape`` and ``INPUT_SHAPES`` are the reference's four assigned
input shapes, which the dry run and the cost model read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """A homogeneous group of layers (one run of the layer plan).

    kind:
      - "attn"  : GQA attention + (dense swiglu | MoE) FFN
      - "mamba" : Mamba2 SSM mixer + no separate FFN (mixer includes gating)
      - "rwkv"  : RWKV6 time-mix + channel-mix
      - "shared_attn" : Zamba-style shared-parameter attention block (params
        are reused across every invocation; each invocation has its own cache)
    """
    kind: str
    count: int
    # attention options
    window: Optional[int] = None      # sliding window; None = full attention
    cross_attn: bool = False          # whisper decoder cross-attention
    causal: bool = True               # False for encoder blocks
    moe: bool = False
    # per-layer window override (e.g. gemma3 local/global pattern); length == count
    windows: Optional[Tuple[Optional[int], ...]] = None

    def layer_windows(self) -> Tuple[Optional[int], ...]:
        if self.windows is not None:
            assert len(self.windows) == self.count
            return self.windows
        return (self.window,) * self.count


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""                    # citation for the config
    # core dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    # attention details
    rope_theta: float = 10000.0
    qkv_bias: bool = False              # qwen1.5
    sliding_window: Optional[int] = None       # uniform SWA (mixtral)
    local_global_ratio: int = 0         # gemma3: N local layers per 1 global
    local_window: Optional[int] = None  # window of local layers
    # YaRN on the full-attention layers (the windowed ones keep plain RoPE
    # at rope_theta): (factor, original max positions, beta_fast,
    # beta_slow, attention_factor); a port-only field
    yarn: Optional[Tuple[float, int, float, float, float]] = None
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_impl: str = "dense_all"         # dense_all | dropping (perf path)
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1                 # dropping: group-local dispatch
                                        # (set to the data-shard count so
                                        # gathers never cross devices)
    router_aux_coef: float = 0.01
    # SSM (RWKV6 / Mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # Zamba-style hybrid: one shared attention block after every k SSM layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper): encoder layer count + stub frame count
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # VLM stub: number of prepended patch embeddings
    num_patches: int = 0
    # misc
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    attn_impl: str = "xla"              # xla | pallas | pallas_interpret
    attn_block_q: int = 256             # chunked-attention query block
    ring_cache: bool = False            # sliding-window layers keep only the
                                        # last `window` KV entries (vLLM-style
                                        # ring buffer) — long_500k §Perf item
    remat: bool = True                  # checkpoint each layer-run in training
    scan_unroll: bool = False           # unroll layer scans (analysis mode:
                                        # XLA cost_analysis counts while-loop
                                        # bodies ONCE, so rooflines lower
                                        # with unroll=True for exact FLOPs)

    def __post_init__(self):
        # a JSON list (a configuration file's) is kept as the tuple
        if self.yarn is not None and not isinstance(self.yarn, tuple):
            object.__setattr__(self, "yarn", tuple(self.yarn))

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_plan(self) -> Tuple[LayerSpec, ...]:
        """Group layers into homogeneous runs."""
        if self.arch_type == "ssm":  # rwkv6
            return (LayerSpec(kind="rwkv", count=self.num_layers),)
        if self.arch_type == "hybrid":  # zamba2: k mamba layers then shared attn
            k = self.hybrid_attn_every
            assert k > 0 and self.num_layers % k == 0
            groups = self.num_layers // k
            plan = []
            for _ in range(groups):
                plan.append(LayerSpec(kind="mamba", count=k))
                plan.append(LayerSpec(kind="shared_attn", count=1))
            return tuple(plan)
        moe = self.num_experts > 0
        if self.local_global_ratio:  # gemma3 pattern: N local then 1 global
            n = self.local_global_ratio
            w = self.local_window
            plan = []
            remaining = self.num_layers
            while remaining > 0:
                c = min(n, remaining)
                plan.append(LayerSpec(kind="attn", count=c, window=w,
                                      moe=moe))
                remaining -= c
                if remaining > 0:
                    plan.append(LayerSpec(kind="attn", count=1, window=None,
                                          moe=moe))
                    remaining -= 1
            return tuple(plan)
        return (LayerSpec(kind="attn", count=self.num_layers, moe=moe,
                          window=self.sliding_window,
                          cross_attn=self.encoder_layers > 0),)

    @property
    def supports_kv_sharing(self) -> bool:
        """Does the paper's KV protocol apply (any attention layers)?"""
        return any(s.kind in ("attn", "shared_attn")
                   for s in self.layer_plan())

    @property
    def attn_layer_count(self) -> int:
        return sum(s.count for s in self.layer_plan()
                   if s.kind in ("attn", "shared_attn"))

    @property
    def total_layers(self) -> int:
        return sum(s.count for s in self.layer_plan())

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's rule)."""
        small = dict(
            num_layers=2, d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256), vocab_size=min(self.vocab_size, 512),
            head_dim=32,
        )
        if self.num_heads:
            small["num_heads"] = min(self.num_heads, 4)
            small["num_kv_heads"] = min(self.num_kv_heads, 2)
            if self.num_heads == self.num_kv_heads:  # MHA-style families
                small["num_kv_heads"] = small["num_heads"]
        if self.num_experts:
            small["num_experts"] = min(self.num_experts, 4)
            small["num_experts_per_tok"] = min(self.num_experts_per_tok, 2)
        if self.encoder_layers:
            small["encoder_layers"] = 2
            small["encoder_seq"] = 16
        if self.num_patches:
            small["num_patches"] = 8
        if self.hybrid_attn_every:
            small["hybrid_attn_every"] = 1
            small["num_layers"] = 2
        if self.arch_type in ("ssm", "hybrid"):
            small["ssm_head_dim"] = 32
            small["ssm_state"] = min(self.ssm_state or 16, 16)
        if self.sliding_window is not None:
            small["sliding_window"] = 8
        if self.local_global_ratio:
            small["local_global_ratio"] = 1
            small["local_window"] = 8
            small["num_layers"] = 2
            if self.num_experts:     # one whole period, experts in each
                small["local_global_ratio"] = self.local_global_ratio
                small["num_layers"] = self.local_global_ratio + 1
        if self.yarn is not None:    # the ramp bites within a few tokens
            small["yarn"] = (self.yarn[0], 16) + tuple(self.yarn[2:])
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (public pool), as the reference's.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
