"""Core primitives of the port: init, RMSNorm, RoPE (with YaRN on the
layers a config gives it), whisper's sinusoid positions, masked GQA
attention
(causal, sliding window) with the Eq. (1) context mass, its query-blocked
form, the swiglu and gelu MLPs and the top-k MoE in both of the
reference's strategies (``dense_all`` and capacity-based ``dropping``);
``dense_all`` runs as a loop over the experts on the CPU and in float32,
and over the routed rows alone on the card (``moe_on_kernel``).

Each function mirrors the reference's dtype steps: norms and rotary run in
float32 and cast back, attention scores are computed in the input dtype and
then cast to float32, softmax runs in float32 and the probabilities are cast
to v's dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.selection import _exp_f32
from repro_torch.kernels.moe_grouped import grouped_experts
from repro_torch.utils import trace

NEG_INF = -1e30
MOE_SPAN = "moe.experts"
MOE_ASSIGNMENTS = "moe.assignments"
MOE_GROUPED = "moe.grouped"
MOE_LOOP = "moe.loop"


# ---------------------------------------------------------------------------
# init (same distributions as the reference; torch.Generator draws differ
# from jax.random, so parity tests bridge weights with ``weights.py``)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norm and rotary
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         yarn: Optional[Tuple[float, int, float, float, float]] = None):
    """Half-split rotary embedding. x: (B, S, H, D); positions: (B, S).
    With ``yarn`` (``ModelConfig.yarn``) the frequencies are YaRN's
    (``yarn_freqs``) and cos and sin are scaled by its attention factor."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    if yarn is not None:
        freq = yarn_freqs(freq, theta, yarn)
    ang = positions.float()[..., None] * freq            # (B, S, half)
    ang = ang[..., None, :]                              # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if yarn is not None:
        cos, sin = cos * yarn[4], sin * yarn[4]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def yarn_freqs(freq: torch.Tensor, theta: float,
               yarn: Tuple[float, int, float, float, float]) -> torch.Tensor:
    """YaRN's rotary frequencies from the plain ones ``freq`` (d / 2,
    float32): a frequency that turns fewer than ``beta_slow`` times over
    the original length is divided by ``factor``, one that turns more
    than ``beta_fast`` times is kept, and a linear ramp over the
    dimensions between blends the two. The ramp's ends are
    floor / ceil of d ln(L0 / (2 pi beta)) / (2 ln theta), clamped to
    [0, d / 2 - 1]."""
    factor, orig, beta_fast, beta_slow, _ = yarn
    half = freq.shape[0]
    d = 2 * half

    def dim_of(turns):
        return d * math.log(orig / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = min(max(math.floor(dim_of(beta_fast)), 0), half - 1)
    high = min(max(math.ceil(dim_of(beta_slow)), 0), half - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=freq.device)
             - low) / (high - low)).clamp(0.0, 1.0)
    return freq / factor * ramp + freq * (1.0 - ramp)


def layer_yarn(cfg, window: Optional[int]):
    """The rotary scaling of a layer: the config's YaRN on full-attention
    layers, none on windowed ones (they keep plain RoPE)."""
    return cfg.yarn if window is None else None


def sinusoid_positions(positions: torch.Tensor, d_model: int):
    """Additive sinusoidal embeddings (whisper-style, no tables): (...,
    d_model) float32, ``[sin | cos]`` of positions over the frequencies
    ``exp(-log(10000) * i / half)``, in float32 as the reference computes
    them. The frequencies take XLA's float32 exp (``_exp_f32``):
    ``torch.exp`` rounds 51 of whisper-medium's 512 otherwise, and one ulp
    of a frequency times a position of ~1,500 moves the sine by ~1e-4.
    The sines and cosines then agree within ~6e-8."""
    half = d_model // 2
    arg = -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half
    freq = torch.from_numpy(_exp_f32(arg.numpy())).to(positions.device)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention core (plain PyTorch; the decode kernel lives in kernels/)
# ---------------------------------------------------------------------------
def _masked_scores(q, k, *, q_pos, kv_pos, kv_valid, causal, window):
    """float32 scores (B, Hkv, G, Sq, Skv) of q (B, Sq, Hq, D) against k
    (B, Skv, Hkv, D), NEG_INF where the causal, window and validity masks
    forbid."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(Dh)
    if q_pos.dim() == 1:
        q_pos = q_pos[None]
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None]
    qp = q_pos[:, None, None, :, None]
    kp = kv_pos[:, None, None, None, :]
    allow = torch.ones((max(q_pos.shape[0], kv_pos.shape[0]), 1, 1, Sq, Skv),
                       dtype=torch.bool, device=q.device)
    if causal:
        allow = allow & (kp <= qp)
    if window is not None:
        allow = allow & ((qp - kp) < window)
    if kv_valid is not None:
        if kv_valid.dim() == 1:
            kv_valid = kv_valid[None]
        allow = allow & kv_valid[:, None, None, None, :]
    return torch.where(allow, scores, torch.full_like(scores, NEG_INF))


def attention_core(
    q: torch.Tensor,                      # (B, Sq, Hq, D)
    k: torch.Tensor,                      # (B, Skv, Hkv, D)
    v: torch.Tensor,                      # (B, Skv, Hkv, D)
    *,
    q_pos: torch.Tensor,                  # (Sq,) or (B, Sq)
    kv_pos: torch.Tensor,                 # (Skv,) or (B, Skv)
    kv_valid: Optional[torch.Tensor] = None,   # (Skv,) or (B, Skv) bool
    causal: bool = True,
    window: Optional[int] = None,              # sliding window
    mass_mask: Optional[torch.Tensor] = None,  # (Skv,) bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked GQA attention; returns (out, context_mass (B,) or None).

    The mass is the paper's Eq. (1) inner sum: softmax mass on
    ``mass_mask`` columns, averaged over heads and query rows."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scores = _masked_scores(q, k, q_pos=q_pos, kv_pos=kv_pos,
                            kv_valid=kv_valid, causal=causal, window=window)
    probs = torch.softmax(scores, dim=-1)
    mass = None
    if mass_mask is not None:
        m = torch.einsum("bhgqk,k->b", probs, mass_mask.to(probs.dtype))
        mass = (m / (Hkv * G * Sq)).expand(B)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, Dh), mass


def attention_partials(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                       causal: bool = True, window=None, mass_mask=None,
                       blk_q: Optional[int] = None):
    """``attention_core`` over one slice of the KV sequence, unmerged:
    (out (B, Sq, Hq, D) normalised over the slice, in v's dtype; the
    row max m, the row sum l of exp(score - m) and, with ``mass_mask``,
    the slice's mass fraction, each (B, Sq, Hq) float32). Slices merge by
    their log-sum-exp weights exp(m - max m) * l (``sharding.
    local_attention``). A row with no allowed column has m = NEG_INF and
    weight 0 beside any slice that has one. With ``blk_q`` it takes query
    blocks as ``attention_core_chunked`` does."""
    B, Sq, Hq, Dh = q.shape
    if blk_q and Sq % blk_q == 0 and Sq > blk_q:
        if q_pos.dim() == 1:
            q_pos = q_pos[None].expand(B, Sq)
        parts = [attention_partials(
            q[:, i:i + blk_q], k, v, q_pos=q_pos[:, i:i + blk_q],
            kv_pos=kv_pos, kv_valid=kv_valid, causal=causal, window=window,
            mass_mask=mass_mask) for i in range(0, Sq, blk_q)]
        return tuple(None if p[0] is None else torch.cat(p, dim=1)
                     for p in zip(*parts))
    scores = _masked_scores(q, k, q_pos=q_pos, kv_pos=kv_pos,
                            kv_valid=kv_valid, causal=causal, window=window)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    l = e.sum(-1, keepdim=True)
    probs = e / l

    def rows(t):      # (B, Hkv, G, Sq) -> (B, Sq, Hq)
        return t.permute(0, 3, 1, 2).reshape(B, Sq, Hq)

    mf = None
    if mass_mask is not None:
        mf = rows(torch.einsum("bhgqk,k->bhgq", probs,
                               mass_mask.to(probs.dtype)))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return (out.reshape(B, Sq, Hq, Dh), rows(m[..., 0]), rows(l[..., 0]),
            mf)


def attention_core_chunked(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                           causal: bool = True, window=None, mass_mask=None,
                           blk_q: int = 512):
    """``attention_core`` over query blocks of ``blk_q`` rows, so the
    float32 probabilities held at once are (B, H, blk_q, Skv). It takes the
    plain core unless Sq is a multiple of ``blk_q`` larger than it, as the
    reference does; the mass is the mean of the blocks' masses."""
    B, Sq = q.shape[:2]
    kw = dict(kv_pos=kv_pos, kv_valid=kv_valid, causal=causal,
              window=window, mass_mask=mass_mask)
    if Sq % blk_q or Sq <= blk_q:
        return attention_core(q, k, v, q_pos=q_pos, **kw)
    if q_pos.dim() == 1:
        q_pos = q_pos[None].expand(B, Sq)
    outs, masses = [], []
    for i in range(0, Sq, blk_q):
        out, mass = attention_core(q[:, i:i + blk_q], k, v,
                                   q_pos=q_pos[:, i:i + blk_q], **kw)
        outs.append(out)
        masses.append(mass)
    mass = (torch.stack(masses).mean(0) if mass_mask is not None
            else None)
    return torch.cat(outs, dim=1), mass


# ---------------------------------------------------------------------------
# MLPs (swiglu; gelu for starcoder-style models)
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model, d_ff, dtype, device, mlp_type: str = "swiglu"):
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {"w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device)}


def apply_mlp(p, x, mlp_type: str = "swiglu"):
    """swiglu: silu(x W_gate) * (x W_up), then W_down; gelu: the tanh
    approximation (``jax.nn.gelu``'s default) of x W_up, then W_down."""
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE: top-k routing, then either every expert on every token with zero
# weight where unrouted (dense_all), or capacity-based dispatch of each
# expert's first C assignments (dropping; the rest pass the residual only)
# ---------------------------------------------------------------------------
def init_moe(gen, d_model, d_ff, num_experts, dtype, device):
    """The router is float32 whatever the model's dtype, as in the
    reference."""
    E = num_experts
    return {"router": dense_init(gen, (d_model, E), torch.float32, device),
            "w_gate": dense_init(gen, (E, d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (E, d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (E, d_ff, d_model), dtype, device)}


def router_probs(p, x, k: int):
    """Top-k routing: (gates (..., k) in x's dtype, idx (..., k), the
    Switch load-balancing loss E * sum_e f_e * p_e as a float32 scalar).
    Ties go to the lower expert, as ``jax.lax.top_k`` orders them (a
    stable descending sort; ``torch.topk`` breaks ties otherwise)."""
    gates, idx, me, ce = route(p, x, k)
    return gates, idx, me.shape[0] * torch.sum(me * ce)


def route(p, x, k: int):
    """``router_probs`` before the loss: (gates, idx, p_e, f_e), the last
    two (E,) float32 means over the tokens of the router's probabilities
    and of the assignments."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[..., :k], order.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(idx, E).sum(-2).reshape(-1, E).float().mean(0)
    return gates.to(x.dtype), idx, me, ce


def apply_moe_dense_all(p, x, k: int):
    """Every expert on every token, accumulated over the experts in order
    in x's dtype with each token's gate (zero where not routed); the
    expert sum is a ``moe.experts`` span."""
    gates, idx, aux = router_probs(p, x, k)
    with trace.span(MOE_SPAN, stream=x.is_cuda):
        out = expert_sum(p, x, combine_weights(gates, idx, p))
    return out, aux


def combine_weights(gates, idx, p):
    """Each token's gate per expert, (..., E), zero where not routed."""
    E = p["router"].shape[-1]
    return (F.one_hot(idx, E).to(gates.dtype) * gates[..., None]).sum(-2)


def expert_sum(p, x, comb):
    """sum_e comb[..., e] * expert_e(x) over the experts of ``p`` (and
    ``comb``'s matching columns), accumulated in order in x's dtype."""
    acc = torch.zeros_like(x)
    for e in range(p["w_gate"].shape[0]):
        h = (F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
        acc = acc + h * comb[..., e, None]
    return acc


def _dispatch(p, xf, k: int, C: int):
    """One token group's capacity dispatch (the reference's sort-based
    route): assignments sorted by expert (stably, so each expert's come
    in token order), each expert's first C of them. Returns (tok_slot
    (E, C), gate_slot (E, C) in xf's dtype, valid (E, C), aux)."""
    n, E = xf.shape[0], p["router"].shape[-1]
    gates, idx, aux = router_probs(p, xf, k)
    dev = xf.device
    eid = idx.reshape(n * k)
    tok = torch.arange(n * k, device=dev) // k
    order = torch.sort(eid, stable=True).indices
    eid_s, tok_s = eid[order], tok[order]
    gate_s = gates.reshape(n * k)[order]
    starts = torch.searchsorted(eid_s, torch.arange(E, device=dev))
    ends = torch.cat([starts[1:], starts.new_full((1,), n * k)])
    gidx = starts[:, None] + torch.arange(C, device=dev)[None]
    valid = gidx < ends[:, None]
    gidx = gidx.clamp(0, n * k - 1)
    gate_slot = torch.where(valid, gate_s[gidx],
                            torch.zeros_like(gate_s[gidx])).to(xf.dtype)
    return tok_s[gidx], gate_slot, valid, aux


def _capacity(x, k: int, E: int, capacity_factor: float, groups: int):
    """(groups, tokens per group n, capacity C): ``groups`` applies only
    where it divides the token count."""
    N = x.shape[0] * x.shape[1]
    G = groups if (groups and N % groups == 0) else 1
    n = N // G
    return G, n, max(int(capacity_factor * n * k / E), 1)


def apply_moe_dropping(p, x, k: int, capacity_factor: float = 1.25,
                       groups: int = 1):
    """Capacity-based dispatch: each group's assignments go to an (E, C, D)
    buffer, batched expert products run on it, and the gated results are
    added back to their tokens (``index_add_``); assignments past an
    expert's capacity C are dropped."""
    B, S, D = x.shape
    E = p["w_gate"].shape[0]
    G, n, C = _capacity(x, k, E, capacity_factor, groups)
    out, auxes = dropping_groups(p, x.reshape(G, n, D), k, C)
    return out.reshape(B, S, D), auxes.mean()


def dropping_groups(p, xg, k: int, C: int, e0: int = 0):
    """``apply_moe_dropping`` on token groups xg (G, n, D) at capacity C,
    run by the experts of ``p``, which are experts [e0, e0 + E_p) of the
    router's E: (their gated outputs (G, n, D), each group's loss (G,))."""
    G, n, D = xg.shape
    Ep = p["w_gate"].shape[0]
    routes = [_dispatch(p, xg[g], k, C) for g in range(G)]
    buf = torch.stack([xg[g][r[0][e0:e0 + Ep]]
                       * r[2][e0:e0 + Ep][..., None].to(xg.dtype)
                       for g, r in enumerate(routes)])      # (G, Ep, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    yb = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out = torch.stack([
        torch.zeros((n, D), dtype=xg.dtype, device=xg.device).index_add_(
            0, tok_slot[e0:e0 + Ep].reshape(-1),
            (yb[g] * gate_slot[e0:e0 + Ep][..., None]).reshape(Ep * C, D))
        for g, (tok_slot, gate_slot, _, _) in enumerate(routes)])
    return out, torch.stack([r[3] for r in routes])


def moe_dropped(p, x, cfg) -> int:
    """Assignments that ``dropping`` drops on ``x`` under ``cfg``'s
    capacity factor and groups (past their expert's capacity)."""
    k, E = cfg.num_experts_per_tok, p["w_gate"].shape[0]
    G, n, C = _capacity(x, k, E, cfg.moe_capacity_factor, cfg.moe_groups)
    xg = x.reshape(G, n, x.shape[-1])
    kept = sum(int(_dispatch(p, xg[g], k, C)[2].sum()) for g in range(G))
    return G * n * k - kept


def moe_on_kernel(p, x: torch.Tensor, cfg) -> bool:
    """Does a ``dense_all`` MoE call take the grouped path (K5,
    ``kernels/moe_grouped.py``) in place of the loop over experts? Read
    from the inputs alone: a plain (not DTensor) bf16 / fp16 CUDA tensor,
    and no autograd through x, the router or the experts (the kernel has
    no backward and reads the weights as raw pointers). The CPU, float32
    and a mesh keep the loop."""
    return (cfg.moe_impl == "dense_all" and not isinstance(x, DTensor)
            and x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, p["router"], p["w_gate"],
                                          p["w_up"], p["w_down"]))))


def apply_moe_grouped(p, x, k: int):
    """``apply_moe_dense_all``'s function over the routed rows alone: the
    same routing, then every (token, expert) assignment once through the
    grouped expert kernel, gated and summed over each token's k experts
    (``kernels.moe_grouped.grouped_experts``)."""
    gates, idx, aux = router_probs(p, x, k)
    B, S, D = x.shape
    with trace.span(MOE_SPAN, stream=x.is_cuda):
        out = grouped_experts(x.reshape(B * S, D), p["w_gate"], p["w_up"],
                              p["w_down"], gates.reshape(B * S, k),
                              idx.reshape(B * S, k))
    return out.reshape(B, S, D), aux


def apply_moe(p, x, cfg):
    """The config's MoE. While the recorder is on, each call counts its
    routed assignments under ``moe.assignments`` and a ``dense_all`` call
    its path under ``moe.grouped`` or ``moe.loop``."""
    k = cfg.num_experts_per_tok
    trace.count(MOE_ASSIGNMENTS, x.shape[0] * x.shape[1] * k)
    if cfg.moe_impl == "dropping":
        return apply_moe_dropping(p, x, k, cfg.moe_capacity_factor,
                                  groups=cfg.moe_groups)
    if moe_on_kernel(p, x, cfg):
        trace.count(MOE_GROUPED)
        return apply_moe_grouped(p, x, k)
    trace.count(MOE_LOOP)
    return apply_moe_dense_all(p, x, k)
