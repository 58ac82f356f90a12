"""SSM mixers of the port: Mamba2 (Zamba2's backbone) and RWKV6 "Finch".

Both are time recurrences with an explicit carried state, so one function
serves a whole sequence (train, prefill: the final state comes back) and
one decode step. The state is the SSM analogue of the KV cache, and the
state-sharing protocol ships it for the selected layers.

State layouts (one dict per layer; the protocol stacks a leading L_ssm
axis):
  mamba: {"conv": (B, K-1, conv_dim), "ssm": (B, nh, hd, ds)}
  rwkv:  {"cm_x": (B, D), "tm_x": (B, D), "wkv": (B, H, hd, hd)}

States are float32 whatever the model dtype, as in the reference. The
RWKV6 time mix runs its WKV recurrence through
``repro_torch.kernels.rwkv_scan.wkv6``: the CUDA kernel on the card, the
plain scan on the CPU and, shard by shard, on DTensors (a mesh). The
Mamba2 scan is a plain loop over time (the reference has no kernel for
it), with everything that does not depend on the state computed before
the loop.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import local_wkv
from repro_torch.kernels.rwkv_scan import wkv6, wkv6_reference
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    ds = cfg.ssm_state
    conv_dim = d_inner + 2 * ds  # x, B, C go through the depthwise conv
    return d_inner, nh, cfg.ssm_head_dim, ds, conv_dim


def init_mamba(gen, cfg, dtype, device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    d_inner, nh, hd, ds, conv_dim = mamba_dims(cfg)
    f32 = torch.float32
    return {
        # order: [z (d_inner) | xBC (conv_dim) | dt (nh)]
        "w_in": dense_init(gen, (d, d_inner + conv_dim + nh), dtype, device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), dtype, device,
                             scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((nh,), dtype=f32, device=device),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=device),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_inner, d), dtype, device),
    }


def init_mamba_state(cfg, batch: int, *, device,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d_inner, nh, hd, ds, conv_dim = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, hd, ds), dtype=dtype, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``, the reference's softplus
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_rmsnorm(y, z, w, eps: float = 1e-5):
    y = y * F.silu(z)
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * (1.0 + w.float())).to(y.dtype)


def apply_mamba(p, cfg, x, state, *, mode: str = "cached"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D); returns (out, new_state). ``mode`` is accepted for the
    reference's signature; train and cached run the same recurrence."""
    B, S, D = x.shape
    d_inner, nh, hd, ds, conv_dim = mamba_dims(cfg)
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:].float()

    # causal depthwise conv, kernel K: y_t = b + sum_i w[i] x_{t-K+1+i},
    # summed in the reference's order
    K = cfg.ssm_conv
    hist = torch.cat([state["conv"].to(xBC.dtype), xBC], dim=1)
    new_conv = hist[:, -(K - 1):, :] if K > 1 else state["conv"]
    conv = sum(p["conv_w"][i] * hist[:, i:i + S, :] for i in range(K))
    xBC = F.silu(conv + p["conv_b"])

    xs = xBC[..., :d_inner].reshape(B, S, nh, hd).float()
    Bt = xBC[..., d_inner:d_inner + ds].float()                 # (B, S, ds)
    Ct = xBC[..., d_inner + ds:].float()                        # (B, S, ds)
    dt = _softplus(dt_raw + p["dt_bias"])                       # (B, S, nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                  # (B, S, nh)
    dtx = dt[..., None] * xs                                    # (B,S,nh,hd)

    s = state["ssm"].float()
    ys = []
    for t in range(S):
        s = s * a[:, t, :, None, None] \
            + dtx[:, t, :, :, None] * Bt[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, Ct[:, t]))
    y = torch.stack(ys, dim=1)                                  # (B,S,nh,hd)
    y = y + p["D"][:, None] * xs
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm"])
    out = y @ p["w_out"]
    return out, {"conv": new_conv.to(state["conv"].dtype),
                 "ssm": s.to(state["ssm"].dtype)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay through a low-rank MLP on the shifted
# mix
# ---------------------------------------------------------------------------
def rwkv_dims(cfg):
    hd = cfg.ssm_head_dim
    return cfg.d_model // hd, hd


def init_rwkv(gen, cfg, dtype, device, lora_rank: int = 32
              ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    H, hd = rwkv_dims(cfg)
    f32 = torch.float32

    def full(shape, value, dt=f32):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        # time mix
        "mu": full((5, d), 0.5),                 # r, k, v, g, w mixes
        "w0": full((d,), -4.0),                  # decay base
        "w_lora_a": dense_init(gen, (d, lora_rank), f32, device, scale=0.01),
        "w_lora_b": dense_init(gen, (lora_rank, d), f32, device, scale=0.01),
        "wr": dense_init(gen, (d, d), dtype, device),
        "wk": dense_init(gen, (d, d), dtype, device),
        "wv": dense_init(gen, (d, d), dtype, device),
        "wg": dense_init(gen, (d, d), dtype, device),
        "u": full((H, hd), 0.0),                 # per-head bonus
        "ln_x": full((d,), 1.0),
        "wo": dense_init(gen, (d, d), dtype, device),
        # channel mix
        "cm_mu": full((2, d), 0.5),              # k, r
        "cm_wk": dense_init(gen, (d, cfg.d_ff), dtype, device),
        "cm_wv": dense_init(gen, (cfg.d_ff, d), dtype, device),
        "cm_wr": dense_init(gen, (d, d), dtype, device),
    }


def init_rwkv_state(cfg, batch: int, *, device,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    H, hd = rwkv_dims(cfg)
    d = cfg.d_model
    return {
        "cm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "tm_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
    }


def _shift(x, last):
    """(B, S, D), (B, D) -> the previous-token sequence, in x's dtype."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv_time_mix(p, cfg, x, state):
    """Returns (out, new wkv state, new shift row). The WKV recurrence is
    ``wkv6``: K4 on a CUDA tensor, its plain scan on a CPU tensor."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    xp = _shift(x, state["tm_x"])
    mu = p["mu"].to(x.dtype)
    xr = x + (xp - x) * mu[0]
    xk = x + (xp - x) * mu[1]
    xv = x + (xp - x) * mu[2]
    xg = x + (xp - x) * mu[3]
    xw = x + (xp - x) * mu[4]
    r = (xr @ p["wr"]).reshape(B, S, H, hd).float()
    k = (xk @ p["wk"]).reshape(B, S, H, hd).float()
    v = (xv @ p["wv"]).reshape(B, S, H, hd).float()
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (the Finch signature)
    dd = torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + dd)).reshape(B, S, H, hd)  # (0, 1)
    if isinstance(r, DTensor):
        # on a mesh the plain scan, shard by shard, as the reference's
        # sharded path runs its XLA scan
        y, new_wkv = local_wkv(wkv6_reference, r, k, v, w, p["u"],
                               state["wkv"].float())
    else:
        y, new_wkv = wkv6(r, k, v, w, p["u"], state["wkv"].float())
    # per-head group norm (population variance, as jnp.var)
    yh = y.reshape(B, S, H, hd)
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True, correction=0) + 1e-5)
    y = (yh.reshape(B, S, D) * p["ln_x"]).to(x.dtype) * g
    out = y @ p["wo"]
    return (out, new_wkv.to(state["wkv"].dtype),
            x[:, -1, :].to(state["tm_x"].dtype))


def rwkv_channel_mix(p, cfg, x, state):
    """Returns (out, new shift row)."""
    xp = _shift(x, state["cm_x"])
    mu = p["cm_mu"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    kk = torch.square(torch.relu(xk @ p["cm_wk"]))
    out = torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])
    return out, x[:, -1, :].to(state["cm_x"].dtype)
