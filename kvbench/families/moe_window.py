"""Sparse experts in every layer and sliding-window attention beside
YaRN full attention (``mellum2-12b``): RMSNorm, grouped-query attention
whose layers repeat ``local_global_ratio`` windowed layers (plain RoPE at
``rope_theta``, keys less than ``local_window`` positions behind the
query) then one full layer (YaRN's RoPE), and in place of the MLP a
softmax router over ``num_experts`` with the top ``num_experts_per_tok``
renormalised, each routed expert a swiglu of width ``d_ff``. Written
from the published description, importing nothing of the program.

Leaves: the dense family's attention, norms, embedding and head, and per
layer ``moe`` = {router (d, E) float32, w_gate and w_up (E, d, F), w_down
(E, F, d)}. The router is drawn at ``ROUTER_SCALE`` / sqrt(d) (see
``leaves``).

Counts (``kvbench.counts``' rules, with this family's layers): a token's
linear operations take the router and its k experts, not all E; a query
row of a windowed layer attends at most ``local_window`` positions, the
prefix's among them; K1 runs the full layers alone. ``moe_calls`` lists
the expert layer's calls a wave needs, for ``moe_roofline_pct``.

The check adds two numbers (``EXTRA_NUMBERS``) over every judged token's
gap: ``gap_p99``, its 99th percentile, and ``gap_mean``, its mean. bf16
rounding flips the router's top k on a share of the rows, and a flip
can move a served token's logit far below float32's best, so ``gap_max``
and ``gap_p99`` guard against gross faults only; ``gap_mean`` holds the
served tokens as a whole, which a flip here and there moves little and
a lower precision throughout moves by several times.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from kvbench import counts, reference, weights

ROUTER_SCALE = 2.0
EXTRA_NUMBERS = ("gap_p99", "gap_mean")
BYTES_BF16 = counts.BYTES_BF16


# ---- the layer pattern ------------------------------------------------------
def windows(model: Dict) -> List:
    """Each layer's window: ``local_global_ratio`` windowed layers, then
    one full (None), repeated."""
    n, w = model["local_global_ratio"], model["local_window"]
    return [w if i % (n + 1) < n else None
            for i in range(model["num_layers"])]


# ---- weights ----------------------------------------------------------------
def leaves(model: Dict, mlp: str):
    """The dense leaves without the MLP, and each layer's router (float32,
    (d, E), drawn at ROUTER_SCALE / sqrt(d): router logits of standard
    deviation about 2 over the normed hidden state, so the top 8 of 64
    hold about 0.7 of the probability, as a trained router's do, and not
    the 0.35 of a 1 / sqrt(d) draw, whose near-equal boundary gates make
    every bf16 near-tie move the output) and experts."""
    d, dff, E = model["d_model"], model["d_ff"], model["num_experts"]
    out = [leaf for leaf in weights.leaves(model, mlp)
           if "mlp" not in leaf[0]]
    for i in range(model["num_layers"]):
        out += [(("layers", i, "moe", "router"), (d, E),
                 ROUTER_SCALE / math.sqrt(d), torch.float32),
                (("layers", i, "moe", "w_gate"), (E, d, dff),
                 1.0 / math.sqrt(d)),
                (("layers", i, "moe", "w_up"), (E, d, dff),
                 1.0 / math.sqrt(d)),
                (("layers", i, "moe", "w_down"), (E, dff, d),
                 1.0 / math.sqrt(dff))]
    return out


# ---- the reference ----------------------------------------------------------
def plain_freqs(dh: int, theta: float) -> torch.Tensor:
    """RoPE's inverse frequencies theta^(-2i/dh), (dh / 2,) float64."""
    return theta ** (-torch.arange(dh // 2, dtype=torch.float64) * 2 / dh)


def yarn_freqs(dh: int, theta: float, yarn: Sequence[float]) -> torch.Tensor:
    """YaRN's inverse frequencies (dh / 2,) float64: plain theta^(-2i/dh),
    divided by ``factor`` past the ramp, kept before it, blended linearly
    over dimensions [low, high] = floor / ceil of dh ln(L0 / (2 pi beta))
    / (2 ln theta) at beta_fast and beta_slow, clamped to [0, dh/2 - 1]."""
    factor, orig, beta_fast, beta_slow = (float(v) for v in yarn[:4])
    half = dh // 2
    plain = plain_freqs(dh, theta)

    def corr(beta):
        return dh * math.log(orig / (beta * 2 * math.pi)) / (
            2 * math.log(theta))
    low = min(max(math.floor(corr(beta_fast)), 0), half - 1)
    high = min(max(math.ceil(corr(beta_slow)), 0), half - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    return plain / factor * ramp + plain * (1 - ramp)


def rotate(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
           scale: float) -> torch.Tensor:
    """Half-split rotation of x (S, H, D) at positions (S,) by inverse
    frequencies ``inv`` (D/2,), cos and sin multiplied by ``scale``."""
    half = x.shape[-1] // 2
    ang = pos.double()[:, None, None] * inv.to(x.device)
    cos = (torch.cos(ang) * scale).float()
    sin = (torch.sin(ang) * scale).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _fp8_per_expert(t: torch.Tensor) -> torch.Tensor:
    """(E, a, b) rounded through float8 with one scale an expert's
    matrix."""
    return torch.stack([reference._fp8(m, None) for m in t])


class Reference(reference.Reference):
    """The float32 reference of this family over one parameter set; the
    dense reference's norm, projections, float8 rounding and embedding,
    with its own layers. ``mode="fp8"`` (the control) computes every bf16
    matrix product from float8 weights (one scale a matrix, each expert's
    its own) and float8 activations; the router, float32 in the
    configuration, stays float32."""

    def __init__(self, model: Dict, mlp: str, params: Dict,
                 mode: str = "fp32"):
        super().__init__(model, mlp, params, mode)
        self.win = windows(model)
        theta = model["rope_theta"]
        self.k = model["num_experts_per_tok"]
        plain = plain_freqs(self.dh, theta)
        yarn = model.get("yarn")
        self.rot = {True: (plain, 1.0),
                    False: ((yarn_freqs(self.dh, theta, yarn),
                             float(yarn[4])) if yarn else (plain, 1.0))}

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        lp = self.p["layers"][i]
        out = {k: lp[k].float() for k in ("ln1", "ln2")}
        out.update({k: self._w(v) for k, v in lp["attn"].items()})
        moe = lp["moe"]
        out["router"] = moe["router"].float()
        for k in ("w_gate", "w_up", "w_down"):
            t = moe[k].float()
            out[k] = _fp8_per_expert(t) if self.mode == "fp8" else t
        out["window"] = self.win[i]
        return out

    def qkv(self, w, x: torch.Tensor, pos: torch.Tensor):
        S = x.shape[0]
        q = self.mm(x, w["wq"]).view(S, self.hq, self.dh)
        k = self.mm(x, w["wk"]).view(S, self.hkv, self.dh)
        v = self.mm(x, w["wv"]).view(S, self.hkv, self.dh)
        inv, scale = self.rot[w["window"] is not None]
        return rotate(q, pos, inv, scale), rotate(k, pos, inv, scale), v

    def ffn(self, w, x: torch.Tensor) -> torch.Tensor:
        """Softmax over the experts, the top k renormalised, each routed
        expert's swiglu weighted by its gate and summed."""
        probs = torch.softmax(x @ w["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = top.values[:, :self.k]
        gates = gates / gates.sum(-1, keepdim=True)
        idx = top.indices[:, :self.k]
        out = torch.zeros_like(x)
        for e in range(w["router"].shape[1]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            h = F.silu(self.mm(xe, w["w_gate"][e])) * self.mm(
                xe, w["w_up"][e])
            out.index_add_(0, rows, self.mm(h, w["w_down"][e])
                           * gates[rows, slot, None])
        return out

    def attend_at(self, q, k, v, q_pos, k_pos, n_prefix: int, window,
                  mass: bool = False):
        """q (Sq, Hq, D) at positions q_pos over k, v at k_pos: causal, and
        with a window only keys fewer than ``window`` positions behind.
        Returns (out (Sq, Hq*D), the mean softmax mass on the first
        ``n_prefix`` keys or None)."""
        Sq, G = q.shape[0], self.hq // self.hkv
        qg = q.view(Sq, self.hkv, G, self.dh)
        outs, tot = [], 0.0
        for a in range(0, Sq, reference.Q_BLOCK):
            qp = q_pos[a:a + reference.Q_BLOCK, None]
            s = torch.einsum("qhgd,khd->hgqk", qg[a:a + reference.Q_BLOCK],
                             k) / math.sqrt(self.dh)
            allow = k_pos[None, :] <= qp
            if window is not None:
                allow = allow & (qp - k_pos[None, :] < window)
            p = torch.softmax(s.masked_fill(~allow, float("-inf")), dim=-1)
            if mass:
                tot = tot + p[..., :n_prefix].sum()
            outs.append(torch.einsum("hgqk,khd->qhgd", p, v))
        out = torch.cat(outs).reshape(Sq, self.hq * self.dh)
        return out, (tot / (self.hq * Sq) if mass else None)

    def _block(self, w, x, pos, prefix=None, mass=False):
        """One layer over x at positions ``pos``, attending ``prefix``
        (k, v at positions 0 .. n - 1) first where given. Returns (x out,
        k, v of x, mass or None)."""
        q, k, v = self.qkv(w, self.norm(x, w["ln1"]), pos)
        kk, vv, kp, n = k, v, pos, 0
        if prefix is not None:
            pk, pv = prefix
            n = pk.shape[0]
            kk, vv = torch.cat([pk, k]), torch.cat([pv, v])
            kp = torch.cat([torch.arange(n, device=pos.device), pos])
        out, m = self.attend_at(q, kk, vv, pos, kp, n, w["window"], mass)
        x = x + self.mm(out, w["wo"])
        return x + self.ffn(w, self.norm(x, w["ln2"])), k, v, m

    # -- the round ------------------------------------------------------------
    def sender_kv(self, contexts, layers):
        want = set(layers)
        last = max(want)
        hs = [self.embed(c) for c in contexts]
        kv = [dict() for _ in contexts]
        for i in range(last + 1):
            w = self.layer(i)
            for r, x in enumerate(hs):
                pos = torch.arange(x.shape[0], device=self.dev)
                if i == last:
                    _, k, v = self.qkv(w, self.norm(x, w["ln1"]), pos)
                else:
                    hs[r], k, v, _ = self._block(w, x, pos)
                if i in want:
                    kv[r][i] = (k, v)
            del w
        return kv

    def receiver(self, tokens, n_prefix, prefixes, rows, mass=False):
        L = self.m["num_layers"]
        hs = [self.embed(t) for t in tokens]
        masses = []
        for i in range(L):
            w = self.layer(i)
            for r, x in enumerate(hs):
                pos = n_prefix[r] + torch.arange(x.shape[0], device=self.dev)
                hs[r], _, _, m = self._block(w, x, pos, prefixes[r].get(i),
                                             mass and r == 0)
                if m is not None:
                    masses.append(m)
            del w
        if mass:
            return torch.stack(masses).cpu()
        head = self._w(self.p["lm_head"])
        fn = self.p["final_norm"].float()
        return [self.mm(self.norm(x[-n:], fn), head)
                for x, n in zip(hs, rows)]


# ---- counts -----------------------------------------------------------------
def linear_per_token(model: Dict) -> int:
    """One token through one layer's projections, router and its k
    experts."""
    d, dff = model["d_model"], model["d_ff"]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    return 2 * (d * (hq * dh + 2 * hkv * dh) + hq * dh * d
                + d * model["num_experts"]
                + model["num_experts_per_tok"] * 3 * d * dff)


def attended(p, sc: int, window, prefix: bool):
    """Positions a query at absolute position p (an int or an array)
    attends (causal; with a window the last ``window`` positions up to
    p): its own from sc on, and the prefix [0, sc) where the layer holds
    it."""
    p = np.asarray(p, dtype=np.int64)
    lo = np.zeros_like(p) if window is None else np.maximum(
        0, p - window + 1)
    own = p + 1 - np.maximum(lo, sc)
    return own + (np.maximum(0, sc - lo) if prefix else 0)


def _attn(model: Dict, positions, sc: int, window, prefix: bool) -> int:
    return counts.attn_ops(model, int(attended(positions, sc, window,
                                               prefix).sum()))


def request_flops(model: Dict, sc: int, sq: int, n: int,
                  sel: Sequence[int]) -> Dict[str, int]:
    """``kvbench.counts.request_flops`` with this family's layers: the
    sender's layers 0 .. dmax-1 over [BOS | context] (windowed where the
    layer is) and layer dmax's K and V; the receiver's every layer over
    the query and the n - 1 decode steps, a selected layer attending the
    prefix within its window. Layers of one window and selection attend
    alike, so each such group is counted once."""
    L, d, V = model["num_layers"], model["d_model"], model["vocab_size"]
    win = windows(model)
    lin = linear_per_token(model)
    kv_proj = 2 * d * 2 * model["num_kv_heads"] * model["head_dim"]
    sel = set(sel)
    dmax = max(sel) if sel else -1
    sender = 0
    if sel:
        for w in set(win[:dmax]):
            sender += win[:dmax].count(w) * _attn(model, np.arange(sc), 0,
                                                  w, False)
        sender += dmax * sc * lin + sc * kv_proj
    groups = {}
    for i in range(L):
        key = (win[i], i in sel)
        groups[key] = groups.get(key, 0) + 1
    logits = 2 * d * V
    q_pos = np.arange(sc, sc + sq)
    d_pos = sc + sq + np.arange(1, n) - 1
    receiver = L * sq * lin + logits
    decode = (n - 1) * (L * lin + logits) if n > 1 else 0
    for (w, pre), c in groups.items():
        receiver += c * _attn(model, q_pos, sc, w, pre)
        if n > 1:
            decode += c * _attn(model, d_pos, sc, w, pre)
    return {"sender": sender, "receiver": receiver, "decode": decode}


def window_flops(model: Dict, mlp: str, items: Iterable,
                 sel: Sequence[int]) -> int:
    return sum(sum(request_flops(model, len(it.context) + 1, len(it.query),
                                 it.answer, sel).values()) for it in items)


def k1_bytes(model: Dict, items: Iterable, sel: Sequence[int],
             itemsize: int = BYTES_BF16) -> int:
    """K1's needed bytes: ``kvbench.counts.k1_bytes`` over the full
    layers alone (the windowed ones decode on the plain core)."""
    full = [i for i, w in enumerate(windows(model)) if w is None]
    hq, hkv, dh = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    m = len(set(sel) & set(full))
    kv_row = 2 * hkv * dh * itemsize
    qo = 2 * hq * dh * itemsize
    total = 0
    for it in items:
        sc, sq, n = len(it.context) + 1, len(it.query), it.answer
        for j in range(1, n):
            total += len(full) * ((sq + j) * kv_row + qo) + m * sc * kv_row
    return total


def moe_calls(model: Dict, items: Sequence, sel: Sequence[int]) -> List[int]:
    """The token count of each expert-layer call one closed wave of
    ``items`` needs: the sender's layers 0 .. dmax-1 over each [BOS |
    context], the receiver's layers over each query, and a call a layer
    a decode step over its live rows (every request admitted before the
    first step, a wave no wider than the slot table; step j holds the
    requests that ask for more than j tokens)."""
    L = model["num_layers"]
    dmax = max(sel) if len(sel) else 0
    calls = []
    for it in items:
        calls += [len(it.context) + 1] * dmax + [len(it.query)] * L
    for j in range(1, max((it.answer for it in items), default=0)):
        live = sum(it.answer > j for it in items)
        calls += [live] * L
    return calls


def moe_flops(model: Dict, n: int) -> int:
    """Operations of one expert-layer call over n tokens: k experts'
    three projections a token."""
    return 2 * 3 * n * model["num_experts_per_tok"] * model["d_model"] \
        * model["d_ff"]


def moe_bytes(model: Dict, n: int, itemsize: int = BYTES_BF16) -> float:
    """Bytes one expert-layer call over n tokens needs: the experts it
    touches, read once (their expected count under routing spread evenly,
    E (1 - (1 - k / E)^n): which experts a call touches is known on the
    card only), and each token's input and output row."""
    E, k = model["num_experts"], model["num_experts_per_tok"]
    d, dff = model["d_model"], model["d_ff"]
    touched = E * (1.0 - (1.0 - k / E) ** n)
    return touched * 3 * d * dff * itemsize + 2 * n * d * itemsize


# ---- the check's own numbers ------------------------------------------------
def extra_numbers(view: Dict) -> Dict:
    gaps = np.concatenate([np.asarray(g, dtype=np.float64)
                           for g in view["token_gaps"]])
    return {"gap_p99": float(np.percentile(gaps, 99)),
            "gap_mean": float(gaps.mean())}
