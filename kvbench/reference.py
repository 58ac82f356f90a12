"""The plain reference of one KVComm round, in float32 PyTorch.

It imports nothing of the program. It reads the weights the benchmark
made (the same tensors the program serves) and upcasts them one layer at
a time, so two bf16 parameter sets and the float32 copy of one layer fit
on the card. It follows the registered decoder: RMSNorm scaled by
``1 + w``, half-split RoPE, grouped-query causal attention, the gelu
(tanh) or swiglu MLP, untied output head. KVComm's round (paper §3.1):

  sender    — [BOS | context] at positions 0 .. Sc-1; the K (after RoPE)
              and V of the selected layers are the prefix.
  wire      — int8: one symmetric scale per layer and part (absmax over
              positions, heads and head dim, over 127), rounded and
              clipped, then scaled back; in memory: untouched.
  receiver  — the query, then the served tokens, at positions Sc, Sc+1,
              ...; a selected layer attends [prefix | causal self], the
              others their causal self only.
  selection — Eq. (1): the query prefilled with every layer shared; each
              layer's softmax mass on the prefix, averaged over heads and
              query rows, min-max normalised.

``mode="fp8"`` is the control: every projection, MLP and output head
computed from float8 (e4m3) weights (one scale per matrix) and float8
activations (one scale per row), the precision step below the
configuration's bf16. Attention and norms stay float32.

Every method works on a list of requests, layer by layer: a layer's
weights are upcast once for all of them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
Q_BLOCK = 1024             # query rows per attention block


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """x rounded through float8 e4m3 with an absmax scale over ``dim``
    (None: the whole tensor)."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = amax.clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(FP8).to(torch.float32) * scale


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """One layer's K or V through the int8 wire: a symmetric scale over
    the whole array."""
    scale = x.abs().amax().clamp_min(1e-8) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (S, H, D) at positions (S,)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The reference over one parameter set (port layout, any dtype)."""

    def __init__(self, model: Dict, mlp: str, params: Dict,
                 mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"mode is fp32 or fp8, not {mode!r}")
        self.m, self.mlp, self.p, self.mode = model, mlp, params, mode
        self.hq, self.hkv = model["num_heads"], model["num_kv_heads"]
        self.dh = model["head_dim"]
        self.eps = model.get("norm_eps", 1e-5)
        self.dev = params["embed"].device

    # -- pieces ---------------------------------------------------------------
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _fp8(t, None) if self.mode == "fp8" else t

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        lp = self.p["layers"][i]
        out = {k: lp[k].float() for k in ("ln1", "ln2")}
        out.update({k: self._w(v) for k, v in lp["attn"].items()})
        out.update({k: self._w(v) for k, v in lp["mlp"].items()})
        return out

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            x = _fp8(x, -1)
        return x @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                            + self.eps)
        return x * (1.0 + w)

    def ffn(self, w, x: torch.Tensor) -> torch.Tensor:
        if self.mlp == "swiglu":
            h = F.silu(self.mm(x, w["w_gate"])) * self.mm(x, w["w_up"])
        else:
            h = F.gelu(self.mm(x, w["w_up"]), approximate="tanh")
        return self.mm(h, w["w_down"])

    def qkv(self, w, x: torch.Tensor, pos: torch.Tensor):
        S = x.shape[0]
        q = self.mm(x, w["wq"]).view(S, self.hq, self.dh)
        k = self.mm(x, w["wk"]).view(S, self.hkv, self.dh)
        v = self.mm(x, w["wv"]).view(S, self.hkv, self.dh)
        theta = self.m["rope_theta"]
        return rope(q, pos, theta), rope(k, pos, theta), v

    def attend(self, q, k, v, n_prefix: int, mass: bool = False):
        """q (Sq, Hq, D) over k, v (n_prefix + Sq, Hkv, D): the prefix
        whole, the own positions causally. Returns (out (Sq, Hq*D), the
        mean softmax mass on the prefix or None)."""
        Sq, G = q.shape[0], self.hq // self.hkv
        qg = q.view(Sq, self.hkv, G, self.dh)
        col = torch.arange(k.shape[0], device=q.device)
        outs, tot = [], 0.0
        for a in range(0, Sq, Q_BLOCK):
            rows = torch.arange(a, min(a + Q_BLOCK, Sq), device=q.device)
            s = torch.einsum("qhgd,khd->hgqk", qg[a:a + Q_BLOCK], k)
            s = s / math.sqrt(self.dh)
            allow = col[None, :] <= rows[:, None] + n_prefix
            s = s.masked_fill(~allow, float("-inf"))
            p = torch.softmax(s, dim=-1)
            if mass:
                tot = tot + p[..., :n_prefix].sum()
            outs.append(torch.einsum("hgqk,khd->qhgd", p, v))
        out = torch.cat(outs).reshape(Sq, self.hq * self.dh)
        return out, (tot / (self.hq * Sq) if mass else None)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed"][tokens.to(self.dev)].float()

    # -- the round ------------------------------------------------------------
    def sender_kv(self, contexts: Sequence[torch.Tensor],
                  layers: Sequence[int]) -> List[Dict[int, tuple]]:
        """K (after RoPE) and V of ``layers`` over each [BOS | context];
        layers past the deepest requested one are not run."""
        want = set(layers)
        last = max(want)
        hs = [self.embed(c) for c in contexts]
        kv: List[Dict[int, tuple]] = [dict() for _ in contexts]
        for i in range(last + 1):
            w = self.layer(i)
            for r, x in enumerate(hs):
                pos = torch.arange(x.shape[0], device=self.dev)
                q, k, v = self.qkv(w, self.norm(x, w["ln1"]), pos)
                if i in want:
                    kv[r][i] = (k, v)
                if i == last:
                    continue
                out, _ = self.attend(q, k, v, 0)
                x = x + self.mm(out, w["wo"])
                hs[r] = x + self.ffn(w, self.norm(x, w["ln2"]))
            del w
        return kv

    def receiver(self, tokens: Sequence[torch.Tensor], n_prefix: Sequence[int],
                 prefixes: Sequence[Dict[int, tuple]], rows: Sequence[int],
                 mass: bool = False):
        """Each token row at positions n_prefix + i; layer i attends the
        request's prefix where ``prefixes[r]`` holds it. Returns the float32
        logits of the last ``rows[r]`` positions of each row (or, with
        ``mass``, the (L,) raw Eq. (1) masses of the first request)."""
        L = self.m["num_layers"]
        hs = [self.embed(t) for t in tokens]
        masses = []
        for i in range(L):
            w = self.layer(i)
            for r, x in enumerate(hs):
                S = x.shape[0]
                pos = n_prefix[r] + torch.arange(S, device=self.dev)
                q, k, v = self.qkv(w, self.norm(x, w["ln1"]), pos)
                np_ = 0
                if i in prefixes[r]:
                    pk, pv = prefixes[r][i]
                    k, v = torch.cat([pk, k]), torch.cat([pv, v])
                    np_ = pk.shape[0]
                out, m = self.attend(q, k, v, np_, mass=mass and r == 0)
                if m is not None:
                    masses.append(m)
                x = x + self.mm(out, w["wo"])
                hs[r] = x + self.ffn(w, self.norm(x, w["ln2"]))
            del w
        if mass:
            return torch.stack(masses).cpu()
        head = self._w(self.p["lm_head"])
        fn = self.p["final_norm"].float()
        return [self.mm(self.norm(x[-n:], fn), head)
                for x, n in zip(hs, rows)]


def normalize(raw: torch.Tensor) -> torch.Tensor:
    lo, hi = raw.min(), raw.max()
    return (raw - lo) / torch.clamp(hi - lo, min=1e-9)


def with_bos(context: torch.Tensor, bos: int) -> torch.Tensor:
    return torch.cat([torch.tensor([bos], dtype=context.dtype,
                                   device=context.device), context])


def calibration_scores(sender: Reference, receiver: Reference,
                       context: torch.Tensor, query: torch.Tensor,
                       bos: int) -> torch.Tensor:
    """Eq. (1) normalised scores (L,) of one calibration request."""
    ctx = with_bos(context, bos)
    L = sender.m["num_layers"]
    kv = sender.sender_kv([ctx], range(L))[0]
    raw = receiver.receiver([query], [ctx.shape[0]], [kv], [0], mass=True)
    return normalize(raw)


def served_logits(sender: Reference, receiver: Reference,
                  contexts: Sequence[torch.Tensor],
                  queries: Sequence[torch.Tensor],
                  served: Sequence[torch.Tensor], layers: Sequence[int],
                  wire: Optional[str], bos: int) -> List[torch.Tensor]:
    """Logits (n, V) at each served position of each request, teacher
    forced on the served tokens: row i is the distribution the i-th served
    token was drawn from."""
    ctxs = [with_bos(c, bos) for c in contexts]
    kvs = sender.sender_kv(ctxs, layers)
    if wire == "int8":
        kvs = [{i: (int8_roundtrip(k), int8_roundtrip(v))
                for i, (k, v) in kv.items()} for kv in kvs]
    elif wire is not None:
        raise ValueError(f"the reference knows the int8 wire only, not "
                         f"{wire!r}")
    toks = [torch.cat([q.to(s.device), s[:-1]]) for q, s in
            zip(queries, served)]
    return receiver.receiver(toks, [c.shape[0] for c in ctxs], kvs,
                             [s.shape[0] for s in served])


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best, (n,)."""
    tokens = tokens.to(logits.device).long()
    return logits.max(dim=-1).values - logits.gather(
        1, tokens[:, None])[:, 0]
