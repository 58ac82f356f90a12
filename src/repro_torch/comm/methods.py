"""CommMethod registry: one class per method the paper compares (§4.1),
registered in ``METHODS`` so that ``CommSession.run`` dispatches by name:

  baseline   — the receiver answers from the query alone.
  skyline    — the receiver reads [BOS context query] itself (upper bound).
  kvcomm     — the paper: the selected layers' KV cross the transport.
  random / contiguous / prior_only / full_kv — selector ablations (Table 2,
               Fig. 4; full_kv shares every layer, the upper bound on KV).
  nld        — the sender greedy-decodes a message; the receiver reads it.
  cipher     — like nld, but the expected embeddings cross (soft tokens).
  ac_replace / ac_mean / ac_sum — the sender's last-token hidden state
               merged into the receiver's at one layer (Ramesh & Li 2025).
  hetero_kvcomm — kvcomm across a depth-mismatched pair: the sender
               selects over its own depth and the ``req.layer_map`` policy
               places its layers in receiver slots.

A method's ``run`` takes the session, a batch of host numpy arrays and a
``CommRequest``, and returns a ``MethodResult``: host numpy predictions,
the transport record's exact wire bytes and the analytic FLOPs. The
session stamps the latency.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.channel import TransferRecord
from repro_torch.core.types import KVCommConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving import costs


@dataclass
class CommRequest:
    """Per-call knobs shared by the methods (each reads what it needs)."""
    kvcfg: Optional[KVCommConfig] = None
    scores: Optional[torch.Tensor] = None
    ac_layer: Optional[int] = None
    nld_tokens: int = 16
    max_new: int = 1
    calib_key: Optional[str] = None   # selection-cache key (task id)
    layer_map: str = "depth_proportional"   # hetero_kvcomm mapping policy


@dataclass
class MethodResult:
    preds: np.ndarray
    accuracy: float
    wire_bytes: int
    flops: float
    extras: Dict[str, Any] = field(default_factory=dict)
    latency_s: float = 0.0
    transfer: Optional[TransferRecord] = None


def _result(preds, answers, wire_bytes, flops, transfer=None, **extras):
    acc = float(np.mean(preds == np.asarray(answers)))
    return MethodResult(preds=preds, accuracy=acc, wire_bytes=wire_bytes,
                        flops=flops, extras=extras, transfer=transfer)


class CommMethod:
    """Base class: subclasses set ``name`` and implement ``run``."""
    name: str = ""

    def run(self, session, batch: Dict[str, np.ndarray],
            req: CommRequest) -> MethodResult:
        raise NotImplementedError


METHODS: Dict[str, CommMethod] = {}


def register(method: CommMethod) -> CommMethod:
    """Add a method instance to the registry (the last one of a name
    wins)."""
    if not method.name:
        raise ValueError("a method needs a name")
    METHODS[method.name] = method
    return method


def get_method(name: str) -> CommMethod:
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; "
                         f"registered: {sorted(METHODS)}") from None


# ---------------------------------------------------------------------------
# no-communication anchors
# ---------------------------------------------------------------------------
class Baseline(CommMethod):
    name = "baseline"

    def run(self, session, batch, req):
        rx, cfg = session.receiver, session.cfg
        qry = batch["query"]
        out = rx.prefill(rx.with_bos(qry), None, max_new=1)
        return _result(rx.predict_last(out.logits), batch["answer"], 0,
                       costs.flops_baseline(cfg, qry.shape[1], req.max_new))


class Skyline(CommMethod):
    name = "skyline"

    def run(self, session, batch, req):
        rx, cfg = session.receiver, session.cfg
        ctx, qry = batch["context"], batch["query"]
        inp = np.concatenate([rx.with_bos(ctx), qry], axis=1)
        out = rx.prefill(inp, None, max_new=1)
        return _result(
            rx.predict_last(out.logits), batch["answer"], 0,
            costs.flops_skyline(cfg, ctx.shape[1] + 1, qry.shape[1],
                                req.max_new))


# ---------------------------------------------------------------------------
# selective KV sharing (the paper) and the selector ablations
# ---------------------------------------------------------------------------
def _override_selector(kvcfg: KVCommConfig, selector: str) -> KVCommConfig:
    if selector == "full_kv":
        return dataclasses.replace(kvcfg, selector="all", ratio=1.0)
    return dataclasses.replace(kvcfg, selector=selector)


class SelectiveKV(CommMethod):
    """KV sharing through the session's transport; ``selector_override``
    pins the selector for the ablation registrations."""

    def __init__(self, name: str, selector_override: Optional[str] = None):
        self.name = name
        self.selector_override = selector_override

    def run(self, session, batch, req):
        if req.kvcfg is None:
            raise ValueError(f"{self.name} needs a KVCommConfig")
        kvcfg = req.kvcfg
        if self.selector_override is not None:
            kvcfg = _override_selector(kvcfg, self.selector_override)
        cfg, rx = session.cfg, session.receiver
        ctx, qry = batch["context"], batch["query"]
        shared, select = session.share(ctx, kvcfg, scores=req.scores,
                                       key=req.calib_key)
        out = rx.prefill(qry, shared, max_new=1)
        rec = session.transport.last
        M = rec.layers
        return _result(
            rx.predict_last(out.logits), batch["answer"], rec.n_bytes,
            costs.flops_kvcomm(cfg, shared.prefix_len, qry.shape[1],
                               req.max_new, M),
            transfer=rec, select=select.cpu().numpy(), M=M,
            packed=shared.is_packed)


class HeteroSelectiveKV(CommMethod):
    """KV sharing across a depth-mismatched pair: the sender selects over
    its own depth (``req.scores`` are SENDER-side, e.g. from
    ``session.calibrate_side("sender", ...)``), the ``req.layer_map``
    policy places the selected layers in receiver slots, and the transport
    moves exactly the mapped payload. On a same-depth pair with
    ``layer_map="identity"`` it is kvcomm, bit for bit."""
    name = "hetero_kvcomm"

    def run(self, session, batch, req):
        if req.kvcfg is None:
            raise ValueError(f"{self.name} needs a KVCommConfig")
        rx, tx = session.receiver, session.sender
        ctx, qry = batch["context"], batch["query"]
        shared, assignment = session.share_mapped(
            ctx, req.kvcfg, policy=req.layer_map, src_scores=req.scores,
            key=req.calib_key)
        out = rx.prefill(qry, shared, max_new=1)
        rec = session.transport.last
        P = rec.layers           # mapped pairs = receiver-consumed layers
        # the receiver's cost at its own depth plus the sender's prefill of
        # [BOS context] at its own (flops_baseline at Tr = 0)
        fl = (costs.flops_kvcomm_receiver(rx.cfg, shared.prefix_len,
                                          qry.shape[1], req.max_new, P)
              + costs.flops_baseline(tx.cfg, ctx.shape[1] + 1, 0))
        return _result(
            rx.predict_last(out.logits), batch["answer"], rec.n_bytes, fl,
            transfer=rec, M=P, policy=req.layer_map,
            src_layers=assignment.src, dst_layers=assignment.dst,
            select=shared.select.cpu().numpy(), packed=shared.is_packed)


# ---------------------------------------------------------------------------
# natural-language and soft-token baselines
# ---------------------------------------------------------------------------
class NLD(CommMethod):
    name = "nld"

    def run(self, session, batch, req):
        tx, rx = session.sender, session.receiver
        ctx, qry = batch["context"], batch["query"]
        B = ctx.shape[0]
        msg_tok, _ = tx.message(ctx, req.nld_tokens)
        inp = np.concatenate([rx.with_bos(msg_tok), qry], axis=1)
        out = rx.prefill(inp, None, max_new=1)
        wire = session.transport.send_text(req.nld_tokens * B)
        fl = costs.flops_nld(rx.cfg, ctx.shape[1], qry.shape[1],
                             req.max_new, req.nld_tokens, sender_cfg=tx.cfg)
        return _result(rx.predict_last(out.logits), batch["answer"], wire,
                       fl, transfer=session.transport.last)


class Cipher(CommMethod):
    name = "cipher"

    @torch.no_grad()
    def run(self, session, batch, req):
        tx, rx, cfg = session.sender, session.receiver, session.cfg
        ctx, qry = batch["context"], batch["query"]
        B = ctx.shape[0]
        msg_tok, msg_emb = tx.message(ctx, req.nld_tokens)
        # the receiver reads the expected embeddings in the message slots;
        # the token ids there are placeholders
        inp = rx.tokens(rx.with_bos(
            np.concatenate([np.zeros_like(msg_tok), qry], 1)))
        out = tfm.apply_model(
            rx.params, cfg, inp, mode="cached",
            cache=tfm.init_cache(cfg, B, inp.shape[1] + 1,
                                 device=rx.device),
            extra={"soft_embeds": msg_emb, "soft_start": 1})
        wire = session.transport.send_text(
            req.nld_tokens * B, bytes_per_token=cfg.d_model * 2)
        fl = costs.flops_nld(rx.cfg, ctx.shape[1], qry.shape[1],
                             req.max_new, req.nld_tokens, sender_cfg=tx.cfg)
        return _result(rx.predict_last(out.logits), batch["answer"], wire,
                       fl, transfer=session.transport.last)


# ---------------------------------------------------------------------------
# activation communication (Ramesh & Li 2025)
# ---------------------------------------------------------------------------
class ActivationComm(CommMethod):
    def __init__(self, mode: str):
        self.name = f"ac_{mode}"
        self.mode = mode

    @torch.no_grad()
    def run(self, session, batch, req):
        # injection is same-index: the vectors are stacked over SENDER
        # layers and the mask addresses receiver layers
        if session.is_hetero:
            raise ValueError("ac_* baselines need equal depths "
                             "(hetero pairs: hetero_kvcomm)")
        tx, rx, cfg = session.sender, session.receiver, session.cfg
        ctx, qry = batch["context"], batch["query"]
        B = ctx.shape[0]
        L = cfg.attn_layer_count
        layer = req.ac_layer if req.ac_layer is not None else L // 2
        vec = tx.export_hiddens(ctx)                    # (L, B, D)
        mask = torch.zeros((L,), dtype=torch.bool)
        mask[layer] = True
        out = tfm.apply_model(
            rx.params, cfg, rx.tokens(rx.with_bos(qry)), mode="train",
            inject={"vec": vec.to(rx.device), "mask": mask,
                    "mode": self.mode})
        wire = session.transport.send_hidden(B, cfg.d_model)
        return _result(rx.predict_last(out.logits), batch["answer"], wire,
                       costs.flops_ac(cfg, ctx.shape[1], qry.shape[1],
                                      req.max_new),
                       transfer=session.transport.last)


register(Baseline())
register(Skyline())
register(SelectiveKV("kvcomm"))
register(SelectiveKV("random", selector_override="random"))
register(SelectiveKV("contiguous", selector_override="contiguous"))
register(SelectiveKV("prior_only", selector_override="prior_only"))
register(SelectiveKV("full_kv", selector_override="full_kv"))
register(HeteroSelectiveKV())
register(NLD())
register(Cipher())
register(ActivationComm("replace"))
register(ActivationComm("mean"))
register(ActivationComm("sum"))
