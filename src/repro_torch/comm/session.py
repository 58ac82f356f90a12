"""CommSession: a sender/receiver pairing over a transport.

It owns the calibration state (Eq. (1) scores and frozen layer selections,
cached per task key and ``KVCommConfig``), the transport, the multi-sender
mailbox of §J (extra senders ``attach_sender`` and deposit views that
``combined`` merges), batched and streaming generation on the receiver,
the per-layer ``WirePlan`` of a frozen selection, and the paged-store
dedup summary. ``run(method, batch, ...)`` dispatches through the
``METHODS`` registry.

Heterogeneous pairs: sender and receiver may differ in depth (not in KV
geometry). ``calibrate_side`` / ``side_selection`` score and select each
model over its own layers, and ``share_mapped`` aligns them with a
``LayerMap`` policy; the same-index ``calibrate`` and ``share`` refuse such
a pair. The resilience ladder is not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.agent import Agent
from repro_torch.comm.methods import CommRequest, MethodResult, get_method
from repro_torch.comm.transport import (InMemoryTransport, Transport,
                                        WirePlan)
from repro_torch.core import protocol
from repro_torch.core.channel import combine_senders
from repro_torch.core.layermap import LayerAssignment, get_layer_map
from repro_torch.core.selection import gaussian_prior, selection_scores
from repro_torch.core.types import KVCommConfig, SharedKV


@dataclass
class SenderHandle:
    """A registered extra sender. ``send`` prefills its context, pushes the
    selected KV through the session's transport and deposits the receiver's
    view in the session's mailbox."""
    session: "CommSession"
    agent: Agent
    name: str

    def send(self, context: np.ndarray, kvcfg: KVCommConfig,
             select: Optional[torch.Tensor] = None,
             scores: Optional[torch.Tensor] = None,
             calib_key: Optional[str] = None) -> SharedKV:
        sess = self.session
        if self.agent.cfg.attn_layer_count != sess.cfg.attn_layer_count:
            raise ValueError("the multi-sender mailbox needs sender depth "
                             "== receiver depth")
        if select is None:
            select = sess.selection(kvcfg, scores=scores, key=calib_key)
        kv, _ = self.agent.export_kv(context)
        shared = sess.transport.send(sess.cfg, kvcfg, kv, select)
        sess.mailbox.append((self.name, shared))
        return shared


class CommSession:
    def __init__(self, sender: Agent, receiver: Agent,
                 transport: Optional[Transport] = None):
        scfg, rcfg = sender.cfg, receiver.cfg
        # depths may differ (a LayerMap aligns them); the per-layer KV
        # geometry must match for the receiver to read the sender's KV
        if (scfg.num_kv_heads, scfg.resolved_head_dim) != \
                (rcfg.num_kv_heads, rcfg.resolved_head_dim):
            raise ValueError(
                "sender/receiver must agree on KV geometry (Hkv, Dh): "
                f"{(scfg.num_kv_heads, scfg.resolved_head_dim)} vs "
                f"{(rcfg.num_kv_heads, rcfg.resolved_head_dim)}")
        self.sender = sender
        self.receiver = receiver
        self.transport = transport if transport is not None \
            else InMemoryTransport()
        self.cfg = rcfg
        self._score_cache: Dict[Optional[str], torch.Tensor] = {}
        self._sel_cache: Dict[Tuple[Optional[str], KVCommConfig],
                              torch.Tensor] = {}
        # per-side state of heterogeneous pairs: scores and selections
        # keyed by ("sender" | "receiver", task key), each over that
        # side's own depth
        self._side_scores: Dict[Tuple[str, Optional[str]],
                                torch.Tensor] = {}
        self._side_sel: Dict[Tuple[str, Optional[str], KVCommConfig],
                             torch.Tensor] = {}
        self.mailbox: List[Tuple[str, SharedKV]] = []
        self._n_handles = 0

    @property
    def is_hetero(self) -> bool:
        """Sender and receiver differ in attention depth: the same-index
        protocol (``share``, "kvcomm") no longer applies and a
        ``LayerMap`` must align the sides (``share_mapped``,
        "hetero_kvcomm"). The port's models are attention-only, so
        attention depth is the whole depth."""
        return (self.sender.cfg.attn_layer_count
                != self.receiver.cfg.attn_layer_count)

    def _agent(self, side: str) -> Agent:
        if side not in ("sender", "receiver"):
            raise ValueError(f"side must be 'sender' or 'receiver', "
                             f"got {side!r}")
        return self.sender if side == "sender" else self.receiver

    # ---- calibration + frozen selections ---------------------------------
    def calibrate(self, context: np.ndarray, query: np.ndarray,
                  key: Optional[str] = None) -> torch.Tensor:
        """Eq. (1) scores from one calibration sample, cached under
        ``key``: the receiver consumes the sender's KV of ``context``, so
        both sides must agree on depth (a heterogeneous pair calibrates
        each side with ``calibrate_side``)."""
        if self.is_hetero:
            raise ValueError("cross-model calibration needs equal depths; "
                             "use calibrate_side('sender', ...) on a "
                             "heterogeneous pair")
        if key is not None and key in self._score_cache:
            return self._score_cache[key]
        kv, _ = self.sender.export_kv(context)
        scores = self.receiver.calibrate(query, kv)
        if key is not None:
            self._score_cache[key] = scores
        return scores

    def calibrate_side(self, side: str, context: np.ndarray,
                       query: np.ndarray,
                       key: Optional[str] = None) -> torch.Tensor:
        """Eq. (1) scores of one side over its own layers: ``side``'s agent
        calibrates against its own KV of ``context``. Cached under
        (side, key)."""
        cache_key = (side, key)
        if key is not None and cache_key in self._side_scores:
            return self._side_scores[cache_key]
        scores = self._agent(side).self_scores(context, query)
        if key is not None:
            self._side_scores[cache_key] = scores
        return scores

    def side_selection(self, side: str, kvcfg: KVCommConfig,
                       scores: Optional[torch.Tensor] = None,
                       key: Optional[str] = None) -> torch.Tensor:
        """The frozen layer subset over ``side``'s own depth; explicit
        ``scores`` recompute and refresh the cache, score-less calls serve
        the frozen mask."""
        agent = self._agent(side)
        cache_key = (side, key, kvcfg)
        if scores is None and key is not None:
            if cache_key in self._side_sel:
                return self._side_sel[cache_key]
            scores = self._side_scores.get((side, key))
        select = protocol.make_selection(agent.cfg, kvcfg, scores)
        if key is not None:
            self._side_sel[cache_key] = select
        return select

    def selection(self, kvcfg: KVCommConfig,
                  scores: Optional[torch.Tensor] = None,
                  key: Optional[str] = None) -> torch.Tensor:
        """The frozen layer subset for (task key, kvcfg), computed once.
        Explicit ``scores`` recompute and refresh the cache."""
        cache_key = (key, kvcfg)
        if scores is None and key is not None:
            if cache_key in self._sel_cache:
                return self._sel_cache[cache_key]
            scores = self._score_cache.get(key)
        select = protocol.make_selection(self.cfg, kvcfg, scores)
        if key is not None:
            self._sel_cache[cache_key] = select
        return select

    def wire_plan(self, kvcfg: KVCommConfig,
                  scores: Optional[torch.Tensor] = None,
                  key: Optional[str] = None, top_frac: float = 0.25,
                  low_frac: float = 0.5) -> WirePlan:
        """The per-layer wire precision for (task key, kvcfg): the frozen
        selection's layers ranked by the scores (+ depth prior) that chose
        them, float16 for the top ``top_frac``, int4 for the bottom
        ``low_frac``, int8 between. With no scores (none passed, none cached
        under ``key``) the Gaussian depth prior alone ranks them. Pass it
        anywhere a ``wire_dtype`` goes."""
        select = self.selection(kvcfg, scores=scores, key=key)
        if scores is None and key is not None:
            scores = self._score_cache.get(key)
        n = int(select.shape[0])
        combined = (gaussian_prior(n, kvcfg.mu, kvcfg.sigma)
                    if scores is None else selection_scores(scores, kvcfg))
        return WirePlan.from_scores(combined.numpy(),
                                    select=select.cpu().numpy(),
                                    top_frac=top_frac, low_frac=low_frac)

    # ---- one communication round -----------------------------------------
    def share(self, context: np.ndarray, kvcfg: KVCommConfig,
              scores: Optional[torch.Tensor] = None,
              key: Optional[str] = None, sync: Optional[bool] = None
              ) -> Tuple[SharedKV, torch.Tensor]:
        """Prefill the context on the sender, select layers, push through
        the transport. Returns (receiver-side SharedKV, select).
        ``sync=False`` keeps the round free of host waits (the transfer's
        stamp is deferred)."""
        if self.is_hetero:
            raise ValueError("sender and receiver disagree on depth; use "
                             "share_mapped (or the 'hetero_kvcomm' method) "
                             "with a LayerMap policy")
        select = self.selection(kvcfg, scores=scores, key=key)
        kv, _ = self.sender.export_kv(context)
        shared = self.transport.send(self.cfg, kvcfg, kv, select, sync=sync)
        return shared, select

    def share_mapped(self, context: np.ndarray, kvcfg: KVCommConfig,
                     policy: str = "depth_proportional",
                     src_scores: Optional[torch.Tensor] = None,
                     dst_scores: Optional[torch.Tensor] = None,
                     key: Optional[str] = None,
                     sync: Optional[bool] = None
                     ) -> Tuple[SharedKV, LayerAssignment]:
        """The heterogeneous round: the sender selects over its own depth,
        the ``policy`` LayerMap places the selected layers in receiver
        slots, and the transport moves exactly the mapped payload. On a
        same-depth pair ``policy="identity"`` reproduces ``share`` bit for
        bit. Returns (receiver-side SharedKV, the assignment)."""
        src_select = self.side_selection("sender", kvcfg, scores=src_scores,
                                         key=key)
        if src_scores is None and key is not None:
            src_scores = self._side_scores.get(("sender", key))
        if dst_scores is None and key is not None:
            dst_scores = self._side_scores.get(("receiver", key))
        host = lambda x: None if x is None else np.asarray(   # noqa: E731
            x.cpu() if isinstance(x, torch.Tensor) else x)
        assignment = get_layer_map(policy).assign(
            protocol.selected_layer_ids(src_select),
            num_src_layers=self.sender.cfg.attn_layer_count,
            num_dst_layers=self.receiver.cfg.attn_layer_count,
            src_scores=host(src_scores), dst_scores=host(dst_scores))
        kv, _ = self.sender.export_kv(context)
        shared = self.transport.send(self.cfg, kvcfg, kv, None,
                                     assignment=assignment, sync=sync)
        return shared, assignment

    # ---- multi-sender (§J) ------------------------------------------------
    def attach_sender(self, agent: Agent,
                      name: Optional[str] = None) -> SenderHandle:
        """Register an additional sender; returns its mailbox handle."""
        handle = SenderHandle(self, agent,
                              name or f"{agent.name}#{self._n_handles}")
        self._n_handles += 1
        return handle

    def combined(self, clear: bool = False) -> SharedKV:
        """Every mailbox deposit merged along the context axis
        (``combine_senders``: one joint selection covers every prefix)."""
        if not self.mailbox:
            raise ValueError("no sender has deposited a SharedKV yet")
        merged = combine_senders([s for _, s in self.mailbox])
        if clear:
            self.mailbox.clear()
        return merged

    # ---- paged-store accounting -------------------------------------------
    def dedup_summary(self) -> Dict[str, float]:
        """The transport log's paged dedup accounting: pages the transfers
        referenced, pages that crossed, the pool-hit rate and the bytes.
        Zeroes when no ``PageStore`` is attached."""
        recs = [r for r in self.transport.log if r.pages_total]
        total = sum(r.pages_total for r in recs)
        hit = sum(r.pages_hit for r in recs)
        return {
            "transfers": len(recs),
            "pages_total": total,
            "pages_sent": sum(r.pages_sent for r in recs),
            "pages_hit": hit,
            "hit_rate": (hit / total) if total else 0.0,
            "bytes": sum(r.n_bytes for r in recs),
        }

    # ---- dispatch ---------------------------------------------------------
    def run(self, method: str, batch: Dict[str, np.ndarray],
            kvcfg: Optional[KVCommConfig] = None,
            scores: Optional[torch.Tensor] = None,
            ac_layer: Optional[int] = None, nld_tokens: int = 16,
            max_new: int = 1, calib_key: Optional[str] = None,
            layer_map: str = "depth_proportional") -> MethodResult:
        """Run one registered method over a batch. The latency ends after
        the receiver's card has finished the method's work."""
        req = CommRequest(kvcfg=kvcfg, scores=scores, ac_layer=ac_layer,
                          nld_tokens=nld_tokens, max_new=max_new,
                          calib_key=calib_key, layer_map=layer_map)
        t0 = time.perf_counter()
        result = get_method(method).run(self, batch, req)
        if self.receiver.device.type == "cuda":
            torch.cuda.synchronize(self.receiver.device)
        result.latency_s = time.perf_counter() - t0
        return result

    # ---- generation -------------------------------------------------------
    def generate(self, query: np.ndarray, shared: Optional[SharedKV] = None,
                 max_new: int = 32) -> np.ndarray:
        """Batched greedy generation on the receiver: (B, max_new)."""
        toks, _ = self.receiver.generate(query, shared, max_new=max_new)
        return toks.cpu().numpy()

    def stream(self, query: np.ndarray, shared: Optional[SharedKV] = None,
               max_new: int = 32,
               backend: str = "reference") -> Iterator[np.ndarray]:
        """Streaming greedy generation: yields one (B,) token per step."""
        if max_new <= 0:
            return
        out = self.receiver.prefill(query, shared, max_new=max_new)
        cache = out.cache
        tok = torch.argmax(out.logits[:, -1, :], dim=-1)[:, None]
        yield tok[:, 0].cpu().numpy()
        for _ in range(max_new - 1):
            tok, _, cache = self.receiver.decode_step(tok, cache, shared,
                                                      backend=backend)
            yield tok[:, 0].cpu().numpy()
