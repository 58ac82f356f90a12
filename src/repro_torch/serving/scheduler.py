"""Continuous-batching scheduler over a ``CommSession`` (port).

  * Slot table — a fixed-capacity serving cache whose rows hold in-flight
    requests at different generation offsets. One ragged step per
    iteration (``protocol.ragged_decode_step``) advances every live row by
    a token; finished slots are refilled mid-flight.
  * Bucket padding — prefixes and queries are padded up to buckets and
    the pad is masked by per-row real lengths, so a bucketed request
    answers exactly like an unpadded one.
  * Overlap — admission (sender prefill, ``send(sync=False)``, bucketed
    receiver prefill, slot insert) is only enqueued on the card, except
    for a serialized transport's codec, whose copies to the host and back
    block (the recorder's ``admit.host_syncs`` counts them). The host
    reads each iteration's tokens one iteration late, through a
    non-blocking copy to pinned memory and an event, so it never waits
    for the step in flight.

  * Tracing — while ``repro_torch.utils.trace`` records, ``run`` opens
    spans at its layer boundaries (``scheduler.run``, ``.setup``,
    ``.admit``, ``.insert``, ``.step``, ``.host_read``, with the
    session's and the transport's inside an admission) and counts
    admissions, steps and host waits inside admissions; its stats then
    carry them under ``"trace"``.

  * Paged admission — when the transport has a ``PageStore`` and a
    ``last_table``, a row's prefix is rebuilt from the store's pages
    (``gather_prefix``: one upload, dequantized on the card) and written by
    ``cache_insert_row_paged``; otherwise it comes from the row as
    prefilled. Both give the same bytes.

  * Degraded admissions — a share the session's ``Resilience`` ladder
    served from a fallback rung is admitted as usual; a text-only one (the
    ladder's baseline rung, or a share that raised: the sender is
    quarantined and the row admitted with ``force_baseline``) gets a zero
    prefix that ``prefix_lens=0`` masks out, so it answers exactly like
    ``prefill(query, None)`` and its neighbours in the table do not move.
    Each such request's ``Completion`` carries its ``DegradationEvent``.

``serve_serial`` is the blocking reference loop (per request: share,
prefill, per-token stream) that the scheduler matches token for token.
A heterogeneous session (sender and receiver of different depths) is
refused, as the reference's scheduler refuses one.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.resilience import DegradationEvent
from repro_torch.comm.session import _LADDER_ERRORS, CommSession
from repro_torch.core import protocol
from repro_torch.core.channel import TransferRecord
from repro_torch.core.types import KVCommConfig, SharedKV
from repro_torch.models import transformer as tfm
from repro_torch.utils import trace


@dataclass
class Request:
    """A sender-side context, a receiver-side query and a budget."""
    rid: int
    context: np.ndarray          # (Sc,) int32
    query: np.ndarray            # (Sq,) int32
    max_new: int = 8             # total tokens (the first from prefill)
    answer: Optional[int] = None


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray           # generated token ids
    ttft_s: float = 0.0          # submit -> first token read on the host
    # set when the request's transfer degraded (a fallback rung or text
    # only) instead of riding the primary transport
    degradation: Optional[DegradationEvent] = None

    @property
    def pred(self) -> int:
        return int(self.tokens[0])


@dataclass
class SchedulerConfig:
    capacity: int = 8            # slot-table rows
    prefix_bucket: int = 16      # Sc rounds up to a multiple of this
    query_bucket: int = 8        # Sq rounds up to a multiple of this
    eos_token: Optional[int] = None
    # a slot that emits eos_token is retired (detected on the lagged host
    # reads) and completions are truncated at the EOS inclusive, matching
    # serve_serial(eos_token=...)
    decode_backend: str = "reference"   # "reference" | "kernel"


def _bucket(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


class _HostRead:
    """A device tensor copied to the host without blocking: the copy queues
    behind the work that produced the tensor, and ``numpy()`` waits for
    that copy alone, not for work enqueued after it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            if trace.active() and not self.event.query():
                with trace.span("scheduler.host_read"):
                    self.event.synchronize()
            else:
                self.event.synchronize()
        return self.host.numpy()


@dataclass
class _Slot:
    req: Request
    start_hist: int              # history row of its first decode token
    col: int = -1                # slot-table row it occupies
    decoded: int = 0


class Scheduler:
    """Iteration-level scheduler on one session; every request shares the
    session's frozen selection (``calib_key``)."""

    def __init__(self, session: CommSession, kvcfg: KVCommConfig, *,
                 calib_key: Optional[str] = None,
                 config: Optional[SchedulerConfig] = None):
        if session.is_hetero:
            raise ValueError("the scheduler serves homogeneous pairs; a "
                             "heterogeneous session shares through "
                             "share_mapped, which its slot table does not "
                             "serve")
        for spec in session.cfg.layer_plan():
            if spec.kind not in ("attn", "shared_attn"):
                raise ValueError(
                    "continuous batching covers attention-only models for "
                    f"now ({session.cfg.name} has {spec.kind} layers: "
                    "ragged SSM rows would need per-row state rewind)")
            if spec.cross_attn:
                raise ValueError(f"{session.cfg.name}: cross-attention "
                                 "rows are not served by the slot table")
        if session.cfg.arch_type == "audio":
            raise ValueError(f"{session.cfg.name}: ragged rows need a RoPE "
                             "arch (an audio model's positions are an "
                             "additive sinusoid)")
        self.session = session
        self.kvcfg = kvcfg
        self.calib_key = calib_key
        self.config = config or SchedulerConfig()
        protocol._check_backend(self.config.decode_backend)
        self.select = session.selection(kvcfg, key=calib_key)
        self.layers = protocol.selected_layer_ids(self.select)
        self.packed = session.transport.packed
        self.device = session.receiver.device
        self._cuda = self.device.type == "cuda"
        self.state: Optional[dict] = None   # the last run's slot table
        self.meta: Optional[SharedKV] = None

    @property
    def pad_token(self) -> int:
        return int(self.session.receiver.tok.PAD)

    def _zero_shared(self, prefix_len: int, capacity: int) -> SharedKV:
        cfg = self.session.cfg
        shape = (capacity, prefix_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = tfm.dtype_of(cfg)
        n = len(self.layers) if self.packed else cfg.attn_layer_count
        kv = {p: torch.zeros((n,) + shape, dtype=dt, device=self.device)
              for p in ("k", "v")}
        if self.packed:
            return protocol.build_packed(self.kvcfg, kv, self.layers,
                                         prefix_len, select=self.select)
        return protocol.build_shared(self.kvcfg, kv, self.select)

    # -- admission ----------------------------------------------------------
    def _admit(self, req: Request, state: dict, slot: int,
               force_baseline: bool = False) -> torch.Tensor:
        """Enqueue one request's admission pipeline with no host wait.
        ``force_baseline`` skips the share and admits the request text
        only (the quarantine ``run`` applies when a share raised)."""
        with trace.span(trace.ADMISSION, rid=req.rid, stream=self._cuda):
            return self._enqueue_admission(req, state, slot, force_baseline)

    def _enqueue_admission(self, req: Request, state: dict, slot: int,
                           force_baseline: bool) -> torch.Tensor:
        sess, cfgd = self.session, self.config
        degraded: Optional[DegradationEvent] = None
        shared = None
        if not force_baseline:
            shared, _ = sess.share(req.context[None, :], self.kvcfg,
                                   key=self.calib_key, sync=False,
                                   rid=req.rid)
            degraded = sess.last_degradation
        if shared is None:
            # a zero prefix that prefix_lens=0 masks out entirely, in the
            # bucket this request's real share would have used
            scb = min(_bucket(int(req.context.shape[0]) + 1,
                              cfgd.prefix_bucket), state["dst_prefix"])
            shared = self._zero_shared(scb, 1)
            sc_real = 0
        else:
            if self.packed and shared.layers != self.layers:
                raise ValueError("a scheduler serves ONE frozen selection; "
                                 "run one scheduler per calib_key")
            sc_real = shared.prefix_len
            scb = min(_bucket(sc_real, cfgd.prefix_bucket),
                      state["dst_prefix"])
        sq_real = int(req.query.shape[0])
        sqb = min(_bucket(sq_real, cfgd.query_bucket), state["query_max"])
        qry = np.full((1, sqb), self.pad_token, np.int32)
        qry[0, :sq_real] = req.query
        with trace.span("receiver.prefill", stream=self._cuda):
            out = sess.receiver.prefill(
                qry, protocol.pad_prefix(shared, scb),
                max_new=state["budget"],
                prefix_lens=torch.full((1,), sc_real, dtype=torch.int32,
                                       device=self.device))
            tok1 = torch.argmax(out.logits[:, sq_real - 1, :], dim=-1)
        if req.max_new <= 1:
            return tok1
        with trace.span("scheduler.insert"):
            geom = dict(src_prefix=scb, dst_prefix=state["dst_prefix"],
                        row_max_len=sqb + state["budget"])
            store = sess.transport.store
            # reading last_table settles this request's deferred ingest;
            # the gather must come before the next share() swaps the table.
            # A degraded or text-only admission leaves it alone: the table
            # belongs to an earlier request's exchange
            btab = (sess.transport.last_table
                    if store is not None and degraded is None
                    and not force_baseline else None)
            if self.packed and btab is not None:
                prefix = store.gather_prefix(btab, scb, device=self.device)
                tfm.cache_insert_row_paged(sess.cfg, state["table"],
                                           out.cache, slot, prefix,
                                           layers=self.layers, **geom)
            else:
                tfm.cache_insert_row(state["table"], out.cache, slot, **geom)
            state["table"]["len"][slot].fill_(state["dst_prefix"] + sq_real)
            state["prefix_lens"][slot].fill_(sc_real)
            state["cur_tok"][slot, 0].copy_(tok1[0])
            state["active"][slot].fill_(True)
        return tok1

    # -- the loop -----------------------------------------------------------
    @torch.no_grad()
    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[Completion], Dict[str, float]]:
        """Serve a request stream to completion. Returns the completions
        (rid order) and metrics (iterations, mean slot occupancy, tokens
        delivered). While the recorder (``repro_torch.utils.trace``) is
        active the metrics also hold the run's spans and counters under
        ``"trace"``."""
        if not requests:
            return [], {"iterations": 0, "steps": 0, "occupancy": 0.0,
                        "tokens": 0}
        with trace.run_recording() as rec:
            mark = rec.mark() if rec is not None else None
            for name in ("admit.count", "admit.host_syncs", "step.count",
                         "prefill.attn_kernel", "prefill.attn_plain",
                         "decode.attn_kernel", "decode.attn_plain",
                         "moe.grouped", "moe.loop", "moe.assignments"):
                trace.count(name, 0)
            with trace.span("scheduler.run"):
                completions, stats = self._serve(requests)
            if rec is not None:
                stats["trace"] = rec.export(mark)
        return completions, stats

    def _serve(self, requests: Sequence[Request]
               ) -> Tuple[List[Completion], Dict[str, float]]:
        sess, cfgd = self.session, self.config
        n_deg0 = len(sess.degradations)    # events of this run only
        cap, dev = cfgd.capacity, self.device
        budget = max(max(r.max_new for r in requests) - 1, 1)
        dst_prefix = _bucket(max(int(r.context.shape[0]) + 1
                                 for r in requests), cfgd.prefix_bucket)
        query_max = _bucket(max(int(r.query.shape[0]) for r in requests),
                            cfgd.query_bucket)
        with trace.span("scheduler.setup", stream=self._cuda):
            zshared = self._zero_shared(dst_prefix, cap)
            table = tfm.init_cache(sess.cfg, cap, query_max + budget,
                                   shared=zshared, device=dev)
            table["len"] = torch.full((cap,), dst_prefix, dtype=torch.int32,
                                      device=dev)
            self.meta = zshared.meta()
            state = self.state = {
                "table": table,
                "prefix_lens": torch.full((cap,), dst_prefix,
                                          dtype=torch.int32, device=dev),
                "cur_tok": torch.zeros((cap, 1), dtype=torch.long,
                                       device=dev),
                "active": torch.zeros((cap,), dtype=torch.bool, device=dev),
                "dst_prefix": dst_prefix,
                "query_max": query_max,
                "budget": budget,
            }
        eos = cfgd.eos_token
        pending = deque(sorted(requests, key=lambda r: r.rid))
        slots: List[Optional[_Slot]] = [None] * cap
        first_tok: Dict[int, _HostRead] = {}
        done: Dict[int, _Slot] = {}
        ttft: Dict[int, float] = {}
        fetch_q: deque = deque()     # (iteration enqueued, read, rid)
        history: List[_HostRead] = []
        occ: List[float] = []

        def retire(i: int) -> None:
            done[slots[i].req.rid] = slots[i]
            slots[i] = None
            state["active"][i].fill_(False)

        it = 0
        t0 = time.perf_counter()
        while pending or any(slots):
            # 1) retire finished slots (host-side counters, no wait)
            for i, s in enumerate(slots):
                if s is not None and s.decoded >= s.req.max_new - 1:
                    retire(i)
            # 2) admit into free slots, enqueued behind the step in flight
            for i in range(cap):
                if not pending:
                    break
                if slots[i] is None:
                    req = pending.popleft()
                    trace.count("admit.count")
                    try:
                        tok1 = self._admit(req, state, i)
                    except _LADDER_ERRORS as e:
                        # quarantine: the failing sender's request is
                        # admitted text only and in-flight rows never
                        # notice (with a ladder this fires only when no
                        # rung could serve)
                        ev = DegradationEvent(
                            stage="baseline",
                            reason=f"{type(e).__name__}: {e}",
                            attempts=getattr(e, "attempts", 1), rid=req.rid)
                        sess.transport.log.append(TransferRecord(
                            kind="kv", n_bytes=0, layers=0, context_len=0,
                            wire_dtype="none", attempts=ev.attempts,
                            degradation=ev))
                        sess.degradations.append(ev)
                        tok1 = self._admit(req, state, i,
                                           force_baseline=True)
                    read = _HostRead(tok1)
                    first_tok[req.rid] = read
                    fetch_q.append((it, read, req.rid))
                    if req.max_new > 1:
                        slots[i] = _Slot(req=req, start_hist=len(history),
                                         col=i)
                    else:
                        done[req.rid] = _Slot(req=req,
                                              start_hist=len(history))
            # 3) one ragged iteration over the whole table
            if any(slots):
                trace.count("step.count")
                with trace.span("scheduler.step", stream=self._cuda):
                    ntok, _, state["table"] = sess.receiver.ragged_step(
                        state["cur_tok"], state["table"], self.meta,
                        state["prefix_lens"], state["active"],
                        backend=cfgd.decode_backend)
                    state["cur_tok"] = ntok[:, None]
                    history.append(_HostRead(ntok))
                    occ.append(sum(s is not None for s in slots) / cap)
                    for s in slots:
                        if s is not None:
                            s.decoded += 1
            # 4) read LAST iteration's results while this one runs; the
            #    same lagged reads drive EOS early exit
            while fetch_q and fetch_q[0][0] < it:
                _, read, rid = fetch_q.popleft()
                tok0 = int(read.numpy()[0])
                ttft.setdefault(rid, time.perf_counter() - t0)
                if eos is not None and tok0 == eos:
                    for i, s in enumerate(slots):
                        if s is not None and s.req.rid == rid:
                            retire(i)
            if eos is not None and len(history) >= 2:
                h = history[-2].numpy()
                row = len(history) - 2
                for i, s in enumerate(slots):
                    if s is not None and row >= s.start_hist \
                            and h[s.col] == eos:
                        retire(i)
            sess.transport.poll_latency()
            it += 1

        hist = (np.stack([h.numpy() for h in history]) if history
                else np.zeros((0, cap), np.int64))
        now = time.perf_counter() - t0
        for _, read, rid in fetch_q:
            read.numpy()
            ttft.setdefault(rid, now)
        sess.transport.flush_latency()

        # per-request degradation events of this run (the last per rid)
        dmap: Dict[int, DegradationEvent] = {
            ev.rid: ev for ev in sess.degradations[n_deg0:]
            if ev.rid is not None}
        completions = []
        for rid in sorted(done):
            s = done[rid]
            toks = [int(first_tok[rid].numpy()[0])]
            if s.req.max_new > 1:
                toks.extend(hist[s.start_hist:s.start_hist + s.decoded,
                                 s.col].tolist())
            if eos is not None and eos in toks:
                toks = toks[:toks.index(eos) + 1]
            completions.append(Completion(
                rid=rid, tokens=np.asarray(toks, np.int32),
                ttft_s=ttft.get(rid, now), degradation=dmap.get(rid)))
        return completions, {
            "iterations": it,
            "steps": len(history),       # ragged steps run on the table
            "occupancy": float(np.mean(occ)) if occ else 0.0,
            "tokens": int(sum(len(c.tokens) for c in completions)),
        }


def serve_serial(session: CommSession, requests: Sequence[Request],
                 kvcfg: KVCommConfig, *, calib_key: Optional[str] = None,
                 eos_token: Optional[int] = None,
                 backend: str = "reference"
                 ) -> Tuple[List[Completion], Dict[str, float]]:
    """The blocking reference loop: one request at a time (synced share,
    prefill, per-token streamed decode)."""
    completions = []
    t0 = time.perf_counter()
    for req in sorted(requests, key=lambda r: r.rid):
        shared, _ = session.share(req.context[None, :], kvcfg,
                                  key=calib_key, sync=True, rid=req.rid)
        degraded = session.last_degradation
        toks, ttft = [], 0.0
        for step_tok in session.stream(req.query[None, :], shared,
                                       max_new=req.max_new,
                                       backend=backend):
            if not toks:
                ttft = time.perf_counter() - t0
            toks.append(int(step_tok[0]))
            if eos_token is not None and toks[-1] == eos_token:
                break
        completions.append(Completion(
            rid=req.rid, tokens=np.asarray(toks, np.int32), ttft_s=ttft,
            degradation=degraded))
    return completions, {
        "iterations": sum(len(c.tokens) for c in completions),
        "occupancy": 1.0,
        "tokens": int(sum(len(c.tokens) for c in completions)),
    }


def accuracy(completions: Sequence[Completion],
             requests: Sequence[Request]) -> float:
    """Fraction of completions whose first token is the recorded answer."""
    byrid = {r.rid: r for r in requests}
    hits = [c.pred == byrid[c.rid].answer for c in completions
            if byrid[c.rid].answer is not None]
    return float(np.mean(hits)) if hits else 0.0


def make_requests(task_batches, max_new: int = 8,
                  pad: Optional[int] = None) -> List[Request]:
    """Flatten task batches ({"context","query","answer"}) into requests,
    trimming right-pad from contexts and left-pad from queries."""
    reqs: List[Request] = []
    for batch in task_batches:
        for b in range(batch["context"].shape[0]):
            ctx, qry = batch["context"][b], batch["query"][b]
            if pad is not None:
                ctx = ctx[:int(np.max(np.nonzero(ctx != pad)[0])) + 1] \
                    if np.any(ctx != pad) else ctx[:1]
                qry = qry[int(np.min(np.nonzero(qry != pad)[0])):] \
                    if np.any(qry != pad) else qry[-1:]
            reqs.append(Request(rid=len(reqs), context=np.asarray(ctx),
                                query=np.asarray(qry), max_new=max_new,
                                answer=int(batch["answer"][b])))
    return reqs
