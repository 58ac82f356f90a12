"""The KVComm protocol (paper §3.1), end to end, in PyTorch.

  sender_prefill    — M_s consumes the context C in one forward pass and
                      exports its per-layer KV and its SSM layers' final
                      states (the state-sharing analogue).
  calibrate         — M_r prefills the calibration query with every layer
                      shared and measures the Eq. (1) masses.
  make_selection    — masses + KVCommConfig -> the layer subset S.
  build/pack_shared — the receiver-side SharedKV view (dense or packed).
  gather/build/pack/scatter_mapped — the same for a heterogeneous pair,
                      keyed by the receiver slots of a ``LayerAssignment``.
  receiver_prefill  — M_r prefills Q with the sender prefix integrated.
  receiver_decode   — one eager greedy step on the masked-dense path.
  decode_step / ragged_decode_step — one greedy step, with the cache
                      updated in place (the reference donated it).

PyTorch runs eagerly, so nothing here compiles; the reference's per-shape
jit specialization has no counterpart yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.selection import normalize_scores, select_layers
from repro_torch.core.types import KVCommConfig, SharedKV
from repro_torch.models import transformer as tfm

# decode-step attention: the masked-dense plain path, or the ragged decode
# kernel (the counterpart of the reference's "pallas")
DECODE_BACKENDS = ("reference", "kernel")


def _check_backend(backend: str) -> None:
    if backend not in DECODE_BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r}; expected one "
                         f"of {DECODE_BACKENDS}")


# ---------------------------------------------------------------------------
# sender side
# ---------------------------------------------------------------------------
def extract_kv(cfg: ModelConfig, cache) -> Optional[Dict[str, torch.Tensor]]:
    """{"k","v"} of (L_attn, B, Sc, Hkv, Dh) from a prefill cache (None for
    an attention-free model). A ring buffer (``cfg.ring_cache`` with a
    context longer than a layer's window) holds only that window, in ring
    slot order, so it is no prefix to share: this raises."""
    if not cache["layers"]:
        return None
    rings = [l for l, e in enumerate(cache["layers"]) if e.get("ring")]
    if rings:
        raise ValueError(
            f"{cfg.name}: attention layers {rings} keep a ring buffer of "
            "their window (ring_cache=True with a context longer than the "
            "window); a ring holds the last window positions in slot "
            "order and cannot be shared as a prefix")
    return {p: torch.stack([e[p] for e in cache["layers"]])
            for p in ("k", "v")}


def extract_states(cfg: ModelConfig, cache) -> Optional[Dict[str, Any]]:
    """The SSM layers' final states stacked on a leading L_ssm axis (None
    for a model without SSM layers)."""
    sts = cache.get("states")
    if not sts:
        return None
    return {key: torch.stack([st[key] for st in sts]) for key in sts[0]}


@torch.no_grad()
def sender_prefill(params, cfg: ModelConfig, context_tokens: torch.Tensor,
                   extra=None) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                        Optional[Dict[str, Any]]]:
    """One forward pass of M_s over C (``extra``: a VLM's ``patches``,
    whisper's ``frames``). Returns (kv, states): the self-attention KV
    only, never a cross-attention layer's ``xk`` / ``xv``."""
    B, Sc = context_tokens.shape
    cache = tfm.init_cache(cfg, B, Sc, device=context_tokens.device)
    out = tfm.apply_model(params, cfg, context_tokens, mode="cached",
                          cache=cache, extra=extra, logits_mode="last")
    return extract_kv(cfg, out.cache), extract_states(cfg, out.cache)


# ---------------------------------------------------------------------------
# calibration + selection
# ---------------------------------------------------------------------------
def _n_ssm(cfg: ModelConfig) -> int:
    return sum(s.count for s in cfg.layer_plan()
               if s.kind in ("mamba", "rwkv"))


def _all_states(cfg: ModelConfig, states) -> Optional[torch.Tensor]:
    """The state mask that shares every SSM layer (None without states)."""
    return (None if states is None
            else torch.ones((_n_ssm(cfg),), dtype=torch.bool))


@torch.no_grad()
def calibrate(receiver_params, cfg: ModelConfig, query_tokens, kv,
              states=None, extra=None) -> torch.Tensor:
    """Prefill Q with every layer (and every SSM state) shared, measuring
    Eq. (1) masses (``extra``: the receiver's ``patches`` / ``frames``).
    Returns the normalized scores S_a, (L_attn,) float32 on the CPU."""
    L = cfg.attn_layer_count
    shared = SharedKV(kv=kv, select=torch.ones((L,), dtype=torch.bool),
                      states=states, state_select=_all_states(cfg, states),
                      prefix_len=kv["k"].shape[2])
    out = receiver_prefill(receiver_params, cfg, query_tokens, shared,
                           max_new=0, extra=extra, collect_mass=True)
    return normalize_scores(out.masses.float().cpu())


def make_selection(cfg: ModelConfig, kvcfg: KVCommConfig,
                   attn_scores: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    return select_layers(attn_scores, cfg.attn_layer_count, kvcfg)


# ---------------------------------------------------------------------------
# the receiver-side view
# ---------------------------------------------------------------------------
def selected_layer_ids(select) -> Tuple[int, ...]:
    """Static tuple of the selected layer indices (select is on the CPU)."""
    if select is None:
        return ()
    return tuple(int(i) for i in torch.nonzero(select.cpu()).flatten())


def _host(mask) -> Optional[torch.Tensor]:
    return None if mask is None else torch.as_tensor(mask).cpu()


def build_shared(kvcfg: KVCommConfig, kv, select, states=None,
                 state_select=None) -> SharedKV:
    """The dense view: the full stack plus the selection mask (and the
    SSM states with their mask)."""
    return SharedKV(kv=kv, select=_host(select), states=states,
                    state_select=_host(state_select),
                    prefix_len=0 if kv is None else kv["k"].shape[2],
                    pos_mode=kvcfg.pos_mode)


def transmit(cfg: ModelConfig, kvcfg: KVCommConfig, kv, select,
             states=None, state_select=None) -> Tuple[SharedKV, int]:
    """Deprecated shim: ``build_shared`` and the analytic byte count
    (``comm.transport.payload_bytes``) in one call. Byte accounting lives
    in the transports; new code uses them."""
    from repro_torch.comm.transport import payload_bytes
    return (build_shared(kvcfg, kv, select, states, state_select),
            payload_bytes(kv, select, states, state_select))


def build_packed(kvcfg: KVCommConfig, payload, layers: Sequence[int],
                 prefix_len: int, select, states=None,
                 state_select=None) -> SharedKV:
    """The packed view from an already-gathered (M, B, Sc, Hkv, Dh)
    payload and its layer map."""
    if select is None:
        raise ValueError("build_packed needs the (L,) selection mask")
    return SharedKV(packed_kv=payload, layers=tuple(int(i) for i in layers),
                    select=_host(select), states=states,
                    state_select=_host(state_select), prefix_len=prefix_len,
                    pos_mode=kvcfg.pos_mode)


def gather_selected(kv, select) -> Dict[str, torch.Tensor]:
    """The wire payload: the M selected layers' KV. Stacks per-layer views
    (indexing with a host list would copy the index to the card and wait
    for the stream)."""
    idx = selected_layer_ids(select)
    return {p: (torch.stack([kv[p][i] for i in idx]) if idx
                else kv[p][:0]) for p in ("k", "v")}


def pack_shared(kvcfg: KVCommConfig, kv, select, states=None,
                state_select=None) -> SharedKV:
    """Gather the selected layers into the packed view (a KV-less transfer
    keeps the dense form)."""
    if kv is None:
        return build_shared(kvcfg, None, select, states, state_select)
    return build_packed(kvcfg, gather_selected(kv, select),
                        selected_layer_ids(select), int(kv["k"].shape[2]),
                        select=select, states=states,
                        state_select=state_select)


# ---------------------------------------------------------------------------
# heterogeneous transmission (sender depth != receiver depth)
# ---------------------------------------------------------------------------
def gather_mapped(kv, assignment) -> Dict[str, torch.Tensor]:
    """The heterogeneous wire payload: the sender layers named by
    ``assignment.src``, stacked in receiver-slot (``dst``) order,
    (P, B, Sc, Hkv, Dh)."""
    idx = assignment.src
    return {p: (torch.stack([kv[p][i] for i in idx]) if idx
                else kv[p][:0]) for p in ("k", "v")}


def build_mapped(kvcfg: KVCommConfig, payload, assignment,
                 prefix_len: int, states=None,
                 state_select=None) -> SharedKV:
    """The packed receiver-side view of a gathered mapped payload:
    ``layers`` are the receiver slots (what the packed cache partitions
    on), ``src_layers`` the sender provenance."""
    return SharedKV(packed_kv=payload, layers=tuple(assignment.dst),
                    src_layers=tuple(assignment.src),
                    select=torch.from_numpy(assignment.dst_mask()),
                    states=states, state_select=_host(state_select),
                    prefix_len=prefix_len, pos_mode=kvcfg.pos_mode)


def pack_mapped(kvcfg: KVCommConfig, kv, assignment, states=None,
                state_select=None) -> SharedKV:
    """``pack_shared`` for a heterogeneous pair: gather the assignment's
    sender layers and key the packed view by receiver slot."""
    if kv is None:
        return build_shared(kvcfg, None,
                            torch.from_numpy(assignment.dst_mask()),
                            states, state_select)
    return build_mapped(kvcfg, gather_mapped(kv, assignment), assignment,
                        int(kv["k"].shape[2]), states, state_select)


def scatter_mapped(kvcfg: KVCommConfig, payload, assignment,
                   prefix_len: int, states=None,
                   state_select=None) -> SharedKV:
    """The dense receiver-side view of a mapped payload: a zero-padded
    (L_dst, ...) stack with each packed slice in its receiver slot
    (``select`` masks the zeros)."""
    kv = {}
    for part in ("k", "v"):
        p = payload[part]
        dense = p.new_zeros((assignment.num_dst_layers,) + tuple(p.shape[1:]))
        for m, j in enumerate(assignment.dst):
            dense[j] = p[m]
        kv[part] = dense
    return SharedKV(kv=kv, select=torch.from_numpy(assignment.dst_mask()),
                    states=states, state_select=_host(state_select),
                    prefix_len=prefix_len, pos_mode=kvcfg.pos_mode)


def pad_prefix(shared: SharedKV, prefix_len: int) -> SharedKV:
    """Zero-pad the shared prefix along Sc up to the bucket ``prefix_len``.
    The pad is masked by per-row ``prefix_lens``, so its value is never
    read; padding only gives every slot-table request one geometry."""
    if shared.prefix_len == prefix_len:
        return shared
    if shared.prefix_len > prefix_len:
        raise ValueError(f"cannot shrink a prefix ({shared.prefix_len} -> "
                         f"{prefix_len})")
    pad = prefix_len - shared.prefix_len

    def pad_kv(kvd):
        if kvd is None:
            return None
        return {p: torch.nn.functional.pad(kvd[p], (0, 0, 0, 0, 0, pad))
                for p in ("k", "v")}

    return SharedKV(kv=pad_kv(shared.kv), select=shared.select,
                    states=shared.states, state_select=shared.state_select,
                    prefix_len=prefix_len, pos_mode=shared.pos_mode,
                    packed_kv=pad_kv(shared.packed_kv), layers=shared.layers)


# ---------------------------------------------------------------------------
# receiver side
# ---------------------------------------------------------------------------
@torch.no_grad()
def receiver_prefill(params, cfg: ModelConfig, query_tokens,
                     shared: Optional[SharedKV], max_new: int = 64,
                     extra=None, prefix_lens=None,
                     collect_mass: bool = False):
    """Prefill Q with the sender prefix integrated; the cache is sized for
    ``max_new`` decode steps. ``extra`` carries a VLM's ``patches`` or
    whisper's ``frames`` (whose cross KV the cache keeps for the decode).
    ``prefix_lens`` (B,) marks each row's real prefix length under a
    bucket-padded prefix (``pad_prefix``)."""
    B, Sq = query_tokens.shape
    cache = tfm.init_cache(cfg, B, Sq + max_new, shared=shared,
                           device=query_tokens.device)
    return tfm.apply_model(params, cfg, query_tokens, mode="cached",
                           cache=cache, shared=shared, extra=extra,
                           collect_mass=collect_mass, prefix_lens=prefix_lens)


@torch.no_grad()
def receiver_decode(params, cfg: ModelConfig, token, cache,
                    shared: Optional[SharedKV] = None):
    """One decode step over ``token`` (B, 1) on the masked-dense path;
    returns the model output (last-position logits, the cache updated in
    place)."""
    return tfm.apply_model(params, cfg, token, mode="cached", cache=cache,
                           shared=shared, logits_mode="last")


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache,
                shared: Optional[SharedKV] = None,
                backend: str = "reference"):
    """One greedy decode step; the cache is updated in place and must be
    treated as consumed. Returns (next_token (B, 1), logits (B, V),
    cache)."""
    _check_backend(backend)
    meta = shared.meta() if shared is not None else None
    out = tfm.apply_model(params, cfg, token, mode="cached", cache=cache,
                          shared=meta, logits_mode="last",
                          decode_backend=backend)
    logits = out.logits[:, -1, :]
    return torch.argmax(logits, dim=-1)[:, None], logits, out.cache


@torch.no_grad()
def ragged_decode_step(params, cfg: ModelConfig, tokens, cache,
                       shared: Optional[SharedKV], prefix_lens, active,
                       backend: str = "reference"):
    """One continuous-batching iteration over a slot-table cache whose
    ``len`` is a per-row (capacity,) tensor. Finished and empty rows do not
    advance: their write cursor is frozen, so a dead slot rewrites its own
    masked position and live rows never see it. Returns (next_tokens
    (capacity,), logits, cache); the cache is updated in place."""
    _check_backend(backend)
    meta = shared.meta() if shared is not None else None
    out = tfm.apply_model(params, cfg, tokens, mode="cached", cache=cache,
                          shared=meta, logits_mode="last",
                          prefix_lens=prefix_lens, decode_backend=backend)
    cache = out.cache
    cache["len"] = torch.where(active, cache["len"], cache["len"] - 1)
    logits = out.logits[:, -1, :]
    return torch.argmax(logits, dim=-1), logits, cache


@torch.no_grad()
def generate(params, cfg: ModelConfig, query_tokens, shared=None,
             max_new: int = 32, extra=None, backend: str = "reference"):
    """Greedy generation (``extra`` as in ``receiver_prefill``). Returns
    (tokens (B, max_new), final cache)."""
    out = receiver_prefill(params, cfg, query_tokens, shared,
                           max_new=max_new, extra=extra)
    cache = out.cache
    tok = torch.argmax(out.logits[:, -1, :], dim=-1)[:, None]
    toks = []
    for _ in range(max_new):
        toks.append(tok[:, 0])
        tok, _, cache = decode_step(params, cfg, tok, cache, shared,
                                    backend=backend)
    return torch.stack(toks, 1), cache
