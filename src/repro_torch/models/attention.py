"""GQA self-attention with KVComm support (port of the reference block).

Modes: ``train`` (causal over S tokens, no cache) and ``cached`` (S new
tokens written into a per-layer cache buffer laid out
``[ sender prefix (prefix_len) | self tokens ... | pad ]``).

``cache_len`` and ``pos_shift`` are Python ints on the uniform path and
(B,) int tensors on ragged continuous-batching rows; ``prefix_lens`` gives
each row's real prefix length inside the bucket. ``ctx_valid`` is the
layer's selection flag (a Python bool: selections are frozen on the host).
The cache buffers are updated in place (the reference donated them); the
caller must treat the passed buffers as consumed.

``window`` (a layer's sliding window) masks keys ``window`` or more
positions behind the query, in every mode. With ``cfg.ring_cache`` a
windowed layer whose buffer is exactly the window and holds no prefix is
a vLLM-style ring: absolute index i lives in slot i % window.
``cfg.attn_impl == "chunked"`` runs the attention core over query blocks
of ``cfg.attn_block_q``.

``backend="kernel"`` sends one-token decode (S == 1, no window, no mass)
to the ragged decode kernel, the counterpart of the reference's
``"pallas"``; windowed layers decode masked-dense, as there.

A cached prefill of a sequence from its start that attends only its own
tokens (empty cache, uniform rows from position 0, no prefix in the layer
or anywhere in the forward, no mass) of
bf16 / fp16 CUDA tensors runs the prefill kernel ``flash_attention``
(``prefill_on_kernel`` is the rule, read from the inputs alone); every
other call, and every call on the CPU, runs the plain core. While the
recorder is on, each call with S > 1 counts under ``prefill.attn_kernel``
or ``prefill.attn_plain``, and each cached one-token call under
``decode.attn_kernel`` or ``decode.attn_plain``.

Each layer rotates by its own rotary (``layers.layer_yarn``): YaRN on a
config's full-attention layers where it sets ``yarn``, plain RoPE at
``rope_theta`` everywhere else.

Whisper's decoder layers add cross-attention over the encoder's output
(``cross_kv`` projects it once per layer, ``cross_attention`` attends it
unmasked, at zero positions and without RoPE); it runs on the plain core,
as in the reference.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import local_attention, write_seq
from repro_torch.kernels import flash_attention as _k2
from repro_torch.kernels.ragged_decode import per_row as _rows
from repro_torch.kernels.ragged_decode import ragged_decode
from repro_torch.models.layers import (attention_core,
                                       attention_core_chunked, dense_init,
                                       layer_yarn, rope)
from repro_torch.utils import trace

KERNEL_PREFILLS = "prefill.attn_kernel"
PLAIN_PREFILLS = "prefill.attn_plain"
KERNEL_DECODES = "decode.attn_kernel"
PLAIN_DECODES = "decode.attn_plain"


def _core(cfg):
    """The attention core: "xla" (the plain core) materialises the (Sq,
    Skv) probabilities, "chunked" takes query blocks of attn_block_q. On
    DTensors (a mesh) it runs shard by shard (``local_attention``)."""
    return functools.partial(
        _run_core, cfg.attn_block_q if cfg.attn_impl == "chunked" else None)


def _run_core(blk_q, q, k, v, **kw):
    if isinstance(q, DTensor):
        return local_attention(q, k, v, blk_q=blk_q, **kw)
    if blk_q:
        return attention_core_chunked(q, k, v, blk_q=blk_q, **kw)
    return attention_core(q, k, v, **kw)


def prefill_on_kernel(q, k, *, mode: str, cache_len, pos_shift,
                      prefix_len: int, shared_prefix_len: int, prefix_lens,
                      collect_mass: bool, ring: bool) -> bool:
    """Does this self-attention call run the prefill kernel in place of the
    plain core? Only a cached prefill (S > 1) of a sequence from its start
    that attends its own tokens alone: an empty cache (``cache_len`` the int
    0), uniform rows starting at position 0 (``pos_shift`` the int 0, no
    ``prefix_lens``), no prefix in this layer (``prefix_len``) nor in the
    forward (``shared_prefix_len``), no mass, not the ring; q a plain bf16 /
    fp16 CUDA tensor at a geometry the kernel takes; no autograd (the kernel
    has no backward). The forward's prefix keeps every layer of a receiver
    prefill on the plain core, those that hold none too (the packed view's
    unselected layers, at shift 0 under ``zero_unselected``), so the packed
    and dense views run one arithmetic."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    return (mode == "cached" and S > 1 and not ring
            and isinstance(cache_len, int) and cache_len == 0
            and isinstance(pos_shift, int) and pos_shift == 0
            and prefix_lens is None and prefix_len == 0
            and shared_prefix_len == 0 and not collect_mass
            and not isinstance(q, DTensor) and q.is_cuda
            and q.dtype in (torch.bfloat16, torch.float16)
            and Hq % Hkv == 0 and _k2.supports(Hq // Hkv, D, q.dtype)
            and not (torch.is_grad_enabled() and q.requires_grad))


def init_attn(gen, cfg, dtype, device):
    d = cfg.d_model
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {"wq": dense_init(gen, (d, Hq * Dh), dtype, device),
         "wk": dense_init(gen, (d, Hkv * Dh), dtype, device),
         "wv": dense_init(gen, (d, Hkv * Dh), dtype, device),
         "wo": dense_init(gen, (Hq * Dh, d), dtype, device)}
    if cfg.qkv_bias:
        for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv)):
            p[f"b{n}"] = torch.zeros((h * Dh,), dtype=dtype, device=device)
    return p


def _proj(p, x, name, H, Dh):
    y = x @ p[f"w{name}"]
    if f"b{name}" in p:
        y = y + p[f"b{name}"]
    B, S, _ = x.shape
    return y.reshape(B, S, H, Dh)


def self_attention(p, cfg, x, *, mode: str, causal: bool = True,
                   use_rope: bool = True, window: Optional[int] = None,
                   pos_shift=0, prefix_len: int = 0,
                   shared_prefix_len: int = 0,
                   ctx_valid: Optional[bool] = None, cache_k=None,
                   cache_v=None, cache_len=None, prefix_lens=None,
                   collect_mass: bool = False, backend: str = "reference"):
    """Returns (out, (cache_k, cache_v) or (k, v), mass).
    ``shared_prefix_len`` is the forward's shared prefix, whether this
    layer holds it (``prefix_len``) or not; it only routes the call."""
    B, S, _ = x.shape
    dev = x.device
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _proj(p, x, "q", Hq, Dh)
    k = _proj(p, x, "k", Hkv, Dh)
    v = _proj(p, x, "v", Hkv, Dh)
    ar = torch.arange(S, device=dev)
    yarn = layer_yarn(cfg, window)

    if mode == "train":
        pos = pos_shift + ar
        if use_rope:
            pb = pos[None].expand(B, S)
            q = rope(q, pb, cfg.rope_theta, yarn)
            k = rope(k, pb, cfg.rope_theta, yarn)
        out, mass = _core(cfg)(q, k, v, q_pos=pos, kv_pos=pos,
                               causal=causal, window=window)
        if S > 1:
            trace.count(PLAIN_PREFILLS)
        return out.reshape(B, S, -1) @ p["wo"], (k, v), mass

    ragged = (isinstance(cache_len, torch.Tensor)
              or isinstance(pos_shift, torch.Tensor)
              or prefix_lens is not None)
    if ragged:
        clen = _rows(cache_len, B, dev)
        shift = _rows(pos_shift, B, dev)
        q_pos = (shift + clen - prefix_len)[:, None] + ar[None]   # (B, S)
    else:
        q_pos = pos_shift + cache_len - prefix_len + ar             # (S,)
    if use_rope:
        pb = q_pos if q_pos.dim() == 2 else q_pos[None].expand(B, S)
        q = rope(q, pb, cfg.rope_theta, yarn)
        k = rope(k, pb, cfg.rope_theta, yarn)

    Smax = cache_k.shape[1]
    ring = bool(cfg.ring_cache and window is not None and Smax == window
                and prefix_len == 0 and not ragged)
    kernel = prefill_on_kernel(
        q, k, mode=mode, cache_len=cache_len, pos_shift=pos_shift,
        prefix_len=prefix_len, shared_prefix_len=shared_prefix_len,
        prefix_lens=prefix_lens, collect_mass=collect_mass, ring=ring)
    # one-token decode on K1: no window (K1 has none), no mass
    decode_kernel = (backend == "kernel" and S == 1 and window is None
                     and not collect_mass)
    if S > 1:
        trace.count(KERNEL_PREFILLS if kernel else PLAIN_PREFILLS)
    else:
        trace.count(KERNEL_DECODES if decode_kernel else PLAIN_DECODES)
    if ring:
        return _ring_attention(p, cfg, q, k, v, q_pos, cache_k, cache_v,
                               cache_len, pos_shift, causal, window)

    # write the new entries in place; like the reference's
    # dynamic_update_slice, the start is clamped to [0, Smax - S]
    # (torch indexing neither clamps nor rejects negative starts)
    if ragged:
        start = clen.clamp(min=0, max=Smax - S)
        rows = torch.arange(B, device=dev)[:, None]
        cols = start[:, None].long() + ar[None]
        cache_k[rows, cols] = k.to(cache_k.dtype)
        cache_v[rows, cols] = v.to(cache_v.dtype)
    else:
        start = max(0, min(cache_len, Smax - S))
        write_seq(cache_k, start, k.to(cache_k.dtype))
        write_seq(cache_v, start, v.to(cache_v.dtype))

    if kernel:
        # the cache holds these S entries alone, at relative positions
        # equal to the rows', so k and v of this call are the whole range
        out, _ = _k2.flash_attention(q, k, v, context_len=0, q_offset=0,
                                     causal=causal, window=window)
        return out.reshape(B, S, -1) @ p["wo"], (cache_k, cache_v), None

    if decode_kernel:
        # positions are baked into q and the cache (RoPE above), so only
        # the validity geometry ships: kv_len = valid entries, pfx = real
        # prefix entries (0 where ctx_valid masks an unselected layer)
        kvl = _rows(cache_len, B, dev) + S
        pfx = None
        if prefix_len:
            pfx = (prefix_lens if prefix_lens is not None
                   else _rows(prefix_len, B, dev))
            if ctx_valid is False:
                pfx = torch.zeros_like(pfx)
        o = ragged_decode(q[:, 0], cache_k, cache_v, kvl, pfx,
                          prefix_len=prefix_len)
        return o.reshape(B, S, -1) @ p["wo"], (cache_k, cache_v), None

    idx = torch.arange(Smax, device=dev)
    if ragged:
        shift2 = shift[:, None]
        kv_pos = (torch.where(idx[None] < prefix_len, idx[None],
                              shift2 + idx[None] - prefix_len)
                  if prefix_len else shift2 + idx[None])
        valid = idx[None] < (clen + S)[:, None]
        if prefix_len and prefix_lens is not None:
            # the bucket pad [real, prefix_len) never holds sender KV
            valid = valid & ~((idx[None] >= prefix_lens[:, None])
                              & (idx[None] < prefix_len))
    else:
        kv_pos = (torch.where(idx < prefix_len, idx,
                              pos_shift + idx - prefix_len)
                  if prefix_len else pos_shift + idx)
        valid = idx < cache_len + S
    if prefix_len and ctx_valid is False:
        valid = valid & (idx >= prefix_len)
    mass_mask = (idx < prefix_len) if (collect_mass and prefix_len) else None
    # decode (S == 1): every valid slot precedes the query by construction,
    # so the causal comparison is dead work there
    out, mass = _core(cfg)(q, cache_k, cache_v, q_pos=q_pos, kv_pos=kv_pos,
                           kv_valid=valid, causal=causal and S > 1,
                           window=window, mass_mask=mass_mask)
    return out.reshape(B, S, -1) @ p["wo"], (cache_k, cache_v), mass


def _ring_attention(p, cfg, q, k, v, q_pos, cache_k, cache_v, cache_len,
                    pos_shift, causal, window):
    """The ring buffer of a windowed layer (uniform rows, no prefix):
    absolute index i lives in slot i % W. A prefill attends over the
    whole incoming sequence (its early rows need positions the ring
    evicts), then keeps the last W entries; a decode step writes its slot
    and attends over the slots' absolute positions (a slot not yet
    written maps below 0 and is masked). No mass is collected."""
    B, S = q.shape[:2]
    W, dev = cache_k.shape[1], q.device
    if S > 1:
        out, _ = _core(cfg)(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                            causal=causal, window=window)
        n_w = min(S, W)
        # slots (cache_len + i) % W of the last n_w entries: from s0,
        # wrapping at W
        s0 = (cache_len + S - n_w) % W
        for buf, new in ((cache_k, k), (cache_v, v)):
            new = new[:, S - n_w:].to(buf.dtype)
            write_seq(buf, s0, new[:, :W - s0])
            if n_w > W - s0:
                write_seq(buf, 0, new[:, W - s0:])
        return out.reshape(B, S, -1) @ p["wo"], (cache_k, cache_v), None
    slot = cache_len % W
    write_seq(cache_k, slot, k.to(cache_k.dtype))
    write_seq(cache_v, slot, v.to(cache_v.dtype))
    idx = torch.arange(W, device=dev)
    kv_pos = cache_len - torch.remainder(cache_len - idx, W)
    out, _ = _core(cfg)(q, cache_k, cache_v, q_pos=q_pos,
                        kv_pos=pos_shift + kv_pos, kv_valid=kv_pos >= 0,
                        causal=causal, window=window)
    return out.reshape(B, S, -1) @ p["wo"], (cache_k, cache_v), None


def init_cross_attn(gen, cfg, dtype, device):
    return init_attn(gen, cfg, dtype, device)


def cross_attention(p, cfg, x, enc_k, enc_v):
    """Whisper-style cross-attention of x (B, S, d) over precomputed
    encoder KV (B, Senc, Hkv, Dh): unmasked, on the plain core."""
    B, S, _ = x.shape
    q = _proj(p, x, "q", cfg.num_heads, cfg.resolved_head_dim)
    zeros = lambda n: torch.zeros((n,), dtype=torch.long,  # noqa: E731
                                  device=x.device)
    out, _ = _run_core(None, q, enc_k, enc_v, q_pos=zeros(S),
                       kv_pos=zeros(enc_k.shape[1]), causal=False)
    return out.reshape(B, S, -1) @ p["wo"]


def cross_kv(p, cfg, enc_out):
    """A layer's cross KV from the encoder output: (B, Senc, Hkv, Dh)
    each."""
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return _proj(p, enc_out, "k", Hkv, Dh), _proj(p, enc_out, "v", Hkv, Dh)
