"""The port's attention-only decoder: init, serving cache, forward.

Parameters are a plain dict of tensors with one entry per layer
(``params["layers"][l]``), and the serving cache keeps one entry per layer;
a Python loop over layers takes the place of the reference's ``lax.scan``
over stacked runs.

KVComm enters through ``shared`` (a ``repro_torch.core.SharedKV``). Its two
views map onto per-layer cache entries:

  * packed — a selected layer gets a buffer of ``max_len + prefix_len``
    that holds its sender prefix; an unselected layer gets a prefix-free
    buffer of ``max_len``. This replaces the reference's stacked sel/unsel
    sub-scans (``transformer._apply_packed_attn_run``) and keeps layer order
    trivially.
  * dense — every layer holds the prefix and ``ctx_valid`` masks it on
    unselected layers.

SSM, MoE, cross-attention, encoders, AC injection and hidden capture are
not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_mlp, rms_norm)


class ModelOut(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Dict[str, Any]]
    masses: Optional[torch.Tensor]     # (L_attn, B) Eq. (1) raw mass


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not cover yet."""
    for spec in cfg.layer_plan():
        if spec.kind != "attn" or spec.moe or spec.cross_attn \
                or any(w is not None for w in spec.layer_windows()):
            raise NotImplementedError(
                f"{cfg.name}: only dense full-attention layers are ported "
                f"(got {spec})")
    if cfg.encoder_layers or cfg.num_patches or cfg.arch_type == "audio" \
            or cfg.name.startswith("starcoder"):
        raise NotImplementedError(f"{cfg.name}: encoder / patch / gelu "
                                  "variants are not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, *, device) -> Dict[str, Any]:
    """Random init from ``seed`` on a ``torch.Generator``: the reference's
    distributions, not its draws (parity tests bridge reference weights
    through ``repro_torch.weights``)."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, d = dtype_of(cfg), cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt, device),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": torch.zeros((d,), dtype=dt, device=device),
            "attn": attn_mod.init_attn(gen, cfg, dt, device),
            "ln2": torch.zeros((d,), dtype=dt, device=device),
            "mlp": init_mlp(gen, d, cfg.d_ff, dt, device),
        })
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dt, device)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               shared=None) -> Dict[str, Any]:
    """Per-layer serving cache. ``len`` is the (uniform) count of valid
    entries including the prefix; the scheduler replaces it by a (B,)
    tensor for ragged rows. Each layer entry holds ``k``/``v`` of
    (B, S_buf, Hkv, Dh), ``prefix`` (does the buffer start with the
    prefix bucket) and ``ctx_valid`` (is the prefix attended)."""
    check_supported(cfg)
    dtype = dtype_of(cfg)
    prefix_len = 0 if shared is None else shared.prefix_len
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    L = cfg.attn_layer_count
    if shared is None:
        sel = [False] * L
    else:
        sel = [bool(b) for b in shared.select.tolist()]
    packed_i = {l: m for m, l in enumerate(shared.layers)} \
        if shared is not None and shared.is_packed else {}
    layers: List[Dict[str, Any]] = []
    for l in range(L):
        has_prefix = shared is not None and (not shared.is_packed
                                             or l in packed_i)
        S_buf = max_len + (prefix_len if has_prefix else 0)
        k = torch.zeros((batch, S_buf, Hkv, Dh), dtype=dtype, device=device)
        v = torch.zeros_like(k)
        if has_prefix:
            src = (shared.packed_kv if shared.is_packed else shared.kv)
            if src is not None:
                i = packed_i[l] if shared.is_packed else l
                k[:, :prefix_len] = src["k"][i].to(dtype)
                v[:, :prefix_len] = src["v"][i].to(dtype)
        layers.append({"k": k, "v": v, "prefix": has_prefix,
                       "ctx_valid": sel[l] if has_prefix else False})
    return {"len": prefix_len, "layers": layers}


def cache_insert_row(table: Dict[str, Any], row: Dict[str, Any], slot: int,
                     *, src_prefix: int, dst_prefix: int,
                     row_max_len: int) -> Dict[str, Any]:
    """Copy the single row of a B == 1 cache into row ``slot`` of a
    slot-table cache, in place (the reference donated the table).

    Same sequence capacity copies straight across; a smaller prefix-free
    buffer (capacity ``row_max_len``) lands at offset 0; a prefix-carrying
    buffer of another capacity moves as two segments: the prefix
    ``[0, src_prefix)`` stays put and the self region moves from
    ``src_prefix`` to ``dst_prefix`` (entries are rotated by absolute
    position, never by buffer offset). ``len`` stays the caller's."""
    for t_e, r_e in zip(table["layers"], row["layers"]):
        for part in ("k", "v"):
            t, r = t_e[part], r_e[part]
            n = r.shape[1]
            if t.shape[1] == n:
                t[slot] = r[0]
            elif n == row_max_len:
                t[slot, :n] = r[0]
            else:
                self_len = n - src_prefix
                t[slot, :src_prefix] = r[0, :src_prefix]
                t[slot, dst_prefix:dst_prefix + self_len] = r[0, src_prefix:]
    return table


def cache_insert_row_paged(cfg: ModelConfig, table: Dict[str, Any],
                           row: Dict[str, Any], slot: int, prefix, *,
                           layers: Tuple[int, ...], src_prefix: int,
                           dst_prefix: int,
                           row_max_len: int) -> Dict[str, Any]:
    """``cache_insert_row`` that takes the prefix of each selected layer
    from a page-table gather: ``prefix`` is ``PageStore.gather_prefix``'s
    packed {"k","v"}: (M, 1, src_prefix, Hkv, Dh) stack, in ``layers``
    order, instead of the row's own prefix. The self region comes from
    ``row`` as in ``cache_insert_row``; ``len`` stays the caller's. Needs
    the packed cache, whose prefix-carrying layers are exactly ``layers``.
    Equal to ``cache_insert_row`` because the gather at the prefix bucket
    is the padded prefix the row was prefilled with. In place."""
    carrying = tuple(l for l, e in enumerate(table["layers"]) if e["prefix"])
    if carrying != tuple(layers) or len(table["layers"]) != \
            cfg.attn_layer_count:
        raise ValueError("cache_insert_row_paged requires the packed cache "
                         f"of the selection {tuple(layers)}; the table "
                         f"carries a prefix on {carrying}")
    slot_of = {l: m for m, l in enumerate(layers)}
    for l, (t_e, r_e) in enumerate(zip(table["layers"], row["layers"])):
        for part in ("k", "v"):
            t, r = t_e[part], r_e[part]
            n = r.shape[1]
            if l in slot_of:
                self_len = n - src_prefix
                t[slot, :src_prefix] = prefix[part][slot_of[l], 0]
                t[slot, dst_prefix:dst_prefix + self_len] = r[0, src_prefix:]
            elif t.shape[1] == n:
                t[slot] = r[0]
            else:
                t[slot, :n] = r[0]
    return table


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def apply_model(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                mode: str = "train", cache=None, shared=None,
                collect_mass: bool = False, logits_mode: str = "all",
                prefix_lens: Optional[torch.Tensor] = None,
                decode_backend: str = "reference") -> ModelOut:
    """Forward over ``tokens`` (B, S). In ``cached`` mode the cache is
    updated in place and returned with ``len`` advanced by S."""
    check_supported(cfg)
    B, S = tokens.shape
    if shared is not None and shared.is_packed and mode != "cached":
        shared = shared.to_dense(cfg.attn_layer_count)
    prefix_len = 0 if shared is None else shared.prefix_len
    zero_unsel = (shared is not None and prefix_len
                  and shared.pos_mode == "zero_unselected")
    if prefix_len == 0 or mode != "cached":
        prefix_lens = None
    cache_len = cache["len"] if cache is not None else 0
    x = params["embed"][tokens]
    masses: List[torch.Tensor] = []
    for l, lp in enumerate(params["layers"]):
        if mode == "cached":
            entry = cache["layers"][l]
            has_prefix, sel = entry["prefix"], entry["ctx_valid"]
        else:
            entry, has_prefix = None, False
            sel = bool(shared.select[l]) if shared is not None else False
        # positional shift: the real prefix length (paper default), or 0
        # on unselected layers under KVComm-S (zero_unselected)
        keep = sel or not zero_unsel
        if prefix_lens is not None:
            shift = prefix_lens if keep else torch.zeros_like(prefix_lens)
        else:
            shift = prefix_len if keep else 0
        pfx = prefix_len if has_prefix else 0
        out, _, mass = attn_mod.self_attention(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
            mode=mode, pos_shift=shift, prefix_len=pfx,
            ctx_valid=sel if has_prefix else None,
            cache_k=entry["k"] if entry else None,
            cache_v=entry["v"] if entry else None,
            cache_len=(cache_len if has_prefix
                       else cache_len - prefix_len) if entry else None,
            prefix_lens=prefix_lens if has_prefix else None,
            collect_mass=collect_mass, backend=decode_backend)
        x = x + out
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        if collect_mass:
            masses.append(mass if mass is not None else
                          torch.zeros((B,), dtype=torch.float32,
                                      device=x.device))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:, :]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    new_cache = None
    if mode == "cached":
        new_cache = {"len": cache_len + S, "layers": cache["layers"]}
    return ModelOut(logits=logits, cache=new_cache,
                    masses=torch.stack(masses) if masses else None)
