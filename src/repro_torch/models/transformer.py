"""The port's decoder: init, serving cache, forward.

Parameters are a plain dict of tensors with one entry per executed layer
in layer-plan order (``params["layers"][i]``): an attention layer holds
``ln1``/``attn``/``ln2`` and ``mlp`` (swiglu, or gelu for starcoder-style
models) or ``moe`` (the router and stacked experts), an RWKV6 layer
``ln1``/``ln2``/``rwkv``, a Mamba2 layer ``ln``/``mamba``. Zamba's shared
attention block lives once in ``params["shared_attn"]`` and every
invocation's entry is that same dict (the same tensors, not copies). A
Python loop over layers takes the place of the reference's ``lax.scan``
over stacked runs.

The serving cache keeps one entry per attention layer (``"layers"``,
shared-attention invocations included, each with its own buffers) and,
for a model with SSM layers, one state dict per SSM layer (``"states"``,
float32 whatever the model dtype). With ``cfg.ring_cache`` a windowed
layer of a prefix-free dense cache keeps a ring of ``window`` entries.

KVComm enters through ``shared`` (a ``repro_torch.core.SharedKV``). Its two
KV views map onto per-layer cache entries:

  * packed — a selected layer gets a buffer of ``max_len + prefix_len``
    that holds its sender prefix; an unselected layer gets a prefix-free
    buffer of ``max_len``. This replaces the reference's stacked sel/unsel
    sub-scans (``transformer._apply_packed_attn_run``) and keeps layer order
    trivially.
  * dense — every layer holds the prefix and ``ctx_valid`` masks it on
    unselected layers.

Its ``states`` seed the SSM layers (the state-sharing protocol): a layer
flagged in ``state_select`` starts from the sender's final state, the rest
from zeros.

The comparison methods enter through three more arguments: ``extra``
soft embeddings (CIPHER), ``capture_hidden`` (each attention layer's
last-token input, the AC wire payload) and ``inject`` (AC, dense path
only). ``extra={"patches": (B, P, D)}`` substitutes a VLM's stub patch
embeddings for the first P positions.

Whisper (``arch_type == "audio"``): ``params["encoder"]`` holds the
encoder's layers (non-causal self-attention and gelu MLP) and its final
norm; ``extra={"frames": (B, Senc, d)}`` (the stub audio frames) runs
them, with the additive sinusoid positions, into ``enc_out``. The decoder
adds sinusoid positions to its embeddings at ``cache_len + arange(S)``
(no RoPE), and each decoder layer carries ``ln_x`` / ``xattn`` for
cross-attention over ``enc_out``. A cached layer keeps that layer's cross
KV in ``xk`` / ``xv``: built from ``enc_out`` at a prefill (S > 1) and
reused at a one-token decode, as in the reference. Ragged rows need a
RoPE arch and raise on an audio model.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed import hints
from repro_torch.distributed.sharding import (cache_placements, distribute,
                                              local_embedding, local_moe,
                                              reduce_partial, unshard_data,
                                              write_seq)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_moe, dense_init,
                                       embed_init, init_mlp, init_moe,
                                       rms_norm, sinusoid_positions)


class ModelOut(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Dict[str, Any]]
    masses: Optional[torch.Tensor]     # (L_attn, B) Eq. (1) raw mass
    aux_loss: torch.Tensor             # MoE load-balance loss (0 if dense)
    hiddens: Optional[torch.Tensor] = None   # (L_attn, B, D) last token


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


SSM_KINDS = ("mamba", "rwkv")
ATTN_KINDS = ("attn", "shared_attn")


def mlp_type(cfg: ModelConfig) -> str:
    return "gelu" if cfg.arch_type == "audio" or cfg.name.startswith(
        "starcoder") else "swiglu"


def encoder_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The run spec of every encoder layer (non-causal attention), as the
    reference's ``encoder_plan``."""
    return [LayerSpec(kind="attn", count=cfg.encoder_layers, causal=False)
            ] * cfg.encoder_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, *, device) -> Dict[str, Any]:
    """Random init from ``seed`` on a ``torch.Generator``: the reference's
    distributions, not its draws (parity tests bridge reference weights
    through ``repro_torch.weights``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, d = dtype_of(cfg), cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt, device),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
        "layers": [],
    }
    zeros = lambda: torch.zeros((d,), dtype=dt, device=device)  # noqa: E731

    def layer(spec):
        kind = spec.kind
        if kind == "rwkv":
            return {"ln1": zeros(), "ln2": zeros(),
                    "rwkv": ssm_mod.init_rwkv(gen, cfg, dt, device)}
        if kind == "mamba":
            return {"ln": zeros(),
                    "mamba": ssm_mod.init_mamba(gen, cfg, dt, device)}
        p = {"ln1": zeros(),
             "attn": attn_mod.init_attn(gen, cfg, dt, device),
             "ln2": zeros()}
        if spec.moe:
            p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.num_experts, dt,
                                device)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt, device, mlp_type(cfg))
        if spec.cross_attn:
            p["ln_x"] = zeros()
            p["xattn"] = attn_mod.init_cross_attn(gen, cfg, dt, device)
        return p

    for spec in layer_specs(cfg):
        if spec.kind != "shared_attn":
            params["layers"].append(layer(spec))
            continue
        if "shared_attn" not in params:   # one block, every invocation
            params["shared_attn"] = layer(LayerSpec(kind="attn", count=1))
        params["layers"].append(params["shared_attn"])
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dt, device)
    if cfg.encoder_layers:
        params["encoder"] = {
            "layers": [layer(spec) for spec in encoder_specs(cfg)],
            "final_norm": zeros()}
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               shared=None, mesh=None) -> Dict[str, Any]:
    """Per-layer serving cache. ``len`` is the (uniform) count of valid
    entries including the prefix; the scheduler replaces it by a (B,)
    tensor for ragged rows. Each layer entry holds ``k``/``v`` of
    (B, S_buf, Hkv, Dh), ``prefix`` (does the buffer start with the
    prefix bucket), ``ctx_valid`` (is the prefix attended) and ``ring``
    (is the buffer a ring shorter than ``max_len``: with
    ``cfg.ring_cache``, a windowed layer of a prefix-free dense cache holds
    min(max_len, window) entries; the packed cache has no ring, as in the
    reference). A cross-attention layer also holds ``xk`` / ``xv`` of
    (B, encoder_seq, Hkv, Dh), in either layout.

    With a ``mesh`` every buffer and state is a DTensor placed by the
    reference's cache rules (``sharding.cache_placements``); a DTensor
    prefix lands through ``sharding.write_seq``."""
    dtype = dtype_of(cfg)
    place = functools.partial(_place, cfg, mesh, batch)
    prefix_len = 0 if shared is None else shared.prefix_len
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    L = cfg.attn_layer_count
    if shared is None or shared.select is None:
        sel = [False] * L
    else:
        sel = [bool(b) for b in shared.select.tolist()]
    packed = shared is not None and shared.is_packed
    packed_i = ({l: m for m, l in enumerate(shared.layers)} if packed
                else {})
    specs = [s for s in layer_specs(cfg) if s.kind in ATTN_KINDS]
    windows = [s.window for s in specs]
    layers: List[Dict[str, Any]] = []
    for l in range(L):
        has_prefix = shared is not None and (not packed or l in packed_i)
        S_buf = max_len + (prefix_len if has_prefix else 0)
        if cfg.ring_cache and windows[l] and prefix_len == 0 and not packed:
            S_buf = min(S_buf, windows[l])
        k = place("k", torch.zeros((batch, S_buf, Hkv, Dh), dtype=dtype,
                                   device=device))
        v = torch.zeros_like(k)
        if has_prefix:
            src = (shared.packed_kv if shared.is_packed else shared.kv)
            if src is not None:
                i = packed_i[l] if shared.is_packed else l
                write_seq(k, 0, src["k"][i].to(dtype))
                write_seq(v, 0, src["v"][i].to(dtype))
        entry = {"k": k, "v": v, "prefix": has_prefix,
                 "ctx_valid": sel[l] if has_prefix else False,
                 "ring": S_buf < max_len}
        if specs[l].cross_attn:
            entry["xk"] = place("xk", torch.zeros(
                (batch, cfg.encoder_seq, Hkv, Dh), dtype=dtype,
                device=device))
            entry["xv"] = torch.zeros_like(entry["xk"])
        layers.append(entry)
    cache = {"len": prefix_len, "layers": layers}
    kinds = [s.kind for s in layer_specs(cfg) if s.kind in SSM_KINDS]
    if kinds:
        cache["states"] = [
            _seed_state({k: place(k, z) for k, z in _init_state(
                cfg, kind, batch, device).items()}, shared, j)
            for j, kind in enumerate(kinds)]
    return cache


def _place(cfg: ModelConfig, mesh, batch: int, name: str, t):
    """A cache tensor as placed on ``mesh`` (unchanged without one)."""
    if mesh is None:
        return t
    return distribute(t, mesh, cache_placements(cfg, mesh, batch, name,
                                                t.shape))


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """The run spec of every executed layer, in layer-plan order (its
    kind, window and MoE flag)."""
    return [s for s in cfg.layer_plan() for _ in range(s.count)]


def _init_state(cfg, kind: str, batch: int, device) -> Dict[str, Any]:
    init = (ssm_mod.init_mamba_state if kind == "mamba"
            else ssm_mod.init_rwkv_state)
    return init(cfg, batch, device=device)


def _seed_state(st, shared, j: int):
    """SSM layer ``j``'s initial state: the sender's where ``state_select``
    flags the layer, zeros elsewhere, by the reference's blend
    ``z * (1 - w) + s * w``."""
    if shared is None or shared.states is None \
            or shared.state_select is None:
        return st
    w = float(bool(shared.state_select[j]))
    return {key: z * (1 - w) + shared.states[key][j].to(z) * w
            for key, z in st.items()}


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
    position, never by buffer offset). A cross-attention layer's ``xk`` /
    ``xv`` copy straight across. ``len`` stays the caller's."""
    for t_e, r_e in zip(table["layers"], row["layers"]):
        _insert_cross(t_e, r_e, slot)
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
        _insert_cross(t_e, r_e, slot)
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


def _insert_cross(t_e, r_e, slot: int) -> None:
    """A cross-attention layer's ``xk`` / ``xv`` row into the table."""
    for part in ("xk", "xv"):
        if part in t_e:
            t_e[part][slot] = r_e[part][0]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _ragged(cache, prefix_lens) -> bool:
    """Do the rows carry per-row lengths (continuous batching)?"""
    return prefix_lens is not None or (
        cache is not None and isinstance(cache["len"], torch.Tensor)
        and cache["len"].dim() > 0)


def _encoder_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                     on_mesh: bool = False):
    """Whisper's encoder over the stub frames (B, Senc, d): the additive
    sinusoid positions, non-causal attention layers without RoPE, gelu
    MLPs, the final norm."""
    enc = params["encoder"]
    x = frames.to(dtype_of(cfg))
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoid_positions(pos, cfg.d_model)[None].to(x.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in enc["layers"]:
        x = _run(functools.partial(_encoder_layer, cfg=cfg), lp, x,
                 remat=remat, on_mesh=on_mesh)
        if on_mesh:
            x = hints.shard_activations(x)
    if on_mesh:
        x = hints.gather_sequence(x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _encoder_layer(lp, x, *, cfg: ModelConfig):
    out, _, _ = attn_mod.self_attention(
        lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
        mode="train", causal=False, use_rope=False)
    x = x + reduce_partial(out)
    return x + reduce_partial(apply_mlp(
        lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), mlp_type(cfg)))


def _run(layer, lp, x, *, remat: bool, on_mesh: bool):
    """``layer(lp, x)``; with ``remat``, checkpointed (its activations are
    recomputed in the backward pass), as the reference checkpoints each
    layer run in training. ``on_mesh``: the layer starts as under ZeRO-3
    with sequence parallelism (``_gathered``)."""
    if on_mesh:
        layer = functools.partial(_gathered, layer)
    if remat:
        return checkpoint(layer, lp, x, use_reentrant=False)
    return layer(lp, x)


def _gathered(layer, lp, x):
    """``layer`` with its parameters gathered over the data axes (kept
    sharded over ``model``) and its input's sequence made whole."""
    return layer(unshard_data(lp), hints.gather_sequence(x))


def mesh_context(t: torch.Tensor):
    """``implicit_replication`` where ``t`` is a DTensor: the plain
    tensors the model makes (positions, masks, zero states) then act as
    replicated on its mesh. A null context for a plain tensor, and inside
    one already entered (``implicit_replication`` clears its flag on
    exit, so it does not nest)."""
    if isinstance(t, DTensor) and \
            not DTensor._op_dispatcher._allow_implicit_replication:
        return implicit_replication()
    return contextlib.nullcontext()


def _on_mesh(fn):
    """Run ``fn(params, ...)`` inside ``mesh_context`` of its
    parameters."""
    @functools.wraps(fn)
    def wrapper(params, *args, **kwargs):
        with mesh_context(params["embed"]):
            return fn(params, *args, **kwargs)
    return wrapper


@_on_mesh
def apply_model(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                mode: str = "train", cache=None, shared=None,
                extra: Optional[Dict[str, Any]] = None,
                collect_mass: bool = False, logits_mode: str = "all",
                capture_hidden: bool = False,
                inject: Optional[Dict[str, Any]] = None,
                prefix_lens: Optional[torch.Tensor] = None,
                decode_backend: str = "reference") -> ModelOut:
    """Forward over ``tokens`` (B, S). In ``cached`` mode the cache is
    updated in place and returned with ``len`` advanced by S.

    ``extra={"soft_embeds": (B, n, D), "soft_start": i}`` replaces the
    embeddings of positions [i, i + n) (CIPHER's soft tokens).
    ``capture_hidden`` returns each attention layer's last-token input in
    ``hiddens``, taken before any injection. ``inject={"vec": (L_attn, B,
    D), "mask": (L_attn,) bool, "mode": "replace" | "sum" | "mean"}``
    merges ``vec[l]`` into the last position's input of each flagged layer
    l (the AC baselines); it runs on the dense path only.
    ``extra={"frames": (B, Senc, d)}`` feeds whisper's encoder.

    On DTensor parameters (a mesh) the plain tensors it makes act as
    replicated (``mesh_context``), each layer's output and the logits
    take the layouts of ``distributed.hints``, and with ``cfg.remat``
    each layer of a training forward is checkpointed."""
    B, S = tokens.shape
    on_mesh = isinstance(params["embed"], DTensor)
    if shared is not None and shared.is_packed and mode != "cached":
        shared = shared.to_dense(cfg.attn_layer_count)
    flags = [False] * cfg.attn_layer_count
    if inject is not None:
        if shared is not None and shared.is_packed:
            raise ValueError("AC injection runs on the dense path")
        flags = [bool(f) for f in torch.as_tensor(inject["mask"]).tolist()]
    prefix_len = 0 if shared is None else shared.prefix_len
    zero_unsel = (shared is not None and prefix_len
                  and shared.pos_mode == "zero_unselected")
    if prefix_len == 0 or mode != "cached":
        prefix_lens = None
    audio = cfg.arch_type == "audio"
    if audio and _ragged(cache, prefix_lens):
        # per-row positions ride in RoPE; the additive sinusoid embed is
        # scalar-shift only (the reference asserts the same)
        raise ValueError(f"{cfg.name}: ragged (continuous-batching) rows "
                         "need a RoPE arch")
    cache_len = cache["len"] if cache is not None else 0
    # cross-attention reads the encoder's output everywhere but at a
    # cached one-token step, which reuses the layer's xk / xv
    use_enc = not (mode == "cached" and S == 1)
    enc_out = None
    if (cfg.encoder_layers and use_enc and extra is not None
            and "frames" in extra):
        enc_out = _encoder_forward(params, cfg, extra["frames"], on_mesh)
    if use_enc and enc_out is None and cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: cross-attention needs the encoder's "
                         "frames (extra={'frames': (B, Senc, d)})")
    x = (local_embedding(tokens, unshard_data(params["embed"])) if on_mesh
         else params["embed"][tokens])
    if cfg.num_patches and extra is not None and "patches" in extra:
        pe = extra["patches"].to(x.dtype)
        x[:, :pe.shape[1]] = pe
    if extra is not None and "soft_embeds" in extra:
        se = extra["soft_embeds"].to(x.dtype)
        start = extra.get("soft_start", 0)
        x[:, start:start + se.shape[1]] = se
    if audio:      # whisper's decoder: additive sinusoid positions
        pos = (cache_len if mode == "cached" else 0) + torch.arange(
            S, device=x.device)
        x = x + sinusoid_positions(pos, cfg.d_model)[None].to(x.dtype)
    masses: List[torch.Tensor] = []
    hiddens: List[torch.Tensor] = []
    states = cache.get("states") if cache is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    l = j = 0                       # attention and SSM layer indices
    for spec, lp in zip(layer_specs(cfg), params["layers"]):
        kind = spec.kind
        if kind in SSM_KINDS:
            st = (states[j] if states is not None
                  else _init_state(cfg, kind, B, x.device))
            x, new_st = _run(functools.partial(
                _ssm_layer, cfg=cfg, kind=kind, st=st, mode=mode), lp, x,
                remat=remat, on_mesh=on_mesh)
            if on_mesh:
                x = hints.shard_activations(x)
            if states is not None:
                states[j] = new_st
            j += 1
            continue
        if capture_hidden:
            hiddens.append(x[:, -1, :])
        if flags[l]:
            vec, last = inject["vec"][l].to(x.dtype), x[:, -1, :]
            x = x.clone()
            x[:, -1, :] = {"replace": vec, "sum": last + vec,
                           "mean": 0.5 * (last + vec)}[inject["mode"]]
        if mode == "cached":
            entry = cache["layers"][l]
            has_prefix, sel = entry["prefix"], entry["ctx_valid"]
        else:
            entry, has_prefix = None, False
            sel = (shared is not None and shared.select is not None
                   and bool(shared.select[l]))
        # positional shift: the real prefix length (paper default), or 0
        # on unselected layers under KVComm-S (zero_unselected)
        keep = sel or not zero_unsel
        if prefix_lens is not None:
            shift = prefix_lens if keep else torch.zeros_like(prefix_lens)
        else:
            shift = prefix_len if keep else 0
        pfx = prefix_len if has_prefix else 0
        attn_kw = dict(
            mode=mode, causal=spec.causal, use_rope=not audio,
            window=spec.window, pos_shift=shift,
            prefix_len=pfx, shared_prefix_len=prefix_len,
            ctx_valid=sel if has_prefix else None,
            cache_k=entry["k"] if entry else None,
            cache_v=entry["v"] if entry else None,
            cache_len=(cache_len if has_prefix
                       else cache_len - prefix_len) if entry else None,
            prefix_lens=prefix_lens if has_prefix else None,
            collect_mass=collect_mass, backend=decode_backend)
        x, mass, layer_aux = _run(functools.partial(
            _attn_layer, cfg=cfg, spec=spec, attn_kw=attn_kw, entry=entry,
            enc_out=enc_out), lp, x, remat=remat, on_mesh=on_mesh)
        if on_mesh:
            x = hints.shard_activations(x)
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect_mass:
            masses.append(mass if mass is not None else
                          torch.zeros((B,), dtype=torch.float32,
                                      device=x.device))
        l += 1
    if on_mesh:
        x = hints.gather_sequence(x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:, :]
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if on_mesh:
        head = unshard_data(head)
    logits = (x @ (head.T if cfg.tie_embeddings else head)).float()
    if on_mesh:
        logits = hints.shard_logits(logits)
    new_cache = None
    if mode == "cached":
        new_cache = {"len": cache_len + S, "layers": cache["layers"]}
        if states is not None:
            new_cache["states"] = states
    return ModelOut(logits=logits, cache=new_cache,
                    masses=torch.stack(masses) if masses else None,
                    aux_loss=aux,
                    hiddens=torch.stack(hiddens) if hiddens else None)


def _attn_layer(lp, x, *, cfg: ModelConfig, spec: LayerSpec, attn_kw, entry,
                enc_out):
    """One attention layer with its residuals (self-attention, whisper's
    cross-attention, the MLP or MoE); returns (x, Eq. (1) mass or None,
    MoE aux loss or None)."""
    out, _, mass = attn_mod.self_attention(
        lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), **attn_kw)
    x = x + reduce_partial(out)
    if spec.cross_attn:
        x = x + reduce_partial(_cross_layer(lp, cfg, x, entry, enc_out))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if spec.moe:
        ffn, layer_aux = (local_moe if isinstance(h, DTensor)
                          else apply_moe)(lp["moe"], h, cfg)
    else:
        ffn, layer_aux = apply_mlp(lp["mlp"], h, mlp_type(cfg)), None
    return x + reduce_partial(ffn), mass, layer_aux


def _cross_layer(lp, cfg: ModelConfig, x, entry, enc_out):
    """One decoder layer's cross-attention output. With ``enc_out`` the
    layer's cross KV is projected from it (and kept in a cached layer's
    ``xk`` / ``xv``); without, a cached layer reuses its own."""
    if enc_out is not None:
        xk, xv = attn_mod.cross_kv(lp["xattn"], cfg, enc_out)
        if entry is not None:
            entry["xk"], entry["xv"] = xk, xv
    else:
        xk, xv = entry["xk"], entry["xv"]
    return attn_mod.cross_attention(
        lp["xattn"], cfg, rms_norm(x, lp["ln_x"], cfg.norm_eps), xk, xv)


def _ssm_layer(lp, x, *, cfg: ModelConfig, kind: str, st, mode: str):
    """One Mamba2 or RWKV6 layer with its residuals; returns (x, new
    state)."""
    if kind == "mamba":
        out, new_st = ssm_mod.apply_mamba(
            lp["mamba"], cfg, rms_norm(x, lp["ln"], cfg.norm_eps), st,
            mode=mode)
        return x + reduce_partial(out), new_st
    r = lp["rwkv"]
    tm_out, new_wkv, new_tmx = ssm_mod.rwkv_time_mix(
        r, cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), st)
    x = x + reduce_partial(tm_out)
    cm_out, new_cmx = ssm_mod.rwkv_channel_mix(
        r, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps), st)
    return x + reduce_partial(cm_out), {"cm_x": new_cmx, "tm_x": new_tmx,
                                        "wkv": new_wkv}
