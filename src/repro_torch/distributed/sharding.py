"""Sharding rules of the port (the counterpart of the reference's
``distributed/sharding.py``), placed as DTensors.

Strategy, as the reference's:
  * Parameters are 2D-sharded: the matmul output/feature dim over ``model``
    (Megatron TP), a second large dim over the data axes (FSDP/ZeRO-3).
  * GQA caveat: wq/wk/wv columns are TP-sharded only when the
    corresponding head count divides the model-axis size; otherwise they
    stay replicated column-wise (starcoder2's 36 q-heads).
  * MoE experts shard over ``model`` when divisible (olmoe 64), else each
    expert's d_ff is TP-sharded (mixtral 8).
  * Decode caches shard batch over data; KV heads over model when
    divisible, else the cache *sequence* over model. long_500k (batch 1)
    shards the sequence over data x model jointly.

A spec is a tuple with the structure of the reference's
``PartitionSpec``: one entry per tensor dim, each ``None``, a mesh axis
name or a tuple of names (major to minor). ``param_spec`` takes the
reference's leaf name and *stacked* shape (a run's leading layer axis),
so its rules are the reference's verbatim; ``param_specs`` maps them onto
the port's per-layer tree and drops the stacked axis (always ``None``).
``to_placements`` turns a spec into DTensor placements: a dim over
several axes is ``Shard`` on each, which DTensor splits in mesh order,
the order JAX gives ("data" major, then "model").

A mesh here is a ``DeviceMesh``, or for the spec functions anything with
its ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.layers import (_capacity, attention_core,
                                       attention_core_chunked,
                                       attention_partials, combine_weights,
                                       dropping_groups, expert_sum, route)
from repro_torch.training.optimizer import tree_map
from repro_torch.utils.costs import count_backward, shard_scope


def _div(n: int, size: int) -> bool:
    return n % size == 0 and n >= size


def param_spec(cfg: ModelConfig, name: str, shape, *, dp, tp,
               tp_size: int) -> tuple:
    """The spec of one parameter leaf. ``name`` is the leaf key and
    ``shape`` its stacked shape in the reference's tree."""
    nd = len(shape)
    lead = (None,) * (nd - 2)  # stacked layer axes

    def fits(axis_size_dim):
        return _div(shape[axis_size_dim], tp_size)

    # --- embeddings / head ---
    if name == "embed":
        return (tp, dp)
    if name == "lm_head":
        return (dp, tp)

    # --- MoE expert banks: (n, E, D, F) / (n, E, F, D) ---
    if nd == 4 and name in ("w_gate", "w_up", "w_down"):
        E = shape[1]
        if _div(E, tp_size):
            return (None, tp, dp, None)
        if name == "w_down":
            return (None, None, tp, dp)
        return (None, None, dp, tp)
    if name == "router":
        return (*lead, dp, None)

    # --- attention projections ---
    if name in ("wq", "bq"):
        ok = _div(cfg.num_heads, tp_size)
        if nd >= 2:
            return (*lead, dp, tp if ok else None)
        return (*lead, tp if ok else None)
    if name in ("wk", "wv", "bk", "bv") and cfg.num_kv_heads:
        ok = _div(cfg.num_kv_heads, tp_size)
        # rwkv reuses "wk"/"wv" names but has num_kv_heads == 0
        if nd >= 2:
            return (*lead, dp, tp if ok else None)
        return (*lead, tp if ok else None)
    if name == "wo":
        ok = _div(cfg.num_heads, tp_size)
        return (*lead, tp if ok else None, dp)

    # --- generic in->out projections (mlp, rwkv, mamba in) ---
    if name in ("w_gate", "w_up", "cm_wk", "cm_wr", "wr", "wk", "wv", "wg",
                "w_in"):
        return (*lead, dp, tp if fits(nd - 1) else None)
    if name in ("w_down", "cm_wv", "w_out"):
        return (*lead, tp if fits(nd - 2) else None, dp)
    if name == "w_lora_a":
        return (*lead, dp, None)
    if name == "w_lora_b":
        return (*lead, None, dp)
    if name == "conv_w":
        return (*lead, None, tp if fits(nd - 1) else None)
    if name in ("conv_b", "norm"):
        return (*lead, tp if fits(nd - 1) else None)
    if name == "u":  # (n, H, hd)
        return (*lead, tp if _div(shape[-2], tp_size) else None, None)

    # norms / small vectors: replicate
    return ()


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _sanitize(spec, shape, mesh) -> tuple:
    """Clear spec entries whose mesh-axis size doesn't divide the dim."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        out.append(ax if shape[i] % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


def _drop_lead(spec, n: int) -> tuple:
    """The spec of one layer of a stack: the first ``n`` (stacked) entries
    dropped (a spec shorter than the stack replicates what it omits)."""
    return tuple(spec[n:])


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh axis that dim's entry names, ``Replicate()`` elsewhere. The axes
    of one entry must come in mesh order (JAX's major-to-minor order is
    then DTensor's)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _stacked(cfg: ModelConfig, params) -> Dict[int, tuple]:
    """id of each parameter tensor -> (leaf name, its shape in the
    reference's tree): a run's layers stack on a leading axis of the
    run's count, the encoder's on one of its depth; Zamba2's shared block
    and the top-level leaves are not stacked."""
    out: Dict[int, tuple] = {}

    def walk(tree, lead):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, lead)
            elif isinstance(v, torch.Tensor):
                out.setdefault(id(v), (k, lead + tuple(v.shape)))

    walk({k: v for k, v in params.items()
          if k not in ("layers", "encoder")}, ())
    i = 0
    for spec in cfg.layer_plan():
        if spec.kind != "shared_attn":
            for lp in params["layers"][i:i + spec.count]:
                walk(lp, (spec.count,))
        i += spec.count
    if "encoder" in params:
        enc = params["encoder"]
        for lp in enc["layers"]:
            walk(lp, (len(enc["layers"]),))
        walk({"final_norm": enc["final_norm"]}, ())
    return out


def param_specs(cfg: ModelConfig, mesh, params, *,
                placements: bool = False) -> Any:
    """The spec of every leaf of the port's parameter tree (or of a tree
    of its layout: gradients, moments): the reference's rule on the
    leaf's stacked shape, sanitized there, the stacked axis dropped; with
    ``placements``, as DTensor placements on ``mesh``."""
    dp, tp = mesh_axes(mesh)
    tp_size = _axis_sizes(mesh)["model"]
    stacked = _stacked(cfg, params)

    def rule(t):
        name, shape = stacked[id(t)]
        spec = _drop_lead(_sanitize(param_spec(
            cfg, name, shape, dp=dp, tp=tp, tp_size=tp_size), shape, mesh),
            len(shape) - t.dim())
        return to_placements(spec, mesh) if placements else spec

    return tree_map(rule, params)


def param_shardings(cfg: ModelConfig, mesh, params) -> Any:
    """``param_specs`` as DTensor placements on ``mesh``."""
    return param_specs(cfg, mesh, params, placements=True)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------
def batch_spec(mesh, global_batch: int) -> tuple:
    """Shard batch over as many data axes as divide it."""
    dp, _ = mesh_axes(mesh)
    if global_batch % _axis_size(mesh, dp) == 0:
        return (dp,)
    if isinstance(dp, tuple) and global_batch % _axis_sizes(mesh)[
            "data"] == 0:
        return ("data",)
    return (None,)


def input_shardings(cfg: ModelConfig, mesh, shape: InputShape,
                    batch) -> Dict[str, tuple]:
    """Placements of a batch dict: batch over the data axes."""
    bspec = batch_spec(mesh, shape.global_batch)
    return {k: to_placements(_sanitize(
        (bspec[0],) + (None,) * (v.dim() - 1), tuple(v.shape), mesh), mesh)
        for k, v in batch.items()}


def _cache_spec(cfg: ModelConfig, mesh, B: int, name: str, shape) -> tuple:
    """The reference's rule for one stacked cache leaf: (n, B, S, Hkv, Dh)
    KV buffers, SSM states (n, B, ...)."""
    dp, tp = mesh_axes(mesh)
    tp_size = _axis_sizes(mesh)["model"]
    long_ctx = B < _axis_size(mesh, dp)   # long_500k: batch unshardable
    kv_head_ok = cfg.num_kv_heads and _div(cfg.num_kv_heads, tp_size)
    nd = len(shape)
    if nd == 5 and name in ("k", "v", "xk", "xv"):
        if long_ctx:
            # batch 1: context-parallel, the cache sequence over
            # data x model jointly
            return _sanitize((None, None, ("data", "model"), None, None),
                             shape, mesh)
        if kv_head_ok:
            return _sanitize((None, dp, None, tp, None), shape, mesh)
        return _sanitize((None, dp, tp, None, None), shape, mesh)
    if nd >= 3:
        spec = [None, None if long_ctx else dp] + [None] * (nd - 2)
        if nd >= 4 and shape[2] % tp_size == 0:
            spec[2] = tp   # heads over model
        return _sanitize(tuple(spec), shape, mesh)
    return ()


def cache_placements(cfg: ModelConfig, mesh, batch: int, name: str,
                     shape) -> tuple:
    """Placements of one per-layer cache tensor (``k`` / ``v`` / ``xk`` /
    ``xv`` of (B, S, Hkv, Dh), or an SSM state leaf of (B, ...)): the
    reference's 5-D rule on the tensor stacked once, its ``n`` axis
    dropped."""
    spec = _cache_spec(cfg, mesh, batch, name, (1,) + tuple(shape))
    return to_placements(_drop_lead(spec, 1), mesh)


def cache_shardings(cfg: ModelConfig, mesh, shape: InputShape,
                    cache) -> Any:
    """Placements of the port's serving cache (per-layer ``layers`` and
    ``states``), or of a stacked {"k", "v"}: (L, B, S, Hkv, Dh) payload;
    ``None`` for every leaf that is not a tensor."""
    B = shape.global_batch

    def walk(node, name, per_layer):
        if isinstance(node, dict):
            return {k: walk(v, k, per_layer or k in ("layers", "states"))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, per_layer) for v in node]
        if not isinstance(node, torch.Tensor):
            return None
        if per_layer:
            return cache_placements(cfg, mesh, B, name, node.shape)
        return to_placements(_cache_spec(cfg, mesh, B, name, node.shape),
                             mesh)

    return walk(cache, None, False)


def replicated(mesh, tree) -> Any:
    """Every tensor of ``tree`` replicated on ``mesh``."""
    return tree_map(lambda t: (Replicate(),) * mesh.ndim, tree)


# ---------------------------------------------------------------------------
# placing and gathering
# ---------------------------------------------------------------------------
def distribute(tree, mesh, shardings) -> Any:
    """Every tensor of ``tree`` as a DTensor with its placements from the
    matching ``shardings`` leaf (other leaves, and tensors whose leaf is
    ``None``, pass through). Every rank must hold the same full tensors
    (the same seed): each keeps its own shards, with no communication. A
    tensor that sits in the tree more than once (Zamba2's shared block)
    becomes one DTensor."""
    def place(t, pl):
        if not isinstance(t, torch.Tensor) or pl is None:
            return t
        return distribute_tensor(t, mesh, pl, src_data_rank=None)
    return tree_map(place, tree, shardings)


def gather(tree) -> Any:
    """Every DTensor of ``tree`` as its full tensor (on every rank)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def unshard_data(tree) -> Any:
    """Each DTensor of ``tree`` gathered over the data axes (its shards
    over ``model`` kept): ZeRO-3's just-in-time all-gather of a layer's
    parameters, whose backward reduce-scatters their gradients. Every
    product then contracts whole rows, in the unsharded order. Plain
    tensors pass through."""
    def gather_dp(t):
        if not isinstance(t, DTensor):
            return t
        dp, _ = mesh_axes(t.device_mesh)
        dp = (dp,) if isinstance(dp, str) else dp
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in dp and p.is_shard() else p
                   for n, p in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)
    return tree_map(gather_dp, tree)


def write_seq(buf: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``buf[:, start:start + n] = new`` in place (n = new.shape[1]), on a
    plain tensor or a DTensor. A DTensor's ``new`` is first laid out as
    ``buf`` with its dim 1 whole; where ``buf``'s dim 1 (the cache
    sequence) is sharded, each rank writes the part of the window that
    falls in its own rows."""
    if not isinstance(buf, DTensor):
        buf[:, start:start + new.shape[1]] = new
        return
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    want = tuple(Replicate() if p == Shard(1) else p for p in pl)
    new = _replicated(new, mesh).redistribute(mesh, want)
    if want == pl:
        buf[:, start:start + new.shape[1]] = new
        return
    shape, off = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    lo = max(start, off[1])
    hi = min(start + new.shape[1], off[1] + shape[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1]:hi - off[1]] = \
            new.to_local()[:, lo - start:hi - start]


def mesh_of(tensor: torch.Tensor):
    """The device mesh of a DTensor, None for a plain tensor."""
    return tensor.device_mesh if isinstance(tensor, DTensor) else None


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending (partial) reductions carried out, its shards
    kept; a plain tensor unchanged. Its gradient's pending reductions are
    carried out too, as Megatron all-reduces a sublayer's input gradient:
    left pending, a partial gradient reaching a row-parallel product makes
    DTensor gather the whole weight there instead. Used after a
    row-parallel product (before the residual add) and where a
    shard-by-shard result is a sum over shards."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    return _ReducePartial.apply(t)


def _carried_out(t: DTensor) -> DTensor:
    pl = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


class _ReducePartial(torch.autograd.Function):
    """Pending reductions carried out, forward and backward."""

    @staticmethod
    def forward(ctx, t):
        return _carried_out(t)

    @staticmethod
    def backward(ctx, grad):
        return _carried_out(grad) if isinstance(grad, DTensor) else grad


def local_attention(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                    mass_mask=None, blk_q=None, **kw):
    """The attention core (``layers.attention_core``, or its query-blocked
    form with ``blk_q``) on DTensor q (B, Sq, Hq, D), k / v (B, Skv, Hkv,
    D), shard by shard. Batch goes over the data axes. ``model`` splits
    the work, in this order of preference: the KV heads with their query
    heads where Hkv divides it; the query heads alone where Hq does (each
    shard takes the KV heads of its own query heads from the whole k /
    v); the query rows where Sq does (each shard attends from its own
    rows over the whole k / v). In the last two the k / v gradients are
    partial sums over ``model``. Every shard computes whole rows of
    softmax; the Eq. (1) mass, a mean over heads and rows, is the mean of
    the shards' means. A sequence-sharded KV (a cache) stays in
    place: each shard attends over its own positions (``attention_partials``)
    and the shards merge by log-sum-exp (``_merge_partials``). Positions
    and masks are plain 1-D tensors (uniform rows), the same on every
    rank."""
    mesh = q.device_mesh
    if any(t is not None and t.dim() != 1
           for t in (q_pos, kv_pos, kv_valid, mass_mask)):
        raise NotImplementedError("attention on a mesh takes uniform rows "
                                  "(1-D positions and masks)")
    _, tp = mesh_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    k, v = _replicated(k, mesh), _replicated(v, mesh)
    sax = tuple(n for n, p in zip(names, k.placements) if p == Shard(1))
    bax = batch_spec(mesh, q.shape[0])[0]
    if bax is not None and set((bax,) if isinstance(bax, str) else bax) \
            & set(sax):
        bax = None
    Sq, Hq, Hkv = q.shape[1], q.shape[2], k.shape[2]
    tp_size = _axis_size(mesh, tp)
    split = None
    if tp not in sax:
        split = ("kv" if Hkv % tp_size == 0 else
                 "q" if Hq % tp_size == 0 else
                 "rows" if Sq > 1 and Sq % tp_size == 0 else None)
    hax = tp if split else None
    q_pl = to_placements((bax, hax if split == "rows" else None,
                          None if split == "rows" else hax, None), mesh)
    kv_pl = to_placements((bax, sax or None, hax if split == "kv" else None,
                           None), mesh)
    kv_grad = tuple(Partial() if split in ("q", "rows") and n == tp else p
                    for n, p in zip(names, kv_pl))
    region = [_axis_size(mesh, bax) * _axis_size(mesh, hax)
              * _axis_size(mesh, sax or None), 0]
    pick = _kv_heads_of(Hq, Hkv, Hq // tp_size,
                        mesh.get_local_rank(tp)) if split == "q" else None
    if split == "rows":
        n = Sq // tp_size
        q_pos = q_pos[mesh.get_local_rank(tp) * n:][:n]
    if sax:
        # this rank's slice of the sequence and of the 1-D masks over it
        shape, off = compute_local_shape_and_global_offset(
            k.shape, mesh, kv_pl)
        lo, hi = off[1], off[1] + shape[1]
        kv_pos, kv_valid, mass_mask = (
            None if t is None else t[lo:hi]
            for t in (kv_pos, kv_valid, mass_mask))

    def fn(q, k, v, q_pos, kv_pos, kv_valid, mass_mask):
        if pick is not None:
            k, v = pick(k), pick(v)
        args = dict(q_pos=q_pos, kv_pos=kv_pos, kv_valid=kv_valid,
                    mass_mask=mass_mask, **kw)
        with shard_scope(region):
            if sax:       # unmerged, stacked on a leading shard axis
                return tuple(None if t is None else t[None] for t in
                             attention_partials(q, k, v, blk_q=blk_q,
                                                **args))
            if blk_q:
                return attention_core_chunked(q, k, v, blk_q=blk_q, **args)
            return attention_core(q, k, v, **args)

    mass_pl = [Replicate()] * mesh.ndim
    for a in () if bax is None else (bax,) if isinstance(bax, str) else bax:
        mass_pl[names.index(a)] = Shard(0)
    if hax is not None:
        mass_pl[names.index(hax)] = Partial("avg")
    if sax:
        part = to_placements((sax, bax, None, None), mesh)
        outs = (to_placements((sax, bax, None, None, None), mesh), part,
                part, None if mass_mask is None else part)
    else:
        outs = (q_pl, None if mass_mask is None else tuple(mass_pl))
    out = local_map(
        fn, out_placements=outs,
        in_placements=(q_pl, kv_pl, kv_pl, None, None, None, None),
        in_grad_placements=(q_pl, kv_grad, kv_grad, None, None, None, None),
        device_mesh=mesh, redistribute_inputs=True)(
            _replicated(q, mesh), k, v, q_pos, kv_pos, kv_valid, mass_mask)
    if sax:
        return _merge_partials(*out, dtype=q.dtype)
    count_backward(out[0], 2 * region[1])
    if split == "rows":
        # the rows made whole again: the output projection flattens
        # (B, S), which DTensor refuses over a sharded S
        out = (out[0].redistribute(mesh, to_placements(
            (bax, None, None, None), mesh)), out[1])
    return out


def _kv_heads_of(Hq: int, Hkv: int, n: int, r: int):
    """For query heads [r n, r n + n) of Hq (groups of G = Hq / Hkv), the
    map from the whole k / v (B, S, Hkv, D) to their KV heads: a slice
    where the heads fall in whole groups, else one KV head per query head
    (G 1)."""
    G = Hq // Hkv
    a = r * n
    if G % n == 0 or n % G == 0:
        lo, hi = a // G, (a + n - 1) // G + 1
        return lambda t: t[:, :, lo:hi]
    idx = [(a + i) // G for i in range(n)]
    return lambda t: t[:, :, idx]


def _merge_partials(o, m, l, mf, *, dtype):
    """Shards' ``attention_partials`` stacked on axis 0 (sharded over the
    sequence's mesh axes) merged by log-sum-exp: weights exp(m - max m) *
    l over their sum. Returns (out (B, Sq, Hq, D) in ``dtype``, the Eq.
    (1) mass (B,) or None), with pending sums carried out."""
    M = m.amax(0, keepdim=True)
    a = torch.exp(m - M) * l
    w = a / a.sum(0, keepdim=True)
    out = reduce_partial((o.float() * w[..., None]).sum(0)).to(dtype)
    mass = None
    if mf is not None:
        mass = reduce_partial((mf * w).sum(0)).mean((1, 2))
    return out, mass


def local_wkv(scan, r, k, v, w, u, state):
    """The RWKV6 WKV scan on DTensor r / k / v / w (B, T, H, hd), u (H, hd)
    and state (B, H, hd, hd), shard by shard: the recurrence is
    independent per (batch row, head), so batch goes over the data axes
    and heads over ``model`` where they divide."""
    mesh = r.device_mesh
    dp, tp = mesh_axes(mesh)
    bax = batch_spec(mesh, r.shape[0])[0]
    hax = tp if r.shape[2] % _axis_size(mesh, tp) == 0 else None
    seq = to_placements((bax, None, hax, None), mesh)
    st = to_placements((bax, hax, None, None), mesh)
    u_pl = to_placements((hax, None), mesh)
    region = [_axis_size(mesh, bax) * _axis_size(mesh, hax), 0]

    def fn(*args):
        with shard_scope(region):
            return scan(*args)

    # each batch shard's gradient of u is a part of the sum over the batch
    u_grad = tuple(Partial() if p == Shard(0) else u
                   for p, u in zip(to_placements((bax,), mesh), u_pl))
    out = local_map(
        fn, out_placements=(seq, st),
        in_placements=(seq, seq, seq, seq, u_pl, st),
        in_grad_placements=(seq, seq, seq, seq, u_grad, st),
        device_mesh=mesh, redistribute_inputs=True)(
            *(_replicated(t, mesh) for t in (r, k, v, w, u, state)))
    count_backward(out[0], 2 * region[1])
    return out


def local_moe(p, x, cfg):
    """``layers.apply_moe`` on DTensor x (B, S, D) and expert banks, shard
    by shard: each batch shard routes its own tokens, and each ``model``
    shard runs the experts it holds (experts over ``model``) or its slice
    of every expert's d_ff, so the output is a partial sum over
    ``model``. ``dropping`` needs whole token groups on a batch shard
    (its groups divisible by the batch shards), else the batch is made
    whole first. The load-balance loss needs the means over every token:
    ``dense_all`` returns each shard's means over its tokens, scaled to
    sum to the whole batch's; ``dropping`` each group's loss. Where the
    experts are split over ``model`` the loss's terms come from ``model``
    rank 0 only (zeros elsewhere, a sum over ``model``), so its gradient
    is taken once."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    _, tp = mesh_axes(mesh)
    E, k = p["router"].shape[-1], cfg.num_experts_per_tok
    dropping = cfg.moe_impl == "dropping"
    bax = batch_spec(mesh, x.shape[0])[0]
    if dropping:
        G, n, C = _capacity(x, k, E, cfg.moe_capacity_factor, cfg.moe_groups)
        if G % _axis_size(mesh, bax):
            bax = None
    x_pl = to_placements((bax, None, None), mesh)
    w_pl = {n_: tuple(t.placements) for n_, t in p.items()}
    split = any(pl.is_shard() for n_, pl in zip(names, w_pl["w_gate"])
                if n_ == tp)
    e0 = compute_local_shape_and_global_offset(
        p["w_gate"].shape, mesh, w_pl["w_gate"])[1][0]
    first = 1.0 if not split or mesh.get_local_rank(tp) == 0 else 0.0
    shards = _axis_size(mesh, bax)
    batch = tuple(pl.is_shard() for pl in x_pl)
    # the output and the gradients of x and the router: partial sums over
    # model where the experts are split there; the weights' gradients:
    # partial sums over the batch shards
    out_pl = tuple(Partial() if split and n_ == tp else pl
                   for n_, pl in zip(names, x_pl))
    w_grad = {k_: tuple(Partial() if b or (split and n_ == tp
                                           and pl.is_replicate()) else pl
                        for n_, b, pl in zip(names, batch, w))
              for k_, w in w_pl.items()}
    # means over the batch shards as sums of pre-scaled terms: a partial
    # mean's gradient reaches each shard undivided
    loss_pl = tuple(Partial() if b or (split and n_ == tp) else Replicate()
                    for n_, b in zip(names, batch))
    frac_pl = tuple(Partial() if b else Replicate() for b in batch)
    keys = sorted(p)
    route_region = [_axis_size(mesh, bax), 0]
    region = [_axis_size(mesh, bax) * (_axis_size(mesh, tp) if split else 1),
              0]

    def fn(x, *w):
        lp = dict(zip(keys, w))
        B, S, D = x.shape
        if dropping:
            xg = x.reshape(-1, n, D)
            with shard_scope(region):
                out, auxes = dropping_groups(lp, xg, k, C, e0)
            return out.reshape(B, S, D), auxes * first
        with shard_scope(route_region):
            gates, idx, me, ce = route(lp, x, k)
            comb = combine_weights(gates, idx, lp)
        with shard_scope(region):
            Ep = lp["w_gate"].shape[0]
            out = expert_sum(lp, x, comb[..., e0:e0 + Ep])
        return out, me * (first / shards), ce / shards

    group_pl = tuple(Partial() if split and n_ == tp else pl for n_, pl in
                     zip(names, to_placements((bax,), mesh)))
    outs = ((out_pl, group_pl) if dropping else
            (out_pl, loss_pl, frac_pl))
    res = local_map(
        fn, out_placements=outs,
        in_placements=(x_pl, *(w_pl[n_] for n_ in keys)),
        in_grad_placements=(out_pl, *(w_grad[n_] for n_ in keys)),
        device_mesh=mesh, redistribute_inputs=True)(
            x, *(p[n_] for n_ in keys))
    count_backward(res[0], 2 * (region[1] + route_region[1]))
    if dropping:
        return res[0], reduce_partial(res[1]).mean()
    me, ce = reduce_partial(res[1]), reduce_partial(res[2])
    return res[0], E * torch.sum(me * ce)


def _replicated(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor (the same on every rank) as a replicated DTensor; a
    DTensor unchanged."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def local_embedding(tokens, embed) -> DTensor:
    """``embed[tokens]`` on DTensors, shard by shard: tokens (B, S) batch
    over the data axes, the table's vocabulary over ``model`` (or whole);
    each rank looks up the tokens its vocabulary rows hold and zeros the
    rest, and the sum over ``model`` is carried out (one term is
    non-zero, so the result is the plain lookup's, bit for bit). The
    table's gradient is a shard of the sum over the batch shards."""
    mesh = embed.device_mesh
    names = tuple(mesh.mesh_dim_names)
    _, tp = mesh_axes(mesh)
    bax = batch_spec(mesh, tokens.shape[0])[0]
    V = embed.shape[0]
    vax = tp if V % _axis_size(mesh, tp) == 0 else None
    tok_pl = to_placements((bax, None), mesh)
    emb_pl = to_placements((vax, None), mesh)
    emb_grad = tuple(Partial() if t == Shard(0) else e
                     for t, e in zip(tok_pl, emb_pl))
    out_pl = tuple(Partial() if n == vax else p
                   for n, p in zip(names, to_placements((bax, None, None),
                                                         mesh)))
    v_loc = V // _axis_size(mesh, vax)
    start = (mesh.get_local_rank(vax) if vax else 0) * v_loc

    def fn(tok, emb):
        hit = (tok >= start) & (tok < start + v_loc)
        rows = emb[(tok - start).clamp(0, v_loc - 1)]
        return (rows * hit[..., None].to(rows.dtype),)

    return reduce_partial(local_map(
        fn, out_placements=(out_pl,), in_placements=(tok_pl, emb_pl),
        in_grad_placements=(tok_pl, emb_grad), device_mesh=mesh,
        redistribute_inputs=True)(_replicated(tokens, mesh), embed)[0])


def local_nll(logits, targets) -> DTensor:
    """-log softmax(logits)[targets] for DTensor logits (B, S, V), shard by
    shard (Megatron's vocabulary-parallel cross-entropy where the
    vocabulary is sharded): each shard returns the log-sum-exp of its
    logits and the logit of each target it holds (0 for the others); the
    shards' log-sum-exps merge by log-sum-exp, and no shard holds the
    whole vocabulary. With one vocabulary shard every step is the plain
    cross-entropy's, to the bit. (DTensor's own gather would make a
    gradient of the whole batch's logits on every rank.) Returns (B, S)
    with its batch placements."""
    mesh = logits.device_mesh
    pl = tuple(logits.placements)
    V = logits.dim() - 1
    shape, off = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                       pl)
    lo, n = off[V], shape[V]
    tok_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    part = tuple(Shard(0) if p.is_shard(V) else
                 Shard(1) if p.is_shard(0) else Replicate() for p in pl)

    def fn(lg, tg):
        hit = (tg >= lo) & (tg < lo + n)
        gold = torch.gather(lg, -1, (tg - lo).clamp(0, n - 1)[..., None])
        return (torch.logsumexp(lg, dim=-1)[None],
                (gold[..., 0] * hit.to(lg.dtype))[None])

    lse, gold = local_map(
        fn, out_placements=(part, part), in_placements=(pl, tok_pl),
        in_grad_placements=(pl, tok_pl), device_mesh=mesh,
        redistribute_inputs=True)(logits, _replicated(targets.long(), mesh))
    return reduce_partial(torch.logsumexp(lse, dim=0) - gold.sum(0))
