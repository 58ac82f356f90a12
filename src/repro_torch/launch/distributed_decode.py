"""Sequence-sharded decode: the receiver decodes against a KV cache split
into shards along the sequence, combining per-shard flash-decode partials
with the log-sum-exp rule instead of ever gathering the cache.

``sharded_decode`` computes the shards one after the other on one device,
each through ``ops.decode_attention_partials``, and merges them with
``combine_decode_partials``; ``run`` checks the result against the
monolithic ``ops.decode_attention`` over the whole cache.

    PYTHONPATH=src python -m repro_torch.launch.distributed_decode
    PYTHONPATH=src python -m repro_torch.launch.distributed_decode --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def make_inputs(B: int, Hq: int, Hkv: int, D: int, S_total: int,
                seed: int = 0):
    """q (B, Hq, D) and k, v (B, S_total, Hkv, D), float32 numpy arrays
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S_total, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S_total, Hkv, D), dtype=np.float32)
    return q, k, v


def sharded_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: torch.Tensor, n_shards: int):
    """Decode q (B, Hq, D) against k, v (B, S, Hkv, D) split into
    ``n_shards`` equal shards along S; ``kv_len`` (B,) counts each row's
    valid entries. Returns the LSE-combined float32 output (B, Hq, D) and
    each shard's (o, m, l) partials."""
    S = k.shape[1]
    if S % n_shards:
        raise ValueError(f"S_total {S} is not a multiple of "
                         f"n_shards {n_shards}")
    per = S // n_shards
    # shard i holds positions [i*per, (i+1)*per): its rows' valid entries
    parts = [ops.decode_attention_partials(
        q, k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per],
        (kv_len - i * per).clamp(0, per)) for i in range(n_shards)]
    combined = ops.combine_decode_partials(
        *(torch.stack(x) for x in zip(*parts)))
    return combined, parts


def run(B: int = 2, Hq: int = 8, Hkv: int = 2, D: int = 64,
        S_total: int = 4096, n_shards: int = 8, dtype: str = "float32",
        device=None, seed: int = 0,
        kv_len: Optional[np.ndarray] = None) -> Dict:
    """Decode one token against a cache of ``S_total`` positions split into
    ``n_shards`` equal shards. ``kv_len`` (B,) gives each row's valid
    entries (default: the whole cache). Returns the combined and the
    monolithic outputs, the largest difference between them and the bytes
    each shard sends (its partials) against the bytes of its KV."""
    dev = resolve_device(device)
    dt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(x).to(dev, dt)
               for x in make_inputs(B, Hq, Hkv, D, S_total, seed))
    lens = (torch.full((B,), S_total, dtype=torch.int32) if kv_len is None
            else torch.as_tensor(kv_len, dtype=torch.int32)).to(dev)
    combined, parts = sharded_decode(q, k, v, lens, n_shards)
    full = ops.decode_attention(q, k, v, lens)
    err = float((combined - full.float()).abs().max())
    per = S_total // n_shards
    partial_bytes = sum(x.numel() * x.element_size() for x in parts[0])
    kv_bytes = 2 * B * per * Hkv * D * q.element_size()
    return {"combined": combined, "full": full, "max_abs_err": err,
            "scale": float(full.float().abs().max()),
            "partial_bytes_per_shard": partial_bytes,
            "kv_bytes_per_shard": kv_bytes, "per_shard": per,
            "shapes": {"o": tuple(parts[0][0].shape),
                       "m": tuple(parts[0][1].shape),
                       "l": tuple(parts[0][2].shape)}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--q-heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.batch, args.q_heads, args.kv_heads, args.head_dim,
              args.tokens, args.shards, args.dtype, args.device, args.seed)
    sh = res["shapes"]
    print(f"cache {args.tokens} tokens across {args.shards} shards")
    print(f"per-shard partial shapes: o{sh['o']} m{sh['m']} l{sh['l']}")
    print(f"LSE-combined vs monolithic decode: max |err| = "
          f"{res['max_abs_err']:.2e}")
    wire, kv = res["partial_bytes_per_shard"], res["kv_bytes_per_shard"]
    print(f"bytes moved per shard: {wire} (vs {kv} to gather its KV shard "
          f"-> {kv / wire:.0f}x saving)")
    tol = 1e-4 if args.dtype == "float32" else 2e-2 * res["scale"]
    assert res["max_abs_err"] < tol, (res["max_abs_err"], tol)


if __name__ == "__main__":
    main()
