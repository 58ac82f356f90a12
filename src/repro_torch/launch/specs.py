"""Shape-only stand-ins for every model input and the step functions the
dry run traces (the counterpart of the reference's ``launch/specs.py``).

The stand-ins hold no data: parameters and optimizer state are built
under ``FakeTensorMode`` (``init_params`` draws from a generator, which
the meta device lacks) and handed out as meta tensors, as are batches and
caches. Meta, not fake, because DTensor's sharding propagation computes
shard offsets with tensor ops, which a fake mode would turn fake. Every
step function is the code the real launchers run (``make_train_step``,
``apply_model``); on DTensor arguments it runs on their mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.types import SharedKV
from repro_torch.distributed.sharding import mesh_of
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import OptimizerConfig, OptState, \
    tree_map
from repro_torch.training.train_loop import TrainState, make_train_step

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in tensor: shape and dtype, no data."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Training / prefill batch inputs for one architecture."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"tokens": sds((B, S), torch.long)}
    if shape.mode == "train":
        out["targets"] = sds((B, S), torch.long)
    if cfg.encoder_layers:
        out["frames"] = sds((B, cfg.encoder_seq, cfg.d_model),
                            torch.bfloat16)
    if cfg.num_patches:
        out["patches"] = sds((B, cfg.num_patches, cfg.d_model),
                             torch.bfloat16)
    return out


def params_specs(cfg: ModelConfig) -> Any:
    with FakeTensorMode():
        fake = tfm.init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: sds(t.shape, t.dtype), fake)


def state_specs(cfg: ModelConfig) -> TrainState:
    params = params_specs(cfg)
    moment = lambda p: sds(p.shape, torch.float32)        # noqa: E731
    return TrainState(params, OptState(0, tree_map(moment, params),
                                       tree_map(moment, params)))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    return tfm.init_cache(cfg, batch, max_len, device=META)


def decode_specs(cfg: ModelConfig, shape: InputShape) -> Tuple[Any, Any]:
    """(token_spec, cache_spec) for one decode step over a full cache."""
    B = shape.global_batch
    return sds((B, 1), torch.long), cache_specs(cfg, B, shape.seq_len + 1)


def _device(t: torch.Tensor) -> torch.device:
    return (t.to_local() if isinstance(t, DTensor) else t).device


def _extra(batch):
    return {k: batch[k] for k in ("frames", "patches") if k in batch} or None


# ---------------------------------------------------------------------------
# step functions traced by the dry run (the code the real launchers run)
# ---------------------------------------------------------------------------
def make_step_fn(cfg: ModelConfig, shape: InputShape,
                 microbatches: int = 1):
    """Returns (fn, example_args) with every argument a stand-in. A
    prefill builds its cache on the parameters' mesh (``init_cache``'s
    placements)."""
    if shape.mode == "train":
        step = make_train_step(cfg, OptimizerConfig(),
                               microbatches=microbatches)
        return step, (state_specs(cfg), batch_specs(cfg, shape))

    if shape.mode == "prefill":
        def prefill(params, batch):
            B, S = batch["tokens"].shape
            emb = params["embed"]
            cache = tfm.init_cache(cfg, B, S + 1, device=_device(emb),
                                   mesh=mesh_of(emb))
            out = tfm.apply_model(params, cfg, batch["tokens"],
                                  mode="cached", cache=cache,
                                  extra=_extra(batch), logits_mode="last")
            return out.logits, out.cache
        return prefill, (params_specs(cfg), batch_specs(cfg, shape))

    if shape.mode == "decode":
        def decode(params, token, cache):
            out = tfm.apply_model(params, cfg, token, mode="cached",
                                  cache=cache, logits_mode="last")
            return out.logits, out.cache
        token, cache = decode_specs(cfg, shape)
        return decode, (params_specs(cfg), token, cache)

    raise ValueError(shape.mode)


def make_kvcomm_prefill_fn(cfg: ModelConfig, shape: InputShape,
                           context_len: int, ratio: float = 0.5):
    """Receiver prefill with a transmitted sender prefix (the paper's
    technique under a mesh): the dense view, every layer holding the
    prefix, ``select`` (the first ``ratio`` of the attention layers; a
    host tensor, the same on every rank) masking it on the rest, the
    Eq. (1) masses collected."""
    B, S = shape.global_batch, shape.seq_len
    L = cfg.attn_layer_count
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim

    def prefill(params, batch, kv, select):
        shared = SharedKV(kv=kv, select=select, prefix_len=context_len)
        emb = params["embed"]
        cache = tfm.init_cache(cfg, B, S + 1, device=_device(emb),
                               shared=shared, mesh=mesh_of(emb))
        out = tfm.apply_model(params, cfg, batch["tokens"], mode="cached",
                              cache=cache, shared=shared,
                              extra=_extra(batch), logits_mode="last",
                              collect_mass=True)
        return out.logits, out.masses, out.cache

    kv_spec = {"k": sds((L, B, context_len, Hkv, Dh), torch.bfloat16),
               "v": sds((L, B, context_len, Hkv, Dh), torch.bfloat16)}
    select = torch.arange(L) < round(ratio * L)
    return prefill, (params_specs(cfg), batch_specs(cfg, shape), kv_spec,
                     select)
