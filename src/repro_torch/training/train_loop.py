"""Training loop of the port: loss, the train-step factory, a host loop (a
port of the reference's ``training/train_loop.py``).

Gradients come from ``torch.autograd`` through the port's train-mode
forward, which runs the plain attention core (as the reference's train
mode runs the XLA core): training launches no kernel. A step updates the
state in place (``optimizer.adamw_update``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_nll
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            adamw_update, init_opt_state,
                                            leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device
                     ) -> TrainState:
    params = tfm.init_params(cfg, seed, device=device)
    return TrainState(params=params, opt=init_opt_state(params))


def cross_entropy(logits, targets, weights=None):
    """Token-level CE. logits (B, S, V) float32; targets (B, S) int;
    ``weights`` (B, S) weighs each position."""
    if isinstance(logits, DTensor):       # on a mesh, shard by shard
        nll = local_nll(logits, targets)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        nll = logz - gold
    if weights is None:
        return torch.mean(nll)
    wsum = torch.clamp(torch.sum(weights), min=1e-6)
    return torch.sum(nll * weights) / wsum


def loss_fn(params, cfg: ModelConfig, batch) -> tuple:
    """(loss, {"ce", "aux"}): the cross-entropy plus ``router_aux_coef``
    times the MoE load-balance loss. ``frames`` / ``patches`` in the batch
    feed whisper's encoder and a VLM's stub patches."""
    extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
    out = tfm.apply_model(params, cfg, batch["tokens"], mode="train",
                          extra=extra or None)
    ce = cross_entropy(out.logits, batch["targets"], batch.get("weights"))
    loss = ce + cfg.router_aux_coef * out.aux_loss
    return loss, {"ce": ce, "aux": out.aux_loss}


def _grads(params, cfg: ModelConfig, batch):
    """(loss, parts, grads): one backward pass; ``grads`` mirrors the
    parameter tree (a shared tensor has one gradient, the sum over its
    uses)."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    try:
        with tfm.mesh_context(ps[0]):
            loss, parts = loss_fn(params, cfg, batch)
            loss.backward()
        grads = tree_map(lambda p: (p.grad if p.grad is not None
                                    else torch.zeros_like(p)), params)
    finally:
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1) -> Callable:
    """(state, batch) -> (state, metrics). With microbatches > 1 the batch
    is split on its leading axis and the gradients are accumulated in
    float32, so activation memory scales with B / microbatches while the
    optimizer sees the full-batch gradient."""
    def train_step(state: TrainState, batch) -> tuple:
        if microbatches == 1:
            loss, parts, grads = _grads(state.params, cfg, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = aux = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, p_i, g = _grads(state.params, cfg, mb)
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
                loss, aux = loss + l, aux + p_i["aux"]
            tree_map(lambda a: a.div_(microbatches), grads)
            loss = loss / microbatches
            parts = {"ce": loss, "aux": aux / microbatches}
        params, opt, om = adamw_update(opt_cfg, state.params, grads,
                                       state.opt)
        return TrainState(params, opt), {"loss": loss, **parts, **om}
    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, cfg, batch)
        return {"loss": loss, **parts}
    return eval_step


def to_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A host batch (numpy) as tensors on ``device``: token ids as long,
    everything else as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if k in ("tokens", "targets")
                  else t.float()).to(device)
    return out


def train(cfg: ModelConfig, opt_cfg: OptimizerConfig, data_iter,
          steps: int, seed: int = 0, state: Optional[TrainState] = None,
          log_every: int = 50, log_fn=print, *, device=None) -> TrainState:
    """Single-device training loop; the reference's log line format.
    The default device is the card."""
    device = resolve_device(device)
    if state is None:
        state = init_train_state(cfg, seed, device=device)
    step_fn = make_train_step(cfg, opt_cfg)
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_fn(state, to_batch(next(data_iter), device))
        if log_every and (i % log_every == 0 or i == steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"step {i:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                   f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} "
                   f"({time.time() - t0:.1f}s)")
    return state
