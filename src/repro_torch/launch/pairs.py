"""The sender/receiver pair definitions of the port.

``pair_config`` is the reference's tiny 8-layer Llama-3.2-family stand-in
and ``deep_receiver_config`` its 12-layer receiver of a heterogeneous pair;
``full_width_config`` is ``llama3.2-3b-pair`` as published.
``random_pair`` draws random weights from a seed (accuracy near zero: the
plumbing and speed are what it shows). ``load_pair`` and
``load_hetero_pair`` give the trained pair: they read the checkpoints the
reference's ``load_pair`` reads (``experiments/ckpt/{base,sender,
receiver,receiver_deep}.npz``, written by either package), and where none
exists they quick-train one on ``task_suite`` and cache it there.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Tuple

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import mixed_lm_iter
from repro_torch.data.synthetic import SyntheticTask, TaskConfig
from repro_torch.data.tokenizer import SymbolTokenizer
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import train

_REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
CKPT_DIR = os.path.join(_REPO_ROOT, "experiments", "ckpt")


def pair_tokenizer() -> SymbolTokenizer:
    return SymbolTokenizer(num_entities=32, num_attributes=16)


def pair_config() -> ModelConfig:
    """Tiny Llama-3.2-family stand-in: 8 layers, float32."""
    tok = pair_tokenizer()
    return dataclasses.replace(
        get_config("llama3.2-3b-pair"),
        num_layers=8, d_model=192, d_ff=512, num_heads=6, num_kv_heads=6,
        head_dim=32, vocab_size=tok.vocab_size, dtype="float32",
        remat=False, tie_embeddings=False)


def deep_receiver_config() -> ModelConfig:
    """The heterogeneous counterpart of ``pair_config``: a deeper receiver
    (12 layers against 8) with the same KV geometry and tokenizer."""
    return dataclasses.replace(pair_config(), num_layers=12)


def full_width_config() -> ModelConfig:
    """``llama3.2-3b-pair`` as published: 28 layers, d_model 3072, 24/8
    heads of 128, d_ff 8192, vocab 128256, bf16, tied embeddings."""
    return get_config("llama3.2-3b-pair")


def random_pair(cfg: ModelConfig, seed: int = 0, *, device
                ) -> Tuple[Any, Any]:
    """(sender, receiver) parameters: ONE random parameter set from
    ``seed`` serves both roles, as the reference does when only a shared
    base checkpoint exists."""
    params = tfm.init_params(cfg, seed, device=device)
    return params, params


def task_suite(tok: SymbolTokenizer, seed: int = 0):
    """The training mixture: the Countries / HotpotQA / Tipsheets
    analogues."""
    return [
        SyntheticTask(tok, TaskConfig("retrieval", num_facts=4, seed=seed)),
        SyntheticTask(tok, TaskConfig("retrieval", num_facts=6,
                                      seed=seed + 1)),
        SyntheticTask(tok, TaskConfig("retrieval", num_facts=8,
                                      seed=seed + 2)),
        SyntheticTask(tok, TaskConfig("multihop", num_facts=6, hops=2,
                                      seed=seed + 3)),
        SyntheticTask(tok, TaskConfig("decision", num_options=3,
                                      seed=seed + 4)),
    ]


def _quick_train(cfg: ModelConfig, tok, steps: int = 1200,
                 ckpt_name: str = "base", *, device=None, log_every: int = 0,
                 log_fn=print, ckpt_dir: str = None):
    """Train one model on ``task_suite`` (batch 64, lr 2e-3, warmup
    steps / 20, the reference's recipe) and cache it as
    ``<ckpt_dir>/<ckpt_name>.npz``; returns its parameters."""
    print(f"[pairs] no checkpoint found -> quick-training {steps} steps "
          f"({ckpt_name})", file=sys.stderr)
    it = mixed_lm_iter(task_suite(tok, seed=0), 64, seed=0)
    opt = OptimizerConfig(lr=2e-3, total_steps=steps,
                          warmup_steps=steps // 20)
    state = train(cfg, opt, it, steps=steps, log_every=log_every,
                  log_fn=log_fn, device=device)
    ckpt_dir = CKPT_DIR if ckpt_dir is None else ckpt_dir
    try:
        os.makedirs(ckpt_dir, exist_ok=True)
        checkpoint.save(os.path.join(ckpt_dir, ckpt_name), state.params,
                        {"role": ckpt_name, "quick_train_steps": steps},
                        cfg=cfg)
    except OSError as e:
        print(f"[pairs] could not cache quick-train checkpoint: {e}",
              file=sys.stderr)
    return state.params


_CACHE: dict = {}


def load_pair(*, device=None) -> Tuple[ModelConfig, SymbolTokenizer, Any,
                                       Any]:
    """(cfg, tok, sender_params, receiver_params) on ``device`` (the card
    by default). Reads the trained checkpoints when they exist, else
    quick-trains a single model for both roles."""
    device = resolve_device(device)
    key = ("pair", str(device))
    if key in _CACHE:
        return _CACHE[key]
    cfg, tok = pair_config(), pair_tokenizer()
    template = tfm.init_params(cfg, 0, device=device)
    s_path = os.path.join(CKPT_DIR, "sender.npz")
    r_path = os.path.join(CKPT_DIR, "receiver.npz")
    b_path = os.path.join(CKPT_DIR, "base.npz")
    if os.path.exists(s_path) and os.path.exists(r_path):
        sender = checkpoint.restore(s_path, template, cfg=cfg)
        receiver = checkpoint.restore(r_path, template, cfg=cfg)
    elif os.path.exists(b_path):
        sender = receiver = checkpoint.restore(b_path, template, cfg=cfg)
    else:
        sender = receiver = _quick_train(cfg, tok, device=device)
    _CACHE[key] = (cfg, tok, sender, receiver)
    return _CACHE[key]


def load_hetero_pair(*, device=None) -> Tuple[ModelConfig, ModelConfig,
                                              SymbolTokenizer, Any, Any]:
    """(sender_cfg, receiver_cfg, tok, sender_params, receiver_params): the
    trained 8-layer sender with a deeper, separately trained 12-layer
    receiver (``receiver_deep.npz``, quick-trained once when absent)."""
    device = resolve_device(device)
    key = ("hetero", str(device))
    if key in _CACHE:
        return _CACHE[key]
    s_cfg, tok, sender, _ = load_pair(device=device)
    r_cfg = deep_receiver_config()
    d_path = os.path.join(CKPT_DIR, "receiver_deep.npz")
    if os.path.exists(d_path):
        receiver = checkpoint.restore(
            d_path, tfm.init_params(r_cfg, 0, device=device), cfg=r_cfg)
    else:
        receiver = _quick_train(r_cfg, tok, ckpt_name="receiver_deep",
                                device=device)
    _CACHE[key] = (s_cfg, r_cfg, tok, sender, receiver)
    return _CACHE[key]
