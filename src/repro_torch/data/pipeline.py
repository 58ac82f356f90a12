"""Batch pipelines feeding the training loop (a copy of the reference's
``data/pipeline.py``: numpy only, the same draws for the same seed).

``synthetic_lm_iter`` — infinite iterator of LM batches from a SyntheticTask
(the communication experiments' training data).

``token_stream_iter`` — generic packed LM stream over a corpus of token ids.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import SyntheticTask
from repro_torch.data.tokenizer import ByteTokenizer


def synthetic_lm_iter(task: SyntheticTask, batch_size: int
                      ) -> Iterator[Dict[str, np.ndarray]]:
    while True:
        yield task.lm_batch(batch_size)


def mixed_lm_iter(tasks, batch_size: int, weights=None, seed: int = 0):
    """Mixture over several SyntheticTask generators (one batch per task
    draw — the fine-tune recipe that differentiates sender/receiver
    models)."""
    rng = np.random.default_rng(seed)
    weights = (np.asarray(weights, np.float64) / np.sum(weights)
               if weights is not None
               else np.full(len(tasks), 1.0 / len(tasks)))
    while True:
        t = tasks[rng.choice(len(tasks), p=weights)]
        yield t.lm_batch(batch_size)


def token_stream_iter(corpus_ids: np.ndarray, batch_size: int, seq_len: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Packed next-token-prediction batches from a flat token array."""
    rng = np.random.default_rng(seed)
    n = corpus_ids.shape[0] - seq_len - 1
    assert n > 0, "corpus too small for seq_len"
    while True:
        starts = rng.integers(0, n, batch_size)
        toks = np.stack([corpus_ids[s:s + seq_len] for s in starts])
        tgts = np.stack([corpus_ids[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32),
               "targets": tgts.astype(np.int32)}


def synthetic_byte_corpus(n_bytes: int = 1 << 16, seed: int = 0
                          ) -> np.ndarray:
    """A structured pseudo-corpus (repeating templated sentences) for the
    end-to-end training run — learnable, non-trivial, offline."""
    from repro_torch.data.synthetic import countries_sample, tipsheets_sample
    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    ids = []
    while len(ids) < n_bytes:
        c, q, a = (countries_sample(rng) if rng.random() < 0.5
                   else tipsheets_sample(rng))
        ids.extend(tok.encode(f"{c} {q} {a}", bos=True, eos=True))
    return np.asarray(ids[:n_bytes], np.int32)
