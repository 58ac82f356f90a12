"""The one traffic generator: a mix file of parameters -> waves of requests.

A mix (``kvbench/traffic/<name>.json``) states three length
distributions (context, query, answer), the wave size W and the serving
knobs the cell runs them under (slot-table capacity, transport, wire
dtype). Every wave holds the same multiset of lengths: the W stratified
quantiles ``(i + 0.5) / W`` of each distribution, each list shuffled on its
own by the seed, so every seed and every wave asks for the same amount of
work in another pairing and order. Token ids are uniform in ``[4, vocab)``
(ids 0-3 are the specials PAD, BOS and two markers).

Everything here is numpy on the host; the requests are plain tuples that
the harness turns into the program's ``Request``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

FIRST_TOKEN = 4            # ids below are specials
DISTS = ("uniform", "log_uniform")


@dataclass(frozen=True)
class Item:
    """One request: its id, the sender's context, the receiver's query and
    the number of answer tokens (the first comes from the prefill)."""
    rid: int
    context: np.ndarray          # (Sc,) int32, without BOS
    query: np.ndarray            # (Sq,) int32
    answer: int


def _check_dist(name: str, d: Dict) -> None:
    if d.get("dist") not in DISTS:
        raise ValueError(f"traffic {name}: dist must be one of {DISTS}")
    lo, hi = d.get("min"), d.get("max")
    if not (isinstance(lo, int) and isinstance(hi, int) and 1 <= lo <= hi):
        raise ValueError(f"traffic {name}: needs whole 1 <= min <= max")


def validate(mix: Dict) -> Dict:
    for key in ("context", "query", "answer"):
        _check_dist(key, mix[key])
    if mix["answer"]["min"] < 2:
        raise ValueError("answers need at least 2 tokens (one decode step)")
    w, cap = mix.get("wave"), mix.get("capacity")
    if not (isinstance(w, int) and isinstance(cap, int) and w >= 1
            and cap >= 1):
        raise ValueError("traffic: wave and capacity are whole and >= 1")
    if mix.get("transport") not in ("in_memory", "serialized"):
        raise ValueError("traffic: transport is in_memory or serialized")
    return mix


def quantile(d: Dict, q: np.ndarray) -> np.ndarray:
    """Lengths at quantiles q in (0, 1) of a distribution, as whole ints
    inside [min, max]."""
    lo, hi = d["min"], d["max"]
    if d["dist"] == "uniform":
        x = lo + np.floor(q * (hi - lo + 1))
    else:
        x = np.round(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo))))
    return np.clip(x, lo, hi).astype(np.int64)


def wave_lengths(mix: Dict, w: int) -> Dict[str, np.ndarray]:
    """The stratified lengths of one wave of w requests, in quantile
    order (unshuffled)."""
    q = (np.arange(w) + 0.5) / w
    return {k: quantile(mix[k], q) for k in ("context", "query", "answer")}


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(FIRST_TOKEN, vocab, size=n, dtype=np.int64
                        ).astype(np.int32)


def wave(mix: Dict, seed: int, k: int, vocab: int) -> List[Item]:
    """Wave k of a run with ``seed``: W requests with ids k*W .. k*W+W-1.
    The same (seed, k) always gives the same wave, whatever came before."""
    w = mix["wave"]
    rng = np.random.default_rng([seed, 0, k])
    lens = {key: rng.permutation(v) for key, v in
            wave_lengths(mix, w).items()}
    return [Item(rid=k * w + i,
                 context=_tokens(rng, int(lens["context"][i]), vocab),
                 query=_tokens(rng, int(lens["query"][i]), vocab),
                 answer=int(lens["answer"][i])) for i in range(w)]


def calibration_item(mix: Dict, seed: int, vocab: int) -> Item:
    """The one request the selection is calibrated on: median lengths,
    its own tokens."""
    rng = np.random.default_rng([seed, 1])
    half = np.array([0.5])
    return Item(rid=-1,
                context=_tokens(rng, int(quantile(mix["context"], half)[0]),
                                vocab),
                query=_tokens(rng, int(quantile(mix["query"], half)[0]),
                              vocab),
                answer=int(quantile(mix["answer"], half)[0]))


WARMUP_ANSWER = 3          # the first token and two ragged steps


def warmup_wave(mix: Dict, seed: int, vocab: int) -> List[Item]:
    """One untimed wave with the context and query lengths every window
    wave has (its own tokens) and answers of ``WARMUP_ANSWER`` tokens: every
    prefill shape, the slot table, the wire and K1 run once, and set-up
    spends no time on decode steps, which meet no shape the first ones did
    not."""
    w = mix["wave"]
    rng = np.random.default_rng([seed, 2])
    lens = {key: rng.permutation(v) for key, v in
            wave_lengths(mix, w).items()}
    answer = min(WARMUP_ANSWER, mix["answer"]["max"])
    return [Item(rid=i, context=_tokens(rng, int(lens["context"][i]), vocab),
                 query=_tokens(rng, int(lens["query"][i]), vocab),
                 answer=answer) for i in range(w)]
