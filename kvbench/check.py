"""The comparison that decides ``correct``.

After the window, on a sample of the requests it finished, the reference
(``kvbench.reference``, float32, independent of the program) judges what
the timed path produced:

  gap_max      — the widest gap by which a served token's logit lies
                 below the reference's best at that position, teacher
                 forced on the served tokens: sender prefill, the wire,
                 the receiver prefill over [prefix | query] and every
                 decode step of the slot table. The reference shares the
                 program's frozen selection, which the next two numbers
                 judge.
  score_err    — the largest difference between the program's Eq. (1)
                 scores of the calibration request and the reference's.
  sel_mismatch — layers where the program's frozen selection differs from
                 the paper's rule (top ceil(ratio L) of alpha * score +
                 (1 - alpha) * Gaussian depth prior) applied to the
                 program's own scores; exact.
  failed       — requests of the window that never completed, or
                 completed with another number of tokens than asked.

The sample is drawn from the seed and always holds the request with the
longest answer; it grows until it covers ``sample_tokens`` served tokens.

A configuration's family (``kvbench.families``) may name more numbers in
``EXTRA_NUMBERS``; its ``extra_numbers(view)`` reads them from what was
judged, the program's side or the control's alike. ``view`` holds
``token_gaps`` (per sampled request, the (n,) gaps of the judged side's
tokens at each served position, in the float32 reference), ``scores``
(the judged side's Eq. (1) scores of the calibration request),
``ref_scores``, ``picked``, ``layers``, ``wire``, ``bos`` and the float32
references ``sender`` and ``receiver``. Each is held to the cell's limit
like the four; a limit that is missing is an error, never a pass.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kvbench import reference as ref

NUMBERS = ("gap_max", "score_err", "sel_mismatch", "failed")


def names(family: Optional[ModuleType]) -> Tuple[str, ...]:
    """The numbers compared for a configuration of ``family``: the four,
    then the family's own."""
    return NUMBERS + tuple(getattr(family, "EXTRA_NUMBERS", ()))


def extra(family: Optional[ModuleType], view: Dict) -> Dict:
    """The family's own numbers read from ``view``; every one it names
    has to be there."""
    want = getattr(family, "EXTRA_NUMBERS", ())
    if not want:
        return {}
    taken = set(want) & {*NUMBERS, "sampled_requests", "sampled_tokens",
                         "gaps", "ref_scores"}
    if taken:
        raise ValueError(f"{family.__name__}.EXTRA_NUMBERS reuses "
                         f"{sorted(taken)}")
    got = family.extra_numbers(view)
    missing = [n for n in want if n not in got]
    if missing:
        raise ValueError(f"{family.__name__}.extra_numbers gave no "
                         f"{missing}")
    return {n: got[n] for n in want}


def gaussian_prior(L: int, sigma: float = 10.0) -> np.ndarray:
    """P^l = exp(-(l - L/2)^2 / (2 sigma^2)) for l = 1 .. L, float32."""
    l = np.arange(1, L + 1, dtype=np.float32)
    return np.exp(-np.square(l - np.float32(L / 2))
                  / np.float32(2 * sigma ** 2)).astype(np.float32)


def paper_selection(scores: np.ndarray, ratio: float, alpha: float
                    ) -> np.ndarray:
    """The paper's rule (§3.2): the top ceil(ratio L) layers of the mixed
    score, ties to the lower index. Returns an (L,) bool mask."""
    L = scores.shape[0]
    mixed = (np.float32(alpha) * scores.astype(np.float32)
             + np.float32(1 - alpha) * gaussian_prior(L))
    m = min(L, max(1, math.ceil(ratio * L)))
    order = np.argsort(-mixed, kind="stable")
    mask = np.zeros(L, dtype=bool)
    mask[order[:m]] = True
    return mask


@dataclass
class Served:
    """One finished request as the program served it."""
    rid: int
    context: np.ndarray
    query: np.ndarray
    answer: int
    tokens: Optional[np.ndarray]      # None: never completed


def failures(served: Sequence[Served]) -> int:
    return sum(s.tokens is None or len(s.tokens) != s.answer for s in served)


def sample(served: Sequence[Served], seed: int, target: int) -> List[Served]:
    """The longest-answer request, then others in an order drawn from the
    seed, until ``target`` served tokens are covered."""
    ok = [s for s in served if s.tokens is not None
          and len(s.tokens) == s.answer]
    if not ok:
        return []
    longest = max(ok, key=lambda s: (s.answer, -s.rid))
    rest = [s for s in ok if s is not longest]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    out, n = [longest], longest.answer
    for i in order:
        if n >= target:
            break
        out.append(rest[int(i)])
        n += rest[int(i)].answer
    return out


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def judge(sender: ref.Reference, receiver: ref.Reference,
          picked: Sequence[Served], layers: Sequence[int],
          wire: Optional[str], bos: int) -> Dict:
    """The reference's logits at each served token, in blocks of requests;
    returns gap_max, the per-request gaps and the per-token ones."""
    dev = sender.dev
    per, tok = [], []
    for a in range(0, len(picked), 4):
        blk = picked[a:a + 4]
        logits = ref.served_logits(
            sender, receiver, [_t(s.context, dev) for s in blk],
            [_t(s.query, dev) for s in blk],
            [_t(s.tokens, dev) for s in blk], layers, wire, bos)
        for s, lg in zip(blk, logits):
            g = ref.gaps(lg, _t(s.tokens, dev))
            per.append(float(g.max()))
            tok.append(g.cpu().numpy())
    return {"gap_max": max(per) if per else float("inf"), "gaps": per,
            "token_gaps": tok}


def numbers(*, sender: ref.Reference, receiver: ref.Reference,
            served: Sequence[Served], calib: Served,
            prog_scores: np.ndarray, prog_select: np.ndarray,
            ratio: float, alpha: float, wire: Optional[str], bos: int,
            seed: int, sample_tokens: int,
            family: Optional[ModuleType] = None) -> Dict:
    """Every number the check compares (the four, then ``family``'s own),
    with what it was read on."""
    picked = sample(served, seed, sample_tokens)
    layers = [int(i) for i in np.nonzero(prog_select)[0]]
    out = judge(sender, receiver, picked, layers, wire, bos)
    dev = sender.dev
    ref_scores = ref.calibration_scores(
        sender, receiver, _t(calib.context, dev), _t(calib.query, dev),
        bos).numpy()
    rule = paper_selection(np.asarray(prog_scores), ratio, alpha)
    own = extra(family, dict(
        token_gaps=out["token_gaps"], scores=np.asarray(prog_scores),
        ref_scores=ref_scores, picked=picked, layers=layers, wire=wire,
        bos=bos, sender=sender, receiver=receiver))
    return {
        "gap_max": out["gap_max"],
        "score_err": float(np.abs(np.asarray(prog_scores, np.float64)
                                  - ref_scores).max()),
        "sel_mismatch": int((rule != np.asarray(prog_select)).sum()),
        "failed": failures(served),
        **own,
        "sampled_requests": len(picked),
        "sampled_tokens": int(sum(s.answer for s in picked)),
        "gaps": out["gaps"],
        "ref_scores": ref_scores,
    }


def control_numbers(*, sender: ref.Reference, receiver: ref.Reference,
                    sender8: ref.Reference, receiver8: ref.Reference,
                    picked: Sequence[Served], calib: Served,
                    layers: Sequence[int], wire: Optional[str], bos: int,
                    family: Optional[ModuleType] = None) -> Dict:
    """The control: the reference at float8 in the program's place. At
    each position of the same prompts and served tokens, the gap (in the
    float32 reference) of the token float8 puts first; float8's Eq. (1)
    scores against float32's; and ``family``'s own numbers read on
    float8's side."""
    dev = sender.dev
    per, tok = [], []
    for a in range(0, len(picked), 4):
        blk = picked[a:a + 4]
        args = ([_t(s.context, dev) for s in blk],
                [_t(s.query, dev) for s in blk],
                [_t(s.tokens, dev) for s in blk], layers, wire, bos)
        exact = ref.served_logits(sender, receiver, *args)
        low = ref.served_logits(sender8, receiver8, *args)
        for e, lo in zip(exact, low):
            g = ref.gaps(e, lo.argmax(dim=-1))
            per.append(float(g.max()))
            tok.append(g.cpu().numpy())
    c, q = _t(calib.context, dev), _t(calib.query, dev)
    s32 = ref.calibration_scores(sender, receiver, c, q, bos).numpy()
    s8 = ref.calibration_scores(sender8, receiver8, c, q, bos).numpy()
    own = extra(family, dict(
        token_gaps=tok, scores=s8, ref_scores=s32, picked=list(picked),
        layers=list(layers), wire=wire, bos=bos, sender=sender,
        receiver=receiver))
    return {"gap_max": max(per), "score_err": float(np.abs(s8 - s32).max()),
            **own}


def verdict(nums: Dict, limits: Dict, names: Sequence[str] = NUMBERS
            ) -> bool:
    """Every number at or below its limit; a missing limit raises."""
    return all(nums[k] <= limits[k] for k in names)


def lines(nums: Dict, limits: Dict, names: Sequence[str] = NUMBERS
          ) -> List[str]:
    return [f"check {k} {nums[k]!r} limit {limits[k]!r}" for k in names]
