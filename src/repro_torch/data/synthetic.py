"""Synthetic task families mirroring the paper's evaluation datasets.

The paper evaluates on Countries ("Uma is at the Mahaffie House. Which
country is Uma located in?") and Tipsheets (multi-company investment tips),
plus long-context QA benchmarks. Offline we cannot load HF checkpoints, so
the communication experiments run on tiny models *trained from scratch* on
structurally identical tasks:

  retrieval  — N (entity, attribute) facts as context; query asks one
               entity's attribute. The symbolic Countries analogue; F1
               becomes exact-match accuracy on the attribute token.
  multihop   — facts form entity->entity links plus a final attribute;
               queries require following k hops (HotpotQA/MuSiQuest
               analogue: answer needs *composition*, not copy).
  decision   — every context lists per-option evidence tokens (good/bad
               signals); the answer is the option with the best net score
               (Tipsheets analogue: aggregate judgment, not extraction).

Textual Countries/Tipsheets generators (byte-level) are provided for the
examples; the benchmark harness uses the symbolic forms for trainability.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer, SymbolTokenizer


@dataclass(frozen=True)
class TaskConfig:
    kind: str = "retrieval"          # retrieval | multihop | decision
    num_facts: int = 8               # facts per context
    hops: int = 2                    # multihop only
    num_options: int = 3             # decision only
    evidence_per_option: int = 2
    seed: int = 0


@dataclass
class Sample:
    context: np.ndarray   # (Sc,) int32
    query: np.ndarray     # (Sq,) int32 — ends with ANS marker
    answer: int           # the single answer token


class SyntheticTask:
    """Generator for one task family over a SymbolTokenizer vocab."""

    def __init__(self, tok: SymbolTokenizer, cfg: TaskConfig):
        self.tok = tok
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    # ---- sampling -------------------------------------------------------
    def sample(self) -> Sample:
        kind = self.cfg.kind
        if kind == "retrieval":
            return self._retrieval()
        if kind == "multihop":
            return self._multihop()
        if kind == "decision":
            return self._decision()
        raise ValueError(kind)

    def _retrieval(self) -> Sample:
        t, c = self.tok, self.cfg
        # Half the slots are REPEATS of earlier facts: the second occurrence
        # of (e, a) makes `a` predictable from context alone, which is the
        # in-context-copy signal that forms the induction circuit the QA
        # behaviour rides on (facts being i.i.d. otherwise, the LM loss
        # would carry no retrieval gradient).
        n_uniq = max(1, c.num_facts - c.num_facts // 2)
        ents = self.rng.choice(t.num_entities, n_uniq, replace=False)
        attrs = self.rng.integers(0, t.num_attributes, n_uniq)
        facts = list(zip(ents, attrs))
        rep = [facts[i] for i in
               self.rng.integers(0, n_uniq, c.num_facts - n_uniq)]
        order = facts + rep
        self.rng.shuffle(order)
        ctx = []
        for e, a in order:
            ctx += [t.entity(e), t.attribute(a)]
        j = self.rng.integers(0, n_uniq)
        query = [t.Q, t.entity(ents[j]), t.ANS]
        return Sample(np.array(ctx, np.int32), np.array(query, np.int32),
                      int(t.attribute(attrs[j])))

    def _multihop(self) -> Sample:
        t, c = self.tok, self.cfg
        # chain: e0 -> e1 -> ... -> e_{hops} -> attribute
        n = c.num_facts
        ents = self.rng.choice(t.num_entities, n + c.hops, replace=False)
        chain = ents[:c.hops + 1]
        attr = int(self.rng.integers(0, t.num_attributes))
        facts: List[Tuple[int, int]] = []
        for i in range(c.hops):
            facts.append((t.entity(chain[i]), t.entity(chain[i + 1])))
        facts.append((t.entity(chain[-1]), t.attribute(attr)))
        # distractor facts
        for e in ents[c.hops + 1:]:
            facts.append((t.entity(e),
                          t.attribute(int(self.rng.integers(
                              0, t.num_attributes)))))
        self.rng.shuffle(facts)
        ctx = [x for f in facts for x in f]
        query = [t.Q, t.entity(chain[0]), t.ANS]
        return Sample(np.array(ctx, np.int32), np.array(query, np.int32),
                      int(t.attribute(attr)))

    def _decision(self) -> Sample:
        t, c = self.tok, self.cfg
        opts = self.rng.choice(t.num_entities, c.num_options, replace=False)
        # evidence attributes: low half = bad, high half = good
        half = t.num_attributes // 2
        scores = np.zeros(c.num_options, np.int64)
        ctx = []
        for i, o in enumerate(opts):
            for _ in range(c.evidence_per_option):
                good = self.rng.random() < 0.5
                a = int(self.rng.integers(half, t.num_attributes) if good
                        else self.rng.integers(0, half))
                scores[i] += 1 if good else -1
                ctx += [t.entity(o), t.attribute(a)]
        # ensure unique argmax
        best = int(np.argmax(scores + np.linspace(0, 0.1, c.num_options)))
        query = [t.Q] + [t.entity(o) for o in opts] + [t.ANS]
        return Sample(np.array(ctx, np.int32), np.array(query, np.int32),
                      int(t.entity(opts[best])))

    # ---- batching -------------------------------------------------------
    def batch(self, n: int) -> Dict[str, np.ndarray]:
        samples = [self.sample() for _ in range(n)]
        sc = max(len(s.context) for s in samples)
        sq = max(len(s.query) for s in samples)
        ctx = np.full((n, sc), self.tok.PAD, np.int32)
        qry = np.full((n, sq), self.tok.PAD, np.int32)
        ans = np.zeros((n,), np.int32)
        for i, s in enumerate(samples):
            ctx[i, :len(s.context)] = s.context
            qry[i, sq - len(s.query):] = s.query   # right-align: ANS last
            ans[i] = s.answer
        return {"context": ctx, "query": qry, "answer": ans}

    def lm_batch(self, n: int) -> Dict[str, np.ndarray]:
        """Skyline-style LM training batch: [BOS C Q ANS a]; loss everywhere,
        which teaches the model the fact format AND the QA behaviour."""
        b = self.batch(n)
        bos = np.full((n, 1), self.tok.BOS, np.int32)
        ansc = b["answer"][:, None]
        seq = np.concatenate([bos, b["context"], b["query"], ansc], axis=1)
        tokens = seq[:, :-1]
        targets = seq[:, 1:]
        # Full weight on attribute tokens (repeated facts make them
        # in-context-predictable -> induction-circuit signal) and on the
        # answer; light weight elsewhere (entities are i.i.d. noise).
        weights = (targets != self.tok.PAD).astype(np.float32) * 0.02
        weights[targets >= self.tok.attr_base] = 1.0
        weights[:, -1] = 1.0
        return {"tokens": tokens, "targets": targets, "weights": weights}


# ---------------------------------------------------------------------------
# textual generators (byte-level), used by examples/
# ---------------------------------------------------------------------------
_PEOPLE = ["Uma", "Liam", "Nora", "Ravi", "Kai", "Zoe", "Omar", "Ada"]
_LANDMARKS = {
    "the Mahaffie House": "United States",
    "the Eiffel Tower": "France",
    "the Blue Mosque": "Turkey",
    "the Vasa Museum": "Sweden",
    "Table Mountain": "South Africa",
    "the Meiji Shrine": "Japan",
}


def countries_sample(rng: np.random.Generator) -> Tuple[str, str, str]:
    person = _PEOPLE[rng.integers(len(_PEOPLE))]
    lm = list(_LANDMARKS)[rng.integers(len(_LANDMARKS))]
    c = f"{person} is at {lm}."
    q = f"Which country is {person} located in?"
    return c, q, _LANDMARKS[lm]


def tipsheets_sample(rng: np.random.Generator) -> Tuple[str, str, str]:
    names = ["Atlas LLC", "Sable LLC", "Trace LLC"]
    good = ["shows clear momentum", "authorized a buyback",
            "won a sizable contract"]
    bad = ["faces a lawsuit", "reported a cyber incident", "EPS -17%"]
    scores = []
    parts = []
    for nme in names:
        g = rng.integers(0, 3)
        b = rng.integers(0, 3)
        scores.append(int(g) - int(b))
        frag = f"{nme} " + "; ".join(
            list(rng.choice(good, g, replace=False))
            + list(rng.choice(bad, b, replace=False)))
        parts.append(frag + ".")
    c = " ".join(parts)
    q = (f"You must invest in exactly one company from "
         f"{', '.join(names)}. Which do you choose?")
    return c, q, names[int(np.argmax(scores))]
