"""The traffic generator: deterministic per seed, inside each mix's
ranges, and the same lengths in every wave and under every seed."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from kvbench import generator

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob(
    "*.json"))
SEEDS = (0, 7, 2**31 + 17, 2**33 + 5)


def load(p):
    with open(p) as f:
        return generator.validate(json.load(f))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_waves_repeat_per_seed(path):
    mix = load(path)
    for seed in SEEDS:
        a = generator.wave(mix, seed, 3, 50000)
        b = generator.wave(mix, seed, 3, 50000)
        assert [x.rid for x in a] == [x.rid for x in b]
        for x, y in zip(a, b):
            assert np.array_equal(x.context, y.context)
            assert np.array_equal(x.query, y.query) and x.answer == y.answer
    assert not np.array_equal(generator.wave(mix, 1, 0, 50000)[0].context,
                              generator.wave(mix, 2, 0, 50000)[0].context)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_lengths_in_range_and_same_multiset(path):
    mix = load(path)
    ref = None
    for seed in SEEDS:
        for k in range(3):
            w = generator.wave(mix, seed, k, 1000)
            assert len(w) == mix["wave"]
            assert [x.rid for x in w] == list(range(k * mix["wave"],
                                                    (k + 1) * mix["wave"]))
            got = {"context": Counter(len(x.context) for x in w),
                   "query": Counter(len(x.query) for x in w),
                   "answer": Counter(x.answer for x in w)}
            for key in got:
                lo, hi = mix[key]["min"], mix[key]["max"]
                assert all(lo <= n <= hi for n in got[key])
            for x in w:
                assert x.context.dtype == np.int32
                assert x.context.min() >= generator.FIRST_TOKEN
                assert x.context.max() < 1000
            ref = ref or got
            assert got == ref


def test_quantiles_cover_the_distribution():
    d = {"dist": "log_uniform", "min": 1024, "max": 4096}
    q = generator.quantile(d, np.array([1e-9, 0.5, 1 - 1e-9]))
    assert q.tolist() == [1024, 2048, 4096]
    u = {"dist": "uniform", "min": 8, "max": 24}
    lens = generator.wave_lengths({"context": d, "query": u, "answer": u},
                                  17)["answer"]
    assert sorted(lens.tolist()) == list(range(8, 25))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_warmup_has_the_window_lengths(path):
    mix = load(path)
    w = generator.warmup_wave(mix, 5, 1000)
    k = generator.wave(mix, 5, 0, 1000)
    for key in ("context", "query"):
        assert sorted(len(getattr(x, key)) for x in w) == sorted(
            len(getattr(x, key)) for x in k)
    assert {x.answer for x in w} == {generator.WARMUP_ANSWER}
    assert not np.array_equal(w[0].context, k[0].context)


@pytest.mark.parametrize("bad", [
    {"dist": "normal", "min": 1, "max": 2},
    {"dist": "uniform", "min": 0, "max": 2},
    {"dist": "uniform", "min": 5, "max": 2}])
def test_validate_refuses_bad_lengths(bad):
    mix = load(MIXES[0])
    mix["query"] = bad
    with pytest.raises(ValueError):
        generator.validate(mix)
