"""The traffic generator: deterministic in the seed, the same sizes for
every seed in another order."""
import json
import os
from collections import Counter

import numpy as np
import pytest

from bench.harness.traffic import Mix, Stream, residuals, strata_values

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic")))


def _mix(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return Mix.from_json(json.load(f))


def _take(mix, seed, n, vocab=32000):
    s = Stream(mix, seed, vocab)
    return [s.take() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    seed = 2 ** 31 + 12345          # seeds past 32 bits
    a, b = _take(mix, seed, 2 * mix.strata), _take(mix, seed, 2 * mix.strata)
    for x, y in zip(a, b):
        assert x.max_new_tokens == y.max_new_tokens
        np.testing.assert_array_equal(x.prompt, y.prompt)
    other = _take(mix, seed + 1, 2 * mix.strata)
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a, other))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_asks_for_the_same_work(name):
    """Only stratum values occur, any run of twice ``strata`` requests
    meets every stratum one to three times, and the mean size over a
    stretch of requests does not follow the seed."""
    mix = _mix(name)
    n = mix.strata
    lens = strata_values(mix.prompt_len, n)
    news = strata_values(mix.new_tokens, n)
    first = mix.clients if mix.stationary_start else 0
    means = []
    for seed in (0, 7, 2 ** 31 + 3, 123456789):
        reqs = _take(mix, seed, first + 20 * n)[first:]
        plens = [r.prompt.shape[0] for r in reqs]
        assert set(plens) <= set(lens)
        assert {r.max_new_tokens for r in reqs} <= set(news)
        for s in range(0, len(reqs) - 2 * n, 7):
            c = Counter(plens[s:s + 2 * n])
            assert all(k <= 3 * lens.count(v) for v, k in c.items())
        means.append(np.mean(plens))
    assert max(means) / min(means) < 1.02


def test_stationary_start_spreads_the_first_budgets():
    mix = Mix.from_json({"clients": 4, "strata": 2, "warm_steps": 0,
                         "prompt_len": {"dist": "fixed", "value": 8},
                         "new_tokens": {"dist": "fixed", "value": 16},
                         "stationary_start": True})
    assert residuals([16], 4) == [2, 6, 10, 14]
    for seed in (1, 2):
        first = [r.max_new_tokens for r in _take(mix, seed, 6)]
        assert sorted(first[:4]) == [2, 6, 10, 14] and first[4:] == [16, 16]
    # budgets uniform over 16..128: a request in flight has fewer left
    r = residuals(list(range(16, 129)), 8)
    assert r == sorted(r) and r[0] < 16 < r[-1] <= 128


def test_sizes_follow_the_distribution():
    mix = Mix.from_json({"clients": 1, "strata": 4, "warm_steps": 0,
                         "prompt_len": {"dist": "loguniform", "lo": 16,
                                        "hi": 256},
                         "new_tokens": {"dist": "uniform", "lo": 0,
                                        "hi": 8}})
    assert strata_values(mix.prompt_len, 4) == [23, 45, 91, 181]
    assert strata_values(mix.new_tokens, 4) == [1, 3, 5, 7]
    tokens = _take(mix, 5, 8, vocab=50)
    assert all(0 <= t.prompt.min() and t.prompt.max() < 50 for t in tokens)


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError):
        Mix.from_json({"clients": 1, "strata": 1, "warm_steps": 0,
                       "prompt_len": {"dist": "fixed", "value": 4},
                       "new_tokens": {"dist": "fixed", "value": 4},
                       "rate": 3})
