"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and a seed, and yields requests.

A mix is a closed loop of ``clients``: each client sends its next request
when its last one has finished.  Every seed asks for the same work in
another order: prompt lengths and new-token budgets are the midpoints of
``strata`` equal-probability strata of their distributions, and request
``k`` takes the strata ``floor(frac(u + k a) strata)`` with ``a`` the
golden ratio's fraction for lengths and sqrt(2)'s for budgets, ``u`` drawn
from the seed for each: any run of consecutive requests meets the strata
about evenly, so a window's work does not follow the seed.  A request's
tokens are drawn from the seed and its index alone.

Distributions: ``{"dist": "fixed", "value": v}``, ``{"dist": "uniform",
"lo": a, "hi": b}``, ``{"dist": "loguniform", "lo": a, "hi": b}``.

``stationary_start``: each client's first request has the budget left to
a request in flight at a random moment (the quantiles of the budget's
equilibrium residual, spread over the clients in a seeded order), so that
the loop finishes requests at its steady rate from the start instead of
all at once a lifetime later.

Warm-up, counted as set-up: ``warm_prompts`` lists prompt lengths served
first, one new token each, so the largest shapes of the mix are met before
the window; clients then join one per scheduler step; the window opens
after ``warm_steps`` steps."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np

MIX_KEYS = {"loop", "clients", "prompt_len", "new_tokens", "strata",
            "warm_steps", "warm_prompts", "stationary_start"}
LEN_STEP = (math.sqrt(5) - 1) / 2
NEW_STEP = math.sqrt(2) - 1


def _seed(seed: int, *tail: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 63), *tail])


def quantile(dist: Dict, q: float) -> int:
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if kind == "uniform":
        return int(round(lo + (hi - lo) * q))
    if kind == "loguniform":
        return int(round(lo * math.exp(math.log(hi / lo) * q)))
    raise ValueError(f"unknown distribution {kind!r}")


def strata_values(dist: Dict, n: int) -> List[int]:
    """The ``n`` stratum midpoints of ``dist``, smallest first."""
    return [quantile(dist, (i + 0.5) / n) for i in range(n)]


def residuals(values: List[int], n: int) -> List[int]:
    """``n`` quantiles of the budget left to a request in flight at a
    random moment when budgets are drawn evenly from ``values``:
    ``P(r) ~ #{v >= r}`` over ``r = 1 .. max``."""
    top = max(values)
    weight = np.array([sum(v >= r for v in values) for r in range(1, top + 1)],
                      float)
    cdf = np.cumsum(weight) / weight.sum()
    return [int(np.searchsorted(cdf, (i + 0.5) / n)) + 1 for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Mix:
    clients: int
    prompt_len: Dict
    new_tokens: Dict
    strata: int
    warm_steps: int
    warm_prompts: List[int]
    stationary_start: bool = False

    @classmethod
    def from_json(cls, d: Dict) -> "Mix":
        unknown = set(d) - MIX_KEYS
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        if d.get("loop", "closed") != "closed":
            raise ValueError("the generator makes closed loops only")
        return cls(clients=int(d["clients"]), prompt_len=d["prompt_len"],
                   new_tokens=d["new_tokens"], strata=int(d["strata"]),
                   warm_steps=int(d["warm_steps"]),
                   warm_prompts=[int(x) for x in d.get("warm_prompts", [])],
                   stationary_start=bool(d.get("stationary_start", False)))

    @property
    def longest_request(self) -> int:
        return (max(strata_values(self.prompt_len, self.strata))
                + max(strata_values(self.new_tokens, self.strata)))


@dataclasses.dataclass(frozen=True)
class Spec:
    index: int
    prompt: np.ndarray          # int64 token ids
    max_new_tokens: int


class Stream:
    """The requests of one seed, in the order clients take them."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self._lens = strata_values(mix.prompt_len, mix.strata)
        self._news = strata_values(mix.new_tokens, mix.strata)
        rng = np.random.Generator(np.random.PCG64(_seed(seed, 1)))
        self._u = rng.random(2)
        self._first = ([residuals(self._news, mix.clients)[j]
                        for j in rng.permutation(mix.clients)]
                       if mix.stationary_start else [])
        self._next = 0

    def _tokens(self, index: int, n: int) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(_seed(self.seed, 2,
                                                        index)))
        return rng.integers(0, self.vocab, size=(n,), dtype=np.int64)

    def _stratum(self, k: int, which: int, step: float) -> int:
        return int(((self._u[which] + k * step) % 1.0) * self.mix.strata)

    def warm(self) -> List[Spec]:
        """The shape warm-up requests (negative indices)."""
        return [Spec(-1 - i, self._tokens((1 << 32) + i, n), 1)
                for i, n in enumerate(self.mix.warm_prompts)]

    def take(self) -> Spec:
        k = self._next
        self._next += 1
        plen = self._lens[self._stratum(k, 0, LEN_STEP)]
        new = (self._first[k] if k < len(self._first)
               else self._news[self._stratum(k, 1, NEW_STEP)])
        return Spec(k, self._tokens(k, plen), new)

    def __iter__(self) -> Iterator[Spec]:
        while True:
            yield self.take()
