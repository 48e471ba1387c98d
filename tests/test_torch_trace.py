"""The port's spans (``repro_torch.runtime.trace``): under a profiler a
scheduler step of a hybrid model (Mamba, MoE and attention blocks) opens
``repro:`` ranges nested layer in layer, the scheduler's carrying the
request ids; without one ``span`` is a shared null context that enters no
``record_function``; and the tokens served are the same either way.
The port runs on the CPU, i.e. on the kernels' plain versions."""
import collections
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch.models import model_lib as TM
from repro_torch.runtime import trace
from repro_torch.serving import Scheduler, ServingConfig

PROMPTS = (3, 4)
#: Spans each lowering opens inside its linears, beside COMMON's.
EXPECTED = {
    "pim_sim": ("pim.pack", "pim.exec", "pim.read", "linear.quantize",
                "linear.rescale"),
    "quant": ("quant.gemm", "linear.quantize", "linear.rescale"),
}
COMMON = ("sched.admit", "sched.prefill", "sched.decode", "model.prefill",
          "model.decode_step", "linear", "moe.ffn", "moe.route",
          "moe.experts", "ssm.mixer")


def _config(mode):
    return TC.get("jamba-v0.1-52b").smoke().scaled(
        max_seq_len=16, pim_mode=mode, n_layers=3, pattern=("md", "me", "ad"))


def _step(params, cfg):
    """One scheduler step: both prompts admitted and prefilled, and one
    decode step over both slots; returns (rids, tokens emitted)."""
    sched = Scheduler(params, cfg, ServingConfig(max_batch=2, paged=True,
                                                 prompt_bucket=1),
                      device="cpu")
    rng = np.random.default_rng(0)
    rids = [sched.submit(rng.integers(0, cfg.vocab_size, n), 3)
            for n in PROMPTS]
    out = sched.step()
    return rids, [tok for _, tok in out]


class _Counter:
    """Counts ``torch.ops.profiler._record_function_enter_new`` calls."""

    def __init__(self):
        self.n = 0
        self.real = torch.ops.profiler._record_function_enter_new

    def __call__(self, *a, **kw):
        self.n += 1
        return self.real(*a, **kw)


@pytest.fixture(scope="module", params=sorted(EXPECTED))
def served(request):
    """The same step without and with a profiler, counting the
    ``record_function`` entries of each."""
    mode = request.param
    cfg = _config(mode)
    params = TM.init_params(cfg, 5, device="cpu")
    runs = {}
    for traced in (False, True):
        count = _Counter()
        with mock.patch.object(torch.ops.profiler,
                               "_record_function_enter_new", count):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    rids, toks = _step(params, cfg)
                events = prof.profiler.kineto_results.events()
            else:
                rids, toks = _step(params, cfg)
                events = None
        runs[traced] = (rids, toks, count.n, events)
    return mode, runs


def _ranges(events):
    """(start, end, name) of every ``repro:`` range, one thread."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if e.name().startswith(trace.PREFIX)]
    assert len({e.start_thread_id() for e in events
                if e.name().startswith(trace.PREFIX)}) == 1
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _parents(ranges):
    """The range each range lies directly inside (None at the top)."""
    parent, stack = [], []
    for s, e, _ in ranges:
        while stack and ranges[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(len(parent) - 1)
    return parent


def _chain(ranges, parent, i):
    names = []
    while i is not None:
        names.append(ranges[i][2].split("|")[0][len(trace.PREFIX):])
        i = parent[i]
    return names


def test_spans_open_nested_under_a_profiler(served):
    mode, runs = served
    rids, _, entered, events = runs[True]
    ranges = _ranges(events)
    parent = _parents(ranges)
    names = collections.Counter(r[2].split("|")[0][len(trace.PREFIX):]
                                for r in ranges)
    assert set(names) == set(COMMON) | set(EXPECTED[mode])
    assert entered >= len(ranges)
    # each pim.* / quant.gemm range lies in a linear of the decode step,
    # the decode step in the scheduler's, which names both requests
    inner = EXPECTED[mode][:3] if mode == "pim_sim" else EXPECTED[mode][:1]
    decode_chains = []
    for i, (_, _, name) in enumerate(ranges):
        chain = _chain(ranges, parent, i)
        if chain[0] in inner and "model.decode_step" in chain:
            decode_chains.append(chain)
            j = chain.index("linear")
            assert chain[j:j + 3] == ["linear", "model.decode_step",
                                      "sched.decode"], chain
        if chain[0] in ("linear.quantize", "linear.rescale", "quant.gemm",
                        "pim.pack", "pim.exec", "pim.read"):
            assert "linear" in chain, chain
        if chain[0] in ("moe.route", "moe.experts"):
            assert chain[1] == "moe.ffn", chain
    assert {c[0] for c in decode_chains} == set(inner)
    decode = [r[2] for r in ranges if r[2].startswith("repro:sched.decode")]
    assert decode == [f"repro:sched.decode|rid={rids[0]},{rids[1]}"]
    prefill = sorted(r[2] for r in ranges
                     if r[2].startswith("repro:sched.prefill"))
    assert prefill == sorted(f"repro:sched.prefill|rid={r}" for r in rids)


def test_no_record_function_without_a_profiler(served):
    _, runs = served
    assert trace.span("linear") is trace._OFF
    assert trace.span("sched.decode", rids=[1, 2]) is trace._OFF
    assert runs[False][2] == 0
    assert runs[True][2] > 0          # the count does see entries


def test_tokens_are_the_same_with_a_profiler(served):
    _, runs = served
    assert runs[False][1] == runs[True][1]
    assert len(runs[False][1]) == 2 * len(PROMPTS)
