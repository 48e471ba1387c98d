"""A configuration brings its own plain reference as new files: a reference
module with a block kind of its own, a configuration naming it, a cell and
a span metric load, draw, check and read with no existing file edited.  A
configuration that its reference does not cover is refused at load, and a
configuration that names no reference gets the one it had before."""
import json
import os
import shutil
import textwrap

import pytest
import torch

from bench.conftest import SMOKE_MODELS
from bench.harness import arith, check, closed_loop, readers, spans
from bench.harness import trace as trace_mod
from bench.harness.main import Run
from bench.harness.spec import load_cell, load_metric
from bench.harness.traffic import Spec
from bench.reference import default
from bench.reference import params as ref_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)

TOY_REFERENCE = textwrap.dedent('''
    """A toy architecture: blocks of kind ``tx``, x + tanh(x W1) W2."""
    from __future__ import annotations

    import dataclasses
    from typing import Tuple

    import torch

    KINDS = ("tx",)
    PROGRAM_ONLY = {"name": "a label"}


    @dataclasses.dataclass(frozen=True)
    class Arch:
        n_layers: int
        d_model: int
        d_mix: int
        vocab_size: int
        pattern: Tuple[str, ...] = ("tx",)
        max_seq_len: int = 64

        @classmethod
        def from_model(cls, model):
            names = {f.name for f in dataclasses.fields(cls)}
            kw = {k: v for k, v in model.items() if k in names}
            kw["pattern"] = tuple(kw.get("pattern", cls.pattern))
            return cls(**kw)


    def draw(a, seed, device):
        g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
        n, d, m = a.n_layers, a.d_model, a.d_mix
        w = lambda *s: torch.randn(s, generator=g, device=device)
        return {"embed": w(a.vocab_size, d),
                "blocks": {"0": {"w1": w(n, d, m) / d ** 0.5,
                                 "w2": w(n, m, d) / m ** 0.5}}}


    def _fixed(w, bits):
        qmax = 2 ** (bits - 1) - 1
        scale = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / qmax
        return torch.round(w / scale) * scale


    def served_logits(params, a, seqs, bits, wide=False):
        b = params["blocks"]["0"]
        out = []
        for toks, n_prompt in seqs:
            x = params["embed"][toks]
            for i in range(a.n_layers):
                x = x + torch.tanh(x @ _fixed(b["w1"][i], bits)) @ b["w2"][i]
            out.append(x[n_prompt - 1:] @ params["embed"].T)
        return out


    def model_flops(a, tokens):
        return 4.0 * a.n_layers * a.d_model * a.d_mix * tokens


    def step_linears(a):
        return [(a.d_model, a.d_mix), (a.d_mix, a.d_model)] * a.n_layers
''')

TOY_MODEL = {"name": "toy", "n_layers": 3, "d_model": 16, "d_mix": 24,
             "vocab_size": 50, "pattern": ["tx"]}


def _checkout(tmp_path, model, reference=None):
    """A copy of ``bench/`` and ``BENCHMARK.json`` plus, as new files and
    entries only, the configuration ``model`` (naming ``reference``), a
    mix, the cell ``toy.cell`` and the span metric ``toy_mixer_share``."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "bench"
    conf = {"name": "toy-arch", "model": model}
    if reference is not None:
        conf["reference"] = reference
    (bench / "configs/toy-arch.json").write_text(json.dumps(conf))
    (bench / "traffic/toy-mix.json").write_text(json.dumps(
        {"clients": 1, "strata": 1, "warm_steps": 0,
         "prompt_len": {"dist": "fixed", "value": 5},
         "new_tokens": {"dist": "fixed", "value": 4}}))
    (bench / "cells/toy.cell.json").write_text(json.dumps(
        {"mode": "pim_sim", "serving": {"max_batch": 1},
         "trace_seconds": 1,
         "check": {"sample": 1, "limits": {"logit_gap_mean": 0.1}}}))
    (bench / "metrics/toy_mixer_share.py").write_text(
        "def read(run):\n"
        "    return None if run.spans is None else "
        "run.spans.share('toy.mixer')\n")
    out = dict(BENCH)
    out["configs"] = BENCH["configs"] + [
        {"name": "toy-arch", "source": "test",
         "file": "bench/configs/toy-arch.json", "reduced": [],
         "why": "test"}]
    out["workloads"] = BENCH["workloads"] + [
        {"name": "toy.cell", "config": "toy-arch", "traffic": "toy-mix",
         "chips": 1, "why": "test"}]
    out["per_layer"] = BENCH["per_layer"] + [
        {"name": "toy_mixer_share", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "test", "moves": "tok_s",
         "workloads": ["toy.cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(out))
    return root


def _toy_root(tmp_path):
    root = _checkout(tmp_path, TOY_MODEL, "toy")
    (root / "bench/reference/toy.py").write_text(TOY_REFERENCE)
    return root


def test_a_new_architecture_is_new_files_only(tmp_path):
    root = _toy_root(tmp_path)
    cell = load_cell("toy.cell", root)
    ref = cell.reference
    assert os.path.samefile(ref.__file__, root / "bench/reference/toy.py")
    assert type(cell.arch) is ref.Arch and cell.arch.d_mix == 24

    # the draw and the check are the toy's
    params = ref.draw(cell.arch, 2 ** 31 + 5, "cpu")
    assert params["blocks"]["0"]["w1"].shape == (3, 16, 24)
    rng = torch.Generator().manual_seed(0)
    reqs = []
    for i in range(2):
        prompt = torch.randint(0, 50, (6,), generator=rng)
        r = closed_loop.Request(i, Spec(i, prompt.numpy(), 4), 0, 0.0)
        seq = prompt
        for _ in range(4):      # greedy decode of the toy reference
            tok = int(ref.served_logits(params, cell.arch, [(seq, 6)],
                                        cell.bits)[0][-1].argmax())
            r.tokens.append(tok)
            seq = torch.cat([seq, torch.tensor([tok])])
        reqs.append(r)
    sound = check.gaps(params, cell.arch, reqs, cell.bits, cell.wide, "cpu",
                       ref)
    assert check.judge(check.readings(sound), cell.limits) == (
        True, {"logit_gap_mean": {"value": 0.0, "limit": 0.1}})
    ctl = check.control_gaps(params, cell.arch, reqs, cell.bits, cell.wide,
                             check.CONTROL_BITS, "cpu", ref)
    assert [len(g) for g in ctl] == [4, 4]

    # the model arithmetic and the span metric read the toy's
    steps = [closed_loop.Step(0.0, 0.1, [6], 0),
             closed_loop.Step(0.1, 0.2, [], 1)]
    trace = trace_mod.Trace(
        0, 2 * 10 ** 9, 10 ** 9, {readers.CROSSBAR_KERNEL: 10 ** 8},
        {("bench:decode", readers.CROSSBAR_KERNEL): 10 ** 8}, {})
    sp = spans.Spans(10 ** 9, {"toy.mixer": 25 * 10 ** 7},
                     {frozenset({"toy.mixer"}): 25 * 10 ** 7}, {}, 1)
    run = Run(cell=cell, setup_s=1.0, t_open=0.0, t_close=1.0, steps=steps,
              requests={}, program_metrics=None, active_samples=[],
              uploads=0, trace=trace, traced_steps=steps, spans=sp)
    assert readers.mfu(run) == pytest.approx(
        100.0 * 4.0 * 3 * 16 * 24 * 7 / (2.0 * arith.PEAK_INT8_OPS))
    bound = 3 * (arith.crossbar_bound_s(1, 16, 24)
                 + arith.crossbar_bound_s(1, 24, 16))
    assert readers.roofline(run, readers.CROSSBAR_KERNEL, "decode") == \
        pytest.approx(100.0 * bound / 0.1)
    metrics = {m.name: m for m in cell.per_layer}
    assert metrics["toy_mixer_share"].read(run) == pytest.approx(25.0)
    assert set(metrics) == {"toy_mixer_share"}
    assert load_metric(root / "bench", "pim_pack_share")(run) is None
    run.spans = None
    assert metrics["toy_mixer_share"].read(run) is None

    # the cell already there still gets the default reference
    assert load_cell("jamba-pim.decode", root).reference.KINDS == \
        default.KINDS


@pytest.mark.parametrize("model,reference,refused", [
    ({**SMOKE_MODELS["jamba-smoke"], "pattern": ["md", "tx"]}, None,
     "block kind 'tx'"),
    ({**SMOKE_MODELS["jamba-smoke"], "mamba_n_heads": 128}, None,
     "model field 'mamba_n_heads'"),
    ({**SMOKE_MODELS["jamba-smoke"], "attention_multiplier": 0.0078125},
     None, "model field 'attention_multiplier'"),
    ({**TOY_MODEL, "pattern": ["tx", "md"]}, "toy", "block kind 'md'"),
    ({**TOY_MODEL, "family": "toy"}, "toy", "model field 'family'"),
])
def test_a_configuration_its_reference_misses_is_refused(
        tmp_path, model, reference, refused):
    root = _checkout(tmp_path, model, reference)
    (root / "bench/reference/toy.py").write_text(TOY_REFERENCE)
    with pytest.raises(ValueError, match=f"toy.cell \\(toy-arch\\).*"
                       f"{refused}"):
        load_cell("toy.cell", root)


# the default reference's model arithmetic as it stood before a
# configuration could name its reference: model_flops over 7 tokens, and
# the (K, N) of a period's linears in the pattern md me md me ad me md me
def _period(d, h, kv, hd, ff):
    mlp = [(d, ff), (ff, d), (d, ff)]
    return mlp + mlp + [(d, h * hd), (d, kv * hd), (d, kv * hd),
                        (h * hd, d)] + mlp + mlp


BEFORE = {"jamba-smoke": (6066816.0, _period(64, 4, 2, 16, 128)),
          "jamba-v0.1-52b.p1": (40545591296.0,
                                _period(4096, 32, 8, 128, 14336))}


@pytest.mark.parametrize("config", sorted(BEFORE))
def test_the_default_route_is_the_parents(config, tmp_path):
    if config in SMOKE_MODELS:
        root = _checkout(tmp_path, SMOKE_MODELS[config])
        cell = load_cell("toy.cell", root)
    else:
        cell = load_cell("jamba-pim.decode")
    assert cell.reference.KINDS == ref_params.KINDS
    assert cell.reference.model_flops(cell.arch, 7) == BEFORE[config][0]
    assert cell.reference.step_linears(cell.arch) == BEFORE[config][1]
    if config not in SMOKE_MODELS:
        return      # the full size compares arithmetic only
    got = _flat(cell.reference.draw(cell.arch, 2 ** 31 + 11, "cpu"))
    want = _flat(ref_params.draw(cell.arch, 2 ** 31 + 11, "cpu"))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): v})
    return out


def test_a_traced_line_carries_the_program_spans(smoke_root, capsys):
    """On the CPU a traced run has the program's ranges but no device
    work: the breakdown names them, and the shares are left out."""
    from pathlib import Path

    from bench.harness import main as harness

    rc = harness.main(["--workload", "j.pim", "--seed", "2147483960",
                       "--seconds", "0.3", "--trace", "1"],
                      root=Path(smoke_root), device="cpu")
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"device_ops", "idle_gaps", "program_device",
            "program_idle_gaps"} <= set(res["breakdown"])
    assert not set(spans.SHARES) & set(res["metrics"])
