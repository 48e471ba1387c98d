"""granite-4.0-h-small's configuration and its own plain reference
(``bench/reference/granite_hybrid.py``): the cell loads; a configuration
the reference does not cover is refused by name; the model arithmetic at
the published sizes is the hand arithmetic; the reference's MoE sublayer
is a per-token sum; and a smoke-size cell of the configuration runs
through the harness on the CPU with a gap of 0."""
import dataclasses
import json
import math
import os
import shutil
from pathlib import Path

import pytest
import torch

from bench.harness import arith, main as harness
from bench.harness.spec import load_cell
from bench.reference import granite_hybrid as G

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "granite-pim.decode"
CONFIG = "bench/configs/granite-4.0-h-small.p1.json"

SMOKE = {
    "name": "granite-smoke", "family": "hybrid", "n_layers": 10,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 32, "vocab_size": 277,
    "pattern": ["ms", "ms", "ms", "ms", "ms", "as", "ms", "ms", "ms", "ms"],
    "n_experts": 8, "top_k": 2, "moe_d_ff": 32, "shared_d_ff": 48,
    "mamba_d_state": 16, "mamba_expand": 1, "mamba_n_heads": 4,
    "embedding_multiplier": 12.0,
    "residual_multiplier": 0.22, "attention_multiplier": 0.0078125,
    "logits_scaling": 16.0, "use_rope": False, "pad_vocab_multiple": 8,
    "max_seq_len": 64, "dtype": "float32"}


def _root(tmp_path, model):
    """A copy of ``bench/`` and ``BENCHMARK.json`` whose granite
    configuration's ``"model"`` is ``model``, and the cell ``g.quant``
    serving it in ``quant`` to one client."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((root / CONFIG).read_text())
    conf["model"] = model
    (root / CONFIG).write_text(json.dumps(conf))
    (root / "bench/traffic/g-one.json").write_text(json.dumps(
        {"clients": 1, "strata": 1, "warm_steps": 1,
         "prompt_len": {"dist": "fixed", "value": 6},
         "new_tokens": {"dist": "fixed", "value": 4}}))
    (root / "bench/cells/g.quant.json").write_text(json.dumps(
        {"mode": "quant", "serving": {"max_batch": 1, "prompt_bucket": 1,
                                      "paged": True},
         "trace_seconds": 0.5,
         "check": {"sample": 1, "limits": {"logit_gap_mean": 1e-4}}}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(
        {"name": "g.quant", "config": "granite-4.0-h-small.p1",
         "traffic": "g-one", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("g.quant")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_cell_loads_with_its_own_reference():
    cell = load_cell(CELL)
    assert cell.reference.__name__ == "bench.reference.granite_hybrid"
    a = cell.arch
    assert (a.n_layers, a.n_super, a.d_inner, a.conv_dim, a.padded_vocab) \
        == (10, 1, 8192, 8448, 100352)
    # the head width follows from d_inner and the heads: the published one
    assert a.mamba_d_head == cell.config["mamba_d_head"] == 64
    assert (cell.mode, cell.serving["max_batch"], cell.mix.clients) == (
        "pim_sim", 8, 8)
    assert {"mamba2_mixer_share", "moe_shared_share"} <= {
        m.name for m in cell.per_layer}
    # the program's configuration is the registry's, cut to one period
    from repro_torch import configs

    cfg = harness.program_config(cell)
    assert cfg == configs.get("granite-4.0-h-small").scaled(
        n_layers=10, pim_mode="pim_sim")


def test_drawn_tree_is_the_programs():
    from repro_torch import configs
    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves

    cfg = configs.get("granite-4.0-h-small")
    names = {f.name for f in dataclasses.fields(G.Arch)}
    a = G.Arch.from_model({k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in names})
    want = {tuple(p): (tuple(s.shape), s.dtype)
            for p, s in leaves(M.param_specs(cfg))}
    assert want == {p: leaf[:2] for p, leaf in G.leaves(a)}
    assert G.param_count(a) == M.param_count(cfg) == 32_207_337_984


@pytest.mark.parametrize("change,refused", [
    ({"pattern": ["ms", "md", "ms", "ms", "ms", "as", "ms", "ms", "ms",
                  "ms"]}, "block kind 'md'"),
    ({"qkv_bias": True}, "model field 'qkv_bias'"),
    ({"mamba_dt_rank": 256}, "model field 'mamba_dt_rank'"),
])
def test_a_configuration_its_reference_misses_is_refused(tmp_path, change,
                                                         refused):
    model = json.loads(Path(ROOT, CONFIG).read_text())["model"]
    root = _root(tmp_path, {**model, **change})
    with pytest.raises(ValueError, match=f"{CELL} .*{refused}"):
        load_cell(CELL, root)


# the published sizes by hand: d 4096, GQA 32/8 of 128, 72 experts of 768
# top 10, a shared expert of 1536, Mamba-2 128 heads of 64, d_state 128
D, V = 4096, 100352
ATTN = 2 * D * 4096 + 2 * D * 1024 + D                  # wq wo, wk wv, norm
MAMBA2 = (D * (2 * 8192 + 2 * 128 + 128) + 4 * 8448 + 8448 + 3 * 128
          + 8192 + 8192 * D + D)      # in_proj, conv, dt A D, norms, out
EXPERTS = 3 * 72 * D * 768
MOE = D + D * 72 + 3 * D * 1536                         # norm, router, shared
ACTIVE_LAYER = {"ms": MAMBA2 + MOE + EXPERTS * 10 // 72,
                "as": ATTN + MOE + EXPERTS * 10 // 72}
SHARED = [(D, 1536), (D, 1536), (1536, D)]


@pytest.mark.parametrize("layers", [10, 40])
def test_model_arithmetic_is_the_hand_arithmetic(layers):
    a = dataclasses.replace(load_cell(CELL).arch, n_layers=layers)
    periods = layers // 10
    active = D + periods * (9 * ACTIVE_LAYER["ms"] + ACTIVE_LAYER["as"])
    scan = periods * 9 * 5 * 128 * 64 * 128
    assert G.active_params(a) == active
    assert G.param_count(a) == V * D + D + periods * (
        9 * (MAMBA2 + MOE + EXPERTS) + ATTN + MOE + EXPERTS)
    assert G.model_flops(a, 7) == 2.0 * active * 7 + scan * 7
    period = SHARED * 5 + [(D, D), (D, 1024), (D, 1024), (D, D)] + SHARED * 5
    assert G.step_linears(a) == period * periods


def test_the_decode_step_stays_resident():
    """At batch 8 the step's crossbars (ceil(K / 37) x ceil(M N / 256) a
    linear: 195,840, 32 KiB each) fit the engine's resident bound; 40
    layers would not."""
    from repro_torch.pim import engine

    a = load_cell(CELL).arch
    crossbars = sum(arith.pim_crossbars(8, k, n) for k, n in
                    G.step_linears(a))
    assert crossbars == 195_840
    state = crossbars * arith.PIM_COLS * arith.PIM_WORDS * 4
    assert state == 6_417_285_120 < engine.MAX_RESIDENT_BYTES < 4 * state


def test_the_moe_sublayer_is_a_per_token_sum():
    """The reference's partial MoE output (the routed experts plus the
    shared expert) of generated rows, which route alone, is each row's
    softmax-weighted sum over its top-k experts plus the shared MLP."""
    a = G.Arch.from_model(SMOKE)
    p = {k: v[0] for k, v in G.draw(a, 2 ** 31 + 3, "cpu")["blocks"]["0"]
         .items()}
    hh = torch.randn(6, a.d_model, generator=torch.Generator().manual_seed(0))
    lin = {n: G.Linear(p[n], 24, True) for n in G.SHARED_LINEARS}
    got = G.moe_with_shared(hh, p, lin, a, n_prompt=1)
    silu = torch.nn.functional.silu
    for t in range(hh.shape[0]):
        x = hh[t]
        logits = x @ p["router"]
        top = torch.topk(logits, a.top_k)
        w = torch.softmax(top.values, -1)
        want = sum(w[j] * ((silu(x @ p["w1"][e]) * (x @ p["w3"][e]))
                           @ p["w2"][e])
                   for j, e in enumerate(top.indices.tolist()))
        want = want + (silu(x @ p["w_in"]) * (x @ p["w_gate"])) @ p["w_out"]
        torch.testing.assert_close(got[t], want, rtol=0, atol=1e-5)


def test_a_smoke_cell_serves_with_no_gap(tmp_path, capsys):
    """The harness draws, serves, checks and reads a granite cell at the
    smoke size on the CPU (float32 on both sides: rounding only)."""
    root = _root(tmp_path, SMOKE)
    rc = harness.main(["--workload", "g.quant", "--seed", "2147483999",
                       "--seconds", "0.5", "--trace", "1"], root=root,
                      device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"], out.err[-2000:]
    assert res["checks"]["logit_gap_mean"]["value"] < 1e-5
    # no device work on the CPU: the span shares are left out
    assert "mamba2_mixer_share" not in res["metrics"]
    assert math.isfinite(res["metrics"]["pim_uploads_per_step"]["value"])
