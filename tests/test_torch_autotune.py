"""The port's ``pim.autotune`` against the reference's: the search grid,
its order and the backend mapping; ``tune_key`` strings; the cache and
its counters; plans attached to artifacts; tuned GEMMs and ``sim_linear``
bit-identical to untuned ones; persistence in both directions; warmup
over a parameter tree; an autotuned scheduler serve.

Backend mapping (``repro_torch/pim/autotune.py``): ``"cuda"`` (the CUDA
crossbar kernel) takes the reference's ``"pallas"`` place.  On the CPU the
candidates and the default are the reference's under that mapping
(``numpy`` under pim_sim); on a card pim_sim races ``"cuda"`` alone and
its default is the minimal model, 1024 columns, 37 terms, the kernel.

Trials are wall-clock races; their picks are not asserted here (they
depend on the machine).  ``vs_default >= 1`` follows from the default
racing too, which a test holds with an injected clock."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.pim import autotune as RA
from repro.pim import engine as RE
from repro_torch.models import model_lib as TM
from repro_torch.pim import autotune, engine
from repro_torch.pim.matmul import max_dot_terms

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh():
    for eng, tun in ((engine, autotune), (RE, RA)):
        eng.clear_cache()        # also clears the tuner table + counters
        tun.enable(False)
    yield
    for eng, tun in ((engine, autotune), (RE, RA)):
        eng.clear_cache()
        tun.enable(False)


def _operands(k, m=2, o=4, n_bits=8, seed=0):
    rng = np.random.default_rng(seed)
    hi = 1 << n_bits
    return (torch.as_tensor(rng.integers(0, hi, size=(m, k))),
            torch.as_tensor(rng.integers(0, hi, size=(o, k))))


def _as_reference(p):
    """A port plan as the reference would name it."""
    back = {v: k for k, v in autotune.REFERENCE_BACKENDS.items()}
    return p.to_json() | {"backend": back.get(p.backend, p.backend)}


# --------------------------------------------------------------------------
# candidate enumeration and the backend mapping
# --------------------------------------------------------------------------

def test_candidates_cover_the_search_grid_sorted():
    cands = autotune.candidates(24, 8, (2, 8), "raw", device=CPU)
    execable = [p for p in cands if p.chunk > 0]
    assert {p.model for p in execable} == set(autotune.PARTITIONED_MODELS)
    assert {p.n_cols for p in execable} == set(autotune.GEOMETRIES)
    assert {p.backend for p in execable} == set(autotune.STATE_BACKENDS)
    serial = {p.model for p in cands if p.chunk == 0}
    assert {"serial_fast", "compressor42", "baseline"} <= serial
    pred = [p.predicted_us for p in cands]
    assert pred == sorted(pred)


@pytest.mark.parametrize("pim_mode", ["raw", "pim_sim"])
@pytest.mark.parametrize("k,n_bits,shape", [(24, 8, (2, 8)), (12, 8, (5, 4)),
                                            (96, 8, (2, 64)), (40, 4, (1, 3))])
def test_candidates_and_default_equal_reference(pim_mode, k, n_bits, shape):
    got = autotune.candidates(k, n_bits, shape, pim_mode, device=CPU)
    want = RA.candidates(k, n_bits, shape, pim_mode)
    assert [_as_reference(p) for p in got] == [p.to_json() for p in want]
    assert autotune.default_plan(k, n_bits, shape, pim_mode,
                                 device=CPU).to_json() == \
        RA.default_plan(k, n_bits, shape, pim_mode).to_json()


def test_state_backends_map_the_reference_names():
    assert tuple(autotune.REFERENCE_BACKENDS.get(b, b)
                 for b in RA.STATE_BACKENDS) == autotune.STATE_BACKENDS
    assert autotune.CALLBACK_BACKENDS == RA.CALLBACK_BACKENDS == ("numpy",)


def test_pim_sim_on_the_card_races_the_kernel(monkeypatch):
    """On a card pim_sim races the kernel alone, and its default is what an
    untuned sim_linear runs there (no card needed to build the plans)."""
    monkeypatch.setattr(autotune, "resolve_device",
                        lambda d: torch.device("cuda"))
    cands = autotune.candidates(1024, 8, (2, 2816), "pim_sim")
    assert {p.backend for p in cands if p.chunk > 0} == {"cuda"}
    d = autotune.default_plan(1024, 8, (2, 2816), "pim_sim")
    assert (d.model, d.n_cols, d.chunk, d.backend) == \
        ("minimal", 1024, 37, "cuda")
    assert d.chunk == max_dot_terms(8, 1024)
    raw = autotune.candidates(24, 8, (2, 8), "raw")
    assert {p.backend for p in raw if p.chunk > 0} == \
        set(autotune.STATE_BACKENDS)
    assert autotune.default_plan(24, 8, (2, 8), "raw").backend == "cuda"


def test_cpu_race_skips_the_kernel(monkeypatch):
    """Raw mode on the CPU lists the kernel (the reference's candidates)
    but never races it: it needs a card."""
    raced = []
    monkeypatch.setattr(autotune, "_trial_time",
                        lambda p, *a: raced.append(p.backend) or 1.0)
    autotune.autotune(12, 8, (2, 4), "raw", trials=1, top_k=3, device=CPU)
    assert raced and "cuda" not in raced


def test_tune_key_strings_equal_reference():
    for args in [(24, 8, "minimal", (5, 16), "raw"),
                 (24, 8, "minimal", (8, 16), "raw"),
                 (1024, 8, "minimal", (2, 2816), "pim_sim"),
                 (152064, 8, "minimal", (2, 1024), "pim_sim"),
                 (7, 5, "unlimited", (1, 1), "quant")]:
        assert autotune.tune_key(*args) == RA.tune_key(*args)
    k = autotune.tune_key(24, 8, "minimal", (5, 16), "raw")
    assert k == autotune.tune_key(24, 8, "minimal", (8, 16), "raw")
    assert k != autotune.tune_key(24, 8, "minimal", (9, 16), "raw")
    assert k != autotune.tune_key(24, 8, "minimal", (5, 16), "pim_sim")


# --------------------------------------------------------------------------
# the search
# --------------------------------------------------------------------------

def test_race_includes_the_default_and_never_loses(monkeypatch):
    """An injected clock: each GEMM advances it by a time set per
    configuration.  The default always races, so the pick is never slower
    than it, and every raced candidate is recorded with its own time."""
    now = [0.0]
    cost = {("unlimited", 1024): 5.0, ("unlimited", 2048): 3.0,
            ("unlimited", 4096): 7.0, ("minimal", 1024): 4.0}
    real = engine.matmul_int

    def timed(x, w, n_bits, plan=None, **kw):
        now[0] += cost.get((plan.model, plan.n_cols), 9.0) * 1e-6
        return real(x, w, n_bits, plan=plan, **kw)

    monkeypatch.setattr(autotune, "_now", lambda: now[0])
    monkeypatch.setattr(engine, "matmul_int", timed)
    plan = autotune.autotune(12, 8, (2, 4), "pim_sim", trials=2, top_k=3,
                             device=CPU)
    race = plan.race
    configs = [(p.model, p.n_cols) for p in race]
    assert ("minimal", 1024) in configs          # the default raced
    assert len(race) == 4 and engine.cache_info().tune_trials == 4
    assert (plan.model, plan.n_cols, plan.source) == \
        ("unlimited", 2048, "trial")
    assert plan.trial_us == pytest.approx(3.0)
    assert plan.default_us == pytest.approx(4.0)
    assert plan.vs_default >= 1.0
    assert all(p.default_us == plan.default_us for p in race)
    assert sorted(p.trial_us for p in race) == \
        pytest.approx([3.0, 4.0, 5.0, 7.0])
    # a default faster than every candidate is the pick
    cost[("minimal", 1024)] = 1.0
    again = autotune.autotune(12, 8, (2, 4), "pim_sim", trials=1,
                              force=True, device=CPU)
    assert (again.model, again.n_cols) == ("minimal", 1024)
    assert again.vs_default == 1.0


def test_autotune_caches_and_counts():
    p1 = autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    info = engine.cache_info()
    assert info.tune_misses == 1 and info.tune_hits == 0
    p2 = autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    assert p2 is p1
    assert engine.cache_info().tune_hits == 1
    # the same calls give the reference's pick and counters
    r1 = RA.autotune(12, 8, (2, 4), "raw", trials=0)
    RA.autotune(12, 8, (2, 4), "raw", trials=0)
    assert _as_reference(p1) == r1.to_json()
    ri = RE.cache_info()
    assert (ri.tune_hits, ri.tune_misses, ri.tune_trials) == (1, 1, 0)


def test_plan_attached_to_compiled_artifact():
    plan = autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    art = engine.compile_matmul(min(plan.chunk, 12), 8, model=plan.model,
                                n_cols=plan.n_cols)
    assert art.plan is plan
    assert engine.compile_matmul(min(plan.chunk, 12), 8, model=plan.model,
                                 n_cols=plan.n_cols).plan is plan
    # not part of the key: an untuned artifact carries none
    assert engine.compile_matmul(12, 8, model="standard").plan is None


def test_tuned_matmul_bit_exact_vs_default():
    x, w = _operands(12)
    want = x @ w.T
    default = engine.matmul_int(x, w, 8)
    assert torch.equal(default, want)
    for mode in ("raw", "pim_sim"):
        plan = autotune.autotune(12, 8, (2, 4), mode, trials=0, device=CPU)
        assert torch.equal(engine.matmul_int(x, w, 8, plan=plan), want), mode


@pytest.mark.parametrize("model,n_cols,chunk", [
    ("unlimited", 2048, 5), ("standard", 1024, 7), ("minimal", 4096, 40)])
def test_plan_sets_model_geometry_chunk_and_backend(monkeypatch, model,
                                                    n_cols, chunk):
    """A plan's model, geometry, chunk and backend are what runs, and all
    its chunks (the last zero-padded) still run as one backend call."""
    calls = []
    engine.backends()                               # register the defaults
    real = engine._backends["numpy"]

    def counting(state, microcode, **kw):
        calls.append(tuple(state.shape))
        return real(state, microcode, **kw)

    monkeypatch.setitem(engine._backends, "numpy", counting)
    x, w = _operands(40, m=3, o=5, seed=1)
    plan = autotune.TunedPlan(key="k", kind="gemm", model=model,
                              n_cols=n_cols, chunk=chunk, backend="numpy",
                              predicted_us=0.0)
    got = engine.matmul_int(x, w, 8, plan=plan)
    assert torch.equal(got, x @ w.T)
    p = -(-40 // chunk)
    assert calls == [(p, n_cols, 8)]              # one crossbar per chunk
    art = engine.compile_matmul(min(40, chunk), 8, model=model,
                                n_cols=n_cols)
    assert engine.cache_info().builds >= 1 and art.n_cols == n_cols
    assert art.program.model == model


def test_tune_ctx_lookup_is_gated_on_enable():
    x, w = _operands(12)
    plan = autotune.autotune(12, 8, (2, 4), "pim_sim", trials=0, device=CPU)
    assert autotune.lookup(12, 8, shape=(2, 4), pim_mode="pim_sim") is None
    autotune.enable(True)
    assert autotune.lookup(12, 8, shape=(2, 4), pim_mode="pim_sim") is plan
    before = engine.cache_info().tune_hits
    y = engine.matmul_int(x, w, 8, tune_ctx="pim_sim")
    assert engine.cache_info().tune_hits == before + 1
    assert torch.equal(y, engine.matmul_int(x, w, 8))


def test_sim_linear_tuned_matches_untuned_bit_exactly():
    """The serving contract: a tuned pim_sim linear changes nothing, and
    both equal the reference's sim_linear."""
    rng = np.random.default_rng(3)
    xn = rng.normal(size=(2, 6)).astype(np.float32)
    wn = rng.normal(size=(6, 4)).astype(np.float32)
    x, w = torch.as_tensor(xn), torch.as_tensor(wn)
    ref = engine.sim_linear(x, w)
    assert np.array_equal(ref.numpy(),
                          np.asarray(RE.sim_linear(jnp.asarray(xn),
                                                   jnp.asarray(wn))))
    # sim_linear quantizes to 7 bits and multiplies at 8 (offset-shifted)
    plan = autotune.autotune(6, 8, (2, 4), "pim_sim", trials=0, device=CPU)
    assert (plan.model, plan.backend) != ("minimal", "")
    autotune.enable(True)
    tuned = engine.sim_linear(x, w)
    assert torch.equal(tuned, ref)
    assert engine.cache_info().tune_hits >= 1


# --------------------------------------------------------------------------
# persistence
# --------------------------------------------------------------------------

def test_table_roundtrip_preserves_picks(tmp_path):
    p_raw = autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    p_sim = autotune.autotune(12, 8, (2, 4), "pim_sim", trials=0, device=CPU)
    path = str(tmp_path / "table.json")
    assert autotune.save_table(path) == 2
    engine.clear_cache()
    assert autotune.table_info().size == 0
    assert autotune.load_table(path, device=CPU) == 2
    autotune.enable(True)
    for orig, mode in ((p_raw, "raw"), (p_sim, "pim_sim")):
        got = autotune.lookup(12, 8, shape=(2, 4), pim_mode=mode)
        assert got is not None and got.source == "table"
        assert (got.model, got.n_cols, got.chunk, got.backend) == \
            (orig.model, orig.n_cols, orig.chunk, orig.backend)
    x, w = _operands(12)
    plan = autotune.lookup(12, 8, shape=(2, 4), pim_mode="raw")
    assert torch.equal(engine.matmul_int(x, w, 8, plan=plan),
                       engine.matmul_int(x, w, 8))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_table_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / f"{writer}.json")
    calls = [(12, 8, (2, 4), "raw"), (12, 8, (2, 4), "pim_sim"),
             (40, 8, (3, 16), "pim_sim")]
    if writer == "reference":
        picks = [RA.autotune(*c, trials=0) for c in calls]
        picks.append(RA.autotune(6, 8, (1, 2), "raw", trials=0,
                                 backends=("pallas",)))
        assert RA.save_table(path) == 4
        assert autotune.load_table(path, device=CPU) == 4
        got = autotune._table
    else:
        picks = [autotune.autotune(*c, trials=0, device=CPU) for c in calls]
        assert autotune.save_table(path) == 3
        assert RA.load_table(path) == 3
        got = RA._table
    for p in picks:
        q = got[p.key]
        assert q.source == "table"
        want = p.to_json() | {"source": "table"}
        if writer == "reference" and p.backend == "pallas":
            # the reference's Pallas kernel reads as the port's CUDA kernel,
            # which a CPU state cannot take: the CPU's raw default runs
            assert autotune.REFERENCE_BACKENDS[p.backend] == "cuda"
            want["backend"] = "scan"
        assert q.to_json() == want
    with open(path) as f:
        assert json.load(f)["version"] == autotune.TABLE_VERSION == \
            RA.TABLE_VERSION


def test_reference_pim_sim_table_runs_the_kernel_on_a_card(tmp_path,
                                                          monkeypatch):
    """The reference tunes pim_sim on its host interpreter (``numpy``).
    Loaded on a card, every GEMM pick runs the kernel: the host oracles
    cannot take card state, so a table never moves the card's work to the
    host (no card needed to load a table)."""
    path = str(tmp_path / "reference.json")
    for c in [(12, 8, (2, 4), "pim_sim"), (40, 8, (3, 16), "pim_sim"),
              (12, 8, (2, 4), "raw")]:
        RA.autotune(*c, trials=0)
    assert {p.backend for p in RA._table.values()} >= {"numpy"}
    RA.save_table(path)
    monkeypatch.setattr(autotune, "resolve_device",
                        lambda d: torch.device("cuda"))
    assert autotune.load_table(path) == 3
    autotune.enable(True)
    for k, o, m in [(12, 4, 2), (40, 16, 3)]:
        plan = autotune.lookup(k, 8, shape=(m, o), pim_mode="pim_sim")
        assert plan.backend == "cuda" and plan.source == "table"
    assert {p.backend for p in autotune._table.values()} == {"cuda"}


@pytest.mark.parametrize("name", ["scan", "jnp", "unrolled", "numpy"])
def test_host_oracles_refuse_a_cuda_state(name):
    """A host oracle named for card state raises, as ``cuda`` does for a
    CPU state: neither silently copies the work to the other device."""
    class CardState:
        device = torch.device("cuda")

    mc = engine.compile_matmul(4, 8).microcode
    with pytest.raises(ValueError, match="host oracle"):
        engine.execute_state(CardState(), mc, backend=name)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        engine.execute_state(torch.zeros(1, 1024, 8, dtype=torch.int32), mc,
                             backend="cuda")


def test_table_version_mismatch_raises(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"version": 0, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        autotune.load_table(str(path), device=CPU)


def test_clear_cache_clears_the_tuner_table():
    autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    assert autotune.table_info().size == 1
    engine.clear_cache()
    info = autotune.table_info()
    assert info.size == 0 and info.misses == 0 and info.trials == 0
    autotune.enable(True)
    assert autotune.lookup(12, 8, shape=(2, 4), pim_mode="raw") is None


def test_cache_info_merges_tune_counters():
    info = engine.cache_info()
    assert (info.tune_hits, info.tune_misses, info.tune_trials) == (0, 0, 0)
    autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    info = engine.cache_info()
    assert info.tune_misses == 1 and info.tune_hits == 1


def test_summary_equals_reference():
    assert autotune.summary().startswith("off, 0 plan(s)")
    assert autotune.summary() == RA.summary()
    for tun in (autotune, RA):
        tun.enable(True)
    plan = autotune.autotune(12, 8, (2, 4), "raw", trials=0, device=CPU)
    RA.autotune(12, 8, (2, 4), "raw", trials=0)
    s = autotune.summary()
    assert s.startswith("on, 1 plan(s)")
    assert plan.model in s and str(plan.n_cols) in s
    assert s == RA.summary()


# --------------------------------------------------------------------------
# warmup over a parameter tree, and the scheduler
# --------------------------------------------------------------------------

def test_plan_for_params_walks_stacked_layer_leaves():
    params = {"stacked": torch.zeros((3, 6, 8)),
              "flat": torch.zeros((6, 8)),
              "other": [torch.zeros((12, 4))],
              "vec": torch.zeros((5,))}
    n = autotune.plan_for_params(params, max_batch=2, trials=0, device=CPU)
    assert n == 2   # (6, 8) deduplicates across the 2-D and 3-D leaves
    autotune.enable(True)
    assert autotune.lookup(6, 8, shape=(2, 8), pim_mode="pim_sim") is not None
    assert autotune.lookup(12, 8, shape=(2, 4),
                           pim_mode="pim_sim") is not None


@pytest.fixture(scope="module")
def smoke():
    import jax

    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(max_seq_len=24,
                                                  pim_mode="pim_sim")
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(max_seq_len=24,
                                                  pim_mode="pim_sim")
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t, device=CPU)
    return cfg_t, pr, pt


def test_plan_for_params_plans_the_reference_keys(smoke):
    """The same walk: the smoke model's tree gives the reference's keys and
    (cost-model) picks, including the leaves no linear multiplies by."""
    _, pr, pt = smoke
    n = autotune.plan_for_params(pt, max_batch=2, trials=0, device=CPU)
    assert n == RA.plan_for_params(pr, max_batch=2, trials=0)
    assert sorted(autotune._table) == sorted(RA._table)
    for key, p in autotune._table.items():
        assert _as_reference(p) == RA._table[key].to_json()


def test_scheduler_autotune_serves_the_untuned_tokens(smoke):
    from repro_torch.serving import (Scheduler, ServingConfig,
                                     synthetic_requests)

    cfg, _, pt = smoke

    def serve(**kw):
        sched = Scheduler(pt, cfg, ServingConfig(max_batch=2, prompt_bucket=8,
                                                 paged=True, **kw),
                          device=CPU)
        reqs = synthetic_requests(2, vocab_size=cfg.vocab_size,
                                  prompt_lens=[5, 9], max_new_tokens=3,
                                  seed=3, start_time=0.0)
        rids = [sched.submit_request(r) for r in reqs]
        out = sched.run()
        return [out[r].tolist() for r in rids], sched

    want, plain = serve()
    assert plain.autotuned_shapes == 0 and not autotune.enabled()
    got, sched = serve(autotune=True, autotune_trials=0)
    assert got == want
    assert sched.autotuned_shapes == 5 and autotune.enabled()
    info = engine.cache_info()
    # every decode step's 7 linears hit the table (2 steps)
    assert info.tune_hits >= 14 and info.tune_trials == 0
    assert any(p.n_cols != 1024 for p in autotune._table.values())


def test_serve_cli_saves_and_reloads_the_table(tmp_path, capsys):
    """``--autotune-table``: the first run plans and saves; the second
    loads the picks before warmup, makes no trial, and serves the same
    tokens."""
    from repro_torch.launch import serve as serve_cli

    path = str(tmp_path / "picks.json")
    argv = ["--smoke", "--device", "cpu", "--pim-mode", "pim_sim",
            "--batch", "2", "--requests", "2", "--prompt-lens", "5",
            "--max-new-tokens", "2", "--paged", "--autotune",
            "--autotune-trials", "0", "--autotune-table", path]
    first = serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "[autotune] on, 5 plan(s)" in out and "saved 5 plan(s)" in out
    engine.clear_cache()
    second = serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "[autotune] loaded 5 plan(s)" in out
    info = engine.cache_info()
    assert info.tune_trials == 0 and info.tune_hits >= 5
    assert [first[r].tolist() for r in sorted(first)] == \
        [second[r].tolist() for r in sorted(second)]


def test_serve_cli_refuses_autotune_for_quant(capsys):
    """``--autotune`` under ``quant`` (refused before ``quant_tp`` was
    ported) now races the two int8 lowerings after the serve, as the
    reference's CLI does: one pick under the reference's key, both
    candidates timed, two trials counted."""
    from repro_torch.launch import serve as serve_cli

    engine.clear_cache()
    serve_cli.main(["--smoke", "--device", "cpu", "--pim-mode", "quant",
                    "--batch", "2", "--requests", "2", "--prompt-lens", "5",
                    "--max-new-tokens", "2", "--autotune"])
    out = capsys.readouterr().out
    assert "[autotune] linear:t2d64o64: quant" in out
    assert "quant_tp" in out
    info = engine.cache_info()
    assert info.tune_trials == 2 and info.tune_misses == 1
    plan = autotune.autotune_linear(2, 64, 64, device="cpu")
    assert plan.kind == "linear" and plan.key == "linear:t2d64o64"
    assert [p.model for p in plan.race] == ["quant", "quant_tp"]
    assert engine.cache_info().tune_hits == 1
    rplan = RA.autotune_linear(2, 64, 64, trials=1, force=True)
    assert (rplan.key, rplan.kind) == (plan.key, plan.kind)
