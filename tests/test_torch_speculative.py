"""The port's self-speculative decoding, held to ``repro`` on the cases of
tests/test_speculative.py (the router kill waits with the router;
``quant_tp`` without a mesh is ``quant``, tests/test_torch_tp.py).

Each serving case runs one seeded trace with the same weights (the
reference's ``init_params``, imported by ``from_reference``) on a tiny
float32 model: speculative tokens must equal plain decode's and the
reference's.  Rejected drafts are forced by sabotaging the draft step,
which exercises rollback across paged blocks and at pool capacity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro.serving import accept_length as r_accept_length
from repro.serving import make_request as r_make_request
from repro_torch.models import model_lib as TM
from repro_torch.pim import engine
from repro_torch.serving import (Scheduler, ServingConfig, accept_length,
                                 make_request)

LOGIT_TOL = 1e-4      # float32 logits, as in test_torch_model.py


def _tiny(mode, **extra):
    kw = dict(n_layers=1, pattern=("ad",), d_model=32, n_heads=2,
              n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
              pad_vocab_multiple=8, loss_chunk=8, max_seq_len=48,
              pim_mode=mode, **extra)
    return (RC.get("qwen1.5-0.5b").smoke().scaled(**kw),
            TC.get("qwen1.5-0.5b").smoke().scaled(**kw))


def _pair(cfg_r, cfg_t, seed):
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return pr, pt


def _trace(vocab, seed=0, n=5, gen=(8, 6, 7, 5, 6)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, (3, 5, 4, 6, 4)[i]), gen[i])
            for i in range(n)]


def _run_port(params, cfg, scfg, reqs, sabotage=False):
    sched = Scheduler(params, cfg, scfg, device="cpu")
    if sabotage:
        _sabotage_drafts(sched)
    rids = [sched.submit_request(make_request(p, g)) for p, g in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


def _run_ref(params, cfg, scfg, reqs):
    sched = RScheduler(params, cfg, RServingConfig(**scfg))
    rids = [sched.submit_request(r_make_request(p, g)) for p, g in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


def _sabotage_drafts(sched):
    """Every draft token off by one: the verify pass must reject
    everything after position 0."""
    spec = sched._spec
    orig = spec._draft

    def bad_draft(p, tokens, pos, active, caches, tables):
        tok, logits, caches = orig(p, tokens, pos, active, caches, tables)
        return (tok + 1) % sched.cfg.vocab_size, logits, caches

    spec._draft = bad_draft


def _spec_summary_checks(sched, k):
    assert sched.decode_traces == 1
    assert sched.draft_traces == 1 and sched.verify_traces == 1
    s = sched.metrics.summary()
    assert s["spec_rounds"] > 0
    assert s["verified_tokens"] == k * s["spec_rounds"]
    assert s["drafted_tokens"] == (k - 1) * s["spec_rounds"]
    assert 1.0 <= s["mean_accept_len"] <= k
    # one on_spec_round per decoding slot per verify step
    assert sched.verify_steps <= s["spec_rounds"] <= \
        sched.verify_steps * sched.scfg.max_batch
    return s


# ---------------------------------------------------------------------------
# tokens equal plain decode and the reference, per verify mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_spec_tokens_equal_reference(mode):
    """The quant verify drafts with the float xla mode and the xla verify
    with quant, so drafts are rejected at some positions: exactness is
    exercised with imperfect acceptance."""
    draft = "xla" if mode == "quant" else "quant"
    cfg_r, cfg_t = _tiny(mode)
    pr, pt = _pair(cfg_r, cfg_t, 0)
    reqs = _trace(cfg_t.vocab_size, seed=1)
    base = dict(max_batch=3, prompt_bucket=4, paged=True, block_size=4)
    spec = dict(speculative=True, draft_mode=draft, draft_k=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, got = _run_port(pt, cfg_t, ServingConfig(**base, **spec), reqs)
    rsched, ref = _run_ref(pr, cfg_r, dict(**base, **spec), reqs)
    assert got == plain == ref, f"speculative divergence under {mode}"
    s = _spec_summary_checks(sched, 4)
    rs = rsched.metrics.summary()
    assert s["accept_len_hist"] == rs["accept_len_hist"]
    assert s["accepted_tokens"] == rs["accepted_tokens"]


def test_spec_pim_sim_equals_plain_and_reference():
    """pim_sim verify, quant draft, at smoke size with few tokens: the
    speculative run equals the port's plain run, which equals the
    reference's plain run.  The quant draft rounds to 8 bits and the
    verify to 7, so its acceptance is whatever it is: measured, not
    assumed."""
    cfg_r, cfg_t = _tiny("pim_sim")
    pr, pt = _pair(cfg_r, cfg_t, 0)
    reqs = _trace(cfg_t.vocab_size, seed=1, n=2, gen=(5, 4))
    base = dict(max_batch=2, prompt_bucket=4, paged=True, block_size=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, got = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="quant", draft_k=3, **base), reqs)
    _, ref = _run_ref(pr, cfg_r, base, reqs)
    assert got == plain == ref
    _spec_summary_checks(sched, 3)


def test_spec_contiguous_pool_equals_reference():
    """The contiguous pool writes a run one position at a time and drops
    writes past its capacity — same exactness, other rollback mechanics."""
    cfg_r, cfg_t = _tiny("xla")
    pr, pt = _pair(cfg_r, cfg_t, 3)
    reqs = _trace(cfg_t.vocab_size, seed=4)
    base = dict(max_batch=3, prompt_bucket=4)
    spec = dict(speculative=True, draft_mode="quant", draft_k=3)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, got = _run_port(pt, cfg_t, ServingConfig(**base, **spec), reqs)
    _, ref = _run_ref(pr, cfg_r, dict(**base, **spec), reqs)
    assert got == plain == ref
    _spec_summary_checks(sched, 3)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_decode_run_equals_single_steps(mode, paged):
    """One (B, k) decode_run_slots gives, per position, the bits of k
    single-position decode_step_slots fed the same tokens — logits and
    every cache row — and matches the reference's decode_run_slots."""
    cfg_r, cfg_t = _tiny(mode)
    pr, pt = _pair(cfg_r, cfg_t, 5)
    b, k, bs = 2, 3, 4
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg_t.vocab_size, (b, k))
    pos = np.array([5, 9])
    active = np.array([True, True])
    if paged:
        bps = cfg_t.max_seq_len // bs
        nblocks = b * bps + 1
        specs = TM.paged_cache_specs(cfg_t, b, cfg_t.max_seq_len, nblocks,
                                     bs)
        tables = np.arange(1, b * bps + 1).reshape(b, bps)
    else:
        specs = TM.cache_specs(cfg_t, b, cfg_t.max_seq_len)
        tables = None
    fill = rng.normal(size=(1 << 16,)).astype(np.float32)

    def caches():
        out = {}
        for i, c in specs.items():
            out[i] = {}
            for key, (shape, dt) in c.items():
                n = int(np.prod(shape))
                out[i][key] = torch.from_numpy(
                    np.resize(fill, n).reshape(shape)).to(dt)
        return out

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))

    run_caches, step_caches = caches(), caches()
    ref_caches = {i: {key: jnp.asarray(run_caches[i][key].numpy())
                      for key in c} for i, c in run_caches.items()}
    vt, logits, _ = TM.decode_run_slots(pt, t(toks), t(pos), t(active),
                                        run_caches, cfg_t,
                                        block_tables=t(tables))
    for i in range(k):
        tok, lg, _ = TM.decode_step_slots(
            pt, t(toks[:, i:i + 1]), t(pos + i), t(active), step_caches,
            cfg_t, block_tables=t(tables))
        assert torch.equal(lg, logits[:, i]), f"position {i}"
        assert torch.equal(tok[:, 0], vt[:, i])
    for i, c in run_caches.items():
        for key, leaf in c.items():
            assert torch.equal(leaf, step_caches[i][key]), key
    rvt, rlogits, _ = RM.decode_run_slots(
        pr, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), ref_caches, cfg_r,
        block_tables=None if tables is None
        else jnp.asarray(tables, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(rvt))


# ---------------------------------------------------------------------------
# degenerate configs: draft_k=1 and draft == verify short-circuit
# ---------------------------------------------------------------------------

def test_spec_draft_k1_degenerates_to_plain_decode():
    _, cfg_t = _tiny("xla")
    _, pt = _pair(*_tiny("xla"), 0)
    reqs = _trace(cfg_t.vocab_size, seed=2)
    base = dict(max_batch=3, prompt_bucket=4, paged=True, block_size=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, spec = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="quant", draft_k=1, **base), reqs)
    assert sched._spec is None, "draft_k=1 must short-circuit"
    assert sched.draft_traces == 0 and sched.verify_traces == 0
    assert sched.metrics.summary()["spec_rounds"] == 0
    assert plain == spec


def test_spec_draft_equals_verify_short_circuits():
    _, cfg_t = _tiny("quant")
    _, pt = _pair(*_tiny("quant"), 0)
    sched = Scheduler(pt, cfg_t, ServingConfig(
        max_batch=2, prompt_bucket=4, speculative=True, draft_mode="quant",
        draft_k=4), device="cpu")
    assert sched._spec is None
    rid = sched.submit_request(make_request(np.array([1, 2, 3]), 4))
    out = sched.run()
    assert len(out[rid]) == 4
    assert sched.draft_traces == 0 and sched.decode_traces == 1


# ---------------------------------------------------------------------------
# adversarial rollback: sabotaged drafts
# ---------------------------------------------------------------------------

def test_spec_all_rejected_makes_forward_progress():
    """A draft wrong at every position still emits one verify-mode token
    per round: the same generations, accept length 1 throughout."""
    _, cfg_t = _tiny("xla")
    _, pt = _pair(*_tiny("xla"), 5)
    reqs = _trace(cfg_t.vocab_size, seed=6)
    base = dict(max_batch=3, prompt_bucket=4, paged=True, block_size=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, got = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="quant", draft_k=4, **base), reqs,
        sabotage=True)
    assert got == plain
    s = sched.metrics.summary()
    assert s["mean_accept_len"] == 1.0
    assert set(s["accept_len_hist"]) == {1}
    assert s["accepted_tokens"] == s["spec_rounds"]


def test_spec_rollback_across_paged_block_boundary():
    """With block_size 4 and draft_k 4 every verify run straddles two KV
    blocks at some round; sabotaged drafts force a rollback every round,
    leaving garbage rows in the next block that must stay invisible."""
    _, cfg_t = _tiny("xla")
    _, pt = _pair(*_tiny("xla"), 7)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(1, cfg_t.vocab_size, p), g)
            for p, g in ((3, 12), (5, 10), (4, 11))]
    base = dict(max_batch=3, prompt_bucket=4, paged=True, block_size=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    sched, got = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="quant", draft_k=4, **base), reqs,
        sabotage=True)
    assert got == plain
    assert sched.decode_traces == 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("width", [1, 3])
def test_write_past_capacity_is_discarded(paged, width):
    """A decode step at positions at or past capacity (where the draft loop
    and the verify run drive slots near the end of their budget) leaves
    every committed row untouched: the paged path writes to the trash
    block 0, the contiguous path drops the write."""
    _, cfg_t = _tiny("xla")
    _, pt = _pair(*_tiny("xla"), 11)
    b, bs = 2, 4
    tok = torch.tensor([[5, 6, 7], [7, 8, 9]])[:, :width]
    active = torch.ones(b, dtype=torch.bool)
    if paged:
        bps = cfg_t.max_seq_len // bs
        nblocks = 2 * bps + 1
        specs = TM.paged_cache_specs(cfg_t, b, cfg_t.max_seq_len, nblocks, bs)
        tables = torch.arange(1, 2 * bps + 1).reshape(b, bps)
        lcap = bps * bs
        pos = torch.tensor([lcap, lcap + 1])
    else:
        specs = TM.cache_specs(cfg_t, b, cfg_t.max_seq_len)
        tables = None
        pos = torch.full((b,), cfg_t.max_seq_len)
    caches = {i: {k: torch.ones(shape, dtype=dt)
                  for k, (shape, dt) in c.items()}
              for i, c in specs.items()}
    before = {k: v.clone() for k, v in caches["0"].items()}
    fn = TM.decode_step_slots if width == 1 else TM.decode_run_slots
    fn(pt, tok, pos, active, caches, cfg_t, block_tables=tables)
    for key, old in before.items():
        new = caches["0"][key]
        if paged:
            assert torch.equal(new[:, 1:], old[:, 1:]), \
                f"{key}: past-capacity write escaped the trash block"
        else:
            assert torch.equal(new, old), \
                f"{key}: past-capacity write was not dropped"


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_spec_request_at_pool_capacity(paged):
    """prompt + budget == pool capacity drives the draft's writes up to
    draft_k - 2 rows past the slot's last reserved position; discarded
    writes keep every live row, so the generation equals plain decode."""
    _, cfg_t = _tiny("xla")
    _, pt = _pair(*_tiny("xla"), 11)
    rng = np.random.default_rng(12)
    prompt = rng.integers(1, cfg_t.vocab_size, 4)
    reqs = [(prompt, cfg_t.max_seq_len - len(prompt))]
    base = dict(max_batch=2, prompt_bucket=4)
    if paged:
        base.update(paged=True, block_size=4)
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    _, got = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="quant", draft_k=4, **base), reqs,
        sabotage=True)
    assert got == plain, "a past-capacity draft write corrupted a live row"


def test_draft_runs_in_the_draft_namespace():
    """A pim_sim draft for a quant verify keeps its crossbar state in the
    "draft" session pool; the verify path's pool stays empty."""
    _, cfg_t = _tiny("quant")
    _, pt = _pair(*_tiny("quant"), 0)
    reqs = _trace(cfg_t.vocab_size, seed=1, n=2, gen=(3, 3))
    base = dict(max_batch=2, prompt_bucket=4, paged=True, block_size=4)
    engine.clear_cache()
    _, plain = _run_port(pt, cfg_t, ServingConfig(**base), reqs)
    _, got = _run_port(pt, cfg_t, ServingConfig(
        speculative=True, draft_mode="pim_sim", draft_k=2, **base), reqs)
    assert got == plain
    spaces = {key[3] for key in engine._sessions}
    assert spaces == {"draft"}
    assert engine.cache_info().resident_entries > 0
    engine.clear_cache()


# ---------------------------------------------------------------------------
# validation + the acceptance rule
# ---------------------------------------------------------------------------

def test_spec_config_validation():
    smoke = TC.get("qwen1.5-0.5b").smoke()
    with pytest.raises(ValueError, match="draft_mode"):
        Scheduler(None, smoke, ServingConfig(speculative=True,
                                             draft_mode="nope"),
                  device="cpu")
    with pytest.raises(ValueError, match="draft_k"):
        Scheduler(None, smoke, ServingConfig(speculative=True, draft_k=0),
                  device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        Scheduler(None, smoke.scaled(sliding_window=8),
                  ServingConfig(speculative=True, draft_mode="quant"),
                  device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        Scheduler(None, smoke.scaled(n_experts=4),
                  ServingConfig(speculative=True), device="cpu")
    with pytest.raises(ValueError, match="draft_k >= 2"):
        from repro_torch.serving.speculative import SpeculativeDecoder

        SpeculativeDecoder(smoke, "quant", 1)


def test_accept_length_rule():
    f = np.array
    cases = [([7, 1, 2, 3], [1, 2, 3, 4], 4), ([7, 1, 2, 3], [1, 2, 9, 4], 3),
             ([7, 1, 2, 3], [1, 9, 3, 4], 2), ([7, 1, 2, 3], [9, 1, 2, 3], 1),
             # a later re-match after a mismatch must not extend the prefix
             ([7, 1, 2, 3], [9, 2, 3, 4], 1), ([5], [8], 1)]
    for fed, verify, n in cases:
        assert accept_length(f(fed), f(verify)) == n
        assert r_accept_length(f(fed), f(verify)) == n


def test_serve_cli_speculative_on_cpu(capsys):
    """``--speculative`` through the CLI: the tokens of the plain serve
    and a ``[spec]`` line with the measured acceptance."""
    from repro_torch.launch import serve as serve_cli

    args = ["--smoke", "--device", "cpu", "--pim-mode", "quant", "--paged",
            "--requests", "3", "--batch", "2", "--prompt-lens", "5,9",
            "--max-new-tokens", "6"]
    plain = serve_cli.main(args)
    capsys.readouterr()
    spec = serve_cli.main(args + ["--speculative", "--draft-mode", "xla",
                                  "--draft-k", "3"])
    out = capsys.readouterr().out
    assert "[spec] draft xla k=3" in out and "verify steps" in out
    assert "1 decode shapes" in out
    assert [plain[r].tolist() for r in sorted(plain)] == \
        [spec[r].tolist() for r in sorted(spec)]
