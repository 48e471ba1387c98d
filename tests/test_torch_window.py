"""Sliding-window attention and serving in the port, held to ``repro`` on
the windowed cases of tests/test_lm_correctness.py,
tests/test_serving_paged.py, tests/test_serving_prefix.py and
tests/test_serving_chunked.py.

Models: ``configs.get("h2o-danube-1.8b").smoke()`` (window 16, GQA) and
the qwen1.5-0.5b smoke model ``.scaled(sliding_window=...)``, float32, the
reference's weights imported by ``from_reference``.  Tolerances are those
of tests/test_torch_model.py: logits within ``LOGIT_TOL`` = 1e-4 (the two
stacks reduce in different orders), caches within ``CACHE_TOL`` = 1e-5;
greedy tokens equal; integer ring positions and block layouts exact.
``pim_sim`` cases hold the port's served tokens to the port's own
oracles (the reference's host interpreter would take minutes a case) and
its prefill to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.models.layers import rms_norm as r_rms_norm
from repro.models.layers import unembed as r_unembed
from repro.pim import engine as r_engine
from repro.serving import PagedCachePool as RPaged
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro.serving import make_request as r_make_request
from repro_torch.models import model_lib as TM
from repro_torch.models.layers import rms_norm, unembed
from repro_torch.pim import engine
from repro_torch.serving import (PagedCachePool, Scheduler, ServingConfig,
                                 make_request)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


def _pair(cfg_r, cfg_t, seed):
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return pr, pt


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_logits(want, got, tol=LOGIT_TOL):
    want, got = np.asarray(want), got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


@pytest.fixture(scope="module")
def danube():
    cfg_r = RC.get("h2o-danube-1.8b").smoke()
    cfg_t = TC.get("h2o-danube-1.8b").smoke()
    assert cfg_t.sliding_window == 16 and cfg_t.n_kv_heads < cfg_t.n_heads
    return (cfg_r, cfg_t) + _pair(cfg_r, cfg_t, 1)


@pytest.fixture(scope="module")
def qwen_w():
    """The reference serving tests' windowed model: the qwen smoke model
    with a 16-token window, and its unwindowed twin on the same
    weights."""
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    pr, pt = _pair(cfg_r, cfg_t, 0)
    return (cfg_r.scaled(sliding_window=16), cfg_t.scaled(sliding_window=16),
            pr, pt, cfg_r, cfg_t)


def _port_forward_last(params, toks, cfg):
    """Cache-free windowed forward of every token (the train mode's
    stack): the last position's logits."""
    x = TM._embed_in(params, toks, cfg)
    x, _ = TM._decoder_stack(params, x, cfg,
                             positions=torch.arange(toks.shape[1]),
                             mode="train")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, -1], TM._unembed_table(params, cfg))


def _ref_forward_last(params, toks, cfg):
    x = RM._embed_in(params, jnp.asarray(toks, jnp.int32), cfg)
    x, _ = RM._decoder_stack(params, x, cfg,
                             positions=jnp.arange(toks.shape[1]),
                             mode="train")
    x = r_rms_norm(x, params["final_norm"], cfg.norm_eps)
    return r_unembed(x[:, -1], RM._unembed_table(params, cfg))


# ---------------------------------------------------------------------------
# the ring: congruence, prefill layout, decode past the window
# ---------------------------------------------------------------------------

def test_ring_slot_positions_exact_on_a_grid():
    last = np.arange(-1, 70)[:, None]
    for ring, window in ((16, 16), (16, 13), (8, 8), (24, 20), (5, 3)):
        r = np.arange(ring)[None, :]
        want_p, want_v = RM.ring_slot_positions(jnp.asarray(last),
                                                jnp.asarray(r), ring, window)
        got_p, got_v = TM.ring_slot_positions(_t(last), _t(r), ring, window)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the scalar form the pool's admit layout uses
    p, v = TM.ring_slot_positions(28, torch.arange(16), 16, 16)
    assert p.tolist() == [16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
                          13, 14, 15] and bool(v.all())


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_windowed_prefill_ring_matches_reference(danube, mode):
    """Logits and the ring cache of a prompt shorter than, equal to and
    longer than the window (danube smoke, window 16): the ring keeps the
    last window positions, position p at index p % cap."""
    cfg_r, cfg_t, pr, pt = danube
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    rng = np.random.default_rng(2)
    lens = (29,) if mode == "pim_sim" else (11, 16, 29)
    for s in lens:
        toks = rng.integers(0, cfg_r.vocab_size, (1, s)).astype(np.int32)
        lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr)
        lt, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, ct)
        _assert_logits(lr, lt)
        cap = min(16, max(s, cfg_t.max_seq_len))
        for key in ("k", "v"):
            assert cache_t["0"][key].shape == cache_r["0"][key].shape
            assert cache_t["0"][key].shape[2] == cap
            np.testing.assert_allclose(cache_t["0"][key].numpy(),
                                       np.asarray(cache_r["0"][key]),
                                       rtol=0, atol=CACHE_TOL)


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_decode_past_twice_the_window_matches_reference(danube, mode):
    """The analogue of test_lm_correctness.py::test_swa_ring_buffer_long_
    decode: prefill 24 tokens, decode to 40 (past 2x the window) one step
    at a time; every step's logits equal the reference's, and the last
    equals a cache-free windowed forward of all 40 tokens."""
    cfg_r, cfg_t, pr, pt = danube
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    total = 40
    toks = np.random.default_rng(2).integers(0, cfg_r.vocab_size,
                                             (1, total)).astype(np.int32)
    _, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks[:, :24])}, cr)
    _, cache_t = TM.prefill(pt, {"tokens": _t(toks[:, :24]).long()}, ct)
    for pos in range(24, total):
        _, lr, cache_r = RM.decode_step(pr, jnp.asarray(toks[:, pos:pos + 1]),
                                        jnp.int32(pos), cache_r, cr)
        _, lt, cache_t = TM.decode_step(pt, _t(toks[:, pos:pos + 1]).long(),
                                        pos, cache_t, ct)
        _assert_logits(lr, lt)
    with engine.mode(mode):
        want = _port_forward_last(pt, _t(toks).long(), ct)
    np.testing.assert_allclose(lt.numpy(), want.detach().numpy(), rtol=2e-3,
                               atol=2e-3)
    with r_engine.mode(mode):
        _assert_logits(_ref_forward_last(pr, toks, cr), want)


def test_decode_matches_forward_danube(danube):
    """test_lm_correctness.py::test_decode_matches_forward for danube:
    prefill(x[:L]) + one decode step == forward(x[:L+1]), L past the
    window, batch 2."""
    cfg_r, cfg_t, pr, pt = danube
    rng = np.random.default_rng(1)
    L = 24
    toks = rng.integers(0, cfg_t.vocab_size, (2, L + 1))
    _, caches = TM.prefill(pt, {"tokens": _t(toks[:, :L])}, cfg_t)
    _, logits_dec, _ = TM.decode_step(pt, _t(toks[:, L:L + 1]), L, caches,
                                      cfg_t)
    logits_fwd = _port_forward_last(pt, _t(toks), cfg_t)
    np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.detach().numpy(),
                               rtol=2e-3, atol=2e-3)
    _assert_logits(_ref_forward_last(pr, toks, cfg_r), logits_fwd)


def test_per_slot_decode_wraps_the_contiguous_ring(danube):
    """Continuous-batching decode over the contiguous ring: per-slot
    positions on both sides of the window, one slot wrapping; logits and
    the ring equal the reference's."""
    cfg_r, cfg_t, pr, pt = danube
    toks = np.random.default_rng(4).integers(0, cfg_r.vocab_size,
                                             (2, 20)).astype(np.int32)
    _, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r)
    _, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, cfg_t)
    nxt = toks[:, :1]
    for step in range(3):
        pos = np.array([20 + step, 9 + step], np.int32)
        active = np.array([True, True])
        tr, lr, cache_r = RM.decode_step_slots(
            pr, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(active),
            cache_r, cfg_r)
        tt, lt, cache_t = TM.decode_step_slots(
            pt, _t(nxt).long(), _t(pos), _t(active), cache_t, cfg_t)
        _assert_logits(lr, lt)
        nxt = np.asarray(tr)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t["0"][key].numpy(),
                                   np.asarray(cache_r["0"][key]), rtol=0,
                                   atol=CACHE_TOL)


def test_multi_position_decode_refuses_windows(danube):
    _, cfg_t, _, pt = danube
    specs = TM.paged_cache_specs(cfg_t, 1, 32, 5, 8)
    caches = TM.zeros_like_specs(specs, "cpu")
    table = torch.tensor([[1, 2]])
    with pytest.raises(ValueError, match="sliding_window"):
        TM.decode_run_slots(pt, torch.zeros((1, 3), dtype=torch.long),
                            torch.tensor([4]), torch.tensor([True]), caches,
                            cfg_t, block_tables=table)
    caches = TM.zeros_like_specs(TM.cache_specs(cfg_t, 1, 32), "cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        TM.decode_run_slots(pt, torch.zeros((1, 3), dtype=torch.long),
                            torch.tensor([4]), torch.tensor([True]), caches,
                            cfg_t)
    with pytest.raises(ValueError, match="sliding_window"):
        Scheduler(pt, cfg_t, ServingConfig(speculative=True, draft_k=3),
                  device="cpu")


def test_cache_specs_size_the_ring(danube):
    _, cfg_t, _, _ = danube
    cfg_r = RC.get("h2o-danube-1.8b").smoke()
    for seq in (8, 16, 40):
        want = RM.cache_specs(cfg_r, 2, seq)
        got = TM.cache_specs(cfg_t, 2, seq)
        assert got["0"]["k"][0] == tuple(want["0"]["k"].shape)
        want = RM.paged_cache_specs(cfg_r, 2, seq, 7, 8)
        got = TM.paged_cache_specs(cfg_t, 2, seq, 7, 8)
        assert got["0"]["k"][0] == tuple(want["0"]["k"].shape)


# ---------------------------------------------------------------------------
# the paged pool's ring layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plen", [5, 16, 29])
def test_paged_admit_lays_out_the_ring_as_the_reference(danube, plen):
    """A prefill's cache admitted into the windowed paged pool reads back
    as the reference pool's logical ring, row for row; the table has the
    ring's blocks."""
    cfg_r, cfg_t, pr, pt = danube
    toks = np.random.default_rng(plen).integers(0, cfg_r.vocab_size,
                                                (1, plen)).astype(np.int32)
    _, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r)
    _, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, cfg_t)
    rpool = RPaged(cfg_r, 2, cfg_r.max_seq_len, block_size=8)
    tpool = PagedCachePool(cfg_t, 2, cfg_t.max_seq_len, block_size=8,
                           device="cpu")
    assert tpool.blocks_per_slot == rpool.blocks_per_slot == 2
    assert tpool.max_tokens is None and rpool.max_tokens is None
    rpool.admit(1, cache_r, plen, plen + 30)
    tpool.admit(1, cache_t, plen, plen + 30)
    np.testing.assert_array_equal(tpool._table, rpool._table)
    want, got = rpool.read_slot(1), tpool.read_slot(1)
    for key in ("k", "v"):
        np.testing.assert_allclose(got["0"][key].numpy(),
                                   np.asarray(want["0"][key]), rtol=0,
                                   atol=CACHE_TOL)


# ---------------------------------------------------------------------------
# serving (tests/test_serving_paged.py, windowed cases)
# ---------------------------------------------------------------------------

def _naive(params, cfg, prompt, n):
    """One request at a time: unpadded contiguous prefill, scalar decode
    steps (the naive ring-decode oracle)."""
    logits, caches = TM.prefill(params, {"tokens": _t(prompt)[None].long()},
                                cfg)
    tok = torch.argmax(logits, -1)[:, None]
    out = [int(tok[0, 0])]
    for i in range(n - 1):
        tok, _, caches = TM.decode_step(params, tok.long(), len(prompt) + i,
                                        caches, cfg)
        out.append(int(tok[0, 0]))
    return out


def _teacher_forced(params, cfg, prompt, n):
    """Cache-free oracle: prefill the whole sequence for every token."""
    toks = list(map(int, prompt))
    out = []
    for _ in range(n):
        logits, _ = TM.prefill(params, {"tokens": _t([toks]).long()}, cfg)
        out.append(int(torch.argmax(logits, -1)[0]))
        toks.append(out[-1])
    return out


def _serve_ref(params, cfg, reqs, **kw):
    sched = RScheduler(params, cfg, RServingConfig(**kw))
    rids = [sched.submit_request(r_make_request(p, b)) for p, b in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


def _serve(params, cfg, reqs, **kw):
    sched = Scheduler(params, cfg, ServingConfig(**kw), device="cpu")
    rids = [sched.submit_request(make_request(p, b)) for p, b in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_sliding_window_serves_end_to_end(qwen_w, mode):
    """Prompts on both sides of the window and decodes straddling it,
    through the auto-enabled paged pool: the naive ring-decode and the
    teacher-forced oracles' tokens, and the reference scheduler's."""
    cfg_r, cfg_t, pr, pt, _, _ = qwen_w
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    rng = np.random.default_rng(3)
    short = rng.integers(0, cfg_t.vocab_size, 5)    # < window; decode crosses
    long_ = rng.integers(0, cfg_t.vocab_size, 29)   # > window at prefill
    budgets = (12, 6) if mode == "pim_sim" else (20, 10)
    reqs = [(short, budgets[0]), (long_, budgets[1])]
    kw = dict(max_batch=2, prompt_bucket=8, block_size=8)
    sched, got = _serve(pt, ct, reqs, **kw)
    assert sched.pool.paged
    assert sched.pool.blocks_per_slot == 2          # the ring, not max_len/8
    assert sched.decode_traces == 1
    for (prompt, n), toks in zip(reqs, got):
        assert toks == _naive(pt, ct, prompt, n)
        if mode != "pim_sim":
            assert toks == _teacher_forced(pt, ct, prompt, n)
    if mode != "pim_sim":
        _, want = _serve_ref(pr, cr, reqs, **kw)
        assert got == want


def test_sliding_window_serves_danube(danube):
    """The same on danube's own smoke config (GQA, window 16), a prompt
    past the window and one wrapping the ring in decode, quant."""
    cfg_r, cfg_t, pr, pt = danube
    cr, ct = cfg_r.scaled(pim_mode="quant"), cfg_t.scaled(pim_mode="quant")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg_t.vocab_size, 21), 8),
            (rng.integers(0, cfg_t.vocab_size, 12), 14)]
    kw = dict(max_batch=2, prompt_bucket=8, block_size=4)
    sched, got = _serve(pt, ct, reqs, **kw)
    assert sched.pool.blocks_per_slot == 4
    _, want = _serve_ref(pr, cr, reqs, **kw)
    assert got == want
    for (prompt, n), toks in zip(reqs, got):
        assert toks == _naive(pt, ct, prompt, n)


def test_window_that_never_binds_decodes_as_unwindowed(qwen_w):
    """Prompt + generation inside the window decodes as the unwindowed
    model on the same weights (test_serving_paged.py:284)."""
    cfg_r, cfg_t, pr, pt, ucfg_r, ucfg_t = qwen_w
    prompt, n = [3, 1, 4, 1], 6
    kw = dict(max_batch=1, prompt_bucket=8, block_size=8)
    _, got = _serve(pt, cfg_t, [(prompt, n)], **kw)
    assert got[0] == _naive(pt, ucfg_t, prompt, n)
    _, want = _serve_ref(pr, cfg_r, [(prompt, n)], **kw)
    assert got == want


def test_windowed_bucket_rule(qwen_w):
    """Prompts bucket while the padded length stays inside the window;
    past it they run unpadded (test_serving_paged.py:300)."""
    cfg_r, cfg_t, pr, pt, _, _ = qwen_w
    sched = Scheduler(pt, cfg_t, ServingConfig(max_batch=1, prompt_bucket=8),
                      device="cpu")
    ref = RScheduler(pr, cfg_r, RServingConfig(max_batch=1, prompt_bucket=8))
    for plen in (3, 13, 16, 17, 40):
        assert sched._bucket(plen) == ref._bucket(plen)
    assert [sched._bucket(p) for p in (3, 13, 17)] == [8, 16, 17]
    for plen in (8, 16, 17):
        assert sched._dense_prefill_ok(plen) == ref._dense_prefill_ok(plen)
    assert sched._dense_prefill_ok(16) and not sched._dense_prefill_ok(17)


def test_windowed_chunked_and_packed_prefill_match_reference(qwen_w):
    """With chunks of 8 and packing on, prompts inside the window pack or
    chunk, and one past the window takes the cold whole prefill (a chunk
    of it would lay out the dense layout, not the ring): tokens equal the
    plain windowed serve's and the reference's."""
    cfg_r, cfg_t, pr, pt, _, _ = qwen_w
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(1, cfg_t.vocab_size, n), b)
            for n, b in ((4, 6), (5, 5), (13, 8), (22, 6), (3, 9))]
    kw = dict(max_batch=2, prompt_bucket=4, block_size=4)
    feat = dict(prefill_chunk=8, packed_prefill=True, **kw)
    _, plain = _serve(pt, cfg_t, reqs, **kw)
    sched, got = _serve(pt, cfg_t, reqs, **feat)
    _, want = _serve_ref(pr, cfg_r, reqs, **feat)
    assert got == plain == want
    s = sched.metrics.summary()
    assert s["packed_prefills"] > 0 and s["prefill_chunks"] > 0


# ---------------------------------------------------------------------------
# copy-on-write on a ring wrap, the long-budget admit
# ---------------------------------------------------------------------------

def test_windowed_ring_wrap_cow_bit_exact():
    """tests/test_serving_prefix.py:133: a windowed slot whose ring wraps
    onto mapped prefix blocks copies them on write — tokens equal the run
    without the prefix cache and the reference's, and the refcounts stay
    exact."""
    from test_torch_serving_prefix import _check_refcounts, _shared_trace

    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=8,
                                                  max_seq_len=64)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=8,
                                                  max_seq_len=64)
    pr, pt = _pair(cfg_r, cfg_t, 2)
    # plen 7 <= window 8 (so the prompt matches the trie), budget 12 wraps
    # the 8-token ring
    reqs = _shared_trace(cfg_t.vocab_size, shared_len=4, tails=(3, 3, 3),
                         budget=12, seed=3)
    kw = dict(max_batch=2, prompt_bucket=4, block_size=4)
    _, cold = _serve(pt, cfg_t, reqs, **kw)
    sched, warm = _serve(pt, cfg_t, reqs, prefix_cache=True, **kw)
    rsched, want = _serve_ref(pr, cfg_r, reqs, prefix_cache=True, **kw)
    assert cold == warm == want
    assert sched.pool.cow_copies > 0, "ring wrap never triggered COW"
    assert sched.pool.cow_copies == rsched.pool.cow_copies
    assert sched.decode_traces == 1
    _check_refcounts(sched.pool)


def test_windowed_wrap_budgets_its_cow_debt():
    """The pool's admission budget for a wrapping ring: mapped blocks and
    its own registered blocks count as COW debt, as in the reference."""
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=8)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=8)
    rpool = RPaged(cfg_r, 2, 32, block_size=4, num_blocks=9,
                   prefix_cache=True)
    tpool = PagedCachePool(cfg_t, 2, 32, block_size=4, num_blocks=9,
                           device="cpu", prefix_cache=True)
    for n_tok, pref in ((7, 0), (20, 0), (20, 4), (8, 4), (40, 4)):
        assert tpool._will_wrap(n_tok) == rpool._will_wrap(n_tok)
        assert (tpool.can_admit(n_tok, pref)
                == rpool.can_admit(n_tok, pref)), (n_tok, pref)
    assert tpool.blocks_needed(40) == rpool.blocks_needed(40) == 2


def test_validate_request_windowed_long_budget_admits_and_serves():
    """tests/test_serving_chunked.py:231: a windowed request with prompt +
    budget past the whole pool's tokens passes validation and serves: its
    slot is a ring of ceil(window / block) blocks."""
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=16)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(sliding_window=16)
    pr, pt = _pair(cfg_r, cfg_t, 8)
    prompt = np.random.default_rng(9).integers(1, cfg_t.vocab_size, 32)
    budget = 16                               # 32 + 16 = 48 > 32 pool tokens
    kw = dict(max_batch=1, prompt_bucket=8, block_size=8, num_blocks=5)
    sched = Scheduler(pt, cfg_t, ServingConfig(**kw), device="cpu")
    req = make_request(prompt, budget)
    sched.validate_request(req)
    sched.submit_request(req)
    out = sched.run()
    assert out[req.rid].shape == (budget,)
    assert sched.metrics.summary()["deferred_admits"] == 0
    _, want = _serve_ref(pr, cfg_r, [(prompt, budget)], **kw)
    assert out[req.rid].tolist() == want[0]


# ---------------------------------------------------------------------------
# training through the windowed masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_windowed_loss_and_grads_match_reference(danube, mode):
    """``loss_fn`` and its gradients on the windowed config (24 tokens,
    past the window), against ``jax.value_and_grad`` of the reference's;
    tolerances of tests/test_torch_train.py."""
    from test_torch_train import GRAD_TOL, LOSS_TOL, _flat, _np_tree

    cfg_r, cfg_t, pr, pt = danube
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(6).integers(0, cfg_r.vocab_size, (2, 25))
    br = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    bt = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    want_loss, want = jax.value_and_grad(RM.loss_fn)(pr, br, cr)
    want = dict(_flat(_np_tree(want)))
    params = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    leaves = [v.requires_grad_(True) for _, v in _flat(params)]
    loss = TM.loss_fn(params, bt, ct)
    grads = dict(zip([k for k, _ in _flat(params)],
                     torch.autograd.grad(loss, leaves)))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    for k, g in grads.items():
        w = want[k]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)
    # the window binds: the unwindowed loss differs
    assert abs(float(TM.loss_fn(params, bt, ct.scaled(sliding_window=None)))
               - float(loss)) > 1e-4
