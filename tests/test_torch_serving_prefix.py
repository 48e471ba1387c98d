"""The port's prefix cache with copy-on-write block sharing, held to
``repro.serving`` on the cases of tests/test_serving_prefix.py.

Each case serves the same seeded trace with the same weights (the
reference's ``init_params``, imported by ``from_reference``) through the
reference scheduler and the port's, on the float32 smoke model, where the
two stacks' logits agree to ~1e-6 (test_torch_model.py): the token
streams must be equal.  The reference runs without a device mesh — its
mesh cases check sharding, which the port does not have.  The windowed
ring-wrap case is in tests/test_torch_window.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.serving import PagedCachePool as RPaged
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro.serving import make_request as r_make_request
from repro.serving import synthetic_requests as r_synthetic_requests
from repro_torch.models import model_lib as TM
from repro_torch.serving import (CachePool, PagedCachePool, Scheduler,
                                 ServingConfig, make_request,
                                 synthetic_requests)

LOGIT_TOL = 1e-4      # float32 logits, as in test_torch_model.py


def _pair(cfg_r, cfg_t, seed):
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return pr, pt


def _smoke():
    return (RC.get("qwen1.5-0.5b").smoke(), TC.get("qwen1.5-0.5b").smoke())


def _tiny(mode):
    kw = dict(n_layers=1, pattern=("ad",), d_model=32, n_heads=2,
              n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
              pad_vocab_multiple=8, loss_chunk=8, max_seq_len=16,
              pim_mode=mode)
    return (RC.get("qwen1.5-0.5b").smoke().scaled(**kw),
            TC.get("qwen1.5-0.5b").smoke().scaled(**kw))


def _shared_trace(vocab, *, shared_len, tails, budget, seed=0):
    """(prompt, budget) pairs sharing one system prompt, with divergent
    random tails."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, shared_len)
    return [(np.concatenate([shared, rng.integers(1, vocab, t)]), budget)
            for t in tails]


def _run_ref(params, cfg, reqs, **kw):
    sched = RScheduler(params, cfg, RServingConfig(**kw))
    rids = [sched.submit_request(r_make_request(p, b)) for p, b in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


def _run_port(params, cfg, reqs, **kw):
    sched = Scheduler(params, cfg, ServingConfig(**kw), device="cpu")
    rids = [sched.submit_request(make_request(p, b)) for p, b in reqs]
    out = sched.run()
    return sched, [out[r].tolist() for r in rids]


def _check_refcounts(pool):
    """The allocator's ground-truth invariant: _ref equals the reference
    multiset (slot block lists + trie entries), the free list holds
    exactly the unreferenced non-sentinel blocks, once each."""
    refs = np.zeros(pool.num_blocks, np.int64)
    for bl in pool._slot_blocks:
        for b in bl:
            refs[b] += 1
    trie = pool.prefix.blocks() if pool.prefix is not None else []
    for b in trie:
        refs[b] += 1
    assert (refs == pool._ref).all(), (refs.tolist(), pool._ref.tolist())
    free = set(pool._free)
    assert len(free) == len(pool._free), "free list holds duplicates"
    assert 0 not in free, "sentinel block leaked into the free list"
    used = {b for bl in pool._slot_blocks for b in bl} | set(trie)
    assert not free & used, "block simultaneously free and referenced"
    assert len(free) + len(used) == pool.num_blocks - 1, "block leak"


@pytest.fixture(scope="module")
def smoke():
    cfg_r, cfg_t = _smoke()
    return (cfg_r, cfg_t) + _pair(cfg_r, cfg_t, 0)


# ---------------------------------------------------------------------------
# trie-hit admits: the same tokens as cold prefill and as the reference
# ---------------------------------------------------------------------------

def test_prefix_admits_bit_exact_across_pools(smoke):
    cfg_r, cfg_t, pr, pt = smoke
    reqs = _shared_trace(cfg_t.vocab_size, shared_len=32, tails=(5, 7, 9, 6),
                         budget=6)
    base = dict(max_batch=2, prompt_bucket=8)
    _, contiguous = _run_port(pt, cfg_t, reqs, **base)
    _, cold = _run_port(pt, cfg_t, reqs, paged=True, **base)
    warm_sched, warm = _run_port(pt, cfg_t, reqs, prefix_cache=True, **base)
    _, ref = _run_ref(pr, cfg_r, reqs, prefix_cache=True, **base)
    assert contiguous == cold == warm == ref
    assert warm_sched.decode_traces == 1
    s = warm_sched.metrics.summary()
    assert s["prefix_hit_rate"] == pytest.approx(3 / 4)  # first admit cold
    assert s["prefix_tokens_reused"] == 3 * 32
    _check_refcounts(warm_sched.pool)
    assert warm_sched.pool.blocks_in_use == warm_sched.pool.prefix.n_blocks


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_prefix_bit_exact_per_pim_mode(mode):
    """The trie-hit path stays bit-identical to cold prefill under every
    ported lowering (pim_sim on a narrow model: each linear is one or two
    crossbar programs), and equal to the reference's tokens."""
    cfg_r, cfg_t = _tiny(mode)
    pr, pt = _pair(cfg_r, cfg_t, 1)
    reqs = _shared_trace(cfg_t.vocab_size, shared_len=8, tails=(3, 2, 4),
                         budget=4, seed=2)
    base = dict(max_batch=2, prompt_bucket=4, block_size=4)
    _, cold = _run_port(pt, cfg_t, reqs, paged=True, **base)
    sched, warm = _run_port(pt, cfg_t, reqs, prefix_cache=True, **base)
    _, ref = _run_ref(pr, cfg_r, reqs, prefix_cache=True, **base)
    assert cold == warm == ref, f"prefix-cache divergence under {mode}"
    assert sched.decode_traces == 1
    assert sched.metrics.summary()["prefix_tokens_reused"] == 2 * 8


def test_resumed_prefill_logits_match_reference(smoke):
    """``prefill(prefix=)`` against the reference's, from the same
    prefix KV: logits and the emitted tail cache."""
    cfg_r, cfg_t, pr, pt = smoke
    toks = np.random.default_rng(9).integers(1, 277, (1, 27)).astype(
        np.int32)
    _, cr = RM.prefill(pr, {"tokens": jnp.asarray(toks[:, :16])}, cfg_r)
    prefix_r = {i: {k: v[:, :, :16] for k, v in c.items()}
                for i, c in cr.items()}
    prefix_t = {i: {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
                for i, c in prefix_r.items()}
    last = np.array([8], np.int32)
    lr, tail_r = RM.prefill(pr, {"tokens": jnp.asarray(toks[:, 16:])},
                            cfg_r, last_index=jnp.asarray(last),
                            prefix=prefix_r)
    lt, tail_t = TM.prefill(pt, {"tokens": torch.from_numpy(toks[:, 16:])},
                            cfg_t, last_index=torch.from_numpy(last),
                            prefix=prefix_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=0,
                               atol=LOGIT_TOL)
    for key in ("k", "v"):
        assert tuple(tail_t["0"][key].shape) == tail_r["0"][key].shape
        np.testing.assert_allclose(tail_t["0"][key].numpy(),
                                   np.asarray(tail_r["0"][key]), atol=1e-5)
    # and the resumed logits are those of the whole prompt's prefill
    whole, _ = TM.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                          last_index=torch.tensor([24]))
    np.testing.assert_allclose(lt.numpy(), whole.numpy(), rtol=0,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# fork (parallel sampling) + COW on the divergent tail
# ---------------------------------------------------------------------------

def _fork_decode(decode, pool, firsts, steps=6):
    n = len(firsts)
    tokens = np.zeros((n, 1), np.int32)
    pos = np.full(n, 10, np.int32)
    act = np.ones(n, bool)
    tokens[:, 0] = firsts
    outs = [[] for _ in range(n)]
    for _ in range(steps):
        for s in range(n):
            pool.ensure_writable(s, int(pos[s]))
        t = decode(pool, tokens, pos, act)
        for s in range(n):
            outs[s].append(int(t[s, 0]))
            tokens[s, 0] = t[s, 0]
        pos += 1
    return outs


def test_fork_cow_divergent_tail(smoke):
    """fork() shares content blocks by reference; the boundary block COWs
    on the sibling's first divergent write, the sibling's generation
    matches a private continuation and the reference's, and the index's
    blocks keep their bits through the COW."""
    cfg_r, cfg_t, pr, pt = smoke
    prompt = np.random.default_rng(4).integers(1, cfg_t.vocab_size, 10)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = prompt
    logits, cache = TM.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                               last_index=torch.tensor([9]))
    first = int(torch.argmax(logits, -1)[0])
    div = (first + 1) % cfg_t.vocab_size    # forced divergent second branch

    def port_decode(pool, tokens, pos, act):
        nt, _, _ = TM.decode_step_slots(
            pt, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
            torch.from_numpy(act), pool.caches, cfg_t,
            block_tables=pool.block_tables)
        return nt.numpy()

    pool = PagedCachePool(cfg_t, 2, cfg_t.max_seq_len, block_size=4,
                          device="cpu", prefix_cache=True)
    pool.admit(0, cache, 10, 16, prompt=prompt)
    pool.fork(0, 1, 10, 16)
    assert pool.has_shared
    trie = sorted(pool.prefix.blocks())
    before = {k: pool.caches["0"][k][:, trie].clone() for k in ("k", "v")}
    a, b = _fork_decode(port_decode, pool, [first, div])
    assert a != b, "forced divergent branches converged"
    assert pool.cow_copies == 1, "boundary block must COW exactly once"
    for slot in (0, 1):       # both keep the prompt's KV, copy included
        view = pool.read_slot(slot)["0"]
        for k in ("k", "v"):
            assert torch.equal(view[k][:, :, :10], cache["0"][k][:, :, :10])
    for k in ("k", "v"):
        assert torch.equal(pool.caches["0"][k][:, trie], before[k]), \
            "COW wrote into a block the index still holds"

    ref_pool = PagedCachePool(cfg_t, 1, cfg_t.max_seq_len, block_size=4,
                              device="cpu")
    ref_pool.admit(0, cache, 10, 16)
    (private,) = _fork_decode(port_decode, ref_pool, [div])
    assert private == b, "fork sibling diverged from private continuation"

    # the reference's fork on its own prefill of the same prompt
    _, rcache = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r,
                           last_index=jnp.asarray([9], np.int32))
    rpool = RPaged(cfg_r, 2, cfg_r.max_seq_len, block_size=4,
                   prefix_cache=True)
    rpool.admit(0, rcache, 10, 16, prompt=prompt)
    rpool.fork(0, 1, 10, 16)

    def ref_decode(pool, tokens, pos, act):
        nt, _, nc = RM.decode_step_slots(
            pr, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(act),
            pool.caches, cfg_r, block_tables=pool.block_tables)
        pool.caches = nc
        return np.asarray(nt)

    assert _fork_decode(ref_decode, rpool, [first, div]) == [a, b]
    assert rpool.cow_copies == pool.cow_copies

    pool.evict(0)
    pool.evict(1)
    _check_refcounts(pool)
    assert pool.blocks_in_use == pool.prefix.n_blocks   # only the trie
    pool.clear_prefix()
    assert pool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# refcount invariants under churn
# ---------------------------------------------------------------------------

def test_refcount_invariants_under_poisson_churn(smoke):
    """Seeded Poisson trace through a deliberately undersized pool:
    admissions defer, the trie reclaims under pressure — after every step
    the refcount ground truth holds, the drain leaks no block, and the
    tokens equal the reference's on the same trace and clock."""
    cfg_r, cfg_t, pr, pt = smoke
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg_t.vocab_size, 16)
    arrivals = np.cumsum(rng.exponential(0.5, size=14))
    trace = [(np.concatenate([shared, rng.integers(
        1, cfg_t.vocab_size, int(rng.integers(2, 9)))]),
        int(rng.integers(1, 7)), float(t)) for t in arrivals]
    kw = dict(max_batch=3, prompt_bucket=8, block_size=4, prefix_cache=True,
              num_blocks=24)

    def drive(sched, mk, check):
        now = [0.0]
        sched.clock = lambda: now[0]
        rids = [sched.submit_request(mk(p, b, arrival_time=t))
                for p, b, t in trace]
        for _ in range(400):
            sched.step()
            check(sched)
            now[0] += 0.5
            if not len(sched.queue) and not sched.active_slots.any():
                break
        assert not len(sched.queue) and not sched.active_slots.any(), \
            "trace failed to drain"
        return [sched.output(r).tolist() for r in rids]

    port = Scheduler(pt, cfg_t, ServingConfig(**kw), device="cpu")
    got = drive(port, make_request, lambda s: _check_refcounts(s.pool))
    ref = RScheduler(pr, cfg_r, RServingConfig(**kw))
    want = drive(ref, r_make_request, lambda s: None)
    assert got == want
    assert port.metrics.deferred_admits == ref.metrics.deferred_admits
    pool = port.pool
    assert pool.blocks_in_use == pool.prefix.n_blocks
    pool.clear_prefix()
    assert pool.blocks_in_use == 0
    assert len(pool._free) == pool.num_blocks - 1
    assert not pool._ref.any(), "refcounts did not return to zero"


# ---------------------------------------------------------------------------
# admit-loop and deferral bookkeeping
# ---------------------------------------------------------------------------

def test_finished_at_admit_retries_same_slot(smoke):
    """A burst of one-token requests drains in a single scheduler step:
    each finishes at admit without occupying its slot."""
    _, cfg, _, params = smoke
    sched = Scheduler(params, cfg, ServingConfig(max_batch=2,
                                                 prompt_bucket=4),
                      device="cpu")
    rng = np.random.default_rng(6)
    one_shot = [sched.submit(rng.integers(1, cfg.vocab_size, 3), 1)
                for _ in range(4)]
    long_rid = sched.submit(rng.integers(1, cfg.vocab_size, 3), 5)
    emitted = sched.step()
    assert len(sched.queue) == 0
    assert {rid for rid, _ in emitted} == set(one_shot) | {long_rid}
    assert sched.n_active == 1  # only the long request holds a slot
    out = sched.run()
    for rid in one_shot:
        assert out[rid].shape == (1,)
    assert out[long_rid].shape == (5,)


def test_deferred_rid_resets_after_admit(smoke):
    """deferred -> admitted -> deferred-again counts two deferral events,
    even when the later request reuses the earlier rid."""
    _, cfg, _, params = smoke
    rng = np.random.default_rng(7)
    # each request: plen 4 + budget 8 = 12 tokens = 3 blocks of 4; the pool
    # holds 3 usable blocks, so exactly one request fits at a time
    mk = lambda rid: make_request(rng.integers(1, cfg.vocab_size, 4), 8,
                                  rid=rid)
    sched = Scheduler(params, cfg,
                      ServingConfig(max_batch=2, prompt_bucket=4,
                                    paged=True, block_size=4, num_blocks=4),
                      clock=lambda: 0.0, device="cpu")
    sched.submit_request(mk(rid=9001))
    sched.step()
    assert sched.n_active == 1
    sched.submit_request(mk(rid=777))
    sched.step()
    assert sched.metrics.deferred_admits == 1     # 777 deferred behind 9001
    for _ in range(20):
        sched.step()
        if not len(sched.queue) and not sched.active_slots.any():
            break
    assert sched.metrics.deferred_admits == 1     # one event per wait
    sched.submit_request(mk(rid=9002))
    sched.step()
    assert sched.n_active == 1                    # 9002 admitted
    sched.submit_request(mk(rid=777))             # rid reuse: worst case
    sched.step()
    assert sched.metrics.deferred_admits == 2


# ---------------------------------------------------------------------------
# stats keys and validation gates
# ---------------------------------------------------------------------------

def test_stats_reserved_vs_in_use_and_key_alignment(smoke):
    """tokens_reserved (logical, per referencing slot) and tokens_in_use
    (physical, each block once) diverge exactly by the shared blocks, as
    in the reference's pool; both pools emit the shared key set."""
    cfg_r, cfg, pr, params = smoke
    prompt = np.random.default_rng(8).integers(1, cfg.vocab_size, 8)
    toks = torch.from_numpy(prompt[None].astype(np.int64))
    _, cache = TM.prefill(params, {"tokens": toks}, cfg)
    _, rcache = RM.prefill(pr, {"tokens": jnp.asarray(prompt[None])}, cfg_r)

    pool = PagedCachePool(cfg, 2, cfg.max_seq_len, block_size=4,
                          device="cpu", prefix_cache=True)
    rpool = RPaged(cfg_r, 2, cfg_r.max_seq_len, block_size=4,
                   prefix_cache=True)
    pool.admit(0, cache, 8, 12, prompt=prompt)     # 3 blocks
    rpool.admit(0, rcache, 8, 12, prompt=prompt)
    st = pool.stats()
    assert st["tokens_reserved"] == st["tokens_in_use"] == 3 * 4
    pool.fork(0, 1, 8, 12)                         # shares 2 content blocks
    rpool.fork(0, 1, 8, 12)
    st = pool.stats()
    assert st["tokens_reserved"] == 6 * 4          # both slots' reservations
    assert st["tokens_in_use"] == 4 * 4            # 3 + 1 fresh, shared once
    assert st["blocks_shared"] == 2.0
    assert st["prefix_blocks"] == 2.0              # plen 8 registered fully
    assert st == rpool.stats()

    flat = CachePool(cfg, 2, cfg.max_seq_len, device="cpu")
    core = {"kv_bytes_in_use", "kv_bytes_reserved", "blocks_in_use",
            "blocks_total", "tokens_reserved", "tokens_in_use"}
    assert core <= set(flat.stats()) and core <= set(st)
    assert flat.stats()["tokens_in_use"] == 0.0
    flat.admit(0, cache, 8, 12)
    assert flat.stats()["tokens_in_use"] == float(cfg.max_seq_len)
    assert flat.stats()["tokens_reserved"] == float(2 * cfg.max_seq_len)


def test_prefix_cache_rejects_non_separable_stacks(smoke):
    """Recurrent state and MoE capacity dropping make KV depend on more
    than the prefix: the scheduler refuses, as the reference's does."""
    cfg = smoke[1]
    moe = cfg.scaled(pattern=("ae",), n_layers=2, n_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        Scheduler(None, moe, ServingConfig(prefix_cache=True), device="cpu")
    rec = cfg.scaled(pattern=("md",), n_layers=2)
    with pytest.raises(ValueError, match="prefix_cache"):
        Scheduler(None, rec, ServingConfig(prefix_cache=True,
                                           prompt_bucket=1), device="cpu")


def test_shared_prefix_synthetic_trace():
    """synthetic_requests(shared_prefix_len=N) prepends one identical
    N-token run to every prompt, the reference's run for the same seed."""
    a = synthetic_requests(4, vocab_size=97, prompt_lens=[3, 5],
                           shared_prefix_len=8, seed=11)
    b = synthetic_requests(2, vocab_size=97, prompt_lens=[4],
                           shared_prefix_len=8, seed=11)
    head = a[0].prompt[:8]
    for r in a + b:
        assert (r.prompt[:8] == head).all()
    assert a[0].prompt.shape == (11,) and a[1].prompt.shape == (13,)
    want = r_synthetic_requests(4, vocab_size=97, prompt_lens=[3, 5],
                                shared_prefix_len=8, seed=11)
    for got, ref in zip(a, want):
        np.testing.assert_array_equal(got.prompt, ref.prompt)
    plain = synthetic_requests(2, vocab_size=97, prompt_lens=[4], seed=11)
    assert plain[0].prompt.shape == (4,)


def test_serve_cli_with_prefix_chunked_and_packed(capsys):
    """The README's CPU example: every feature is used and reported."""
    from repro_torch.launch import serve as serve_cli

    results = serve_cli.main([
        "--smoke", "--device", "cpu", "--pim-mode", "quant", "--batch", "2",
        "--requests", "6", "--prompt-lens", "5,9,24", "--max-new-tokens",
        "4", "--shared-prefix", "16", "--prefix-cache", "--prefill-chunk",
        "16", "--packed-prefill"])
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out and "1 decode shapes" in out
    assert "[pool]" in out and "[prefix] hit rate" in out
    assert "[chunked]" in out and " 0 prefill chunks" not in out
    assert all(len(t) == 4 for t in results.values())
