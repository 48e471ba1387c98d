"""``repro_torch.serving.router`` against ``repro.serving.router``: the
mirror of tests/test_serving_router.py, the mid-prefill kill of
tests/test_serving_chunked.py and the mid-verify kill of
tests/test_speculative.py, ``Scheduler.drain``, the serve CLI's fleet
and mesh, and the fleet over ranks.

The reference's tests pass ``devices=jax.devices()[:2]``: one-device
meshes, respawned on the same device.  The port's ``devices=None`` has
the same semantics (every replica its own scheduler and pool on the one
device).  Every fleet's tokens are held bit for bit to the *reference's*
single scheduler on the same trace and weights (``model.from_reference``;
float32 smoke models, whose greedy tokens agree across the packages, see
tests/test_torch_serving.py).  The fleet over ranks runs in one spawn of
four gloo ranks (``fleet_runs``; per-rank cases in
tests/_torch_dist_cases.py): its replicas are sub-meshes of two ranks,
and the reference's fleets it is held to run over ``jax.devices()[:4]``.  ``FleetClock`` arithmetic,
``RouterConfig``'s validation and the merged summary's router fields are
compared with the reference's directly.  One ``pim_sim`` fleet is held
to the reference's host interpreter; the other ``pim_sim`` case uses the
port's own single scheduler as its oracle.
"""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
import repro.configs as RC
import repro.serving as R
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import spawn
from repro_torch.models import model_lib as TM
from repro_torch.pim import engine
from repro_torch.serving import (AdmissionQueue, FailurePlan, FleetClock,
                                 Router, RouterConfig, Scheduler,
                                 ServingConfig, make_request,
                                 synthetic_requests)

N_REQ = 8
GEN = 8
SPAWN_TIMEOUT_S = 120.0


class FakeClock:
    """Settable clock: router timing becomes exactly computable."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def models():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return cfg_r, cfg_t, pr, pt


def _trace(fn, cfg):
    """The shared fleet trace; same seed => same prompts across calls
    (fresh Request objects each time — the router mutates replica_id)."""
    return fn(N_REQ, vocab_size=cfg.vocab_size, prompt_lens=[5, 7],
              max_new_tokens=GEN, seed=11)


@pytest.fixture(scope="module")
def oracle(models):
    """The reference's single-scheduler generations for _trace."""
    cfg_r, _, pr, _ = models
    reqs = _trace(R.synthetic_requests, cfg_r)
    sched = R.Scheduler(pr, cfg_r, R.ServingConfig(max_batch=4,
                                                   prompt_bucket=8))
    for r in reqs:
        sched.submit_request(r)
    out = sched.run()
    return [out[r.rid] for r in reqs]


def _scfg(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("prompt_bucket", 8)
    return ServingConfig(**kw)


def _router(models, rcfg, scfg=None, **kw):
    _, cfg_t, _, pt = models
    return Router(pt, cfg_t, scfg or _scfg(), rcfg, device="cpu", **kw)


def _assert_matches_oracle(results, reqs, oracle):
    assert set(results) == {r.rid for r in reqs}
    for i, r in enumerate(reqs):
        assert np.array_equal(results[r.rid], oracle[i]), i


# --------------------------------------------------------------------------
# config + clock + queue plumbing
# --------------------------------------------------------------------------

def test_router_config_validation():
    for kw, match in (({"policy": "fastest"}, "unknown router policy"),
                      ({"n_replicas": 0}, "n_replicas")):
        with pytest.raises(ValueError, match=match) as want:
            R.RouterConfig(**kw)
        with pytest.raises(ValueError, match=match) as got:
            RouterConfig(**kw)
        assert str(got.value) == str(want.value)
    assert RouterConfig() == RouterConfig(**{
        f: getattr(R.RouterConfig(), f) for f in
        R.RouterConfig.__dataclass_fields__})


def test_fleet_clock_rounds_cost_their_slowest_segment():
    def drive(cls):
        wall = FakeClock(0.0)
        fc = cls(wall=wall)
        reads = [fc()]
        fc.start_segment()
        wall.t += 2.0
        reads.append(fc())
        dt1 = fc.end_segment()
        reads += [dt1, fc()]
        fc.start_segment()
        wall.t += 5.0
        dt2 = fc.end_segment()
        fc.end_round([dt1, dt2])
        reads.append(fc())
        fc.advance_to(9.0)
        reads.append(fc())
        fc.advance_to(1.0)
        reads.append(fc())
        fc.end_round([])
        reads.append(fc())
        return reads

    got = drive(FleetClock)
    assert got == drive(R.FleetClock)
    assert got == [0.0, 2.0, 2.0, 0.0, 5.0, 9.0, 9.0, 9.0]


def test_requeue_front_keeps_arrival_and_order():
    q = AdmissionQueue()
    r1 = make_request([1, 2, 3], 4, arrival_time=0.5)
    r2 = make_request([4, 5], 4, arrival_time=0.6)
    q.submit(r1)
    q.submit(r2)
    assert q.pop(now=1.0) is r1
    r1.n_migrations += 1
    q.requeue(r1)
    assert q.peek(now=1.0) is r1         # drained work goes to the front
    assert r1.arrival_time == 0.5        # arrival is never rewritten
    assert r1.n_migrations == 1


def test_devices_raise_naming_d3(models):
    """``devices`` are world ranks of an initialised ``torch.distributed``
    world: without one they are refused, never ignored (the fleet over
    ranks, formerly refused as ROADMAP item D3, is
    ``test_fleet_over_ranks_option``)."""
    _, cfg_t, _, pt = models
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        Router(pt, cfg_t, _scfg(), RouterConfig(), devices=[0, 1],
               device="cpu")
    with pytest.raises(ValueError, match="model_parallel > 1"):
        _router(models, RouterConfig(n_replicas=2, model_parallel=2))


# --------------------------------------------------------------------------
# dispatch policies
# --------------------------------------------------------------------------

def test_round_robin_cycles_and_matches_oracle(models, oracle):
    reqs = _trace(synthetic_requests, models[1])
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="round_robin"))
    for r in reqs:
        router.submit_request(r)
    results = router.run()
    assert [r.replica_id for r in reqs] == [i % 2 for i in range(N_REQ)]
    _assert_matches_oracle(results, reqs, oracle)
    s = router.metrics().summary()
    assert s["router_policy"] == "round_robin"
    assert set(s["per_replica_tok_s"]) == {0, 1}
    assert s["rebalanced_requests"] == 0 and s["replica_restarts"] == 0
    assert s["n_finished"] == N_REQ


def test_least_loaded_prefers_emptier_replica(models):
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="least_loaded"),
                     clock=FakeClock(1.0))
    # pre-load replica 0 behind the router's back
    router.replicas[0].sched.submit([9, 9, 9], 2)
    a = make_request([1, 2, 3], 2)
    b = make_request([4, 5, 6], 2)
    router.submit_request(a)
    router.submit_request(b)
    router._dispatch()
    assert a.replica_id == 1             # 0 queued+active vs replica 0's 1
    assert b.replica_id == 0             # now tied 1-1; lowest rid wins


def test_prefix_affinity_pins_tenants_to_replicas(models):
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="prefix_affinity"),
                     _scfg(paged=True, block_size=8), clock=FakeClock(1.0))
    reqs = synthetic_requests(6, vocab_size=models[1].vocab_size,
                              prompt_lens=[4], max_new_tokens=2, seed=5,
                              shared_prefix_len=8, n_tenants=2)
    for r in reqs:
        router.submit_request(r)
    router._dispatch()
    by_tenant = {0: {r.replica_id for r in reqs[0::2]},
                 1: {r.replica_id for r in reqs[1::2]}}
    assert len(by_tenant[0]) == 1, "tenant 0 smeared across replicas"
    assert len(by_tenant[1]) == 1, "tenant 1 smeared across replicas"
    assert by_tenant[0] != by_tenant[1]
    assert len(router._affinity) == 2


def test_prefix_affinity_beats_round_robin_hit_rate(models):
    """Pinning tenants to replicas keeps each tenant's blocks in one trie;
    the port's hit rates equal the reference's for both policies, and its
    tokens the reference fleet's."""
    cfg_r, cfg_t, pr, pt = models
    rates, want_rates = {}, {}
    for policy in ("round_robin", "prefix_affinity"):
        kw = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=8,
                  prefix_cache=True)
        router = _router(models, RouterConfig(n_replicas=2, policy=policy),
                         ServingConfig(**kw), clock=FakeClock(1.0))
        rrouter = R.Router(pr, cfg_r, R.ServingConfig(**kw),
                           R.RouterConfig(n_replicas=2, policy=policy),
                           devices=jax.devices()[:2], clock=FakeClock(1.0))
        got = {}
        for rt, fn, out in ((router, synthetic_requests, got),
                            (rrouter, R.synthetic_requests, {})):
            reqs = fn(12, vocab_size=cfg_t.vocab_size, prompt_lens=[4],
                      max_new_tokens=3, seed=9, shared_prefix_len=16,
                      n_tenants=3)
            for r in reqs:
                rt.submit_request(r)
            res = rt.run()
            out["toks"] = [res[r.rid].tolist() for r in reqs]
            if rt is rrouter:
                assert out["toks"] == got["toks"], policy
        rates[policy] = router.metrics().summary()["prefix_hit_rate"]
        want_rates[policy] = rrouter.metrics().summary()["prefix_hit_rate"]
    assert rates == want_rates
    assert rates["prefix_affinity"] > rates["round_robin"], rates


# --------------------------------------------------------------------------
# fault path: kill, drain, requeue, respawn
# --------------------------------------------------------------------------

def test_kill_mid_trace_is_bit_exact_and_keeps_arrivals(models, oracle):
    reqs = _trace(synthetic_requests, models[1])
    for i, r in enumerate(reqs):
        r.arrival_time = 0.1 * i         # distinct, all arrived at t=100
    arrivals = {r.rid: r.arrival_time for r in reqs}
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="round_robin"),
                     _scfg(paged=True), clock=FakeClock(100.0),
                     failure_plan=FailurePlan(kill_replica=0, at_step=3))
    for r in reqs:
        router.submit_request(r)
    dead_pool = weakref.ref(router.replicas[0].sched.pool)
    dead_sched = weakref.ref(router.replicas[0].sched)
    results = router.run()
    _assert_matches_oracle(results, reqs, oracle)
    assert router.replica_restarts == 1
    assert router.rebalanced_requests > 0
    # the killed scheduler and its pool are garbage (only its metrics are
    # kept), with no collection pass needed
    assert dead_pool() is None and dead_sched() is None
    migrated = [r for r in reqs if r.n_migrations > 0]
    assert len(migrated) == router.rebalanced_requests
    for r in reqs:                       # drains never launder latency
        assert r.arrival_time == arrivals[r.rid]
    m = router.metrics().summary()
    assert m["n_finished"] == N_REQ
    assert m["rebalanced_requests"] == router.rebalanced_requests


def test_kill_without_respawn_retires_replica(models, oracle):
    reqs = _trace(synthetic_requests, models[1])
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="least_loaded"),
                     clock=FakeClock(1.0),
                     failure_plan=FailurePlan(kill_replica=0, at_step=2,
                                              respawn=False))
    for r in reqs:
        router.submit_request(r)
    dead_pool = weakref.ref(router.replicas[0].sched.pool)
    results = router.run()
    _assert_matches_oracle(results, reqs, oracle)
    assert not router.replicas[0].alive
    assert router.replica_restarts == 0
    assert router.rebalanced_requests > 0
    assert dead_pool() is None
    # the lone survivor served every migrated request
    assert {r.replica_id for r in reqs if r.n_migrations > 0} == {1}


def test_all_replicas_dead_raises(models):
    router = _router(models, RouterConfig(n_replicas=1), clock=FakeClock(1.0),
                     failure_plan=FailurePlan(kill_replica=0, at_step=0,
                                              respawn=False))
    router.submit([1, 2, 3], 2)
    with pytest.raises(RuntimeError, match="all replicas dead"):
        router.run()


def test_straggler_strikes_kill_and_respawn(models, oracle):
    reqs = _trace(synthetic_requests, models[1])
    clk = FakeClock(1.0)
    router = _router(models,
                     RouterConfig(n_replicas=2, policy="round_robin",
                                  health_check=True, straggler_patience=3,
                                  straggler_threshold=3.0,
                                  straggler_alpha=0.1), clock=clk)
    rep = router.replicas[1]
    orig_step = rep.step
    dts = iter([0.01] * 4 + [5.0] * 3)
    rep.step = lambda: (orig_step(), setattr(
        clk, "t", clk.t + next(dts, 0.0)))[0]
    for r in reqs:
        router.submit_request(r)
    results = router.run()
    _assert_matches_oracle(results, reqs, oracle)
    assert router.replica_restarts == 1
    assert router.rebalanced_requests > 0
    assert rep.alive and rep.strikes == 0


def test_merged_summary_router_fields_match_reference(models):
    """The same kill drill on both routers (fake clocks): the merged
    summary's router fields and counts are the reference's."""
    cfg_r, cfg_t, pr, pt = models
    plan = dict(kill_replica=1, at_step=2)
    router = _router(models, RouterConfig(n_replicas=2,
                                          policy="least_loaded"),
                     clock=FakeClock(1.0), failure_plan=FailurePlan(**plan))
    rrouter = R.Router(pr, cfg_r, R.ServingConfig(max_batch=2,
                                                  prompt_bucket=8),
                       R.RouterConfig(n_replicas=2, policy="least_loaded"),
                       devices=jax.devices()[:2], clock=FakeClock(1.0),
                       failure_plan=R.FailurePlan(**plan))
    sums = []
    for rt, fn in ((router, synthetic_requests),
                   (rrouter, R.synthetic_requests)):
        reqs = _trace(fn, cfg_t)
        for r in reqs:
            rt.submit_request(r)
        rt.run()
        s = rt.metrics().summary()
        sums.append((s["router_policy"], s["rebalanced_requests"],
                     s["replica_restarts"], sorted(s["per_replica_tok_s"]),
                     s["n_finished"], s["n_requests"], s["total_tokens"],
                     [r.replica_id for r in reqs],
                     [r.n_migrations for r in reqs], rt.step_count))
    assert sums[0] == sums[1]


# --------------------------------------------------------------------------
# queue policy: sjf vs fifo
# --------------------------------------------------------------------------

def _bimodal(cfg):
    rng = np.random.default_rng(7)
    reqs = [make_request(rng.integers(0, cfg.vocab_size, 16), 12)]
    reqs += [make_request(rng.integers(0, cfg.vocab_size, 4), 2)
             for _ in range(4)]
    return reqs


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_queue_policy_accepted_by_scheduler(models, policy):
    _, cfg_t, _, pt = models
    sched = Scheduler(pt, cfg_t, _scfg(max_batch=1, queue_policy=policy),
                      device="cpu")
    assert sched.queue.policy == policy


def test_sjf_beats_fifo_p50_queue_wait_on_bimodal_trace(models):
    _, cfg_t, _, pt = models
    p50 = {}
    for policy in ("fifo", "sjf"):
        clk = FakeClock(0.0)
        sched = Scheduler(pt, cfg_t, _scfg(max_batch=1, queue_policy=policy),
                          clock=clk, device="cpu")
        for r in _bimodal(cfg_t):
            sched.submit_request(r)
        while len(sched.queue) or sched.n_active:
            sched.step()
            clk.t += 1.0
        p50[policy] = sched.metrics.summary()["p50_queue_wait_s"]
    assert p50["sjf"] < p50["fifo"], p50


# --------------------------------------------------------------------------
# kills mid-prefill and mid-verify (tests/test_serving_chunked.py:171,
# tests/test_speculative.py:303)
# --------------------------------------------------------------------------

def _ref_single(pr, cfg_r, rscfg, reqs):
    sched = R.Scheduler(pr, cfg_r, rscfg)
    rids = [sched.submit_request(R.make_request(r.prompt, r.max_new_tokens))
            for r in reqs]
    out = sched.run()
    return sched, [out[rid] for rid in rids]


def test_midprefill_slot_drains_through_router_kill():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(6))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [make_request(rng.integers(1, cfg_t.vocab_size, p), g)
            for p, g in ((48, 6), (5, 8), (7, 6), (48, 4), (6, 8))]
    kw = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=8,
              prefill_chunk=16, step_token_budget=16)
    rsched, oracle = _ref_single(pr, cfg_r, R.ServingConfig(**kw), reqs)
    assert rsched.metrics.summary()["prefill_chunks"] >= 6
    router = Router(pt, cfg_t, ServingConfig(**kw),
                    RouterConfig(n_replicas=2, policy="round_robin"),
                    clock=FakeClock(1.0), device="cpu",
                    failure_plan=FailurePlan(kill_replica=0, at_step=1))
    seen = []
    real = Scheduler.drain

    def drain(self):
        seen.append(bool(self._prefilling.any()))
        return real(self)

    Scheduler.drain = drain
    try:
        fresh = [make_request(r.prompt, r.max_new_tokens) for r in reqs]
        for r in fresh:
            router.submit_request(r)
        results = router.run()
    finally:
        Scheduler.drain = real
    assert seen == [True], "the kill must catch a slot mid-prefill"
    assert router.rebalanced_requests > 0
    for i, r in enumerate(fresh):
        assert np.array_equal(results[r.rid], oracle[i]), i
    for rep in router.replicas:
        if rep.alive:
            assert not rep.sched._prefilling.any()
            assert not rep.sched._deferred_rids
            assert rep.sched.pool.blocks_in_use == 0


def test_spec_router_kill_mid_verify_bit_exact():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(9))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t, device="cpu")
    rng = np.random.default_rng(10)
    reqs = [make_request(rng.integers(1, cfg_t.vocab_size, p), g)
            for p, g in ((6, 8), (5, 9), (7, 6), (4, 8), (6, 7))]
    kw = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=8,
              speculative=True, draft_mode="quant", draft_k=3)
    _, oracle = _ref_single(pr, cfg_r, R.ServingConfig(**kw), reqs)
    router = Router(pt, cfg_t, ServingConfig(**kw),
                    RouterConfig(n_replicas=2, policy="round_robin"),
                    clock=FakeClock(1.0), device="cpu",
                    failure_plan=FailurePlan(kill_replica=0, at_step=1))
    fresh = [make_request(r.prompt, r.max_new_tokens) for r in reqs]
    for r in fresh:
        router.submit_request(r)
    results = router.run()
    assert router.rebalanced_requests > 0, "kill must catch in-flight work"
    assert router.metrics().summary()["spec_rounds"] > 0
    for i, r in enumerate(fresh):
        assert np.array_equal(results[r.rid], oracle[i]), i


# --------------------------------------------------------------------------
# pim_sim fleets: the engine's resident state survives a respawn
# --------------------------------------------------------------------------

def _tiny(mod, mode):
    return mod.get("qwen1.5-0.5b").smoke().scaled(
        n_layers=1, pattern=("ad",), d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=64, pad_vocab_multiple=8,
        loss_chunk=8, max_seq_len=24, pim_mode=mode)


@pytest.fixture(scope="module")
def tiny_pim():
    cfg_r, cfg_t = _tiny(RC, "pim_sim"), _tiny(TC, "pim_sim")
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(3))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [make_request(rng.integers(1, 64, p), g)
            for p, g in ((6, 4), (9, 3), (5, 4))]
    return cfg_r, cfg_t, pr, pt, reqs


def _pim_fleet(tiny_pim, plan):
    _, cfg_t, _, pt, reqs = tiny_pim
    uploads = []
    real = Scheduler._plain_step

    def step(self, active, emitted):
        real(self, active, emitted)
        uploads.append(engine.cache_info().exec_uploads)

    Scheduler._plain_step = step
    try:
        router = Router(pt, cfg_t, _scfg(paged=True, block_size=8),
                        RouterConfig(n_replicas=2, policy="least_loaded"),
                        clock=FakeClock(1.0), device="cpu",
                        failure_plan=plan)
        fresh = [make_request(r.prompt, r.max_new_tokens) for r in reqs]
        for r in fresh:
            router.submit_request(r)
        res = router.run()
    finally:
        Scheduler._plain_step = real
    return [res[r.rid] for r in fresh], router, uploads


def test_pim_sim_fleet_kill_matches_reference_interpreter(tiny_pim):
    """A pim_sim fleet with a kill mid-trace gives the reference single
    scheduler's tokens (its host interpreter); no decode step after the
    first uploads crossbar state, the respawned replica's included."""
    cfg_r, _, pr, _, reqs = tiny_pim
    engine.clear_cache()
    got, router, uploads = _pim_fleet(
        tiny_pim, FailurePlan(kill_replica=0, at_step=2))
    assert router.replica_restarts == 1 and router.rebalanced_requests > 0
    assert uploads and all(u == uploads[0] for u in uploads), uploads
    _, want = _ref_single(pr, cfg_r, R.ServingConfig(
        max_batch=2, prompt_bucket=8, paged=True, block_size=8), reqs)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), i


def test_pim_sim_fleet_without_respawn_matches_port_scheduler(tiny_pim):
    _, cfg_t, _, pt, reqs = tiny_pim
    got, router, _ = _pim_fleet(
        tiny_pim, FailurePlan(kill_replica=1, at_step=1, respawn=False))
    assert router.replica_restarts == 0 and not router.replicas[1].alive
    sched = Scheduler(pt, cfg_t, _scfg(max_batch=3), device="cpu")
    rids = [sched.submit_request(make_request(r.prompt, r.max_new_tokens))
            for r in reqs]
    out = sched.run()
    for i, rid in enumerate(rids):
        assert np.array_equal(got[i], out[rid]), i


# --------------------------------------------------------------------------
# Scheduler.drain
# --------------------------------------------------------------------------

def test_drain_releases_blocks_and_prefix_refcounts(models):
    """After ``drain`` the pool holds no block of a drained slot: the
    prefix index's blocks and refcounts are those of a fresh scheduler
    that cached the same prompts, the decode batch and queue are empty,
    and the same scheduler then serves a new trace to the reference's
    tokens."""
    cfg_r, cfg_t, pr, pt = models
    kw = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=8,
              prefix_cache=True, prefill_chunk=16, step_token_budget=16)
    reqs = synthetic_requests(5, vocab_size=cfg_t.vocab_size,
                              prompt_lens=[4, 30], max_new_tokens=6, seed=3,
                              shared_prefix_len=16)
    sched = Scheduler(pt, cfg_t, ServingConfig(**kw), device="cpu")
    for r in reqs:
        sched.submit_request(r)
    sched.step()
    sched.step()
    assert sched.n_active > 0 and len(sched.queue) > 0
    drained = sched.drain()
    assert sorted(r.rid for r in drained) == sorted(
        r.rid for r in reqs if sched.metrics.requests[r.rid].finish_time
        is None)
    assert sched.n_active == 0 and not len(sched.queue)
    assert not sched._prefilling.any() and not sched._deferred_rids
    pool = sched.pool
    assert all(not b for b in pool._slot_blocks)
    held = sorted(pool.prefix.blocks())
    # every block in use is held by the index alone, once
    assert pool.blocks_in_use == len(held)
    assert sorted(np.flatnonzero(pool._ref).tolist()) == held
    assert all(pool._ref[b] == 1 for b in held)
    # a fresh scheduler that cached the prompts the drained one registered
    # (a prompt enters the index when its prefill completes: a chunked one
    # at its last chunk)
    registered = [r for r in reqs if sched.metrics.requests[r.rid]
                  .first_token_time is not None]
    assert registered
    fresh = Scheduler(pt, cfg_t, ServingConfig(**kw), device="cpu")
    for r in registered:
        fresh.submit_request(make_request(r.prompt, r.max_new_tokens))
    fresh.run()
    assert len(fresh.pool.prefix.blocks()) == len(held)
    assert fresh.pool.blocks_in_use == pool.blocks_in_use
    assert sorted(fresh.pool._ref.tolist()) == sorted(pool._ref.tolist())
    # the same scheduler serves on, to the reference's tokens
    new = synthetic_requests(4, vocab_size=cfg_t.vocab_size,
                             prompt_lens=[5, 20], max_new_tokens=5, seed=8)
    rids = [sched.submit_request(make_request(r.prompt, r.max_new_tokens))
            for r in new]
    out = sched.run()
    _, want = _ref_single(pr, cfg_r, R.ServingConfig(**kw), new)
    for i, rid in enumerate(rids):
        assert np.array_equal(out[rid], want[i]), i


@pytest.mark.parametrize("paged", [False, True])
def test_drain_zeroes_a_contiguous_or_paged_slot(models, paged):
    _, cfg_t, _, pt = models
    sched = Scheduler(pt, cfg_t, _scfg(paged=paged), device="cpu")
    for r in _trace(synthetic_requests, cfg_t)[:3]:
        sched.submit_request(r)
    sched.step()
    out = sched.drain()
    assert len(out) == 3 and sched.n_active == 0
    for c in sched.pool.caches.values():
        for leaf in c.values():
            assert not leaf.any()
    gc.collect()


# --------------------------------------------------------------------------
# the serve CLI: a fleet, and the mesh at a world the model axis does not
# divide
# --------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--pim-mode", "quant", "--paged",
       "--requests", "5", "--batch", "2", "--prompt-lens", "5,9",
       "--max-new-tokens", "4"]


def test_serve_cli_fleet_with_a_kill_matches_one_scheduler(capsys):
    single = serve_cli.main(CLI)
    fleet = serve_cli.main(CLI + ["--replicas", "2", "--router-policy",
                                  "round_robin", "--kill-replica", "0:2"])
    out = capsys.readouterr().out
    assert "[router] round_robin over 2 replicas" in out
    assert "1 restarts" in out
    # rids differ between the runs: compare in submission order
    assert [single[k].tolist() for k in sorted(single)] == \
        [fleet[k].tolist() for k in sorted(fleet)]


def test_serve_cli_world3_model_parallel2_degrades_to_data3():
    """``--model-parallel 2`` at a world of 3 serves at (pod 1, data 3,
    model 1), as the reference's ElasticMesh lays it out, where the CLI
    used to raise."""
    ranks = spawn(C.run_jobs, 3, [("cli_case", ("serve", CLI + [
        "--model-parallel", "2"]))], timeout_s=SPAWN_TIMEOUT_S)
    res, out = ranks[0][0]
    assert "[mesh] {'pod': 1, 'data': 3, 'model': 1} over 3 ranks" in out
    want = serve_cli.main(CLI)
    assert [res[k] for k in sorted(res)] == \
        [want[k].tolist() for k in sorted(want)]
    for r in ranks[1:]:
        assert r[0][0] == res and r[0][1] == ""


# --------------------------------------------------------------------------
# the fleet over ranks: four spawned gloo ranks, two replicas of two
# --------------------------------------------------------------------------

WORLD = 4
FLEET_TIMEOUT_S = 240.0
TRACE = dict(n=N_REQ, prompt_lens=[5, 7], max_new_tokens=GEN, seed=11)
PREFIX_TRACE = dict(n=12, prompt_lens=[4], max_new_tokens=3, seed=9,
                    shared_prefix_len=16, n_tenants=3)
PREFIX_KW = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=8,
                 prefix_cache=True)
RR = dict(n_replicas=2, policy="round_robin")
LOSE0 = dict(kill_replica=0, at_step=2, lose_devices=1)
QUANT_TP = dict(pim_mode="quant_tp")

# name -> (case, args after the params); fleet_case's are (overrides,
# trace, ServingConfig, RouterConfig, FailurePlan, kill_at)
FLEET_JOBS = {
    "elastic": (RR, None, None),
    "model_parallel": (dict(RR, model_parallel=2), None, None),
    "lose_devices": (dict(RR, model_parallel=2), LOSE0, None),
    "kill": (RR, None, (2, 0, 1)),
    "least_loaded": (dict(n_replicas=2, policy="least_loaded"),
                     dict(kill_replica=1, at_step=2), None),
    "prefix_affinity": (dict(n_replicas=2, policy="prefix_affinity"), None,
                        None),
}
FLEET_CLI = CLI + ["--pim-mode", "quant_tp", "--replicas", "2",
                   "--model-parallel", "2", "--router-policy",
                   "round_robin", "--kill-replica", "0:2"]


def _fleet_job(name):
    rcfg, plan, kill = FLEET_JOBS[name]
    over = QUANT_TP if name in ("model_parallel", "lose_devices") else {}
    if name == "elastic":
        plan = LOSE0
    if name == "prefix_affinity":
        return (over, PREFIX_TRACE, PREFIX_KW, rcfg, plan, kill)
    return (over, TRACE, dict(max_batch=2, prompt_bucket=8), rcfg, plan,
            kill)


@pytest.fixture(scope="module")
def fleet_runs(models):
    """Every fleet-over-ranks case in one spawn of four ranks: name ->
    each rank's result."""
    pr = models[2]
    params_np = jax.tree.map(np.asarray, pr)
    jobs = [("fleet_case", (params_np,) + _fleet_job(n)) for n in FLEET_JOBS]
    jobs.append(("cli_case", ("serve", FLEET_CLI)))
    ranks = spawn(C.run_jobs, WORLD, jobs, timeout_s=FLEET_TIMEOUT_S)
    names = list(FLEET_JOBS) + ["cli"]
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def quant_oracle(models):
    """The reference's single scheduler in ``quant`` on _trace: the oracle
    of the ``quant_tp`` fleets (``quant_tp`` tiles are exact, and a
    replica shrunk to one rank runs ``quant``)."""
    cfg_r, _, pr, _ = models
    reqs = _trace(R.synthetic_requests, cfg_r)
    sched = R.Scheduler(pr, cfg_r.scaled(pim_mode="quant"),
                        R.ServingConfig(max_batch=4, prompt_bucket=8))
    for r in reqs:
        sched.submit_request(r)
    out = sched.run()
    return [out[r.rid].tolist() for r in reqs]


def _same_on_every_rank(runs):
    for r in runs[1:]:
        assert r == runs[0]
    return runs[0]


def _tokens(oracle):
    return [np.asarray(t).tolist() for t in oracle]


def test_elastic_mesh_shrinks_on_device_loss(fleet_runs, oracle):
    """The mirror of tests/test_serving_router.py's: replica 0's sub-mesh
    is re-derived over its surviving rank mid-serve and the trace still
    completes exactly, on every rank."""
    runs = fleet_runs["elastic"]
    for rank, run in enumerate(runs):
        assert run["before"][0][0] == [0, 1]            # two ranks
        assert run["before"][0][1] == {"pod": 1, "data": 2, "model": 1}
        ranks, shape, alive = run["after"][0]
        assert ranks == [1] and alive                  # shrank to one
        assert shape == {"pod": 1, "data": 1, "model": 1}
        assert run["restarts"] == 1 and run["rebalanced"] > 0
        # rank 0 was lost: it holds no scheduler of replica 0 any more
        assert run["member"] == [rank == 1, rank >= 2]
    run = _same_on_every_rank([{k: v for k, v in r.items()
                                if k not in ("member", "exchanges")}
                               for r in runs])
    assert run["tokens"] == _tokens(oracle)
    assert run["summary"]["n_finished"] == N_REQ


@pytest.mark.parametrize("option", ["model_parallel", "lose_devices",
                                    "kill", "cli"])
def test_fleet_over_ranks_option(fleet_runs, oracle, quant_oracle, option):
    """A per-replica model axis, ranks that die with a replica (by plan
    and by a direct ``_kill``) and the serve CLI's ``--replicas 2
    --model-parallel 2`` under a world of four: the tokens are the
    reference single scheduler's (``quant`` for the ``quant_tp``
    fleets)."""
    if option == "cli":
        got = _same_on_every_rank([r[0] for r in fleet_runs["cli"]])
        out = fleet_runs["cli"][0][1]
        assert "[router] round_robin over 2 replicas" in out
        assert "1 restarts" in out
        want = serve_cli.main(CLI)
        assert [got[k] for k in sorted(got, key=int)] == \
            [want[k].tolist() for k in sorted(want)]
        return
    run = _same_on_every_rank([{k: v for k, v in r.items() if k != "member"}
                               for r in fleet_runs[option]])
    want = quant_oracle if option in ("model_parallel", "lose_devices") \
        else _tokens(oracle)
    assert run["tokens"] == want
    tp = {"pod": 1, "data": 1, "model": 2}
    if option == "model_parallel":
        assert [b[1] for b in run["before"]] == [tp, tp]
        assert run["restarts"] == 0
    elif option == "lose_devices":
        assert run["before"][0] == ([0, 1], tp)
        assert run["after"][0] == ([1], {"pod": 1, "data": 1, "model": 1},
                                   True)
        assert run["after"][1] == ([2, 3], tp, True)
        assert run["restarts"] == 1
    else:
        assert run["after"][0][0] == [1] and run["restarts"] == 1
    # two world exchanges a round (a kill adds two): rank 0's decisions
    # and the replicas' reports
    assert run["exchanges"]["world_gather"] >= run["steps"]


@pytest.mark.parametrize("policy", ["least_loaded", "prefix_affinity"])
def test_fleet_over_ranks_policy(fleet_runs, models, policy):
    """The load signals cross processes: rank 0 dispatches from the
    replicas' reports, and every request lands where the reference's
    router over four devices puts it, with its tokens, migrations, round
    count and summary (a kill of replica 1 under ``least_loaded``; the
    prefix hit rate under ``prefix_affinity``)."""
    cfg_r, _, pr, _ = models
    run = _same_on_every_rank([{k: v for k, v in r.items()
                                if k not in ("member", "exchanges")}
                               for r in fleet_runs[policy]])
    _, trace, scfg, rcfg, plan, _ = _fleet_job(policy)
    rrouter = R.Router(pr, cfg_r, R.ServingConfig(**scfg),
                       R.RouterConfig(**rcfg), devices=jax.devices()[:WORLD],
                       clock=FakeClock(1.0),
                       failure_plan=R.FailurePlan(**plan) if plan else None)
    trace = dict(trace)
    reqs = R.synthetic_requests(trace.pop("n"), vocab_size=cfg_r.vocab_size,
                                **trace)
    for r in reqs:
        rrouter.submit_request(r)
    res = rrouter.run()
    s = rrouter.metrics().summary()
    assert run["tokens"] == [res[r.rid].tolist() for r in reqs]
    assert run["replica_ids"] == [r.replica_id for r in reqs]
    assert run["migrations"] == [r.n_migrations for r in reqs]
    assert run["steps"] == rrouter.step_count
    assert run["per_replica"] == sorted(s["per_replica_tok_s"])
    for k, v in run["summary"].items():
        assert v == s[k] or (v != v and s[k] != s[k]), k
    assert len(set(run["replica_ids"])) == 2


def test_rank_that_skips_a_respawn_group_hangs(models):
    """Every rank must build every replica's groups, even those it is not
    in: a rank that skips replica 0's respawn groups makes the next
    respawn wait forever, and the spawn's timeout turns the hang into a
    failure."""
    params_np = jax.tree.map(np.asarray, models[2])
    with pytest.raises((TimeoutError, RuntimeError)) as err:
        spawn(C.skip_group_case, WORLD, params_np, 3, timeout_s=15.0)
    assert "respawned" not in str(err.value)
