"""The port's continuous-batching runtime: both pools give the same
tokens, the tokens equal ``repro.serving.Scheduler``'s on the same trace
and weights, and the decode step keeps one input shape.

The smoke model runs in float32, where the two stacks' logits agree to
~1e-6 (see test_torch_model.py); the seeded traces here have no greedy
step whose top-2 margin is that close, so the token streams must be
equal."""
import time

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro.serving import synthetic_requests as r_synthetic_requests
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model_lib as TM
from repro_torch.serving import (CachePool, PagedCachePool, Scheduler,
                                 ServingConfig, synthetic_requests)


@pytest.fixture(scope="module")
def models():
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(max_seq_len=40)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(max_seq_len=40)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return cfg_r, cfg_t, pr, pt


def _trace(fn, n=6):
    return fn(n, vocab_size=277, prompt_lens=[5, 12, 20, 9], max_new_tokens=8,
              seed=3, start_time=0.0)


def _serve_port(params, cfg, **kw):
    sched = Scheduler(params, cfg, ServingConfig(max_batch=3,
                                                 prompt_bucket=8, **kw),
                      clock=time.monotonic, device="cpu")
    rids = [sched.submit_request(r) for r in _trace(synthetic_requests)]
    out = sched.run()
    return [out[r].tolist() for r in rids], sched


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_scheduler_tokens_match_reference(models, mode):
    cfg_r, cfg_t, pr, pt = models
    got, sched = _serve_port(pt, cfg_t.scaled(pim_mode=mode), paged=True)
    rs = RScheduler(pr, cfg_r.scaled(pim_mode=mode),
                    RServingConfig(max_batch=3, prompt_bucket=8, paged=True))
    rids = [rs.submit_request(r) for r in _trace(r_synthetic_requests)]
    rout = rs.run()
    want = [rout[r].tolist() for r in rids]
    assert got == want
    assert sched.decode_traces == 1 == rs.decode_traces
    s = sched.metrics.summary()
    assert s["n_finished"] == 6 and s["total_tokens"] == 48


def test_paged_and_contiguous_pools_give_the_same_tokens(models):
    _, cfg, _, params = models
    paged, sp = _serve_port(params, cfg, paged=True, block_size=4)
    contiguous, sc = _serve_port(params, cfg)
    assert paged == contiguous
    assert isinstance(sp.pool, PagedCachePool)
    assert isinstance(sc.pool, CachePool)
    assert sp.decode_traces == sc.decode_traces == 1
    assert sp.pool.blocks_in_use == 0            # every block returned


def test_paged_pool_defers_when_short_of_blocks(models):
    """A pool with room for one request at a time still serves the whole
    trace (admission defers, never overruns) with the same tokens."""
    _, cfg, _, params = models
    roomy, _ = _serve_port(params, cfg, paged=True, block_size=4)
    tight, sched = _serve_port(params, cfg, paged=True, block_size=4,
                               num_blocks=8)
    assert tight == roomy
    assert sched.metrics.deferred_admits > 0
    assert sched.pool.peak_blocks_in_use <= 7


def test_pool_round_trip(models):
    _, cfg, _, params = models
    pool = PagedCachePool(cfg, 2, 40, block_size=8, device="cpu")
    toks = torch.from_numpy(np.arange(11)[None] % 277)
    _, cache = TM.prefill(params, {"tokens": toks}, cfg)
    assert pool.can_admit(11 + 5)
    pool.admit(1, cache, 11, 16)
    view = pool.read_slot(1)
    for key in ("k", "v"):
        torch.testing.assert_close(view["0"][key][:, :, :11],
                                   cache["0"][key][:, :, :11], rtol=0, atol=0)
    assert pool.stats()["blocks_in_use"] == 2
    pool.evict(1)
    assert pool.blocks_in_use == 0 and pool.block_tables.abs().sum() == 0
    with pytest.raises(ValueError):
        Scheduler(params, cfg, ServingConfig(max_batch=0), device="cpu")


def test_request_beyond_capacity_is_rejected(models):
    _, cfg, _, params = models
    sched = Scheduler(params, cfg, ServingConfig(max_batch=2), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        sched.submit(np.arange(30), 20)


def test_scheduler_needs_an_explicit_cpu_without_a_card(models):
    _, cfg, _, params = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(params, cfg, ServingConfig())


def test_serve_cli_on_cpu(capsys):
    results = serve_cli.main(["--smoke", "--device", "cpu", "--pim-mode",
                              "quant", "--paged", "--requests", "3",
                              "--batch", "2", "--prompt-lens", "5,9",
                              "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "1 decode shapes" in out
    assert "[pool]" in out and "sample generation" in out
    assert all(len(t) == 4 for t in results.values())
