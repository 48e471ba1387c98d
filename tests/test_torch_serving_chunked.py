"""The port's chunked and packed prefill, held to ``repro.serving`` on the
cases of tests/test_serving_chunked.py, plus an EOS parity test.

Each serving case runs the same seeded trace with the same weights (the
reference's ``init_params``, imported by ``from_reference``) through the
reference scheduler and the port's, on the float32 smoke model: the token
streams must be equal, and equal to whole-prompt prefill.  The router
case (a replica killed mid-prefill) waits with its module (ROADMAP queue
1); the windowed-admit case is in tests/test_torch_window.py.
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
from repro.serving import make_request as r_make_request
from repro_torch.models import model_lib as TM
from repro_torch.serving import Scheduler, ServingConfig, make_request

LOGIT_TOL = 1e-4      # float32 logits, as in test_torch_model.py


def _pair(cfg_r, cfg_t, seed):
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                           device="cpu")
    return pr, pt


def _tiny(mode):
    kw = dict(n_layers=1, pattern=("ad",), d_model=32, n_heads=2,
              n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
              pad_vocab_multiple=8, loss_chunk=8, max_seq_len=48,
              pim_mode=mode)
    return (RC.get("qwen1.5-0.5b").smoke().scaled(**kw),
            TC.get("qwen1.5-0.5b").smoke().scaled(**kw))


def _bursty_trace(vocab, *, long_plen, seed=0):
    """Short prompts with staggered budgets plus one long prompt wedged
    mid-queue — the chunking workload."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(1, vocab, (3, 5, 4, 6)[i]), (4, 6, 5, 4)[i])
            for i in range(4)]
    reqs.insert(2, (rng.integers(1, vocab, long_plen), 4))
    return reqs


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


@pytest.fixture(scope="module")
def smoke():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    return (cfg_r, cfg_t) + _pair(cfg_r, cfg_t, 2)


# ---------------------------------------------------------------------------
# chunked + packed scheduling: the tokens of whole prefill and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_chunked_bit_exact_per_pim_mode(mode):
    cfg_r, cfg_t = _tiny(mode)
    pr, pt = _pair(cfg_r, cfg_t, 0)
    reqs = _bursty_trace(cfg_t.vocab_size, long_plen=32, seed=1)
    base = dict(max_batch=3, prompt_bucket=4, block_size=4, paged=True)
    chunked = dict(prefill_chunk=8, step_token_budget=8, packed_prefill=True)
    _, whole = _run_port(pt, cfg_t, reqs, **base)
    sched, got = _run_port(pt, cfg_t, reqs, **base, **chunked)
    rsched, ref = _run_ref(pr, cfg_r, reqs, **base, **chunked)
    assert whole == got == ref, f"chunked/packed divergence under {mode}"
    s = sched.metrics.summary()
    # the 32-token prompt chunked (4 chunks of 8)
    assert s["prefill_chunks"] == 4
    assert s["packed_prefills"] == rsched.metrics.summary()["packed_prefills"]
    assert sched.decode_traces == 1


def test_decode_trace_stays_single_under_chunk_churn(smoke):
    """Mid-prefill slots joining and leaving the decode batch never change
    the decode step's input shapes, and the tokens equal whole prefill's
    and the reference's."""
    cfg_r, cfg_t, pr, pt = smoke
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg_t.vocab_size, 40), 6) for _ in range(3)]
    reqs += [(rng.integers(1, cfg_t.vocab_size, p), g)
             for p, g in ((5, 7), (9, 4), (3, 9), (7, 5))]
    base = dict(max_batch=4, prompt_bucket=8, paged=True, block_size=8)
    chunked = dict(prefill_chunk=16, step_token_budget=16,
                   packed_prefill=True)
    sched, got = _run_port(pt, cfg_t, reqs, **base, **chunked)
    assert sched.decode_traces == 1
    s = sched.metrics.summary()
    assert s["prefill_chunks"] >= 9          # 3 prompts x 3 chunks
    _, whole = _run_port(pt, cfg_t, reqs, **base)
    _, ref = _run_ref(pr, cfg_r, reqs, **base, **chunked)
    assert got == whole == ref
    assert sched.pool.blocks_in_use == 0     # every block returned


def _pack(prompts, widths):
    L = sum(widths)
    toks = np.zeros((1, L), np.int32)
    pos = np.zeros(L, np.int32)
    seg = np.full(L, -1, np.int32)
    last = np.zeros(len(prompts), np.int32)
    s0 = 0
    for i, (p, w) in enumerate(zip(prompts, widths)):
        toks[0, s0:s0 + len(p)] = p
        pos[s0:s0 + w] = np.arange(w)
        seg[s0:s0 + len(p)] = i
        last[i] = s0 + len(p) - 1
        s0 += w
    return toks, pos, seg, last


def test_packed_segments_are_isolated():
    """Each packed segment's logits equal its own unpacked prefill's and
    the reference's packed logits; perturbing one segment's tokens moves
    no other segment's logits (the block-diagonal mask isolates)."""
    cfg_r, cfg_t = _tiny("xla")
    pr, pt = _pair(cfg_r, cfg_t, 4)
    rng = np.random.default_rng(5)
    plens, widths = [5, 3, 7], [8, 4, 8]     # bucket-aligned widths
    prompts = [rng.integers(1, cfg_t.vocab_size, p) for p in plens]

    def port(prompts):
        arrs = [torch.from_numpy(a) for a in _pack(prompts, widths)]
        return TM.prefill_packed(pt, *arrs, cfg_t)

    packed, cache = port(prompts)
    want, rcache = RM.prefill_packed(
        pr, *[jnp.asarray(a) for a in _pack(prompts, widths)], cfg_r)
    np.testing.assert_allclose(packed.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["0"][key].numpy(),
                                   np.asarray(rcache["0"][key]), atol=1e-5)
    for i, (p, w) in enumerate(zip(prompts, widths)):
        toks = np.zeros((1, w), np.int64)
        toks[0, :len(p)] = p
        solo, _ = TM.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                             last_index=torch.tensor([len(p) - 1]))
        np.testing.assert_allclose(packed[i].numpy(), solo[0].numpy(),
                                   rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"segment {i} != solo prefill")
    mutated = list(prompts)
    mutated[1] = rng.integers(1, cfg_t.vocab_size, plens[1])
    perturbed, _ = port(mutated)
    for i in (0, 2):
        assert torch.equal(packed[i], perturbed[i]), \
            f"segment {i} leaked across the segment mask"
    assert not torch.equal(packed[1], perturbed[1])


def test_chunked_config_validation(smoke):
    cfg = smoke[1]
    with pytest.raises(ValueError, match="multiple of block_size"):
        Scheduler(None, cfg, ServingConfig(paged=True, block_size=8,
                                           prefill_chunk=12), device="cpu")
    with pytest.raises(ValueError, match="below"):
        Scheduler(None, cfg, ServingConfig(paged=True, block_size=8,
                                           prefill_chunk=16,
                                           step_token_budget=8),
                  device="cpu")
    with pytest.raises(ValueError, match="step_token_budget"):
        Scheduler(None, cfg, ServingConfig(step_token_budget=0),
                  device="cpu")
    moe = cfg.scaled(pattern=("ae",), n_layers=2, n_experts=4)
    with pytest.raises(ValueError, match="packed_prefill"):
        Scheduler(None, moe, ServingConfig(packed_prefill=True),
                  device="cpu")
    with pytest.raises(ValueError, match="unknown queue policy"):
        Scheduler(None, cfg, ServingConfig(queue_policy="lifo"),
                  device="cpu")


def test_deferred_admits_dedupes_across_sjf_head_churn(smoke):
    """Under SJF the queue head changes identity while a request waits:
    a continued wait is the same deferral event, as in the reference."""
    cfg_r, cfg_t, pr, pt = smoke
    rng = np.random.default_rng(11)
    hold = rng.integers(1, cfg_t.vocab_size, 4)
    a = rng.integers(1, cfg_t.vocab_size, 8)
    b = rng.integers(1, cfg_t.vocab_size, 4)
    kw = dict(max_batch=2, prompt_bucket=4, paged=True, block_size=4,
              num_blocks=4, queue_policy="sjf")

    def drive(sched, mk):
        # each request needs 3 blocks of 4; the pool holds 3 usable blocks
        sched.submit_request(mk(hold, 8, rid=1))
        sched.step()
        assert sched.n_active == 1
        sched.submit_request(mk(a, 4, rid=2))
        sched.step()
        assert sched.metrics.deferred_admits == 1    # A behind hold
        sched.submit_request(mk(b, 8, rid=3))
        sched.step()
        assert sched.metrics.deferred_admits == 2    # B is the SJF head
        for _ in range(40):
            sched.step()
            if not len(sched.queue) and not sched.active_slots.any():
                break
        assert not len(sched.queue)
        assert sched.metrics.deferred_admits == 2
        return [sched.output(r).tolist() for r in (1, 2, 3)]

    got = drive(Scheduler(pt, cfg_t, ServingConfig(**kw), clock=lambda: 0.0,
                          device="cpu"), make_request)
    want = drive(RScheduler(pr, cfg_r, RServingConfig(**kw),
                            clock=lambda: 0.0), r_make_request)
    assert got == want


# ---------------------------------------------------------------------------
# EOS: the same early stops as the reference, on every admit path
# ---------------------------------------------------------------------------

def _first_fresh(stream, start=2):
    """The first index >= ``start`` whose token does not occur earlier in
    ``stream``: with that token as EOS, the stream stops exactly there."""
    for j in range(start, len(stream)):
        if stream[j] not in stream[:j]:
            return j
    raise AssertionError(f"no first occurrence past {start} in {stream}")


def _cut(stream, eos):
    return stream[:stream.index(eos) + 1] if eos in stream else stream


def test_eos_parity_including_a_packed_admit(smoke):
    """Four short prompts admitted by one packed prefill.  With EOS set to
    request 1's first token, request 1 finishes inside the packed admit;
    with EOS set to a token of request 0 whose first occurrence is at a
    known index >= 2, request 0 stops there.  Every stream is its no-EOS
    stream cut at its first EOS, and equals the reference's."""
    cfg_r, cfg_t, pr, pt = smoke
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(1, cfg_t.vocab_size, p), 8) for p in (5, 7, 4, 6)]
    base = dict(max_batch=4, prompt_bucket=8, paged=True,
                packed_prefill=True)
    sched, full = _run_port(pt, cfg_t, reqs, **base)
    assert sched.metrics.summary()["packed_prefills"] == 1
    _, ref_full = _run_ref(pr, cfg_r, reqs, **base)
    assert full == ref_full
    j = _first_fresh(full[0])
    for eos, stopped, length in ((full[1][0], 1, 1), (full[0][j], 0, j + 1)):
        sched, got = _run_port(pt, cfg_t, reqs, eos_id=eos, **base)
        _, want = _run_ref(pr, cfg_r, reqs, eos_id=eos, **base)
        assert got == want == [_cut(s, eos) for s in full]
        assert len(got[stopped]) == length
        assert sched.metrics.summary()["packed_prefills"] == 1
        assert sched.pool.blocks_in_use == 0
