"""granite-4.0-h-small in the port: the Mamba-2 block ``"ms"`` and the
attention block ``"as"``, each with the MoE beside a shared expert, the muP
multipliers and NoPE, against the benchmark's plain reference
(``bench/reference/granite_hybrid.py``, float32 PyTorch that imports
nothing of the port).  The JAX package has no such model.

The smoke size (``ModelConfig.smoke``): one period of 10 layers, d 64, 8
experts top 2 beside a shared expert of 48, 4 Mamba-2 heads of 16 and
d_state 16, float32, on weights the reference draws from a seed.

Tolerances:

* ``LOGIT_TOL`` = 2e-6 on logits whose spread is about 0.03: float32 on
  both sides, in different reduction orders (5e-8 read); the reference's
  linears are its fixed point at 24 bits, which is float32's own
  precision (the port's ``xla`` linears do not round).
* ``QUANT_TOL`` = 2e-5, the benchmark's test's: ``quant`` and ``pim_sim``
  against the reference at the mode's bits, where the integer products
  are exact and only the float rescales and the rest differ in order.
* ``STATE_TOL`` = 1e-5 relative (and 1e-6 absolute) on the Mamba-2 state
  carried across a decode step: ``in_proj`` over 9 rows and then 1 rounds
  in another order than over 10 (1.1e-6 read on an element of 0.87).
* A dropped mechanism must move a logit by more than 10 x ``LOGIT_TOL``.
"""
import dataclasses
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import repro_torch.configs as TC  # noqa: E402
from bench.reference import granite_hybrid as G  # noqa: E402
from repro_torch.models import model_lib as TM  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.pim import engine  # noqa: E402
from repro_torch.serving import PagedCachePool, Scheduler, ServingConfig  # noqa: E402,E501

LOGIT_TOL = 2e-6
QUANT_TOL = 2e-5
STATE_TOL = 1e-5
FLOAT_BITS = 24
MODE_BITS = {"quant": (8, False), "pim_sim": (7, True)}
SEED = 2 ** 31 + 7
CFG = TC.get("granite-4.0-h-small").smoke()


def _arch(cfg):
    names = {f.name for f in dataclasses.fields(G.Arch)}
    return G.Arch.from_model({k: v for k, v in dataclasses.asdict(cfg).items()
                              if k in names})


@pytest.fixture(scope="module")
def params():
    return G.draw(_arch(CFG), SEED, "cpu")


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab_size, (n,)))


def _forward(params, toks, cfg):
    """The port's full forward (the train mode's stack): logits at every
    position of ``toks`` (L,)."""
    with torch.no_grad():
        x = TM._embed_in(params, toks[None], cfg)
        x, _ = TM._decoder_stack(params, x, cfg,
                                 positions=torch.arange(len(toks)),
                                 mode="train")
        x = TM.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return TM._logits(x[0], TM._unembed_table(params, cfg), cfg)


def _reference(params, toks, n_prompt, bits=FLOAT_BITS, wide=True):
    return G.served_logits(params, _arch(CFG), [(toks, n_prompt)], bits,
                           wide)[0]


def test_registry_holds_the_published_model():
    cfg = TC.get("granite-4.0-h-small")
    assert (cfg.n_layers, cfg.n_super, cfg.d_model, cfg.hd) == (40, 4, 4096,
                                                                128)
    assert cfg.pattern == ("ms",) * 5 + ("as",) + ("ms",) * 4
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab) == (32, 8, 100352)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.shared_d_ff) == (
        72, 10, 768, 1536)
    assert (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
            cfg.mamba_d_conv, cfg.d_inner) == (128, 64, 128, 4, 8192)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling, cfg.use_rope,
            cfg.tie_embeddings) == (12.0, 0.22, 1 / 128, 16.0, False, True)
    assert cfg.has_recurrent_blocks
    specs = TM.param_specs(cfg)["blocks"]
    assert specs["0"]["in_proj"][0] == (4, 4096, 2 * 8192 + 2 * 128 + 128)
    assert specs["0"]["conv_w"][0] == (4, 4, 8192 + 2 * 128)
    assert specs["5"]["w_in"][0] == (4, 4096, 1536)
    assert specs["5"]["w1"][0] == (4, 72, 4096, 768)
    caches = TM.cache_specs(cfg, 8, 64)
    assert caches["0"]["ssm"] == ((4, 8, 128, 64, 128), torch.float32)
    assert set(caches["5"]) == {"k", "v"}


def test_full_forward_logits_equal_the_reference(params):
    toks = _tokens(12)
    got = _forward(params, toks, CFG)
    want = _reference(params, toks, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


def test_prefill_then_decode_through_the_paged_pool(params):
    """Two prompts prefilled into a paged pool, then 8 decode steps of
    both slots: each step's logits are the reference's full forward at
    that position."""
    prompts = [_tokens(5, 1), _tokens(9, 2)]
    pool = PagedCachePool(CFG, 2, block_size=4, device="cpu")
    fed, out = [list(p.tolist()) for p in prompts], [[], []]
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            logits, cache = TM.prefill(params, {"tokens": p[None]}, CFG)
            pool.admit(slot, cache, len(p), len(p) + 8)
            out[slot].append(logits[0])
        for _ in range(8):
            tok = torch.tensor([[int(o[-1].argmax())] for o in out])
            pos = torch.tensor([len(f) for f in fed])
            for f, t in zip(fed, tok[:, 0].tolist()):
                f.append(t)
            _, logits, pool.caches = TM.decode_step_slots(
                params, tok, pos, torch.ones(2, dtype=torch.bool),
                pool.caches, CFG, block_tables=pool.block_tables)
            for slot in range(2):
                out[slot].append(logits[slot])
    for slot, p in enumerate(prompts):
        want = _reference(params, torch.tensor(fed[slot]), len(p))
        torch.testing.assert_close(torch.stack(out[slot]), want, rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("mode", ["quant", "pim_sim"])
def test_integer_modes_equal_the_reference_at_their_bits(params, mode):
    """Prefill and two decode steps in ``quant`` and ``pim_sim`` against
    the reference's linears at the mode's bits."""
    cfg = CFG.scaled(pim_mode=mode)
    toks = _tokens(6, 3)
    fed = list(toks.tolist())
    engine.clear_cache()
    with torch.no_grad():
        logits, caches = TM.prefill(params, {"tokens": toks[None]}, cfg)
        got = [logits[0]]
        for _ in range(2):
            fed.append(int(got[-1].argmax()))
            _, logits, caches = TM.decode_step(
                params, torch.tensor([[fed[-1]]]), len(fed) - 1, caches, cfg)
            got.append(logits[0])
    engine.clear_cache()
    bits, wide = MODE_BITS[mode]
    want = _reference(params, torch.tensor(fed), len(toks), bits, wide)
    torch.testing.assert_close(torch.stack(got), want, rtol=0,
                               atol=QUANT_TOL)


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_scheduler_serves_every_mode(params, mode):
    """``Scheduler`` serves the config (paged, unbucketed) and each served
    token is the reference's best at its position."""
    cfg = CFG.scaled(pim_mode=mode)
    bits, wide = MODE_BITS.get(mode, (FLOAT_BITS, True))
    engine.clear_cache()
    sched = Scheduler(params, cfg, ServingConfig(max_batch=1, paged=True,
                                                 prompt_bucket=1),
                      device="cpu")
    prompt = _tokens(5, 4).numpy()
    rid = sched.submit(prompt, 3)
    served = sched.run()[rid]
    engine.clear_cache()
    seq = torch.from_numpy(np.concatenate([prompt, served[:-1]]))
    want = _reference(params, seq, len(prompt), bits, wide)
    gaps = want.max(-1).values - want.gather(
        1, torch.as_tensor(served, dtype=torch.long)[:, None])[:, 0]
    assert float(gaps.max()) <= QUANT_TOL, gaps


def test_mamba2_state_continuity(params):
    """prefill(n) then one decode step gives prefill(n + 1)'s logits and
    Mamba-2 states (capacity factor 16: no MoE drops in either path)."""
    cfg = CFG.scaled(capacity_factor=16.0)
    toks = _tokens(10, 5)
    with torch.no_grad():
        # the attention leaves come padded to max_seq_len: decode's cache
        _, caches = TM.prefill(params, {"tokens": toks[None, :9]}, cfg)
        _, dec, caches = TM.decode_step(params, toks[None, 9:], 9, caches,
                                        cfg)
        want, ref_caches = TM.prefill(params, {"tokens": toks[None]}, cfg)
    torch.testing.assert_close(dec, want, rtol=0, atol=LOGIT_TOL)
    for i, kind in enumerate(cfg.pattern):
        if kind == "ms":
            for k in ("ssm", "conv"):
                torch.testing.assert_close(caches[str(i)][k],
                                           ref_caches[str(i)][k],
                                           rtol=STATE_TOL, atol=1e-6)


def _ungated(y, z, weight, eps):
    return y * F.silu(z.to(torch.float32)) * weight


@pytest.mark.parametrize("dropped", [
    {"residual_multiplier": 1.0}, {"embedding_multiplier": 1.0},
    {"attention_multiplier": None}, {"logits_scaling": 1.0},
    {"use_rope": True}, "gated_norm"])
def test_a_dropped_mechanism_fails_the_tolerance(params, dropped):
    """The comparison sees each mechanism: the port without one of them
    misses the reference by far more than the tolerance."""
    toks = _tokens(12)
    want = _reference(params, toks, 1)
    if dropped == "gated_norm":
        with mock.patch.object(ssm, "gated_norm", _ungated):
            got = _forward(params, toks, CFG)
    else:
        got = _forward(params, toks, CFG.scaled(**dropped))
    assert float((got - want).abs().max()) > 10 * LOGIT_TOL

