"""The dense LM stack against ``repro.models.model_lib`` on the smoke
config of qwen1.5-0.5b (float32), with the reference's weights imported by
``from_reference``.

Tolerances: the two stacks run the same float32 math in different
reduction orders (XLA vs PyTorch CPU kernels), so logits agree to a few
float32 ulps of the activations: ``LOGIT_TOL`` = 1e-4 absolute on logits of
magnitude ~1 (observed ~1e-6).  Greedy tokens must be equal wherever the
reference's top-2 margin exceeds 2 * LOGIT_TOL.  The ``pim_sim`` test is
held to the same tolerance: its linears are bit-identical (the integer
GEMM is exact), and on its seeded inputs no activation lies within a
reduction-order ulp of a 7-bit rounding edge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.models.attention import decode_attention as r_decode_attention
from repro.models.attention import flash_attention as r_flash_attention
from repro.serving.cache import PagedCachePool as RPaged
from repro_torch.models import attention as A
from repro_torch.models import model_lib as TM
from repro_torch.models.layers import rms_norm, unembed
from repro_torch.serving.cache import PagedCachePool

LOGIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _tree_t(tree):
    return {i: {k: _t(v) for k, v in c.items()} for i, c in tree.items()}


@pytest.fixture(scope="module")
def models():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    cfg_t = TC.get("qwen1.5-0.5b").smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    # the QKV biases init to zero: perturb them so the bias path is live
    for b in ("bq", "bk", "bv"):
        leaf = pr["blocks"]["0"][b]
        pr["blocks"]["0"][b] = leaf + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(b)), leaf.shape)
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    return cfg_r, cfg_t, pr, pt


def _assert_logits(want, got, tol):
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def test_from_reference_is_bit_exact(models):
    cfg_r, cfg_t, pr, pt = models
    assert torch.equal(pt["embed"], _t(pr["embed"]))
    assert torch.equal(pt["blocks"]["0"]["w_gate"],
                       _t(pr["blocks"]["0"]["w_gate"]))
    assert TM.param_count(cfg_t) == RM.param_count(cfg_r)
    full = TM.init_params(TC.get("qwen1.5-0.5b").scaled(n_layers=2), 0,
                          device="cpu")
    assert full["embed"].shape == (152064, 1024)
    assert full["embed"].dtype == torch.bfloat16
    assert full["blocks"]["0"]["w_in"].shape == (2, 1024, 2816)


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_prefill_and_decode_match_reference(models, mode):
    cfg_r, cfg_t, pr, pt = models
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_r.vocab_size, (2, 11)).astype(np.int32)
    last = np.array([10, 6], np.int32)
    lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr,
                             last_index=jnp.asarray(last))
    lt, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, ct,
                             last_index=_t(last))
    _assert_logits(lr, lt, LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t["0"][key].numpy(),
                                   np.asarray(cache_r["0"][key]), atol=1e-5)
    # continuous-batching decode over the contiguous caches: per-slot
    # positions, one inactive slot
    nxt = toks[:, :1]
    pos = np.array([11, 7], np.int32)
    active = np.array([True, False])
    tr, lr2, new_r = RM.decode_step_slots(
        pr, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(active),
        cache_r, cr)
    tt, lt2, new_t = TM.decode_step_slots(
        pt, _t(nxt).long(), _t(pos), _t(active), cache_t, ct)
    _assert_logits(lr2, lt2, LOGIT_TOL)
    assert tt[1, 0] == 0 and int(tr[1, 0]) == 0
    for key in ("k", "v"):
        np.testing.assert_allclose(new_t["0"][key].numpy(),
                                   np.asarray(new_r["0"][key]), atol=1e-5)


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_paged_decode_matches_reference(models, mode):
    """decode_step_slots through block tables: the same pool contents and
    table go to both stacks; one slot writes past its capacity (routed to
    the trash block) and one slot is empty (all-sentinel row)."""
    cfg_r, cfg_t, pr, pt = models
    cr = cfg_r.scaled(pim_mode=mode, max_seq_len=24)
    ct = cfg_t.scaled(pim_mode=mode, max_seq_len=24)
    rng = np.random.default_rng(2)
    rpool = RPaged(cr, 3, 24, block_size=8)
    tpool = PagedCachePool(ct, 3, 24, block_size=8, device="cpu")
    for slot, plen in ((0, 9), (1, 20)):
        toks = rng.integers(0, cfg_r.vocab_size, (1, plen)).astype(np.int32)
        _, rc = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr)
        _, tc = TM.prefill(pt, {"tokens": _t(toks).long()}, ct)
        rpool.admit(slot, rc, plen, plen + 3)
        tpool.admit(slot, tc, plen, plen + 3)
    np.testing.assert_array_equal(tpool.block_tables.numpy(),
                                  np.asarray(rpool.block_tables))
    # identical pool contents on both sides (the import is checked above)
    caches = _np_tree(rpool.caches)
    tcaches = _tree_t(caches)
    nxt = rng.integers(0, cfg_r.vocab_size, (3, 1)).astype(np.int32)
    pos = np.array([9, 24, 0], np.int32)    # slot 1 writes at lcap
    active = np.array([True, True, False])
    table = np.asarray(rpool.block_tables)
    tr, lr, new_r = RM.decode_step_slots(
        pr, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(active),
        jax.tree.map(jnp.asarray, caches), cr,
        block_tables=jnp.asarray(table))
    tt, lt, new_t = TM.decode_step_slots(
        pt, _t(nxt).long(), _t(pos), _t(active), tcaches, ct,
        block_tables=_t(table))
    _assert_logits(lr, lt, LOGIT_TOL)
    for key in ("k", "v"):
        r_new = np.asarray(new_r["0"][key])
        t_new = new_t["0"][key].numpy()
        # every block but the trash block 0 agrees
        np.testing.assert_allclose(t_new[:, 1:], r_new[:, 1:], atol=1e-5)
        # slot 1's last real block keeps its committed rows
        last_blk = table[1, -1]
        np.testing.assert_array_equal(t_new[:, last_blk],
                                      caches["0"][key][:, last_blk])


def test_int8_kv_cache_matches_reference(models):
    cfg_r, cfg_t, pr, pt = models
    cr = cfg_r.scaled(kv_cache_dtype="int8")
    ct = cfg_t.scaled(kv_cache_dtype="int8")
    toks = np.random.default_rng(3).integers(0, 277, (1, 9)).astype(np.int32)
    lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr)
    lt, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, ct)
    _assert_logits(lr, lt, LOGIT_TOL)
    assert cache_t["0"]["k"].dtype == torch.int8
    assert set(cache_t["0"]) == set(cache_r["0"])
    _, lr2, _ = RM.decode_step(pr, jnp.asarray(toks[:, :1]), jnp.int32(9),
                               cache_r, cr)
    _, lt2, _ = TM.decode_step(pt, _t(toks[:, :1]).long(), 9, cache_t, ct)
    _assert_logits(lr2, lt2, LOGIT_TOL)


def test_decode_matches_forward(models):
    """prefill(x[:L]) + decode step == forward(x[:L+1]) last-token logits
    (the self-check of tests/test_lm_correctness.py, within the port)."""
    _, cfg, _, params = models
    rng = np.random.default_rng(1)
    L = 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, L + 1)))
    _, caches = TM.prefill(params, {"tokens": toks[:, :L]}, cfg)
    _, logits_dec, _ = TM.decode_step(params, toks[:, L:L + 1], L, caches,
                                      cfg)
    x = TM._embed_in(params, toks, cfg)
    x, _ = TM._decoder_stack(params, x, cfg, positions=torch.arange(L + 1),
                             mode="train")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits_fwd = unembed(x[:, -1], TM._unembed_table(params, cfg))
    torch.testing.assert_close(logits_dec, logits_fwd, rtol=2e-3, atol=2e-3)


def test_attention_matches_reference_and_flash_equals_direct():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 100, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 100, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 100, 2, 16)).astype(np.float32)
    for window in (None, 17):
        a = A.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, block_q=32, block_k=32)
        b = A.direct_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window)
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
        r = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, block_q=32,
                              block_k=32)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    valid = rng.random((2, 100)) < 0.7
    valid[:, 0] = True
    got = A.decode_attention(_t(q[:, :1]), _t(k), _t(v), valid=_t(valid))
    want = r_decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                              jnp.asarray(v), valid=jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pim_sim_narrow_model_matches_reference():
    """One prefill and one decode step with every linear on the crossbar
    simulator (the port's plain per-gate executor), at a width where each
    linear is one 32-term program."""
    kw = dict(d_model=32, d_ff=32, head_dim=8, n_heads=4, n_kv_heads=4,
              pim_mode="pim_sim", max_seq_len=16)
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(**kw)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(**kw)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(3))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    toks = np.random.default_rng(4).integers(0, 277, (1, 6)).astype(np.int32)
    lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r)
    lt, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, cfg_t)
    _assert_logits(lr, lt, LOGIT_TOL)
    nxt = np.asarray(lr).argmax(-1)[:, None].astype(np.int32)
    _, lr2, _ = RM.decode_step(pr, jnp.asarray(nxt), jnp.int32(6), cache_r,
                               cfg_r)
    _, lt2, _ = TM.decode_step(pt, _t(nxt).long(), 6, cache_t, cfg_t)
    _assert_logits(lr2, lt2, LOGIT_TOL)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_matches_reference(name):
    """``activation(name)`` against the reference's (jax.nn.gelu is the
    tanh approximation) on [-4, 4] in float32."""
    from repro.models.layers import activation as r_activation

    from repro_torch.models.layers import activation

    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    got = activation(name)(_t(x)).numpy()
    want = np.asarray(r_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# bfloat16 logits: both stacks round every activation to bf16 (8 mantissa
# bits), in different reduction orders, so the logits (|logit| <= ~1.5 on
# the smoke model) may differ by a few bf16 ulps (2**-7 = 0.0078 at 1-2);
# 0.05 is about 6 of them.  The argmax must agree.
BF16_LOGIT_TOL = 0.05


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_bf16_prefill_matches_reference(mode):
    """The served dtype: the smoke model in bfloat16, prefill logits of
    both stacks from the same weights, in every ported lowering."""
    kw = dict(dtype="bfloat16", pim_mode=mode)
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(**kw)
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(**kw)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(5))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    assert pt["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(6).integers(0, 277, (2, 11)).astype(
        np.int32)
    lr, _ = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r)
    lt, _ = TM.prefill(pt, {"tokens": _t(toks).long()}, cfg_t)
    lr = np.asarray(lr)
    np.testing.assert_allclose(lt.numpy(), lr, rtol=0, atol=BF16_LOGIT_TOL)
    np.testing.assert_array_equal(lt.numpy().argmax(-1), lr.argmax(-1))
