"""The recurrent blocks (``repro_torch.models.ssm``, ``repro_torch.models
.xlstm`` and the ``"md"``/``"me"``/``"xm"``/``"xs"`` blocks of
``models/model.py``) against ``repro.models.ssm``, ``repro.models.xlstm``
and ``repro.models.model_lib`` on the smoke configs of jamba-v0.1-52b and
xlstm-1.3b (float32), the reference's weights imported by
``from_reference``; the port runs on the CPU, i.e. on the kernels' plain
versions.  The recurrences are ``lax.scan`` in the reference and reach no
Pallas kernel; its ``pim_sim`` linears run its host interpreter.

Exact: every integer GEMM of the path (jamba's MLPs and attention; xLSTM
runs none), the ``"alog"`` init, imported weights, served tokens, the
pool's slot leaves and the refusal messages.  Float tolerances, for the
same float32 math in other reduction orders, each relative to the
largest entry of the reference's tensor: one mixer's or block's output
and state within ``STATE_TOL`` = 1e-5 (a float32 loop over 9-14 steps);
the states at the end of a whole stack within ``STACK_STATE_TOL`` = 1e-4
(each layer's input already differs by the layers below it, as the
logits do, which stay within ``LOGIT_TOL`` = 1e-4 absolute as in
tests/test_torch_model.py); losses within ``LOSS_TOL`` = 1e-5 as in
tests/test_torch_train.py, and each gradient leaf within ``GRAD_TOL`` =
1e-4 of its largest reference entry: five times the dense stacks'
2e-5, for the backward through 12 recurrent float32 steps in each of 8
layers.  The port's own invariants take the
reference tests' tolerances: Mamba state continuity ``rtol=2e-3,
atol=2e-4`` (tests/test_lm_correctness.py), decode == forward
``rtol=atol=2e-3``.
"""
import contextlib
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.kernels.quant_matmul import quant_matmul_int as r_qmm
from repro.launch import train as r_train_cli
from repro.models import model_lib as RM
from repro.models import ssm as r_ssm
from repro.models import xlstm as r_xlstm
from repro.pim import engine as r_engine
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model_lib as TM
from repro_torch.models import ssm as t_ssm
from repro_torch.models import xlstm as t_xlstm
from repro_torch.pim import engine
from repro_torch.serving import (CachePool, PagedCachePool, Scheduler,
                                 ServingConfig)

STATE_TOL = 1e-5
STACK_STATE_TOL = 1e-4
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NAMES = ("jamba-v0.1-52b", "xlstm-1.3b")
STATE_KEYS = ("ssm", "conv", "c", "n", "m")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke(name, **kw):
    return RC.get(name).smoke().scaled(**kw), TC.get(name).smoke().scaled(**kw)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    cfg_r, cfg_t = _smoke(request.param, max_seq_len=32)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(11))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    return cfg_r, cfg_t, pr, pt


def _layer(params, i):
    return {k: np.asarray(v[0]) for k, v in params["blocks"][str(i)].items()}


def _close(got, want, tol=STATE_TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _t(a):
    return TM._from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# the mixers and blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_mamba_mixer_matches_reference(carried):
    """One Mamba layer of jamba's smoke model on (2, 9) tokens, fresh and
    from the state the reference carries out of 5 earlier tokens: the
    output, the float32 SSM state and the conv tail."""
    cfg_r, cfg_t = _smoke("jamba-v0.1-52b")
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(1))
    p = _layer(pr, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 14, cfg_t.d_model), dtype=np.float32)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    state_r = state_t = None
    if carried:
        _, state_r = r_ssm.mamba_mixer(jnp.asarray(x[:, :5]), pj, cfg_r)
        state_t = tuple(_t(s) for s in state_r)
        x = x[:, 5:]
    y_r, (h_r, tail_r) = r_ssm.mamba_mixer(jnp.asarray(x), pj, cfg_r,
                                           state_r)
    y_t, (h_t, tail_t) = t_ssm.mamba_mixer(
        _t(x), {k: _t(v) for k, v in p.items()}, cfg_t, state_t)
    _close(y_t, y_r, what="y")
    _close(h_t, h_r, what="ssm state")
    _close(tail_t, tail_r, what="conv tail")
    assert h_t.dtype == torch.float32


@pytest.mark.parametrize("kind", ["xm", "xs"])
@pytest.mark.parametrize("carried", [False, True])
def test_xlstm_blocks_match_reference(kind, carried):
    """One mLSTM (pattern index 1) or sLSTM (index 0) layer of xlstm's
    smoke model on (2, 9) tokens, fresh and from the reference's carried
    (c, n, m): the output and every state leaf, the stabilizer m
    included."""
    cfg_r, cfg_t = _smoke("xlstm-1.3b")
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(2))
    p = _layer(pr, 1 if kind == "xm" else 0)
    fr = r_xlstm.mlstm_block if kind == "xm" else r_xlstm.slstm_block
    ft = t_xlstm.mlstm_block if kind == "xm" else t_xlstm.slstm_block
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 14, cfg_t.d_model), dtype=np.float32)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    state_r = state_t = None
    if carried:
        _, state_r = fr(jnp.asarray(x[:, :5]), pj, cfg_r)
        state_t = tuple(_t(s) for s in state_r)
        x = x[:, 5:]
    y_r, st_r = fr(jnp.asarray(x), pj, cfg_r, state_r)
    y_t, st_t = ft(_t(x), {k: _t(v) for k, v in p.items()}, cfg_t, state_t)
    _close(y_t, y_r, what="y")
    for name, a, b in zip("cnm", st_t, st_r):
        _close(a, b, what=name)
        assert a.dtype == torch.float32


def test_mamba_state_continuity():
    """The reference's test on the port: a Mamba prefill state continues
    into the next tokens as the whole run does."""
    cfg = TC.get("jamba-v0.1-52b").smoke()
    p = {k: v[0] for k, v in TM.init_params(cfg, 4, "cpu")["blocks"]["0"]
         .items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 12, cfg.d_model), dtype=np.float32))
    y_full, _ = t_ssm.mamba_mixer(x, p, cfg, None)
    _, st = t_ssm.mamba_mixer(x[:, :8], p, cfg, None)
    y_b, _ = t_ssm.mamba_mixer(x[:, 8:], p, cfg, st)
    np.testing.assert_allclose(y_full[:, 8:].numpy(), y_b.numpy(),
                               rtol=2e-3, atol=2e-4)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def test_alog_init_is_the_reference_exactly():
    """``init_params``' ``"alog"`` leaves equal the reference's
    ``materialize`` bit for bit (the smoke config keeps jamba's d_state
    of 16)."""
    cfg_r, cfg_t = _smoke("jamba-v0.1-52b")
    assert cfg_t.mamba_d_state == TC.get("jamba-v0.1-52b").mamba_d_state
    want = RM.init_params(cfg_r, jax.random.PRNGKey(0))["blocks"]
    got = TM.init_params(cfg_t, 0, "cpu")["blocks"]
    n = 0
    for i, block in got.items():
        if "a_log" in block:
            np.testing.assert_array_equal(
                block["a_log"].numpy().view(np.uint32),
                np.asarray(want[i]["a_log"]).view(np.uint32))
            n += 1
    assert n == 7


def test_init_params_draws_each_leaf_on_the_device():
    """Every random leaf is a ``normal_`` on the target device, straight
    into the leaf's dtype (no float32 temporary), from its own generator
    (no numpy draw), with std near ``scale / sqrt(fan_in)``; one seed
    gives one tree, another seed another."""
    cfg = TC.get("jamba-v0.1-52b").smoke()
    specs = dict(TM._leaves(TM.param_specs(cfg)))
    draws = []
    real = torch.Tensor.normal_

    def normal_(self, mean=0.0, std=1.0, *, generator=None):
        draws.append((self.device, generator.device, self.dtype))
        return real(self, mean, std, generator=generator)

    host = AssertionError("a host draw")
    with mock.patch.object(np.random, "Generator", side_effect=host), \
            mock.patch.object(np.random, "default_rng", side_effect=host), \
            mock.patch.object(TM.torch, "randn",
                              side_effect=AssertionError("a float32 draw")), \
            mock.patch.object(torch.Tensor, "normal_", normal_):
        a = dict(TM._leaves(TM.init_params(cfg, 3, "cpu")))
    assert draws and all(d[:2] == (torch.device("cpu"), torch.device("cpu"))
                         for d in draws)
    assert sorted({str(d[2]) for d in draws}) == sorted(
        {str(dt) for _, dt, init, _ in specs.values() if init == "normal"})
    b = dict(TM._leaves(TM.init_params(cfg, 3, "cpu")))
    c = dict(TM._leaves(TM.init_params(cfg, 4, "cpu")))
    n_random = 0
    for path, (shape, dt, init, scale) in specs.items():
        t = a[path]
        assert tuple(t.shape) == shape and t.dtype == dt, path
        assert torch.equal(t, b[path]), path
        if init != "normal":
            assert torch.equal(t, c[path]), path
            continue
        n_random += 1
        assert not torch.equal(t, c[path]), path
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        want = scale / np.sqrt(max(1, fan_in))
        got = float(t.float().std())
        # n >= 64 draws: the sample std's error is about 1/sqrt(2n)
        assert abs(got / want - 1) < 5 / np.sqrt(2 * t.numel()), \
            (path, got, want)
    assert n_random == len(draws) >= 20
    # the leaves draw from independent streams: two leaves of one shape
    # do not repeat each other
    assert not torch.equal(a[("blocks", "0", "w_in")],
                           a[("blocks", "0", "w_gate")])


def test_from_reference_carries_the_recurrent_trees(model):
    cfg_r, cfg_t, pr, pt = model
    want = _np_tree(pr)
    for i in pt["blocks"]:
        assert set(pt["blocks"][i]) == set(want["blocks"][i])
        for k, v in pt["blocks"][i].items():
            w = want["blocks"][i][k]
            assert v.dtype == torch.float32 and tuple(v.shape) == w.shape
            np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                          w.view(np.uint32), err_msg=k)
    assert TM.param_count(cfg_t) == RM.param_count(cfg_r)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

def _assert_logits(want, got):
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def _assert_states(want, got):
    """The recurrent leaves of two cache trees (KV is held by the
    logits)."""
    n = 0
    for i, c in want.items():
        for key, w in c.items():
            if key in STATE_KEYS:
                _close(got[i][key], w, tol=STACK_STATE_TOL,
                       what=f"{i}/{key}")
                n += 1
    assert n


def _recording(mode, calls):
    if mode == "quant":
        real = q_ops.quant_matmul_int

        def record(x, w):
            acc = real(x, w)
            calls.append((x.numpy(), w.numpy(), acc.numpy()))
            return acc

        return mock.patch.object(q_ops, "quant_matmul_int", record)
    if mode == "pim_sim":
        real = engine.matmul_int

        def record(x, w, n_bits=8, **kw):
            acc = real(x, w, n_bits, **kw)
            calls.append((x.numpy(), w.numpy(), acc.numpy(), n_bits))
            return acc

        return mock.patch.object(engine, "matmul_int", record)
    return contextlib.nullcontext()


def _check_gemms(mode, calls):
    for call in calls:
        if mode == "quant":
            x, w, acc = call
            want = np.asarray(r_qmm(jnp.asarray(x), jnp.asarray(w)))
        else:
            x, w, acc, bits = call
            want = r_engine.matmul_int(x.astype(np.uint64),
                                       w.astype(np.uint64), bits,
                                       backend="numpy").astype(np.int64)
        np.testing.assert_array_equal(acc, want)


def _snapshot(tree):
    return {i: {k: v.clone() for k, v in c.items()} for i, c in tree.items()}


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_prefill_and_decode_match_reference(model, mode):
    """Prefill of 2 x 5 tokens, one ``decode_step`` (but in ``pim_sim``,
    whose reference runs its host interpreter) and one
    ``decode_step_slots`` (slot 1 inactive): logits and the recurrent
    state after each, and every integer GEMM, held to the reference's.
    jamba's linears are its 3 Mamba layers' MLPs and the attention
    layer's 7 (16 a step); xLSTM has none."""
    cfg_r, cfg_t, pr, pt = model
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(4).integers(0, cfg_r.vocab_size,
                                             (2, 5)).astype(np.int32)
    calls = []
    engine.clear_cache()
    with _recording(mode, calls):
        lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr)
        lt, cache_t = TM.prefill(pt, {"tokens": torch.from_numpy(toks).long()},
                                 ct)
        _assert_logits(lr, lt)
        _assert_states(cache_r, cache_t)
        slots_t = _snapshot(cache_t)
        nxt = np.asarray(jnp.argmax(lr, -1))[:, None].astype(np.int32)
        if mode != "pim_sim":
            _, lr2, cache_r2 = RM.decode_step(pr, jnp.asarray(nxt),
                                              jnp.int32(5), cache_r, cr)
            _, lt2, cache_t = TM.decode_step(
                pt, torch.from_numpy(nxt).long(), 5, cache_t, ct)
            _assert_logits(lr2, lt2)
            _assert_states(cache_r2, cache_t)
        pos = np.array([5, 5], np.int32)
        active = np.array([True, False])
        tr, lr3, cache_r3 = RM.decode_step_slots(
            pr, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(active),
            cache_r, cr)
        tt, lt3, slots_t = TM.decode_step_slots(
            pt, torch.from_numpy(nxt).long(), torch.from_numpy(pos),
            torch.from_numpy(active), slots_t, ct)
        _assert_logits(lr3, lt3)
        _assert_states(cache_r3, slots_t)
        assert tt.tolist() == np.asarray(tr).tolist()
    engine.clear_cache()
    n_lin = 16 if cfg_t.name.startswith("jamba") else 0
    if mode != "xla":
        assert len(calls) == (2 if mode == "pim_sim" else 3) * n_lin
        _check_gemms(mode, calls)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """The reference's test on the port: prefill(x[:L]) + one decode step
    gives forward(x[:L+1])'s last logits (capacity factor 16: no MoE
    drops in either path)."""
    cfg = TC.get(name).smoke().scaled(capacity_factor=16.0)
    params = TM.init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(1)
    L = 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, L + 1)))
    _, caches = TM.prefill(params, {"tokens": toks[:, :L]}, cfg)
    _, logits_dec, _ = TM.decode_step(params, toks[:, L:], L, caches, cfg)
    x = TM._embed_in(params, toks, cfg)
    x, _ = TM._decoder_stack(params, x, cfg, positions=torch.arange(L + 1),
                             mode="train")
    x = TM.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits_fwd = TM.unembed(x[:, -1], TM._unembed_table(params, cfg))
    np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.numpy(),
                               rtol=2e-3, atol=2e-3)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("name,mode", [("jamba-v0.1-52b", "xla"),
                                       ("xlstm-1.3b", "xla")])
def test_loss_and_grads_match_reference(name, mode):
    """``loss_fn`` and its gradients (2 x 12 tokens) against
    ``jax.value_and_grad`` of the reference's, remat on and off."""
    cfg_r, cfg_t = _smoke(name, pim_mode=mode)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(7))
    toks = np.random.default_rng(8).integers(0, cfg_r.vocab_size, (2, 13))
    br = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    bt = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    want_loss, want = jax.value_and_grad(RM.loss_fn)(pr, br, cfg_r)
    want = dict(_flat(_np_tree(want)))
    for remat in (False, True):
        params = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
        leaves = [v.requires_grad_(True) for _, v in _flat(params)]
        loss = TM.loss_fn(params, bt, cfg_t.scaled(remat=remat))
        grads = torch.autograd.grad(loss, leaves)
        assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
        got = dict(zip([k for k, _ in _flat(params)], grads))
        assert set(got) == set(want)
        for k, g in got.items():
            _close(g, want[k], tol=GRAD_TOL, what=k)
        for leaf in ("a_log", "conv_w", "dt_proj", "w_gates"):
            hit = [k for k in got if k.endswith("/" + leaf)]
            assert all(float(got[k].abs().max()) > 0 for k in hit), leaf


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

# (prompt length, new tokens): lengths off any bucket, served unpadded
TRACE = ((4, 4), (7, 3), (5, 4))


@pytest.mark.parametrize("mode,paged", [("xla", False), ("quant", True)])
def test_scheduler_tokens_match_reference(model, mode, paged):
    """The port's ``Scheduler`` serves the reference's tokens at
    ``prompt_bucket=1``, max_batch 2, contiguous and paged (slot churn:
    3 requests over 2 slots, one decode shape), as the reference's
    tests/test_serving.py::test_recurrent_arch_unbucketed_prefill_matches_naive
    serves xlstm against its naive decode."""
    cfg_r, cfg_t, pr, pt = model
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    rng = np.random.default_rng(3)
    trace = [(rng.integers(1, ct.vocab_size, p), n) for p, n in TRACE]
    kw = dict(max_batch=2, prompt_bucket=1, paged=paged, block_size=4)
    sched = Scheduler(pt, ct, ServingConfig(**kw), clock=time.monotonic,
                      device="cpu")
    rids = [sched.submit(p, n) for p, n in trace]
    out = sched.run()
    got = [out[r].tolist() for r in rids]
    rs = RScheduler(pr, cr, RServingConfig(**kw))
    rrids = [rs.submit(p, n) for p, n in trace]
    rout = rs.run()
    want = [rout[r].tolist() for r in rrids]
    assert got == want
    assert sched.decode_traces == 1 == rs.decode_traces
    assert [len(t) for t in got] == [n for _, n in trace]


def _fill(pool, rng):
    """A (batch-1) prefill-shaped cache of random values for ``pool``."""
    out = {}
    for li, c in pool.caches.items():
        out[li] = {}
        for key, leaf in c.items():
            if key in TM.PAGED_KV_KEYS:
                shape = (leaf.shape[0], 1, 8) + leaf.shape[3:]
            else:
                shape = (leaf.shape[0], 1) + leaf.shape[2:]
            out[li][key] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(leaf.dtype)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_paged_pool_slot_leaves(name):
    """The paged pool installs the recurrent leaves into the slot on
    admit, returns them from ``read_slot``, copies them on a fork and
    zeroes them on evict, leaving the other slots alone; a pure-recurrent
    stack reserves no block."""
    cfg = TC.get(name).smoke().scaled(max_seq_len=16)
    pool = PagedCachePool(cfg, 3, block_size=4, device="cpu")
    rng = np.random.default_rng(9)
    reqs = [_fill(pool, rng) for _ in range(2)]
    pool.admit(0, reqs[0], 8, 12)
    pool.admit(2, reqs[1], 8, 12)
    pure = not any(k in TM.PAGED_KV_KEYS for c in pool.caches.values()
                   for k in c)
    assert pure == (name == "xlstm-1.3b")
    assert pool.blocks_in_use == (0 if pure else 2 * 3)
    keys = [(li, k) for li, c in pool.caches.items() for k in c
            if k in STATE_KEYS]
    assert keys
    for slot, req in ((0, reqs[0]), (2, reqs[1])):
        got = pool.read_slot(slot)
        for li, k in keys:
            assert torch.equal(got[li][k], req[li][k]), (slot, li, k)
    pool.fork(0, 1, 8, 12)
    for li, k in keys:
        assert torch.equal(pool.read_slot(1)[li][k], reqs[0][li][k])
    # the KV blocks follow the pool's rules: the fork maps 2 and takes 1
    assert pool.blocks_in_use == (0 if pure else 2 * 3 + 1)
    pool.evict(0)
    for li, k in keys:
        assert not pool.read_slot(0)[li][k].any()
        assert torch.equal(pool.read_slot(1)[li][k], reqs[0][li][k])
        assert torch.equal(pool.read_slot(2)[li][k], reqs[1][li][k])
    # slot 0's own block is freed, the 2 it shares with slot 1 are not
    assert pool.blocks_in_use == (0 if pure else 2 * 3)


def test_contiguous_pool_slot_leaves():
    cfg = TC.get("xlstm-1.3b").smoke().scaled(max_seq_len=16)
    pool = CachePool(cfg, 2, device="cpu")
    req = _fill(pool, np.random.default_rng(10))
    pool.admit(1, req, 4, 8)
    got = pool.read_slot(1)
    assert all(torch.equal(got[li][k], req[li][k])
               for li, c in req.items() for k in c)
    assert pool.kv_reserved_bytes == 0
    pool.evict(1)
    assert not any(v.any() for c in pool.read_slot(1).values()
                   for v in c.values())


def test_cache_specs_match_reference():
    """KV only on the attention kinds, the recurrent leaves slot-indexed,
    contiguous and paged, full width: xlstm's state at batch 4 is
    2,821,721,472 B."""
    for name in NAMES:
        cfg_t, cfg_r = TC.get(name), RC.get(name)
        for got, want in ((TM.cache_specs(cfg_t, 4, 64),
                           RM.cache_specs(cfg_r, 4, 64)),
                          (TM.paged_cache_specs(cfg_t, 4, 64, 9, 16),
                           RM.paged_cache_specs(cfg_r, 4, 64, 9, 16))):
            assert set(got) == set(want)
            for i, c in want.items():
                assert {k: (tuple(s.shape), str(s.dtype)) for k, s in
                        c.items()} == {k: (tuple(shape), str(dt).replace(
                            "torch.", "")) for k, (shape, dt) in
                            got[i].items()}
    specs = TM.cache_specs(TC.get("xlstm-1.3b"), 4, 64)
    nbytes = sum(int(np.prod(shape)) * 4 for c in specs.values()
                 for shape, _ in c.values())
    assert nbytes == 2_821_721_472


@pytest.mark.parametrize("what", ["prompt_bucket", "prefix_cache",
                                  "prefill_chunk", "packed_prefill",
                                  "speculative"])
def test_scheduler_refuses_what_recurrence_breaks(model, what):
    """Each ``ValueError`` the reference raises for a recurrent stack,
    with its message."""
    cfg_r, cfg_t, pr, pt = model
    kw = {"prompt_bucket": 8, "prefix_cache": True, "prefill_chunk": 16,
          "packed_prefill": True, "speculative": True}
    scfg = {"prompt_bucket": 1, what: kw[what]}
    with pytest.raises(ValueError) as want:
        RScheduler(pr, cfg_r, RServingConfig(**scfg))
    with pytest.raises(ValueError) as got:
        Scheduler(pt, cfg_t, ServingConfig(**scfg), device="cpu")
    assert str(got.value) == str(want.value)
    assert "SSM/xLSTM" in str(got.value)


def test_serve_cli_serves_recurrent_configs_unbucketed(capsys):
    """The CLI buckets a recurrent config at 1 (the scheduler refuses
    any other bucket) and a dense one as before."""
    seen = []
    real = serve_cli.serve_trace

    def record(*a, prompt_bucket, **kw):
        seen.append(prompt_bucket)
        return real(*a, prompt_bucket=prompt_bucket, **kw)

    with mock.patch.object(serve_cli, "serve_trace", record):
        for arch in NAMES + ("qwen1.5-0.5b",):
            results = serve_cli.main([
                "--arch", arch, "--smoke", "--device", "cpu", "--pim-mode",
                "quant", "--paged", "--requests", "2", "--batch", "2",
                "--prompt-lens", "5,9", "--max-new-tokens", "3"])
            assert all(len(t) == 3 for t in results.values())
    assert seen == [1, 1, 8]
    assert "served 2/2 requests" in capsys.readouterr().out


def test_train_cli_ssm_preset():
    """``build_cfg``'s SSM branch: the preset's KV heads follow its
    heads, as in the reference's."""
    for arch in NAMES:
        args = type("A", (), dict(arch=arch, smoke=False, preset="tiny",
                                  layers=None))
        got, want = train_cli.build_cfg(args), r_train_cli.build_cfg(args)
        for f in ("n_heads", "n_kv_heads", "n_layers", "d_model",
                  "n_experts", "top_k", "moe_d_ff", "pattern"):
            assert getattr(got, f) == getattr(want, f), (arch, f)
    xcfg = train_cli.build_cfg(type("A", (), dict(
        arch="xlstm-1.3b", smoke=False, preset="tiny", layers=None)))
    assert xcfg.n_kv_heads == xcfg.n_heads == 4
