"""The MoE block (``repro_torch.models.moe``, the ``"ae"`` and ``"ar"``
blocks of ``models/model.py``) against ``repro.models.moe`` and
``repro.models.model_lib`` on the smoke configs of granite-moe-1b-a400m
and arctic-480b (float32), the reference's weights imported by
``from_reference``; the port runs on the CPU, i.e. on the kernels' plain
versions.

Exact: the capacity, the top-k expert ids (ties to the lower index), which
(token, expert) pairs are dropped, the trash slot's last-writer rule, every
integer GEMM of the path, served tokens.  Float tolerances, for the same
float32 math in other reduction orders: ``moe_ffn`` outputs within
``MOE_TOL`` = 1e-5 (observed about 1e-7), bf16 outputs within
``MOE_BF16_TOL`` = 2**-6 relative to the largest entry (a few bf16 ulps:
the expert products round to bf16 in both), logits within ``LOGIT_TOL``
= 1e-4 as in tests/test_torch_model.py, losses within ``LOSS_TOL`` =
1e-5 and each gradient leaf within ``GRAD_TOL`` = 2e-5 of its largest
reference entry, as in tests/test_torch_train.py.
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
from repro.models import model_lib as RM
from repro.models import moe as r_moe
from repro.pim import engine as r_engine
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model_lib as TM
from repro_torch.models import moe as t_moe
from repro_torch.pim import engine
from repro_torch.serving import Scheduler, ServingConfig

MOE_TOL = 1e-5
MOE_BF16_TOL = 2.0 ** -6
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
NAMES = ("granite-moe-1b-a400m", "arctic-480b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke(name, **kw):
    return RC.get(name).smoke().scaled(**kw), TC.get(name).smoke().scaled(**kw)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    cfg_r, cfg_t = _smoke(request.param, max_seq_len=40)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(5))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    return cfg_r, cfg_t, pr, pt


def _layer(params, layer=0):
    return {k: v[layer] for k, v in params["blocks"]["0"].items()}


def _ref_moe(x, p, cfg):
    keep = ("router", "w1", "w2", "w3")
    return np.asarray(r_moe.moe_ffn(
        jnp.asarray(x), {k: jnp.asarray(np.asarray(p[k])) for k in keep},
        cfg))


def _port_moe(x, p, cfg):
    keep = ("router", "w1", "w2", "w3")
    return t_moe.moe_ffn(TM._from_numpy(np.asarray(x)),
                         {k: TM._from_numpy(np.asarray(p[k])) for k in keep},
                         cfg)


def _routes(x2d, router, k):
    """The reference's routing of (T, d) tokens: (weights, ids)."""
    logits = jnp.asarray(x2d, jnp.float32) @ jnp.asarray(router, jnp.float32)
    w, ids = jax.lax.top_k(logits, k)
    return np.asarray(jax.nn.softmax(w, axis=-1)), np.asarray(ids)


@pytest.mark.parametrize("tokens", [(2, 9), (3, 40)])
def test_moe_ffn_matches_reference(model, tokens):
    """Random tokens through one layer's experts: the same expert ids,
    weights and outputs (at 120 tokens the capacity is below the
    hits, so tokens drop)."""
    cfg_r, cfg_t, pr, _ = model
    p = _layer(_np_tree(pr))
    x = np.random.default_rng(1).standard_normal(
        tokens + (cfg_t.d_model,), dtype=np.float32)
    want = _ref_moe(x, p, cfg_r)
    got = _port_moe(x, p, cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_TOL)
    w, ids = _routes(x.reshape(-1, cfg_t.d_model), p["router"], cfg_t.top_k)
    tw, tids = t_moe.router_top_k(torch.from_numpy(x.reshape(
        -1, cfg_t.d_model)), torch.from_numpy(p["router"]), cfg_t.top_k)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_allclose(tw.numpy(), w, rtol=0, atol=1e-6)


def test_moe_ffn_bf16_matches_reference(model):
    cfg_r, cfg_t, pr, _ = model
    cfg_r, cfg_t = (c.scaled(dtype="bfloat16") for c in (cfg_r, cfg_t))
    p = _layer(_np_tree(pr))
    p = {k: (v.astype(jnp.bfloat16) if k in ("w1", "w2", "w3") else v)
         for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg_t.d_model), dtype=np.float32).astype(jnp.bfloat16)
    want = _ref_moe(x, p, cfg_r).astype(np.float32)
    got = _port_moe(x, p, cfg_t)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=MOE_BF16_TOL * scale)


def _zero_router_case(cfg):
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": np.zeros((d, e), np.float32),
         "w1": rng.standard_normal((e, d, f), dtype=np.float32) / 8,
         "w2": rng.standard_normal((e, f, d), dtype=np.float32) / 8,
         "w3": rng.standard_normal((e, d, f), dtype=np.float32) / 8}
    return p, rng.standard_normal((1, 32, d), dtype=np.float32)


def test_zero_router_overflow_keeps_the_last_token():
    """Every logit ties at 0, so all 32 tokens pick experts 0 and 1
    (capacity 20): tokens 0-19 are served, 20-30 dropped by both experts,
    and token 31 kept through the trash slot, whose last writer it is."""
    cfg_r, cfg_t = _smoke("granite-moe-1b-a400m")
    p, x = _zero_router_case(cfg_t)
    assert t_moe.expert_capacity(32, 2, cfg_t.capacity_factor, 4) == 20
    want = _ref_moe(x, p, cfg_r)[0]
    got = _port_moe(x, p, cfg_t).numpy()[0]
    kept = np.abs(want).sum(-1) > 0
    np.testing.assert_array_equal(np.nonzero(kept)[0],
                                  list(range(20)) + [31])
    np.testing.assert_array_equal(np.abs(got).sum(-1) > 0, kept)
    np.testing.assert_allclose(got, want, rtol=0, atol=MOE_TOL)
    assert np.abs(got[31] - want[31]).max() <= MOE_TOL


def test_trash_slot_rule_against_a_host_recomputation():
    """The slot map of every expert, recomputed in Python from the
    routing: real slots in token order up to the capacity, the trash slot
    holding the largest token index sent there; each token's output is
    the sum over the experts that served it (the trash winner counted
    when it was routed there)."""
    cfg = TC.get("granite-moe-1b-a400m").smoke()
    rng = np.random.default_rng(3)
    d, e = cfg.d_model, cfg.n_experts
    # a shared direction plus noise: most tokens agree, experts overflow
    x = (rng.standard_normal(d) + 0.3 * rng.standard_normal((37, d))
         ).astype(np.float32)
    p = {"router": rng.standard_normal((d, e), dtype=np.float32),
         "w1": rng.standard_normal((e, d, 8), dtype=np.float32) / 8,
         "w2": rng.standard_normal((e, 8, d), dtype=np.float32) / 8,
         "w3": rng.standard_normal((e, d, 8), dtype=np.float32) / 8}
    xt = torch.from_numpy(x)
    tw, tids = t_moe.router_top_k(xt, torch.from_numpy(p["router"]), 2)
    cap = t_moe.expert_capacity(37, 2, cfg.capacity_factor, e)
    got = t_moe.moe_ffn(xt[None], {k: torch.from_numpy(v)
                                   for k, v in p.items()}, cfg)[0]
    want = torch.zeros((37, d))
    drops = set()
    for ex in range(e):
        hits = [i for i in range(37) if ex in tids[i].tolist()]
        served = hits[:cap]
        trash = [i for i in range(37) if i not in served]
        winner = max(trash) if trash else None
        if winner is not None and winner in hits:
            served = served + [winner]
        drops |= {(i, ex) for i in hits if i not in served}
        for i in served:
            w = float(tw[i][tids[i] == ex][0])
            hx = xt[i] @ torch.from_numpy(p["w1"][ex])
            hx = torch.nn.functional.silu(hx) * (
                xt[i] @ torch.from_numpy(p["w3"][ex]))
            want[i] += w * (hx @ torch.from_numpy(p["w2"][ex]))
    assert drops, "the case must overflow some expert"
    torch.testing.assert_close(got, want, rtol=0, atol=MOE_TOL)


def test_chip_smoke_reads_the_served_pairs_from_the_dispatch():
    """``chip_smoke.served_from_rows``, the on-card check of the grouped
    dispatch, reads the (token, expert) pairs from the rows that
    ``_local_moe`` gathers back: on overflowing routes (the dispatch at
    two expert offsets, as under a mesh) they equal the host rule of
    ``chip_smoke.moe_routes_on_host``, and a row read back from another
    token's slot or a dropped read-back is caught."""
    import chip_smoke

    rng = np.random.default_rng(5)
    t, k, e = 37, 2, 8
    # most tokens pick experts 0-2, so those overflow
    ids = np.stack([rng.permutation(np.r_[rng.choice(3, 1), 3 + rng.choice(
        5, 1)] if i % 4 else rng.choice(3, 2, replace=False))[:k]
        for i in range(t)])
    cap = t_moe.expert_capacity(t, k, 1.25, e)
    top_ids = torch.from_numpy(ids)
    want, dropped, last = chip_smoke.moe_routes_on_host(ids, t, cap, e)
    assert dropped
    halves = [t_moe._dispatch(top_ids, cap, e // 2, b) + (e // 2, b)
              for b in (0, e // 2)]
    got, wrong = chip_smoke.served_from_rows(halves, ids.tolist(), t)
    assert (got, wrong) == (want, [])

    tok_of_slot, rows, order, n_e, b = halves[0]
    i, j = map(int, np.argwhere(rows.numpy() < n_e * (cap + 1))[0])
    moved = rows.clone()
    moved[i, j] = (moved[i, j] + 1) % (n_e * (cap + 1))
    _, wrong = chip_smoke.served_from_rows(
        [(tok_of_slot, moved, order, n_e, b)], ids.tolist(), t)
    assert wrong
    lost = rows.clone()
    lost[i, j] = n_e * (cap + 1)
    got, wrong = chip_smoke.served_from_rows(
        [(tok_of_slot, lost, order, n_e, b), halves[1]], ids.tolist(), t)
    assert got == want - {(i, int(ids[i, order[i, j]]))} and not wrong


def test_top_k_tie_order_is_the_reference():
    """Exact ties (duplicated router columns, zero tokens) resolve to the
    lower expert index in both packages."""
    rng = np.random.default_rng(4)
    col = rng.standard_normal((16, 1), dtype=np.float32)
    other = rng.standard_normal((16, 1), dtype=np.float32)
    router = np.concatenate([other, col, col, other, col, other], axis=1)
    x = rng.standard_normal((20, 16), dtype=np.float32)
    x[:3] = 0.0                          # every logit ties at 0
    for k in (1, 2, 3, 4):
        w, ids = _routes(x, router, k)
        tw, tids = t_moe.router_top_k(torch.from_numpy(x),
                                      torch.from_numpy(router), k)
        np.testing.assert_array_equal(tids.numpy(), ids)
        np.testing.assert_allclose(tw.numpy(), w, rtol=0, atol=1e-6)
    assert tids[0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("k,cf,e", [(8, 1.25, 32), (2, 1.25, 128),
                                    (2, 1.25, 4), (2, 1.0, 8),
                                    (3, 0.7, 5)])
def test_expert_capacity_matches_reference(k, cf, e):
    """``_cap`` for T = 1-300: the capacity the reference hands its
    expert loop, read through a stand-in for ``_local_moe`` while the
    reference's ``moe_ffn`` is traced (``jax.eval_shape``: nothing runs)."""
    cfg_r = RC.get("granite-moe-1b-a400m").smoke().scaled(
        d_model=4, n_experts=e, top_k=k, capacity_factor=cf)
    seen = []

    def record(x, *a, capacity, **kw):
        seen.append(capacity)
        return jnp.zeros(x.shape, jnp.float32)

    p = {"router": jnp.zeros((4, e), jnp.float32), "w1": None, "w2": None,
         "w3": None}
    with mock.patch.object(r_moe, "_local_moe", record):
        for t in range(1, 301):
            jax.eval_shape(lambda x: r_moe.moe_ffn(x, p, cfg_r),
                           jax.ShapeDtypeStruct((1, t, 4), jnp.float32))
    assert seen == [t_moe.expert_capacity(t, k, cf, e)
                    for t in range(1, 301)]


def _assert_logits(want, got):
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


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


@pytest.mark.parametrize("mode,router", [
    ("xla", "random"), ("quant", "random"), ("pim_sim", "random"),
    ("xla", "zero"), ("quant", "zero")])
def test_prefill_and_decode_match_reference(model, mode, router):
    """Prefill (2 x 9 tokens; with a zero router 6 of 18 overflow) and one
    decode step; every integer GEMM held to the reference's."""
    cfg_r, cfg_t, pr, pt = model
    if router == "zero":
        pr = jax.tree.map(lambda a: a, pr)
        pr["blocks"]["0"]["router"] = jnp.zeros_like(
            pr["blocks"]["0"]["router"])
        pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(4).integers(0, cfg_r.vocab_size,
                                             (2, 9)).astype(np.int32)
    calls = []
    engine.clear_cache()
    with _recording(mode, calls):
        lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cr)
        lt, cache_t = TM.prefill(pt, {"tokens": torch.from_numpy(toks).long()},
                                 ct)
        _assert_logits(lr, lt)
        nxt = np.asarray(jnp.argmax(lr, -1))[:, None].astype(np.int32)
        _, lr2, _ = RM.decode_step(pr, jnp.asarray(nxt), jnp.int32(9),
                                   cache_r, cr)
        _, lt2, _ = TM.decode_step(pt, torch.from_numpy(nxt).long(), 9,
                                   cache_t, ct)
        _assert_logits(lr2, lt2)
    engine.clear_cache()
    # the four attention projections, and arctic's dense MLP (gated)
    n_lin = 4 + (3 if cfg_t.pattern == ("ar",) else 0)
    if mode != "xla":
        assert len(calls) == 2 * n_lin
        _check_gemms(mode, calls)


def test_from_reference_carries_the_moe_trees(model):
    cfg_r, cfg_t, pr, pt = model
    want = _np_tree(pr)["blocks"]["0"]
    got = pt["blocks"]["0"]
    assert {"norm_moe", "router", "w1", "w2", "w3"} <= set(got)
    assert ("w_in" in got) == (cfg_t.pattern == ("ar",))
    assert set(got) == set(want)
    assert got["router"].dtype == torch.float32
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      want[k].view(np.uint32), err_msg=k)
    ns, e, d, f = (cfg_t.n_super, cfg_t.n_experts, cfg_t.d_model,
                   cfg_t.moe_d_ff)
    assert tuple(got["w1"].shape) == (ns, e, d, f)
    assert tuple(got["w2"].shape) == (ns, e, f, d)
    assert tuple(got["router"].shape) == (ns, d, e)
    assert TM.param_count(cfg_t) == RM.param_count(cfg_r)


# (prompt length, new tokens); pim_sim's trace keeps to one prompt bucket:
# the reference compiles its host interpreter's callback per shape
TRACES = {"quant": ((5, 4), (12, 3), (7, 5), (20, 4)),
          "pim_sim": ((5, 3), (7, 4))}


@pytest.mark.parametrize("mode", ["quant", "pim_sim"])
def test_scheduler_tokens_match_reference(model, mode):
    """The port's ``Scheduler`` serves the reference's tokens at max_batch
    2 (bucketed prefill, the paged pool, one decode shape)."""
    cfg_r, cfg_t, pr, pt = model
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    rng = np.random.default_rng(3)
    trace = [(rng.integers(1, ct.vocab_size, p), n) for p, n in TRACES[mode]]
    kw = dict(max_batch=2, prompt_bucket=8, paged=True, block_size=4)
    engine.clear_cache()
    sched = Scheduler(pt, ct, ServingConfig(**kw), clock=time.monotonic,
                      device="cpu")
    rids = [sched.submit(p, n) for p, n in trace]
    out = sched.run()
    got = [out[r].tolist() for r in rids]
    rs = RScheduler(pr, cr, RServingConfig(**kw))
    rrids = [rs.submit(p, n) for p, n in trace]
    rout = rs.run()
    want = [rout[r].tolist() for r in rrids]
    engine.clear_cache()
    assert got == want
    assert sched.decode_traces == 1 == rs.decode_traces
    assert [len(t) for t in got] == [n for _, n in trace]


@pytest.mark.parametrize("what", ["prefix_cache", "prefill_chunk",
                                  "packed_prefill", "speculative"])
def test_scheduler_refuses_what_moe_breaks(model, what):
    _, cfg_t, _, pt = model
    kw = {"prefix_cache": True, "prefill_chunk": 16,
          "packed_prefill": True, "speculative": True}
    with pytest.raises(ValueError, match="MoE"):
        Scheduler(pt, cfg_t, ServingConfig(**{what: kw[what]}),
                  device="cpu")


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_decode_run_slots_matches_reference(mode):
    """A (2, 3) multi-position decode step over the paged pool routes its
    6 rows together, as the reference's does."""
    cfg_r, cfg_t = _smoke("granite-moe-1b-a400m", max_seq_len=24,
                          pim_mode=mode)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(6))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    b, k, bs = 2, 3, 4
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg_t.vocab_size, (b, k))
    pos = np.array([5, 9])
    bps = cfg_t.max_seq_len // bs
    specs = TM.paged_cache_specs(cfg_t, b, cfg_t.max_seq_len, b * bps + 1,
                                 bs)
    tables = np.arange(1, b * bps + 1).reshape(b, bps)
    caches = {i: {key: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dt) for key, (shape, dt) in c.items()}
        for i, c in specs.items()}
    ref_caches = {i: {key: jnp.asarray(v.numpy()) for key, v in c.items()}
                  for i, c in caches.items()}
    active = np.array([True, True])
    vt, logits, _ = TM.decode_run_slots(
        pt, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(active), caches, cfg_t,
        block_tables=torch.from_numpy(tables))
    rvt, rlogits, _ = RM.decode_run_slots(
        pr, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), ref_caches, cfg_r,
        block_tables=jnp.asarray(tables, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(rvt))


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_loss_and_grads_match_reference(mode):
    """``loss_fn`` and its gradients on granite-moe smoke (2 x 16 tokens:
    the capacity of 20 drops tokens of the busiest experts) against
    ``jax.value_and_grad`` of the reference's, remat on and off."""
    cfg_r, cfg_t = _smoke("granite-moe-1b-a400m", pim_mode=mode)
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(7))
    toks = np.random.default_rng(8).integers(0, cfg_r.vocab_size, (2, 17))
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
        assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
        got = dict(zip([k for k, _ in _flat(params)], grads))
        assert set(got) == set(want)
        for k, g in got.items():
            w = want[k]
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=k)
            if mode == "quant" and k.split("/")[-1] in ("wq", "wk", "wv",
                                                         "wo"):
                np.testing.assert_array_equal(g.numpy() != 0, w != 0,
                                              err_msg=k)
        assert float(got["blocks/0/router"].abs().max()) > 0


def test_train_cli_moe_preset():
    ap = type("A", (), dict(arch="granite-moe-1b-a400m", smoke=False,
                            preset="tiny", layers=None))
    cfg = train_cli.build_cfg(ap)
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.d_model) == \
        (8, 2, 32, 64)
    losses = train_cli.main(["--arch", "granite-moe-1b-a400m", "--preset",
                             "tiny", "--device", "cpu", "--steps", "1",
                             "--batch", "2", "--seq", "8"])
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("mode", ["quant", "pim_sim"])
def test_serve_cli_moe_smoke(capsys, mode):
    results = serve_cli.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                              "--device", "cpu", "--pim-mode", mode,
                              "--paged", "--requests", "2", "--batch", "2",
                              "--prompt-lens", "5,9",
                              "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "1 decode shapes" in out
    assert all(len(t) == 3 for t in results.values())
    engine.clear_cache()


def test_tf32_refused_on_a_card():
    """Routing needs a true float32 product: on a CUDA tensor with TF32
    on, ``router_top_k`` raises instead of rounding the operands."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        # a CPU tensor: TF32 does not apply
        _, ids = t_moe.router_top_k(torch.zeros((2, 4)), torch.zeros((4, 3)),
                                    2)
        assert ids.tolist() == [[0, 1], [0, 1]]
        fake = mock.MagicMock(spec=torch.Tensor, is_cuda=True)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            t_moe.router_top_k(fake, None, 2)
    finally:
        flags.allow_tf32 = old
