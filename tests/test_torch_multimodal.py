"""The encoder-decoder and cross-attention path (``attention.
cross_attention``, the ``"adx"`` and ``"enc"`` blocks, ``_encode`` and
``_memory`` of ``models/model.py``, the seamless-m4t-medium and
llama-3.2-vision-11b configs) against ``repro`` on their smoke configs
(float32; seamless: one ``"adx"`` layer over 2 ``"enc"`` layers, d 64;
vision: 5 layers ``ad ad ad adx ad``, vision_dim 24, 9 patches), the
reference's weights imported by ``from_reference``; the port runs on the
CPU, i.e. on the kernels' plain versions.  Cross-attention is an einsum in
the reference and reaches no Pallas kernel; its ``pim_sim`` linears run
its host interpreter, so the ``pim_sim`` cases keep to the seamless model.
The vision model's ``pim_sim`` prefill and decode step run in the port
alone (the reference's model would run every GEMM through that
interpreter a second time, doubling the case's several minutes), with the
launch budget (``engine.MAX_LAUNCH_BYTES``) cut to ``SPLIT_CROSSBARS``
crossbars so that its ``xwk``/``xwv`` over the patches run as several
launches, as the full-width model's do: each GEMM is held to the
reference's ``matmul_int``, the logits to the same run on the exact
integer product, the launches to the pieces ``engine.launch_pieces``
reckons for the recorded GEMMs.

Exact: every integer GEMM of the path (each ``quant`` int32 accumulator
equal to the reference's Pallas kernel in interpret mode, each
``pim_sim`` product to the reference's crossbar GEMM through its numpy
interpreter), imported weights, the ``xk``/``xv`` leaves across decode,
a multi-position step against single steps, greedy tokens, cache specs,
the stubs' batches and the refusal messages.  Float tolerances, for the
same float32 math in other reduction orders: one ``cross_attention``
within ``XATTN_TOL`` = 1e-6 absolute (its inputs are of unit scale);
the memory (encoder output or patch projection) within ``MEMORY_TOL`` =
1e-5 of its largest entry; logits within ``LOGIT_TOL`` = 1e-4 absolute as
in tests/test_torch_model.py, the ``xk``/``xv`` leaves within the same
relative 1e-5 as the memory they come from; losses within ``LOSS_TOL`` =
1e-5 and each gradient leaf within ``GRAD_TOL`` = 2e-5 of its largest
reference entry, as in tests/test_torch_train.py; decode == forward
within the reference test's ``rtol=atol=2e-3``
(tests/test_lm_correctness.py::test_decode_matches_forward).
"""
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.data import pipeline as r_pipeline
from repro.kernels.quant_matmul import quant_matmul_int as r_qmm
from repro.launch import train as r_train_cli
from repro.models import attention as r_attn
from repro.models import model_lib as RM
from repro.pim import engine as r_engine
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as t_attn
from repro_torch.models import model_lib as TM
from repro_torch.pim import engine
from repro_torch.serving import Scheduler, ServingConfig

XATTN_TOL = 1e-6
MEMORY_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
SEAMLESS, VISION = "seamless-m4t-medium", "llama-3.2-vision-11b"
NAMES = (SEAMLESS, VISION)
# frames of a seamless request in these tests (any length works; the
# cache specs size it seq_len // audio_frames_div)
FRAMES = 6
# prompt length of the prefill cases
PLEN = 7
# crossbars a launch may hold in the vision model's pim_sim case: its xwk
# (18 patch rows x 32 outputs, 2 chunks of 3 crossbars) runs as 2 launches
SPLIT_CROSSBARS = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return TM._from_numpy(np.asarray(a))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _pair(name, seed=21):
    """(reference config, port config, reference params, port params) of
    ``name``'s smoke model; the port's imported from the reference's."""
    cfg_r, cfg_t = RC.get(name).smoke(), TC.get(name).smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(seed))
    pt = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
    return cfg_r, cfg_t, pr, pt


@pytest.fixture(params=NAMES)
def model(request):
    return _pair(request.param)


def _media(cfg, b, seed, frames=FRAMES):
    """The memory input of ``b`` requests: ``{"frames": ...}`` or
    ``{"patches": ...}``, seeded numpy."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal(
            (b, frames, cfg.d_model), dtype=np.float32)}
    return {"patches": rng.standard_normal(
        (b, cfg.n_patches, cfg.vision_dim), dtype=np.float32)}


def _batches(cfg, toks, media):
    br = {"tokens": jnp.asarray(toks, jnp.int32)}
    bt = {"tokens": torch.from_numpy(np.asarray(toks)).long()}
    for k, v in media.items():
        br[k], bt[k] = jnp.asarray(v), torch.from_numpy(v)
    return br, bt


# --------------------------------------------------------------------------
# cross_attention and the memory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(hkv, sq):
    rng = np.random.default_rng(hkv * 10 + sq)
    q = rng.standard_normal((2, sq, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 9, hkv, 16), dtype=np.float32)
    v = rng.standard_normal((2, 9, hkv, 16), dtype=np.float32)
    want = r_attn.cross_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    got = t_attn.cross_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=XATTN_TOL)


def test_cross_attention_casts_as_the_reference():
    """bf16 operands: the softmax is cast to ``v``'s dtype before the
    float32 weighted sum, and the result to ``q``'s dtype."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((1, 3, 4, 16), (1, 7, 2, 16), (1, 7, 2, 16)))
    want = np.asarray(r_attn.cross_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16)).astype(jnp.float32))
    got = t_attn.cross_attention(*(_t(a).to(torch.bfloat16)
                                   for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the largest output
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_memory_matches_reference(model):
    """The encoder over 2 x 6 frames (non-causal, no RoPE, ``enc_norm``)
    or the vision projection of 2 x 9 patches."""
    cfg_r, cfg_t, pr, pt = model
    media = _media(cfg_t, 2, 1)
    br, bt = _batches(cfg_t, np.zeros((2, 1)), media)
    want = RM._memory(pr, br, cfg_r)
    got = TM._memory(pt, bt, cfg_t)
    _close(got, want, MEMORY_TOL, "memory")
    if cfg_t.is_encoder_decoder:
        # non-causal: the first frame's output depends on the last frame
        f2 = dict(media)
        f2["frames"] = media["frames"].copy()
        f2["frames"][:, -1] += 1.0
        got2 = TM._memory(pt, _batches(cfg_t, np.zeros((2, 1)), f2)[1],
                          cfg_t)
        assert not torch.equal(got[:, 0], got2[:, 0])


def test_encoder_blocks_attend_without_rope_or_mask():
    """An ``"enc"`` block equals the reference's ``apply_block("enc")``
    (train mode) at shifted positions: no RoPE, so positions do not
    matter."""
    cfg_r, cfg_t = RC.get(SEAMLESS).smoke(), TC.get(SEAMLESS).smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(2))
    p = {k: np.asarray(v[0]) for k, v in pr["encoder"]["blocks"]["0"].items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 64), dtype=np.float32)
    want, _ = RM.apply_block("enc", jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()},
                             cfg_r, positions=jnp.arange(5), mode="train")
    pt = {k: _t(v) for k, v in p.items()}
    for off in (0, 11):
        got, c = TM.apply_block("enc", _t(x), pt, cfg_t,
                                positions=off + torch.arange(5),
                                mode="train")
        assert c is None
        _close(got, want, MEMORY_TOL, f"offset {off}")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def test_from_reference_carries_the_encoder_and_vision_trees(model):
    cfg_r, cfg_t, pr, pt = model
    want = _np_tree(pr)
    extra = "encoder" if cfg_t.is_encoder_decoder else "vision_proj"
    assert extra in pt and (("encoder" in pt) != ("vision_proj" in pt))
    got = dict(TM._leaves(pt))
    ref = {path: leaf for path, leaf in TM._leaves(want)}
    assert set(got) == set(ref)
    for path, v in got.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      ref[path].view(np.uint32),
                                      err_msg="/".join(path))
    assert TM.param_count(cfg_t) == RM.param_count(cfg_r)
    if cfg_t.is_encoder_decoder:
        enc = pt["encoder"]["blocks"]["0"]
        assert enc["wq"].shape == (2, 64, 64) and "xwq" not in enc
        assert "xwk" in pt["blocks"]["0"]
    else:
        assert pt["vision_proj"].shape == (24, 64)


def test_init_params_draws_the_new_leaves_on_the_device():
    """``init_params`` draws the encoder, cross-attention and vision leaves
    like every other (one generator per random leaf, in sorted-path
    order): the seed decides them, and ones/zeros leaves are exact."""
    for name in NAMES:
        cfg = TC.get(name).smoke()
        specs = dict(TM._leaves(TM.param_specs(cfg)))
        a = dict(TM._leaves(TM.init_params(cfg, 3, "cpu")))
        b = dict(TM._leaves(TM.init_params(cfg, 3, "cpu")))
        c = dict(TM._leaves(TM.init_params(cfg, 4, "cpu")))
        assert set(a) == set(specs)
        for path, (shape, dt, init, _) in specs.items():
            assert tuple(a[path].shape) == shape and a[path].dtype == dt
            assert torch.equal(a[path], b[path]), path
            if init == "ones":
                assert bool((a[path] == 1).all()), path
            elif init == "normal":
                assert not torch.equal(a[path], c[path]), path
        new = [p for p in specs if p[0] in ("encoder", "vision_proj")
               or p[-1].startswith("xw")]
        assert len(new) >= 4


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------

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


def _linears(cfg, prefill: bool):
    """Linears of one prefill or one decode step: 7 per ``"ad"``/
    ``"enc"`` layer; an ``"adx"`` layer adds ``xwq``/``xwo`` and, in
    prefill, ``xwk``/``xwv``."""
    per = {"ad": 7, "adx": 11 if prefill else 9}
    n = sum(per[k] for k in cfg.pattern) * cfg.n_super
    return n + (7 * cfg.n_encoder_layers if prefill else 0)


def _pieces(x, w, bits):
    """Launches of one ``engine.matmul_int`` call on (M, K) x (O, K)
    uint8 operands by the engine's rule: 37-term chunks, 256 rows a
    crossbar, pieces under ``engine.MAX_LAUNCH_BYTES``."""
    (m, k), o = x.shape, w.shape[0]
    art = engine.compile_matmul(min(k, 37), bits)
    per = engine.launch_bytes(art.n_cols, art.n_terms, len(art.acc_cols))
    return len(engine.launch_pieces(-(-k // 37), -(-m * o // 256), per))


@contextlib.contextmanager
def _split_launches(calls, memory_rows):
    """Cut the launch budget to ``SPLIT_CROSSBARS`` crossbars and count the
    crossbar launches; on exit, hold them to the pieces of the GEMMs
    recorded in ``calls`` and require that ``xwk``/``xwv`` (the GEMMs on
    the ``memory_rows`` rows of the memory) split."""
    from repro_torch.kernels import crossbar_exec as xb

    art = engine.compile_matmul(37, 8)
    budget = SPLIT_CROSSBARS * engine.launch_bytes(
        art.n_cols, art.n_terms, len(art.acc_cols))
    real, launches = xb.crossbar_exec, []

    def count(state, mc):
        launches.append(state.shape[0])
        return real(state, mc)

    with mock.patch.object(engine, "MAX_LAUNCH_BYTES", budget), \
            mock.patch.object(xb, "crossbar_exec", count):
        yield
        pieces = [_pieces(x, w, bits) for x, w, _, bits in calls]
    assert len(launches) == sum(pieces)
    assert max(launches) <= SPLIT_CROSSBARS
    xkv = [n for (x, *_), n in zip(calls, pieces) if len(x) == memory_rows]
    assert len(xkv) == 2 and min(xkv) > 1


def _xattn(tree):
    return {(i, k): v.clone() for i, c in tree.items() for k, v in c.items()
            if k in ("xk", "xv")}


CASES = [(SEAMLESS, "xla"), (SEAMLESS, "quant"), (SEAMLESS, "pim_sim"),
         (VISION, "xla"), (VISION, "quant")]


@pytest.mark.parametrize("name,mode", CASES)
def test_prefill_and_decode_match_reference(name, mode):
    """Prefill of 2 x 7 tokens with the request's memory, one
    ``decode_step`` (but in ``pim_sim``, whose reference runs its host
    interpreter) and one ``decode_step_slots`` (slot 1 inactive): the
    logits, the ``xk``/``xv`` leaves (left unchanged by both decode steps)
    and every integer GEMM held to the reference's."""
    cfg_r, cfg_t, pr, pt = _pair(name)
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(4).integers(0, cfg_r.vocab_size,
                                             (2, PLEN)).astype(np.int32)
    br, bt = _batches(cfg_t, toks, _media(cfg_t, 2, 4))
    calls = []
    engine.clear_cache()
    with _recording(mode, calls):
        lr, cache_r = RM.prefill(pr, br, cr)
        lt, cache_t = TM.prefill(pt, bt, ct)
        _assert_logits(lr, lt)
        n_prefill = len(calls)
        xa = _xattn(cache_t)
        assert len(xa) == 2
        for (i, key), leaf in xa.items():
            assert leaf.dtype == ct.compute_dtype
            rows = FRAMES if ct.is_encoder_decoder else ct.n_patches
            assert leaf.shape == (ct.n_super, 2, rows, ct.n_kv_heads, ct.hd)
            _close(leaf, cache_r[i][key], MEMORY_TOL, f"{i}/{key}")
        slots_t = {i: {k: v.clone() for k, v in c.items()}
                   for i, c in cache_t.items()}
        nxt = np.asarray(jnp.argmax(lr, -1))[:, None].astype(np.int32)
        pos = np.array([PLEN, PLEN], np.int32)
        active = np.array([True, False])
        tr, lr3, _ = RM.decode_step_slots(
            pr, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(active),
            cache_r, cr)
        if mode != "pim_sim":
            _, lr2, _ = RM.decode_step(pr, jnp.asarray(nxt),
                                       jnp.int32(PLEN), cache_r, cr)
            _, lt2, cache_t = TM.decode_step(
                pt, torch.from_numpy(nxt).long(), PLEN, cache_t, ct)
            _assert_logits(lr2, lt2)
        tt, lt3, slots_t = TM.decode_step_slots(
            pt, torch.from_numpy(nxt).long(), torch.from_numpy(pos),
            torch.from_numpy(active), slots_t, ct)
        _assert_logits(lr3, lt3)
        assert tt.tolist() == np.asarray(tr).tolist()
    engine.clear_cache()
    for tree in (cache_t, slots_t):
        after = _xattn(tree)
        assert all(torch.equal(after[k], xa[k]) for k in xa)
    if mode != "xla":
        assert n_prefill == _linears(ct, True)
        steps = 1 if mode == "pim_sim" else 2
        assert len(calls) - n_prefill == steps * _linears(ct, False)
        _check_gemms(mode, calls)


def test_vision_pim_sim_holds_every_gemm_to_the_reference():
    """The vision model in ``pim_sim`` with its ``xwk``/``xwv`` split
    into several launches: a prefill of 2 x 7 tokens with 9 patches each
    and one ``decode_step_slots`` (slot 1 inactive).  Every integer GEMM
    equals the reference's ``matmul_int``, the launches equal their
    pieces, and the logits and tokens equal, bit for bit, those of the
    same steps on the exact integer product."""
    _, cfg_t, _, pt = _pair(VISION)
    ct = cfg_t.scaled(pim_mode="pim_sim")
    toks = np.random.default_rng(4).integers(0, ct.vocab_size, (2, PLEN))
    _, bt = _batches(cfg_t, toks, _media(cfg_t, 2, 4))
    pos = torch.tensor([PLEN, PLEN])
    active = torch.tensor([True, False])

    def steps():
        logits, cache = TM.prefill(pt, bt, ct)
        tok, logits2, _ = TM.decode_step_slots(
            pt, logits.argmax(-1)[:, None], pos, active, cache, ct)
        return logits, tok, logits2

    def exact(x, w, n_bits=8, **kw):
        return (x.double() @ w.double().T).long()

    calls = []
    engine.clear_cache()
    with _split_launches(calls, 2 * ct.n_patches), \
            _recording("pim_sim", calls):
        got = steps()
    with mock.patch.object(engine, "matmul_int", exact):
        want = steps()
    engine.clear_cache()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(calls) == _linears(ct, True) + _linears(ct, False)
    _check_gemms("pim_sim", calls)


def _noise_caches(specs, rng):
    fill = rng.normal(size=(1 << 16,)).astype(np.float32)
    out = {}
    for i, c in specs.items():
        out[i] = {}
        for key, (shape, dt) in c.items():
            n = int(np.prod(shape))
            out[i][key] = torch.from_numpy(
                np.resize(fill, n).reshape(shape)).to(dt)
    return out


RUN_CASES = [(SEAMLESS, "xla", False), (SEAMLESS, "quant", True),
             (SEAMLESS, "pim_sim", False), (VISION, "xla", True),
             (VISION, "quant", False)]


@pytest.mark.parametrize("name,mode,paged", RUN_CASES)
def test_decode_run_slots_equals_single_steps(name, mode, paged):
    """One (2, 2) ``decode_run_slots`` gives, per position, the bits of
    two ``decode_step_slots`` fed the same tokens (logits, tokens and
    every cache leaf, ``xk``/``xv`` untouched), contiguous or paged, and
    matches the reference's ``decode_run_slots``."""
    cfg_r, cfg_t, pr, pt = _pair(name, 22)
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    b, k, bs = 2, 2, 4
    rng = np.random.default_rng(6)
    toks = rng.integers(1, ct.vocab_size, (b, k))
    pos = np.array([5, 9])
    active = np.array([True, True])
    seq = ct.max_seq_len
    if paged:
        bps = seq // bs
        specs = TM.paged_cache_specs(ct, b, seq, b * bps + 1, bs)
        tables = np.arange(1, b * bps + 1).reshape(b, bps)
    else:
        specs = TM.cache_specs(ct, b, seq)
        tables = None
    run_caches = _noise_caches(specs, np.random.default_rng(7))
    step_caches = _noise_caches(specs, np.random.default_rng(7))
    ref_caches = {i: {key: jnp.asarray(v.numpy()) for key, v in c.items()}
                  for i, c in run_caches.items()}
    xa = _xattn(run_caches)

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))

    engine.clear_cache()
    vt, logits, _ = TM.decode_run_slots(pt, t(toks), t(pos), t(active),
                                        run_caches, ct,
                                        block_tables=t(tables))
    for i in range(k):
        tok, lg, _ = TM.decode_step_slots(
            pt, t(toks[:, i:i + 1]), t(pos + i), t(active), step_caches, ct,
            block_tables=t(tables))
        assert torch.equal(lg, logits[:, i]), f"position {i}"
        assert torch.equal(tok[:, 0], vt[:, i])
    for i, c in run_caches.items():
        for key, leaf in c.items():
            assert torch.equal(leaf, step_caches[i][key]), key
    assert all(torch.equal(_xattn(run_caches)[key], xa[key]) for key in xa)
    rvt, rlogits, _ = RM.decode_run_slots(
        pr, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), ref_caches, cr,
        block_tables=None if tables is None
        else jnp.asarray(tables, jnp.int32))
    engine.clear_cache()
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(rvt))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """The reference's test on the port: prefill(x[:L]) + one decode step
    gives forward(x[:L+1])'s last logits, with the same memory."""
    cfg = TC.get(name).smoke()
    params = TM.init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(1)
    L = 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, L + 1)))
    media = {k: torch.from_numpy(v) for k, v in _media(cfg, 2, 3).items()}
    _, caches = TM.prefill(params, {"tokens": toks[:, :L], **media}, cfg)
    _, logits_dec, _ = TM.decode_step(params, toks[:, L:], L, caches, cfg)
    x = TM._embed_in(params, toks, cfg)
    memory = TM._memory(params, media, cfg)
    x, _ = TM._decoder_stack(params, x, cfg, positions=torch.arange(L + 1),
                             mode="train", memory=memory)
    x = TM.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits_fwd = TM.unembed(x[:, -1], TM._unembed_table(params, cfg))
    np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name,mode", [(SEAMLESS, "quant"), (VISION, "xla")])
def test_greedy_generation_matches_reference(name, mode):
    """Prefill then 6 greedy ``decode_step``s, each package feeding its
    own tokens back: the tokens are equal."""
    cfg_r, cfg_t, pr, pt = _pair(name)
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(8).integers(0, cr.vocab_size,
                                             (2, 5)).astype(np.int32)
    br, bt = _batches(ct, toks, _media(ct, 2, 8))
    lr, cache_r = RM.prefill(pr, br, cr)
    lt, cache_t = TM.prefill(pt, bt, ct)
    want = [np.asarray(jnp.argmax(lr, -1))]
    got = [lt.argmax(-1).numpy()]
    for step in range(6):
        p = 5 + step
        nr, _, cache_r = RM.decode_step(
            pr, jnp.asarray(want[-1][:, None], jnp.int32), jnp.int32(p),
            cache_r, cr)
        nt, _, cache_t = TM.decode_step(
            pt, torch.from_numpy(got[-1][:, None]).long(), p, cache_t, ct)
        want.append(np.asarray(nr)[:, 0])
        got.append(nt[:, 0].numpy())
    assert np.array_equal(np.stack(got), np.stack(want))


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("name,mode", [(SEAMLESS, "xla"), (SEAMLESS, "quant"),
                                       (VISION, "xla")])
def test_loss_and_grads_match_reference(name, mode):
    """``loss_fn`` and its gradients (2 x 12 tokens with their memory)
    against ``jax.value_and_grad`` of the reference's, remat on and off:
    the encoder's, the cross-attention's and ``vision_proj``'s gradients
    among them (``quant``: the same scale-only pattern of nonzeros)."""
    cfg_r, cfg_t, pr, _ = _pair(name)
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    toks = np.random.default_rng(9).integers(0, cr.vocab_size, (2, 13))
    br, bt = _batches(ct, toks[:, :-1], _media(ct, 2, 9))
    br["labels"] = jnp.asarray(toks[:, 1:], jnp.int32)
    bt["labels"] = torch.from_numpy(toks[:, 1:])
    want_loss, want = jax.value_and_grad(RM.loss_fn)(pr, br, cr)
    want = dict(_flat(_np_tree(want)))
    for remat in (False, True):
        params = TM.from_reference(_np_tree(pr), cfg_t, device="cpu")
        leaves = [v.requires_grad_(True) for _, v in _flat(params)]
        loss = TM.loss_fn(params, bt, ct.scaled(remat=remat))
        grads = torch.autograd.grad(loss, leaves)
        assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
        got = dict(zip([k for k, _ in _flat(params)], grads))
        assert set(got) == set(want)
        for k, g in got.items():
            _close(g, want[k], GRAD_TOL, k)
            if mode == "quant":
                np.testing.assert_array_equal(g.numpy() != 0, want[k] != 0,
                                              err_msg=k)
        new = [k for k in got if k.startswith(("encoder/", "vision_proj"))
               or "/xw" in k or k.endswith("/normx")]
        assert len(new) >= 5
        assert all(float(got[k].abs().max()) > 0 for k in new)


# --------------------------------------------------------------------------
# caches, serving refusals, the trainer
# --------------------------------------------------------------------------

def test_cache_specs_match_reference():
    """``xk``/``xv`` slot-indexed on the ``"adx"`` layers (1601 patches,
    or 64 // 4 frames), not paged; full width."""
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
    assert TM.cache_specs(TC.get(VISION), 2, 64)["3"]["xk"][0] == \
        (8, 2, 1601, 8, 128)
    assert TM.cache_specs(TC.get(SEAMLESS), 2, 64)["0"]["xv"][0] == \
        (12, 2, 16, 16, 64)
    assert not set(TM.PAGED_KV_KEYS) & {"xk", "xv"}


def test_scheduler_refuses_multimodal_configs(model):
    """The reference's ``NotImplementedError``, with its message, before
    any other check."""
    cfg_r, cfg_t, pr, pt = model
    for scfg in ({}, {"paged": True, "speculative": True}):
        with pytest.raises(NotImplementedError) as want:
            RScheduler(pr, cfg_r, RServingConfig(**scfg))
        with pytest.raises(NotImplementedError) as got:
            Scheduler(pt, cfg_t, ServingConfig(**scfg), device="cpu")
        assert str(got.value) == str(want.value)
        assert "multimodal serving" in str(got.value)


@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_refuses_multimodal_configs(name):
    cfg_r = RC.get(name).smoke()
    with pytest.raises(NotImplementedError) as want:
        RScheduler(RM.init_params(cfg_r, jax.random.PRNGKey(0)), cfg_r,
                   RServingConfig())
    with pytest.raises(NotImplementedError) as got:
        serve_cli.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--pim-mode", "quant", "--requests", "2",
                        "--batch", "2", "--prompt-lens", "5",
                        "--max-new-tokens", "2"])
    assert str(got.value) == str(want.value)


def test_train_cli_encoder_and_vision_presets():
    """``build_cfg``'s encoder and vision branches: every field equals the
    reference's."""
    for name in NAMES:
        for preset in ("tiny", "20m"):
            args = type("A", (), dict(arch=name, smoke=False, preset=preset,
                                      layers=None))
            got, want = train_cli.build_cfg(args), r_train_cli.build_cfg(args)
            for f in dataclasses.fields(want):
                assert getattr(got, f.name) == getattr(want, f.name), \
                    (name, preset, f.name)
    tiny = type("A", (), dict(arch=SEAMLESS, smoke=False, preset="tiny",
                              layers=None))
    assert train_cli.build_cfg(tiny).n_encoder_layers == 2


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_feeds_the_reference_stub_batches(name, capsys):
    """Two CPU steps of the training CLI: each step's ``frames`` or
    ``patches`` equal the reference's stub batch for that step bit for
    bit, as float32 on the device, and the losses are finite."""
    seen = []
    real = train_cli.train_step

    def record(params, opt_state, batch, cfg, ocfg):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(params, opt_state, batch, cfg, ocfg)

    with mock.patch.object(train_cli, "train_step", record):
        losses = train_cli.main(["--arch", name, "--smoke", "--device",
                                 "cpu", "--steps", "2", "--batch", "2",
                                 "--seq", "16", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = RC.get(name).smoke()
    for step, batch in enumerate(seen):
        if cfg.is_encoder_decoder:
            key = "frames"
            want = r_pipeline.AudioStub(cfg.d_model, 16 // cfg.audio_frames_div
                                        ).batch_at(step, 2)
        else:
            key = "patches"
            want = r_pipeline.VisionStub(cfg.vision_dim, cfg.n_patches
                                         ).batch_at(step, 2)
        got = batch[key]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        assert set(batch) == {"tokens", "labels", key}
    assert "final loss" in capsys.readouterr().out
