"""The port's compile-once / execute-many engine against ``repro``:
``matmul_int`` exact across K chunks, ``sim_linear`` bit-identical to the
reference's host math, weight-stationary sessions exact, and the
straight-through gradient."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pim import engine as r_engine
from repro_torch.pim import engine


def _exact(x, w):
    return x.astype(np.int64) @ w.astype(np.int64).T


@pytest.mark.parametrize("m,k,o", [(3, 30, 5), (2, 80, 7), (2, 79, 4),
                                   (2, 1024, 3)])
def test_matmul_int_exact(m, k, o):
    # K > 37 runs ceil(K / 37) 37-term chunks, the last zero-padded, as one
    # batch: K=79 is 2 * 37 + 5, K=1024 is 27 * 37 + 25
    rng = np.random.default_rng(k)
    x = rng.integers(0, 256, (m, k))
    w = rng.integers(0, 256, (o, k))
    got = engine.matmul_int(torch.from_numpy(x), torch.from_numpy(w), 8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _exact(x, w))
    want = r_engine.matmul_int(x.astype(np.uint64), w.astype(np.uint64), 8,
                               backend="numpy")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_compile_cache_returns_one_artifact():
    a = engine.compile_dot(5, 8)
    info = engine.cache_info()
    b = engine.compile_matmul(5, 8)
    assert a is b
    assert engine.cache_info().hits == info.hits + 1
    assert a.microcode_on("cpu") is a.microcode_on("cpu")
    r = r_engine.compile_dot(5, 8)
    np.testing.assert_array_equal(a.microcode, r.microcode)
    assert (a.x_cols, a.w_cols, a.acc_cols) == (r.x_cols, r.w_cols,
                                                r.acc_cols)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sim_linear_bit_identical(dtype):
    # K=64 at the smoke width: two 37-term chunks, the second zero-padded
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 24)) * 0.2).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = r_engine.sim_linear(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    xt = torch.from_numpy(x).to(tdt)
    wt = torch.from_numpy(w).to(tdt)
    got = engine.sim_linear(xt, wt)
    assert got.dtype == tdt and got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_sessions_keep_weights_resident_and_exact():
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(30, 6)) * 0.3).astype(np.float32))
    x1 = torch.from_numpy(rng.normal(size=(4, 30)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(4, 30)).astype(np.float32))

    def ref(x, w):
        return np.asarray(r_engine.sim_linear(jnp.asarray(x.numpy()),
                                              jnp.asarray(w.numpy())))

    i0 = engine.cache_info()
    y1 = engine.sim_linear(x1, w)
    i1 = engine.cache_info()
    assert i1.exec_uploads == i0.exec_uploads + 1      # cold upload
    y2 = engine.sim_linear(x2, w)
    y1b = engine.sim_linear(x1, w)
    i2 = engine.cache_info()
    assert i2.exec_hits == i1.exec_hits + 2            # weight-stationary
    assert i2.exec_uploads == i1.exec_uploads
    assert torch.equal(y1, y1b)
    np.testing.assert_array_equal(y1.numpy(), ref(x1, w))
    np.testing.assert_array_equal(y2.numpy(), ref(x2, w))
    # an in-place change of the weight bumps its version: a cold upload,
    # and the result follows the new weight
    w.mul_(-0.5)
    y3 = engine.sim_linear(x1, w)
    i3 = engine.cache_info()
    assert i3.exec_uploads == i2.exec_uploads + 1
    np.testing.assert_array_equal(y3.numpy(), ref(x1, w))


def test_one_artifact_and_one_launch_per_linear():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (2, 79)))
    w = torch.from_numpy(rng.integers(0, 256, (3, 79)))
    engine.clear_cache()
    got = engine.matmul_int(x, w, 8)
    info = engine.cache_info()
    assert info.builds == 1 and info.size == 1       # the 37-term program
    assert info.exec_uploads == 3                    # one per chunk GEMM
    np.testing.assert_array_equal(got.numpy(), _exact(x.numpy(), w.numpy()))


def test_second_call_with_the_same_weight_uploads_nothing():
    # the zero-padded weight is made once per weight tensor, so the padded
    # chunks keep their crossbar state resident across calls
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(79, 4)) * 0.2).astype(np.float32))
    x1 = torch.from_numpy(rng.normal(size=(2, 79)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(2, 79)).astype(np.float32))
    engine.sim_linear(x1, w)
    i1 = engine.cache_info()
    y2 = engine.sim_linear(x2, w)
    i2 = engine.cache_info()
    assert i2.exec_uploads == i1.exec_uploads
    assert i2.exec_hits == i1.exec_hits + 3
    want = r_engine.sim_linear(jnp.asarray(x2.numpy()), jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(y2.numpy(), np.asarray(want))


def test_session_batches_chunks_into_one_state():
    art = engine.compile_dot(4, 8)
    sess = engine.ExecutionSession(art)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (3, 2, 4)))
    w = torch.from_numpy(rng.integers(0, 256, (3, 5, 4)))
    got = sess.execute(x, w)
    assert got.shape == (3, 2, 5) and sess.uploads == 3
    for p in range(3):
        np.testing.assert_array_equal(got[p].numpy(),
                                      _exact(x[p].numpy(), w[p].numpy()))
    with pytest.raises(ValueError, match="terms"):
        sess.execute(x[0, :, :3], w[0, :, :3])


def test_sim_linear_straight_through_gradient():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    (engine.sim_linear(x, w) * g).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    ((x2 @ w2) * g).sum().backward()        # the ideal matmul's gradient
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=1e-6)


def test_mode_context():
    assert engine.current_mode() == "xla"
    with engine.mode("quant"):
        assert engine.resolve_mode() == "quant"
        with engine.mode("pim_sim"):
            assert engine.current_mode() == "pim_sim"
        assert engine.resolve_mode("xla") == "xla"
    assert engine.current_mode() == "xla"
    assert engine.MODES == r_engine.MODES
    with pytest.raises(ValueError):
        engine.resolve_mode("bogus")


def test_prefill_keeps_no_resident_state():
    """Prefills of several lengths run their pim_sim linears on transient
    state: no resident entry is kept for a prefill M, only the decode
    step's M stays resident, and the logits are the bits of a run that
    keeps every state resident."""
    import contextlib

    import repro_torch.configs as TC
    from repro_torch.models import model_lib as TM

    cfg = TC.get("qwen1.5-0.5b").smoke().scaled(
        d_model=32, d_ff=32, head_dim=8, n_heads=4, n_kv_heads=4,
        pim_mode="pim_sim", max_seq_len=16)
    params = TM.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(0, 277, (1, n)))
               for n in (3, 5, 7)]

    def prefills():
        return [TM.prefill(params, {"tokens": t}, cfg)[0] for t in prompts]

    engine.clear_cache()
    transient = prefills()
    info = engine.cache_info()
    assert info.resident_entries == 0 and info.resident_bytes == 0
    assert info.exec_uploads == 0 and info.exec_hits == 0
    assert info.exec_transient == 3 * 7          # 3 prefills x 7 linears
    _, caches = TM.prefill(params, {"tokens": prompts[0]}, cfg)
    tok = torch.zeros((1, 1), dtype=torch.long)
    TM.decode_step(params, tok, 3, caches, cfg)
    info = engine.cache_info()
    assert info.resident_entries == 7            # the decode M only
    assert info.exec_uploads == 7
    # one 32-term program per linear: (O*M/256 -> 1 crossbar) x 1024 x 8
    assert info.resident_bytes == 7 * 1024 * 8 * 4
    TM.decode_step(params, tok, 4, caches, cfg)
    assert engine.cache_info().exec_hits == 7
    assert engine.cache_info().resident_entries == 7

    engine.clear_cache()
    with mock.patch.object(engine, "transient", contextlib.nullcontext):
        kept = prefills()
    info = engine.cache_info()
    assert info.resident_entries == 3 * 7        # one per (prefill M, linear)
    assert info.exec_transient == 0
    for a, b in zip(transient, kept):
        assert torch.equal(a, b)


def test_resident_bytes_are_bounded():
    """The byte bound evicts least recently used states across sessions;
    an evicted weight is uploaded again and its results keep their
    bits."""
    rng = np.random.default_rng(8)
    ws = [torch.from_numpy(rng.integers(0, 256, (3, 20))) for _ in range(5)]
    x = torch.from_numpy(rng.integers(0, 256, (2, 20)))
    engine.clear_cache()
    one = 1024 * 8 * 4                           # one crossbar's state
    with mock.patch.object(engine, "MAX_RESIDENT_BYTES", 2 * one):
        first = [engine.matmul_int(x, w, 8) for w in ws]
        info = engine.cache_info()
        assert info.resident_entries == 2 and info.resident_bytes == 2 * one
        assert info.exec_uploads == 5
        again = [engine.matmul_int(x, w, 8) for w in ws]
        info = engine.cache_info()
        assert info.exec_uploads == 10 and info.exec_hits == 0
        assert info.resident_bytes <= 2 * one
    for w, a, b in zip(ws, first, again):
        np.testing.assert_array_equal(a.numpy(), _exact(x.numpy(), w.numpy()))
        assert torch.equal(a, b)
    # the last two stay resident: a hit each
    engine.matmul_int(x, ws[-1], 8)
    assert engine.cache_info().exec_hits == 1


def _weight_bytes(*ws):
    """derived (uint8 offset operand, f32 scales, int64 column sums) and
    chunked (the uint8 operand zero-padded to whole 37-term chunks) bytes
    of (K, N) weights, K > 37."""
    derived = sum(w.shape[0] * w.shape[1] + 12 * w.shape[1] for w in ws)
    chunked = sum(-(-w.shape[0] // 37) * 37 * w.shape[1] for w in ws)
    return derived, chunked


@pytest.mark.parametrize("transient", [False, True],
                         ids=["resident", "transient"])
def test_dropped_weights_leave_no_cache_entry(transient):
    """A weight the caller drops leaves nothing in the engine: its derived
    copies, chunked copies and resident states go with it, in resident and
    in ``transient()`` calls, while a live weight keeps its entries, its
    resident state (a hit on its next call) and its bits."""
    import contextlib
    import gc
    import weakref

    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(2, 80)).astype(np.float32))
    live = torch.from_numpy(rng.normal(size=(80, 6)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(size=(80, 6)).astype(np.float32))
          for _ in range(3)]
    ctx = engine.transient if transient else contextlib.nullcontext
    engine.clear_cache()
    with ctx():
        y_live = engine.sim_linear(x, live)
        for w in ws:
            engine.sim_linear(x, w)
    derived, chunked = _weight_bytes(live, *ws)
    info = engine.cache_info()
    assert (info.derived_entries, info.chunked_entries) == (4, 4)
    assert (info.derived_bytes, info.chunked_bytes) == (derived, chunked)
    # one 3-chunk state per weight: 3 crossbars of 1024 x 8 words
    assert info.resident_bytes == (0 if transient else 4 * 3 * 1024 * 8 * 4)
    refs = [weakref.ref(w) for w in ws]
    del ws, w
    gc.collect()
    assert all(r() is None for r in refs)
    derived, chunked = _weight_bytes(live)
    info = engine.cache_info()
    assert (info.derived_entries, info.chunked_entries) == (1, 1)
    assert (info.derived_bytes, info.chunked_bytes) == (derived, chunked)
    assert info.resident_entries == (0 if transient else 1)
    # the live weight: a hit on its resident state, the same bits
    y_again = engine.sim_linear(x, live)
    after = engine.cache_info()
    assert after.exec_hits == info.exec_hits + (0 if transient else 3)
    assert after.exec_uploads == info.exec_uploads + (3 if transient else 0)
    assert torch.equal(y_live, y_again)
    want = r_engine.sim_linear(jnp.asarray(x.numpy()),
                               jnp.asarray(live.numpy()))
    np.testing.assert_array_equal(y_again.numpy(), np.asarray(want))
    ref = weakref.ref(live)
    del live
    gc.collect()
    info = engine.cache_info()
    assert ref() is None
    assert (info.derived_bytes, info.chunked_bytes, info.resident_bytes) \
        == (0, 0, 0)
    assert (info.derived_entries, info.chunked_entries,
            info.resident_entries) == (0, 0, 0)


def test_dropped_views_of_a_stacked_weight_keep_their_entries():
    """A layer's weight is a fresh view of the stacked parameter on every
    call: dropping the view ends nothing while the parameter lives (its
    second call hits), and dropping the parameter ends every layer's
    entries."""
    import gc

    rng = np.random.default_rng(11)
    stacked = torch.from_numpy(rng.normal(size=(2, 80, 6)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 80)).astype(np.float32))
    engine.clear_cache()
    first = [engine.sim_linear(x, stacked[i]) for i in range(2)]
    gc.collect()
    info = engine.cache_info()
    assert info.resident_entries == 2 and info.derived_entries == 2
    again = [engine.sim_linear(x, stacked[i]) for i in range(2)]
    assert engine.cache_info().exec_hits == info.exec_hits + 2 * 3
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    del stacked
    gc.collect()
    info = engine.cache_info()
    assert (info.derived_bytes, info.chunked_bytes, info.resident_bytes) \
        == (0, 0, 0)


@pytest.mark.parametrize("which", ["derived", "chunked"])
def test_weight_caches_are_bounded_in_bytes(which):
    """Past its byte bound a weight cache evicts its least recently used
    entry first (with the resident states made from it); an evicted
    weight is rebuilt on its next call with the same bits."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 80)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(size=(80, 6)).astype(np.float32))
          for _ in range(3)]
    derived, chunked = _weight_bytes(ws[0])
    one = derived if which == "derived" else chunked
    bound = "MAX_DERIVED_BYTES" if which == "derived" else "MAX_CHUNKED_BYTES"
    engine.clear_cache()
    with mock.patch.object(engine, bound, 2 * one):
        first = [engine.sim_linear(x, w) for w in ws]
        info = engine.cache_info()
        assert getattr(info, f"{which}_entries") == 2
        assert getattr(info, f"{which}_bytes") == 2 * one
        # the first weight went, and its resident state with it
        assert info.resident_entries == 2 and info.exec_uploads == 3 * 3
        engine.sim_linear(x, ws[2])        # the most recent: a hit
        assert engine.cache_info().exec_hits == 3
        y0 = engine.sim_linear(x, ws[0])   # rebuilt: a cold upload
        info = engine.cache_info()
        assert info.exec_uploads == 4 * 3
        # ws[1] was the least recently used and is gone now
        assert getattr(info, f"{which}_entries") == 2
        y1 = engine.sim_linear(x, ws[1])
        assert engine.cache_info().exec_uploads == 5 * 3
    assert torch.equal(y0, first[0]) and torch.equal(y1, first[1])
    engine.clear_cache()
    assert engine.cache_info().derived_bytes == 0
