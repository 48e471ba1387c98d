"""The train mode (``loss_fn`` with remat and the chunked loss, the train
step) against ``repro.models.model_lib`` on the smoke config of
qwen1.5-0.5b (float32), the reference's weights imported by
``from_reference``; the port runs on the CPU, i.e. on the kernels' plain
versions.

Tolerances: the two stacks run the same float32 math in different
reduction orders.  Losses agree within ``LOSS_TOL`` = 1e-5 (observed 0 in
``xla`` and ``quant``, 4.8e-7 in ``pim_sim``); each gradient leaf within
``GRAD_TOL`` = 2e-5 of its largest reference entry (observed below 1e-6).
``quant`` has no straight-through gradient in the reference: a weight
gets a gradient only through its column scale, at the column's abs-max
entry, so its nonzero pattern is held equal to the reference's too.
Losses of a short training loop agree within ``LOOP_TOL`` = 1e-4.
"""
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import model_lib as RM
from repro.optim import adamw as RA
from repro_torch.kernels import crossbar_exec as xb_pkg
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.launch.train import train_step
from repro_torch.models import model_lib as TM
from repro_torch.models.layers import unembed
from repro_torch.optim import adamw as TA
from repro_torch.pim import engine

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
LOOP_TOL = 1e-4
# batch, seq per mode: pim_sim runs the crossbar programs on the host
SHAPES = {"xla": (2, 16), "quant": (2, 16), "pim_sim": (1, 8)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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
    return cfg_r, cfg_t, pr


def _batch(cfg, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    ref = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
           "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    port = {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}
    return ref, port


def _port_params(pr, cfg_t):
    return TM.from_reference(_np_tree(pr), cfg_t, device="cpu")


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _port_loss_grads(params, batch, cfg):
    leaves = [v.requires_grad_(True) for _, v in _flat(params)]
    loss = TM.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip([k for k, _ in _flat(params)], grads))


_ref_cache = {}


def _ref_loss_grads(pr, batch, cfg, key):
    if key not in _ref_cache:
        loss, grads = jax.value_and_grad(RM.loss_fn)(pr, batch, cfg)
        _ref_cache[key] = float(loss), dict(_flat(_np_tree(grads)))
    return _ref_cache[key]


def _assert_grads(got, want, pattern: bool):
    assert set(got) == set(want)
    for k, g in got.items():
        g, w = g.numpy(), want[k]
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)
        if pattern:
            np.testing.assert_array_equal(g != 0, w != 0, err_msg=k)


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_loss_and_grads_match_reference(models, mode):
    cfg_r, cfg_t, pr = models
    b, s = SHAPES[mode]
    br, bt = _batch(cfg_r, b, s)
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    want_loss, want = _ref_loss_grads(pr, br, cr, (mode, b, s))
    loss, got = _port_loss_grads(_port_params(pr, cfg_t), bt, ct)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    _assert_grads(got, want, pattern=mode == "quant")
    if mode == "quant":
        # the scale-only gradient: one entry per column of each weight
        w_in = got["blocks/0/w_in"][0]
        assert 0 < int((w_in != 0).sum()) <= 2 * w_in.shape[1]


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_remat_gives_the_same_loss_and_grads(models, mode):
    cfg_r, cfg_t, pr = models
    _, bt = _batch(cfg_r, *SHAPES[mode])
    ct = cfg_t.scaled(pim_mode=mode)
    loss0, g0 = _port_loss_grads(_port_params(pr, cfg_t), bt,
                                 ct.scaled(remat=False))
    loss1, g1 = _port_loss_grads(_port_params(pr, cfg_t), bt,
                                 ct.scaled(remat=True))
    assert torch.equal(loss0, loss1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("chunk", [None, 0, 7, 100, 280, 1000])
def test_unembed_chunk_equals_the_full_product(chunk):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5, 64), dtype=np.float32))
    table = torch.from_numpy(rng.standard_normal((280, 64),
                                                 dtype=np.float32))
    got = unembed(x, table, chunk=chunk)
    assert got.shape == (5, 280)
    np.testing.assert_allclose(got.numpy(), (x @ table.T).numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [dict(loss_chunk=8), dict(unembed_chunk=100),
                                dict(loss_chunk=16, unembed_chunk=64)])
def test_chunked_loss_matches_reference(models, kw):
    """The loss's token-chunk split path (32 tokens in chunks of 8 or 16)
    and the vocab-chunked unembed, against the reference's."""
    cfg_r, cfg_t, pr = models
    br, bt = _batch(cfg_r, 2, 16, seed=2)
    want_loss, want = _ref_loss_grads(pr, br, cfg_r.scaled(**kw),
                                      tuple(sorted(kw.items())))
    loss, got = _port_loss_grads(_port_params(pr, cfg_t), bt,
                                 cfg_t.scaled(**kw))
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    _assert_grads(got, want, pattern=False)
    whole = TM.loss_fn(_port_params(pr, cfg_t), bt, cfg_t)
    assert abs(float(loss) - float(whole)) <= LOSS_TOL


def _counting(fn, box, key):
    def wrapped(*a, **kw):
        box[key] += 1
        return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize("mode", ["quant", "pim_sim"])
def test_backward_on_another_thread(models, mode):
    """``backward()`` from a thread that entered no context (as autograd's
    device thread on a card) recomputes every checkpointed block in the
    forward's mode and on transient state: the same gradients and the same
    kernel counts as from the calling thread, and no resident state."""
    cfg_r, cfg_t, pr = models
    _, bt = _batch(cfg_r, 1, 8, seed=3)
    cfg = cfg_t.scaled(pim_mode=mode, remat=True)
    n_linears = 7 * cfg.n_layers
    box = {"quant": 0, "pim_sim": 0}
    patches = [
        mock.patch.object(q_ops, "quant_matmul_int",
                          _counting(q_ops.quant_matmul_int, box, "quant")),
        mock.patch.object(xb_pkg, "crossbar_exec",
                          _counting(xb_pkg.crossbar_exec, box, "pim_sim"))]
    for p in patches:
        p.start()
    try:
        runs = {}
        for where in ("caller", "thread"):
            params = _port_params(pr, cfg_t)
            leaves = [v.requires_grad_(True) for _, v in _flat(params)]
            info0 = engine.cache_info()
            box.update(quant=0, pim_sim=0)
            loss = TM.loss_fn(params, bt, cfg)
            fwd = dict(box)
            if where == "caller":
                loss.backward()
            else:
                err = []

                def run():
                    try:
                        assert engine.current_mode() == "xla"
                        loss.backward()
                    except BaseException as e:   # re-raised below
                        err.append(e)

                t = threading.Thread(target=run)
                t.start()
                t.join()
                if err:
                    raise err[0]
            info = engine.cache_info()
            runs[where] = (fwd, dict(box), [v.grad.clone() for v in leaves],
                           info.resident_entries - info0.resident_entries,
                           info.exec_uploads - info0.exec_uploads)
    finally:
        for p in patches:
            p.stop()
    (fwd_a, all_a, g_a, res_a, up_a), (fwd_b, all_b, g_b, res_b, up_b) = \
        runs["caller"], runs["thread"]
    # the forward runs each linear once, the recompute each again (the
    # checkpoint's last saved tensor is packed after w_out's kernel)
    assert fwd_a[mode] == fwd_b[mode] == n_linears
    assert all_a[mode] == all_b[mode] == 2 * n_linears
    other = "pim_sim" if mode == "quant" else "quant"
    assert all_a[other] == all_b[other] == 0
    assert res_a == res_b == 0 and up_a == up_b == 0
    for a, b in zip(g_a, g_b):
        assert torch.equal(a, b)


def test_pim_sim_train_step_keeps_no_resident_state(models):
    """Train steps keep no crossbar state resident, and the engine's
    derived-weight caches keep one version per weight: a step changes
    every weight in place, and the next replaces each cached entry."""
    cfg_r, cfg_t, pr = models
    cfg = cfg_t.scaled(pim_mode="pim_sim", remat=True)
    params = _port_params(pr, cfg_t)
    ocfg = TA.AdamWConfig(warmup_steps=1, total_steps=4)
    state = TA.init_state(ocfg, params)
    info0 = engine.cache_info()
    sizes = []
    for step in range(2):
        _, bt = _batch(cfg_r, 1, 8, seed=4 + step)
        params, state, loss, metrics = train_step(params, state, bt, cfg,
                                                  ocfg)
        assert torch.isfinite(loss) and torch.isfinite(metrics["grad_norm"])
        sizes.append((len(engine._derived), len(engine._chunked)))
    info = engine.cache_info()
    assert info.resident_entries == info0.resident_entries
    assert info.resident_bytes == info0.resident_bytes
    assert info.exec_uploads == info0.exec_uploads
    assert info.exec_transient > info0.exec_transient
    assert int(state["step"]) == 2
    assert sizes[1] == sizes[0]


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_train_loop_matches_reference(models, mode):
    """Three steps of both packages' train steps from the same weights,
    each carrying its own: the losses per step and the final weights."""
    cfg_r, cfg_t, pr = models
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=3)
    ocr, oct_ = RA.AdamWConfig(**kw), TA.AdamWConfig(**kw)

    @jax.jit
    def ref_step(p, o, batch):
        loss, grads = jax.value_and_grad(
            lambda q: RM.loss_fn(q, batch, cr))(p)
        p, o, _ = RA.apply_updates(ocr, p, grads, o)
        return p, o, loss

    p_r, o_r = pr, RA.init_state(ocr, pr)
    p_t = _port_params(pr, cfg_t)
    o_t = TA.init_state(oct_, p_t)
    for step in range(3):
        br, bt = _batch(cfg_r, 2, 16, seed=10 + step)
        p_r, o_r, loss_r = ref_step(p_r, o_r, br)
        p_t, o_t, loss_t, _ = train_step(p_t, o_t, bt, ct, oct_)
        assert abs(float(loss_t) - float(loss_r)) <= LOOP_TOL, step
    for k, v in _flat(_np_tree(p_r)):
        np.testing.assert_allclose(dict(_flat(p_t))[k].detach().numpy(), v,
                                   rtol=0, atol=LOOP_TOL, err_msg=k)
