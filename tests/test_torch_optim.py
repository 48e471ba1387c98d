"""AdamW (``repro_torch.optim.adamw``) against ``repro.optim.adamw``, and
the reference's own optimizer cases (``tests/test_substrate.py``) on the
port.

Tolerances: both run the same float32 elementwise math; XLA and PyTorch
may round ``pow``/``cos``/``sqrt`` chains and the global-norm reduction in
another order, so the schedule agrees within ``SCHED_TOL`` = 1e-6
(relative, a few float32 ulps; observed 1.6e-7 from ``cos``), the
gradient norm within ``NORM_TOL`` = 1e-6 (relative), and parameters and
moments after 5 steps within ``STATE_TOL`` = 1e-6 of the
leaf's scale (float32 moments) or one bfloat16 ulp (2**-8, relative) for
bfloat16 moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.optim import adamw as TA

SCHED_TOL = 1e-6
NORM_TOL = 1e-6
STATE_TOL = 1e-6

VARIANTS = {
    "plain": dict(),
    "factored": dict(factored=True, factored_min_dim=8),
    "bf16": dict(moment_dtype="bfloat16"),
}


def _cfgs(**kw):
    base = dict(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2, total_steps=6,
                weight_decay=0.1, clip_norm=1.0)
    base.update(kw)
    return RA.AdamWConfig(**base), TA.AdamWConfig(**base)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _params(rng):
    """A bf16 matrix, a float32 matrix, a float32 vector (a norm) and a
    stacked (2, 16, 12) bf16 leaf, as the model's tree nests them."""
    shapes = {"embed": ((24, 16), jnp.bfloat16),
              "final_norm": ((16,), jnp.float32),
              "blocks": {"0": {"w_in": ((2, 16, 12), jnp.bfloat16),
                               "wq": ((16, 16), jnp.float32)}}}

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dt = spec
        return jnp.asarray(rng.standard_normal(shape), dt)
    return make(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    return t.numpy()


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=10,
                                             total_steps=110, lr_min=0.1,
                                             lr_peak=1.0),
                                dict(warmup_steps=0, total_steps=7)])
def test_cosine_schedule_matches_reference(kw):
    rc, tc = _cfgs(**kw)
    for step in range(0, 130, 3):
        want = float(RA.cosine_schedule(rc, jnp.int32(step)))
        got = float(TA.cosine_schedule(tc, torch.tensor(step,
                                                        dtype=torch.int32)))
        assert abs(got - want) <= SCHED_TOL * max(abs(want), 1e-30), step


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_state_tree_matches_reference(variant):
    rc, tc = _cfgs(**VARIANTS[variant])
    pr = _params(np.random.default_rng(0))
    want = dict(_flat(RA.init_state(rc, pr)))
    got = dict(_flat(TA.init_state(tc, _to_torch(pr))))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        assert not _np(g).any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_updates_matches_reference(variant):
    """Five steps on identical gradients: three large enough to be clipped
    (norm above ``clip_norm``), two below it."""
    rc, tc = _cfgs(**VARIANTS[variant])
    rng = np.random.default_rng(1)
    pr = _params(rng)
    pt = _to_torch(pr)
    sr, st = RA.init_state(rc, pr), TA.init_state(tc, pt)
    clipped = 0
    for step in range(5):
        mag = 3.0 if step % 2 == 0 else 0.01
        gr = jax.tree.map(
            lambda p: jnp.asarray(mag * rng.standard_normal(p.shape),
                                  p.dtype), pr)
        pr, sr, mr = RA.apply_updates(rc, pr, gr, sr)
        pt2, st2, mt = TA.apply_updates(tc, pt, _to_torch(gr), st)
        assert pt2 is pt and st2 is st          # updated in place
        gn_r, gn_t = float(mr["grad_norm"]), float(mt["grad_norm"])
        assert abs(gn_t - gn_r) <= NORM_TOL * gn_r
        clipped += gn_r > rc.clip_norm
        assert abs(float(mt["lr"]) - float(mr["lr"])) <= \
            SCHED_TOL * float(mr["lr"])
        assert int(st["step"]) == int(sr["step"]) == step + 1
        for (k, w), (k2, g) in zip(_flat(jax.tree.map(np.asarray,
                                                      {"p": pr, "o": sr})),
                                   _flat({"p": pt, "o": st})):
            assert k == k2
            w = np.asarray(w, np.float32)
            scale = max(float(np.abs(w).max()), 1e-30)
            tol = STATE_TOL * scale
            if g.dtype == torch.bfloat16:
                tol = 2.0 ** -8 * np.abs(w) + STATE_TOL * scale
            np.testing.assert_array_less(np.abs(_np(g) - w), tol + 1e-30,
                                         err_msg=f"step {step} {k}")
    assert clipped == 3


# -- the reference's own cases (tests/test_substrate.py) ----------------------

def _train_quadratic(cfg, steps=150):
    params = {"w": torch.from_numpy(
        np.linspace(-2, 2, 256).reshape(16, 16).astype(np.float32))}
    state = TA.init_state(cfg, params)
    for _ in range(steps):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.sum(w ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, state, _ = TA.apply_updates(cfg, params, {"w": g}, state)
    return float(torch.sum(params["w"] ** 2))


def test_adamw_converges():
    cfg = TA.AdamWConfig(lr_peak=0.2, warmup_steps=5, total_steps=150,
                         weight_decay=0.0, clip_norm=100.0)
    assert _train_quadratic(cfg) < 0.5


def test_factored_second_moment_converges():
    cfg = TA.AdamWConfig(lr_peak=0.2, warmup_steps=5, total_steps=150,
                         weight_decay=0.0, clip_norm=100.0, factored=True,
                         factored_min_dim=8)
    assert _train_quadratic(cfg) < 1.0


def test_factored_state_is_small():
    cfg = TA.AdamWConfig(factored=True, factored_min_dim=64)
    params = {"w": torch.zeros((256, 512), dtype=torch.bfloat16)}
    st = TA.init_state(cfg, params)["leaves"]["w"]
    assert "v" not in st and st["vr"].shape == (256,) \
        and st["vc"].shape == (512,)


def test_schedule_shape():
    cfg = TA.AdamWConfig(lr_peak=1.0, lr_min=0.1, warmup_steps=10,
                         total_steps=110)
    assert float(TA.cosine_schedule(cfg, 0)) == 0.0
    assert abs(float(TA.cosine_schedule(cfg, 10)) - 1.0) < 1e-6
    assert float(TA.cosine_schedule(cfg, 110)) <= 0.1 + 1e-6


def test_global_norm_matches_reference():
    pr = _params(np.random.default_rng(2))
    want = float(RA.global_norm(pr))
    got = float(TA.global_norm(_to_torch(pr)))
    assert abs(got - want) <= NORM_TOL * want
