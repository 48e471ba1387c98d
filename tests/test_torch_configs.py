"""The port's configuration registry against ``repro.configs``, and the
dense configurations gemma-7b (head_dim 256 above d_model / n_heads, the
embedding scale, tanh gelu, tied embeddings) and granite-20b (one KV head,
an ungated MLP, untied embeddings) on the reference's weights.  The MoE
configurations granite-moe-1b-a400m and arctic-480b, and the recurrent
jamba-v0.1-52b and xlstm-1.3b, and the encoder-decoder seamless-m4t-medium
and vision llama-3.2-vision-11b, are held field for field and tree for
tree here (every leaf's init kind and scale too); their smoke models run
in tests/test_torch_moe.py, tests/test_torch_recurrent.py and
tests/test_torch_multimodal.py.

Tolerances: logits within ``LOGIT_TOL`` = 1e-4 of the reference's
(float32 smoke models, different reduction orders, as in
tests/test_torch_model.py), greedy tokens equal; every integer GEMM of the
path exact: each int32 accumulator of ``quant`` equals the reference's
Pallas kernel (interpret mode) on the same operands, each ``pim_sim``
product the reference's crossbar GEMM (its numpy interpreter).
"""
import contextlib
import dataclasses
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
from repro.pim import engine as r_engine
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.models import model_lib as TM
from repro_torch.pim import engine

LOGIT_TOL = 1e-4
NEW = ("gemma-7b", "granite-20b", "h2o-danube-1.8b")
MOE = ("granite-moe-1b-a400m", "arctic-480b")
RECURRENT = ("jamba-v0.1-52b", "xlstm-1.3b")
MULTIMODAL = ("seamless-m4t-medium", "llama-3.2-vision-11b")
#: The port's own configurations, which the reference has no model for
#: (tests/test_torch_granite_hybrid.py holds them to the benchmark's plain
#: reference), and the port's own fields, each with the default that
#: leaves every reference configuration as the reference computes it.
PORT_ONLY_ARCHS = ("granite-4.0-h-small",)
PORT_ONLY_FIELDS = {"mamba_n_heads": 0, "shared_d_ff": 0,
                    "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                    "attention_multiplier": None, "logits_scaling": 1.0,
                    "use_rope": True}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", NEW + ("qwen1.5-0.5b",) + MOE + RECURRENT
                         + MULTIMODAL)
def test_every_field_equals_the_reference(name):
    got, want = TC.get(name), RC.get(name)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == \
        names + list(PORT_ONLY_FIELDS)
    for f in names:
        assert getattr(got, f) == getattr(want, f), f
    for f, default in PORT_ONLY_FIELDS.items():
        assert getattr(got, f) == default, f
    assert (got.hd, got.padded_vocab, got.n_super) == \
        (want.hd, want.padded_vocab, want.n_super)
    assert (got.dt_rank, got.d_inner, got.has_recurrent_blocks,
            got.sub_quadratic, got.is_encoder_decoder) == (
                want.dt_rank, want.d_inner, want.has_recurrent_blocks,
                want.sub_quadratic, want.is_encoder_decoder)
    smoke_t, smoke_r = got.smoke(), want.smoke()
    for f in names:
        assert getattr(smoke_t, f) == getattr(smoke_r, f), f
    for f, default in PORT_ONLY_FIELDS.items():
        assert getattr(smoke_t, f) == default, f


def test_registry():
    """Every reference configuration, in the reference's order, then the
    port's own; an unknown name raises ``KeyError``."""
    assert TC.ARCH_NAMES == RC.ARCH_NAMES + list(PORT_ONLY_ARCHS)
    assert set(NEW + MOE + RECURRENT + MULTIMODAL) <= set(TC.ARCH_NAMES)
    assert list(TC.all_configs()) == TC.ARCH_NAMES
    with pytest.raises(KeyError):
        TC.get("seamless-m4t-large")


@pytest.mark.parametrize("name", NEW + MOE + RECURRENT + MULTIMODAL)
def test_full_width_parameter_tree_equals_the_reference(name):
    """The full-width tree, no weight allocated: every leaf's shape,
    dtype, init kind and scale (gemma's 16 heads of 256, granite's single
    KV head and ungated MLP, untied heads, the MoE blocks' float32 router
    and stacked experts, arctic's dense residual MLP, jamba's Mamba,
    xLSTM's per-head leaves, seamless's encoder subtree and
    cross-attention, llama-vision's ``vision_proj``)."""
    cfg_t, cfg_r = TC.get(name), RC.get(name)
    specs_r = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype),
                                      s.init, s.scale),
                           RM.param_specs(cfg_r),
                           is_leaf=lambda x: isinstance(x,
                                                        jax.ShapeDtypeStruct))
    specs_t = TM.param_specs(cfg_t)

    def walk(t, r, path=()):
        assert set(t) == set(r), path
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], r[k], path + (k,))
            else:
                shape, dt, init, scale = t[k]
                assert (tuple(shape), str(dt).replace("torch.", ""), init,
                        scale) == r[k], path + (k,)

    walk(specs_t, specs_r)
    assert TM.param_count(cfg_t) == RM.param_count(cfg_r)
    blocks = specs_t["blocks"]["0"]
    if name == "gemma-7b":
        assert blocks["wq"][0] == (28, 3072, 16 * 256)
    if name == "granite-20b":
        assert blocks["wk"][0] == (52, 6144, 128) and "w_gate" not in blocks
        assert "lm_head" in specs_t
    if name == "granite-moe-1b-a400m":
        assert blocks["router"][:2] == ((24, 1024, 32), torch.float32)
        assert blocks["w1"][0] == (24, 32, 1024, 512)
        assert blocks["w2"][0] == (24, 32, 512, 1024)
        assert "w_in" not in blocks and "lm_head" not in specs_t
    if name == "arctic-480b":
        assert blocks["w1"][0] == (35, 128, 7168, 4864)
        assert blocks["w_in"][0] == (35, 7168, 4864)
        assert "lm_head" in specs_t
    if name == "jamba-v0.1-52b":
        assert blocks["in_proj"][0] == (4, 4096, 16384)
        assert blocks["x_proj"][0] == (4, 8192, 256 + 32)
        assert blocks["a_log"][2:] == ("alog", 1.0)
        assert "w_in" in blocks and "w1" in specs_t["blocks"]["1"]
        assert "wq" in specs_t["blocks"]["4"] and "lm_head" in specs_t
    if name == "xlstm-1.3b":
        assert blocks["wz"][0] == (6, 4, 1024, 1024)
        assert specs_t["blocks"]["1"]["w_gates"][0] == (6, 4096, 8)
        assert specs_t["blocks"]["1"]["w_gates"][2:] == ("normal", 0.5)
        assert "lm_head" not in specs_t
    if name == "seamless-m4t-medium":
        enc = specs_t["encoder"]
        assert enc["blocks"]["0"]["wq"][0] == (12, 1024, 1024)
        assert "xwq" not in enc["blocks"]["0"]
        assert enc["enc_norm"][2] == "ones"
        assert blocks["xwk"][0] == (12, 1024, 1024)
        assert blocks["normx"][:3] == ((12, 1024), torch.float32, "ones")
        assert "lm_head" not in specs_t and "vision_proj" not in specs_t
    if name == "llama-3.2-vision-11b":
        assert specs_t["vision_proj"][:2] == ((1280, 4096), torch.bfloat16)
        assert specs_t["blocks"]["3"]["xwk"][0] == (8, 4096, 1024)
        assert "xwq" not in blocks and "encoder" not in specs_t
        assert "lm_head" in specs_t


def _smoke(name, **kw):
    return RC.get(name).smoke().scaled(**kw), TC.get(name).smoke().scaled(**kw)


# gemma: 4 heads of 32 over d_model 64, so head_dim is not d_model / heads;
# granite: one KV head (smoke() would pick 2)
CASES = {"gemma-7b": dict(head_dim=32), "granite-20b": dict(n_kv_heads=1)}


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    name = request.param
    cfg_r, cfg_t = _smoke(name, **CASES[name])
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(3))
    pt = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t, device="cpu")
    return name, cfg_r, cfg_t, pr, pt


def _assert_logits(want, got):
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def _prefill_and_decode(cfg_r, cfg_t, pr, pt):
    toks = np.random.default_rng(4).integers(0, cfg_r.vocab_size,
                                             (2, 9)).astype(np.int32)
    lr, cache_r = RM.prefill(pr, {"tokens": jnp.asarray(toks)}, cfg_r)
    lt, cache_t = TM.prefill(pt, {"tokens": _t(toks).long()}, cfg_t)
    _assert_logits(lr, lt)
    nxt = np.asarray(jnp.argmax(lr, -1))[:, None].astype(np.int32)
    _, lr2, _ = RM.decode_step(pr, jnp.asarray(nxt), jnp.int32(9),
                               cache_r, cfg_r)
    _, lt2, _ = TM.decode_step(pt, _t(nxt).long(), 9, cache_t, cfg_t)
    _assert_logits(lr2, lt2)
    return lt, lt2


@pytest.mark.parametrize("mode", ["xla", "quant", "pim_sim"])
def test_prefill_and_decode_match_reference(model, mode):
    name, cfg_r, cfg_t, pr, pt = model
    cr, ct = cfg_r.scaled(pim_mode=mode), cfg_t.scaled(pim_mode=mode)
    calls = []
    if mode == "quant":
        real = q_ops.quant_matmul_int

        def record(x, w):
            acc = real(x, w)
            calls.append((x.numpy(), w.numpy(), acc.numpy()))
            return acc

        patch = mock.patch.object(q_ops, "quant_matmul_int", record)
    elif mode == "pim_sim":
        real = engine.matmul_int

        def record(x, w, n_bits=8, **kw):
            acc = real(x, w, n_bits, **kw)
            calls.append((x.numpy(), w.numpy(), acc.numpy(), n_bits))
            return acc

        patch = mock.patch.object(engine, "matmul_int", record)
    else:
        patch = contextlib.nullcontext()
    engine.clear_cache()
    with patch:
        _prefill_and_decode(cr, ct, pr, pt)
    # every linear of the prefill and of the decode step (w_gate only when
    # gated)
    n_lin = 7 if cfg_t.gated_mlp else 6
    if mode == "quant":
        assert len(calls) == 2 * n_lin
        for x, w, acc in calls:
            want = np.asarray(r_qmm(jnp.asarray(x), jnp.asarray(w)))
            np.testing.assert_array_equal(acc, want)
    elif mode == "pim_sim":
        assert len(calls) == 2 * n_lin
        for x, w, acc, bits in calls:
            want = r_engine.matmul_int(x.astype(np.uint64),
                                       w.astype(np.uint64), bits,
                                       backend="numpy")
            np.testing.assert_array_equal(acc, want.astype(np.int64))
    engine.clear_cache()


def test_gemma_scales_the_embedding_and_granite_does_not():
    for name, scaled in (("gemma-7b", True), ("granite-20b", False)):
        _, cfg_t = _smoke(name, **CASES[name])
        params = TM.init_params(cfg_t, 0, device="cpu")
        toks = torch.tensor([[1, 2, 3]])
        x = TM._embed_in(params, toks, cfg_t)
        want = params["embed"][toks]
        if scaled:
            want = want * torch.tensor(cfg_t.d_model ** 0.5)
        assert torch.equal(x, want)
