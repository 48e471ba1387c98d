"""The substrate of training — data pipeline, checkpoints, fault tolerance
— against the reference's (``repro.data``, ``repro.checkpoint``,
``repro.runtime``), and the reference's own cases of
``tests/test_substrate.py`` on the port.

Data and checkpoints are held bit for bit: the pipeline is the same numpy
code, and a checkpoint written by either package restores in the other
with every leaf's bytes unchanged.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RCK
from repro.data import pipeline as RD
from repro.runtime import fault_tolerance as RFT
from repro_torch import checkpoint as TCK
from repro_torch.data import pipeline as TD
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.runtime import fault_tolerance as TFT


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_synthetic_lm_equals_reference(seed):
    for vocab, seq, batch, shards in ((512, 64, 8, 1), (277, 16, 4, 2),
                                      (152064, 32, 4, 4)):
        for shard in range(shards):
            a = RD.SyntheticLM(vocab, seq, batch, seed=seed,
                               shard_index=shard, shard_count=shards)
            b = TD.SyntheticLM(vocab, seq, batch, seed=seed,
                               shard_index=shard, shard_count=shards)
            for step in (0, 1, 5, 1000):
                x, y = a.batch_at(step), b.batch_at(step)
                assert x.keys() == y.keys()
                for k in x:
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_stubs_equal_reference(seed):
    for step in (0, 2, 9):
        np.testing.assert_array_equal(
            RD.AudioStub(64, 12).batch_at(step, 3, seed=seed),
            TD.AudioStub(64, 12).batch_at(step, 3, seed=seed))
        np.testing.assert_array_equal(
            RD.VisionStub(24, 9).batch_at(step, 2, seed=seed),
            TD.VisionStub(24, 9).batch_at(step, 2, seed=seed))


def test_data_deterministic_and_stateless():
    a = TD.SyntheticLM(512, 64, 8, seed=7)
    b = TD.SyntheticLM(512, 64, 8, seed=7)
    for step in (0, 3, 1000):
        x, y = a.batch_at(step), b.batch_at(step)
        assert np.array_equal(x["tokens"], y["tokens"])
        assert np.array_equal(x["labels"], y["labels"])
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              a.batch_at(1)["tokens"])


def test_data_shards_disjoint():
    shards = [TD.SyntheticLM(512, 32, 8, seed=1, shard_index=i,
                             shard_count=4) for i in range(4)]
    batches = [s.batch_at(5)["tokens"] for s in shards]
    assert all(b.shape == (2, 32) for b in batches)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(batches[i], batches[j])


def test_labels_are_next_tokens():
    b = TD.SyntheticLM(512, 64, 2, seed=0).batch_at(0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- checkpoints --------------------------------------------------------------

def _trees(rng):
    """The same tree as the reference's (jax) and the port's (torch):
    float32, bfloat16, int32 and a 0-d step, nested as a train state."""
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    c = rng.integers(-9, 9, (4,)).astype(np.int32)
    ref = {"p": {"blocks": {"0": {"wq": jnp.asarray(b, jnp.bfloat16)}},
                 "embed": jnp.asarray(a)},
           "o": {"step": jnp.int32(7), "leaves": {"c": jnp.asarray(c)}}}
    port = {"p": {"blocks": {"0": {"wq": torch.from_numpy(b).to(
        torch.bfloat16)}}, "embed": torch.from_numpy(a)},
        "o": {"step": torch.tensor(7, dtype=torch.int32),
              "leaves": {"c": torch.from_numpy(c)}}}
    return ref, port


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_same_bits(ref_tree, port_tree):
    want, got = dict(_flat(ref_tree)), dict(_flat(port_tree))
    assert want.keys() == got.keys()
    for k in want:
        w, g = _bits(want[k]), _bits(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(w, g, err_msg=k)


def test_checkpoint_keys_are_the_references(tmp_path):
    ref, port = _trees(np.random.default_rng(0))
    RCK.save_checkpoint(str(tmp_path / "r"), 1, ref, shard_count=3)
    TCK.save_checkpoint(str(tmp_path / "t"), 1, port, shard_count=3)
    mr = json.load(open(tmp_path / "r" / "step_00000001" / "manifest.json"))
    mt = json.load(open(tmp_path / "t" / "step_00000001" / "manifest.json"))
    assert mt == mr
    assert "p/blocks/0/wq" in mt["index"] and "o/step" in mt["index"]
    assert mt["index"]["p/blocks/0/wq"][1] == "bfloat16"


@pytest.mark.parametrize("shards", [1, 2])
def test_checkpoint_roundtrip(tmp_path, shards):
    ref, port = _trees(np.random.default_rng(1))
    TCK.save_checkpoint(str(tmp_path), 5, port, metadata={"k": 1},
                        shard_count=shards)
    assert TCK.latest_step(str(tmp_path)) == 5
    back, meta = TCK.restore_checkpoint(str(tmp_path), 5, port, device="cpu")
    assert meta == {"k": 1}
    _assert_same_bits(ref, back)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port = _trees(np.random.default_rng(2))
    RCK.save_checkpoint(str(tmp_path), 3, ref, metadata={"a": 2},
                        shard_count=2)
    like = jax.tree.map(torch.zeros_like, port)
    back, meta = TCK.restore_checkpoint(str(tmp_path), 3, like,
                                        device="cpu")
    assert meta == {"a": 2}
    _assert_same_bits(ref, back)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _trees(np.random.default_rng(3))
    TCK.save_checkpoint(str(tmp_path), 4, port, metadata={"b": 3},
                        shard_count=2)
    back, meta = RCK.restore_checkpoint(str(tmp_path), 4,
                                        jax.tree.map(jnp.zeros_like, ref))
    assert meta == {"b": 3}
    _assert_same_bits(back, port)


def test_checkpoint_retention(tmp_path):
    m = TFT.CheckpointManager(str(tmp_path), every_steps=1, keep=2,
                              device="cpu")
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        m.maybe_save(s, tree)
    assert TCK.available_steps(str(tmp_path)) == [3, 4]
    step, back, _ = m.resume(tree)
    assert step == 4 and torch.equal(back["x"], tree["x"])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    TCK.save_checkpoint(str(tmp_path), 1, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        TCK.restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros((3, 2))},
                               device="cpu")
    with pytest.raises(KeyError):
        TCK.restore_checkpoint(str(tmp_path), 1, {"y": torch.zeros((2, 2))},
                               device="cpu")


def test_restore_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    TCK.save_checkpoint(str(tmp_path), 1, {"x": torch.zeros((2,))})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TCK.restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros((2,))})
    assert not os.path.exists(tmp_path / "step_00000001.tmp")


# -- fault tolerance ----------------------------------------------------------

def test_run_with_restarts_resumes_identically(tmp_path):
    """Crash mid-training; the restarted run must match an uninterrupted one
    step for step (stateless data indexing + checkpoint resume)."""
    cfg = AdamWConfig(lr_peak=0.05, warmup_steps=2, total_steps=20,
                      weight_decay=0.0)
    data = TD.SyntheticLM(64, 16, 4, seed=3)

    def make_worker(crash_at, log, ckdir):
        manager = TFT.CheckpointManager(ckdir, every_steps=2, keep=3,
                                        device="cpu")

        def worker(resume_at):
            params = {"w": torch.zeros((64, 8), dtype=torch.float32)}
            state = init_state(cfg, params)
            start = 0
            if resume_at is not None:
                _, tree, _ = manager.resume({"p": params, "o": state})
                params, state = tree["p"], tree["o"]
                start = resume_at

            def loss_fn(w, batch):
                emb = w[torch.from_numpy(batch["tokens"]).long()]
                return torch.mean(emb ** 2) + 1e-3 * torch.sum((w - 1.0) ** 2)

            for step in range(start, 14):
                if crash_at is not None and step == crash_at \
                        and resume_at is None:
                    raise RuntimeError("injected")
                w = params["w"].detach().requires_grad_(True)
                loss = loss_fn(w, data.batch_at(step))
                (g,) = torch.autograd.grad(loss, [w])
                params, state, _ = apply_updates(cfg, {"w": w.detach()},
                                                 {"w": g}, state)
                log.append((step, round(float(loss.detach()), 8)))
                manager.maybe_save(step + 1, {"p": params, "o": state})
            return 14

        return worker, manager

    log_a, log_b = [], []
    wa, ma = make_worker(None, log_a, str(tmp_path / "a"))
    wa(None)
    wb, mb = make_worker(9, log_b, str(tmp_path / "b"))
    assert TFT.run_with_restarts(wb, mb) == 14
    # steps 8.. re-run after the crash resume; compare the final tail
    tail_a = [x for x in log_a if x[0] >= 10]
    tail_b = [x for x in log_b if x[0] >= 10]
    assert tail_a == tail_b[-len(tail_a):]
    assert [s for s, _ in log_b] == list(range(9)) + list(range(8, 14))


def test_run_with_restarts_gives_up():
    calls = []

    def worker(resume_at):
        calls.append(resume_at)
        raise RuntimeError("always")

    m = TFT.CheckpointManager("/nonexistent-dir-for-test", device="cpu")
    with pytest.raises(RuntimeError):
        TFT.run_with_restarts(worker, m, max_restarts=2)
    assert calls == [None, None, None]


def test_straggler_monitor_flags_the_references_steps():
    rng = np.random.default_rng(5)
    series = list(rng.uniform(0.9, 1.1, 40))
    for i in (6, 17, 18, 31):
        series[i] *= 4
    series[25] = 0.0
    a, b = RFT.StragglerMonitor(), TFT.StragglerMonitor()
    flags_a = [a.record(t) for t in series]
    flags_b = [b.record(t) for t in series]
    assert flags_a == flags_b and a.flagged == b.flagged > 0
    b.reset()
    assert b.flagged == 0 and not b.record(100.0)


def test_straggler_monitor():
    m = TFT.StragglerMonitor()
    for _ in range(10):
        assert not m.record(1.0)
    assert m.record(5.0)
    assert m.flagged == 1


def test_elastic_mesh_layout_matches_reference():
    """The port's ``ElasticMesh`` layout rule, (pods, data, model) over a
    world of ``n`` ranks, is the reference's over ``n`` devices, for every
    world the host's devices allow (``tests/test_torch_zero3.py`` builds
    the meshes over spawned worlds)."""
    for n in range(1, len(jax.devices()) + 1):
        for mp in (1, 2, 3, 4, 8):
            for pods in (1, 2, 3):
                m = RFT.ElasticMesh(mp, pods).make(jax.devices()[:n])
                assert TFT.ElasticMesh(mp, pods).shape(n) == tuple(
                    m.shape[a] for a in ("pod", "data", "model"))
