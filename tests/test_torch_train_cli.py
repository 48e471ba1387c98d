"""The training CLI (``repro_torch.launch.train``) on the CPU: the smoke
config, the crash-and-resume drill through ``--fail-at-step`` and
``--resume``, the parallel flags at one rank, and the mesh branch at two
ranks.  The drill's resumed steps must give the uninterrupted run's
losses and final weights bit for bit: both runs take the same ops on the
same data in one process."""
import json

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as TCK
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import model_lib as M

BASE = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16", "--log-every", "1", "--ckpt-every", "3"]


def _run(tmp_path, name, *extra):
    d = tmp_path / name
    return train.main(BASE + ["--ckpt-dir", str(d), "--metrics-out",
                              str(tmp_path / f"{name}.jsonl")] + list(extra))


def _metrics(path):
    return [json.loads(line) for line in open(path)]


def _final(tmp_path, name, cfg):
    like = {"p": M.init_params(cfg, 0, "cpu")}
    from repro_torch.optim.adamw import AdamWConfig, init_state

    like["o"] = init_state(AdamWConfig(), like["p"])
    tree, meta = TCK.restore_checkpoint(str(tmp_path / name), 6, like,
                                        device="cpu")
    return tree, meta


@pytest.mark.parametrize("mode", ["xla", "quant"])
def test_crash_and_resume_equals_the_uninterrupted_run(tmp_path, mode):
    extra = ["--pim-mode", mode]
    want = _run(tmp_path, "a", *extra)
    assert len(want) == 6 and all(map(torch.isfinite, torch.tensor(want)))
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        _run(tmp_path, "b", *extra, "--fail-at-step", "4")
    assert TCK.available_steps(str(tmp_path / "b")) == [3]
    tail = _run(tmp_path, "b", *extra, "--resume")
    assert tail == want[3:]
    logged = _metrics(tmp_path / "b.jsonl")
    assert [m["step"] for m in logged] == [0, 1, 2, 3, 3, 4, 5]
    assert [m["loss"] for m in logged[4:]] == want[3:]
    cfg = configs.get("qwen1.5-0.5b").smoke()
    a, meta = _final(tmp_path, "a", cfg)
    b, _ = _final(tmp_path, "b", cfg)
    assert meta == {"arch": cfg.name, "final": True}
    flat_a = TCK.checkpoint._flatten(a)
    flat_b = TCK.checkpoint._flatten(b)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, x), (_, y) in zip(flat_a, flat_b):
        assert torch.equal(x, y), k
    # a resume past the last step has nothing left to do
    assert _run(tmp_path, "b", *extra, "--resume") == []


def test_cli_smoke_and_autotune_report(tmp_path, capsys):
    losses = train.main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "8", "--pim-mode",
                         "pim_sim", "--autotune"])
    out = capsys.readouterr().out
    assert len(losses) == 2
    assert "[autotune] cost-model report, 2 linear shape(s) at 16 tokens " \
        "(pim_sim)" in out
    assert "final loss" in out


def test_layers_cuts_the_depth():
    ap = type("A", (), dict(arch="qwen1.5-0.5b", smoke=False, preset=None,
                            layers=2))
    cfg = train.build_cfg(ap)
    assert cfg.n_layers == 2 and cfg.d_model == 1024
    ap.preset = "tiny"
    cfg = train.build_cfg(ap)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat) == \
        (2, 64, "float32", False)


@pytest.mark.parametrize("argv", [["--model-parallel", "2"],
                                  ["--pim-mode", "quant_tp"]])
def test_parallel_flags_train_at_one_rank(argv):
    """At one rank there is no mesh: ``--model-parallel 2`` is ignored, as
    in the reference, and ``--pim-mode quant_tp`` trains as ``quant``;
    both step for step."""
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "8"]
    losses = train.main(base + argv)
    assert len(losses) == 2 and all(np.isfinite(losses))
    plain = ["--pim-mode", "quant"] if "quant_tp" in argv else []
    assert losses == train.main(base + plain)


def test_two_rank_cli_trains_under_the_mesh_branch():
    """A 2-rank world (what ``torchrun --nproc-per-node 2`` starts) trains
    under the mesh branch: ``[mesh]`` (pod 1, data 2, model 1), a ZeRO-3
    sharded tree, rank 0 printing, and the single rank's losses within
    float32 summation order."""
    import _torch_dist_cases as C
    from repro_torch.launch.mesh import spawn

    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "8", "--log-every", "1", "--pim-mode", "quant"]
    ranks = spawn(C.run_jobs, 2, [("cli_case", ("train", argv))],
                  timeout_s=120.0)
    (losses, out), (losses1, out1) = ranks[0][0], ranks[1][0]
    assert "[mesh] {'pod': 1, 'data': 2, 'model': 1} over 2 ranks" in out
    assert "final loss" in out and out1 == ""
    assert losses == losses1
    np.testing.assert_allclose(losses, train.main(argv), rtol=0, atol=1e-5)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
