"""The plain reference against the program's plain CPU path, at the smoke
sizes of both configurations' block kinds (float32, so that both compute
the same numbers): the benchmark's run of each smoke cell reads a gap of
0 on every served token, and the reference's prefill logits equal the
program's.  The drawn parameter tree is the program's at full size."""
import dataclasses
from pathlib import Path

import pytest
import torch

from bench.harness import main as harness
from bench.harness.spec import load_cell
from bench.reference import params as ref_params
from bench.reference.arch import Arch
from bench.reference.model import served_logits


@pytest.mark.parametrize("name,layers", [("jamba-v0.1-52b", 8),
                                         ("h2o-danube-1.8b", 24)])
def test_drawn_tree_is_the_programs(name, layers):
    from repro_torch import configs
    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves

    cfg = configs.get(name).scaled(n_layers=layers)
    want = {tuple(p): (tuple(s.shape), s.dtype)
            for p, s in leaves(M.param_specs(cfg))}
    have = {p: (leaf[0], leaf[1]) for p, leaf in
            ref_params.leaves(Arch.from_model(dataclasses.asdict(cfg)))}
    assert want == have


@pytest.mark.parametrize("name", ["d.quant", "j.quant"])
def test_served_tokens_read_no_gap(smoke_root, name, capsys):
    rc = harness.main(["--workload", name, "--seed", "2147483999",
                       "--seconds", "1.5", "--trace", "0"],
                      root=Path(smoke_root), device="cpu")
    out = capsys.readouterr()
    assert rc == 0
    import json

    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"], out.err[-2000:]
    (c,) = res["checks"].values()
    assert c["value"] < 1e-4, c   # float32 on both sides: rounding only
    assert set(res["metrics"]) == {"tok_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("mode", ["quant", "pim_sim"])
def test_prefill_logits_equal_the_programs(smoke_root, mode):
    from repro_torch.models import model_lib as M

    cell = load_cell("j.quant", Path(smoke_root))
    cfg = harness.program_config(cell).scaled(pim_mode=mode)
    torch.manual_seed(0)
    params = ref_params.draw(cell.arch, 11, "cpu")
    toks = torch.randint(0, cell.arch.vocab_size, (1, 9))
    with torch.no_grad():
        logits, _ = M.prefill(params, {"tokens": toks}, cfg)
    ref = served_logits(params, cell.arch, [(toks[0], 9)],
                        8 if mode == "quant" else 7, mode == "pim_sim")[0]
    torch.testing.assert_close(ref[0], logits[0], rtol=0, atol=2e-5)


def test_window_prefill_logits_equal_the_programs(smoke_root):
    """A prompt past danube-smoke's window of 16."""
    from repro_torch.models import model_lib as M

    cell = load_cell("d.quant", Path(smoke_root))
    cfg = harness.program_config(cell)
    params = ref_params.draw(cell.arch, 12, "cpu")
    toks = torch.randint(0, cell.arch.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = M.prefill(params, {"tokens": toks}, cfg)
    ref = served_logits(params, cell.arch, [(toks[0], 40)], 8)[0]
    torch.testing.assert_close(ref[0], logits[0], rtol=0, atol=2e-5)


def test_arch_reads_only_known_fields():
    a = Arch.from_model({"n_layers": 2, "d_model": 8, "n_heads": 2,
                         "n_kv_heads": 1, "d_ff": 16, "vocab_size": 10,
                         "pattern": ["ad"], "family": "dense"})
    assert a.pattern == ("ad",) and a.padded_vocab == 256 and a.hd == 4
