"""The comparison that decides ``correct`` fails what it must: a token
altered where the scheduler produces it, and the control (the reference
in the program's place with int4 linears) reads far above a sound run."""
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from bench.harness import check, closed_loop, main as harness
from bench.harness.spec import load_cell
from bench.harness.traffic import Spec
from bench.reference import params as ref_params


def _run(root, name, capsys, seed=2147483777):
    rc = harness.main(["--workload", name, "--seed", str(seed),
                       "--seconds", "1.0", "--trace", "0"],
                      root=Path(root), device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["d.quant", "j.quant"])
def test_an_altered_token_is_not_correct(smoke_root, name, capsys):
    from repro_torch.serving.scheduler import Scheduler

    real = Scheduler._decode

    def altered(self, active):
        toks = real(self, active)
        return (toks + 1) % self.cfg.vocab_size

    with mock.patch.object(Scheduler, "_decode", altered):
        res = _run(smoke_root, name, capsys)
    assert not res["correct"]
    (c,) = res["checks"].values()
    assert c["value"] > c["limit"]
    assert res["failed"] >= 1


def test_an_altered_first_token_is_not_correct(smoke_root, capsys):
    """The token a prefill produces, altered at the admit."""
    from repro_torch.serving.scheduler import Scheduler

    real = Scheduler._prefill

    def altered(self, toks, last, prefix=None):
        logits, cache = real(self, toks, last, prefix)
        logits = logits.clone()
        logits[0, int(logits[0].argmax())] -= 1e3
        return logits, cache

    with mock.patch.object(Scheduler, "_prefill", altered):
        res = _run(smoke_root, "d.quant", capsys)
    assert not res["correct"]


def test_the_control_reads_far_above_a_sound_run(smoke_root):
    cell = load_cell("j.quant", Path(smoke_root))
    params = ref_params.draw(cell.arch, 21, "cpu")
    rng = np.random.default_rng(0)
    reqs = []
    from bench.reference.model import served_logits

    for i in range(3):
        prompt = rng.integers(0, cell.arch.vocab_size, size=12)
        r = closed_loop.Request(i, Spec(i, prompt, 6), 0, 0.0)
        seq = torch.as_tensor(prompt)
        for _ in range(6):      # greedy decode of the reference itself
            lg = served_logits(params, cell.arch, [(seq, 12)], 8)[0]
            tok = int(lg[-1].argmax())
            r.tokens.append(tok)
            seq = torch.cat([seq, torch.tensor([tok])])
        reqs.append(r)
    sound = check.readings(check.gaps(params, cell.arch, reqs, 8, False,
                                      "cpu"))
    ctl = check.readings(check.control_gaps(params, cell.arch, reqs, 8,
                                            False, check.CONTROL_BITS,
                                            "cpu"))
    assert sound == {"logit_gap_max": 0.0, "logit_gap_mean": 0.0}
    assert ctl["logit_gap_max"] > 0.05 and ctl["logit_gap_mean"] > 0.01


def test_the_sample_holds_the_longest():
    reqs = [closed_loop.Request(i, Spec(i, np.zeros(10 + i, np.int64), 5), 0,
                           0.0, tokens=[1] * (i % 4 + 1)) for i in range(12)]
    for seed in (1, 2, 2 ** 31 + 9):
        smp = check.sample(reqs, 4, seed)
        assert len(smp) == 4 and smp[0] is reqs[11]
        assert len({r.rid for r in smp}) == 4
    assert check.sample(reqs, 4, 5) == check.sample(reqs, 4, 5)
    assert check.sample([], 3, 1) == []
