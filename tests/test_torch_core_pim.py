"""``core/`` and the ``pim/`` program builders against ``repro``: control
message widths, and the microcode, I/O columns and statistics of real
programs must be equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import PartitionConfig as RCfg
from repro.core import message_bits as r_message_bits
from repro.pim.matmul import build_dot as r_build_dot
from repro.pim.matmul import max_dot_terms as r_max_dot_terms
from repro.pim.multpim import build_multpim as r_build_multpim
from repro_torch.core import MODELS, PartitionConfig, message_bits
from repro_torch.core.gates import ALL_ONES, GATE_CODES, GATE_DEFS
from repro_torch.pim.matmul import build_dot, max_dot_terms
from repro_torch.pim.multpim import build_multpim
from repro.core import MODELS as R_MODELS
from repro.core.gates import GATE_CODES as R_GATE_CODES


@pytest.mark.parametrize("n,k", [(1024, 32), (1024, 8), (512, 16),
                                 (4096, 64)])
def test_message_bits_all_models(n, k):
    assert tuple(MODELS) == tuple(R_MODELS)
    for model in MODELS:
        assert message_bits(model, PartitionConfig(n, k)) == \
            r_message_bits(model, RCfg(n, k)), model


def test_gate_codes_and_word_semantics():
    import torch

    assert GATE_CODES == R_GATE_CODES
    a = torch.tensor([0x0F0F0F0F, -1, 0], dtype=torch.int32)
    b = torch.tensor([0x00FF00FF, 0, -1], dtype=torch.int32)
    an, bn = a.numpy().view(np.uint32), b.numpy().view(np.uint32)
    want = {"NOT": ~an, "NOR": ~(an | bn), "OR": an | bn,
            "NAND": ~(an & bn), "AND": an & bn}
    for name, w in want.items():
        g = GATE_DEFS[name]
        got = g(a) if g.n_inputs == 1 else g(a, b)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), w)
    assert int(GATE_DEFS["INIT"]()) == int(ALL_ONES) == -1


def _same_program(p, r):
    np.testing.assert_array_equal(p.program.to_microcode(),
                                  r.program.to_microcode())
    assert dataclasses.asdict(p.program.stats()) == \
        dataclasses.asdict(r.program.stats())


@pytest.mark.parametrize("n_terms", [37, 25])
def test_build_dot_equal(n_terms):
    assert max_dot_terms(8, 1024) == r_max_dot_terms(8, 1024) == 37
    p, r = build_dot(n_terms, 8), r_build_dot(n_terms, 8)
    _same_program(p, r)
    assert (p.x_cols, p.w_cols, p.acc_cols) == (r.x_cols, r.w_cols,
                                                r.acc_cols)
    assert p.program.name == r.program.name


@pytest.mark.parametrize("model", ["minimal", "standard", "unlimited"])
def test_build_multpim_equal(model):
    p, r = build_multpim(8, 1024, model), r_build_multpim(8, 1024, model)
    _same_program(p, r)
    assert (p.a_cols, p.b_cols, p.result_cols) == (r.a_cols, r.b_cols,
                                                   r.result_cols)
    p.program.check_messages()          # every control message round-trips
