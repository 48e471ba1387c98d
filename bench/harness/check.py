"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests served in the window, drawn from the seed and holding the
longest one, goes through the cell's plain reference (``Cell.reference``,
a module under ``bench/reference``):
each prompt with the tokens the program served after it, teacher-forced.
At each served position the reading is how far the served token's logit
lies below the reference's best logit there; a cell compares the widest
such gap over the sample (``logit_gap_max``) or their mean
(``logit_gap_mean``), each under its own limit (``bench/cells``).  Every
served token is greedy, so a sound program reads near 0 and a token
altered or computed in a lower precision reads far above it."""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness.closed_loop import Request
from bench.reference import default

#: The control's linears: int4, the step below the int8 and 7-bit
#: fixed point the configurations run (``bench/control.py``).
CONTROL_BITS = 4


def sample(requests: List[Request], n: int, seed: int) -> List[Request]:
    """``n`` of ``requests``: the longest (prompt and served tokens), then
    the rest drawn from ``seed``."""
    if not requests:
        return []
    by_len = sorted(requests, key=lambda r: (-(r.plen + len(r.tokens)),
                                             r.spec.index))
    rest = by_len[1:]
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed % (1 << 63), 3])))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [by_len[0]] + [rest[i] for i in sorted(pick)]


def sequences(reqs: List[Request], device) -> List:
    """``(prompt + served[:-1], prompt length)`` of each request."""
    return [(torch.as_tensor(np.concatenate(
        [r.spec.prompt, np.asarray(r.tokens[:-1], np.int64)]),
        device=device), r.plen) for r in reqs]


def _gaps(ref_logits, picks) -> List[torch.Tensor]:
    """Per request, each position's reference best logit less the
    reference's logit of the token picked there (float64, on the host)."""
    out = []
    for lg, pick in zip(ref_logits, picks):
        best = lg.max(dim=-1).values
        got = lg.gather(1, pick.to(lg.device)[:, None])[:, 0]
        out.append((best - got).double().cpu())
    return out


def gaps(params, arch, reqs: List[Request], bits: int, wide: bool, device,
         ref: Optional[ModuleType] = None) -> List[torch.Tensor]:
    """Per request, the gap at each served position below the reference's
    best logit (its linears at ``bits``, rescaled in float64 when
    ``wide``) of the token served there; ``ref``: the cell's reference,
    the default one if None."""
    ref = ref or default
    logits = ref.served_logits(params, arch, sequences(reqs, device), bits,
                               wide)
    return _gaps(logits, [torch.as_tensor(r.tokens) for r in reqs])


def control_gaps(params, arch, reqs: List[Request], bits: int, wide: bool,
                 control_bits: int, device, ref: Optional[ModuleType] = None
                 ) -> List[torch.Tensor]:
    """The control: the reference put in the program's place with its
    linears at ``control_bits``.  At each served position, the gap below
    the reference's best (at ``bits``) of the token the control puts
    first."""
    ref = ref or default
    seqs = sequences(reqs, device)
    best = ref.served_logits(params, arch, seqs, bits, wide)
    ctl = ref.served_logits(params, arch, seqs, control_bits)
    return _gaps(best, [lc.argmax(dim=-1) for lc in ctl])


def readings(per_req: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap over every served
    position of the sample, and the mean gap over them."""
    if not per_req or not sum(g.numel() for g in per_req):
        return {}
    allg = torch.cat(per_req)
    return {"logit_gap_max": float(allg.max()),
            "logit_gap_mean": float(allg.mean())}


def judge(read: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) of the cell's compared
    numbers; a number that could not be read is not correct."""
    checks = {n: {"value": read.get(n), "limit": lim}
              for n, lim in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
