"""Self-speculative decoding: cheap-mode draft, expensive-mode verify,
exact greedy acceptance.

One round over the scheduler's slot batch:

1. **Draft**: the cheap mode (``draft_mode``, e.g. ``"quant"``) runs
   ``k - 1`` ordinary single-token decode steps from the batch's current
   tokens, producing a candidate run per slot.  Drafting shares the KV
   pool: its writes land at the run's positions and are overwritten by
   the verify step below, and writes past a slot's last reserved row are
   discarded by the model's guarded per-slot write paths (trash-block
   routing on the paged pool, dropped writes on the contiguous one), never
   wrapped or clamped onto live rows.  Drafting shares the compiled
   artifacts, but runs inside :func:`repro_torch.pim.engine.draft_ctx`,
   whose ``"draft"`` session namespace keeps a ``pim_sim`` draft's
   crossbar uploads from evicting the verify path's resident state.
2. **Verify**: the expensive mode (the scheduler's ``cfg.pim_mode``)
   checks all ``k`` positions — current token plus ``k - 1`` drafts — in
   **one** :func:`repro_torch.models.model.decode_run_slots` call, which
   rewrites every KV row it covers with verify-mode bits.
3. **Accept**: greedy decode makes acceptance a pure integer comparison
   (:func:`accept_length`): the longest prefix of drafts matching the
   verify continuations is committed, plus the verify continuation after
   it — at least one token per round.  Rejected rows hold garbage KV, but
   every decode mask is position-gated, so the next round's writes land
   on them before any query can see them: rollback is "don't advance
   ``pos`` past the accepted rows".

The committed tokens are exactly the greedy chain the verify mode gives
alone, so speculative decode is bit-identical to plain decode in every
mode and for every draft: a poor draft only shortens the accepted runs.
How often a draft matches is a property of the pair, and has to be
measured: ``"quant"`` rounds activations and weights to 8 bits and
``"pim_sim"`` to 7, so a ``"quant"`` draft for a ``"pim_sim"`` verify is
not bit-equal to it, and an ``"xla"`` float draft differs from both.

Shapes are pinned: the draft step is the plain ``(B, 1)`` decode step and
the verify step one ``(B, k)`` step.  ``draft_traces`` / ``verify_traces``
count their distinct input shapes, as the scheduler's ``decode_traces``
does (the reference counts jit retraces); tests pin both to 1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model_lib as M
from repro_torch.models.config import ModelConfig
from repro_torch.pim import engine

__all__ = ["SpeculativeDecoder", "accept_length"]


def accept_length(fed: np.ndarray, verify: np.ndarray) -> int:
    """Tokens committed by one verify run, in ``1..S`` (host-side, exact).

    ``fed`` (S,) is the token run the verify step consumed — the current
    token followed by ``S - 1`` drafts; ``verify`` (S,) the greedy
    continuation it produced at each position.  ``verify[0]`` conditions
    only on committed tokens, so it is always accepted; ``verify[i]`` is
    accepted while every draft before it matched its verify continuation
    (``fed[j + 1] == verify[j]`` for ``j < i``).
    """
    n = 1
    s = len(fed)
    while n < s and fed[n] == verify[n - 1]:
        n += 1
    return n


def _shape_key(tokens, pos, active, tables):
    return (tuple(tokens.shape), tuple(pos.shape), tuple(active.shape),
            None if tables is None else tuple(tables.shape))


class SpeculativeDecoder:
    """Draft/verify round engine for one scheduler's slot batch.

    The ``(B, 1)`` draft step runs under ``cfg.scaled(pim_mode=draft_mode)``
    inside :func:`engine.draft_ctx`; the ``(B, k)`` verify step under the
    scheduler's own ``cfg``.  ``rounds`` counts verify steps."""

    def __init__(self, cfg: ModelConfig, draft_mode: str, draft_k: int):
        if draft_k < 2:
            raise ValueError("SpeculativeDecoder needs draft_k >= 2 "
                             "(draft_k=1 is plain decode; the scheduler "
                             "short-circuits it)")
        self.cfg = cfg
        self.draft_mode = draft_mode
        self.k = draft_k
        self.dcfg = cfg.scaled(pim_mode=draft_mode)
        self.rounds = 0
        self._draft_shapes: set = set()
        self._verify_shapes: set = set()

    @property
    def draft_traces(self) -> int:
        return len(self._draft_shapes)

    @property
    def verify_traces(self) -> int:
        return len(self._verify_shapes)

    def _draft(self, params, tokens, pos, active, caches, tables):
        self._draft_shapes.add(_shape_key(tokens, pos, active, tables))
        # the "draft" session namespace: a pim_sim draft can never evict
        # the verify path's resident crossbar state
        with engine.draft_ctx():
            return M.decode_step_slots(params, tokens, pos, active, caches,
                                       self.dcfg, block_tables=tables)

    def _verify(self, params, tokens, pos, active, caches, tables):
        self._verify_shapes.add(_shape_key(tokens, pos, active, tables))
        return M.decode_run_slots(params, tokens, pos, active, caches,
                                  self.cfg, block_tables=tables)

    def run_round(self, params, tokens: np.ndarray, pos: np.ndarray,
                  active: np.ndarray, caches, tables, device):
        """One draft + verify round over the whole slot batch.

        ``tokens`` (B, 1) int current token per slot, ``pos`` (B,) int its
        absolute position, ``active`` (B,) bool the decoding mask; the
        caches and ``tables`` live on ``device``.  Returns ``(toks_run,
        verify_tok, caches)``: the (B, k) run the verify step consumed and
        its (B, k) greedy continuations, both as host arrays, and the cache
        tree with every covered row rewritten in verify-mode bits.  The
        drafts stay on the device until the verify has run: one host copy
        per round."""
        cur = torch.as_tensor(np.asarray(tokens, np.int64)).to(device)
        pos_t = torch.as_tensor(np.asarray(pos, np.int64)).to(device)
        act = torch.as_tensor(np.asarray(active)).to(device)
        run = [cur]
        for i in range(1, self.k):
            cur, _, caches = self._draft(params, cur, pos_t + (i - 1), act,
                                         caches, tables)
            run.append(cur)
        toks_run = torch.cat([t.to(torch.int64) for t in run], dim=1)
        vt, _, caches = self._verify(params, toks_run, pos_t, act, caches,
                                     tables)
        self.rounds += 1
        return toks_run.cpu().numpy(), vt.cpu().numpy(), caches
