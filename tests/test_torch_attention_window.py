"""``decode_attention(..., window=)`` against the reference's
(``repro.models.attention.decode_attention``): the window clip of the
prefix mask, for a window below, at and above ``cache_len``, with a
scalar and a per-slot ``(B, 1)`` ``cache_len``.

Same float32 inputs, made from a seed with numpy, through both.  Both
compute float32 scores and a float32 weighted sum, but the two einsum
implementations may reduce in another order: the outputs agree within
``ATOL`` (a few float32 ulps of values of order 1), and the masked rows
agree exactly in which keys they see (a key outside the window moves the
output by far more than ``ATOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ratt
from repro_torch.models import attention as tatt

B, S, H, HKV, D = 3, 24, 4, 2, 16
ATOL = 2e-6


def _inputs(seed, sq=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, cache_len, window):
    want = np.asarray(ratt.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(cache_len), window=window))
    got = tatt.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.as_tensor(cache_len), window=window).numpy()
    return got, want


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [4, 17, 17 + 1, 40, None],
                         ids=["below", "below2", "at", "above", "none"])
def test_window_clip_matches_reference(window, per_slot):
    q, k, v = _inputs(0)
    cache_len = (np.array([[18], [9], [24]], np.int32) if per_slot
                 else np.int32(18))
    got, want = _both(q, k, v, cache_len, window)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_window_changes_what_is_seen():
    """A window below ``cache_len`` drops the oldest keys: the output
    differs from the unwindowed one, and equals attention over the last
    ``window`` keys alone."""
    q, k, v = _inputs(1)
    cl, w = 18, 5
    full = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.tensor(cl))
    win = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.tensor(cl),
                                window=w)
    tail = tatt.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[:, cl - w:cl]),
        torch.from_numpy(v[:, cl - w:cl]), torch.tensor(w))
    assert (full - win).abs().max() > 100 * ATOL
    np.testing.assert_allclose(win.numpy(), tail.numpy(), rtol=0, atol=ATOL)
