"""Compile-once / execute-many front-end for the PIM stack.

The driving side of the partitioned crossbar, as one API:

* :func:`compile_dot` / :func:`compile_matmul` — build (once) and cache a
  :class:`CompiledPim` artifact: the gate program, its flat microcode, and
  the I/O column layout, keyed on
  ``(n_terms, n_bits, model, accumulate, n_cols)``.  Repeated calls with
  the same key return the *same* artifact without rebuilding (program
  construction is the expensive Python part — thousands of gate appends).
* :class:`ExecutionSession` / :func:`session_for` — persistent execution:
  crossbar state stays resident on the operands' device across calls,
  keyed per (geometry, weight) — a crossbar array in real PIM *is* a
  weight matrix — so repeated GEMMs write only the *activation* columns
  while the weights stay resident (weight-stationary operation; a
  program's microcode re-INITs every working column it reads and never
  writes operand columns, so reuse is bit-exact).  The state runs on the
  CUDA crossbar kernel for a CUDA tensor and on its plain version for a
  CPU tensor (``kernels.crossbar_exec``).  Resident state is bounded in
  bytes, process-wide (:data:`MAX_RESIDENT_BYTES`, LRU).
* :func:`transient` — a context in which every GEMM runs on a fresh
  state that is dropped after the call.  The model's prefill entry points
  enter it: a prompt's row count M is a one-off shape, and one M's
  states for every linear of a full-width model come to about M GiB, so
  only the decode step (whose M is fixed) keeps state resident.
* :func:`matmul_int` — the exact integer GEMM over the session pool, with
  inner dimensions longer than one row's column budget split into chunks
  and the last chunk zero-padded to a whole one; all chunks run as one
  batch of crossbars, so a linear costs one kernel launch.
* :func:`mode` / :func:`current_mode` / :func:`resolve_mode` — an
  explicit, exception-safe context manager selecting how
  ``models.layers.linear`` lowers a matmul (``"xla"`` | ``"quant"`` |
  ``"quant_tp"`` | ``"pim_sim"``); ``ModelConfig.pim_mode`` threads the
  same selection through configs, and an explicit config field wins over
  the ambient context.
* :func:`sim_linear` — the bit-accurate crossbar linear, a
  ``torch.autograd.Function`` with a straight-through backward.  It calls
  :func:`matmul_int` directly: packing, execution and unpacking stay on
  the tensor's device.

Every non-"xla" lowering quantizes activations **per row**, so a batched
step is bit-identical per row to a single-row one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "MODES",
    "CompiledPim",
    "CacheInfo",
    "compile_dot",
    "compile_matmul",
    "cache_info",
    "clear_cache",
    "ExecutionSession",
    "MAX_RESIDENT_BYTES",
    "session_for",
    "transient",
    "matmul_int",
    "sim_linear",
    "mode",
    "current_mode",
    "resolve_mode",
]


# ==========================================================================
# execution-mode selection
# ==========================================================================

MODES = ("xla", "quant", "quant_tp", "pim_sim")
_DEFAULT_MODE = "xla"


class _ModeStack(threading.local):
    def __init__(self):
        self.frames = []


_mode_stack = _ModeStack()


def _check_mode(name: str) -> str:
    if name not in MODES:
        raise ValueError(f"unknown PIM mode {name!r}; expected one of {MODES}")
    return name


@contextlib.contextmanager
def mode(name: str) -> Iterator[str]:
    """Select the linear-lowering mode for the enclosed block (re-entrant).

    The prior mode is restored on exit, including on exception.  Thread
    local, so concurrent callers don't race each other.
    """
    _mode_stack.frames.append(_check_mode(name))
    try:
        yield name
    finally:
        _mode_stack.frames.pop()


def current_mode() -> str:
    """The innermost ``mode(...)`` selection, or ``"xla"`` outside any."""
    return _mode_stack.frames[-1] if _mode_stack.frames else _DEFAULT_MODE


def resolve_mode(override: Optional[str] = None) -> str:
    """Explicit (config-threaded) mode if given, else the ambient mode."""
    if override is not None:
        return _check_mode(override)
    return current_mode()


# ==========================================================================
# compile cache
# ==========================================================================

@dataclasses.dataclass(frozen=True, eq=False)
class CompiledPim:
    """An executable PIM artifact: program + microcode + I/O columns.

    Immutable and shared — every cache hit returns the same object, so
    treat ``microcode`` as read-only.  :meth:`microcode_on` and
    :meth:`columns_on` keep one copy per device.
    """

    key: Tuple
    program: "object"               # repro_torch.core.program.Program
    microcode: np.ndarray           # (G, 4) int32 flat microcode
    n_bits: int
    n_terms: int
    x_cols: Tuple[Tuple[int, ...], ...]
    w_cols: Tuple[Tuple[int, ...], ...]
    acc_cols: Tuple[int, ...]
    _device_copies: Dict = dataclasses.field(default_factory=dict,
                                             repr=False)

    @property
    def n_cols(self) -> int:
        return self.program.cfg.n

    def _on(self, device) -> Tuple[torch.Tensor, ...]:
        device = torch.device(device)
        hit = self._device_copies.get(device)
        if hit is None:
            hit = tuple(torch.as_tensor(a, dtype=dt).to(device).contiguous()
                        for a, dt in ((self.microcode, torch.int32),
                                      (self.x_cols, torch.long),
                                      (self.w_cols, torch.long),
                                      (self.acc_cols, torch.long)))
            self._device_copies[device] = hit
        return hit

    def microcode_on(self, device) -> torch.Tensor:
        """The (G, 4) int32 microcode as a tensor on ``device`` (cached)."""
        return self._on(device)[0]

    def columns_on(self, device) -> Tuple[torch.Tensor, ...]:
        """``(x_cols, w_cols, acc_cols)`` as int64 tensors on ``device``
        (cached), so that a GEMM copies no column index from the host: such
        a copy waits for the stream and would stall the host behind every
        kernel already queued."""
        return self._on(device)[1:]


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    hits: int
    misses: int
    builds: int
    size: int
    # execution counters (ExecutionSession), one per chunk GEMM: how many
    # reused resident crossbar state (writing only activation columns —
    # the weights were already resident) vs paid a cold full-state upload
    # that stays resident, and how many ran on a transient state (both
    # operands written, nothing kept; see ``transient``).
    exec_hits: int = 0
    exec_uploads: int = 0
    exec_transient: int = 0
    # resident crossbar states across all sessions, and their bytes
    resident_entries: int = 0
    resident_bytes: int = 0


_cache: Dict[Tuple, CompiledPim] = {}
_cache_lock = threading.Lock()
_hits = 0
_misses = 0
_builds = 0


def compile_dot(n_terms: int, n_bits: int = 8, *, model: str = "minimal",
                accumulate: str = "carry_save", n_cols: int = 1024
                ) -> CompiledPim:
    """Compile (or fetch) the single-row dot-product program.

    The artifact computes ``sum_i x_i * w_i`` over ``n_terms`` pairs of
    ``n_bits``-bit unsigned ints per simulator row.
    """
    global _hits, _misses, _builds
    key = (n_terms, n_bits, model, accumulate, n_cols)
    with _cache_lock:
        art = _cache.get(key)
        if art is not None:
            _hits += 1
            return art
        _misses += 1
    # build outside the lock: a multi-second build must not stall unrelated
    # cache hits or other keys' builds.  On a lost race the first insert
    # wins and the duplicate build is discarded.
    from repro_torch.pim.matmul import build_dot

    dot = build_dot(n_terms, n_bits, n_cols=n_cols, model=model,
                    accumulate=accumulate)
    art = CompiledPim(
        key=key,
        program=dot.program,
        microcode=dot.program.to_microcode(),
        n_bits=dot.n_bits,
        n_terms=dot.n_terms,
        x_cols=dot.x_cols,
        w_cols=dot.w_cols,
        acc_cols=dot.acc_cols,
    )
    with _cache_lock:
        existing = _cache.get(key)
        if existing is not None:
            return existing
        _builds += 1
        _cache[key] = art
        return art


def compile_matmul(n_terms: int, n_bits: int = 8, *, model: str = "minimal",
                   accumulate: str = "carry_save", n_cols: int = 1024
                   ) -> CompiledPim:
    """Compile (or fetch) the artifact driving an integer GEMM.

    A GEMM with inner dimension ``K = n_terms`` runs the dot program on
    every (m, o) output element concurrently — one simulator row each —
    so the artifact is exactly the dot artifact; this alias documents the
    intent at GEMM call sites.
    """
    return compile_dot(n_terms, n_bits, model=model, accumulate=accumulate,
                       n_cols=n_cols)


def cache_info() -> CacheInfo:
    with _cache_lock:
        info = CacheInfo(hits=_hits, misses=_misses, builds=_builds,
                         size=len(_cache))
    with _session_lock:
        return dataclasses.replace(info, exec_hits=_exec_hits,
                                   exec_uploads=_exec_uploads,
                                   exec_transient=_exec_transient,
                                   resident_entries=len(_resident),
                                   resident_bytes=_resident_bytes)


def clear_cache() -> None:
    global _hits, _misses, _builds, _exec_hits, _exec_uploads, \
        _exec_transient, _resident_bytes
    with _cache_lock:
        _cache.clear()
        _hits = _misses = _builds = 0
    with _session_lock:
        for sess, key in list(_resident):
            sess._states.pop(key, None)
        _resident.clear()
        _resident_bytes = 0
        _sessions.clear()
        _exec_hits = _exec_uploads = _exec_transient = 0
    _derived.clear()
    _chunked.clear()


# ==========================================================================
# execution front-end
# ==========================================================================

def _tensor_key(t: torch.Tensor) -> Tuple:
    """Identity of a tensor's contents: storage, view geometry, dtype,
    device and in-place version.  Whoever keys on it must also hold ``t``,
    so that the storage cannot be freed and reused while the key lives."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype, t.device, t._version)


def _grid(v: torch.Tensor, n_cb: int, rows: int) -> torch.Tensor:
    """(P, M*O, K) operand rows -> (P*n_cb, rows, K), zero-padded to whole
    crossbars (the paper's rows x crossbars way-parallelism)."""
    p, total, k = v.shape
    pad = n_cb * rows - total
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    return v.reshape(p * n_cb, rows, k)


_sessions: Dict[Tuple, "ExecutionSession"] = {}
_session_lock = threading.Lock()
_exec_hits = 0
_exec_uploads = 0
_exec_transient = 0

#: Bound on the bytes of resident crossbar state over all sessions
#: (``state.numel() * 4`` per entry), least recently used evicted first.
#: 8 GiB holds the decode-step states of every linear of full-width
#: qwen1.5-0.5b (about 1 GiB per decode row) up to batch 8.
MAX_RESIDENT_BYTES = 8 << 30
# every resident state, LRU order: (session, key) -> bytes
_resident: "collections.OrderedDict" = collections.OrderedDict()
_resident_bytes = 0


class _Transient(threading.local):
    def __init__(self):
        self.depth = 0


_transient = _Transient()


@contextlib.contextmanager
def transient() -> Iterator[None]:
    """Run every GEMM of the enclosed block on a transient crossbar state:
    a blank state, both operands written, executed, read, and nothing kept
    (re-entrant, thread local).  The results are the same bits as on
    resident state.  ``models.model``'s prefill entry points enter it."""
    _transient.depth += 1
    try:
        yield
    finally:
        _transient.depth -= 1


def _keep(sess: "ExecutionSession", key: Tuple, w: torch.Tensor,
          state: torch.Tensor) -> None:
    """Make ``state`` resident under ``key`` and evict least recently used
    states (of any session) past the entry and byte bounds."""
    global _resident_bytes
    with _session_lock:
        nbytes = state.numel() * 4
        sess._states[key] = (w, state)
        _resident[(sess, key)] = nbytes
        _resident_bytes += nbytes
        while len(sess._states) > sess.max_resident:
            _drop(sess, next(iter(sess._states)))
        while _resident_bytes > MAX_RESIDENT_BYTES and _resident:
            _drop(*next(iter(_resident)))


def _drop(sess: "ExecutionSession", key: Tuple) -> None:
    global _resident_bytes
    sess._states.pop(key, None)
    _resident_bytes -= _resident.pop((sess, key), 0)


class ExecutionSession:
    """Persistent crossbar execution for one compiled artifact.

    Resident state is kept per ``(geometry, weight)`` on the operands'
    device — a crossbar array in real PIM *is* a weight matrix, so each
    distinct weight gets its own resident copy (bounded by
    ``max_resident``, LRU-evicted).  The first :meth:`execute` against a
    weight pays a full state upload (a *cold upload*); every later call
    with that weight reuses the post-execution state and writes only the
    activation columns.  Reuse is bit-exact because every dot/matmul
    program INITs each working column before reading it, and never writes
    its operand columns.

    The weight is keyed by its tensor's **identity** — storage pointer,
    offset, shape, strides, dtype, device and ``_version`` — not by its
    bytes: hashing or comparing the bytes of a device tensor would cost a
    pass over the weight (and a host copy) on every call.  An in-place
    change of the weight bumps ``_version`` and so costs a cold upload;
    the session holds a reference to every keyed weight, so a freed
    weight's address cannot be reused by another tensor while its state
    is resident.  An equal weight in another tensor is a different weight
    here (a cold upload), unlike the reference, which compares bytes.

    Inside :func:`transient` a call neither reads nor keeps resident
    state: it writes both operands into a blank state and drops it.

    Resident states are bounded per session by ``max_resident`` entries
    and over all sessions by :data:`MAX_RESIDENT_BYTES`, least recently
    used first.  Counts go to the process-wide ``cache_info`` counters
    (``exec_hits`` / ``exec_uploads`` / ``exec_transient``), one per chunk
    GEMM.  Not thread-safe.
    """

    def __init__(self, artifact: CompiledPim, *, rows_per_crossbar: int = 256,
                 max_resident: int = 1024):
        self.artifact = artifact
        self.rows_per_crossbar = rows_per_crossbar
        self.max_resident = max_resident
        # key -> (weight tensor, resident state)
        self._states: "collections.OrderedDict" = collections.OrderedDict()
        self.uploads = 0
        self.hits = 0
        self.transient = 0

    def _count(self, kind: str, n: int) -> None:
        global _exec_hits, _exec_uploads, _exec_transient
        with _session_lock:
            if kind == "upload":
                _exec_uploads += n
            elif kind == "hit":
                _exec_hits += n
            else:
                _exec_transient += n

    def execute(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Integer GEMM ``(M, K) x (O, K) -> (M, O)`` on resident state.

        Also takes a batch of ``P`` GEMMs of this artifact, ``x`` (P, M, K)
        and ``w`` (P, O, K) -> (P, M, O): all ``P * n_cb`` crossbars run in
        one launch.  Exact for unsigned operands up to
        ``artifact.n_bits`` bits; returns int64 on the operands' device.
        """
        from repro_torch.pim import executor as ex

        art = self.artifact
        rows = self.rows_per_crossbar
        single = x.dim() == 2
        if single:
            x, w = x[None], w[None]
        if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]:
            raise ValueError(f"expected (M, K) x (O, K) or (P, M, K) x "
                             f"(P, O, K), got {tuple(x.shape)} x "
                             f"{tuple(w.shape)}")
        p, m, k = x.shape
        o = w.shape[1]
        if k != w.shape[2]:
            raise ValueError(f"inner dims disagree: x {tuple(x.shape)} vs "
                             f"w {tuple(w.shape)}")
        if k != art.n_terms:
            raise ValueError(
                f"artifact compiled for {art.n_terms} terms, got K={k}")
        if x.device != w.device:
            raise ValueError(f"operands on {x.device} and {w.device}")
        total = m * o
        n_cb = (total + rows - 1) // rows

        x_cols, w_cols, acc_cols = art.columns_on(x.device)
        keep = _transient.depth == 0
        key = (p, n_cb, m, o, _tensor_key(w))
        entry = None
        if keep:
            with _session_lock:
                entry = self._states.get(key)
                if entry is not None:
                    _drop(self, key)     # kept again below, as the MRU
        if entry is None:
            state = ex.blank_state(p * n_cb, art.n_cols, rows,
                                   device=x.device)
            ws = _grid(w.repeat(1, m, 1), n_cb, rows)
            ex.write_numbers(state, w_cols, ws)
        else:
            state = entry[1]
        xs = _grid(x.repeat_interleave(o, dim=1), n_cb, rows)
        ex.write_numbers(state, x_cols, xs)
        state = ex.execute(state, art.microcode_on(x.device))
        if not keep:
            self.transient += p
            self._count("transient", p)
        else:
            _keep(self, key, w, state)
            if entry is None:
                self.uploads += p
                self._count("upload", p)
            else:
                self.hits += p                   # resident weights: x-only
                self._count("hit", p)
        acc = ex.read_numbers(state, acc_cols, rows)
        acc = acc.reshape(p, n_cb * rows)[:, :total].reshape(p, m, o)
        return acc[0] if single else acc


def session_for(artifact: CompiledPim, *, rows_per_crossbar: int = 256
                ) -> ExecutionSession:
    """The process-wide persistent session for ``(artifact,
    rows_per_crossbar)`` — created on first use, then reused so repeated
    GEMMs with the same artifact keep their crossbar state resident.
    ``clear_cache()`` drops all pooled sessions."""
    key = (artifact.key, rows_per_crossbar)
    with _session_lock:
        sess = _sessions.get(key)
        if sess is None:
            sess = ExecutionSession(artifact,
                                    rows_per_crossbar=rows_per_crossbar)
            _sessions[key] = sess
        return sess


def matmul_int(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8, *,
               model: str = "minimal", rows_per_crossbar: int = 256,
               accumulate: str = "carry_save") -> torch.Tensor:
    """Compile-and-execute convenience: bit-exact integer GEMM.

    ``x`` (M, K) and ``w`` (O, K) hold unsigned ints below ``2**n_bits``;
    returns (M, O) int64 on their device.  The compile step is cached.
    Inner dimensions longer than one row's column budget
    (``max_dot_terms``) are zero-padded to whole chunks, and all
    ``ceil(K / chunk)`` chunks run as one batch of GEMMs: one artifact, one
    kernel launch.  Zero terms add nothing, so the partials, summed in
    int64, are exact.  Execution goes through the pooled
    :class:`ExecutionSession` of the artifact, so repeated calls with the
    same ``w`` tensor keep crossbar state resident (the padded weight is
    made once per weight tensor, see :func:`_chunked_weight`).
    """
    from repro_torch.pim.matmul import max_dot_terms

    n_cols = 1024
    chunk = max_dot_terms(n_bits, n_cols)
    if chunk <= 0:
        raise ValueError(f"n_bits={n_bits} does not fit the crossbar layout")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected (M, K) x (O, K), got {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    k = x.shape[1]
    if k > chunk:
        p = -(-k // chunk)
        x = torch.nn.functional.pad(x, (0, p * chunk - k))
        x = x.unflatten(1, (p, chunk)).transpose(0, 1)
        w = _chunked_weight(w, p, chunk)
    artifact = compile_matmul(min(k, chunk), n_bits, model=model,
                              accumulate=accumulate, n_cols=n_cols)
    acc = session_for(artifact, rows_per_crossbar=rows_per_crossbar
                      ).execute(x, w)
    return acc.sum(dim=0) if k > chunk else acc


# zero-padded, chunked weights per weight tensor (identity key, see
# _tensor_key) -> (weight, (P, O, chunk) view).  The cached view's stable
# identity is what keeps the crossbar state resident across calls.
# Bounded LRU.
_chunked: "collections.OrderedDict" = collections.OrderedDict()
_CHUNKED_MAX = 4096


def _chunked_weight(w: torch.Tensor, p: int, chunk: int) -> torch.Tensor:
    """``w`` (O, K) zero-padded to (O, p * chunk), as a (p, O, chunk) view;
    made once per weight tensor."""
    key = (_tensor_key(w), p, chunk)
    hit = _chunked.pop(key, None)
    if hit is None:
        wp = torch.nn.functional.pad(w, (0, p * chunk - w.shape[1]))
        hit = (w, wp.unflatten(1, (p, chunk)).transpose(0, 1))
    _chunked[key] = hit
    while len(_chunked) > _CHUNKED_MAX:
        _chunked.popitem(last=False)
    return hit[1]


# ==========================================================================
# the simulator linear
# ==========================================================================

# quantized weights per weight tensor (identity key, see _tensor_key) ->
# (weight, (offset wq^T, scales, column sums)); the stable identity of the
# cached offset tensor is what keeps the crossbar state resident across
# calls.  Bounded LRU.
_derived: "collections.OrderedDict" = collections.OrderedDict()
_DERIVED_MAX = 4096


def _quantized_weight(w: torch.Tensor, bits: int):
    key = (_tensor_key(w), bits)
    hit = _derived.pop(key, None)
    if hit is None:
        qmax = 2 ** (bits - 1) - 1
        wf = w.detach().to(torch.float32)
        wsc = torch.clamp(torch.amax(torch.abs(wf), dim=0, keepdim=True),
                          min=1e-8) / qmax
        wq = torch.clamp(torch.round(wf / wsc), -qmax, qmax).to(torch.int64)
        # crossbars store magnitudes: the offset operand (wq + qmax + 1)^T
        # lies in [1, 2**bits - 1] and is kept as uint8
        w_off = (wq.T + (qmax + 1)).to(torch.uint8).contiguous()
        hit = (w, (w_off, wsc, wq.sum(dim=0, keepdim=True)))
    _derived[key] = hit
    while len(_derived) > _DERIVED_MAX:
        _derived.popitem(last=False)
    return hit[1]


def _sim_forward(x: torch.Tensor, w: torch.Tensor, bits: int, model: str
                 ) -> torch.Tensor:
    """The host math of the reference's ``_sim_mm`` (``engine.py:806``),
    bit for bit: quantization in float32, the integer GEMM exact, and the
    rescale in float64 (numpy promotes int64 x float32 to float64; torch
    would pick float32, so both sides are cast)."""
    qmax = 2 ** (bits - 1) - 1
    off = qmax + 1
    lead = x.shape[:-1]
    k = x.shape[-1]
    xf = x.detach().to(torch.float32).reshape(-1, k)
    xs = torch.clamp(torch.amax(torch.abs(xf), dim=1, keepdim=True),
                     min=1e-8) / qmax
    xq = torch.clamp(torch.round(xf / xs), -qmax, qmax).to(torch.int64)
    w_off, wsc, wq_sum = _quantized_weight(w, bits)
    # 2's-complement offset: shift into unsigned, multiply, correct
    # ((a+off)(b+off))
    acc = matmul_int((xq + off).to(torch.uint8), w_off, n_bits=bits + 1,
                     model=model)
    corr = off * (wq_sum + off * k) + off * xq.sum(dim=1, keepdim=True)
    y = (acc - corr).to(torch.float64) * (xs * wsc).to(torch.float64)
    return y.reshape(*lead, w.shape[1]).to(x.dtype)


class _SimLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bits, model):
        ctx.save_for_backward(x, w)
        return _sim_forward(x, w, bits, model)

    @staticmethod
    def backward(ctx, g):
        # straight-through estimator: the forward is the quantized crossbar
        # result, the backward differentiates the ideal float matmul
        x, w = ctx.saved_tensors
        gx = (g @ w.to(g.dtype).T).to(x.dtype)
        gw = (x.reshape(-1, x.shape[-1]).to(g.dtype).T
              @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None, None


def sim_linear(x: torch.Tensor, w: torch.Tensor, bits: int = 7, *,
               model: str = "minimal") -> torch.Tensor:
    """Bit-exact crossbar execution of ``x @ w`` (x: (..., K), w: (K, N)).

    7-bit symmetric quantization so the offset-shifted unsigned operands
    fit the 8-bit (power-of-two partition count) MultPIM multiplier.  The
    GEMM runs on the crossbar simulator on the operands' device — the CUDA
    crossbar kernel for CUDA tensors, its plain version on the CPU — with
    the weight's crossbar state resident across calls (see
    :class:`ExecutionSession` for how the weight is keyed).
    Differentiable through a straight-through backward (the gradient of
    the ideal matmul), so a ``pim_sim`` model trains.
    """
    return _SimLinear.apply(x, w, bits, model)
