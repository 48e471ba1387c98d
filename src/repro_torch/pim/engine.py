"""Compile-once / execute-many front-end for the PIM stack.

The driving side of the partitioned crossbar, as one API:

* :func:`compile_dot` / :func:`compile_matmul` — build (once) and cache a
  :class:`CompiledPim` artifact: the gate program, its flat microcode, and
  the I/O column layout, keyed on
  ``(n_terms, n_bits, model, accumulate, n_cols)``.  Repeated calls with
  the same key return the *same* artifact without rebuilding (program
  construction is the expensive Python part — thousands of gate appends).
* :func:`execute` / :func:`execute_state` / :func:`build_multiplier` — one
  registry of backends, each tagged with its kind.  A ``"state"`` backend
  maps ``(crossbar_state, microcode) -> state``; a ``"mult"`` backend maps
  ``(n_bits, n_cols) -> multiplier build``; a ``"linear"`` backend maps
  ``(x, w) -> y`` (``quant_tp``).  Picking a name of the wrong kind at a
  dispatch point is a clear error:

  ============  ======  ===================================================
  backend       kind    what it runs
  ============  ======  ===================================================
  cuda          state   the CUDA crossbar kernel; raises on a non-CUDA
                        state (the counterpart of the reference's
                        ``pallas``, which the port does not register)
  scan / jnp    state   ``crossbar_exec_ref``, the per-gate oracle
  unrolled      state   ``executor.execute_unrolled``, static indices
  numpy         state   a numpy interpreter over uint32 words
                        (these host oracles raise on a CUDA state)
  quant_tp      linear  ``kernels.quant_matmul.tp.tp_quant_linear``: the
                        int8 GEMM in per-rank tiles over the active
                        mesh's ``"model"`` axis (``quant`` without one)
  serial        mult    the paper's optimized serial NOR multiplier
  serial_fast   mult    the 7-gate NAND/OR/AND full-adder variant
  compressor42  mult    the 4:2 two-rows-per-pass variant
  ============  ======  ===================================================

  :func:`register_backend` adds more; a custom backend never hides the
  defaults.
* :class:`ExecutionSession` / :func:`session_for` — persistent execution:
  crossbar state stays resident on the operands' device across calls,
  keyed per (geometry, weight) — a crossbar array in real PIM *is* a
  weight matrix — so repeated GEMMs write only the *activation* columns
  while the weights stay resident (weight-stationary operation; a
  program's microcode re-INITs every working column it reads and never
  writes operand columns, so reuse is bit-exact).  The state runs on the
  CUDA crossbar kernel for a CUDA tensor and on its plain version for a
  CPU tensor (``kernels.crossbar_exec``), unless the session names a
  registered state backend.  Resident state is bounded in bytes per
  session namespace (:data:`MAX_RESIDENT_BYTES`, LRU).  The weights'
  derived copies (the quantized offset operand, the zero-padded chunks)
  are cached per weight, bounded in bytes too (:data:`MAX_DERIVED_BYTES`,
  :data:`MAX_CHUNKED_BYTES`).  No cache holds a caller's weight: each
  entry keyed on a tensor goes when that tensor's storage is freed, and
  with it everything derived from it (see :func:`_bind`).
* :func:`draft_ctx` / :func:`current_session_ns` — the ``"draft"``
  session namespace of a speculative drafting pass
  (``serving.speculative``): its sessions share the compiled artifacts
  but keep their own resident state under their own byte bound, so a
  drafting pass can never evict the verify path's resident crossbars.
* :func:`transient` — a context in which every GEMM runs on a fresh
  state that is dropped after the call.  The model's prefill entry points
  enter it: a prompt's row count M is a one-off shape, and one M's
  states for every linear of a full-width model come to about M GiB, so
  only the decode step (whose M is fixed) keeps state resident.
* :func:`matmul_int` — the exact integer GEMM over the session pool, with
  inner dimensions longer than one row's column budget split into chunks
  and the last chunk zero-padded to a whole one; all chunks run as one
  batch of crossbars, so a linear costs one kernel launch, or one per
  piece where its crossbars would take more than :data:`MAX_LAUNCH_BYTES`
  (:func:`launch_pieces`): a launch's memory is a constant of the engine,
  not a function of M and K.  ``plan=`` (a
  ``pim.autotune.TunedPlan``) or ``tune_ctx=`` (a table lookup) picks the
  partition model, crossbar geometry, chunk and backend; the bits are the
  same under every plan.  ``cache_info()`` carries the tuner's counters,
  and ``clear_cache()`` clears its table.
* :func:`capture_context` — the calling thread's mode, namespace and
  transient flag as one context manager, re-entered where a checkpointed
  block is recomputed during ``backward()`` (another thread on a card).
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
step is bit-identical per row to a single-row one.  The lowerings do not
all quantize alike: ``"quant"`` rounds to 8 bits and ``"pim_sim"`` to 7
(:func:`sim_linear`), so a ``"quant"`` draft for a ``"pim_sim"`` verify is
not bit-equal to it, and how many of its drafts are accepted has to be
measured.  Every pairing stays exact, because a rejected draft is decoded
again by the verify mode.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.trace import span

__all__ = [
    "MODES",
    "CompiledPim",
    "CacheInfo",
    "compile_dot",
    "compile_matmul",
    "cache_info",
    "clear_cache",
    "BACKEND_KINDS",
    "register_backend",
    "get_backend",
    "backend_kind",
    "backends",
    "build_multiplier",
    "execute",
    "execute_state",
    "ExecutionSession",
    "MAX_RESIDENT_BYTES",
    "MAX_LAUNCH_BYTES",
    "launch_bytes",
    "launch_pieces",
    "session_for",
    "transient",
    "matmul_int",
    "sim_linear",
    "mode",
    "current_mode",
    "resolve_mode",
    "draft_ctx",
    "current_session_ns",
    "capture_context",
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


class _NsStack(threading.local):
    def __init__(self):
        self.frames = []


_ns_stack = _NsStack()


@contextlib.contextmanager
def draft_ctx(name: Optional[str] = None) -> Iterator[Optional[str]]:
    """Context for a speculative *drafting* pass.

    Drafting runs a second, cheaper lowering next to the verify path's in
    the same process.  Both share the compiled-artifact cache, but not
    resident :class:`ExecutionSession` state: inside this context
    :func:`sim_linear` (and any caller that passes
    :func:`current_session_ns` to :func:`session_for` / :func:`matmul_int`)
    uses the ``"draft"``-namespaced session pool, whose states are bounded
    apart from the verify path's, so a drafting pass can never evict a
    verify crossbar.  ``name`` optionally selects the draft's lowering mode
    as well (``draft_ctx("quant")`` is ``mode("quant")`` plus the
    namespace).  Re-entrant, exception-safe and thread local.
    """
    _ns_stack.frames.append("draft")
    try:
        if name is None:
            yield None
        else:
            with mode(name):
                yield name
    finally:
        _ns_stack.frames.pop()


def current_session_ns() -> str:
    """``"draft"`` inside :func:`draft_ctx`, else ``""`` (the verify and
    default session namespace)."""
    return _ns_stack.frames[-1] if _ns_stack.frames else ""


def capture_context():
    """A context manager that re-enters, later and on any thread, the
    calling thread's lowering context as it is now: its :func:`mode`, its
    session namespace and whether GEMMs run on :func:`transient` state.

    The mode, the namespace and the transient flag are thread locals read
    when a linear runs.  ``torch.utils.checkpoint`` runs a block again
    during ``backward()``: after the caller's ``with`` blocks have closed
    and, for CUDA tensors, on autograd's device thread, which sees none of
    the caller's thread locals.  ``models.model`` hands the recompute this
    context (the checkpoint's ``context_fn``), so the recomputed linears
    lower as the forward's did.  The active mesh (``dist.context``) is a
    thread local too and comes back with them."""
    from repro_torch.dist import context as dctx

    m, ns, tr = current_mode(), current_session_ns(), _transient.depth > 0
    mesh, dp = dctx.current_mesh(), dctx.dp_axes()

    @contextlib.contextmanager
    def reenter() -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                stack.enter_context(dctx.use_mesh(mesh, dp_axes=dp))
            stack.enter_context(mode(m))
            if ns:
                _ns_stack.frames.append(ns)
                stack.callback(_ns_stack.frames.pop)
            if tr:
                stack.enter_context(transient())
            yield

    return reenter()


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
    # winning autotune.TunedPlan, attached (object.__setattr__) by the tuner
    # when this artifact is the picked configuration for its compile key;
    # None until tuned.  Not part of the cache key.
    plan: Optional["object"] = None

    @property
    def n_cols(self) -> int:
        return self.program.cfg.n

    def _on(self, device) -> Tuple[torch.Tensor, ...]:
        device = torch.device(device)
        hit = self._device_copies.get(device)
        if hit is None:
            hit = tuple(torch.as_tensor(a, dtype=torch.int32).to(device)
                        .contiguous()
                        for a in (self.microcode, self.x_cols, self.w_cols,
                                  self.acc_cols))
            self._device_copies[device] = hit
        return hit

    def microcode_on(self, device) -> torch.Tensor:
        """The (G, 4) int32 microcode as a tensor on ``device`` (cached)."""
        return self._on(device)[0]

    def columns_on(self, device) -> Tuple[torch.Tensor, ...]:
        """``(x_cols, w_cols, acc_cols)`` as int32 tensors on ``device``
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
    # the weights' cached derived copies: quantized offset operands
    # (``derived``) and zero-padded chunked copies (``chunked``)
    derived_entries: int = 0
    derived_bytes: int = 0
    chunked_entries: int = 0
    chunked_bytes: int = 0
    # autotuner counters (pim.autotune): table lookups served from a cached
    # pick vs searches run, and how many timed candidate trials those
    # searches spent.
    tune_hits: int = 0
    tune_misses: int = 0
    tune_trials: int = 0


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
    from repro_torch.pim import autotune

    with _cache_lock:
        info = CacheInfo(hits=_hits, misses=_misses, builds=_builds,
                         size=len(_cache))
    with _session_lock:
        info = dataclasses.replace(info, exec_hits=_exec_hits,
                                   exec_uploads=_exec_uploads,
                                   exec_transient=_exec_transient,
                                   resident_entries=sum(
                                       len(lru) for lru in _resident.values()),
                                   resident_bytes=sum(
                                       _resident_bytes.values()),
                                   derived_entries=len(_derived),
                                   derived_bytes=_cached_bytes["derived"],
                                   chunked_entries=len(_chunked),
                                   chunked_bytes=_cached_bytes["chunked"])
    t = autotune.table_info()
    return dataclasses.replace(info, tune_hits=t.hits, tune_misses=t.misses,
                               tune_trials=t.trials)


def clear_cache() -> None:
    global _hits, _misses, _builds, _exec_hits, _exec_uploads, \
        _exec_transient
    from repro_torch.pim import autotune

    with _cache_lock:
        _cache.clear()
        _hits = _misses = _builds = 0
    with _session_lock:
        for lru in list(_resident.values()):
            for sess, key in list(lru):
                _drop(sess, key)
        _resident.clear()
        _resident_bytes.clear()
        _sessions.clear()
        _exec_hits = _exec_uploads = _exec_transient = 0
        for name, cache in _weight_caches.items():
            while cache:
                _forget(name, next(iter(cache)))
    # picks must not leak across runs: the tuner table (and its counters)
    # clears with the compile cache it indexes into
    autotune.clear()


# ==========================================================================
# backend registry
# ==========================================================================

# A "state" backend maps (state, microcode, **kw) -> new state, where state
# is the bit-packed (C, n, W) int32 crossbar tensor and microcode the (G, 4)
# rows (a tensor or an array); a "mult" backend maps (n_bits, n_cols, **kw)
# -> a built multiplier (program + I/O columns); "linear" is the kind of a
# linear lowering (x, w) -> y.  One registry, tagged kinds: picking a name
# of the wrong kind at a dispatch point is a clear error, not a shape
# explosion deep in a kernel.
Backend = Callable[..., "object"]

BACKEND_KINDS = ("state", "linear", "mult")

_backends: Dict[str, Backend] = {}
_backend_kinds: Dict[str, str] = {}
_backends_lock = threading.Lock()


def register_backend(name: str, fn: Backend, *, kind: str = "state") -> None:
    if kind not in BACKEND_KINDS:
        raise ValueError(f"backend kind must be one of {BACKEND_KINDS}, "
                         f"got {kind!r}")
    with _backends_lock:
        _backends[name] = fn
        _backend_kinds[name] = kind


_defaults_registered = False


def _microcode_tensor(microcode, device) -> torch.Tensor:
    if isinstance(microcode, torch.Tensor):
        return microcode.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(microcode), dtype=torch.int32,
                           device=device)


def _microcode_array(microcode) -> np.ndarray:
    if isinstance(microcode, torch.Tensor):
        microcode = microcode.cpu()
    return np.asarray(microcode)


def _host_only(name: str, state) -> None:
    """The oracles run on the host: a CUDA state is an error, as a CPU
    state is for ``cuda``, never a reason to copy the card's work there."""
    if state.device.type == "cuda":
        raise ValueError(f"backend {name!r} is a host oracle and needs a CPU "
                         f"state; a CUDA state runs on 'cuda'")


def _cuda(state, microcode, **kw):
    """The CUDA crossbar kernel; a state off the card is an error, not a
    reason to run something else."""
    from repro_torch.kernels.crossbar_exec import crossbar_exec

    if state.device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs the CUDA crossbar kernel and "
                         f"needs a CUDA state; got a state on {state.device}")
    return crossbar_exec(state.contiguous(),
                         _microcode_tensor(microcode, state.device))


def _scan(state, microcode, **kw):
    from repro_torch.kernels.crossbar_exec import crossbar_exec_ref

    _host_only("scan", state)
    return crossbar_exec_ref(state, _microcode_tensor(microcode, "cpu"))


def _unrolled(state, microcode, **kw):
    from repro_torch.pim import executor as ex

    _host_only("unrolled", state)
    return ex.execute_unrolled(state, _microcode_array(microcode))


def _numpy_interpret(state, microcode, **kw):
    """Numpy microcode interpreter over the reference's uint32 words.

    Takes and returns the port's int32 state tensor (on its device); the
    loop itself runs on the host, gate codes as ``GATE_CODES``."""
    _host_only("numpy", state)
    st = state.detach().cpu().numpy().view(np.uint32).copy()
    ones = np.uint32(0xFFFFFFFF)
    for code, ia, ib, out in _microcode_array(microcode).tolist():
        a = st[:, ia, :]
        b = st[:, ib, :]
        if code == 0:                       # INIT
            res = np.full_like(a, ones)
        elif code == 1:                     # NOT
            res = ~a
        elif code == 2:                     # NOR
            res = ~(a | b)
        elif code == 3:                     # OR
            res = a | b
        elif code == 4:                     # NAND
            res = ~(a & b)
        else:                               # AND
            res = a & b
        st[:, out, :] = res
    return torch.from_numpy(st.view(np.int32)).to(state.device)


def _quant_tp(x, w, **kw):
    """The tensor-parallel linear lowering: operands are (x, w) float
    tensors, not crossbar state.  ``models.layers.linear`` dispatches mode
    ``"quant_tp"`` here; the tiles split over the active mesh's
    ``"model"`` axis at the call."""
    from repro_torch.kernels.quant_matmul.tp import tp_quant_linear

    return tp_quant_linear(x, w, **kw)


def _ensure_default_backends() -> None:
    global _defaults_registered
    if _defaults_registered:
        return
    from repro_torch.pim.compressor42 import build_compressor42_multiplier
    from repro_torch.pim.mult_serial import build_serial_multiplier
    from repro_torch.pim.mult_serial_fast import build_fast_serial_multiplier

    with _backends_lock:
        for nm, fn, kind in (("cuda", _cuda, "state"),
                             ("scan", _scan, "state"),
                             ("jnp", _scan, "state"),  # the reference's alias
                             ("unrolled", _unrolled, "state"),
                             ("numpy", _numpy_interpret, "state"),
                             ("quant_tp", _quant_tp, "linear"),
                             ("serial", build_serial_multiplier, "mult"),
                             ("serial_fast", build_fast_serial_multiplier,
                              "mult"),
                             ("compressor42", build_compressor42_multiplier,
                              "mult")):
            _backends.setdefault(nm, fn)
            _backend_kinds.setdefault(nm, kind)
        # only after everything registered: a failed import above leaves the
        # flag unset so the next call retries
        _defaults_registered = True


def get_backend(name: str) -> Backend:
    _ensure_default_backends()
    with _backends_lock:
        fn = _backends.get(name)
    if fn is None:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {sorted(_backends)}")
    return fn


def backends() -> Tuple[str, ...]:
    _ensure_default_backends()
    with _backends_lock:
        return tuple(sorted(_backends))


def backend_kind(name: str) -> str:
    """``"state"``, ``"linear"`` or ``"mult"`` (see the registry comment
    above)."""
    _ensure_default_backends()
    with _backends_lock:
        if name not in _backends:
            raise ValueError(f"unknown backend {name!r}; "
                             f"registered: {sorted(_backends)}")
        return _backend_kinds.get(name, "state")


def execute_state(state, microcode, *, backend: str = "scan", **kw):
    """Run flat microcode over raw crossbar state on the chosen backend."""
    kind = backend_kind(backend)
    if kind != "state":
        what = ("a linear lowering" if kind == "linear"
                else "a multiplier algorithm")
        raise ValueError(
            f"backend {backend!r} is {what}, not a crossbar-state "
            f"executor; it cannot run microcode")
    return get_backend(backend)(state, microcode, **kw)


def build_multiplier(name: str, n_bits: int, *, n_cols: int = 1024, **kw):
    """Build (uncached) a registered multiplier algorithm by name.

    Dispatches ``kind="mult"`` registry entries.  Guarded like
    :func:`execute_state`: a state or linear backend name is a clear error.
    """
    kind = backend_kind(name)
    if kind != "mult":
        raise ValueError(
            f"backend {name!r} is a {kind!r} backend, not a multiplier "
            f"algorithm; it cannot build a gate program")
    return get_backend(name)(n_bits, n_cols, **kw)


# ==========================================================================
# execution front-end
# ==========================================================================

def _tensor_key(t: torch.Tensor) -> Tuple:
    """Identity of a tensor's contents: storage, view geometry, dtype,
    device and in-place version.  An entry keyed on it must not outlive
    ``t``'s storage, or a later tensor at the freed address would find it:
    :func:`_bind` drops the entry when the storage is freed."""
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


def _bit_kernels(x, w, art: CompiledPim) -> bool:
    """Whether :meth:`ExecutionSession.execute` packs its operands and reads
    its accumulators through ``kernels.pim_bits``: for a CUDA state,
    uint8 operands, at most 8 bits a term and 63 accumulator bits.  Else it
    takes ``executor.write_numbers`` / ``read_numbers``."""
    from repro_torch.kernels.pim_bits import MAX_ACC_BITS, MAX_BITS

    return (x.device.type == "cuda" and x.dtype == w.dtype == torch.uint8
            and max(map(len, art.x_cols + art.w_cols)) <= MAX_BITS
            and len(art.acc_cols) <= MAX_ACC_BITS)


def _operand_rows(v: torch.Tensor, lo: int, hi: int, n_cb: int, rows: int,
                  m: int, o: int, of_x: bool) -> torch.Tensor:
    """The operand rows of crossbars ``[lo, hi)`` of a batch of GEMMs,
    ``x`` (P, M, K) or ``w`` (P, O, K), as (hi - lo, rows, K): row ``r`` of
    chunk ``q`` is ``x[q, r // o]`` against ``w[q, r % o]``, and rows past
    M * O are zero.  ``[lo, hi)`` is a run of whole chunks or a part of one
    (:func:`launch_pieces`), so only its own rows are ever built."""
    if lo % n_cb == 0 and hi % n_cb == 0:
        part = v[lo // n_cb:hi // n_cb]
        part = (part.repeat_interleave(o, dim=1) if of_x
                else part.repeat(1, m, 1))
        return _grid(part, n_cb, rows)
    q, first = divmod(lo, n_cb)
    r = torch.arange(first * rows, min((first + hi - lo) * rows, m * o),
                     device=v.device)
    part = v[q, r // o] if of_x else v[q, r % o]
    return _grid(part[None], hi - lo, rows)


_sessions: Dict[Tuple, "ExecutionSession"] = {}
# re-entrant: freeing a tensor inside a critical section can run the
# finalizer of an entry bound to it (_bind), which takes the lock again
_session_lock = threading.RLock()
_exec_hits = 0
_exec_uploads = 0
_exec_transient = 0

#: Bound on the bytes of resident crossbar state over the sessions of one
#: namespace (``state.numel() * 4`` per entry), least recently used
#: evicted first.  8 GiB holds the decode-step states of every linear of
#: full-width qwen1.5-0.5b (about 1 GiB per decode row) up to batch 8.
MAX_RESIDENT_BYTES = 8 << 30
#: Bound on the bytes one crossbar launch takes on its device, reckoned on
#: the host by :func:`launch_bytes`: a GEMM whose crossbars take more runs
#: as several launches over contiguous ranges of them
#: (:func:`launch_pieces`).  At 1024 columns, 37 8-bit terms and 256 rows
#: a crossbar is reckoned at 272,640 B, so a launch holds up to 47,259
#: crossbars: the decode steps' linears of every configuration run in one
#: launch (granite-20b's w_in at batch 2, the largest, is 32,064
#: crossbars, 8.74 GB), while long transient prefills split, among them
#: llama-3.2-vision-11b's xwk over 1601 patches (710,844 crossbars).
MAX_LAUNCH_BYTES = 12 << 30
# every resident state per session namespace, in LRU order:
# namespace -> {(session, key): bytes}, and the bytes of each namespace
_resident: Dict[str, "collections.OrderedDict"] = {}
_resident_bytes: Dict[str, int] = {}


def launch_bytes(n_cols: int, n_terms: int, acc_bits: int,
                 rows: int = 256, itemsize: int = 1) -> int:
    """The bytes one crossbar of a launch takes at most, by host
    arithmetic: its state in and the kernel's state out (``n_cols`` columns
    of ``ceil(rows / 32)`` 32-bit words each); its two operands' rows of
    ``n_terms`` values of ``itemsize`` bytes, each built and then padded to
    whole crossbars, with two int64 row numbers a row; and the larger of
    the writer's and the reader's temporaries.  ``executor._pack_bit``
    holds a bit plane as int64 and its shifted words (``rows * n_terms``
    int64 each) beside four word-sized sums; ``executor.read_numbers``
    holds the ``acc_bits`` accumulator bits of each row as bool and int64,
    their weighted values as int64, and their sum."""
    words = -(-rows // 32)
    padded = 32 * words
    state = n_cols * words * 4
    operands = 2 * (2 * padded * n_terms * itemsize + 2 * 8 * padded)
    pack = 2 * padded * n_terms * 8 + 4 * words * n_terms * 8
    read = acc_bits * padded * (1 + 2 * 8) + 8 * padded
    return 2 * state + operands + max(pack, read)


def launch_pieces(p: int, n_cb: int, per_crossbar: int,
                  budget: Optional[int] = None) -> List[Tuple[int, int]]:
    """Split a batch of ``p`` chunk GEMMs of ``n_cb`` crossbars each into
    launches under ``budget`` bytes (default :data:`MAX_LAUNCH_BYTES`),
    ``per_crossbar`` bytes a crossbar (:func:`launch_bytes`).  Returns
    contiguous, disjoint ``[lo, hi)`` ranges of the ``p * n_cb`` crossbars
    that cover each once, in order: one range when all fit; else runs of
    whole chunks, as many as fit, balanced; else, when one chunk does not
    fit, each chunk in balanced parts.  Raises when one crossbar does not
    fit."""
    budget = MAX_LAUNCH_BYTES if budget is None else budget
    cap = budget // per_crossbar
    if cap < 1:
        raise ValueError(f"one crossbar takes {per_crossbar} B, over the "
                         f"launch budget of {budget} B")
    if p * n_cb <= cap:
        return [(0, p * n_cb)]
    if n_cb <= cap:
        n = -(-p // (cap // n_cb))
        size = -(-p // n) * n_cb
        return [(lo, min(lo + size, p * n_cb))
                for lo in range(0, p * n_cb, size)]
    n = -(-n_cb // cap)
    size = -(-n_cb // n)
    return [(q * n_cb + lo, q * n_cb + min(lo + size, n_cb))
            for q in range(p) for lo in range(0, n_cb, size)]


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


class _Entry:
    """One cache entry keyed on a tensor's identity: ``value`` (never the
    keyed tensor itself), its bytes, and the finalizer that drops it when
    that tensor's storage is freed (:func:`_bind`)."""

    __slots__ = ("value", "nbytes", "fin", "__weakref__")

    def __init__(self, value, nbytes: int):
        self.value = value
        self.nbytes = nbytes
        self.fin = None


def _bind(t: torch.Tensor, entry: _Entry, expire: Callable, owner,
          key: Tuple) -> None:
    """End ``entry`` with ``t``'s storage: once the storage is freed,
    ``expire(owner, key, ref)`` drops the entry, if the entry under
    ``key`` is still this one (``ref`` is a weak reference to it, so a
    newer entry at a reused address is never dropped).  Nothing holds
    ``t``; whoever removes the entry first detaches the finalizer.  A
    dropped entry releases its value, and so ends every entry bound to a
    tensor in it: a chunked copy made from a quantized weight, the
    resident states keyed on either."""
    entry.fin = weakref.finalize(t.untyped_storage(), expire, owner, key,
                                 weakref.ref(entry))


def _expire_state(sess_ref, key: Tuple, ref) -> None:
    with _session_lock:
        sess, entry = sess_ref(), ref()
        if sess is not None and entry is not None \
                and sess._states.get(key) is entry:
            _drop(sess, key)


def _keep(sess: "ExecutionSession", key: Tuple, w: torch.Tensor,
          state: torch.Tensor) -> None:
    """Make ``state`` resident under ``key`` (bound to ``w``'s storage)
    and evict least recently used states past the session's entry bound
    and its namespace's byte bound.  Only states of the session's own
    namespace are evicted, so a drafting pass (namespace ``"draft"``)
    never drops a verify state."""
    ns = sess.namespace
    with _session_lock:
        lru = _resident.setdefault(ns, collections.OrderedDict())
        entry = sess._states.get(key)
        if entry is not None:            # a hit: now the most recent
            entry.value = state
            sess._states.move_to_end(key)
            lru.move_to_end((sess, key))
            return
        entry = _Entry(state, state.numel() * 4)
        _bind(w, entry, _expire_state, weakref.ref(sess), key)
        sess._states[key] = entry
        lru[(sess, key)] = entry.nbytes
        _resident_bytes[ns] = _resident_bytes.get(ns, 0) + entry.nbytes
        while len(sess._states) > sess.max_resident:
            _drop(sess, next(iter(sess._states)))
        while _resident_bytes[ns] > MAX_RESIDENT_BYTES and lru:
            _drop(*next(iter(lru)))


def _drop(sess: "ExecutionSession", key: Tuple) -> None:
    entry = sess._states.pop(key, None)
    if entry is None:
        return
    entry.fin.detach()
    _resident[sess.namespace].pop((sess, key), None)
    _resident_bytes[sess.namespace] -= entry.nbytes


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
    change of the weight bumps ``_version`` and so costs a cold upload.
    The session does not hold the weight: its state is dropped when the
    weight's storage is freed (:func:`_bind`), so a dropped model keeps no
    state, and a later tensor at the freed address never finds it.  An
    equal weight in another tensor is a different weight here (a cold
    upload), unlike the reference, which compares bytes.

    Inside :func:`transient` a call neither reads nor keeps resident
    state: it writes both operands into a blank state and drops it.

    ``backend`` names a registered state backend to run the microcode on;
    ``None`` (the default) runs the device's own: the CUDA kernel for a
    CUDA state, its grouped plain version for a CPU state.

    Resident states are bounded per session by ``max_resident`` entries
    and over the sessions of one ``namespace`` by
    :data:`MAX_RESIDENT_BYTES`, least recently used first.  Counts go to
    the process-wide ``cache_info`` counters (``exec_hits`` /
    ``exec_uploads`` / ``exec_transient``), one per chunk GEMM.  Not
    thread-safe.
    """

    def __init__(self, artifact: CompiledPim, *,
                 backend: Optional[str] = None, rows_per_crossbar: int = 256,
                 max_resident: int = 1024, namespace: str = ""):
        if backend is not None and backend_kind(backend) != "state":
            raise ValueError(f"backend {backend!r} is not a crossbar-state "
                             "executor")
        self.artifact = artifact
        self.backend = backend
        self.namespace = namespace
        self.rows_per_crossbar = rows_per_crossbar
        self.max_resident = max_resident
        # key -> _Entry(resident state), bound to the keyed weight
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
        one launch, or, past :data:`MAX_LAUNCH_BYTES`, in one launch per
        piece (:func:`launch_pieces`), each piece packing only its own
        operand rows.  A transient piece's state is dropped after its
        read; a resident state stays one tensor, its pieces run on slices
        of it.  Exact for unsigned operands up to ``artifact.n_bits`` bits;
        returns int64 on the operands' device.  On a CUDA state with uint8
        operands the operands are written and the accumulators read by
        ``kernels.pim_bits`` (:func:`_bit_kernels`), straight from ``x`` and
        ``w``; otherwise by ``executor.write_numbers`` over
        :func:`_operand_rows` and ``executor.read_numbers``: the same bits.
        """
        from repro_torch.kernels import pim_bits
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
        pieces = launch_pieces(p, n_cb, launch_bytes(
            art.n_cols, k, len(art.acc_cols), rows,
            max(x.element_size(), w.element_size())))

        x_cols, w_cols, acc_cols = art.columns_on(x.device)
        mc = art.microcode_on(x.device)
        keep = _transient.depth == 0
        key = (p, n_cb, m, o, _tensor_key(w))
        entry = None
        if keep:
            with _session_lock:
                entry = self._states.get(key)
        if entry is not None:
            state = entry.value
        elif keep:
            state = ex.blank_state(p * n_cb, art.n_cols, rows,
                                   device=x.device)
        else:
            state = None                 # transient: a state per piece

        write_back = keep and len(pieces) > 1
        on_card = _bit_kernels(x, w, art)

        def write(part, v, cols, lo, hi, of_x):
            if on_card:
                pim_bits.write_operand(part, v, cols, lo, hi, n_cb, rows, m,
                                       o, of_x)
            else:
                ex.write_numbers(part, cols, _operand_rows(
                    v, lo, hi, n_cb, rows, m, o, of_x))

        def read(new, out=None):
            if on_card:
                return pim_bits.read_accumulators(new, acc_cols, rows, out)
            got = ex.read_numbers(new, acc_cols, rows)
            return got if out is None else out.copy_(got)

        def launch(lo, hi):
            """Pack, run and (a resident piece) write back crossbars
            ``[lo, hi)``; returns their state after the program."""
            with span("pim.pack"):
                part = (ex.blank_state(hi - lo, art.n_cols, rows,
                                       device=x.device)
                        if state is None else state[lo:hi])
                if entry is None:
                    write(part, w, w_cols, lo, hi, of_x=False)
                write(part, x, x_cols, lo, hi, of_x=True)
            with span("pim.exec"):
                if self.backend is None:
                    new = ex.execute(part, mc)
                else:
                    new = execute_state(part, mc, backend=self.backend)
                if write_back:
                    part.copy_(new)
            return new

        def shaped(acc):
            return acc.reshape(p, n_cb * rows)[:, :total].reshape(p, m, o)

        if len(pieces) == 1:
            new = launch(0, p * n_cb)
            if keep:
                state = new
            with span("pim.read"):
                acc = shaped(read(new))
            del new
        else:
            acc = torch.empty((p * n_cb, rows), dtype=torch.int64,
                              device=x.device)
            for lo, hi in pieces:
                new = launch(lo, hi)
                with span("pim.read"):
                    read(new, acc[lo:hi])
                del new
            with span("pim.read"):
                acc = shaped(acc)
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
        return acc[0] if single else acc


def session_for(artifact: CompiledPim, *, backend: Optional[str] = None,
                rows_per_crossbar: int = 256,
                max_resident: Optional[int] = None,
                namespace: str = "") -> ExecutionSession:
    """The process-wide persistent session for ``(artifact, backend,
    rows_per_crossbar, namespace)`` — created on first use, then reused so
    repeated GEMMs with the same artifact keep their crossbar state
    resident.  ``max_resident`` applies on creation (and raises the cap of
    an existing session).  ``namespace`` partitions the pool and its byte
    bound: a speculative drafting pass runs under ``"draft"`` (see
    :func:`draft_ctx`) so its uploads can never evict the verify path's
    resident state.  ``clear_cache()`` drops all pooled sessions."""
    key = (artifact.key, backend, rows_per_crossbar, namespace)
    with _session_lock:
        sess = _sessions.get(key)
        if sess is None:
            sess = ExecutionSession(
                artifact, backend=backend,
                rows_per_crossbar=rows_per_crossbar, namespace=namespace,
                **({} if max_resident is None
                   else {"max_resident": max_resident}))
            _sessions[key] = sess
        elif max_resident is not None:
            sess.max_resident = max(sess.max_resident, max_resident)
        return sess


def execute(artifact: CompiledPim, x: torch.Tensor, w: torch.Tensor, *,
            backend: Optional[str] = None, rows_per_crossbar: int = 256
            ) -> torch.Tensor:
    """One-shot integer GEMM ``(M, K) x (O, K) -> (M, O)`` int64 on a fresh
    crossbar state that is dropped after the call (counted as transient).
    Callers that run one artifact repeatedly should hold an
    :class:`ExecutionSession` (or go through :func:`session_for` /
    :func:`matmul_int`, which pool sessions) instead."""
    sess = ExecutionSession(artifact, backend=backend,
                            rows_per_crossbar=rows_per_crossbar)
    with transient():
        return sess.execute(x, w)


def matmul_int(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8, *,
               model: str = "minimal", rows_per_crossbar: int = 256,
               backend: Optional[str] = None, accumulate: str = "carry_save",
               plan: Optional["object"] = None,
               tune_ctx: Optional[str] = None,
               session_ns: str = "") -> torch.Tensor:
    """Compile-and-execute convenience: bit-exact integer GEMM.

    ``x`` (M, K) and ``w`` (O, K) hold unsigned ints below ``2**n_bits``;
    returns (M, O) int64 on their device.  The compile step is cached.
    Inner dimensions longer than one row's column budget
    (``max_dot_terms``) are zero-padded to whole chunks, and all
    ``ceil(K / chunk)`` chunks run as one batch of GEMMs: one artifact, one
    kernel launch, or one per piece past :data:`MAX_LAUNCH_BYTES`.  Zero
    terms add nothing, so the partials, summed in int64, are exact and the
    same bits as the reference's per-chunk loop.  Execution goes through
    the pooled :class:`ExecutionSession` of the artifact, so repeated calls
    with the same ``w`` tensor keep crossbar state resident (the padded
    weight is made once per weight tensor and chunk, see
    :func:`_chunked_weight`).

    ``plan`` (an ``autotune.TunedPlan``) overrides model / crossbar
    geometry / chunking / execution backend with a tuned pick; passing
    ``tune_ctx`` (a pim-mode string, e.g. ``"pim_sim"``) instead looks the
    plan up in the autotuner table when tuning is enabled — a miss keeps
    the defaults, it never triggers a search.  Every configuration
    computes the same exact integer GEMM, in the same pieces rule, so
    plans change speed, never results.

    ``backend`` names a registered state backend (``None``: the device's
    own, see :class:`ExecutionSession`); ``session_ns`` routes execution to
    a namespaced session pool (see :func:`draft_ctx`).
    """
    from repro_torch.pim.matmul import max_dot_terms

    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected (M, K) x (O, K), got {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    k = x.shape[1]
    if plan is None and tune_ctx is not None:
        from repro_torch.pim import autotune

        plan = autotune.lookup(k, n_bits, shape=(x.shape[0], w.shape[0]),
                               pim_mode=tune_ctx, model=model)
    n_cols = 1024
    if plan is not None:
        model, n_cols, backend = plan.model, plan.n_cols, plan.backend
    chunk = max_dot_terms(n_bits, n_cols)
    if chunk <= 0:
        raise ValueError(f"n_bits={n_bits} does not fit the crossbar layout")
    if plan is not None and 0 < plan.chunk <= chunk:
        chunk = plan.chunk
    if k > chunk:
        p = -(-k // chunk)
        with span("pim.pack"):
            x = torch.nn.functional.pad(x, (0, p * chunk - k))
            x = x.unflatten(1, (p, chunk)).transpose(0, 1)
            w = _chunked_weight(w, p, chunk)
    artifact = compile_matmul(min(k, chunk), n_bits, model=model,
                              accumulate=accumulate, n_cols=n_cols)
    if backend == "cuda" and x.device.type == "cuda":
        # the device's own kernel: share the session (and its resident
        # state) of the untuned calls that name no backend
        backend = None
    acc = session_for(artifact, backend=backend,
                      rows_per_crossbar=rows_per_crossbar,
                      namespace=session_ns).execute(x, w)
    if k > chunk:
        with span("pim.read"):
            return acc.sum(dim=0)
    return acc


# The weights' derived copies, each cache an LRU of _Entry bound to the
# storage of the tensor it is keyed on (_bind) and bounded in bytes:
# "chunked" maps (weight identity without its version, P, chunk) to
# (version, zero-padded (P, O, chunk) view), "derived" maps (weight
# identity without its version, bits) to (version, (offset wq^T, scales,
# column sums)).  The stable identity of a cached view or offset tensor is
# what keeps the crossbar state made from it resident across calls.  A
# weight changed in place (a train step bumps its version) replaces its
# entry: one version per weight is kept, and what was made from the old
# one goes with it.
_weight_caches: Dict[str, "collections.OrderedDict"] = {
    "derived": collections.OrderedDict(), "chunked": collections.OrderedDict()}
_derived = _weight_caches["derived"]
_chunked = _weight_caches["chunked"]
_cached_bytes = {"derived": 0, "chunked": 0}
#: Bounds on the bytes of each weight cache, least recently used evicted
#: first, as the resident pool's.  A full-width model's linears take their
#: weights' element count in each: 0.31 GB for qwen1.5-0.5b, 1.1 GB for 4
#: layers of gemma-7b.
MAX_DERIVED_BYTES = 8 << 30
MAX_CHUNKED_BYTES = 8 << 30


def _forget(name: str, key: Tuple) -> None:
    entry = _weight_caches[name].pop(key)
    entry.fin.detach()
    _cached_bytes[name] -= entry.nbytes


def _expire_cached(name: str, key: Tuple, ref) -> None:
    with _session_lock:
        entry = ref()
        if entry is not None and _weight_caches[name].get(key) is entry:
            _forget(name, key)


def _cached(name: str, w: torch.Tensor, key: Tuple):
    """The value cached for ``w`` under ``key``, made the most recent, or
    None; an entry of another version of ``w`` is dropped."""
    cache = _weight_caches[name]
    with _session_lock:
        entry = cache.get(key)
        if entry is None:
            return None
        if entry.value[0] == w._version:
            cache.move_to_end(key)
            return entry.value[1]
        _forget(name, key)
    return None


def _remember(name: str, w: torch.Tensor, key: Tuple, value, nbytes: int):
    """Cache ``value`` for ``w``'s current version under ``key``, bound to
    ``w``'s storage, and evict past the cache's byte bound; returns
    ``value``."""
    cache = _weight_caches[name]
    bound = MAX_DERIVED_BYTES if name == "derived" else MAX_CHUNKED_BYTES
    entry = _Entry((w._version, value), nbytes)
    with _session_lock:
        if key in cache:
            _forget(name, key)
        _bind(w, entry, _expire_cached, name, key)
        cache[key] = entry
        _cached_bytes[name] += nbytes
        while _cached_bytes[name] > bound and cache:
            _forget(name, next(iter(cache)))
    return value


def _chunked_weight(w: torch.Tensor, p: int, chunk: int) -> torch.Tensor:
    """``w`` (O, K) zero-padded to (O, p * chunk), as a (p, O, chunk) view;
    made once per weight tensor and version."""
    key = (_tensor_key(w)[:-1], p, chunk)
    hit = _cached("chunked", w, key)
    if hit is not None:
        return hit
    wp = torch.nn.functional.pad(w, (0, p * chunk - w.shape[1]))
    return _remember("chunked", w, key, wp.unflatten(1, (p, chunk)
                                                     ).transpose(0, 1),
                     wp.numel() * wp.element_size())


# ==========================================================================
# the simulator linear
# ==========================================================================

def _quantized_weight(w: torch.Tensor, bits: int):
    key = (_tensor_key(w)[:-1], bits)
    hit = _cached("derived", w, key)
    if hit is not None:
        return hit
    qmax = 2 ** (bits - 1) - 1
    wf = w.detach().to(torch.float32)
    wsc = torch.clamp(torch.amax(torch.abs(wf), dim=0, keepdim=True),
                      min=1e-8) / qmax
    wq = torch.clamp(torch.round(wf / wsc), -qmax, qmax).to(torch.int64)
    # crossbars store magnitudes: the offset operand (wq + qmax + 1)^T
    # lies in [1, 2**bits - 1] and is kept as uint8
    w_off = (wq.T + (qmax + 1)).to(torch.uint8).contiguous()
    out = (w_off, wsc, wq.sum(dim=0, keepdim=True))
    return _remember("derived", w, key, out,
                     sum(t.numel() * t.element_size() for t in out))


def _sim_forward(x: torch.Tensor, w: torch.Tensor, bits: int, model: str,
                 ns: str) -> torch.Tensor:
    """The host math of the reference's ``_sim_mm`` (``engine.py:806``),
    bit for bit: quantization in float32, the integer GEMM exact, and the
    rescale in float64 (numpy promotes int64 x float32 to float64; torch
    would pick float32, so both sides are cast)."""
    qmax = 2 ** (bits - 1) - 1
    off = qmax + 1
    lead = x.shape[:-1]
    k = x.shape[-1]
    with span("linear.quantize"):
        xf = x.detach().to(torch.float32).reshape(-1, k)
        xs = torch.clamp(torch.amax(torch.abs(xf), dim=1, keepdim=True),
                         min=1e-8) / qmax
        xq = torch.clamp(torch.round(xf / xs), -qmax, qmax).to(torch.int64)
        # 2's-complement offset: shift into unsigned, multiply, correct
        # ((a+off)(b+off))
        x_off = (xq + off).to(torch.uint8)
        w_off, wsc, wq_sum = _quantized_weight(w, bits)
    # tune_ctx="pim_sim": pick up any tuned plan for this (K, n_bits) — a
    # no-op unless autotune is enabled and the table has a pick
    acc = matmul_int(x_off, w_off, n_bits=bits + 1, model=model,
                     tune_ctx="pim_sim", session_ns=ns)
    with span("linear.rescale"):
        corr = off * (wq_sum + off * k) + off * xq.sum(dim=1, keepdim=True)
        y = (acc - corr).to(torch.float64) * (xs * wsc).to(torch.float64)
        return y.reshape(*lead, w.shape[1]).to(x.dtype)


class _SimLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bits, model, ns):
        ctx.save_for_backward(x, w)
        return _sim_forward(x, w, bits, model, ns)

    @staticmethod
    def backward(ctx, g):
        # straight-through estimator: the forward is the quantized crossbar
        # result, the backward differentiates the ideal float matmul
        x, w = ctx.saved_tensors
        gx = (g @ w.to(g.dtype).T).to(x.dtype)
        gw = (x.reshape(-1, x.shape[-1]).to(g.dtype).T
              @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None, None, None


def sim_linear(x: torch.Tensor, w: torch.Tensor, bits: int = 7, *,
               model: str = "minimal") -> torch.Tensor:
    """Bit-exact crossbar execution of ``x @ w`` (x: (..., K), w: (K, N)).

    7-bit symmetric quantization so the offset-shifted unsigned operands
    fit the 8-bit (power-of-two partition count) MultPIM multiplier.  The
    GEMM runs on the crossbar simulator on the operands' device — the CUDA
    crossbar kernel for CUDA tensors, its plain version on the CPU — with
    the weight's crossbar state resident across calls (see
    :class:`ExecutionSession` for how the weight is keyed), in the session
    namespace of the call (:func:`current_session_ns`).  7 bits, where the
    ``"quant"`` lowering rounds to 8: the two modes' results differ.
    Differentiable through a straight-through backward (the gradient of
    the ideal matmul), so a ``pim_sim`` model trains.
    """
    return _SimLinear.apply(x, w, bits, model, current_session_ns())
