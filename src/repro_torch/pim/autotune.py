"""Cost-model-driven partition autotuner: the engine's configuration planner.

The paper's central trade-off — partition count vs. peripheral/control
overhead — means the fastest crossbar configuration depends on the
workload shape.  For each compile key ``(n_terms, n_bits, model, shape,
pim_mode)`` this module

1. enumerates candidate configurations — partition model
   (``minimal``/``standard``/``unlimited``), crossbar geometry (1024, 2048
   or 4096 columns: a wider row fits more dot terms per chunk but pays
   more control bits per message), the implied inner-dimension chunking
   (``matmul.max_dot_terms``), the execution backend, and the multiplier
   algorithm (every ``kind="mult"`` registry entry — the NOR serial
   baseline plus ``serial_fast`` and ``compressor42`` — priced in the same
   race even though only partitioned models lower to executable dot
   programs);
2. scores every candidate with ``cost_model.gemm_cost`` /
   ``cost_model.mult_cost`` (predicted device latency);
3. breaks ties among the top predicted candidates with short timed trials
   on clipped operands — the default configuration is ALWAYS in the trial
   set, so the pick can never be slower than the default on the machine
   that tuned it (``vs_default >= 1.0`` by construction);
4. caches the winner: in the in-process table (hit on the next
   :func:`lookup`), attached to the ``CompiledPim`` artifact
   (``artifact.plan``), and — via :func:`save_table` / :func:`load_table`
   — in a JSON file, so serving warmup (``serve.py --autotune-table``)
   reloads picks instead of re-searching.  The JSON is the JAX reference's
   (``TABLE_VERSION`` 1): a table written by either package loads in the
   other.

Backends.  The reference races ``("scan", "pallas", "numpy")`` and, under
``pim_sim``, only ``"numpy"``, the one backend that may run inside its
``jax.pure_callback``.  Here ``"cuda"`` (the CUDA crossbar kernel) takes
``"pallas"``'s place.  Every state backend runs on one kind of device:
``cuda`` on a CUDA state, the host oracles (``scan``, ``numpy``, ...) on a
CPU state; each raises on the other (``engine``).  So what races depends
on the tuner's ``device``:

==========  =========  ===========================  ==========  =========
device      pim_mode   listed backends              raced       default
==========  =========  ===========================  ==========  =========
cpu         pim_sim    ``numpy``                    ``numpy``   ``numpy``
cpu         other      ``scan``, ``cuda``, ``numpy``  ``scan``,   ``scan``
                                                    ``numpy``
cuda        pim_sim    ``cuda``                     ``cuda``    ``cuda``
cuda        other      ``scan``, ``cuda``, ``numpy``  ``cuda``    ``cuda``
==========  =========  ===========================  ==========  =========

On the CPU the candidates and the default are the reference's (with
``cuda`` for ``pallas``).  On a card ``pim_sim`` races the kernel that
serving then runs, and its default is what an untuned ``sim_linear`` runs
there: the minimal model, 1024 columns, 37 terms per program, the kernel.
A loaded table runs on the device that loads it: ``pallas`` reads as
``cuda``, and a backend that cannot take that device's state becomes the
device's default (a reference ``pim_sim`` table's ``numpy`` becomes
``cuda`` on a card).

Trials time each candidate's ``engine.matmul_int(plan=...)`` call on the
tuner's device, with the device synchronized before each clock read, so
a card's time is the call's whole time (host packing and the kernel), not
the time to queue it.  Every tuned configuration computes the same exact
integer GEMM, so plans change speed, never results.
``engine.clear_cache()`` clears the table and its counters;
``engine.cache_info()`` exposes them (``tune_hits`` / ``tune_misses`` /
``tune_trials``).

:func:`autotune_linear` races the two int8 linear lowerings, single-rank
``quant`` and the per-rank ``quant_tp`` tiles, for one (tokens, d_in,
d_out) shape (the reference's ``linear:t…d…o…`` key).  Under a mesh of
more than one process every rank must pick the same lowering, so the
trial times are reduced across the mesh (``all_reduce(MAX)``) before the
pick.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "TunedPlan",
    "TuneInfo",
    "autotune",
    "lookup",
    "default_plan",
    "candidates",
    "enable",
    "enabled",
    "clear",
    "save_table",
    "load_table",
    "table_info",
    "summary",
    "plan_for_params",
    "autotune_linear",
]

# executable dot-program partition models (build_dot lowers these)
PARTITIONED_MODELS = ("minimal", "standard", "unlimited")
# crossbar geometries raced; wider rows fit more terms
GEOMETRIES = (1024, 2048, 4096)
# state backends raced outside pim_sim: the reference's ("scan", "pallas",
# "numpy") with the CUDA kernel in the Pallas kernel's place
STATE_BACKENDS = ("scan", "cuda", "numpy")
# pim_sim on the CPU: the reference's callback-safe set
CALLBACK_BACKENDS = ("numpy",)
# pim_sim on a card: the kernel serving runs
DEVICE_BACKENDS = ("cuda",)
# backend names of a table written by the reference, read as the port's
REFERENCE_BACKENDS = {"pallas": "cuda"}


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One tuned configuration pick (the reference's table entry)."""

    key: str
    kind: str               # "gemm" | "linear"
    model: str              # partition model (gemm) / lowering mode (linear)
    n_cols: int
    chunk: int              # dot terms per program (0: n/a)
    backend: str            # execution backend / lowering name
    predicted_us: float     # cost-model device latency
    trial_us: float = 0.0   # measured trial wall time (0: untried)
    default_us: float = 0.0  # the default config's time in the same race
    source: str = "cost_model"  # "cost_model" | "trial" | "table"
    # the race that picked this plan: every timed candidate with its own
    # trial_us and the default's default_us.  Not saved in the table.
    race: Tuple["TunedPlan", ...] = dataclasses.field(
        default=(), compare=False, repr=False)

    @property
    def vs_default(self) -> float:
        """default_time / picked_time (>= 1.0 when trials ran)."""
        if self.trial_us > 0 and self.default_us > 0:
            return self.default_us / self.trial_us
        return 1.0

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        del d["race"]
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "TunedPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class TuneInfo:
    hits: int
    misses: int
    trials: int
    size: int
    enabled: bool


_table: Dict[str, TunedPlan] = {}
_lock = threading.Lock()
_hits = 0
_misses = 0
_trials = 0
_enabled = False
# the trial clock (tests inject one)
_now = time.perf_counter


def enable(on: bool = True) -> None:
    """Turn ambient plan lookup on/off (``matmul_int(tune_ctx=...)``)."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop every pick and zero the counters (leaves ``enabled`` alone)."""
    global _hits, _misses, _trials
    with _lock:
        _table.clear()
        _hits = _misses = _trials = 0


def table_info() -> TuneInfo:
    with _lock:
        return TuneInfo(hits=_hits, misses=_misses, trials=_trials,
                        size=len(_table), enabled=_enabled)


def _bucket_m(m: int) -> int:
    """Batch rows bucket to the next power of two: decode batch sizes churn
    as requests come and go, and re-tuning per transient M would thrash."""
    return 1 << max(0, int(m - 1).bit_length())


def tune_key(n_terms: int, n_bits: int, model: str, shape: Tuple[int, int],
             pim_mode: str) -> str:
    m, o = shape
    return f"gemm:k{n_terms}b{n_bits}m{model}x{_bucket_m(m)}o{o}@{pim_mode}"


def _allowed_backends(pim_mode: str, backends: Optional[Sequence[str]],
                      dev: torch.device) -> Tuple[str, ...]:
    if backends is not None:
        return tuple(backends)
    if pim_mode == "pim_sim":
        return DEVICE_BACKENDS if dev.type == "cuda" else CALLBACK_BACKENDS
    return STATE_BACKENDS


def _runs_on(backend: str, dev: torch.device) -> bool:
    """The CUDA kernel takes a CUDA state only, the host oracles a CPU
    state only."""
    return (backend == "cuda") == (dev.type == "cuda")


def _own_backend(pim_mode: str, dev: torch.device) -> str:
    """The device's untuned backend: the kernel on a card; on the CPU the
    reference's ``scan``, or ``numpy`` under pim_sim."""
    if dev.type == "cuda":
        return "cuda"
    return "numpy" if pim_mode == "pim_sim" else "scan"


def default_plan(n_terms: int, n_bits: int, shape: Tuple[int, int],
                 pim_mode: str = "raw", model: str = "minimal",
                 device="cuda") -> TunedPlan:
    """The configuration tuned calls are raced against: the engine's
    defaults (minimal model, 1024-column crossbar, max chunking) on the
    device's untuned backend — the kernel on a card; on the CPU the
    reference's ``scan``, or ``numpy`` under pim_sim."""
    from repro_torch.pim.cost_model import gemm_cost
    from repro_torch.pim.matmul import max_dot_terms

    chunk = min(n_terms, max_dot_terms(n_bits, 1024))
    backend = _own_backend(pim_mode, resolve_device(device))
    cost = gemm_cost(shape[0], n_terms, shape[1], n_bits, model,
                     n_cols=1024, chunk=chunk)
    return TunedPlan(key=tune_key(n_terms, n_bits, model, shape, pim_mode),
                     kind="gemm", model=model, n_cols=1024, chunk=chunk,
                     backend=backend, predicted_us=cost.time_s * 1e6)


def candidates(n_terms: int, n_bits: int, shape: Tuple[int, int],
               pim_mode: str = "raw",
               backends: Optional[Sequence[str]] = None,
               device="cuda") -> List[TunedPlan]:
    """Every raced configuration, cost-model-scored, fastest predicted
    first.  Serial multiplier algorithms (``kind="mult"`` registry entries)
    are priced with ``chunk=0``/no backend — they rank in the race but
    cannot lower to a dot program, so :func:`autotune` never picks them for
    execution."""
    from repro_torch.pim import engine
    from repro_torch.pim.cost_model import gemm_cost
    from repro_torch.pim.matmul import max_dot_terms

    dev = resolve_device(device)
    m, o = shape
    out: List[TunedPlan] = []
    key_of = lambda model: tune_key(n_terms, n_bits, model, shape, pim_mode)
    for model in PARTITIONED_MODELS:
        for n_cols in GEOMETRIES:
            chunk = min(n_terms, max_dot_terms(n_bits, n_cols))
            if chunk <= 0:
                continue
            cost = gemm_cost(m, n_terms, o, n_bits, model,
                             n_cols=n_cols, chunk=chunk)
            for backend in _allowed_backends(pim_mode, backends, dev):
                out.append(TunedPlan(
                    key=key_of(model), kind="gemm", model=model,
                    n_cols=n_cols, chunk=chunk, backend=backend,
                    predicted_us=cost.time_s * 1e6))
    for name in engine.backends():
        if engine.backend_kind(name) != "mult" or name == "serial":
            continue
        cost = gemm_cost(m, n_terms, o, n_bits, name, n_cols=1024)
        out.append(TunedPlan(key=key_of(name), kind="gemm", model=name,
                             n_cols=1024, chunk=0, backend="",
                             predicted_us=cost.time_s * 1e6))
    # the NOR serial baseline, for the race report
    cost = gemm_cost(m, n_terms, o, n_bits, "baseline", n_cols=1024)
    out.append(TunedPlan(key=key_of("baseline"), kind="gemm",
                         model="baseline", n_cols=1024, chunk=0, backend="",
                         predicted_us=cost.time_s * 1e6))
    out.sort(key=lambda p: p.predicted_us)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trial_time(plan: TunedPlan, n_terms: int, n_bits: int,
                shape: Tuple[int, int], trials: int,
                rng: np.random.Generator, dev: torch.device) -> float:
    """Median-of-``trials`` wall microseconds for one tuned GEMM call.

    Operands are clipped (M<=8, O<=64 rows) so warmup stays cheap; the
    full inner dimension is kept — chunking is what the race is about.
    Runs through ``matmul_int(plan=...)`` on ``dev``, so the winning
    artifact lands in the compile cache.  The device is synchronized
    before each clock read.
    """
    from repro_torch.pim import engine

    m = min(shape[0], 8)
    o = min(shape[1], 64)
    hi = np.uint64(1) << np.uint64(n_bits)
    x = rng.integers(0, hi, size=(m, n_terms), dtype=np.uint64)
    w = rng.integers(0, hi, size=(o, n_terms), dtype=np.uint64)
    x = torch.from_numpy(x.astype(np.int64)).to(dev)
    w = torch.from_numpy(w.astype(np.int64)).to(dev)
    engine.matmul_int(x, w, n_bits, plan=plan)  # warm: compile + upload
    best = []
    for _ in range(max(1, trials)):
        _sync(dev)
        t0 = _now()
        engine.matmul_int(x, w, n_bits, plan=plan)
        _sync(dev)
        best.append((_now() - t0) * 1e6)
    return float(np.median(best))


def _config(p: TunedPlan) -> Tuple:
    return (p.model, p.n_cols, p.chunk, p.backend)


def autotune(n_terms: int, n_bits: int, shape: Tuple[int, int],
             pim_mode: str = "raw", *, model: str = "minimal",
             trials: int = 1, top_k: int = 3,
             backends: Optional[Sequence[str]] = None,
             force: bool = False, device="cuda") -> TunedPlan:
    """Search (or fetch) the fastest configuration for one compile key.

    Cost-model scores every candidate; the ``top_k`` predicted-fastest
    executable candidates plus the default then race in timed trials on
    ``device`` (set ``trials=0`` for a pure cost-model pick).  The winner
    is cached in the table, attached to its ``CompiledPim`` artifact, and
    returned; after a race its ``race`` holds every timed candidate.
    """
    global _hits, _misses, _trials
    dev = resolve_device(device)
    key = tune_key(n_terms, n_bits, model, shape, pim_mode)
    with _lock:
        plan = _table.get(key)
        if plan is not None and not force:
            _hits += 1
            _attach(plan, n_terms, n_bits)
            return plan
        _misses += 1

    cands = candidates(n_terms, n_bits, shape, pim_mode, backends, dev)
    execable = [p for p in cands if p.chunk > 0 and _runs_on(p.backend, dev)]
    default = default_plan(n_terms, n_bits, shape, pim_mode, model, dev)
    picked = execable[0] if execable else default
    if trials > 0 and execable:
        race = execable[:top_k]
        if not any(_config(p) == _config(default) for p in race):
            race.append(default)
        rng = np.random.default_rng(0)
        timed: List[Tuple[float, TunedPlan]] = []
        for p in race:
            t = _trial_time(p, n_terms, n_bits, shape, trials, rng, dev)
            timed.append((t, p))
            with _lock:
                _trials += 1
        t_default = next(t for t, p in timed
                         if _config(p) == _config(default))
        t_best, best = min(timed, key=lambda tp: tp[0])
        race = tuple(dataclasses.replace(p, key=key, trial_us=t,
                                         default_us=t_default,
                                         source="trial") for t, p in timed)
        picked = dataclasses.replace(best, key=key, trial_us=t_best,
                                     default_us=t_default, source="trial",
                                     race=race)
    else:
        picked = dataclasses.replace(picked, key=key, source="cost_model")

    with _lock:
        _table[key] = picked
    _attach(picked, n_terms, n_bits)
    return picked


def _attach(plan: TunedPlan, n_terms: int, n_bits: int) -> None:
    """Pin the pick on its ``CompiledPim`` artifact (cache hits carry it)."""
    if plan.kind != "gemm" or plan.chunk <= 0:
        return
    from repro_torch.pim import engine

    art = engine.compile_matmul(min(plan.chunk, n_terms), n_bits,
                                model=plan.model, n_cols=plan.n_cols)
    if art.plan is not plan:
        object.__setattr__(art, "plan", plan)


def lookup(n_terms: int, n_bits: int, *, shape: Tuple[int, int],
           pim_mode: str, model: str = "minimal") -> Optional[TunedPlan]:
    """Table-only fetch for the hot path (``matmul_int(tune_ctx=...)``):
    returns the cached pick or None — a miss never triggers a search."""
    global _hits, _misses
    if not _enabled:
        return None
    key = tune_key(n_terms, n_bits, model, shape, pim_mode)
    with _lock:
        plan = _table.get(key)
        if plan is None:
            _misses += 1
        else:
            _hits += 1
        return plan


# ==========================================================================
# persistence + warmup helpers
# ==========================================================================

TABLE_VERSION = 1


def save_table(path: str) -> int:
    """Write every pick to ``path`` (the reference's JSON table).  Returns
    the number of entries written."""
    with _lock:
        entries = {k: p.to_json() for k, p in sorted(_table.items())}
    doc = {"version": TABLE_VERSION, "entries": entries}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return len(entries)


def load_table(path: str, *, merge: bool = True, device="cuda") -> int:
    """Load picks from ``path`` for ``device``; returns the number of
    entries loaded.

    Loaded plans are stamped ``source="table"`` — the hit counters then
    show serving warmup reusing picks instead of re-searching — and a
    reference backend name reads as the port's (``pallas`` as ``cuda``).
    A GEMM plan whose backend cannot take ``device``'s state gets the
    device's default backend for its pim mode: a table tuned on the host
    (the reference's ``numpy`` under pim_sim) runs the kernel on a card,
    never the host interpreter on card state.  With ``merge=False`` the
    current table is replaced.
    """
    dev = resolve_device(device)
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != TABLE_VERSION:
        raise ValueError(f"tuning table {path!r} has version "
                         f"{doc.get('version')!r}, expected {TABLE_VERSION}")
    loaded = {}
    for k, v in doc.get("entries", {}).items():
        p = TunedPlan.from_json(v)
        backend = REFERENCE_BACKENDS.get(p.backend, p.backend)
        if p.kind == "gemm" and p.chunk > 0 and not _runs_on(backend, dev):
            backend = _own_backend(k.rsplit("@", 1)[-1], dev)
        loaded[k] = dataclasses.replace(p, source="table", backend=backend)
    with _lock:
        if not merge:
            _table.clear()
        _table.update(loaded)
    return len(loaded)


def summary() -> str:
    """One-line state for launcher echoes (``serve.py``'s ``[autotune]``)."""
    info = table_info()
    with _lock:
        picks = [p for p in _table.values() if p.kind == "gemm"]
    pick = ""
    if picks:
        p = max(picks, key=lambda p: p.chunk)
        pick = (f"; e.g. {p.key}: model={p.model} n_cols={p.n_cols} "
                f"chunk={p.chunk} backend={p.backend} "
                f"({p.vs_default:.2f}x vs default)")
    return (f"{'on' if info.enabled else 'off'}, {info.size} plan(s), "
            f"{info.hits} hits / {info.misses} misses, "
            f"{info.trials} trials{pick}")


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_shapes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_shapes(v)
    else:
        shp = getattr(tree, "shape", None)
        if shp is not None:
            yield tuple(shp)


def plan_for_params(params, max_batch: int, *, bits: int = 7,
                    pim_mode: str = "pim_sim", trials: int = 1,
                    device="cuda") -> int:
    """Tune every distinct linear shape in a model's parameter tree.

    Walks the tree (dicts, lists and tuples of tensors or arrays) for the
    trailing ``(K, O)`` dims of 2-D leaves and of 3-D layer-stacked leaves
    ``(n_layers, K, O)``, as the reference does — so its keys are the
    reference's, including those of leaves no linear multiplies by (the
    embedding, stacked biases and norms).  Each distinct shape is planned
    at the serving batch bucket.  ``sim_linear`` quantizes to ``bits`` and
    multiplies at ``bits+1`` (offset-shifted unsigned), hence the
    ``n_bits`` below.  Returns the number of shapes planned (table hits
    count, so a reloaded table makes this free).
    """
    dev = resolve_device(device)
    shapes = set()
    for shp in _leaf_shapes(params):
        if len(shp) in (2, 3):
            shapes.add((int(shp[-2]), int(shp[-1])))
    for k_dim, o in sorted(shapes):
        autotune(k_dim, bits + 1, (max_batch, o), pim_mode, trials=trials,
                 device=dev)
    return len(shapes)


# ==========================================================================
# the quant vs quant_tp split rule
# ==========================================================================

def autotune_linear(tokens: int, d_in: int, d_out: int, *,
                    trials: int = 2, force: bool = False,
                    device="cuda") -> TunedPlan:
    """Race the int8 linear lowerings — single-rank ``quant`` vs the
    per-rank ``quant_tp`` tiles — for one (tokens, d_in, d_out) shape.

    Both compute bit-identical results, so the pick is a speed decision:
    ``quant_tp`` pays off only once the mesh's ``"model"`` axis is wide
    enough to beat its collectives.  Without an active mesh ``quant_tp``
    is ``quant`` and the race times the same call twice.  Each candidate
    is warmed once, then timed ``trials`` times on ``device`` (synchronized
    before each clock read; the median counts).  Under a mesh of more than
    one process the medians are reduced with ``all_reduce(MAX)`` over the
    whole mesh (every rank then sees the same times and picks the same
    lowering: a rank that ran the other one would wait forever in its
    collectives).  The pick's ``race`` holds both timed candidates.
    """
    global _hits, _misses, _trials
    from repro_torch.dist import context as dctx
    from repro_torch.models import layers

    dev = resolve_device(device)
    key = f"linear:t{_bucket_m(tokens)}d{d_in}o{d_out}"
    with _lock:
        plan = _table.get(key)
        if plan is not None and not force:
            _hits += 1
            return plan
        _misses += 1

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((tokens, d_in)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(
        np.float32)).to(dev)
    names = ("quant", "quant_tp")
    medians = []
    for mode_name in names:
        layers.linear(x, w, mode=mode_name)  # warm
        times = []
        for _ in range(max(1, trials)):
            _sync(dev)
            t0 = _now()
            layers.linear(x, w, mode=mode_name)
            _sync(dev)
            times.append((_now() - t0) * 1e6)
        medians.append(float(np.median(times)))
        with _lock:
            _trials += 1
    mesh = dctx.current_mesh()
    if mesh is not None and mesh.size > 1:
        t = torch.tensor(medians, dtype=torch.float64,
                         device=mesh.comm_device)
        medians = dctx.all_reduce(t, mesh.axis_names, "max", mesh).tolist()
    t_best, best = min(zip(medians, names))
    t_default = medians[0]
    race = tuple(TunedPlan(key=key, kind="linear", model=nm, n_cols=0,
                           chunk=0, backend=nm, predicted_us=0.0,
                           trial_us=t, default_us=t_default, source="trial")
                 for t, nm in zip(medians, names))
    plan = dataclasses.replace(race[names.index(best)], race=race)
    with _lock:
        _table[key] = plan
    return plan
