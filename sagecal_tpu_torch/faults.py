"""Deterministic fault injection and transient retry (port of
``sagecal_tpu/faults.py``, copied whole: stdlib plus ``obs.metrics``).

- **Injection** (:func:`inject` / :func:`fires` / :func:`draw`): a
  seedable, deterministic fault plan with NAMED injection points
  (:data:`POINTS`). Call sites cost one attribute load and one ``is
  None`` test when no plan is installed. Probabilistic rules draw from a
  crc32 of ``(seed, point, key, occurrence)`` (:func:`_draw`), so the
  same plan and seed draw the same sequence here as in the JAX package,
  whatever the thread interleaving.

- **Retry** (:func:`retry_transient`): bounded exponential backoff with
  jitter for TRANSIENT failures, counting ``retries_total`` per retry
  and ``gave_up_total`` when the budget is spent; a non-transient
  exception, or the last attempt's, re-raises with its traceback.

Transience (:func:`is_transient`): an injected :class:`TransientFault`,
``ConnectionError``/``TimeoutError``/``InterruptedError``, and ``OSError``
except ``FileNotFoundError``, ``PermissionError``, ``IsADirectoryError``
and ``NotADirectoryError``. An injected :class:`FatalFault` is never
transient.

In the port the consensus runner draws ``admm_subband_slow``
(``consensus/admm.make_admm_runner_stale``), which the MPI CLI's
``--faults`` installs; the I/O seams that the other points name come
with the port's host runtime (ROADMAP queue A item 10), so nothing in
the port queries them yet.
"""

from __future__ import annotations

import json
import random
import threading
import time
import zlib

from sagecal_tpu_torch.obs import metrics as obs

#: every named injection point; an unknown point in a rule is an error
#: (a typo'd chaos plan silently injecting nothing is exactly the
#: failure mode a fault harness must refuse)
POINTS = (
    "ms_read",          # io/dataset: SimMS.read_tile entry
    "ms_write",         # io/dataset: SimMS.write_tile entry
    "solutions_write",  # io/solutions: SolutionWriter block write
    "beam_stage",       # pipeline: per-tile beam-table staging (reader)
    "residual_fetch",   # pipeline: residual d->h fetch (writer thread)
    "solve_nan",        # pipeline: poison a tile solve's residual
    "reader_thread",    # sched: Prefetcher producer death
    "writer_thread",    # sched: AsyncWriter job-loop death
    "socket_drop",      # serve/api: drop the client connection
    "migrate_abort",    # serve/scheduler: kill a job mid-migration,
    #                     AFTER its checkpoint flushed on the source
    #                     device and BEFORE its re-admission on the
    #                     target — the recovery path must re-queue the
    #                     job from the durable watermark (zero tiles
    #                     lost; chaos-gated in tests/test_faults.py)
    "worker_crash",     # serve/scheduler: kill the WHOLE WORKER
    #                     PROCESS (os._exit) at the tile boundary
    #                     entering tile ti, key "<job_id>:<ti>" — the
    #                     cross-process chaos lever: the router's
    #                     lease eviction must recover the dead
    #                     worker's jobs onto survivors from their
    #                     durable checkpoint watermarks (serve/
    #                     router.py; gated in tests/test_router.py).
    #                     Queried via fires(); only a process started
    #                     with a --faults plan can fire it, so it can
    #                     never kill a multi-tenant test process
    "admm_subband_slow",  # consensus/admm: a subband straggles for one
    #                     ADMM round (kind "transient": skipped under
    #                     bounded staleness, forced when the bound is
    #                     exhausted; kind "fatal": the subband is DEAD
    #                     — masked out of every later consensus).
    #                     Queried via draw(); key = subband index
    "tile_late",        # serve/scheduler + pipeline: force a streaming
    #                     tile past its per-tile arrival->write
    #                     deadline, key "<job_id>:<ti>" (serve) or the
    #                     tile index (direct runs). Queried via
    #                     fires(); the stream layer then applies its
    #                     own lateness policy — count, or degrade to
    #                     the last-good-Jones writeback — so the chaos
    #                     lever exercises the REAL late path, not a
    #                     synthetic clock skew
    "tile_dropped",     # stream transports: make the transport drop
    #                     tile i on the floor (never delivered), key =
    #                     tile index. The consumer observes the index
    #                     gap, counts stream_tiles_dropped_total and
    #                     continues — a live stream must survive loss
    #                     without stalling (gated in tests/
    #                     test_stream.py)
    "lock_acquire",     # analysis/threadsan: deterministic
    #                     interleaving pressure — an armed sanitizer
    #                     draws here on every instrumented lock
    #                     acquire (key = lock name) and stalls briefly
    #                     on a hit, widening race windows on the
    #                     plan's counted schedule instead of relying
    #                     on the OS scheduler to be unlucky. Queried
    #                     via draw(); only meaningful under
    #                     --sanitize-threads
)

_KINDS = ("transient", "fatal")

#: retry policy defaults (module attributes so tests/embedders can
#: tighten them; read at call time, never cached)
RETRY_ATTEMPTS = 3      # total attempts, including the first
RETRY_BASE_S = 0.05     # first backoff; doubles per retry
RETRY_MAX_S = 2.0       # backoff cap before jitter

_PLAN = None            # module-level singleton; None = disabled


class FaultError(RuntimeError):
    """Base class of every injected fault."""


class TransientFault(FaultError, OSError):
    """An injected fault the retry machinery should recover from."""


class FatalFault(FaultError):
    """An injected fault that must reach the fail-stop path."""


def _draw(seed: int, point: str, key, occ: int) -> float:
    """Stable uniform draw in [0, 1): a crc32 of the call identity, so
    probabilistic plans fire identically regardless of thread timing
    (Python's str hash is process-randomized — unusable here)."""
    h = zlib.crc32(repr((seed, point, key, occ)).encode())
    return (h & 0xFFFFFFFF) / 2.0 ** 32


class Rule:
    """One injection rule: WHERE (point), WHO (keys), HOW OFTEN
    (times / p), and WHAT (transient vs fatal)."""

    __slots__ = ("point", "kind", "at", "times", "p", "fired")

    def __init__(self, point: str, kind: str = "transient", at=None,
                 times: int | None = 1, p: float | None = None):
        if point not in POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; known: {POINTS}")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"known: {_KINDS}")
        self.point = point
        self.kind = kind
        if at is None:
            self.at = None
        else:
            at = at if isinstance(at, (list, tuple, set)) else (at,)
            self.at = frozenset(at)
        self.times = None if times is None else int(times)
        self.p = None if p is None else float(p)
        self.fired = 0


class Plan:
    """An installed set of rules + the seed (thread-safe)."""

    def __init__(self, rules, seed: int = 0):
        self.rules = [r if isinstance(r, Rule) else Rule(**r)
                      for r in rules]
        self.seed = int(seed)
        self._occ: dict = {}       # (point, key) -> query count
        self._lock = threading.Lock()

    def match(self, point: str, key) -> Rule | None:
        """The first rule that fires for this call, or None; fired
        counts are consumed under the lock so concurrent seams (reader
        + writer threads) never double-fire a bounded rule."""
        with self._lock:
            k = (point, key)
            occ = self._occ[k] = self._occ.get(k, 0) + 1
            for r in self.rules:
                if r.point != point:
                    continue
                if r.at is not None and key not in r.at:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.p is not None and _draw(self.seed, point, key,
                                             occ) >= r.p:
                    continue
                r.fired += 1
                return r
        return None


# ---------------------------------------------------------------------------
# module-level no-op-when-disabled API (the diag.trace pattern)
# ---------------------------------------------------------------------------

def enable(rules, seed: int = 0) -> Plan:
    """Install a fault plan (a list of :class:`Rule` / rule dicts)."""
    global _PLAN
    _PLAN = Plan(rules, seed=seed)
    return _PLAN


def enable_spec(spec: str) -> Plan:
    """Install a plan from a CLI spec: a JSON list of rule dicts, a
    JSON object ``{"seed": ..., "rules": [...]}``, or ``@path`` / a
    readable path to a file holding either form."""
    text = spec
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            text = f.read()
    else:
        try:
            with open(spec) as f:
                text = f.read()
        except OSError:
            pass
    d = json.loads(text)
    if isinstance(d, dict):
        return enable(d.get("rules", []), seed=int(d.get("seed", 0)))
    return enable(d)


def disable() -> None:
    global _PLAN
    _PLAN = None


def get() -> Plan | None:
    return _PLAN


def active() -> bool:
    """True when a fault plan is installed — the blessed gate for call
    sites whose key computation is itself costly (none today)."""
    return _PLAN is not None


def fires(point: str, key=None) -> bool:
    """Value-corruption sites (``solve_nan``): True when a rule fires;
    the caller applies the corruption itself. False when disabled."""
    p = _PLAN
    if p is None:
        return False
    r = p.match(point, key)
    if r is None:
        return False
    obs.inc("faults_injected_total", point=point)
    return True


def draw(point: str, key=None) -> str | None:
    """Kind-preserving query sites (``admm_subband_slow``): the rule's
    ``kind`` ("transient"/"fatal") when one fires, else None — for
    callers whose response differs by kind (a slow subband is skipped
    for a round, a dead one is masked out for good) without raising
    through a device-dispatch loop. None when disabled."""
    p = _PLAN
    if p is None:
        return None
    r = p.match(point, key)
    if r is None:
        return None
    obs.inc("faults_injected_total", point=point)
    return r.kind


def inject(point: str, key=None) -> None:
    """Exception sites: raise :class:`TransientFault` /
    :class:`FatalFault` when a rule fires, else return. No-op (one
    attribute load, one ``is None`` test) when no plan is installed."""
    p = _PLAN
    if p is None:
        return
    r = p.match(point, key)
    if r is None:
        return
    obs.inc("faults_injected_total", point=point)
    if r.kind == "transient":
        raise TransientFault(
            f"injected transient fault: {point} (key={key})")
    raise FatalFault(f"injected fatal fault: {point} (key={key})")


# ---------------------------------------------------------------------------
# transient retry (the production half)
# ---------------------------------------------------------------------------

#: OSError subclasses that describe the world, not the weather — a
#: retry cannot conjure a missing file or a permission bit
_NON_TRANSIENT_OS = (FileNotFoundError, PermissionError,
                     IsADirectoryError, NotADirectoryError)


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, TransientFault):
        return True
    if isinstance(exc, FaultError):
        return False                       # FatalFault
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, _NON_TRANSIENT_OS)
    return False


def retry_transient(fn, args=(), kwargs=None, *, what: str = "io",
                    key=None, attempts: int | None = None,
                    base_s: float | None = None, log=None):
    """Run ``fn(*args, **kwargs)``, retrying TRANSIENT failures up to
    ``attempts`` total tries with exponential backoff + jitter. Counts
    ``retries_total{what=}`` per retry and ``gave_up_total{what=}``
    when the budget is exhausted, then re-raises the ORIGINAL
    exception (original traceback — the fail-stop contract downstream
    depends on it). Non-transient exceptions re-raise immediately,
    uncounted. ``fn`` must be idempotent up to its first durable side
    effect (the wired call sites are: reads are pure, writes are
    atomic or single-call)."""
    kwargs = kwargs or {}
    n = max(1, RETRY_ATTEMPTS if attempts is None else int(attempts))
    base = RETRY_BASE_S if base_s is None else float(base_s)
    for a in range(n):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if not is_transient(e):
                raise
            if a == n - 1:
                obs.inc("gave_up_total", what=what)
                raise
            obs.inc("retries_total", what=what)
            delay = min(base * (2 ** a), RETRY_MAX_S)
            delay *= 0.5 + 0.5 * random.random()   # full-ish jitter
            if log is not None:
                log(f"transient {what} failure "
                    f"({type(e).__name__}: {e}); retry "
                    f"{a + 1}/{n - 1} in {delay * 1e3:.0f} ms"
                    + (f" (key={key})" if key is not None else ""))
            time.sleep(delay)
