"""Persistent, schema-versioned tuning cache: measure once per machine,
dispatch tuned forever.

Counterpart of ``repro.tune.cache``.  The autotuner
(``repro_torch.tune.tuner``) is a *measured* search — its trials cost
real device time — so its verdicts must outlive the process.  This
module stores them in one JSON document (``repro_torch.tune/v1``), keyed
two levels deep:

  * a **machine key** derived from ``repro_torch.obs.bench``'s
    :func:`machine_fingerprint` of the device the call runs on
    (platform, torch and CUDA versions, device type, name and count) —
    one torch process can run on the CPU and on the card, and a verdict
    measured on the card never answers a ``device="cpu"`` call;
  * a **workload key** — the resolved ``DPSpec`` (``describe()`` plus
    accumulator dtype), query length ``m``, reference length ``n``, the
    8 x 2^k batch bucket, and the requested sweep outputs: the same
    string ``repro.tune.workload_key`` gives.

Every verdict records the winning backend (kernel vs engine), the
winning ``segment_width``, the measured times, and how many trials were
spent, so a warm process answers ``segment_width="auto"`` with ZERO
timing trials (the ``tune.trials`` / ``tune.cache_hits`` counters show
it).

Location: ``$REPRO_TORCH_TUNE_CACHE`` names the file; unset it defaults
to ``~/.cache/repro_torch/tuning.json``; set it to ``0`` / ``off`` /
``none`` to keep the cache in memory only.  The port keeps its own file
and schema: the JAX package's loader rejects (and rewrites) a document
of another schema, so a shared file would lose one package's verdicts at
every write of the other.  Writes are atomic (tmp + rename).  A corrupt
or schema-mismatched file is REJECTED — logged and treated as empty,
never trusted and never allowed to crash a dispatch — and the next
:meth:`TuningCache.put` rewrites a valid document.

Hygiene: verdicts whose stored machine fingerprint no longer hashes to
the section's :func:`machine_key` (torch upgraded in place, device set
changed, hand-migrated files) are AGED OUT on load — counted in the
``tune.cache_expired`` obs counter and ``TuningCache.expired`` — so a
stale measurement can never pick this machine's dispatch plan.  A
``max_age_s`` bound (env: ``REPRO_TORCH_TUNE_CACHE_MAX_AGE`` seconds for
the default caches) additionally expires a section whose
``updated_unix`` write stamp is older than the bound, through the same
counters.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

from repro_torch.obs.bench import fingerprint_device, machine_fingerprint

log = logging.getLogger(__name__)

TUNE_SCHEMA = "repro_torch.tune/v1"

_DISABLED = ("0", "off", "none", "false")


def default_cache_path() -> str | None:
    """The tuning-cache file the default cache persists to, or None
    (memory-only) when ``REPRO_TORCH_TUNE_CACHE`` disables persistence."""
    raw = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if raw is None:
        return os.path.join(os.path.expanduser("~"), ".cache",
                            "repro_torch", "tuning.json")
    if raw.strip().lower() in _DISABLED or not raw.strip():
        return None
    return raw


def machine_key(fingerprint: dict | None = None) -> str:
    """The cache's trust boundary: verdicts only apply to the machine
    and device they were measured on."""
    fp = machine_fingerprint() if fingerprint is None else fingerprint
    return (f"{fp.get('platform', '?')}|torch={fp.get('torch', '?')}|"
            f"cuda={fp.get('cuda', '?')}|{fp.get('device_type', '?')}:"
            f"{fp.get('device_name', '?')}x{fp.get('device_count', 0)}")


def workload_key(*, spec, m: int, n: int, batch_bucket: int,
                 outputs) -> str:
    """One tuning key per (recurrence, shape, outputs) workload.

    The recurrence FAMILY is part of the key: a twed and an sdtw
    workload over identical (m, n, bucket, outputs) tune — and cache —
    independently (their kernels run different folds and operand
    sets).  The explicit ``fam=`` component rides next to
    ``spec.describe()`` (which also spells the family parameters) for
    every non-sdtw family; sdtw keys have none, as in ``repro``.
    """
    out = "+".join(sorted(outputs))
    fam = "" if spec.family == "sdtw" else f"fam={spec.family}|"
    return (f"{fam}{spec.describe()}|accum={spec.accum_dtype}|m={m}|n={n}|"
            f"b={batch_bucket}|out={out}")


def _valid_verdict(v) -> bool:
    """Entry-level rejection: a verdict read back from disk must carry
    a sane winner before anyone dispatches on it."""
    if not isinstance(v, dict):
        return False
    w = v.get("segment_width")
    if isinstance(w, bool) or not isinstance(w, int) or w < 1:
        return False
    if not isinstance(v.get("backend"), str):
        return False
    best = v.get("best_ms")
    if best is not None and (not isinstance(best, (int, float))
                             or not math.isfinite(best)):
        return False
    return True


class TuningCache:
    """One machine's (one device's) view of the persistent tuning
    document.

    ``path=None`` keeps the cache in memory (still shared by every
    consumer holding this object).  The on-disk document may hold
    entries for many machines; this object reads and writes only the
    section under its own :func:`machine_key`, preserving the rest.
    ``fingerprint`` defaults to :func:`machine_fingerprint` of
    ``device`` (``None``: the current card when there is one, else the
    CPU).
    """

    def __init__(self, path: str | None = None, *,
                 fingerprint: dict | None = None,
                 device=None,
                 max_age_s: float | None = None):
        if max_age_s is not None and max_age_s <= 0:
            raise ValueError(f"max_age_s must be positive or None, got "
                             f"{max_age_s!r}")
        self.path = path
        self.max_age_s = max_age_s
        self.fingerprint = (machine_fingerprint(device) if fingerprint
                            is None else fingerprint)
        self.machine = machine_key(self.fingerprint)
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self.rejected = False       # a corrupt/mismatched file was seen
        self.expired = 0            # verdicts aged out on load (stored
        #                             fingerprint drifted off machine_key
        #                             or section older than max_age_s;
        #                             mirrored in ``tune.cache_expired``)
        if path is not None:
            self._entries = self._load(path)

    # ------------------------------------------------------------ load
    def _load(self, path: str) -> dict:
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError) as e:
            self.rejected = True
            log.warning("tuning cache %s rejected (not JSON: %s); "
                        "starting empty", path, e)
            return {}
        if not isinstance(doc, dict) or doc.get("schema") != TUNE_SCHEMA:
            self.rejected = True
            log.warning("tuning cache %s rejected (schema=%r, expected "
                        "%r); starting empty", path,
                        doc.get("schema") if isinstance(doc, dict)
                        else type(doc).__name__, TUNE_SCHEMA)
            return {}
        section = doc.get("machines", {})
        if not isinstance(section, dict):
            self.rejected = True
            log.warning("tuning cache %s rejected (machines is not an "
                        "object); starting empty", path)
            return {}
        mine = section.get(self.machine, {})
        entries = mine.get("entries", {}) if isinstance(mine, dict) else {}
        if not isinstance(entries, dict):
            self.rejected = True
            return {}
        # cache hygiene: the section sits under our machine_key, but the
        # FULL fingerprint stored alongside it must still hash back to
        # that key — a hand-migrated file, a historical key scheme, or a
        # torch upgrade that drifted the stored fingerprint all mean these
        # verdicts were measured on a machine shape that no longer
        # matches, so they age out rather than mis-tune dispatches
        stored_fp = mine.get("fingerprint") if isinstance(mine, dict) \
            else None
        if entries and isinstance(stored_fp, dict) \
                and machine_key(stored_fp) != self.machine:
            self.expired += len(entries)
            self._count_expired(len(entries))
            log.warning(
                "tuning cache %s: expired %d verdict(s) — stored "
                "fingerprint (%s) no longer matches this machine (%s)",
                path, len(entries), machine_key(stored_fp), self.machine)
            return {}
        # time-based expiry: the section's write stamp bounds the age of
        # every verdict in it — past ``max_age_s`` the device clocks,
        # thermals, or CUDA software stack may have drifted enough that a
        # re-measurement is cheaper than a mis-tuned dispatch plan
        if entries and self.max_age_s is not None:
            stamp = mine.get("updated_unix") if isinstance(mine, dict) \
                else None
            age = (time.time() - stamp) if isinstance(
                stamp, (int, float)) and not isinstance(stamp, bool) \
                else None
            if age is None or age > self.max_age_s:
                self.expired += len(entries)
                self._count_expired(len(entries))
                log.warning(
                    "tuning cache %s: expired %d verdict(s) — section %s "
                    "(max_age_s=%g)", path, len(entries),
                    "has no updated_unix stamp" if age is None
                    else f"is {age:.0f}s old", self.max_age_s)
                return {}
        kept = {k: v for k, v in entries.items() if _valid_verdict(v)}
        dropped = len(entries) - len(kept)
        if dropped:
            self.rejected = True
            log.warning("tuning cache %s: dropped %d malformed "
                        "entr%s", path, dropped,
                        "y" if dropped == 1 else "ies")
        return kept

    @staticmethod
    def _count_expired(n: int) -> None:
        """Tick the process-wide ``tune.cache_expired`` counter (late
        import: repro_torch.obs must stay importable without
        repro_torch.tune)."""
        try:
            from repro_torch import obs
            obs.default_registry().inc("tune.cache_expired", n)
        except Exception:      # hygiene must never break a cache load
            log.debug("could not record tune.cache_expired", exc_info=True)

    # ------------------------------------------------------- accessors
    def key(self, *, spec, m: int, n: int, batch_bucket: int,
            outputs) -> str:
        return workload_key(spec=spec, m=m, n=n,
                            batch_bucket=batch_bucket, outputs=outputs)

    def get(self, key: str) -> dict | None:
        with self._lock:
            v = self._entries.get(key)
            return dict(v) if v is not None else None

    def put(self, key: str, verdict: dict) -> None:
        """Record a verdict and (when file-backed) persist atomically."""
        if not _valid_verdict(verdict):
            raise ValueError(f"malformed tuning verdict for {key!r}: "
                             f"{verdict!r}")
        with self._lock:
            self._entries[key] = dict(verdict)
            if self.path is not None:
                self._flush()

    def entries(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def __len__(self) -> int:
        return len(self._entries)

    # ----------------------------------------------------------- flush
    def _flush(self) -> None:
        """Merge this machine's entries into the on-disk document and
        atomically replace it (other machines' sections preserved)."""
        path = self.path
        doc: dict = {"schema": TUNE_SCHEMA, "machines": {}}
        try:
            with open(path) as f:
                old = json.load(f)
            if isinstance(old, dict) and old.get("schema") == TUNE_SCHEMA \
                    and isinstance(old.get("machines"), dict):
                doc["machines"] = old["machines"]
        except (OSError, json.JSONDecodeError):
            pass                      # corrupt/missing: rewrite clean
        doc["machines"][self.machine] = {
            "fingerprint": self.fingerprint,
            "updated_unix": time.time(),
            "entries": self._entries,
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def __repr__(self):
        return (f"TuningCache(path={self.path!r}, "
                f"entries={len(self._entries)})")


# ----------------------------------------------------- default caches
_defaults: dict[str, TuningCache] = {}
_default_lock = threading.Lock()


def _default_max_age() -> float | None:
    """``REPRO_TORCH_TUNE_CACHE_MAX_AGE`` (seconds) for the default
    caches; unset/empty/non-positive/garbage all mean no time-based
    expiry."""
    raw = os.environ.get("REPRO_TORCH_TUNE_CACHE_MAX_AGE", "").strip()
    if not raw:
        return None
    try:
        age = float(raw)
    except ValueError:
        log.warning("ignoring REPRO_TORCH_TUNE_CACHE_MAX_AGE=%r (not a "
                    "number)", raw)
        return None
    return age if age > 0 else None


def default_cache(device=None) -> TuningCache:
    """The process-wide cache ``segment_width="auto"`` consults for calls
    on ``device`` unless handed an explicit one: one object per device
    (``"cpu"``, ``"cuda:0"``, ...), each its own section of the same
    file (env knobs: ``REPRO_TORCH_TUNE_CACHE`` for the path,
    ``REPRO_TORCH_TUNE_CACHE_MAX_AGE`` for time-based expiry)."""
    dev = fingerprint_device(device)
    with _default_lock:
        cache = _defaults.get(str(dev))
        if cache is None:
            cache = _defaults[str(dev)] = TuningCache(
                default_cache_path(), device=dev,
                max_age_s=_default_max_age())
        return cache


def set_default_cache(cache: TuningCache | None,
                      device=None) -> TuningCache | None:
    """Swap the process-wide cache of ``device`` (tests; ``None`` drops
    it, so the next :func:`default_cache` reopens the file); returns the
    previous one."""
    key = str(fingerprint_device(device))
    with _default_lock:
        prev = _defaults.pop(key, None)
        if cache is not None:
            _defaults[key] = cache
        return prev
