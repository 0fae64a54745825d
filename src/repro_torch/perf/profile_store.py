"""Persistent cross-run performance profile store.

Every run of this system pays probing costs — Pallas tile searches, scaler
(bs, mtl) latency probes, migration kill+relaunch stalls — and before this
module, only the autotune results outlived the process.  The store unifies
the three cross-run artifacts in ONE schema-versioned JSON document so a
fresh process starts from everything earlier runs already measured:

  * ``autotune``   — tuned tile configs per (kernel, shape-class, dtype,
    backend); ``perf.autotune`` now keeps its cache here (the legacy
    ``autotune_cache.json`` is imported once on first touch).  Every new
    tuning bumps the ``autotune`` *generation*, which the RealExecutor
    folds into its AOT executable-cache key — a re-tune invalidates stale
    executables instead of serving them forever.
  * ``surfaces``   — SurfaceLibrary rows (normalized (bs, mtl) step-latency
    sums/counts) persisted per (architecture-signature, device-class).
    ``ClusterEngine`` reloads them at construction so newly admitted jobs
    in a fresh process hit the matrix-completion fast path.  Loading is
    staleness-gated: rows recorded under a different autotune generation
    are evicted (the tiles that shaped those latencies no longer run), and
    the leave-one-out validation is re-run on load — a row the completion
    machinery itself rejects is dropped from the store, not kept to poison
    the next run too.
  * ``migrations`` — measured kill+relaunch (+ recompile) seconds per
    (signature, device-class).  Churn-mode migration stalls are charged
    from a calibrated percentile once enough measurements exist, falling
    back to the 2.3 s parallel kill+relaunch / 8 GB/s DCN modeling
    defaults otherwise.

Location: explicit ``root`` argument > ``REPRO_PROFILE_STORE`` env var >
``.profile_store/`` in the working directory.  Writes are atomic
merge-and-replace (re-read disk, our keys win on collision, ``os.replace``
of a temp file) so concurrent writers keep each other's entries and a
reader never sees a half-written document — last writer wins per key,
never a crash.  A schema-version mismatch or corrupt file is a clean cold
start: the store behaves as empty and the next save rewrites it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

SCHEMA_VERSION = 1
DEFAULT_STORE_DIR = ".profile_store"
STORE_FILE = "profile_store.json"
ENV_VAR = "REPRO_PROFILE_STORE"

MIN_MIGRATION_SAMPLES = 3     # calibrated percentiles need this many
MAX_MIGRATION_SAMPLES = 64    # ring-buffer cap per calibration key
MIGRATION_QUANTILE = 0.9      # stalls are charged at this percentile


def default_root() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_STORE_DIR


_STORES: dict = {}


def store_for(root: Optional[str] = None) -> "ProfileStore":
    """Process-resident store per root dir (autotune, executors, and the
    cluster engine must all see ONE in-memory generation counter)."""
    resolved = os.path.abspath(root or default_root())
    st = _STORES.get(resolved)
    if st is None:
        st = ProfileStore(resolved)
        _STORES[resolved] = st
    return st


class ProfileStore:
    def __init__(self, root: Optional[str] = None):
        self.root = root or default_root()
        self.cold_start = False      # True when disk was absent/invalid
        self.evictions = 0           # stale/corrupt records dropped on load
        self._deleted: set = set()   # (section, key) tombstones: a merge
        #                              save must not resurrect evicted rows
        self._doc: Optional[dict] = None

    # -- document lifecycle --------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.root, STORE_FILE)

    @staticmethod
    def _fresh_doc() -> dict:
        return {"schema": SCHEMA_VERSION, "generations": {}}

    def _read_disk(self) -> Optional[dict]:
        """The on-disk document, or None when absent/corrupt/mismatched —
        any invalid state means COLD START, never a crash."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA_VERSION:
            return None
        return doc

    def load(self) -> dict:
        if self._doc is None:
            disk = self._read_disk()
            if disk is None:
                self.cold_start = True
                self._doc = self._fresh_doc()
            else:
                self._doc = disk
        return self._doc

    def reload(self) -> None:
        """Drop the in-memory mirror; the next access re-reads disk."""
        self._doc = None
        self._deleted.clear()

    # -- generic section access ----------------------------------------------
    def section(self, name: str) -> dict:
        sec = self.load().setdefault(name, {})
        if not isinstance(sec, dict):        # tolerate hand-edited junk
            sec = {}
            self.load()[name] = sec
        return sec

    def get(self, section: str, key: str, default=None):
        return self.section(section).get(key, default)

    def put(self, section: str, key: str, value) -> None:
        self.section(section)[key] = value
        self._deleted.discard((section, key))

    def delete(self, section: str, key: str) -> None:
        self.section(section).pop(key, None)
        self._deleted.add((section, key))

    # -- recorded run traces (serving.replay) --------------------------------
    def record_trace(self, name: str, trace: dict) -> None:
        """Persist a recorded run trace (one key per run name)."""
        self.put("traces", name, trace)
        self.save()

    def get_trace(self, name: str):
        rec = self.get("traces", name)
        return rec if isinstance(rec, dict) else None

    def generation(self, name: str = "autotune") -> int:
        gens = self.load().setdefault("generations", {})
        try:
            return int(gens.get(name, 0))
        except (TypeError, ValueError):
            return 0

    def bump_generation(self, name: str = "autotune") -> int:
        gens = self.load().setdefault("generations", {})
        gens[name] = self.generation(name) + 1
        return gens[name]

    def save(self) -> None:
        """Atomic merge-and-replace.  Disk is re-read so a concurrent
        writer's keys survive; our keys win on collision (last-writer-wins
        per key); generations merge by max so a bump is never undone;
        tombstoned keys stay deleted."""
        doc = self.load()
        os.makedirs(self.root, exist_ok=True)
        disk = self._read_disk() or self._fresh_doc()
        out = {"schema": SCHEMA_VERSION}
        gens = {k: int(v) for k, v in disk.get("generations", {}).items()
                if isinstance(v, (int, float))}
        for k, v in doc.get("generations", {}).items():
            gens[k] = max(int(v), int(gens.get(k, 0)))
        out["generations"] = gens
        names = (set(disk) | set(doc)) - {"schema", "generations"}
        for name in names:
            base = disk.get(name)
            merged = dict(base) if isinstance(base, dict) else {}
            ours = doc.get(name)
            if isinstance(ours, dict):
                merged.update(ours)
            for sec, key in self._deleted:
                if sec == name:
                    merged.pop(key, None)
            out[name] = merged
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=STORE_FILE + ".tmp.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._doc = out

    def stats(self) -> dict:
        doc = self.load()
        return {
            "root": self.root,
            "schema": doc.get("schema"),
            "cold_start": self.cold_start,
            "evictions": self.evictions,
            "generations": dict(doc.get("generations", {})),
            "sections": {k: len(v) for k, v in doc.items()
                         if isinstance(v, dict) and k != "generations"},
        }

    # -- surfaces: persisted SurfaceLibrary rows ------------------------------
    @staticmethod
    def surface_key(signature: str, device_class: str) -> str:
        return f"{signature}|{device_class}"

    def persist_surface(self, lib, key, *, signature: str, device_class: str,
                        autotune_generation: int = 0,
                        tile_dependent: bool = True,
                        min_points: int = 3) -> bool:
        """Persist one tenancy's probed (bs, mtl) row under its
        architecture signature + device class.  A record for the same
        signature recorded under the same grid and generation accumulates
        (sample sums/counts merge element-wise); anything else is
        replaced.  `tile_dependent=False` marks rows whose latencies do
        not come from tuned kernels (simulated executors) — those are
        exempt from the generation staleness gate, so a re-tune does not
        wipe a warm-start library it cannot have invalidated.  Returns
        True when something was written."""
        row = lib.export_row(key)
        if row is None:
            return False
        sum_, cnt = row
        # the (1,1) normalizer lives at the largest share rung with data
        # ((bs=1, mtl=1) itself on the default single-rung grid)
        if int((cnt > 0).sum()) < min_points or not (cnt[0, 0] > 0).any():
            return False                 # too sparse / no (1,1) normalizer
        sk = self.surface_key(signature, device_class)
        rec = self.get("surfaces", sk)
        share_values = [float(s)
                        for s in getattr(lib, "share_values", (1.0,))]
        if (isinstance(rec, dict)
                and (not tile_dependent
                     or rec.get("autotune_generation")
                     == int(autotune_generation))
                and rec.get("bs_values") == list(lib.bs_values)
                and rec.get("mtl_values") == list(lib.mtl_values)
                and rec.get("share_values", [1.0]) == share_values):
            try:
                sum_ = sum_ + np.asarray(rec["sum"], np.float64)
                cnt = cnt + np.asarray(rec["cnt"], np.int64)
            except (KeyError, TypeError, ValueError):
                pass                     # malformed record: replace it
        self.put("surfaces", sk, {
            "signature": signature,
            "device_class": device_class,
            "bs_values": list(lib.bs_values),
            "mtl_values": list(lib.mtl_values),
            "share_values": share_values,
            "sum": np.asarray(sum_, np.float64).tolist(),
            "cnt": np.asarray(cnt, np.int64).tolist(),
            "points": int((np.asarray(cnt) > 0).sum()),
            "autotune_generation": int(autotune_generation),
            "tile_dependent": bool(tile_dependent),
        })
        return True

    def _surface_record_ok(self, rec, lib, autotune_generation: int) -> bool:
        if not isinstance(rec, dict):
            return False
        if (rec.get("tile_dependent", True)
                and rec.get("autotune_generation")
                != int(autotune_generation)):
            return False                 # stale: the resident tiles changed
            #                              under these measured latencies
            #                              (sim rows are tile-independent
            #                              and skip this gate)
        if (rec.get("bs_values") != list(lib.bs_values)
                or rec.get("mtl_values") != list(lib.mtl_values)
                or rec.get("share_values", [1.0])
                != [float(s) for s in getattr(lib, "share_values", (1.0,))]):
            return False
        try:
            sum_ = np.asarray(rec["sum"], np.float64)
            cnt = np.asarray(rec["cnt"], np.int64)
        except (KeyError, ValueError, TypeError):
            return False
        if sum_.shape != lib.shape or cnt.shape != lib.shape:
            return False
        if (cnt < 0).any() or not np.isfinite(sum_).all() or (sum_ < 0).any():
            return False
        if not (cnt[0, 0] > 0).any() or (sum_[cnt > 0] <= 0).any():
            return False                 # need the (1,1) normalizer
        return True

    def load_surfaces(self, lib, *, device_class: str,
                      autotune_generation: int = 0,
                      validate: bool = True) -> dict:
        """Load persisted rows for `device_class` into `lib` as historical
        tenancies keyed ("hist", signature, device_class).

        Two gates run at load time, and a failing record is EVICTED from
        the store (not merely skipped — a bad row would fail again on
        every future load):
          * staleness — recorded under a different autotune generation, or
            structurally invalid for the library grid;
          * leave-one-out — the completion machinery's own LOO validation
            (``SurfaceLibrary.predict``) re-run against the other loaded
            rows; a row it rejects carries no transferable shape."""
        loaded, evicted = [], []
        for sk, rec in list(self.section("surfaces").items()):
            if not isinstance(rec, dict) or \
                    rec.get("device_class") != device_class:
                continue
            if not self._surface_record_ok(rec, lib, autotune_generation):
                self.delete("surfaces", sk)
                self.evictions += 1
                evicted.append(sk)
                continue
            key = ("hist", rec["signature"], device_class)
            if lib.import_row(key, rec["sum"], rec["cnt"]):
                loaded.append((sk, key))
            else:
                self.delete("surfaces", sk)
                self.evictions += 1
                evicted.append(sk)
        if validate:
            for sk, key in list(loaded):
                # library tier only: a cost-model prior answering here
                # would mask the LOO verdict this eviction gate needs
                pred = lib.predict(key, allow_model=False)
                if pred is None and lib.last_reject == "loo":
                    lib.reset_row(key)
                    self.delete("surfaces", sk)
                    self.evictions += 1
                    evicted.append(sk)
                    loaded.remove((sk, key))
        if evicted:
            self.save()
        return {"loaded": [sk for sk, _ in loaded], "evicted": evicted}

    # -- partition interference: measured slice-proxy inflation ---------------
    def record_interference(self, key: str, share: float, wall_s: float,
                            inflated_s: float) -> None:
        """One real-executor partition-proxy measurement: the raw wall
        step and the slice-inflated step actually served, per
        (signature|device-class) key and share rung.  Ring-buffered like
        the migration samples."""
        if not (np.isfinite(wall_s) and np.isfinite(inflated_s)) \
                or wall_s <= 0 or inflated_s <= 0:
            return
        rung = f"{key}|share={share:.4f}"
        rec = self.get("interference", rung)
        samples = list(rec.get("samples", [])) if isinstance(rec, dict) else []
        samples.append([float(wall_s), float(inflated_s)])
        self.put("interference", rung,
                 {"samples": samples[-MAX_MIGRATION_SAMPLES:]})

    def interference_factor(self, key: str, share: float) -> Optional[float]:
        """Median measured inflation (inflated / wall) for one rung, or
        None without samples."""
        rec = self.get("interference", f"{key}|share={share:.4f}")
        if not isinstance(rec, dict):
            return None
        ratios = [i / w for w, i in rec.get("samples", [])
                  if isinstance(w, (int, float)) and w > 0
                  and isinstance(i, (int, float)) and i > 0]
        if not ratios:
            return None
        return float(np.median(np.asarray(ratios)))

    # -- migrations: measured kill+relaunch calibration -----------------------
    def record_migration(self, key: str, seconds: float) -> None:
        if not np.isfinite(seconds) or seconds < 0:
            return
        rec = self.get("migrations", key)
        samples = list(rec.get("samples", [])) if isinstance(rec, dict) else []
        samples.append(float(seconds))
        self.put("migrations", key,
                 {"samples": samples[-MAX_MIGRATION_SAMPLES:]})

    def migration_cost(self, key: str, *, q: float = MIGRATION_QUANTILE,
                       min_samples: int = MIN_MIGRATION_SAMPLES
                       ) -> Optional[float]:
        """Calibrated stall seconds for one migration of `key`, or None
        until `min_samples` measurements exist (callers fall back to the
        modeling defaults)."""
        rec = self.get("migrations", key)
        if not isinstance(rec, dict):
            return None
        samples = [float(s) for s in rec.get("samples", [])
                   if isinstance(s, (int, float)) and np.isfinite(s)
                   and s >= 0]
        if len(samples) < min_samples:
            return None
        return float(np.quantile(np.asarray(samples), q))
