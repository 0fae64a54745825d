"""The port's profile store is bit-identical to the reference's: the
operations of tests/test_profile_store.py, from the document round trip
through the migration ring buffer, driven through both packages (each
with its own SurfaceLibrary) give equal answers and save equal JSON
documents."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core.matrix_completion import \
    SurfaceLibrary as RefLibrary  # noqa: E402
from repro.perf import profile_store as ref_ps  # noqa: E402
from repro_torch.core.matrix_completion import \
    SurfaceLibrary as PortLibrary  # noqa: E402
from repro_torch.perf import profile_store as port_ps  # noqa: E402

BS_GRID = (1, 2, 4, 8, 16, 32)
MAX_MTL = 8


def _lat_s(bs, mtl, base_ms=5.0):
    b_fac = 1.0 if bs <= 8 else 10.0
    m_fac = 1.0 + 10.0 * (mtl - 1)
    return base_ms * b_fac * m_fac / 1e3


def _fill(lib, key, base_ms=5.0):
    for b in BS_GRID:
        for m in range(1, MAX_MTL + 1):
            lib.observe(key, b, m, _lat_s(b, m, base_ms=base_ms))


def _lib(Lib):
    return Lib(bs_values=BS_GRID, max_mtl=MAX_MTL)


# Each scenario drives one package's store module ``ps`` and
# SurfaceLibrary ``Lib`` under ``root`` and returns what it observed.
def round_trip(ps, Lib, root):
    a = ps.ProfileStore(root)
    a.put("autotune", "k1", {"config": {"block_q": 64}})
    a.put("migrations", "m1", {"samples": [0.1, 0.2]})
    a.bump_generation("autotune")
    a.save()
    b = ps.ProfileStore(root)
    return [b.get("autotune", "k1"), b.get("migrations", "m1"),
            b.generation("autotune"), b.cold_start]


INVALID = ['{"schema": 999, "autotune": {"k": 1}}', '{"autotune": {"k": 1}}',
           "not json at all {{{", '["schema", 1]']


def invalid_disk_cold_start(ps, Lib, root):
    out = []
    for i, content in enumerate(INVALID):
        sub = os.path.join(root, str(i))
        os.makedirs(sub)
        with open(os.path.join(sub, ps.STORE_FILE), "w") as f:
            f.write(content)
        st = ps.ProfileStore(sub)
        out += [st.section("autotune"), st.cold_start,
                st.generation("autotune")]
        st.put("autotune", "fresh", {"v": 1})
        st.save()
    return out


def concurrent_writers(ps, Lib, root):
    a, b = ps.ProfileStore(root), ps.ProfileStore(root)
    a.put("autotune", "only_a", 1)
    a.put("autotune", "shared", "A")
    b.put("autotune", "only_b", 2)
    b.put("autotune", "shared", "B")
    a.bump_generation("autotune")
    b.bump_generation("autotune")
    b.bump_generation("autotune")
    a.save()
    b.save()
    c = ps.ProfileStore(root)
    return [c.section("autotune"), c.generation("autotune")]


def deleted_keys_stay_deleted(ps, Lib, root):
    a = ps.ProfileStore(root)
    a.put("surfaces", "gone", {"x": 1})
    a.save()
    b = ps.ProfileStore(root)
    b.delete("surfaces", "gone")
    b.save()
    return [ps.ProfileStore(root).get("surfaces", "gone")]


def surface_round_trip(ps, Lib, root):
    store = ps.ProfileStore(root)
    lib = _lib(Lib)
    _fill(lib, "job-a")
    wrote = store.persist_surface(lib, "job-a", signature="net/data",
                                  device_class="gpu", autotune_generation=0)
    store.save()
    fresh = ps.ProfileStore(root)
    lib2 = _lib(Lib)
    res = fresh.load_surfaces(lib2, device_class="gpu", autotune_generation=0)
    for b, m in ((1, 1), (32, 1), (1, 8)):
        lib2.observe("new", b, m, _lat_s(b, m, base_ms=7.0))
    est, support = lib2.predict("new")
    return [wrote, res, est.tolist(), support.tolist()]


def surface_accumulates(ps, Lib, root):
    store = ps.ProfileStore(root)
    lib = _lib(Lib)
    _fill(lib, "j")
    out = []
    for gen in (3, 3, 4):
        store.persist_surface(lib, "j", signature="s", device_class="d",
                              autotune_generation=gen)
        out.append(store.get("surfaces", "s|d"))
    store.save()
    return out


def stale_rows_evicted(ps, Lib, root):
    store = ps.ProfileStore(root)
    lib = _lib(Lib)
    _fill(lib, "j")
    store.persist_surface(lib, "j", signature="s", device_class="d",
                          autotune_generation=0)
    _fill(lib, "sim")
    store.persist_surface(lib, "sim", signature="sim", device_class="d",
                          autotune_generation=0, tile_dependent=False)
    store.save()
    fresh = ps.ProfileStore(root)
    lib2 = _lib(Lib)
    res = fresh.load_surfaces(lib2, device_class="d", autotune_generation=1,
                              validate=False)
    return [res, lib2.n_points(("hist", "s", "d")),
            lib2.n_points(("hist", "sim", "d")), fresh.evictions]


def corrupt_row_evicted(ps, Lib, root):
    store = ps.ProfileStore(root)
    store.put("surfaces", "bad|d", {"device_class": "d", "signature": "bad",
                                    "bs_values": [1], "mtl_values": [1],
                                    "sum": [[-1.0]], "cnt": [[1]],
                                    "autotune_generation": 0})
    res = store.load_surfaces(_lib(Lib), device_class="d",
                              autotune_generation=0)
    return [res]


def loo_invalid_row_evicted(ps, Lib, root):
    store = ps.ProfileStore(root)
    lib = _lib(Lib)
    _fill(lib, "good")
    _fill(lib, "broken")
    for b, m in ((4, 2), (4, 2), (8, 3), (8, 3)):
        lib.observe("broken", b, m, 100 * _lat_s(b, m))
    for key in ("good", "broken"):
        store.persist_surface(lib, key, signature=key, device_class="d",
                              autotune_generation=0)
    store.save()
    fresh = ps.ProfileStore(root)
    res = fresh.load_surfaces(_lib(Lib), device_class="d",
                              autotune_generation=0)
    return [res, fresh.get("surfaces", "broken|d")]


def migration_percentiles(ps, Lib, root):
    store = ps.ProfileStore(root)
    out = [store.migration_cost("k")]
    for s in (0.10, 0.12, float("nan"), -5.0):
        store.record_migration("k", s)
    out.append(store.migration_cost("k"))
    store.record_migration("k", 0.30)
    out += [store.migration_cost("k", q=0.5), store.migration_cost("k", q=0.9)]
    store.record_interference("k", 0.5, 0.1, 0.15)
    out.append(store.interference_factor("k", 0.5))
    store.save()
    return out


def migration_ring_buffer(ps, Lib, root):
    store = ps.ProfileStore(root)
    for i in range(200):
        store.record_migration("k", 0.001 * (i + 1))
    store.record_trace("run", {"events": [1, 2, 3]})
    return [store.get("migrations", "k"), store.get_trace("run"),
            store.stats()["sections"]]


SCENARIOS = [round_trip, invalid_disk_cold_start, concurrent_writers,
             deleted_keys_stay_deleted, surface_round_trip,
             surface_accumulates, stale_rows_evicted, corrupt_row_evicted,
             loo_invalid_row_evicted, migration_percentiles,
             migration_ring_buffer]


def _documents(root):
    docs = {}
    for dirpath, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            with open(os.path.join(dirpath, name)) as f:
                docs[os.path.relpath(os.path.join(dirpath, name),
                                     root)] = f.read()
    return docs


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_store_operations_bit_identical(tmp_path, scenario):
    roots = {}
    got = {}
    for name, ps, Lib in (("ref", ref_ps, RefLibrary),
                          ("port", port_ps, PortLibrary)):
        roots[name] = str(tmp_path / name)
        os.makedirs(roots[name])
        got[name] = scenario(ps, Lib, roots[name])
    np.testing.assert_equal(got["port"], got["ref"])
    ref_docs, port_docs = _documents(roots["ref"]), _documents(roots["port"])
    assert ref_docs and port_docs == ref_docs
