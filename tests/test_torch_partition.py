"""The port's ``serving/partition.py`` is a verbatim copy of the
reference's: the cases of ``tests/test_partition.py`` that need no cluster
(plan legality, the MIG grid, submesh plans, memory slices, share ladders
and snapping, MIG sub-slicing, slice pricing on ``SimExecutor``, the
scaler's share axis), run through both packages on the same inputs, give
equal results, exactly."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import scaler as ref_scaler  # noqa: E402
from repro.serving import device_model as ref_dm  # noqa: E402
from repro.serving import executor as ref_ex  # noqa: E402
from repro.serving import partition as ref_pt  # noqa: E402
from repro.serving import tenancy as ref_ten  # noqa: E402
from repro_torch.core import scaler as port_scaler  # noqa: E402
from repro_torch.serving import device_model as port_dm  # noqa: E402
from repro_torch.serving import executor as port_ex  # noqa: E402
from repro_torch.serving import partition as port_pt  # noqa: E402
from repro_torch.serving import tenancy as port_ten  # noqa: E402

REF = dict(pt=ref_pt, dm=ref_dm, ten=ref_ten, ex=ref_ex, sc=ref_scaler)
PORT = dict(pt=port_pt, dm=port_dm, ten=port_ten, ex=port_ex,
            sc=port_scaler)


def _plain(x):
    """A result as plain data: dataclasses as dicts, tuples as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{k: _plain(v) for k, v in dataclasses.asdict(x).items()}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _both(fn):
    """``fn`` run on each package: the port's result, the reference's."""
    return _plain(fn(PORT)), _plain(fn(REF))


def _equal(fn):
    port, ref = _both(fn)
    assert port == ref


def _plan_facts(plan):
    return (plan, plan.tenants, plan.total_share, plan.headroom,
            plan.validate())


def test_constants_equal():
    for name in ("MIG_PROFILES", "MPS_LADDER", "SHARE_TOL",
                 "MIG_COMPUTE_SLICES"):
        assert getattr(port_pt, name) == getattr(ref_pt, name), name


@pytest.mark.parametrize("shares,mems", [
    ([0.5, 0.25, 0.25], None), ([0.75, 0.5], None), ([0.5, -0.1], None),
    ([0.5, 0.25], [0.9, 0.9]), ([1.0], None), ([0.3, 0.3, 0.3], None)])
def test_mps_plan_legality(shares, mems):
    _equal(lambda m: _plan_facts(m["pt"].mps_plan(shares, mems)))


@pytest.mark.parametrize("shares", [[0.5, 0.3, 0.15], [1.0], [0.01, 0.9],
                                    [0.3, 0.3, 0.3]])
def test_mig_plan_snaps_to_profile_grid(shares):
    _equal(lambda m: _plan_facts(m["pt"].mig_plan(shares)))


def test_mig_plan_rejects_illegal_combination():
    def msg(m):
        with pytest.raises(ValueError) as err:
            m["pt"].mig_plan([1.0, 1.0])
        return str(err.value)
    _equal(msg)


def test_hand_built_plans_are_flagged_alike():
    def plans(m):
        pt = m["pt"]
        return [_plan_facts(p) for p in (
            pt.PartitionPlan(kind="mig", slices=(
                pt.TenantSlice(share=0.33, tenants=1, isolation=1.0),)),
            pt.PartitionPlan(kind="submesh", slices=(
                pt.TenantSlice(share=0.3, tenants=1, isolation=1.0),),
                mesh_shape=(4, 4)),
            pt.PartitionPlan(kind="submesh", slices=(
                pt.TenantSlice(share=0.5),)),
            pt.PartitionPlan(kind="mesh", slices=()))]
    _equal(plans)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_submesh_plan_wraps_tenancy_plan(k):
    _equal(lambda m: _plan_facts(m["pt"].from_tenancy(
        m["ten"].plan((4, 4), k))))


@pytest.mark.parametrize("kind", ["mps", "mig", "submesh"])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_uniform_plan(kind, k):
    _equal(lambda m: _plan_facts(m["pt"].uniform_plan(
        k, kind, mesh_shape=(4, 4) if kind == "submesh" else None)))


def test_memory_slices_fit_check():
    def fits(m):
        pt, dm = m["pt"], m["dm"]
        prof = dm.paper_profile("inception_v1")
        return [pt.mps_plan([0.5, 0.5]).fits_memory(
                    dm.TESLA_P40, [prof, prof], [(1, 1), (1, 1)]),
                pt.mps_plan([0.5, 0.5], mem_fractions=[0.99, 0.01])
                .fits_memory(dm.TESLA_P40, [prof, prof], [(1, 1), (128, 4)])]
    port, ref = _both(fits)
    assert port == ref == [True, False]


@pytest.mark.parametrize("kind,mesh", [("mps", None), ("mig", None),
                                       ("submesh", (4, 4)),
                                       ("submesh", (2, 4))])
def test_share_ladders_and_snap(kind, mesh):
    def ladder(m):
        pt = m["pt"]
        return (pt.share_ladder(kind, mesh),
                [pt.snap(kind, s, mesh) for s in
                 (0.01, 0.125, 0.3, 0.5, 0.8, 0.99, 1.0)])
    _equal(ladder)


def test_mig_step_down_and_packing_key():
    def steps(m):
        pt = m["pt"]
        return ([pt.mig_step_down(s) for s in
                 (1.0, 4 / 7, 3 / 7, 2 / 7, 1 / 7, 0.05)],
                [pt.packing_key(p, occupied=o, fill=f)
                 for p in ("pack", "spread", None)
                 for o in (True, False) for f in (0.0, 0.5)])
    _equal(steps)


@pytest.mark.parametrize("kind", ["mps", "mig"])
@pytest.mark.parametrize("mtl", [1, 2, 3, 4])
def test_split_for_instances_and_its_latency(kind, mtl):
    def split(m):
        pt, dm = m["pt"], m["dm"]
        sl = pt.TenantSlice(share=1.0, inv_share=1.0, tenants=1,
                            isolation=1.0 if kind == "mig" else 0.0)
        subs = pt.split_for_instances(sl, mtl, kind=kind)
        prof = dm.paper_profile("inception_v1")
        return subs, [pt.part_instances_latency(dm.TESLA_P40, prof, bs,
                                                subs) for bs in (1, 4, 32)]
    _equal(split)


@pytest.mark.parametrize("share,tenants,iso", [(0.5, 2, 0.0), (0.25, 4, 1.0),
                                               (1.0, 1, 0.0), (0.3, 3, 0.0)])
def test_slice_slowdowns(share, tenants, iso):
    def slow(m):
        ts = m["pt"].TenantSlice(share=share, tenants=tenants, isolation=iso)
        return ts, [ts.slowdown(k) for k in (1, 2, 4)], ts.proxy_slowdown()
    _equal(slow)


@pytest.mark.parametrize("seed", [0, 3])
def test_sim_executor_partition_pricing_and_memory(seed):
    """A slice prices latency, power, memory and token steps alike in both
    packages, and a resize reprices without a rebuild."""
    def sim(m):
        pt, dm, ex = m["pt"], m["dm"], m["ex"]
        prof = dm.paper_profile("inception_v1")
        ts = pt.TenantSlice(share=0.5, inv_share=2.0, tenants=2,
                            isolation=0.0)
        e = ex.SimExecutor(prof, device=dm.TESLA_P40, partition=ts,
                           seed=seed)
        out = [e.mean_latency(4, 1), e.power_terms(4, 1), e.fits(64, 4),
               e.price_surface([1, 4, 32], [1, 2, 3]),
               e.token_step_latency(8, 1, prefill_tenants=1),
               [e.run_step(4, 1)["step_time"] for _ in range(3)]]
        e.set_partition(pt.TenantSlice(share=1.0, inv_share=1.0, tenants=2))
        out += [e.mean_latency(4, 1), e.power_terms(4, 1)]
        sliver = ex.SimExecutor(prof, device=dm.TESLA_P40,
                                partition=pt.TenantSlice(
                                    share=0.02, mem_fraction=0.02,
                                    tenants=2))
        return out + [sliver.fits(64, 4)]
    port, ref = _both(sim)
    assert port == ref
    assert port[-1] is False


LADDER = (0.25, 0.5, 0.75, 1.0)


def _drive(m, steps, demand_cap=None, **kw):
    """tests/test_partition.py's closed loop on its synthetic 3-D surface:
    the (bs, mtl, share) the scaler serves at each step."""
    sc = m["sc"].HybridScaler(0.1, decision_interval=1, share_ladder=LADDER,
                              **kw)
    sc.set_granted_share(0.5)
    trace = []
    for _ in range(steps):
        act = sc.action()
        share = act.share if act.share is not None else 1.0
        lat = 0.01 * act.bs * (1 + 0.5 * (act.mtl - 1)) / share
        items = act.bs * act.mtl
        if demand_cap is not None:
            items = min(items, demand_cap * lat)
        trace.append((act.bs, act.mtl, share))
        sc.observe(lat, {"step_time": lat, "items": items})
    return trace, sc.infeasible


@pytest.mark.parametrize("kw", [dict(steps=600),
                                dict(steps=200, demand_cap=5.0, max_bs=1,
                                     max_mtl=1)], ids=["slo", "demand_cap"])
def test_share_axis_trace_equal(kw):
    _equal(lambda m: _drive(m, **kw))
