"""Spatial partition planner — the MPS/MIG-style third knob.

The paper's Multi-Tenancy knob time-shares the whole GPU among co-located
instances; D-STACK and the multi-tenant GPU inference survey show that
*spatial* partitioning — MPS compute percentages, MIG slices — is the other
half of the design space and often dominates time-slicing for small DNNs.
This module is the planning layer for that axis:

  * `TenantSlice` — one tenant's grant: a compute fraction, a memory
    fraction, the exact slowdown factor its kernels pay (`inv_share`,
    kept separately so uniform 1/k grants price BIT-IDENTICALLY to the
    paper's MTL curves — see `device_model.part_latency_grid`), and an
    isolation degree (0 = MPS shared memory paths, 1 = MIG/submesh
    hardware isolation).
  * `PartitionPlan` — the per-device plan: one slice per resident tenant,
    with backend-specific legality (`validate`): shares and memory
    fractions must sum to <= 1, MIG shares must sit on the discrete
    profile grid, submesh shares must correspond to feasible submesh
    splits.  `tenancy.TenancyPlan` — today's TPU submesh planner — maps
    onto the `submesh` backend via `from_tenancy`: the pod-slice split is
    just the discrete, fully-isolated instance of the same abstraction.
  * share ladders (`share_ladder`) — the discrete rungs a HybridScaler's
    third coordinate-descent axis may request, and `snap` — the largest
    legal rung at or below a requested fraction.

Kinds:
  "mps"     — continuous shares in (0, 1]; cross-tenant interference term
              calibrated so uniform shares reproduce MTL time-slicing.
  "mig"     — discrete shares from `MIG_PROFILES` (the A100/H100 1g/2g/
              3g/4g/7g compute grid with 1/8..1 memory slices); hardware
              isolation suppresses cross-tenant interference.
  "submesh" — TPU pod-slice splits (disjoint chips): shares from
              `tenancy.plan`, full isolation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.serving import tenancy

# A100/H100-style MIG grid: (compute fraction, memory fraction) per
# profile, out of 7 compute slices and 8 memory slices.
MIG_COMPUTE_SLICES = 7
MIG_MEMORY_SLICES = 8
MIG_PROFILES = (          # (compute_frac, mem_frac) — 1g.10gb .. 7g.80gb
    (1 / 7, 1 / 8),
    (2 / 7, 2 / 8),
    (3 / 7, 4 / 8),
    (4 / 7, 4 / 8),
    (7 / 7, 8 / 8),
)

# MPS rungs: active-thread-percentage style eighths of the device.
MPS_LADDER = tuple((k + 1) / 8 for k in range(8))

SHARE_TOL = 1e-9          # float-sum slack for legality checks


@dataclasses.dataclass(frozen=True)
class TenantSlice:
    """One tenant's spatial grant on a device."""

    share: float                       # compute fraction in (0, 1]
    mem_fraction: float = None         # memory fraction (defaults to share)
    inv_share: float = None            # exact slowdown factor (1/share);
    #                                    pass the integer k for uniform 1/k
    #                                    grants so pricing is bit-identical
    #                                    to the MTL curves at equal share
    tenants: int = 1                   # co-resident tenants on the device
    isolation: float = 0.0             # 0 = MPS shared, 1 = MIG/submesh

    def __post_init__(self):
        if self.mem_fraction is None:
            object.__setattr__(self, "mem_fraction", self.share)
        if self.inv_share is None:
            object.__setattr__(self, "inv_share", 1.0 / self.share)

    def slowdown(self, mtl: int = 1) -> float:
        """Latency inflation factor of this slice vs sole ownership of the
        whole device at mtl=1 (GPU-side term of the partition pricing)."""
        from repro_torch.serving.device_model import EPS_MT
        x = (mtl - 1.0) + (1.0 - self.isolation) * (self.tenants - 1.0)
        return self.inv_share * mtl * (1.0 + EPS_MT * x)

    def proxy_slowdown(self) -> float:
        """Wall-clock inflation for the RealExecutor capped-batch proxy.
        The measured wall already contains the instance-stacked (vmap)
        compute, so only the share slowdown and the cross-tenant
        interference are applied on top — never the x mtl factor."""
        from repro_torch.serving.device_model import EPS_MT
        x = (1.0 - self.isolation) * (self.tenants - 1.0)
        return self.inv_share * (1.0 + EPS_MT * x)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Per-device spatial plan: one slice per resident tenant."""

    kind: str                          # "mps" | "mig" | "submesh"
    slices: tuple                      # TenantSlice per tenant
    mesh_shape: Optional[tuple] = None  # submesh backend: the pod slice

    @property
    def tenants(self) -> int:
        return len(self.slices)

    @property
    def total_share(self) -> float:
        return sum(s.share for s in self.slices)

    @property
    def headroom(self) -> float:
        return max(0.0, 1.0 - self.total_share)

    def validate(self) -> list:
        """Legality violations (empty list = legal plan)."""
        errs = []
        if self.kind not in ("mps", "mig", "submesh"):
            errs.append(f"unknown kind {self.kind!r}")
            return errs
        for i, s in enumerate(self.slices):
            if not 0.0 < s.share <= 1.0:
                errs.append(f"tenant {i}: share {s.share} outside (0, 1]")
            if not 0.0 < s.mem_fraction <= 1.0:
                errs.append(f"tenant {i}: mem {s.mem_fraction} outside (0, 1]")
        if self.total_share > 1.0 + SHARE_TOL:
            errs.append(f"shares sum to {self.total_share:.4f} > 1")
        mem_total = sum(s.mem_fraction for s in self.slices)
        if mem_total > 1.0 + SHARE_TOL:
            errs.append(f"memory slices sum to {mem_total:.4f} > 1")
        if self.kind == "mig":
            for i, s in enumerate(self.slices):
                if not any(abs(s.share - c) <= SHARE_TOL
                           and s.mem_fraction >= m - SHARE_TOL
                           for c, m in MIG_PROFILES):
                    errs.append(f"tenant {i}: share {s.share:.4f} not on "
                                f"the MIG profile grid")
        if self.kind == "submesh":
            if self.mesh_shape is None:
                errs.append("submesh plan needs a mesh_shape")
            else:
                total = self.mesh_shape[-2] * self.mesh_shape[-1]
                for i, s in enumerate(self.slices):
                    chips = s.share * total
                    if abs(chips - round(chips)) > 1e-6 or round(chips) < 1:
                        errs.append(f"tenant {i}: share {s.share:.4f} is "
                                    f"not a whole-chip submesh of "
                                    f"{self.mesh_shape}")
        return errs

    def fits_memory(self, dev, profiles: Sequence, bs_mtl: Sequence) -> bool:
        """Every tenant's model + activations fit inside its memory slice
        (`profiles[i]` / `bs_mtl[i] = (bs, mtl)` per tenant)."""
        from repro_torch.serving import device_model as dm
        for s, prof, (bs, mtl) in zip(self.slices, profiles, bs_mtl):
            sliced = dataclasses.replace(
                dev, hbm_bytes=dev.hbm_bytes * s.mem_fraction)
            if not dm.fits_memory(sliced, prof, bs, mtl):
                return False
        return True


def _isolation(kind: str) -> float:
    return 0.0 if kind == "mps" else 1.0


def uniform_plan(tenants: int, kind: str = "mps",
                 mesh_shape: Optional[tuple] = None) -> PartitionPlan:
    """Equal 1/k grants.  `inv_share` carries the exact integer factor so
    uniform partitions price bit-identically to MTL time-slicing."""
    if kind == "submesh":
        p = tenancy.plan_at_least(mesh_shape, tenants)
        if p is None:
            raise ValueError(f"{tenants} tenants do not fit {mesh_shape}")
        return from_tenancy(p, mesh_shape=mesh_shape)
    sl = TenantSlice(share=1.0 / tenants, mem_fraction=1.0 / tenants,
                     inv_share=float(tenants), tenants=tenants,
                     isolation=_isolation(kind))
    return PartitionPlan(kind=kind, slices=(sl,) * tenants)


def mps_plan(shares: Sequence[float],
             mem_fractions: Optional[Sequence[float]] = None) -> PartitionPlan:
    """Continuous (heterogeneous) MPS shares, one tenant each."""
    shares = tuple(float(s) for s in shares)
    mems = tuple(mem_fractions) if mem_fractions is not None else shares
    k = len(shares)
    slices = tuple(TenantSlice(share=s, mem_fraction=m, tenants=k,
                               isolation=0.0)
                   for s, m in zip(shares, mems))
    return PartitionPlan(kind="mps", slices=slices)


def mig_plan(shares: Sequence[float]) -> PartitionPlan:
    """Discrete MIG plan: each requested share snaps DOWN to the largest
    profile at or below it (a request below the smallest profile gets the
    smallest).  Raises on an illegal combination."""
    k = len(shares)
    slices = []
    for s in shares:
        c, m = MIG_PROFILES[0]
        for pc, pm in MIG_PROFILES:
            if pc <= s + SHARE_TOL:
                c, m = pc, pm
        slices.append(TenantSlice(share=c, mem_fraction=m, tenants=k,
                                  isolation=1.0))
    plan = PartitionPlan(kind="mig", slices=tuple(slices))
    errs = plan.validate()
    if errs:
        raise ValueError("; ".join(errs))
    return plan


def from_tenancy(p: tenancy.TenancyPlan,
                 mesh_shape: Optional[tuple] = None) -> PartitionPlan:
    """Wrap a TPU submesh split as the discrete backend of this
    abstraction: `p.replicas` equal fully-isolated slices of `p.share`."""
    mesh = mesh_shape if mesh_shape is not None else p.total
    sl = TenantSlice(share=p.share, mem_fraction=p.share,
                     tenants=p.replicas, isolation=1.0)
    return PartitionPlan(kind="submesh", slices=(sl,) * p.replicas,
                         mesh_shape=mesh)


def share_ladder(kind: str = "mps",
                 mesh_shape: Optional[tuple] = None) -> tuple:
    """The discrete rungs the scaler's third axis may request, ascending."""
    if kind == "mps":
        return MPS_LADDER
    if kind == "mig":
        return tuple(sorted({c for c, _ in MIG_PROFILES}))
    if kind == "submesh":
        total = mesh_shape[-2] * mesh_shape[-1]
        rungs = set()
        for k in range(1, total + 1):
            p = tenancy.plan(mesh_shape, k)
            if p is not None:
                rungs.add(p.share)
        return tuple(sorted(rungs))
    raise ValueError(f"unknown kind {kind!r}")


def packing_key(policy: Optional[str], *, occupied: bool,
                fill: float) -> tuple:
    """Device-ordering key fragment for the consolidate-vs-spread packing
    objective (ClusterEngine's `power_policy`).

    "pack" prefers already-powered devices, fullest first — admissions
    consolidate onto few devices so the rest stay power-gated (zero idle
    floor) at trough.  "spread" prefers empty devices, emptiest first —
    tail latency over joules at peak.  None returns the empty tuple, so
    legacy score tuples are byte-identical when no policy is set."""
    if policy == "pack":
        return (0 if occupied else 1, -fill)
    if policy == "spread":
        return (1 if occupied else 0, fill)
    return ()


def mig_step_down(share: float) -> Optional[float]:
    """The largest MIG compute fraction STRICTLY below `share`, or None
    when the share already sits at (or below) the smallest profile —
    the unit move of the admission shrink loop."""
    best = None
    for c, _ in MIG_PROFILES:
        if c < share - SHARE_TOL and (best is None or c > best):
            best = c
    return best


def snap(kind: str, share: float,
         mesh_shape: Optional[tuple] = None) -> float:
    """Largest legal rung at or below `share` (the smallest rung when the
    request sits below every rung)."""
    ladder = share_ladder(kind, mesh_shape)
    best = ladder[0]
    for r in ladder:
        if r <= share + SHARE_TOL:
            best = r
    return best


def split_for_instances(sl: TenantSlice, mtl: int,
                        kind: str = "mps") -> tuple:
    """Sub-slice one tenant's grant across its own `mtl` instances.

    MPS sub-slices are uniform; a MIG grant splits into the legal
    profiles that tile it, which is generally HETEROGENEOUS — e.g. a 7/7
    grant across 3 instances becomes (3g, 2g, 2g).  The synchronized
    batch step is gated by the slowest (smallest) instance, which is why
    `part_instances_latency` prices the max over sub-slices."""
    if mtl <= 1:
        return (sl,)
    if kind != "mig":
        child = dataclasses.replace(
            sl, share=sl.share / mtl, mem_fraction=sl.mem_fraction / mtl,
            inv_share=sl.inv_share * float(mtl))
        return (child,) * mtl
    # MIG: balanced greedy — the synchronized step is gated by the
    # SMALLEST sub-slice, so each instance takes the largest profile at or
    # below its fair share of the remaining slices (while leaving one
    # slice per remaining instance)
    total = round(sl.share * MIG_COMPUTE_SLICES)
    sizes = sorted((round(c * MIG_COMPUTE_SLICES) for c, _ in MIG_PROFILES),
                   reverse=True)
    out = []
    left, remaining = total, mtl
    for i in range(mtl):
        fair = -(-left // remaining)     # ceil(left / instances left)
        remaining -= 1
        pick = 1
        for sz in sizes:
            if sz <= min(left - remaining, fair):
                pick = sz
                break
        left -= pick
        frac = pick / MIG_COMPUTE_SLICES
        mem = next(m for c, m in MIG_PROFILES
                   if round(c * MIG_COMPUTE_SLICES) == pick)
        out.append(dataclasses.replace(
            sl, share=frac, mem_fraction=min(mem, sl.mem_fraction),
            inv_share=MIG_COMPUTE_SLICES / pick))
    return tuple(out)


def part_instances_latency(dev, prof, bs: int, slices: Sequence[TenantSlice],
                           isolation: Optional[float] = None) -> float:
    """Step latency (s) of one synchronized batch across possibly
    heterogeneous per-instance sub-slices: the slowest slice gates."""
    from repro_torch.serving import device_model as dm
    worst = 0.0
    for s in slices:
        iso = s.isolation if isolation is None else isolation
        worst = max(worst, dm.part_latency(
            dev, prof, bs, 1, inv_share=s.inv_share,
            tenants=s.tenants, isolation=iso))
    return worst
