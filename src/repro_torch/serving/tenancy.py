"""TPU tenancy planner — the pod-scale translation of GPU multi-tenancy.

A TPU core runs one program at a time, so "co-locating MTL instances" maps to
partitioning the pod slice into MTL disjoint submeshes, each hosting one
replica (DESIGN.md §2).  The planner chooses balanced submesh shapes and the
SimExecutor prices each replica at its fractional device share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TenancyPlan:
    mtl: int
    total: tuple            # full mesh shape, e.g. (16, 16)
    replica_shape: tuple    # submesh per replica
    replicas: int

    @property
    def share(self) -> float:
        full = 1
        for s in self.total:
            full *= s
        per = 1
        for s in self.replica_shape:
            per *= s
        return per / full


def plan(mesh_shape: tuple, mtl: int) -> Optional[TenancyPlan]:
    """Split (data, model) into `mtl` balanced submeshes.

    Prefers splitting the data axis (keeps per-replica TP intact), then the
    model axis.  Returns None when mtl doesn't divide the mesh.
    """
    data, model = mesh_shape[-2], mesh_shape[-1]
    d, m, rem = data, model, mtl
    # peel factors off the data axis first
    for axis in range(2):
        cur = d if axis == 0 else m
        f = _gcd_factor(cur, rem)
        if axis == 0:
            d //= f
        else:
            m //= f
        rem //= f
    if rem != 1:
        return None
    return TenancyPlan(mtl=mtl, total=(data, model),
                       replica_shape=(d, m), replicas=mtl)


def plan_at_least(mesh_shape: tuple, mtl: int) -> Optional[TenancyPlan]:
    """Smallest feasible split into >= mtl submeshes.

    A non-divisor MTL over-partitions: the slice is cut into the next
    feasible number of equal submeshes and the surplus ones sit idle —
    you cannot carve 256 chips into 3 equal submeshes, so you take the
    4-way split and run 3 replicas.  Returns None only when mtl exceeds
    the chip count."""
    total = mesh_shape[-2] * mesh_shape[-1]
    for k in range(mtl, total + 1):
        p = plan(mesh_shape, k)
        if p is not None:
            return dataclasses.replace(p, mtl=mtl)
    return None


def _gcd_factor(n: int, k: int) -> int:
    """Largest divisor of n that also divides k."""
    best = 1
    for f in range(1, min(n, k) + 1):
        if n % f == 0 and k % f == 0:
            best = f
    return best


def max_tenancy(mesh_shape: tuple) -> int:
    data, model = mesh_shape[-2], mesh_shape[-1]
    return data * model
