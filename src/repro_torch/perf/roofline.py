"""The card's constants, the roofline terms the cost model reads, and the
dry-run's roofline of one rank's program.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet: the
counterpart of the hardware constants of ``repro.perf.roofline``, which
are a TPU's.  These are published peaks at the card's full 700 W power
limit; a card set below it reaches less.  ``perf.autotune`` prices its
candidates with them and ``chip_smoke.py`` computes its kernels' bounds
from them.

``bound_time_features`` and ``model_flops`` are verbatim copies of the
reference's.  ``bound_time_features`` keeps the reference's TPU v5e rates
as its defaults (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``): the cost model
always passes the priced device's own rates, and its simulated devices are
the reference's.

``Roofline``, ``analyze`` and ``save_json`` are the reference's, for
``launch/dryrun.py``: ``analyze`` counts the step function itself on meta
tensors (``perf.op_analysis``, one rank's program on DTensors) where the
reference reads a compiled module, and its three terms are priced on the
card: ``BF16_FLOPS``, ``HBM_BPS`` and ``NVLINK_BPS``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import torch

# --- TPU v5e constants, the reference's defaults for bound_time_features ---
PEAK_FLOPS = 197e12        # bf16 FLOP/s
HBM_BW = 819e9             # bytes/s
ICI_BW = 50e9              # bytes/s per link

# --- the card ---------------------------------------------------------------
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, FLOP/s
TF32_FLOPS = 495e12         # dense TF32 tensor-core peak, FLOP/s
F32_FLOPS = 67e12           # float32 peak outside the tensor cores, FLOP/s
HBM_BPS = 3.35e12           # device memory, bytes/s
SMEM_PER_BLOCK = 232_448    # shared memory one block can use (227 KB), bytes
NUM_SMS = 132               # streaming multiprocessors
# One direction of the H100 SXM's NVLink 4 (900 GB/s both ways, NVIDIA's
# data sheet): the counterpart of ICI_BW.  A 256-rank mesh spans 32
# eight-GPU nodes, whose links between nodes are slower, so t_collective
# priced at this rate is a lower bound.
NVLINK_BPS = 450e9


def bound_time_features(flops: float, hbm_bytes: float,
                        coll_bytes: float = 0.0, *,
                        peak_flops: float = PEAK_FLOPS,
                        hbm_bw: float = HBM_BW,
                        ici_bw: float = ICI_BW) -> dict:
    """Roofline-derived scalars for the learned cost model
    (``perf/cost_model.py``): the three bound times on the given device,
    which of them binds, and the arithmetic intensity.  Accepts explicit
    device rates so the same op counts can be priced per device class."""
    t_comp = flops / peak_flops
    t_mem = hbm_bytes / hbm_bw
    t_coll = coll_bytes / ici_bw
    return {
        "t_compute": t_comp,
        "t_memory": t_mem,
        "t_collective": t_coll,
        "bound_time": max(t_comp, t_mem, t_coll),
        # FLOP/byte; degenerate inputs fall back to balanced intensity
        "intensity": (flops / hbm_bytes) if hbm_bytes > 0
        else (peak_flops / hbm_bw),
    }


def model_flops(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step: 6*N*D train, 2*N*D inference
    (N = active params, D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens


@dataclasses.dataclass
class Roofline:
    flops: float               # per-rank FLOPs per step
    hbm_bytes: float           # per-rank device-memory traffic per step
    coll_bytes: float          # per-rank collective link bytes per step
    chips: int
    model_flops: float = 0.0   # analytic useful FLOPs (global)
    coll_detail: Optional[dict] = None
    xla_cost: Optional[dict] = None     # no XLA here: always None
    memory_per_chip: float = 0.0
    memory: Optional[dict] = None       # the record's memory_analysis
    # ((the mark that opened it, how many times it had), its peak bytes)
    # of each phase of the run (``_tracked``), in order
    phase_peaks: Optional[list] = None

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BPS

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """(model_flops/chips) / flops_per_chip — how much of the counted
        compute is useful; <1 means remat/replication/dispatch waste."""
        if not self.flops:
            return 0.0
        return (self.model_flops / self.chips) / self.flops

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops, "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes, "chips": self.chips,
            "model_flops_global": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "memory_per_chip": self.memory_per_chip,
            "coll_detail": self.coll_detail,
            "xla_cost": self.xla_cost,
        }


class PhaseMarks:
    """A step's phase marker (``mark=`` of ``launch/steps.py``'s steps):
    ``marks(name)`` is entered around each phase of the step (a layer
    group; the gather of the leaves outside the groups; a train step's
    forward, backward, accumulation and update; the decode append), and
    tells ``observer``, while ``analyze`` sets one, where the phase starts
    (``name``) and ends (``"/" + name``)."""

    def __init__(self):
        self.observer = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.observer:
            self.observer(name)
        try:
            yield
        finally:
            if self.observer:
                self.observer("/" + name)


def _make_tracker(device, args=()):
    """A ``MemTracker`` that also keeps the peak on ``device`` of each
    phase (``next_phase``), leaves DTensor's propagation through an op's
    decomposition untracked, and never counts the storage of a tensor in
    ``args`` (the step's arguments, which a record counts as its argument
    bytes) when the step views, reads into or writes it."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.weak import WeakIdKeyDictionary

    from repro_torch.distributed.sharding import tree_map_with_path
    from repro_torch.perf.op_analysis import propagating
    given = WeakIdKeyDictionary()

    def note(_, t):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            given[loc.untyped_storage()] = True
    tree_map_with_path(note, list(args))

    class Tracker(MemTracker):
        def __init__(self):
            super().__init__()
            self.phases = [[("", 0), 0]]
            self.seen = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, reftype, t) -> None:
            if t.untyped_storage() not in given:
                super()._track(reftype, t)

        def _now(self) -> int:
            return self._curr_mem_snap.get(device, {}).get("Total", 0)

        def next_phase(self, mark: str) -> None:
            self.seen[mark] = self.seen.get(mark, 0) + 1
            self.phases.append([(mark, self.seen[mark]), self._now()])

        def _update_peak_stats(self, peak_state) -> None:
            super()._update_peak_stats(peak_state)
            self.phases[-1][1] = max(self.phases[-1][1], self._now())
    return Tracker()


def _tracked(run, device, marks: Optional[PhaseMarks] = None,
             args=()) -> tuple:
    """(``run()``'s value, the peak bytes allocated on ``device`` while it
    ran and that peak within each phase, or None, and why not).
    ``MemTracker`` (``torch.distributed._tools``) over the run on the
    meta tensors themselves: every tensor the step makes, its results
    included, at its local shape; not the storage of its arguments
    ``args`` (a parameter the step detaches, a cache or an optimizer
    state it writes in place), nor the host tensors DTensor makes to lay
    its meshes out (once a process), nor those of its propagation
    through an op's decomposition (``op_analysis``).  A phase starts and
    ends where one of ``marks`` does (the step built with them).  Where
    the tracker fails, the run is made again without it."""
    from repro_torch.perf.op_analysis import dtensor_propagation_marked
    with dtensor_propagation_marked():
        try:
            tracker = _make_tracker(device, args)
            if marks is not None:
                marks.observer = tracker.next_phase
            try:
                with tracker:
                    value = run()
            finally:
                if marks is not None:
                    marks.observer = None
            return (value, float(max(p for _, p in tracker.phases)),
                    [tuple(p) for p in tracker.phases], None)
        except (ImportError, RuntimeError, TypeError, AttributeError) as e:
            return (run(), None, None,
                    f"MemTracker failed: {type(e).__name__}: {e}")


def memory_analysis(args, out, temp, why=None) -> dict:
    """The reference's memory_analysis keys: argument, output and alias
    bytes are this rank's shard bytes of the arguments, the results
    ``out`` and the results that are arguments (a cache written in
    place); ``temp`` the peak ``_tracked`` found."""
    from repro_torch.distributed.sharding import (local_bytes,
                                                  tree_map_with_path)
    ids = set()
    tree_map_with_path(lambda _, t: ids.add(id(t)), list(args))
    aliased = []
    tree_map_with_path(lambda _, t: aliased.append(t) if id(t) in ids
                       else None, list(out) if isinstance(out, tuple)
                       else [out])
    mem = {"argument_size": local_bytes(list(args)),
           "output_size": local_bytes(list(out) if isinstance(out, tuple)
                                      else [out]),
           "temp_size": temp, "alias_size": local_bytes(aliased),
           "generated_code_size": None}
    if why:
        mem["temp_reason"] = why
    return mem


def analyze(fn, args, cfg, shape, chips: int,
            marks: Optional[PhaseMarks] = None) -> Roofline:
    """The roofline of ``fn(*args)`` (one rank's step on meta DTensors):
    one run, counted by ``op_analysis.analyze_ops`` under ``MemTracker``
    (every meta kernel run, as the step alone runs them, so the tracker
    sees what the step allocates); ``marks``: those the step was built
    with, for each phase's peak (``phase_peaks``)."""
    from repro_torch.perf.op_analysis import analyze_ops
    results = []

    def step(*a):
        results.append(fn(*a))
        return results[-1]
    h, temp, phases, why = _tracked(
        lambda: analyze_ops(step, *args, reuse_meta=False),
        torch.device("meta"), marks, args)
    mem = memory_analysis(args, results[-1], temp, why)
    per_chip = (mem["temp_size"] or 0.0) + mem["argument_size"] \
        + mem["output_size"] - mem["alias_size"]
    return Roofline(
        flops=h["flops"], hbm_bytes=h["hbm_bytes"],
        coll_bytes=h["total_coll_bytes"], chips=chips,
        model_flops=model_flops(cfg, shape),
        coll_detail={"bytes": h["coll_bytes"], "count": h["coll_count"]},
        xla_cost=None, memory_per_chip=per_chip, memory=mem,
        phase_peaks=phases)


def save_json(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
