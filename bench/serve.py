"""The served path under test, built as the program's ``serve_real``
builds it, and the measured window around it.

``make_controller("dnnscaler", ...)`` over a ``RealExecutor`` whose
callable is ``api.generate`` at the traffic's prompt length and new
tokens, one CUDA graph per batch bucket (``aot=True``), each step staging
its bucket's prompts from the host (``donate_batch=True``), driven by
``ServingEngine.run``.  The benchmark wraps the executor and the
controller in its own classes, which stamp every step on the host clock
and end the window; nothing of the engine's simulated clock is read.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.kernels import build
from repro_torch.launch.serve import make_controller
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor

from bench.weights import SeededWeights

STEP, CONTROLLER = "bench.step", "bench.controller"
KINDS = ("closed_loop",)     # the traffic kinds this harness serves


class WindowClosed(Exception):
    """Raised by the executor's wrapper at the first step the window no
    longer admits; the engine's loop ends with it."""


@dataclasses.dataclass
class Step:
    id: int               # which requests it served (``Requests.batch``)
    t0: float             # host clock when the engine asked for the step
    t1: float             # host clock when it returned (synchronised)
    items: int            # requests served: bs x mtl
    bucket: int           # the bucket's rows the replay computed
    misses: int           # bucket-cache misses the step paid for


class Requests:
    """Every step's own prompts: rows cut from one pool of token ids drawn
    from the seed on the host, at an offset set by the step's id, so no
    two steps serve the same requests."""

    POOL = 1 << 24
    STRIDE = 7_919_993          # prime, so the offsets cover the pool

    def __init__(self, seed: int, T: int, vocab: int):
        self.T, self.vocab = T, vocab
        self.draw(seed)

    def draw(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed % 2 ** 63)
        self.pool = torch.randint(0, self.vocab, (self.POOL,), generator=gen,
                                  dtype=torch.int32)

    def batch(self, step: int, n: int) -> torch.Tensor:
        """(n, T) prompts of step ``step``."""
        span = self.POOL - n * self.T
        off = (step * self.STRIDE) % span
        return self.pool[off:off + n * self.T].view(n, self.T)


class TimedExecutor:
    """The program's executor, each ``run_step`` stamped on the host clock
    and fed its own requests: the bucket's host batch, which the executor
    stages to the card every step (``donate_batch``), is written with the
    step's prompts first.  A step asked for at or after ``deadline``
    raises ``WindowClosed``."""

    def __init__(self, executor: RealExecutor, requests: Requests,
                 made: dict):
        self.executor = executor
        self.requests = requests
        self.made = made            # bucket rows -> what its run returns
        self.steps: list = []
        self.deadline = None
        self.current = 0            # the id of the step being served
        self.outputs: dict = {}     # step id -> its served tokens

    def __getattr__(self, name):
        return getattr(self.executor, name)

    def run_step(self, bs: int, mtl: int) -> dict:
        t0 = time.perf_counter()
        if self.deadline is not None and t0 >= self.deadline:
            raise WindowClosed
        self.current += 1
        sid = self.current
        nb = self.executor.bucket(bs * mtl)
        entry = self.executor._exec.get(nb)
        if entry is not None and entry.host is not None:
            entry.host["tokens"].copy_(self.requests.batch(sid, nb))
        misses = self.executor.cache_stats.misses
        with record_function(STEP):
            res = self.executor.run_step(bs, mtl)
        self.steps.append(Step(sid, t0, time.perf_counter(), res["items"],
                               nb, self.executor.cache_stats.misses - misses))
        # the served tokens, taken as the step returns: a bucket's graph
        # output lives in the pool the buckets share, and a later replay
        # of another bucket may write over it
        self.outputs[sid] = self.made[nb].clone()
        return res


class TimedController:
    """The program's controller, its host time per call summed."""

    def __init__(self, controller):
        self.controller = controller
        self.host_s = 0.0

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        with record_function(CONTROLLER):
            out = fn(*args)
        self.host_s += time.perf_counter() - t0
        return out

    def set_slo(self, slo_s: float) -> None:
        self._timed(self.controller.set_slo, slo_s)

    def action(self):
        return self._timed(self.controller.action)

    def observe(self, p95: float, result=None) -> None:
        self._timed(self.controller.observe, p95, result)


class Served:
    """One cell's served path: the weights from the seed, the executor and
    its buckets, and a controller per window."""

    def __init__(self, cell, seed: int, device):
        if cell.traffic["kind"] not in KINDS:
            raise ValueError(f"traffic kind {cell.traffic['kind']!r}: the "
                             f"harness serves only {KINDS}")
        self.device = torch.device(device)
        self.cfg = cfg = ModelConfig(**cell.conf["port"])
        build.build(*cell.conf["kernels"])
        self.weights = SeededWeights(api.param_specs(cfg), torch_dtype(cfg),
                                     self.device, seed)
        T, steps = cell.traffic["prompt_len"], cell.traffic["new_tokens"]
        self.T = T

        # what each bucket's run returns: on the card the graph's output,
        # which every replay writes; run eagerly, the last run's
        self.made: dict = {}

        def serve_fn(params, batch):
            out = api.generate(params, batch, cfg, steps)
            self.made[out.shape[0]] = out
            return out

        self.requests = Requests(seed, T, cfg.vocab_size)

        def make_batch(n):
            # a bucket's first batch: the prompts of the step that reaches
            # it (of step 0, when warmed ahead of serving)
            return {"tokens": self.requests.batch(self.timed.current, n)
                    .to(self.device)}

        self.executor = RealExecutor(serve_fn, self.weights.params,
                                     make_batch, donate_batch=True, aot=True)
        self.timed = TimedExecutor(self.executor, self.requests, self.made)
        k = cell.knobs["controller"]
        self.knobs = k
        self.buckets = sorted({self.executor.bucket(i) for i in range(
            1, max(k["max_bs"], k["max_mtl"]) + 1)}, reverse=True)

    def warm(self) -> None:
        """Every bucket the controller can reach, largest first (so the
        smaller graphs carve their memory out of the largest one's pool):
        the Profiler probes (1, 1), (m, 1) and (1, n), then the Scaler moves
        bs at mtl 1 or mtl at bs 1."""
        for n in self.buckets:
            self.executor.warmup(n, 1)

    def reseed(self, seed: int) -> None:
        """New weights and requests from ``seed``, the weights in the same
        tensors, so the captured graphs read them (the control's many seeds
        in one process)."""
        self.weights.fill(seed)
        self.requests.draw(seed)

    def controller(self, slo_s: float) -> TimedController:
        """A fresh DNNScaler controller; its Profiler probes run here."""
        k = self.knobs
        ctrl = make_controller(k["name"], self.timed, slo_s, m=k["m"],
                               n=k["n"], max_bs=k["max_bs"],
                               max_mtl=k["max_mtl"])
        return TimedController(ctrl)


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    steps: list
    host_s: float
    engine: ServingEngine

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def serve_window(served: Served, ctrl: TimedController, slo_s: float,
                 seconds: float) -> Window:
    """The engine's loop for ``seconds``: every step asked for before the
    deadline runs, and the window ends with the last one's return."""
    timed = served.timed
    engine = ServingEngine(timed, slo_s, instance_launch_s=0.2)
    timed.steps = []
    ctrl.host_s = 0.0
    t0 = time.perf_counter()
    timed.deadline = t0 + seconds
    try:
        engine.run(ctrl, max_steps=10 ** 9)
    except WindowClosed:
        pass
    finally:
        timed.deadline = None
    steps = list(timed.steps)
    if not steps:
        raise RuntimeError("the window served no step")
    return Window(t0, steps[-1].t1, steps, ctrl.host_s, engine)
