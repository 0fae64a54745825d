"""Multi-pod dry-run: every (arch x input-shape x mesh), the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each step on 512 placeholder CPU
devices.  Here each mesh is a ``fake`` process group (``torch``'s test
backend: collectives return at once and move nothing) of 256 or 512
ranks, this process being rank 0:

    single-pod:  (16, 16)       ("data", "model")      256 ranks
    multi-pod:   (2, 16, 16)    ("pod", "data", "model")  512 ranks

The step (``launch/steps.py``) is built on meta tensors laid out by the
reference's sharding rules and run as rank 0 (``perf.roofline``), once
under the op counter and the memory tracker together: its memory
(argument, output and alias bytes are the local shards', so exact; temp
the peak ``MemTracker`` sees over the run of what the step allocates,
not its arguments' own storage) and its roofline (FLOPs,
device-memory bytes and collective bytes of rank 0's program, by
``perf.op_analysis``, priced on the card's constants).  Each layer group
is counted at one to three layers and grown to its depth, as the
reference compiles a scan body once, and a train step's microbatches at
three and four (``analyze_step``).  ``lower_s`` is the time to build the
steps and lay out their arguments, ``compile_s`` the time to run and
count them (the reference's lowering and compilation).  Records land in
experiments/dryrun/*.json.  The default kernel path is the plain one, as
the reference's ``kernel_impl="xla"``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--mesh single|multi|both] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --report --out DIR
        [--beside REFERENCE_DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh_info
from repro_torch.perf import roofline


def skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: long_500k requires sub-quadratic/"
                "windowed attention (see DESIGN.md)")
    return None


def fake_group(world: int) -> None:
    """A ``fake`` default group of ``world`` ranks, this process rank 0
    (one made for another size is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def laid_out(arg_specs, in_shardings, minfo):
    """The step's meta arguments as DTensors of their placements."""
    return [shd.distribute(a, pl, minfo) if isinstance(a, torch.Tensor)
            else shd.distribute_tree(a, pl, minfo)
            for a, pl in zip(arg_specs, in_shardings)]


# ---------------------------------------------------------------------------
# Counting each stacked layer group once, as the reference's scan does
# ---------------------------------------------------------------------------
def group_depths(cfg) -> tuple:
    """The layer count of each of ``cfg.layer_groups``."""
    return tuple(n for _, n in cfg.layer_groups)


def at_depths(cfg, depths):
    """``cfg`` with its layer groups at ``depths``, all else the same."""
    if cfg.arch_type == "hybrid":
        new = cfg.replace(num_layers=depths[0] * (cfg.hybrid_attn_every + 1)
                          + sum(depths[1:]))
    elif cfg.is_encoder_decoder:
        new = cfg.replace(encoder_layers=depths[0], num_layers=depths[1])
    elif cfg.local_global_alternating:
        new = cfg.replace(num_layers=2 * depths[0])
    else:
        new = cfg.replace(num_layers=depths[0])
    if group_depths(new) != tuple(depths):
        raise ValueError(f"{cfg.name}: no config has groups {depths}")
    return new


def _numbers(rl: roofline.Roofline) -> dict:
    """What a record says, as numbers that grow by the same amount with
    each layer of a group."""
    out = {"flops": rl.flops, "hbm_bytes": rl.hbm_bytes}
    for part in ("bytes", "count"):
        for kind, v in rl.coll_detail[part].items():
            out[f"coll_{part}/{kind}"] = v
    for k in ("argument_size", "output_size", "alias_size", "temp_size"):
        out[k] = rl.memory[k]
    return out


def _record(nums: dict, cfg, shape, chips: int, why=None) -> roofline.Roofline:
    """The ``Roofline`` of ``_numbers`` ``nums``."""
    detail = {part: {k.split("/")[1]: v for k, v in nums.items()
                     if k.startswith(f"coll_{part}/")}
              for part in ("bytes", "count")}
    mem = {k: nums[k] for k in ("argument_size", "output_size", "temp_size",
                                "alias_size")}
    mem["generated_code_size"] = None
    if why:
        mem["temp_reason"] = why
    per_chip = (mem["temp_size"] or 0.0) + mem["argument_size"] \
        + mem["output_size"] - mem["alias_size"]
    return roofline.Roofline(
        flops=nums["flops"], hbm_bytes=nums["hbm_bytes"],
        coll_bytes=sum(detail["bytes"].values()), chips=chips,
        model_flops=roofline.model_flops(cfg, shape), coll_detail=detail,
        xla_cost=None, memory_per_chip=per_chip, memory=mem)


def _fixed_choices(cfg, minfo, shape, step_kwargs: dict) -> dict:
    """The step's choices that depend on the model's size, made for the
    whole model: the train step's microbatch count, the inference
    params' FSDP."""
    kw = dict(step_kwargs)
    if shape.kind == "train":
        kw.setdefault("num_microbatches",
                      steps_lib.default_microbatches(cfg, shape, minfo))
    else:
        kw["param_mode"] = shd.resolved_mode(
            cfg, minfo, kw.get("param_mode", "infer"))
    return kw


def _same_layout(cfg, minfo, shape, kw: dict, depths: tuple) -> bool:
    """Whether ``cfg``'s step at ``depths`` lays every argument out as the
    whole model's step does (the FSDP rule may pick a layer axis)."""
    def layout(c):
        return repr(steps_lib.make_step(c, minfo, shape, **kw)[2])
    return layout(cfg) == layout(at_depths(cfg, depths))


def analyze_step(cfg, minfo, shape, chips: int, *, fast: bool = True,
                 **step_kwargs) -> tuple:
    """(the step's ``Roofline``, seconds building steps, seconds running
    them).  ``fast=False`` runs the whole step op by op.

    ``fast``: every layer of a group is one program at one shape, as the
    reference's scan body is, so the record is the step's with every
    group at one layer, plus each group's growth: that group run at 2
    and 3 layers (the others at one) gives one more layer's FLOPs, bytes,
    collectives and argument / output / alias bytes, the same for every
    layer past the first, and the whole group adds that for each of its
    layers past the third.  The temp bytes are a peak over the run: each
    phase of the step (``roofline.PhaseMarks``: a layer group, with the
    gather of each of its layers (``steps.layer_gather``) inside it; the
    gather of the leaves outside the groups; a train step's forward,
    backward, accumulation, update) has its own peak, which grows by its
    own amount with each layer, and the record's is the largest of the
    phases' peaks so grown.

    A train step's microbatches are one program too: from the third on,
    each holds what the one before held and adds what it added.  So a
    step of more than four is grown as above at three microbatches and at
    four, and each microbatch past the fourth adds their difference to
    every number; each phase's peak (a phase of the third microbatch
    stands for the same phase of every later one) grows by its own
    difference.

    The choices that depend on the model's size are made for the whole
    model, and the whole step's argument layout must equal the shallow
    ones' leaf for leaf (the FSDP rule may pick a layer axis), else the
    whole step runs.  So does a step that has no more layers and
    microbatches than the probes run (Zamba2's six super-blocks and two
    Mamba blocks, at prefill)."""
    timing = [0.0, 0.0]

    def run(c, shp, kw):
        t0 = time.time()
        marks = roofline.PhaseMarks()
        fn, arg_specs, in_sh, _ = steps_lib.make_step(c, minfo, shp,
                                                      mark=marks, **kw)
        args = laid_out(arg_specs, in_sh, minfo)
        t1 = time.time()
        rl = roofline.analyze(fn, args, c, shp, chips, marks)
        timing[0] += t1 - t0
        timing[1] += time.time() - t1
        return rl

    full = group_depths(cfg)
    one = tuple(min(n, 1) for n in full)
    kw = _fixed_choices(cfg, minfo, shape, step_kwargs)
    nm = kw.get("num_microbatches", 1)
    per = shape.global_batch // nm
    counts = (3, 4) if nm > 4 and all(
        shd.batch_spec_axes(minfo, per * m)
        == shd.batch_spec_axes(minfo, shape.global_batch) for m in (3, 4)) \
        else (nm,)
    # layers run: the base, then each group at 2 and 3 layers
    probes = sum(one) + sum(sum(one) - 1 + d for n in full
                            for d in range(2, min(n, 3) + 1))
    if not fast or probes * sum(counts) >= sum(full) * nm \
            or not _same_layout(cfg, minfo, shape, kw, one):
        return run(cfg, shape, step_kwargs), *timing
    grown = []
    for m in counts:
        shp = dataclasses.replace(shape, global_batch=per * m)
        grown.append(_grown(cfg, one, full, lambda c: run(
            c, shp, {**kw, "num_microbatches": m} if m != nm else kw)))
    (total, peaks, why), = grown[-1:]
    if len(grown) == 2:
        (lo, lo_peaks, _), m = grown[0], counts[-1]
        total = {k: None if v is None or lo[k] is None
                 else v + (nm - m) * (v - lo[k]) for k, v in total.items()}
        peaks = peaks and lo_peaks and _microbatch_peaks(lo_peaks, peaks,
                                                         nm - m)
    if peaks:
        total["temp_size"] = float(max(peaks.values()))
    return _record(total, cfg, shape, chips, why), *timing


def _microbatch_peaks(lo: dict, hi: dict, more: int) -> dict:
    """Each phase's peak with ``more`` microbatches past ``hi``'s, from
    ``lo`` and ``hi`` (one microbatch fewer): every phase both hold grows
    by its difference; ``hi``'s last microbatch holds what the one before
    held, so it adds no phase of its own."""
    return {k: v + more * (v - lo[k]) for k, v in hi.items() if k in lo}


def _grown(cfg, one: tuple, full: tuple, run) -> tuple:
    """(``_numbers`` of ``cfg``'s step with every group grown to ``full``
    layers from ``run``s at ``one`` and each group at 2 and 3, each
    phase's grown peak by its key (or None), why a temp is missing)."""
    r0 = run(at_depths(cfg, one))
    n0, p0 = _numbers(r0), r0.phase_peaks
    total, peaks = dict(n0), dict(p0) if p0 else None
    for g, n in enumerate(full):
        if n == 1:
            continue
        seen = {1: (n0, p0)}
        for d in range(2, min(n, 3) + 1):
            depths = list(one)
            depths[g] = d
            r = run(at_depths(cfg, tuple(depths)))
            seen[d] = (_numbers(r), r.phase_peaks)
        d = min(n, 3)
        (last, lp), (prev, pp) = seen[d], seen[d - 1]
        for k, v in last.items():
            if v is None or total[k] is None:
                total[k] = None
            else:
                total[k] += v - n0[k] + (n - d) * (v - prev[k])
        if peaks is not None and lp and pp and [k for k, _ in lp] \
                == [k for k, _ in pp] == [k for k, _ in p0]:
            base, prev = dict(p0), dict(pp)
            peaks = {k: peaks[k] + v - base[k] + (n - d) * (v - prev[k])
                     for k, v in lp}
        else:
            peaks = None
    return total, peaks, r0.memory.get("temp_reason")


def _save(rec: dict, out_dir: str, variant: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    roofline.save_json(os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"),
        rec)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            verbose: bool = True, variant: str = "baseline",
            step_kwargs: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "chips": 512 if multi_pod else 256}

    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "SKIP"
        rec["reason"] = reason
        if out_dir:
            _save(rec, out_dir, variant)
        return rec

    t0 = time.time()
    try:
        fake_group(rec["chips"])
        minfo = make_mesh_info(multi_pod=multi_pod)
        rl, t_lower, t_compile = analyze_step(cfg, minfo, shape,
                                              rec["chips"],
                                              **(step_kwargs or {}))
        rec.update({
            "status": "OK",
            "lower_s": round(t_lower, 1),
            "compile_s": round(t_compile, 1),
            "memory_analysis": rl.memory,
            "roofline": rl.to_dict(),
            "constants": {"BF16_FLOPS": roofline.BF16_FLOPS,
                          "HBM_BPS": roofline.HBM_BPS,
                          "NVLINK_BPS": roofline.NVLINK_BPS},
        })
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name} x {variant}] OK "
                  f"build={t_lower:.0f}s run={t_compile:.0f}s "
                  f"dominant={rl.dominant} "
                  f"t=(c {rl.t_compute*1e3:.2f} | m {rl.t_memory*1e3:.2f} | "
                  f"x {rl.t_collective*1e3:.2f}) ms "
                  f"useful={rl.useful_flops_ratio:.2f}")
            print(f"  memory_analysis: {rl.memory}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAIL: {rec['error']}")

    if out_dir:
        _save(rec, out_dir, variant)
    return rec


CARD_BYTES = 80e9          # one H100's device memory


def _fit(r: dict):
    """An OK record's per-rank argument + temp bytes (temp 0 where it has
    none), else None."""
    if r.get("status") != "OK":
        return None
    m = r["memory_analysis"]
    return m["argument_size"] + (m["temp_size"] or 0.0)


def report(out_dir: str, beside: str | None = None) -> str:
    """The records under ``out_dir`` as a markdown table: per-rank
    argument + temp bytes against one card's 80 GB, the dominant roofline
    term, the useful-FLOPs ratio and the record's seconds.  ``beside``: a
    directory of other records of the same names (the reference's
    ``repro.launch.dryrun`` records), whose argument + temp bytes are set
    beside each, with the ratio."""
    import glob
    import json
    extra = " reference (GB) | port / reference |" if beside else ""
    rows = ["| arch | shape | mesh | status | args + temp per rank (GB) "
            "| of 80 GB | dominant | useful | s |" + extra,
            "|---|---|---|---|---|---|---|---|---|" + (
                "---|---|" if beside else "")]
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        cells = [r["arch"], r["shape"], r["mesh"], r["status"]]
        fit = _fit(r)
        if fit is not None:
            m, rl = r["memory_analysis"], r["roofline"]
            cells += [f"{fit / 1e9:.2f}" + ("" if m["temp_size"] is not None
                                             else " (no temp)"),
                      f"{fit / CARD_BYTES:.1%}", rl["dominant"],
                      f"{rl['useful_flops_ratio']:.3f}",
                      f"{r['lower_s'] + r['compile_s']:.1f}"]
        else:
            cells += ["", "", "", "", ""]
        if beside:
            other = os.path.join(beside, os.path.basename(path))
            ref = None
            if os.path.exists(other):
                with open(other) as f:
                    ref = _fit(json.load(f))
            cells += ["" if ref is None else f"{ref / 1e9:.2f}",
                      "" if ref is None or fit is None
                      else f"{fit / ref:.2f}"]
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default all)")
    ap.add_argument("--shape", default=None, help="single shape (default all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--variant", default="baseline",
                    help="label; combine with --windowed/--param-mode/--micro")
    ap.add_argument("--windowed", action="store_true",
                    help="ring-buffer caches for sliding-window layers (decode)")
    ap.add_argument("--param-mode", default=None,
                    help="override inference param sharding: infer|tp")
    ap.add_argument("--micro", type=int, default=None,
                    help="override train microbatch count")
    ap.add_argument("--report", action="store_true",
                    help="print the records under --out as a table; run "
                         "nothing")
    ap.add_argument("--beside", default=None,
                    help="with --report: a directory of the reference's "
                         "records, set beside the port's")
    args = ap.parse_args()
    if args.report:
        print(report(args.out, args.beside))
        return

    step_kwargs = {}
    if args.windowed:
        step_kwargs["windowed_cache"] = True
    if args.param_mode:
        step_kwargs["param_mode"] = args.param_mode
    if args.micro:
        step_kwargs["num_microbatches"] = args.micro

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    try:
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    results.append(run_one(arch, shape, multi, args.out,
                                           variant=args.variant,
                                           step_kwargs=step_kwargs))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    ok = sum(r["status"] == "OK" for r in results)
    skip = sum(r["status"] == "SKIP" for r in results)
    fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n=== dry-run summary: {ok} OK / {skip} SKIP / {fail} FAIL "
          f"of {len(results)} ===")
    for r in results:
        if r["status"] == "FAIL":
            print(f"  FAIL {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['error']}")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
