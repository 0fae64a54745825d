"""Multi-pod dry-run: every (arch x input-shape x mesh), the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each step on 512 placeholder CPU
devices.  Here each mesh is a ``fake`` process group (``torch``'s test
backend: collectives return at once and move nothing) of 256 or 512
ranks, this process being rank 0:

    single-pod:  (16, 16)       ("data", "model")      256 ranks
    multi-pod:   (2, 16, 16)    ("pod", "data", "model")  512 ranks

The step (``launch/steps.py``) is built on meta tensors laid out by the
reference's sharding rules and run once as rank 0 (``perf.roofline``):
its memory (argument, output and alias bytes are the local shards', so
exact; temp the peak ``MemTracker`` sees over the run) and its roofline
(FLOPs, device-memory bytes and collective bytes of rank 0's program, by
``perf.op_analysis``, priced on the card's constants).  ``lower_s`` is
the time to build the step and lay out its arguments, ``compile_s`` the
time to run and count it (the reference's lowering and compilation).
Records land in experiments/dryrun/*.json.  The default kernel path is
the plain one, as the reference's ``kernel_impl="xla"``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--mesh single|multi|both] [--out DIR]
"""

from __future__ import annotations

import argparse
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
        fn, arg_specs, in_sh, _ = steps_lib.make_step(cfg, minfo, shape,
                                                      **(step_kwargs or {}))
        args = laid_out(arg_specs, in_sh, minfo)
        t_lower = time.time() - t0
        rl = roofline.analyze(fn, args, cfg, shape, rec["chips"])
        t_compile = time.time() - t0 - t_lower
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


def report(out_dir: str) -> str:
    """The records under ``out_dir`` as a markdown table: per-rank
    argument + temp bytes against one card's 80 GB, the dominant roofline
    term, the useful-FLOPs ratio and the record's seconds."""
    import glob
    import json
    rows = ["| arch | shape | mesh | status | args + temp per rank (GB) "
            "| of 80 GB | dominant | useful | s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        cells = [r["arch"], r["shape"], r["mesh"], r["status"]]
        if r["status"] == "OK":
            m, rl = r["memory_analysis"], r["roofline"]
            fit = m["argument_size"] + (m["temp_size"] or 0.0)
            cells += [f"{fit / 1e9:.2f}" + ("" if m["temp_size"] is not None
                                             else " (no temp)"),
                      f"{fit / CARD_BYTES:.1%}", rl["dominant"],
                      f"{rl['useful_flops_ratio']:.3f}",
                      f"{r['lower_s'] + r['compile_s']:.1f}"]
        else:
            cells += ["", "", "", "", ""]
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
    args = ap.parse_args()
    if args.report:
        print(report(args.out))
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
