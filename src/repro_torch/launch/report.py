"""Generate the EXPERIMENTS.md roofline tables from dry-run JSON artifacts,
and (optionally) the cluster-serving comparison table from the JSON that
examples/cluster_serve.py --json dumps.

    PYTHONPATH=src python -m repro_torch.launch.report \
        --baseline experiments/dryrun --final experiments/dryrun_final \
        --cluster experiments/cluster.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_dir(d: str) -> dict:
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        r = json.load(open(f))
        key = (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
        out[key] = r
    return out


def fmt_ms(x: float) -> str:
    if x >= 1.0:
        return f"{x:.1f}s"
    return f"{x * 1e3:.2f}ms"


def roofline_table(recs: dict, mesh: str, variant: str) -> str:
    from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES
    lines = [
        "| arch | shape | status | t_comp | t_mem | t_coll | dominant | "
        "useful | mem/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            r = recs.get((arch, shape, mesh, variant))
            if r is None:
                continue
            if r["status"] == "SKIP":
                lines.append(f"| {arch} | {shape} | SKIP (full attention; "
                             f"DESIGN.md) | — | — | — | — | — | — |")
                continue
            if r["status"] != "OK":
                lines.append(f"| {arch} | {shape} | **FAIL** | — | — | — | — "
                             f"| — | — |")
                continue
            rl = r["roofline"]
            mem = r["memory_analysis"]
            live = (mem["argument_size"] + mem["temp_size"]
                    - mem["alias_size"]) / 1e9
            lines.append(
                f"| {arch} | {shape} | OK | {fmt_ms(rl['t_compute'])} | "
                f"{fmt_ms(rl['t_memory'])} | {fmt_ms(rl['t_collective'])} | "
                f"{rl['dominant']} | {rl['useful_flops_ratio']:.2f} | "
                f"{live:.1f}GB |")
    return "\n".join(lines)


def cluster_tables(reports: dict) -> str:
    """Markdown for a multi-policy cluster run ({mode: ClusterEngine report},
    the structure examples/cluster_serve.py dumps)."""
    parts = ["| policy | aggregate thr | feasible jobs meeting SLO | "
             "instance stalls |", "|---|---|---|---|"]
    for mode, rep in reports.items():
        a = rep["aggregate"]
        parts.append(
            f"| {mode} | {a['aggregate_throughput']:.1f}/s | "
            f"{a['jobs_meeting_slo']}/{a['feasible_jobs']} | "
            f"{a['total_stall_s']:.1f}s |")
    ref = reports.get("auto") or next(iter(reports.values()))
    cmp_mode = "hybrid" if "hybrid" in reports else None
    parts.append("\n| job | dnn/dataset | device | approach | bs | mtl | "
                 "thr/s | tail p95 | SLO |")
    parts.append("|---|---|---|---|---|---|---|---|---|")
    for r in (reports.get(cmp_mode) or ref)["per_job"]:
        parts.append(
            f"| {r['job_id']} | {r['dnn']} | {r['device']} | "
            f"{r['approach']} | {r['bs']} | {r['mtl']} | "
            f"{r['throughput']:.1f} | {r['tail_p95_ms']:.1f}ms | "
            f"{r['slo_ms']:.1f}ms |")
    return "\n".join(parts)


def churn_tables(reports: dict) -> str:
    """Markdown for a churn run ({policy: ClusterEngine report}, the
    structure examples/cluster_churn.py dumps)."""
    parts = ["| policy | goodput | throughput | admissions | drains | "
             "migrations | migration stalls | conserved |",
             "|---|---|---|---|---|---|---|---|"]
    for policy, rep in reports.items():
        a = rep["aggregate"]
        parts.append(
            f"| {policy} | {a['goodput']:.1f}/s | "
            f"{a['aggregate_throughput']:.1f}/s | {a['admissions']} | "
            f"{a['drains']} | {a['migrations']} | "
            f"{a['migration_stall_s']:.1f}s | "
            f"{'yes' if a['conserved'] else 'NO'} |")
    best = reports.get("surface") or next(iter(reports.values()))
    parts.append("\n| job | dnn/dataset | device | lifetime | bs | mtl | "
                 "migs | submitted | completed | rejected | attain |")
    parts.append("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in best["per_job"]:
        end = (f"{r['drained_at']:.0f}s" if r["drained_at"] is not None
               else "end")
        parts.append(
            f"| {r['job_id']} | {r['dnn']} | {r['device']} | "
            f"{r['admit_s']:.0f}s-{end} | {r['bs']} | {r['mtl']} | "
            f"{r['migrations']} | {r['submitted']} | {r['completed']} | "
            f"{r['rejected']} | {r['slo_attainment']:.3f} |")
    return "\n".join(parts)


def partition_tables(reports: dict) -> str:
    """Markdown for a spatial-partitioning run ({policy: ClusterEngine
    report}, the structure examples/partition_serve.py dumps): the policy
    comparison (heterogeneous shares + cheap resizes vs the uniform-MTL
    baseline) and the per-tenant share table of the best policy."""
    parts = ["| policy | goodput | throughput | resizes | resize stalls | "
             "equiv migration stalls | migrations | migration stalls | "
             "conserved |",
             "|---|---|---|---|---|---|---|---|---|"]
    for policy, rep in reports.items():
        a = rep["aggregate"]
        parts.append(
            f"| {policy} | {a['goodput']:.1f}/s | "
            f"{a['aggregate_throughput']:.1f}/s | {a['resizes']} | "
            f"{a['resize_stall_s']:.2f}s | "
            f"{a['resize_equiv_migration_stall_s']:.1f}s | "
            f"{a['migrations']} | {a['migration_stall_s']:.1f}s | "
            f"{'yes' if a['conserved'] else 'NO'} |")
    best = reports.get("het") or next(iter(reports.values()))
    parts.append("\n| job | dnn/dataset | device | share | bs | mtl | "
                 "resizes | thr/s | attain |")
    parts.append("|---|---|---|---|---|---|---|---|---|")
    for r in best["per_job"]:
        share = f"{r['share']:.3f}" if r.get("share") is not None else "—"
        parts.append(
            f"| {r['job_id']} | {r['dnn']} | {r['device']} | {share} | "
            f"{r['bs']} | {r['mtl']} | {r.get('resizes', 0)} | "
            f"{r['throughput']:.1f} | {r['slo_attainment']:.3f} |")
    return "\n".join(parts)


def scenario_tables(reports: dict) -> str:
    """Markdown for a scenario-matrix run ({cell: ClusterEngine report},
    the structure examples/scenario_matrix.py dumps): goodput, minimum
    per-job SLO attainment, and the energy column the power-packing
    objective moves (joules per good request)."""
    parts = ["| cell | goodput | min attain | J/good req | $/good req | "
             "energy | devices powered | evacuated | killed | conserved |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for cell, rep in reports.items():
        a = rep["aggregate"]
        jpg = a.get("joules_per_good_request")
        cpg = a.get("cost_per_good_request")
        parts.append(
            f"| {cell} | {a['goodput']:.1f}/s | "
            f"{a['min_attainment']:.3f} | "
            f"{f'{jpg:.4f}J' if jpg is not None else '—'} | "
            f"{f'${cpg:.3g}' if cpg is not None else '—'} | "
            f"{a['energy_j']:.0f}J | {a['devices_powered']} | "
            f"{a['preempt_evacuated']} | {a['preempt_killed']} | "
            f"{'yes' if a['conserved'] else 'NO'} |")
    return "\n".join(parts)


def disagg_tables(reports: dict) -> str:
    """Markdown for a disaggregated-serving comparison ({mode: token
    report}, the structure examples/disagg_serve.py dumps): goodput, the
    two per-token SLO attainments, and — for the disagg row — the
    KV-transfer fabric's accounting."""
    parts = ["| mode | goodput | TTFT p95 | TTFT attain | TPOT p95 | "
             "TPOT attain | KV moved | wire time | conserved |",
             "|---|---|---|---|---|---|---|---|---|"]
    for mode, rep in reports.items():
        fab = rep.get("fabric")
        kv = f"{fab['bytes_moved'] / 1e9:.1f}GB" if fab else "—"
        wire = f"{fab['busy_s'] * 1e3:.0f}ms" if fab else "—"
        parts.append(
            f"| {mode} | {rep['goodput_tokens_s']:.0f} tok/s | "
            f"{rep['ttft_p95_s'] * 1e3:.0f}ms | "
            f"{rep['ttft_attainment']:.3f} | "
            f"{rep['tpot_p95_s'] * 1e3:.2f}ms | "
            f"{rep['tpot_attainment']:.3f} | {kv} | {wire} | "
            f"{'yes' if rep['conserved'] else 'NO'} |")
    return "\n".join(parts)


def profile_store_tables(store) -> str:
    """Markdown summary of a cross-run profile store: what knowledge the
    next run starts with (tuned tiles + generation, persisted surface
    rows, migration calibrations)."""
    import numpy as np
    s = store.stats()
    parts = [f"_store `{s['root']}` (schema {s['schema']}, tuned-tile "
             f"generation {s['generations'].get('autotune', 0)}, "
             f"{s['sections'].get('autotune', 0)} autotune entries)_\n"]
    surfaces = store.section("surfaces")
    if surfaces:
        parts.append("| surface row | device class | points | autotune gen |")
        parts.append("|---|---|---|---|")
        for sk in sorted(surfaces):
            r = surfaces[sk]
            parts.append(f"| {r.get('signature', sk)} | "
                         f"{r.get('device_class', '?')} | "
                         f"{r.get('points', '?')} | "
                         f"{r.get('autotune_generation', '?')} |")
    migrations = store.section("migrations")
    if migrations:
        parts.append("\n| migration calibration | samples | p50 | p90 |")
        parts.append("|---|---|---|---|")
        for mk in sorted(migrations):
            samples = [x for x in migrations[mk].get("samples", [])
                       if isinstance(x, (int, float))]
            if not samples:
                continue
            parts.append(
                f"| {mk} | {len(samples)} | "
                f"{float(np.quantile(samples, 0.5)) * 1e3:.1f}ms | "
                f"{float(np.quantile(samples, 0.9)) * 1e3:.1f}ms |")
    cost_models = store.section("cost_model")
    if cost_models:
        parts.append("\n| cost model | schema | trained rows | signatures | "
                     "share rungs | autotune gen |")
        parts.append("|---|---|---|---|---|---|")
        for dc in sorted(cost_models):
            r = cost_models[dc]
            if not isinstance(r, dict):
                continue
            parts.append(
                f"| {dc} | {r.get('schema', '?')} | "
                f"{r.get('n_rows', '?')} | "
                f"{len(r.get('train_signatures', []) or [])} | "
                f"{len(r.get('rung_factors', {}) or {})} | "
                f"{r.get('autotune_generation', '?')} |")
    interference = store.section("interference")
    if interference:
        parts.append("\n| partition interference | samples | "
                     "median inflation |")
        parts.append("|---|---|---|")
        for ik in sorted(interference):
            rung, _, share = ik.rpartition("|share=")
            try:
                factor = store.interference_factor(rung, float(share))
            except (TypeError, ValueError):
                continue
            if factor is None:
                continue
            n = len(interference[ik].get("samples", []))
            parts.append(f"| {ik} | {n} | x{factor:.2f} |")
    return "\n".join(parts)


def collect_summary(recs: dict, variant: str) -> str:
    n = {"OK": 0, "SKIP": 0, "FAIL": 0}
    for (a, s, m, v), r in recs.items():
        if v == variant:
            n[r["status"]] = n.get(r["status"], 0) + 1
    return f"{n['OK']} OK / {n['SKIP']} SKIP / {n['FAIL']} FAIL"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="experiments/dryrun")
    ap.add_argument("--final", default="experiments/dryrun_final")
    ap.add_argument("--cluster", default=None,
                    help="cluster_serve.py --json output to tabulate")
    ap.add_argument("--churn", default=None,
                    help="cluster_churn.py --json output to tabulate")
    ap.add_argument("--partition", default=None,
                    help="partition_serve.py --json output to tabulate")
    ap.add_argument("--scenarios", default=None,
                    help="scenario_matrix.py --json output to tabulate")
    ap.add_argument("--disagg", default=None,
                    help="examples/disagg_serve.py --json output to "
                         "tabulate (disagg vs co-tenant vs chunked)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="cross-run profile store dir to summarize "
                         "(perf.profile_store)")
    ap.add_argument("--replay", default=None, metavar="NAME",
                    help="what-if analysis of a run recorded with "
                         "`serve --record NAME`: re-drive the trace under "
                         "counterfactual policies (uniform MTL, MIG'd "
                         "fleet, 20%% fewer devices) and print the diff "
                         "table")
    ap.add_argument("--out", default="experiments/roofline_tables.md")
    args = ap.parse_args()

    if args.replay:
        from repro_torch.perf.profile_store import store_for
        from repro_torch.serving import replay as rp
        store = store_for(args.store)   # None -> $REPRO_PROFILE_STORE
        trace = rp.load_trace(store, args.replay)
        meta = trace["init"].get("meta", {})
        print(f"replay of {args.replay!r} "
              f"(entry={meta.get('entry', '?')}, "
              f"{trace['event_count']} recorded events):\n")
        print(rp.diff_table(rp.replay_diff(trace)))
        return

    base = load_dir(args.baseline)
    final = load_dir(args.final)

    parts = []
    parts.append("### Baseline roofline — single-pod 16x16 (256 chips)\n")
    parts.append(f"_{collect_summary(base, 'baseline')} "
                 f"(mesh=single+multi combined)_\n")
    parts.append(roofline_table(base, "single", "baseline"))
    parts.append("\n### Baseline roofline — multi-pod 2x16x16 (512 chips)\n")
    parts.append(roofline_table(base, "multi", "baseline"))
    if final:
        parts.append("\n### Final (optimized defaults) — single-pod\n")
        parts.append(f"_{collect_summary(final, 'final')}_\n")
        parts.append(roofline_table(final, "single", "final"))
        parts.append("\n### Final (optimized defaults) — multi-pod\n")
        parts.append(roofline_table(final, "multi", "final"))
    if args.cluster and os.path.exists(args.cluster):
        parts.append("\n### Cluster serving — 30-job Table-4 trace\n")
        parts.append(cluster_tables(json.load(open(args.cluster))))
    if args.churn and os.path.exists(args.churn):
        parts.append("\n### Online churn — admission/draining with "
                     "migration-aware re-placement\n")
        parts.append(churn_tables(json.load(open(args.churn))))
    if args.partition and os.path.exists(args.partition):
        parts.append("\n### Spatial partitioning — heterogeneous shares "
                     "vs uniform multi-tenancy\n")
        parts.append(partition_tables(json.load(open(args.partition))))
    if args.scenarios and os.path.exists(args.scenarios):
        parts.append("\n### Scenario matrix — traffic shape x spot "
                     "capacity x power packing\n")
        parts.append(scenario_tables(json.load(open(args.scenarios))))
    if args.disagg and os.path.exists(args.disagg):
        parts.append("\n### Disaggregated prefill/decode — pool + "
                     "KV-transfer fabric vs single-device modes\n")
        parts.append(disagg_tables(json.load(open(args.disagg))))
    if args.store:
        from repro_torch.perf.profile_store import ProfileStore
        parts.append("\n### Cross-run profile store\n")
        parts.append(profile_store_tables(ProfileStore(args.store)))

    text = "\n".join(parts) + "\n"
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    open(args.out, "w").write(text)
    print(f"wrote {args.out} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
