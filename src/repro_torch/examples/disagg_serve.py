"""Disaggregated prefill/decode serving vs the single-device prefill modes.

One long-prefill ragged decode trace (2048-token-mean prompts) served
four ways on the same device class:

  cotenant — prefill as a co-resident spatial tenant on the decode
             device (the token engine's default): decode steps inflate
             by the cross-tenant interference terms and every prompt pays
             the profile's monolithic budget-priced prefill;
  chunked  — prefill split into fixed token-budget chunks piggybacked
             into decode steps (priced as bs + chunk_tokens /
             decode_token_equiv on the existing latency grid): per-token
             prefill pricing, bounded decode interference;
  static   — the fixed-shape bucketed baseline;
  disagg   — a PrefillPool of dedicated prefill devices absorbs every
             prompt, the finished KV streams over the KVTransferFabric
             (per-device-class interconnect: bandwidth + latency floor)
             into a free decode slot.  TTFT = queue + prefill +
             transfer; TPOT stays pure decode.

Request conservation — submitted == completed + rejected + backlog, with
in-flight KV transfers folded into backlog — is asserted for every mode.
The `--json` output feeds `launch/report.py --disagg`.

    PYTHONPATH=src python -m repro_torch.examples.disagg_serve
    PYTHONPATH=src python -m repro_torch.examples.disagg_serve \
        --rate 20 --pool 3 \
        --json experiments/disagg.json
"""

import argparse
import json
import os

from repro_torch.configs.base import get_config
from repro_torch.serving import device_model as dm
from repro_torch.serving.disagg import run_disagg_serving
from repro_torch.serving.token_engine import run_token_serving
from repro_torch.serving.workload import long_prefill_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--prefill-mean", type=int, default=2048)
    ap.add_argument("--kv-budget", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--pool", type=int, default=3,
                    help="prefill-pool members (disagg mode)")
    ap.add_argument("--chunk", type=int, default=512,
                    help="chunk token budget (chunked mode)")
    ap.add_argument("--ttft-slo", type=float, default=1.2)
    ap.add_argument("--tpot-slo", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    prof = dm.llm_profile(get_config(args.config), mode="decode",
                          kv_seq_budget=args.kv_budget)
    trace = long_prefill_trace(args.requests, args.seed,
                               rate_rps=args.rate,
                               prefill_mean=args.prefill_mean)
    kw = dict(seed=args.seed, trace=trace, max_slots=args.slots,
              ttft_slo_s=args.ttft_slo, tpot_slo_s=args.tpot_slo)

    reports = {}
    for mode in ("cotenant", "chunked", "static"):
        if mode == "static":
            rep = run_token_serving(prof, policy="static",
                                    static_bs=args.slots, **kw)
        else:
            rep = run_token_serving(prof, policy="continuous",
                                    prefill_mode=mode,
                                    chunk_tokens=args.chunk, **kw)
        assert rep["conserved"], f"{mode}: conservation violated"
        reports[mode] = rep
    rep = run_disagg_serving(prof, n_prefill=args.pool, n_decode=1,
                             kv_seq_budget=args.kv_budget, **kw)
    assert rep["conserved"], "disagg: conservation violated"
    reports["disagg"] = rep

    print(f"{args.config} @ {args.rate:.0f} req/s, "
          f"{args.prefill_mean}-token-mean prompts, {args.slots} slots "
          f"(TTFT<={args.ttft_slo * 1e3:.0f}ms, "
          f"TPOT<={args.tpot_slo * 1e3:.0f}ms):\n")
    print(f"{'mode':<10} {'goodput':>12} {'ttft_p95':>9} {'ttft':>6} "
          f"{'tpot_p95':>9} {'tpot':>6} {'conserved':>9}")
    for mode, r in reports.items():
        print(f"{mode:<10} {r['goodput_tokens_s']:>8.1f}tok/s "
              f"{r['ttft_p95_s'] * 1e3:>7.0f}ms {r['ttft_attainment']:>6.3f} "
              f"{r['tpot_p95_s'] * 1e3:>7.2f}ms {r['tpot_attainment']:>6.3f} "
              f"{'yes' if r['conserved'] else 'NO':>9}")
    d, fab, pool = rep, rep["fabric"], rep["pool"]
    print(f"\ndisagg fleet: {args.pool} prefill + 1 decode device; "
          f"pool prefills {pool['prefills']}")
    print(f"KV fabric ({fab['interconnect']}, "
          f"{fab['bw_bps'] / 1e9:.0f} GB/s + "
          f"{fab['latency_s'] * 1e6:.0f} us/transfer): "
          f"{fab['bytes_moved'] / 1e9:.1f} GB in {fab['transfers']} "
          f"transfers, {fab['busy_s'] * 1e3:.0f} ms on the wire")
    best = max((r["goodput_tokens_s"], m) for m, r in reports.items()
               if m != "disagg")
    print(f"disagg vs best single-device mode ({best[1]}): "
          f"{d['goodput_tokens_s'] / max(best[0], 1e-9):.2f}x goodput")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        # drop the raw per-request records: everything else is scalar
        jsonable = {m: {k: v for k, v in r.items() if k != "requests"}
                    for m, r in reports.items()}
        with open(args.json, "w") as f:
            json.dump(jsonable, f, indent=1)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
