"""Find a cell's knee: the highest offered rate at which
completions keep up with arrivals.

    python3 -m h100_bench.sweep --workload <cell> --rates 1,2,3 \\
        --seconds 40 --seed <n>

One engine serves every rate in turn (the cell's geometry, its model
drawn from the seed); each rate runs the cell's mix with its warm-up
and a window of ``--seconds``, with no drain, and the engine empties
before the next rate. One JSON line per rate: the offered and the
completed requests per second in the window, the engine's queue
(``/load`` ``queue_depth``, sequences waiting for a slot) and running
sequences at the window's open and close, and the window's TTFT and
TPOT. A rate is sustained when the queue does not grow across the
window. The benchmark's runs never run this; its result is written
into the cell's file as a number.
"""

import argparse
import json
import sys
import time

from h100_bench import measures


def main(argv=None) -> int:
    from h100_bench import run as R
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    R.cache_env(R.ROOT)
    import torch
    from h100_bench import serve, traffic
    from h100_bench.spec import Bench
    from h100_bench.weights import dims
    bench = Bench(R.ROOT)
    wl = bench.workload(args.workload)
    cfg, cell = bench.config(wl["config"]), bench.cell(args.workload)
    cfg_path = str(bench.config_path(wl["config"]))
    mix = bench.traffic(wl["traffic"])
    dev = torch.device("cuda")
    server = serve.Server(
        serve.engine_config(cfg_path, cfg, cell, args.seed, "cuda"),
        serve.build_model(cfg_path, cfg, args.seed, dev))
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            plan = traffic.plan(mix, dict(cell, rate=rate), args.seed,
                                dims(cfg)["V"], args.seconds, 5.0)
            plan.update(url=server.url, model=server.model_id,
                        seconds=args.seconds, drain_s=0.0, trace=False,
                        deadline=time.monotonic() + mix["warm_s"]
                        + args.seconds + 60.0)
            client = R.Client(plan)
            try:
                t_open = client.lines.wait_for("open", plan["deadline"])
                at_open = server.get("/load")
                client.lines.wait_for("close", t_open + args.seconds + 30)
                at_close = server.get("/load")
                run = client.result(timeout=120.0)
            finally:
                client.close()
            win = measures.window_requests(run)
            done = [r for r in run["records"] if r["finished"]
                    and run["open"] <= r["times"][-1] <= run["close"]]
            ttft = measures.ttfts_s(run)
            tpot = measures.tpots_s(run)
            print(json.dumps({
                "rate": rate, "offered_rps": len(win) / args.seconds,
                "completed_rps": len(done) / args.seconds,
                "queue_open": at_open["queue_depth"],
                "queue_close": at_close["queue_depth"],
                "running_open": at_open["running"],
                "running_close": at_close["running"],
                "ttft_p50_ms": 1e3 * measures.percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * measures.percentile(ttft, 95),
                "tpot_p95_ms": 1e3 * measures.percentile(tpot, 95),
                "output_tok_s": measures.output_tokens_in_window(run)
                / args.seconds}), flush=True)
            deadline = time.monotonic() + 180.0
            while time.monotonic() < deadline:
                load = server.get("/load")
                if load["running"] == 0 and load["queue_depth"] == 0:
                    break
                time.sleep(0.5)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
