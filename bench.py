#!/usr/bin/env python3
"""Benchmark: END-TO-END identify throughput (reads/sec/chip) on a
non-toy corpus, versus the reference kASA binary measured on the SAME
workload.

Workload (bench_corpus.py, cached): 2047-species synthetic index
(~32M (k-mer, taxid) entries, real codon-table letter skew, conserved
multi-taxa groups incl. an overflow-tier one), 200k x 150 bp reads with
0.5% errors.  Both systems read the same reference-format artifact
family and the same fastq, and both write per-read json + profile CSV.

Ours: the full CLI fast path (native parse -> fused encode+turbo
classify jit -> native sparse rank+format -> file), match/fast.py +
match/turbo.py.  Baseline: `.golden_kASA identify` with the index in
RAM (-r), at BOTH -n 1 (the historical round-1 protocol, BASELINE.md)
and -n <all cores of this host> (README.md:172 recommends multiple
threads; VERDICT r4 asked for the multithreaded bar).  Both sides use
the identical protocol: startup-cancelled (small, big) read pairs,
N >= 3 trials, the MEDIAN reported (per-trial values ride in the JSON
so the variance band is visible).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_corpus

TMP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   ".bench_tmp")
REF_BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".golden_kASA")
TRIALS = int(os.environ.get("KASA_BENCH_TRIALS", 3))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _median_rate(pairs, c):
    """pairs: [(t_small, t_big)] -> (median_rate, rates)."""
    rates = [(c["reads_n"] - c["small_n"]) / (tb - ts)
             for ts, tb in pairs]
    return statistics.median(rates), rates


def ref_baseline(c) -> dict:
    """Median reads/s of the reference binary at -n 1 and -n <cores>
    on this corpus (cached).  Same trial protocol as ours()."""
    ncores = os.cpu_count() or 1
    cache = os.path.join(bench_corpus.DIR, "ref_baseline_v2.json")
    if os.path.exists(cache):
        with open(cache) as fh:
            d = json.load(fh)
        if d.get("trials") == TRIALS and d.get("mt_threads") == ncores:
            return d
    os.makedirs(TMP, exist_ok=True)

    def run(reads, tag, xidx, nthreads):
        cmd = [REF_BIN, "identify", "-c", c["index"] + "_content.txt",
               "-d", c["index"], "-i", reads,
               "-q", os.path.join(TMP, f"ref_{tag}.json"),
               "-p", os.path.join(TMP, f"ref_{tag}.csv"),
               "-n", str(nthreads), "-m", "5", "-r", "-t", TMP + "/",
               "-x", str(xidx)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(
                f"reference identify failed: {r.stderr[-400:]!r}")
        return dt

    out = {"trials": TRIALS, "mt_threads": ncores}
    for label, nthreads in (("1t", 1), ("mt", ncores)):
        log(f"# measuring reference baseline (-n {nthreads}, -r) x"
            f"{TRIALS} trials ...")
        pairs = []
        for trial in range(TRIALS):
            ts = run(c["reads_small"], f"small_{label}{trial}",
                     70 + trial, nthreads)
            tb = run(c["reads"], f"big_{label}{trial}",
                     80 + trial, nthreads)
            pairs.append((ts, tb))
            log(f"#   ref -n {nthreads} trial {trial}: {ts:.1f}s/"
                f"{c['small_n']}, {tb:.1f}s/{c['reads_n']} -> "
                f"{(c['reads_n'] - c['small_n']) / (tb - ts):,.0f} reads/s")
        med, rates = _median_rate(pairs, c)
        out[f"ref_{label}_reads_per_sec"] = round(med, 1)
        out[f"ref_{label}_trials"] = [round(r, 1) for r in rates]
        log(f"# reference -n {nthreads}: median {med:,.0f} reads/s "
            f"(trials: {[f'{r:,.0f}' for r in rates]})")
    with open(cache, "w") as fh:
        json.dump(out, fh)
    return out


def ours(c) -> dict:
    import contextlib

    import jax.numpy as jnp
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    from kasa_tpu.utils import timers
    from kasa_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()

    # one-time per-process warm-ups outside the timed region: device
    # start-up, turbo table load/build + upload, XLA compile
    t0 = time.perf_counter()
    float(jnp.zeros(()) + 1.0)
    log(f"# device warm-up: {time.perf_counter() - t0:.1f}s")

    def run(reads, tag):
        cfg = Config()
        cfg.engine = "tpu"
        cfg.content_file = c["index"] + "_content.txt"
        t0 = time.perf_counter()
        # identify's OUT:-prefixed progress lines go to stderr here so
        # stdout stays a single parseable JSON line
        with contextlib.redirect_stdout(sys.stderr):
            identify(cfg, index_path=c["index"], input_path=reads,
                     out_file=os.path.join(TMP, f"tpu_{tag}.json"),
                     profile_file=os.path.join(TMP, f"tpu_{tag}.csv"))
        return time.perf_counter() - t0

    os.makedirs(TMP, exist_ok=True)
    t0 = time.perf_counter()
    run(c["warm"], "warm")
    cold_s = time.perf_counter() - t0
    log(f"# tables + compile + warm batch: {cold_s:.1f}s")
    pairs = []
    for trial in range(TRIALS):
        t_small = run(c["reads_small"], f"small{trial}")
        timers.reset()
        t_big = run(c["reads"], f"big{trial}")
        pairs.append((t_small, t_big))
        rate = (c["reads_n"] - c["small_n"]) / (t_big - t_small)
        log(f"# kasa_tpu trial {trial}: {t_small:.1f}s/{c['small_n']} "
            f"reads, {t_big:.1f}s/{c['reads_n']} reads -> "
            f"{rate:,.0f} reads/s")
    med, rates = _median_rate(pairs, c)
    med_i = rates.index(sorted(rates)[len(rates) // 2]) \
        if TRIALS % 2 else 0
    t_big_med = pairs[med_i][1]
    log(f"# kasa_tpu: median {med:,.0f} reads/s over {TRIALS} trials "
        f"(band {min(rates):,.0f}..{max(rates):,.0f}; full-run rate of "
        f"the median trial {c['reads_n'] / t_big_med:,.0f})")
    log(f"# per-stage breakdown of the last {c['reads_n']:,}-read run:")
    timers.report(printer=log)
    return {"median": med, "trials": [round(r, 1) for r in rates],
            "best": max(rates), "t_big_median": t_big_med,
            "cold_start_s": round(cold_s, 1)}


def main():
    c = bench_corpus.ensure_corpus(log=log)
    log(f"# corpus: {c['n_entries']:,}-entry index, "
        f"{c['num_species']} species, {c['reads_n']:,} reads")
    ref = ref_baseline(c)
    res = ours(c)
    rate = res["median"]
    from kasa_tpu.match import fast as fast_mod
    fb, fb_tot = fast_mod.LAST_FALLBACK
    ref_1t = ref["ref_1t_reads_per_sec"]
    ref_mt = ref["ref_mt_reads_per_sec"]
    print(json.dumps({
        "metric": "identify_e2e_reads_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": (f"reads/s median of {TRIALS} (150bp, k=7..12, "
                 f"{c['n_entries']:,}-entry {c['num_species']}-species "
                 "index, end-to-end: parse->encode->classify->rank->"
                 "write, vs reference binary -r on the same workload)"),
        "vs_baseline": round(rate / ref_1t, 2),
        "trials": res["trials"],
        "best": round(res["best"], 1),
        "cold_start_s": res["cold_start_s"],
        "ref_reads_per_sec": ref_1t,
        "ref_1t_trials": ref["ref_1t_trials"],
        "ref_mt_reads_per_sec": ref_mt,
        "ref_mt_threads": ref["mt_threads"],
        "ref_mt_trials": ref["ref_mt_trials"],
        "vs_ref_1t": round(rate / ref_1t, 2),
        "vs_ref_mt": round(rate / ref_mt, 2),
        "full_run_reads_per_sec": round(
            c["reads_n"] / res["t_big_median"], 1),
        "host_fallback_pct": round(100.0 * fb / fb_tot, 3) if fb_tot
        else 0.0,
    }))


if __name__ == "__main__":
    main()
