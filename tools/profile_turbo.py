#!/usr/bin/env python3
"""Per-stage profile of the turbo identify path at bench-corpus scale.

Measures, on the device JAX runs on:
  * kernel-only time per batch for fused_turbo at a 33M-entry index
    (delta-timed: K chained dispatches ending in block_until_ready, so
    the fixed launch and sync cost cancels),
  * device->host readback cost per output array,
  * host-side costs: native parse, matrix assemble, rank+format+write,
  * the bytes the kernel's gathers and sorts move (a traffic model; a
    roofline share waits for a peak table keyed by device kind).

Usage: python tools/profile_turbo.py [--reads N] [--batch B]
Writes a JSON summary to stdout (one dict) and a human table to stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=None,
                    help="cap reads profiled (default: the small set)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--kernel-iters", type=int, default=10)
    ap.add_argument("--stages", action="store_true",
                    help="per-stage kernel breakdown via probe variants")
    args = ap.parse_args()

    import bench_corpus
    c = bench_corpus.ensure_corpus(log=log)
    from kasa_tpu.utils.compcache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    from kasa_tpu.config import Config
    from kasa_tpu.index import artifacts
    from kasa_tpu.match.pipeline import (load_content_for_identify,
                                         load_frequencies)
    from kasa_tpu.match.fast import BatchAssembler, _bucket, _len_bucket
    from kasa_tpu.match.turbo import load_or_build_turbo, fused_turbo
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.native import NativeRanker, load_fastx, sanitize_inplace

    res = {}

    devs = jax.devices()
    res["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs)}
    t0 = time.perf_counter()
    float(jnp.zeros(()) + 1.0)
    res["device_warmup_s"] = round(time.perf_counter() - t0, 2)
    log(f"device warm-up: {res['device_warmup_s']}s on {res['device']}")

    # ---- artifacts + tables
    t0 = time.perf_counter()
    limbs, taxids, highest_k, _ = artifacts.read_index(c["index"])
    content = load_content_for_identify(c["index"] + "_content.txt")
    freqs = load_frequencies(c["index"], content.num_species, 12, 7)
    res["artifact_load_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    tt = load_or_build_turbo(c["index"], limbs,
                             map_tax_rows(taxids, content.tax_to_idx),
                             highest_k, 7, 12, content.num_species)
    # force upload completion
    float(jnp.sum(tt.rowdat[0]))
    res["turbo_tables_s"] = round(time.perf_counter() - t0, 2)
    log(f"tables: load/build {res['turbo_tables_s']}s  n={tt.n:,}")

    # ---- parse + assemble one batch
    cfg = Config()
    min_k, max_k = 7, 12
    S = content.num_species
    t0 = time.perf_counter()
    parsed = load_fastx(c["reads_small"], True)
    seq, seq_off, name_blob, name_off, nlines = parsed
    sanitize_inplace(seq, False)
    res["parse_10k_s"] = round(time.perf_counter() - t0, 3)
    R_total = len(seq_off) - 1
    lens = np.diff(seq_off)
    if args.reads:
        R_total = min(R_total, args.reads)

    asm = BatchAssembler(highest_k, min_k, False, False, False)
    B = args.batch
    r0, r1 = 0, min(B, R_total)
    blens = lens[r0:r1]
    t0 = time.perf_counter()
    maxlen = _len_bucket(int(blens.max()) + asm.marker_len, 36)
    rows_pad = _bucket(r1 - r0, 512)
    blob = seq[seq_off[r0]:seq_off[r1]]
    offs = (seq_off[r0:r1 + 1] - seq_off[r0]).astype(np.int64)
    mat = asm.assemble(blob, offs, maxlen, rows_pad)
    res["assemble_batch_s"] = round(time.perf_counter() - t0, 4)
    w = asm.window_target(maxlen)
    log(f"batch: rows_pad={rows_pad} maxlen={maxlen} w={w}")

    from kasa_tpu.core.encode import build_codon_code_lut
    lut_np = build_codon_code_lut()
    lut = jnp.asarray(np.asarray(lut_np, np.int32))
    tabs = (tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2, tt.d_tax4,
            tt.weights, tt.masks2, tt.hotmask, tt.t_hot)
    mat_d = jnp.asarray(mat)

    def dispatch():
        return fused_turbo(*tabs, mat_d, lut, tt.num_steps, min_k, max_k,
                           highest_k, S, rows_pad, False, False, 1, w)

    # compile
    t0 = time.perf_counter()
    out = dispatch()
    float(jnp.sum(out[3][0]))
    res["compile_plus_first_s"] = round(time.perf_counter() - t0, 2)
    log(f"compile+first: {res['compile_plus_first_s']}s")

    # ---- kernel-only delta timing
    def run_k(k):
        t0 = time.perf_counter()
        last = None
        for _ in range(k):
            last = dispatch()
        jax.block_until_ready(last)
        return time.perf_counter() - t0

    run_k(2)                            # warm
    t2 = run_k(2)
    tk = run_k(args.kernel_iters)
    kernel_s = (tk - t2) / (args.kernel_iters - 2)
    res["kernel_s_per_batch"] = round(kernel_s, 4)
    res["kernel_reads_per_s"] = round(B / kernel_s, 1)
    log(f"kernel: {kernel_s*1e3:.1f} ms/batch -> {B/kernel_s:,.0f} reads/s "
        f"(t2={t2:.2f}s t{args.kernel_iters}={tk:.2f}s)")

    if args.stages:
        from kasa_tpu.match.turbo import fused_turbo_probe
        stages = ["encode", "search", "slots", "t1sort", "wsort1",
                  "wsort2", "bands", "fold", None]
        prev = 0.0
        for st in stages:
            def disp(st=st):
                return fused_turbo_probe(
                    *tabs, mat_d, lut, tt.num_steps, min_k, max_k,
                    highest_k, S, rows_pad, False, False, 1, w, st)
            t0 = time.perf_counter()
            float(jnp.sum(disp()))
            comp = time.perf_counter() - t0
            def run_p(k):
                t0 = time.perf_counter()
                last = None
                for _ in range(k):
                    last = disp()
                jax.block_until_ready(last)
                return time.perf_counter() - t0
            run_p(2)
            t2 = run_p(2)
            tk = run_p(args.kernel_iters)
            dt = (tk - t2) / (args.kernel_iters - 2)
            name = st or "full"
            res[f"stage_{name}_s"] = round(dt, 4)
            res[f"stage_{name}_delta_ms"] = round((dt - prev) * 1e3, 1)
            log(f"stage {name}: cum {dt*1e3:.1f} ms "
                f"(+{(dt-prev)*1e3:.1f} ms) [compile {comp:.0f}s]")
            prev = dt
        print(json.dumps(res, indent=1))
        return

    # ---- readback costs
    out = dispatch()
    float(jnp.sum(out[3][0]))           # ensure done
    names = ["hit_tax", "hit_ksum", "hit_cnt", "counts_all",
             "counts_unique", "ofc", "ofl"]
    total_bytes = 0
    t_all0 = time.perf_counter()
    for name, arr in zip(names, out):
        t0 = time.perf_counter()
        host = np.asarray(arr)
        dt = time.perf_counter() - t0
        res[f"fetch_{name}_s"] = round(dt, 3)
        res[f"fetch_{name}_bytes"] = host.nbytes
        total_bytes += host.nbytes
        log(f"fetch {name}: {host.nbytes/1e6:.2f} MB in {dt:.3f}s "
            f"({host.nbytes/max(dt,1e-9)/1e6:.1f} MB/s)")
    res["fetch_total_s"] = round(time.perf_counter() - t_all0, 3)
    res["fetch_total_bytes"] = total_bytes

    # fetch same outputs again via one concatenated device array
    packed = jnp.concatenate([
        jnp.asarray(o, jnp.int32).reshape(-1) if o.dtype != jnp.float32
        else jax.lax.bitcast_convert_type(o, jnp.int32).reshape(-1)
        for o in out[:5]] + [out[5].astype(jnp.int32),
                             out[6].astype(jnp.int32)])
    float(packed[0])
    t0 = time.perf_counter()
    np.asarray(packed)
    res["fetch_packed_s"] = round(time.perf_counter() - t0, 3)
    log(f"fetch packed ({packed.nbytes/1e6:.2f} MB, one array): "
        f"{res['fetch_packed_s']:.3f}s")

    # tiny-fetch latency
    t0 = time.perf_counter()
    float(jnp.sum(out[2]))
    res["scalar_fetch_s"] = round(time.perf_counter() - t0, 3)
    log(f"scalar fetch latency: {res['scalar_fetch_s']:.3f}s")

    # ---- host rank+format
    ranker = NativeRanker(content.idx_to_tax, content.organisms,
                          freqs[:, 0], min_k, max_k, highest_k, False, 3,
                          0.0, 3, "json", coherence_on=False)
    ht = np.asarray(out[0])[:r1]
    hk = np.asarray(out[1])[:r1]
    hc = np.asarray(out[2])[:r1]
    nm = [name_blob[name_off[i]:name_off[i + 1]].tobytes().decode("latin-1")
          + " " for i in range(r0, r1)]
    rep = (lens[r0:r1] + nlines[r0:r1]).astype(np.uint32)
    t0 = time.perf_counter()
    text, _ = ranker.format_sparse(ht, hk, hc, nm, rep, 0)
    res["rank_format_batch_s"] = round(time.perf_counter() - t0, 4)
    res["rank_bytes"] = len(text)
    log(f"rank+format: {res['rank_format_batch_s']}s ({len(text)} B)")

    # ---- bandwidth model for the kernel
    M = rows_pad * w
    num_k = 6
    SW = w * num_k
    n = tt.n
    # dominant device-memory traffic: rowdat row-gathers (search steps + final),
    # per-read sort passes over (R, SW) key+val, worklist sort over
    # M*num_k, multi fold sort over (R, S)
    bytes_gather = M * 32 * (tt.num_steps + 1)
    sort_elems = (2 * rows_pad * SW * 8 * 2      # T1 sort + compaction
                  + M * num_k * 8 * 2            # worklist compaction
                  + rows_pad * S * 8 * 2)        # multi fold
    res["model_gather_mb"] = round(bytes_gather / 1e6, 1)
    res["model_sort_mb_per_pass"] = round(sort_elems / 1e6, 1)
    log(f"traffic model: gathers {bytes_gather/1e6:.0f} MB, "
        f"sort arrays {sort_elems/1e6:.0f} MB per full pass")

    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
