#!/usr/bin/env python3
"""Scale proof (VERDICT r2 #4): a >= 1 GB fasta / 10,000-species corpus
driven through index build + identify, ours vs the reference binary.

Corpus design: each 100 kb genome is 90% segments drawn from a shared
100 MB pool (pan-genome redundancy -- realistic conserved content and
multi-taxa groups at scale) + 10% unique sequence, so the fasta is
~1.03 GB while the dedup'd index stays ~200M entries (2.4 GB on disk).
The resident turbo tables for 200M entries (~19 GB) may exceed one
card's memory budget, so OUR identify exercises the tiered turbo path -- exactly the
regime the out-of-core design exists for.

Steps (each cached/timed independently; rerun safe):
  1. generate the 1 GB corpus (fasta + content + 100k x 150 bp reads)
  2. kasa_tpu build_index on the 1 GB fasta -> build GB/s (the result
     is a 999M-entry / 12 GB index: pan-genome segments shared across
     taxa multiply (kmer, taxid) PAIRS, exactly like real RefSeq)
  3. reference build (-n 2, 1 h timeout)  -> build GB/s or "timeout"
  4. IDENTIFY tier (r5): a 10k-species / 400 MB corpus -> ~400M-entry
     / 4.8 GB index -- beyond the resident turbo's 2^28-entry cap, so
     ours runs the TIERED turbo path (compact 28 B/entry chunks that
     fit device memory in chunk form and upload once); reference runs -r.  This
     is the beyond-resident regime VERDICT r4 weak #4 asked to prove
     at >= 400M entries on one chip.

Prints one JSON dict; progress on stderr.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import bench_corpus

DIR = os.path.join(bench_corpus.DIR, "scale")
NUM_SPECIES = 10_000
GENOME_LEN = 100_000
POOL_LEN = 100_000_000
SEG = 5_000
UNIQ_FRAC = 0.1
READS = 100_000
READ_LEN = 150
SEED = 77


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gen_corpus():
    os.makedirs(DIR, exist_ok=True)
    fasta = os.path.join(DIR, "scale.fasta")
    content = os.path.join(DIR, "scale_content.txt")
    reads = os.path.join(DIR, "scale_reads.fastq")
    stamp = os.path.join(DIR, "GEN_DONE")
    if os.path.exists(stamp):
        return fasta, content, reads
    from kasa_tpu.index.content import ContentEntry, write_content_file
    rng = np.random.default_rng(SEED)
    dna = np.frombuffer(b"ACGT", np.uint8)
    log("# scale corpus: generating pool ...")
    pool = dna[rng.integers(0, 4, size=POOL_LEN)]
    t0 = time.time()
    qual = b"I" * READ_LEN
    n_seg = int(GENOME_LEN * (1 - UNIQ_FRAC)) // SEG
    with open(fasta, "wb") as fh, open(reads, "wb") as rf:
        for i in range(NUM_SPECIES):
            parts = [dna[rng.integers(0, 4,
                                      size=int(GENOME_LEN * UNIQ_FRAC))]]
            offs = rng.integers(0, POOL_LEN - SEG, size=n_seg)
            for off in offs:
                parts.append(pool[off:off + SEG])
            g = np.concatenate(parts)
            fh.write(b">SC%d.1 scale species %d\n" % (i + 1, i + 1))
            for j in range(0, len(g), 80):
                fh.write(g[j:j + 80].tobytes())
                fh.write(b"\n")
            for r in range(READS // NUM_SPECIES):
                off = int(rng.integers(0, len(g) - READ_LEN))
                rd = g[off:off + READ_LEN].copy()
                err = np.nonzero(rng.random(READ_LEN) < 0.005)[0]
                if len(err):
                    rd[err] = dna[rng.integers(0, 4, size=len(err))]
                rf.write(b"@sc%d_%d\n" % (i, r))
                rf.write(rd.tobytes())
                rf.write(b"\n+\n")
                rf.write(qual)
                rf.write(b"\n")
            if (i + 1) % 2000 == 0:
                log(f"#   {i + 1}/{NUM_SPECIES} genomes "
                    f"({time.time() - t0:.0f}s)")
    entries = [ContentEntry(name=f"Scale species {i}", taxid=str(i),
                            lowest_taxids=[str(i)],
                            accessions=[f"SC{i}.1"])
               for i in range(1, NUM_SPECIES + 1)]
    write_content_file(content, entries)
    open(stamp, "w").write("ok")
    log(f"# scale corpus done: {os.path.getsize(fasta) / 1e9:.2f} GB "
        f"({time.time() - t0:.0f}s)")
    return fasta, content, reads


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-ref-build", action="store_true")
    ap.add_argument("--skip-ref-identify", action="store_true")
    ap.add_argument("--ident-only", action="store_true",
                    help="skip the 1 GB build tier (reuse recorded "
                         "numbers); run only the 400M identify tier")
    ap.add_argument("--ref-timeout", type=int, default=3600)
    args = ap.parse_args()

    res = {}
    if args.ident_only:
        os.makedirs(DIR, exist_ok=True)
        prior = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench_results",
            "round5_scale.json")
        if os.path.exists(prior):
            res.update({k: v for k, v in json.load(open(prior)).items()
                        if not k.startswith("_")})
        args.skip_ref_build = True
        fasta = content = reads = None
    else:
        fasta, content, reads = gen_corpus()
        gb = os.path.getsize(fasta) / 1e9
        res["fasta_gb"] = round(gb, 3)
        res["num_species"] = NUM_SPECIES

    idx = os.path.join(DIR, "scaleIdx")
    if not args.ident_only and not os.path.exists(idx + "_info.txt"):
        from kasa_tpu.index.build import build_index
        log("# kasa_tpu build ...")
        t0 = time.time()
        limbs, taxids = build_index(
            fasta, content, idx, highest_k=12, lowest_k=7,
            temp_dir=DIR, verbose=False)
        dt = time.time() - t0
        res["ours_build_s"] = round(dt, 1)
        res["ours_build_gb_per_s"] = round(gb / dt, 4)
        res["index_entries"] = int(len(taxids))
        with open(os.path.join(DIR, "build_time.json"), "w") as fh:
            json.dump({k: res[k] for k in
                       ("ours_build_s", "ours_build_gb_per_s",
                        "index_entries")}, fh)
        log(f"# kasa_tpu build: {dt:.0f}s ({len(taxids):,} entries)")
    elif not args.ident_only:
        with open(os.path.join(DIR, "build_time.json")) as fh:
            res.update(json.load(fh))

    # reference build
    ref_bin = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".golden_kASA")
    if not args.skip_ref_build:
        cache = os.path.join(DIR, "ref_build_time.json")
        if os.path.exists(cache):
            res.update(json.load(open(cache)))
        else:
            tmp = os.path.join(DIR, "ref_tmp")
            os.makedirs(tmp, exist_ok=True)
            cmd = [ref_bin, "build", "-c", content, "-i", fasta,
                   "-d", os.path.join(tmp, "refIdx"), "-n", "2",
                   "-m", "24", "-t", tmp + "/", "-x", "95",
                   "-k", "12", "7"]
            log("# reference build (-n 2) ...")
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True,
                                   timeout=args.ref_timeout)
                dt = time.time() - t0
                if r.returncode != 0:
                    log(f"# reference build failed: {r.stderr[-200:]!r}")
                    res["ref_build_s"] = None
                else:
                    res["ref_build_s"] = round(dt, 1)
                    res["ref_build_gb_per_s"] = round(gb / dt, 4)
            except subprocess.TimeoutExpired:
                res["ref_build_s"] = f">{args.ref_timeout} (timeout)"
            json.dump({k: v for k, v in res.items()
                       if k.startswith("ref_build")}, open(cache, "w"))

    # ---- identify tier: 10k species x 40 kb -> ~400M entries
    ident_dir = os.path.join(DIR, "ident400")
    os.makedirs(ident_dir, exist_ok=True)
    ifasta = os.path.join(ident_dir, "ident.fasta")
    icontent = os.path.join(ident_dir, "ident_content.txt")
    ireads = os.path.join(ident_dir, "ident_reads.fastq")
    iidx = os.path.join(ident_dir, "identIdx")
    if not os.path.exists(os.path.join(ident_dir, "GEN_DONE")):
        from kasa_tpu.index.content import (ContentEntry,
                                            write_content_file)
        rng = np.random.default_rng(SEED + 3)
        dna = np.frombuffer(b"ACGT", np.uint8)
        qual = b"I" * READ_LEN
        log("# ident corpus: 10k x 40 kb genomes + 100k reads ...")
        with open(ifasta, "wb") as fh, open(ireads, "wb") as rf:
            for i in range(NUM_SPECIES):
                g = dna[rng.integers(0, 4, size=40_000)]
                fh.write(b">ID%d.1 ident species %d\n" % (i + 1, i + 1))
                for j in range(0, len(g), 80):
                    fh.write(g[j:j + 80].tobytes())
                    fh.write(b"\n")
                for r in range(READS // NUM_SPECIES):
                    off = int(rng.integers(0, len(g) - READ_LEN))
                    rd = g[off:off + READ_LEN].copy()
                    err = np.nonzero(rng.random(READ_LEN) < 0.005)[0]
                    if len(err):
                        rd[err] = dna[rng.integers(0, 4, size=len(err))]
                    rf.write(b"@id%d_%d\n" % (i, r))
                    rf.write(rd.tobytes())
                    rf.write(b"\n+\n")
                    rf.write(qual)
                    rf.write(b"\n")
        entries = [ContentEntry(name=f"Ident species {i}", taxid=str(i),
                                lowest_taxids=[str(i)],
                                accessions=[f"ID{i}.1"])
                   for i in range(1, NUM_SPECIES + 1)]
        write_content_file(icontent, entries)
        open(os.path.join(ident_dir, "GEN_DONE"), "w").write("ok")
    if not os.path.exists(iidx + "_info.txt"):
        from kasa_tpu.index.build import build_index
        log("# ident index build ...")
        t0 = time.time()
        _l, _t = build_index(ifasta, icontent, iidx, highest_k=12,
                             lowest_k=7, temp_dir=ident_dir,
                             verbose=False)
        res["ident_index_entries"] = int(len(_t))
        res["ident_build_s"] = round(time.time() - t0, 1)
        json.dump({k: res[k] for k in
                   ("ident_index_entries", "ident_build_s")},
                  open(os.path.join(ident_dir, "build_time.json"), "w"))
    else:
        res.update(json.load(open(
            os.path.join(ident_dir, "build_time.json"))))

    idx, content, reads = iidx, icontent, ireads
    if os.environ.get("KASA_SCALE_BUILD_ONLY"):
        # corpus + index builds done (cached); a later invocation runs
        # the identify tier when the device is free
        print(json.dumps(res, indent=1))
        return

    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    import contextlib

    def run_ours(tag):
        cfg = Config()
        cfg.engine = "tpu"
        cfg.content_file = content
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            identify(cfg, index_path=idx, input_path=reads,
                     out_file=os.path.join(DIR, f"ours_{tag}.json"),
                     profile_file=None)
        return time.time() - t0

    log("# kasa_tpu identify (cold: chunk-cache build) ...")
    t_cold = run_ours("cold")
    log(f"# cold: {t_cold:.0f}s")
    log("# kasa_tpu identify (warm) ...")
    t_warm = run_ours("warm")
    res["ours_identify_cold_s"] = round(t_cold, 1)
    res["ours_identify_warm_s"] = round(t_warm, 1)
    res["ours_identify_reads_per_s"] = round(READS / t_warm, 1)
    log(f"# warm: {t_warm:.0f}s -> {READS / t_warm:,.0f} reads/s")

    if not args.skip_ref_identify:
        tmp = os.path.join(DIR, "ref_tmp")
        os.makedirs(tmp, exist_ok=True)
        cmd = [ref_bin, "identify", "-c", content, "-d", idx,
               "-i", reads, "-q", os.path.join(tmp, "ref_out.json"),
               "-p", os.path.join(tmp, "ref_out.csv"),
               "-n", "1", "-m", "12", "-r", "-t", tmp + "/", "-x", "96"]
        log("# reference identify (-r) ...")
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True,
                               timeout=args.ref_timeout)
            dt = time.time() - t0
            if r.returncode != 0:
                log(f"# reference identify failed: {r.stderr[-200:]!r}")
                res["ref_identify_s"] = None
            else:
                res["ref_identify_s"] = round(dt, 1)
                res["ref_identify_reads_per_s"] = round(READS / dt, 1)
                res["identify_speedup"] = round(
                    dt / t_warm, 2)
        except subprocess.TimeoutExpired:
            res["ref_identify_s"] = f">{args.ref_timeout} (timeout)"

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_results",
        "round5_scale.json")
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
