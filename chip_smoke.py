#!/usr/bin/env python3
"""Run identify end to end on the GPU and check what it computes.

    python3 chip_smoke.py           # one card: environment, identify, parity
    python3 chip_smoke.py --four    # four cards: the (dp, ip) mesh phase only

Data is the bench corpus (bench_corpus.ensure_corpus), generated from its
seed on first use: a 2,047-species index of 32,678,008 (k-mer, taxid)
entries and 150 bp reads with 0.5 % substitution errors.  Nothing is
downloaded.  Outputs go to .smoke/ in the checkout.

One card, each phase timed on its own line:
  1. environment: the card's name and power limit (nvidia-smi, before
     JAX touches the card), JAX's devices, version and compile cache.
     Fails unless JAX's default backend is the GPU and the native
     library loads.
  2. identify: CLI identify on 12,288 reads with the default engine.
     The run must take the resident turbo dispatch and write a
     well-formed json and profile; the host-fallback share, the stage
     timers and the device's peak memory are printed (one run, not a
     benchmark).
  3. parity on the first 4,096 reads: the turbo results against the
     exact engine (read number, specifier and length per read, and the
     profile's unique counts: integers, identical), and the
     per-(read, taxon) scores that identify handed its ranker against a
     float64 numpy oracle of the intended semantics, which encodes the
     reads from the fastq itself (rtol 2e-4, atol 1e-3, as the CPU
     tests).

--four runs CLI identify on all four cards in one process: a single
card (the baseline), the default mesh (dp=4, ip=1) and an index-sharded
mesh (dp=2, ip=2).  Unique counts must be identical and scores within
the tolerance above.

The last line of standard output is one JSON object naming the device.
Any failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke")
PARITY_READS = 4096
RTOL, ATOL = 2e-4, 1e-3          # tests/test_device_scoring.py
MIN_K, MAX_K, HIGHEST_K = 7, 12, 12   # identify's default k range


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


class _Tee(io.TextIOBase):
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out = out
        self.parts: list[str] = []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def environment(num_cards: int) -> list:
    """Print the cards and JAX's view of them; fail off the GPU."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    import jax
    backend = jax.default_backend()
    check(backend == "gpu", f"JAX's default backend is {backend!r}, not gpu")
    devs = jax.devices()
    check(len(devs) >= num_cards,
          f"{len(devs)} GPU devices visible, {num_cards} needed")
    from kasa_tpu.native import get_lib, lib_error
    from kasa_tpu.utils.compcache import enable_compilation_cache
    print(f"jax {jax.__version__}; devices {devs}")
    print(f"device_kind {devs[0].device_kind!r}")
    print(f"compile cache {enable_compilation_cache()}")
    check(get_lib() is not None, f"native library: {lib_error()}")
    return devs


def run_identify(index: str, reads: str, out_json: str, out_csv: str,
                 engine: str | None = None) -> str:
    """CLI identify in this process; returns what it printed."""
    from kasa_tpu import cli
    argv = ["kasa_tpu", "identify", "-d", index,
            "-c", index + "_content.txt", "-i", reads,
            "-q", out_json, "-p", out_csv]
    if engine:
        argv += ["--engine", engine]
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    check(rc == 0, f"identify {argv[1:]} exited {rc}")
    return tee.text()


def head_fastq(src: str, dst: str, n: int) -> None:
    """The first n records of a 4-line fastq."""
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for _ in range(4 * n):
            fo.write(fi.readline())


def check_outputs(out_json: str, out_csv: str, num_reads: int,
                  num_k: int) -> tuple[list, dict]:
    """Both identify outputs parse and cover every read."""
    with open(out_json) as fh:
        reads = json.load(fh)
    check(len(reads) == num_reads,
          f"{out_json}: {len(reads)} reads, expected {num_reads}")
    check([r["Read number"] for r in reads] == list(range(num_reads)),
          f"{out_json}: read numbers out of order")
    prof = profile_unique(out_csv, num_k)
    check(len(prof) > 0, f"{out_csv}: no taxa")
    return reads, prof


def profile_unique(path: str, num_k: int) -> dict:
    """taxID -> the profile's unique-count columns (k = max .. min)."""
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split(",")
        check(header[:2] == ["#taxID", "Name"]
              and header[2].startswith("Unique counts"),
              f"{path}: unexpected header {header[:3]}")
        out = {}
        for line in fh:
            cols = line.rstrip("\n").split(",")
            out[cols[0]] = tuple(int(c) for c in cols[2:2 + num_k])
    return out


def compare_with_exact(turbo: tuple, exact: tuple) -> None:
    """(reads, profile) of the turbo engine against the exact engine:
    per-read number, specifier and length, and unique counts, equal."""
    (t_reads, t_prof), (e_reads, e_prof) = turbo, exact
    check(len(t_reads) == len(e_reads), "read counts differ")
    for t, e in zip(t_reads, e_reads):
        for field in ("Read number", "Specifier from input file", "Length"):
            check(t[field] == e[field],
                  f"read {e['Read number']}: {field} {t[field]!r} "
                  f"!= {e[field]!r}")
    check(t_prof == e_prof, "profile unique counts differ: "
          f"{sorted(set(t_prof.items()) ^ set(e_prof.items()))[:5]}")


# the standard genetic code, codons in TCAG order; stops TAA/TAG are
# '[' and TGA is ']' in the index alphabet
GENETIC_CODE = "FFLLSSSSYY[[CC]WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def fastq_windows(path: str, num_reads: int, highest_k: int, min_k: int):
    """The query windows of the first num_reads reads of a 4-line fastq,
    encoded from the raw bytes here: -> ((n,) uint64 keys, (n,) read).

    A read is followed by 3 * (highest_k - min_k) 'X'; a window starts
    at every base and takes highest_k codons at a stride of 3, each
    letter 5 bits, first letter highest.  A codon with a base outside
    ACGT is '_', else one with an 'X' is '^', else its amino acid."""
    with open(path, "rb") as fh:
        seqs = fh.read().split(b"\n")[1::4][:num_reads]
    check(len(seqs) == num_reads, f"{path}: {len(seqs)} reads")
    base = np.full(256, 5, np.int64)               # 5: not ACGT
    for i, c in enumerate(b"TCAG"):
        base[c] = base[c | 32] = i
    width = max(len(s) for s in seqs) + 3 * (highest_k - min_k)
    mat = np.full((num_reads, width + 2), 4, np.int64)   # 4: 'X'
    for r, s in enumerate(seqs):
        mat[r, :len(s)] = base[np.frombuffer(s, np.uint8)]
    b1, b2, b3 = mat[:, :-2], mat[:, 1:-1], mat[:, 2:]
    letters = np.frombuffer(GENETIC_CODE.encode(), np.uint8)
    code = (letters[np.minimum(16 * b1 + 4 * b2 + b3, 63)] & 31) \
        .astype(np.uint64)
    worst = np.maximum(np.maximum(b1, b2), b3)
    code[worst == 4] = ord("^") & 31
    code[worst == 5] = ord("_") & 31
    nwin = width - 3 * highest_k + 1
    keys = np.zeros((num_reads, nwin), np.uint64)
    for j in range(highest_k):
        keys |= code[:, 3 * j:3 * j + nwin] \
            << np.uint64(5 * (highest_k - 1 - j))
    rid = np.repeat(np.arange(num_reads), nwin)
    return keys.reshape(-1), rid


def identify_with_scores(index: str, reads: str, out_json: str,
                         out_csv: str, num_reads: int, num_species: int):
    """CLI identify with the default engine, and the per-(read, taxon)
    scores its drive loop handed the ranker (fast.HIT_SINK): ->
    (what it printed, (reads, S) float64)."""
    from kasa_tpu.match import fast
    fast.HIT_SINK = sink = []
    try:
        out = run_identify(index, reads, out_json, out_csv)
    finally:
        fast.HIT_SINK = None
    scores = np.zeros((num_reads, num_species), np.float64)
    seen = 0
    for r0, hc, ht, hk in sink:
        rr = np.repeat(np.arange(len(hc)), hc)
        cc = np.arange(len(rr)) - np.repeat(np.cumsum(hc) - hc, hc)
        scores[r0 + rr, ht[rr, cc]] = hk[rr, cc]
        seen += len(hc)
    check(seen == num_reads,
          f"identify handed the ranker {seen} reads, expected {num_reads}")
    return out, scores


def oracle_scores(idx_u64: np.ndarray, tax_rows: np.ndarray,
                  q_u64: np.ndarray, rid: np.ndarray, num_reads: int,
                  num_species: int, min_k: int, max_k: int,
                  highest_k: int) -> np.ndarray:
    """float64 scores of the intended semantics, vectorised.

    Window i belongs to read rid[i].  At each k in
    [min_k, max_k] at which it is valid, a window whose k-prefix equals
    that of an index group gives each distinct taxon of the group
    w(k) / T, with T the group's distinct-taxon count and
    w(k) = k^2 / 625.  A window is invalid at k when a letter at
    positions min_k-1 .. k-1 is '^' (code 30), the reference's rule as
    match/join.py states it.  idx_u64 is sorted; tax_rows are the
    entries' content rows."""
    R, S = num_reads, num_species
    out = np.zeros(R * S, np.float64)
    ok = np.ones(len(q_u64), bool)
    for k in range(min_k, max_k + 1):
        sh = np.uint64(5 * (highest_k - k))
        ok &= ((q_u64 >> sh) & np.uint64(31)) != np.uint64(30)
        m = np.nonzero(ok)[0]
        ip = idx_u64 >> sh
        qp = q_u64[m] >> sh
        lo = np.searchsorted(ip, qp, "left")
        hi = np.searchsorted(ip, qp, "right")
        hit = lo < hi
        m, lo = m[hit], lo[hit]
        if not len(m):
            continue
        glo, inv = np.unique(lo, return_inverse=True)
        sizes = np.searchsorted(ip, ip[glo], "right") - glo
        gid = np.repeat(np.arange(len(glo), dtype=np.int64), sizes)
        ent = np.arange(int(sizes.sum())) \
            - np.repeat(np.cumsum(sizes) - sizes, sizes) \
            + np.repeat(glo, sizes)
        pair = np.unique(gid * S + tax_rows[ent].astype(np.int64))
        T = np.bincount(pair // S, minlength=len(glo))
        start = np.cumsum(T) - T
        Tq = T[inv]
        within = np.arange(int(Tq.sum())) - np.repeat(np.cumsum(Tq) - Tq, Tq)
        taxa = (pair % S)[np.repeat(start[inv], Tq) + within]
        out += np.bincount(np.repeat(rid[m], Tq) * S + taxa,
                           weights=np.repeat((k * k / 625.0) / Tq, Tq),
                           minlength=R * S)
    return out.reshape(R, S)


def index_for_oracle(index: str):
    """(sorted u64 keys, content rows, species) of an on-disk index."""
    from kasa_tpu.core import kmer
    from kasa_tpu.index import artifacts
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.match.pipeline import load_content_for_identify
    limbs, taxids, _hk, _t = artifacts.read_index(index)
    content = load_content_for_identify(index + "_content.txt")
    return (kmer.limbs_to_u64(limbs),
            map_tax_rows(taxids, content.tax_to_idx), content.num_species)


def check_scores(got: np.ndarray, want: np.ndarray, what: str) -> str:
    """Same hit taxa per read, scores within RTOL/ATOL."""
    diff = np.nonzero((got != 0) != (want != 0))
    check(len(diff[0]) == 0,
          f"{what}: hit taxa differ at (read, taxon) "
          f"{list(zip(*diff))[:5]}")
    try:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: {e}") from None
    err = np.abs(got - want)
    return (f"{what}: {int((want != 0).sum())} (read, taxon) scores, "
            f"max abs err {err.max():.3e}, max rel err "
            f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3e} "
            f"(rtol {RTOL}, atol {ATOL})")


def oracle_for(fastq: str, num_reads: int, oracle_index) -> np.ndarray:
    """The oracle's scores for the first num_reads reads of a fastq."""
    idx_u64, tax_rows, S = oracle_index
    q, rid = fastq_windows(fastq, num_reads, HIGHEST_K, MIN_K)
    return oracle_scores(idx_u64, tax_rows, q, rid, num_reads, S, MIN_K,
                         MAX_K, HIGHEST_K)


def check_k_range(disp) -> None:
    tt = disp.tt
    check((tt.min_k, tt.max_k, tt.highest_k) == (MIN_K, MAX_K, HIGHEST_K),
          f"identify ran k {tt.min_k}..{tt.max_k} of {tt.highest_k}")


def one_card(corpus: dict) -> None:
    import jax
    from kasa_tpu.match import fast
    from kasa_tpu.utils import timers
    index, num_k = corpus["index"], MAX_K - MIN_K + 1
    small_n = corpus["small_n"]

    with phase("identify"):
        timers.reset()
        out = run_identify(index, corpus["reads_small"],
                           os.path.join(OUT, "identify.json"),
                           os.path.join(OUT, "identify.csv"))
        check("fast path unavailable" not in out,
              "identify fell back from the fast path")
        check(isinstance(fast.LAST_DISPATCH, fast.SingleTurboDispatch),
              f"dispatch {type(fast.LAST_DISPATCH).__name__}, expected "
              "the resident SingleTurboDispatch")
        check_k_range(fast.LAST_DISPATCH)
        check_outputs(os.path.join(OUT, "identify.json"),
                      os.path.join(OUT, "identify.csv"), small_n, num_k)
        fb, tot = fast.LAST_FALLBACK
        check(tot == small_n, f"identify classified {tot} reads")
        print(f"host fallback: {fb} of {tot} reads "
              f"({100.0 * fb / tot:.4f} %)")
        timers.report()
        stats = jax.devices()[0].memory_stats() or {}
        print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    with phase("parity"):
        head = os.path.join(OUT, "head.fastq")
        head_fastq(corpus["reads_small"], head, PARITY_READS)
        oracle_index = index_for_oracle(index)
        res = {}
        for engine in ("tpu", "exact"):
            j = os.path.join(OUT, f"head_{engine}.json")
            c = os.path.join(OUT, f"head_{engine}.csv")
            t0 = time.perf_counter()
            if engine == "tpu":
                _out, got = identify_with_scores(
                    index, head, j, c, PARITY_READS, oracle_index[2])
                flagged = fast.LAST_FALLBACK[0]
            else:
                run_identify(index, head, j, c, engine=engine)
            print(f"identify --engine {engine} on {PARITY_READS} reads: "
                  f"{time.perf_counter() - t0:.3f} s")
            res[engine] = check_outputs(j, c, PARITY_READS, num_k)
        compare_with_exact(res["tpu"], res["exact"])
        print(f"parity vs exact engine: {PARITY_READS} reads' number, "
              f"specifier, length and {len(res['tpu'][1])} taxa's unique "
              "counts identical")
        want = oracle_for(head, PARITY_READS, oracle_index)
        print(check_scores(got, want, "parity vs float64 oracle")
              + f"; {flagged} reads recomputed on the host")


MESHES = (("single card", "1", "1"), ("default mesh", None, None),
          ("dp=2 ip=2", "2", "2"))


def four_cards(corpus: dict) -> None:
    """CLI identify on reads_small over one card, the default mesh and
    an index-sharded mesh: unique counts identical to one card's, and
    scores within the tolerance of one card's (every read) and of the
    oracle's (the first PARITY_READS reads)."""
    from kasa_tpu.match import fast
    from kasa_tpu.parallel.turbo_mesh import MeshTurboDispatch
    index, num_k = corpus["index"], MAX_K - MIN_K + 1
    small_n = corpus["small_n"]
    oracle_index = index_for_oracle(index)
    n_oracle = min(PARITY_READS, small_n)
    want = oracle_for(corpus["reads_small"], n_oracle, oracle_index)
    base = None
    for name, dp, ip in MESHES:
        with phase(f"four cards, {name}"):
            for key, val in (("KASA_MESH_DP", dp), ("KASA_MESH_IP", ip)):
                if val is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = val
            tag = name.replace(" ", "_").replace("=", "")
            j = os.path.join(OUT, f"four_{tag}.json")
            c = os.path.join(OUT, f"four_{tag}.csv")
            _out, got = identify_with_scores(
                index, corpus["reads_small"], j, c, small_n,
                oracle_index[2])
            disp = fast.LAST_DISPATCH
            check_k_range(disp)
            shape = (dict(disp.mesh.shape)
                     if isinstance(disp, MeshTurboDispatch) else None)
            want_shape = (None if dp == "1" else
                          {"dp": int(dp or 4), "ip": int(ip or 1)})
            check(shape == want_shape,
                  f"{name}: mesh {shape}, expected {want_shape}")
            _reads, prof = check_outputs(j, c, small_n, num_k)
            print(check_scores(got[:n_oracle], want,
                               f"{name} vs float64 oracle")
                  + f"; {fast.LAST_FALLBACK[0]} reads recomputed on the "
                  "host")
            if base is None:
                base = (prof, got)
            else:
                check(prof == base[0],
                      f"{name}: unique counts differ from one card")
                print(check_scores(got, base[1], f"{name} vs one card"))
    for key in ("KASA_MESH_DP", "KASA_MESH_IP"):
        os.environ.pop(key, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    cards = 4 if args.four else 1
    t_start = time.perf_counter()
    with phase("environment"):
        devs = environment(cards)
    os.makedirs(OUT, exist_ok=True)
    sys.path.insert(0, REPO)
    import bench_corpus
    with phase("corpus"):
        corpus = bench_corpus.ensure_corpus()
        print(f"corpus: {corpus['n_entries']:,} entries, "
              f"{corpus['num_species']} species")
    if args.four:
        four_cards(corpus)
    else:
        one_card(corpus)
    print(f"total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
