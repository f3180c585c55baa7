"""Synthetic non-toy bench corpus for kasa_tpu (used by bench.py).

Generates, once, under ``.bench_corpus_v1/``:

  * a reference-format index family (index + _info/_trie/_trie.txt/_f.txt/
    _content.txt) built from NUM_SPECIES synthetic genomes -- random DNA
    translated through the real codon table (so the AA k-mer distribution
    carries the true codon-multiplicity skew), with a pool of conserved
    "core genes" shared across genomes (realistic multi-taxa groups:
    tiers up to T~16, a few T~60, one ultra-conserved T~150 that
    exercises the overflow fallback), and
  * 150 bp read sets sampled from those genomes with 0.5% substitution
    errors (rates: Illumina-like), as fastq.

Both the kasa_tpu CLI and the reference kASA binary consume the same
files, so bench.py can measure the two systems on an identical workload
(the file formats are byte-compatible, tests/test_golden_parity.py).
"""

from __future__ import annotations

import os
import sys

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   ".bench_corpus_v1")
NUM_SPECIES = 2047
GENOME_LEN = 16_000
CORE_GENES = 256        # 300 bp each, ~16 genomes share one gene
CORE_PER_GENOME = 2
ULTRA_GENOMES = 150     # genomes embedding the one ultra-conserved gene
READS = 200_000
WARM_READS = 8_192
READ_LEN = 150
ERR_RATE = 0.005
SEED = 20260820

INDEX = os.path.join(DIR, "benchIndex")
READS_FQ = os.path.join(DIR, "reads.fastq")
READS_SMALL_FQ = os.path.join(DIR, "reads_small.fastq")
WARM_FQ = os.path.join(DIR, "warm.fastq")
SMALL_READS = 12_288    # one 8192-read batch plus a 4096-read
                        # remainder: both batch shapes of a run

_DNA = np.frombuffer(b"ACGT", np.uint8)


def _gen_genomes(rng):
    core = rng.integers(0, 4, size=(CORE_GENES, 300))
    ultra = rng.integers(0, 4, size=300)
    genomes = []
    for g in range(NUM_SPECIES):
        dna = rng.integers(0, 4, size=GENOME_LEN)
        for pick in rng.integers(0, CORE_GENES, size=CORE_PER_GENOME):
            off = int(rng.integers(0, GENOME_LEN - 300))
            dna[off:off + 300] = core[pick]
        if g < ULTRA_GENOMES:
            off = int(rng.integers(0, GENOME_LEN - 300))
            dna[off:off + 300] = ultra
        genomes.append(_DNA[dna])
    return genomes


def _index_from_genomes(genomes):
    from kasa_tpu.core.encode import (build_codon_code_lut,
                                      dna_to_aa_codes_np, encode_windows_np)
    lut = build_codon_code_lut()
    all_limbs, all_tax = [], []
    for g, dna in enumerate(genomes):
        aa = dna_to_aa_codes_np(dna, lut)
        win = encode_windows_np(aa, 12, 3)
        w = len(dna) - 36 + 1          # windows fully inside the genome
        win = win[:w]
        all_limbs.append(win)
        all_tax.append(np.full(w, g + 1, np.uint32))
    limbs = np.concatenate(all_limbs)
    taxids = np.concatenate(all_tax)
    order = np.lexsort((taxids, limbs[:, 1], limbs[:, 0]))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    return np.ascontiguousarray(limbs[keep]), taxids[keep]


def _write_artifacts(limbs, taxids):
    from kasa_tpu.index import artifacts
    from kasa_tpu.index.build import compute_frequencies
    from kasa_tpu.index.content import ContentEntry, write_content_file

    entries = [ContentEntry(name=f"Synthetic species {i}", taxid=str(i),
                            lowest_taxids=[str(i)], accessions=[f"SYN{i}"])
               for i in range(1, NUM_SPECIES + 1)]
    write_content_file(INDEX + "_content.txt", entries)
    artifacts.write_index(INDEX, limbs, taxids, 12)
    prefixes, counts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(INDEX, prefixes, counts)
    freq = compute_frequencies(limbs, taxids, entries, 12, 1)
    artifacts.write_frequency_file(INDEX, entries, freq)


def _write_reads(genomes, rng):
    lens = np.array([len(g) for g in genomes])
    qual = b"I" * READ_LEN

    def emit(fh, n, tag):
        gsel = rng.integers(0, len(genomes), size=n)
        for i in range(n):
            g = genomes[gsel[i]]
            off = int(rng.integers(0, len(g) - READ_LEN))
            r = g[off:off + READ_LEN].copy()
            err = np.nonzero(rng.random(READ_LEN) < ERR_RATE)[0]
            if len(err):
                r[err] = _DNA[rng.integers(0, 4, size=len(err))]
            fh.write(b"@%s_%d src%d\n" % (tag, i, gsel[i] + 1))
            fh.write(r.tobytes())
            fh.write(b"\n+\n")
            fh.write(qual)
            fh.write(b"\n")

    with open(READS_FQ, "wb") as fh:
        emit(fh, READS, b"r")
    with open(READS_SMALL_FQ, "wb") as fh:
        emit(fh, SMALL_READS, b"s")
    with open(WARM_FQ, "wb") as fh:
        emit(fh, WARM_READS, b"w")


def ensure_corpus(log=print) -> dict:
    """Generate (once) and return corpus paths + stats."""
    stamp = os.path.join(DIR, "DONE")
    if not os.path.exists(stamp):
        import time
        os.makedirs(DIR, exist_ok=True)
        rng = np.random.default_rng(SEED)
        t0 = time.time()
        genomes = _gen_genomes(rng)
        log(f"# corpus: genomes generated ({time.time()-t0:.0f}s)")
        limbs, taxids = _index_from_genomes(genomes)
        log(f"# corpus: index built n={len(taxids):,} ({time.time()-t0:.0f}s)")
        _write_artifacts(limbs, taxids)
        log(f"# corpus: artifacts written ({time.time()-t0:.0f}s)")
        _write_reads(genomes, rng)
        log(f"# corpus: reads written ({time.time()-t0:.0f}s)")
        with open(stamp, "w") as fh:
            fh.write(f"{len(taxids)}\n")
    # regenerate the startup-cancellation sets when their geometry
    # changes (cheap; invalidates the cached reference baseline too)
    import itertools
    def _nreads(path):
        with open(path, "rb") as fh:
            return sum(1 for _ in fh) // 4
    if os.path.exists(READS_SMALL_FQ) and _nreads(READS_SMALL_FQ) != SMALL_READS:
        rng2 = np.random.default_rng(SEED + 1)
        genomes = _gen_genomes(np.random.default_rng(SEED))
        qual = b"I" * READ_LEN
        with open(READS_SMALL_FQ, "wb") as fh:
            gsel = rng2.integers(0, len(genomes), size=SMALL_READS)
            for i in range(SMALL_READS):
                g = genomes[gsel[i]]
                off = int(rng2.integers(0, len(g) - READ_LEN))
                r = g[off:off + READ_LEN].copy()
                err = np.nonzero(rng2.random(READ_LEN) < ERR_RATE)[0]
                if len(err):
                    r[err] = _DNA[rng2.integers(0, 4, size=len(err))]
                fh.write(b"@s_%d src%d\n" % (i, gsel[i] + 1))
                fh.write(r.tobytes())
                fh.write(b"\n+\n")
                fh.write(qual)
                fh.write(b"\n")
        ref_cache = os.path.join(DIR, "ref_baseline.json")
        if os.path.exists(ref_cache):
            os.remove(ref_cache)
    with open(stamp) as fh:
        n = int(fh.read().split()[0])
    return dict(index=INDEX, reads=READS_FQ, reads_small=READS_SMALL_FQ,
                warm=WARM_FQ, n_entries=n, num_species=NUM_SPECIES,
                reads_n=READS, small_n=SMALL_READS, warm_n=WARM_READS)


if __name__ == "__main__":
    info = ensure_corpus()
    print(info)
