"""Mesh-sharded turbo classify (parallel/turbo_mesh.py) through the
FULL CLI fast path: on the 8-virtual-device CPU mesh, `--engine tpu`
with a (dp, ip) mesh must agree with the single-chip turbo run on a
skewed, multi-taxa corpus -- identical hit taxa + integer profile
columns, scores to float-reorder tolerance.  This is the production
path VERDICT r2 flagged as untested (the dryrun used toy shapes and
the classic kernel)."""

import json
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

NUM_SPECIES = 61
GENOME_LEN = 420
READ_LEN = 100
NUM_READS = 700


def synth_corpus(tmp_path, seed=7):
    """Mini bench-corpus: genomes with conserved multi-taxa genes
    (T~20 and T~5 groups + prefix skew through the real codon LUT),
    reference-format artifacts + a fastq of sampled reads."""
    from kasa_tpu.core.encode import (build_codon_code_lut,
                                      dna_to_aa_codes_np,
                                      encode_windows_np)
    from kasa_tpu.index import artifacts
    from kasa_tpu.index.build import compute_frequencies
    from kasa_tpu.index.content import ContentEntry, write_content_file

    rng = np.random.default_rng(seed)
    dna4 = np.frombuffer(b"ACGT", np.uint8)
    gene_a = rng.integers(0, 4, size=90)      # shared by ~20 genomes
    gene_b = rng.integers(0, 4, size=90)      # shared by 5
    genomes = []
    for g in range(NUM_SPECIES):
        d = rng.integers(0, 4, size=GENOME_LEN)
        if g % 3 == 0:
            off = int(rng.integers(0, GENOME_LEN - 90))
            d[off:off + 90] = gene_a
        if g < 5:
            off = int(rng.integers(0, GENOME_LEN - 90))
            d[off:off + 90] = gene_b
        genomes.append(dna4[d])

    lut = build_codon_code_lut()
    all_l, all_t = [], []
    for g, dna in enumerate(genomes):
        aa = dna_to_aa_codes_np(dna, lut)
        win = encode_windows_np(aa, 12, 3)[:len(dna) - 36 + 1]
        all_l.append(win)
        all_t.append(np.full(len(win), g + 1, np.uint32))
    limbs = np.concatenate(all_l)
    taxids = np.concatenate(all_t)
    order = np.lexsort((taxids, limbs[:, 1], limbs[:, 0]))
    limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    limbs = np.ascontiguousarray(limbs[keep])
    taxids = taxids[keep]

    idx = str(tmp_path / "meshIndex")
    entries = [ContentEntry(name=f"Mesh species {i}", taxid=str(i),
                            lowest_taxids=[str(i)],
                            accessions=[f"MS{i}"])
               for i in range(1, NUM_SPECIES + 1)]
    write_content_file(idx + "_content.txt", entries)
    artifacts.write_index(idx, limbs, taxids, 12)
    pref, cnts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(idx, pref, cnts)
    freq = compute_frequencies(limbs, taxids, entries, 12, 1)
    artifacts.write_frequency_file(idx, entries, freq)

    fq = tmp_path / "mesh_reads.fastq"
    with open(fq, "wb") as fh:
        gsel = rng.integers(0, NUM_SPECIES, size=NUM_READS)
        for i in range(NUM_READS):
            g = genomes[gsel[i]]
            off = int(rng.integers(0, len(g) - READ_LEN))
            r = g[off:off + READ_LEN].copy()
            err = np.nonzero(rng.random(READ_LEN) < 0.01)[0]
            if len(err):
                r[err] = dna4[rng.integers(0, 4, size=len(err))]
            fh.write(b"@mr_%d src%d\n" % (i, gsel[i] + 1))
            fh.write(r.tobytes())
            fh.write(b"\n+\nI" * 1 + b"I" * (READ_LEN - 1) + b"\n")
    return idx, str(fq)


def run_identify(idx, fq, out, prof, monkeypatch, dp, ip):
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify

    monkeypatch.setenv("KASA_MESH_DP", str(dp))
    monkeypatch.setenv("KASA_MESH_IP", str(ip))
    cfg = Config()
    cfg.engine = "tpu"
    cfg.content_file = idx + "_content.txt"
    # show every hit: the single-chip batch trips overflow band caps
    # where the mesh's 8x smaller per-device worklists do not, so the
    # two paths produce ulp-different scores for fallback reads; a
    # display cutoff (0.8 x max / num_of_beasts) would flip taxa in
    # and out and make set comparison flaky
    cfg.num_of_beasts = 100
    identify(cfg, index_path=idx, input_path=fq,
             out_file=out, profile_file=prof)


@pytest.mark.parametrize("dp,ip", [(2, 4), (8, 1), (1, 8)])
def test_cli_turbo_mesh_agrees_with_single(tmp_path, monkeypatch, dp, ip):
    import jax
    if len(jax.devices()) < dp * ip:
        pytest.skip("needs 8 virtual devices")

    idx, fq = synth_corpus(tmp_path)
    o1 = str(tmp_path / "single.json")
    p1 = str(tmp_path / "single.csv")
    run_identify(idx, fq, o1, p1, monkeypatch, dp=1, ip=1)
    o2 = str(tmp_path / "mesh.json")
    p2 = str(tmp_path / "mesh.csv")
    run_identify(idx, fq, o2, p2, monkeypatch, dp=dp, ip=ip)

    a = json.load(open(o1))
    b = json.load(open(o2))
    assert len(a) == len(b) == NUM_READS
    multi_hit_reads = 0
    for ra, rb in zip(a, b):
        ha = {h["tax ID"]: h for h in ra["Top hits"] + ra["Further hits"]}
        hb = {h["tax ID"]: h for h in rb["Top hits"] + rb["Further hits"]}
        assert set(ha) == set(hb), f"read {ra['Read number']}"
        if len(ha) > 1:
            multi_hit_reads += 1
        for t, h in ha.items():
            np.testing.assert_allclose(float(h["k-mer Score"]),
                                       float(hb[t]["k-mer Score"]),
                                       rtol=2e-5, atol=1e-4)
    assert multi_hit_reads > 10, "corpus should exercise multi-taxa merge"

    # profile: integer unique-count columns identical, doubles close
    for la, lb in zip(open(p1).read().splitlines(),
                      open(p2).read().splitlines()):
        ca, cb = la.split(","), lb.split(",")
        assert ca[:2] == cb[:2]
        for va, vb in zip(ca[2:], cb[2:]):
            try:
                np.testing.assert_allclose(float(va), float(vb),
                                           rtol=2e-5, atol=1e-6)
            except ValueError:
                assert va == vb


def test_over_budget_index_shards_over_ip(tmp_path, monkeypatch,
                                          capsys):
    """When the turbo tables exceed -m but 1/ip of them fits, the
    fast path shards the index over the mesh instead of falling back
    to tiered streaming; results must agree with the resident run."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from kasa_tpu.match.fast import bytes_per_entry_resident
    from kasa_tpu.index import artifacts

    idx, fq = synth_corpus(tmp_path)
    n, _ = artifacts.read_info(idx)

    o1 = str(tmp_path / "res.json")
    run_identify(idx, fq, o1, None, monkeypatch, dp=1, ip=1)

    monkeypatch.delenv("KASA_MESH_DP", raising=False)
    monkeypatch.delenv("KASA_MESH_IP", raising=False)
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify

    cfg = Config()
    cfg.engine = "tpu"
    cfg.content_file = idx + "_content.txt"
    cfg.num_of_beasts = 100
    # tables / 4 fit, tables / 1 do not -> expect ip >= 4
    cfg.memory_avail = int(bytes_per_entry_resident(6) * n / 3 / 0.8)
    o2 = str(tmp_path / "shard.json")
    identify(cfg, index_path=idx, input_path=fq, out_file=o2,
             profile_file=None)
    out = capsys.readouterr().out
    assert "turbo mesh active" in out and "ip=4" in out, out

    a = json.load(open(o1))
    b = json.load(open(o2))
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        ha = {h["tax ID"] for h in ra["Top hits"] + ra["Further hits"]}
        hb = {h["tax ID"] for h in rb["Top hits"] + rb["Further hits"]}
        assert ha == hb, ra["Read number"]


def test_mesh_step_takes_tables_as_arguments(tmp_path):
    """The jitted mesh step receives the sharded tables as arguments:
    tables it closed over would be baked into every compiled program as
    constants (the 24-bit router alone is 134 MB per shard), which made
    each mesh compile take minutes at bench scale."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from kasa_tpu.core.encode import build_codon_code_lut
    from kasa_tpu.index import artifacts
    from kasa_tpu.match.pipeline import load_content_for_identify
    from kasa_tpu.match.join import map_tax_rows
    from kasa_tpu.parallel.turbo_mesh import (ShardedTurboTables,
                                              turbo_mesh_program)
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    idx, _fq = synth_corpus(tmp_path)
    limbs, taxids, _hk, _t = artifacts.read_index(idx)
    content = load_content_for_identify(idx + "_content.txt")
    S = content.num_species
    st = ShardedTurboTables.build(
        limbs, map_tax_rows(taxids, content.tax_to_idx), 12, 7, 12, S, 2)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "ip"))
    jitted, tables = turbo_mesh_program(st, mesh)
    rows, maxlen = 64, 128
    acc = jnp.zeros((2, 6, S), jnp.float32)
    text = jitted.lower(
        *tables, jnp.zeros((rows, maxlen), jnp.uint8),
        jnp.asarray(build_codon_code_lut().astype(np.int32)), acc,
        acc.astype(jnp.int32), rows_pad=rows, protein=False,
        one_frame=False, lpr=1, w=maxlen - 35, csr_cap=4 * rows // 2
    ).as_text()
    table_bytes = sum(int(a.nbytes) for a in jax.tree.leaves(tables))
    assert table_bytes > 100 << 20
    assert len(text) < table_bytes // 100, len(text)
