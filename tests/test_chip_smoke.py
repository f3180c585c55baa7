"""chip_smoke.py's checks at toy size on the CPU: the vectorised
float64 oracle equals the loop oracle, its own read encoder equals
identify's, the parity phase passes on the example index, and the
script refuses to run without a GPU."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
FIXTURES = REPO / "fixtures"


def _loop_oracle(idx_u64, tax_rows, q_u64, rid, num_reads, S, min_k,
                 max_k, highest_k):
    """One window at a time: score[r][t] += w(k)/T for each distinct
    taxon t of the matched k-prefix group, skipping windows with a '^'
    (code 30) at letter positions min_k-1 .. k-1."""
    scores = np.zeros((num_reads, S), np.float64)
    for k in range(min_k, max_k + 1):
        sh = np.uint64(5 * (highest_k - k))
        ip = idx_u64 >> sh
        for i, q in enumerate(q_u64):
            letters = [(int(q) >> (5 * (highest_k - 1 - p))) & 31
                       for p in range(min_k - 1, k)]
            if 30 in letters:
                continue
            lo = np.searchsorted(ip, q >> sh, "left")
            hi = np.searchsorted(ip, q >> sh, "right")
            if lo < hi:
                taxa = np.unique(tax_rows[lo:hi])
                scores[rid[i], taxa] += (k * k / 625.0) / len(taxa)
    return scores


def _skewed(n, S, heavy, seed):
    """Sorted u64 keys with skewed prefixes, multi-taxa groups of the
    given sizes, and content rows 1..S-1."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(1, 27, size=(n, 12)).astype(np.uint64)
    letters[:, 0] = rng.integers(1, 3, size=n)
    keys = np.zeros(n, np.uint64)
    for j in range(12):
        keys |= letters[:, j] << np.uint64(5 * (11 - j))
    tax = rng.integers(1, S, size=n)
    extra_k, extra_t = [keys], [tax]
    for T in heavy:
        extra_k.append(np.repeat(keys[rng.integers(0, n)], T))
        extra_t.append(rng.choice(np.arange(1, S), size=T, replace=False))
    keys, tax = np.concatenate(extra_k), np.concatenate(extra_t)
    order = np.lexsort((tax, keys))
    return keys[order], tax[order].astype(np.int32)


@pytest.mark.parametrize("S,heavy", [(64, (3, 9, 40)), (3000, (2, 700))],
                         ids=["small_s", "big_s"])
def test_vectorised_oracle_equals_loop_oracle(S, heavy):
    keys, tax = _skewed(4000, S, heavy, seed=S)
    rng = np.random.default_rng(7)
    R, kpr = 24, 20
    q = keys[rng.integers(0, len(keys), size=R * kpr)].copy()
    # misses, and '^' letters both inside and after the checked range
    q[::5] ^= np.uint64(1 << 7)
    q[1::7] |= np.uint64(30) << np.uint64(5 * 2)     # letter 9
    q[2::11] |= np.uint64(30) << np.uint64(5 * 9)    # letter 2
    rid = np.arange(R * kpr) // kpr
    want = _loop_oracle(keys, tax, q, rid, R, S, 7, 12, 12)
    got = cs.oracle_scores(keys, tax, q, rid, R, S, 7, 12, 12)
    assert (want > 0).sum() > R
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_oracle_on_example_reads():
    """Real read windows (with '^' marker padding) against the example
    index, whose entries carry '^' letters too."""
    idx_u64, tax_rows, S = cs.index_for_oracle(str(GOLDEN / "exampleIndex"))
    R = 12
    q, rid = cs.fastq_windows(str(FIXTURES / "reads.fastq"), R, 12, 7)
    want = _loop_oracle(idx_u64, tax_rows, q, rid, R, S, 7, 12, 12)
    got = cs.oracle_scores(idx_u64, tax_rows, q, rid, R, S, 7, 12, 12)
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _odd_reads(path):
    """Reads of uneven length, lowercase bases, N and other letters."""
    rng = np.random.default_rng(3)
    with open(path, "w") as fh:
        for i, n in enumerate((150, 21, 20, 97, 36, 149)):
            s = "".join(rng.choice(list("ACGTacgtNRX"),
                                   p=[.2, .2, .2, .2, .04, .04, .04, .04,
                                      .02, .01, .01], size=n))
            fh.write(f"@r{i}\n{s}\n+\n{'I' * n}\n")


@pytest.mark.parametrize("reads", ["fixture", "odd"])
def test_fastq_windows_equal_the_identify_encoder(tmp_path, reads):
    """The oracle's own encoder gives identify's windows: the batch
    assembler's padded rows through the codon table and the window
    encoder, window for window."""
    from kasa_tpu.core import kmer
    from kasa_tpu.core.encode import (build_codon_code_lut,
                                      dna_to_aa_codes_np, encode_windows_np)
    from kasa_tpu.match.fast import BatchAssembler
    from kasa_tpu.native import load_fastx, sanitize_inplace
    path = str(FIXTURES / "reads.fastq")
    if reads == "odd":
        path = str(tmp_path / "odd.fastq")
        _odd_reads(path)
    seq, seq_off, *_ = load_fastx(path, True)
    sanitize_inplace(seq, False)
    R = len(seq_off) - 1
    q, rid = cs.fastq_windows(path, R, 12, 7)
    nwin = len(q) // R
    asm = BatchAssembler(12, 7, False, False, False)
    maxlen = int(np.diff(seq_off).max()) + asm.marker_len + 9
    mat = asm.assemble(seq, seq_off - seq_off[0], maxlen, R)
    aa = dna_to_aa_codes_np(np.concatenate([mat.reshape(-1),
                                            np.zeros(36, np.uint8)]),
                            build_codon_code_lut())
    win = encode_windows_np(aa, 12, 3)[:R * maxlen].reshape(R, maxlen, 2)
    want = kmer.limbs_to_u64(
        np.ascontiguousarray(win[:, :nwin]).reshape(-1, 2))
    np.testing.assert_array_equal(q, want)
    np.testing.assert_array_equal(rid, np.repeat(np.arange(R), nwin))


def test_parity_phase_on_example_index(tmp_path):
    """The parity phase, end to end through CLI identify, on the example
    index: turbo against the exact engine, and the scores identify
    handed its ranker against the oracle."""
    from kasa_tpu.match import fast
    index = str(GOLDEN / "exampleIndex")
    reads = str(FIXTURES / "reads.fastq")
    oracle_index = cs.index_for_oracle(index)
    res = {}
    for engine in ("tpu", "exact"):
        j, c = str(tmp_path / f"{engine}.json"), str(tmp_path / f"{engine}.csv")
        if engine == "tpu":
            out, got = cs.identify_with_scores(index, reads, j, c, 300,
                                               oracle_index[2])
            assert "OUT: device cpu" in out
            cs.check_k_range(fast.LAST_DISPATCH)
        else:
            cs.run_identify(index, reads, j, c, engine=engine)
        res[engine] = cs.check_outputs(j, c, 300, 6)
    assert fast.HIT_SINK is None
    cs.compare_with_exact(res["tpu"], res["exact"])
    want = cs.oracle_for(reads, 300, oracle_index)
    assert (want > 0).sum() > 100
    assert "scores" in cs.check_scores(got, want, "toy")


def test_identify_with_scores_reads_the_run(tmp_path, monkeypatch):
    """Scores come from identify's own hit lists: skewing what the
    drive loop decodes shows up in them."""
    from kasa_tpu.match import fast
    index = str(GOLDEN / "exampleIndex")
    reads = str(FIXTURES / "reads.fastq")
    S = cs.index_for_oracle(index)[2]

    def run(tag):
        return cs.identify_with_scores(
            index, reads, str(tmp_path / f"{tag}.json"),
            str(tmp_path / f"{tag}.csv"), 300, S)[1]
    good = run("good")
    cls = type(fast.LAST_DISPATCH)
    real = cls.decode

    def skewed(self, *a, **k):
        hc, ofc, ofl, nflag, ht, hk = real(self, *a, **k)
        return hc, ofc, ofl, nflag, ht, hk * np.float32(1.01)
    monkeypatch.setattr(cls, "decode", skewed)
    bad = run("bad")
    np.testing.assert_allclose(bad[good != 0], 1.01 * good[good != 0],
                               rtol=1e-6)
    with pytest.raises(cs.SmokeFailure, match="tol"):
        cs.check_scores(bad, good, "skewed")


def test_compare_with_exact_catches_differences(tmp_path):
    reads = [{"Read number": 0, "Specifier from input file": "r0 ",
              "Length": 151}]
    prof = {"7": (3, 2, 1, 0, 0, 0)}
    cs.compare_with_exact((reads, prof), (reads, dict(prof)))
    bad = [dict(reads[0], Length=150)]
    with pytest.raises(cs.SmokeFailure, match="Length"):
        cs.compare_with_exact((bad, prof), (reads, prof))
    with pytest.raises(cs.SmokeFailure, match="unique counts"):
        cs.compare_with_exact((reads, {"7": (3, 2, 1, 0, 0, 1)}),
                              (reads, prof))


def test_check_scores_tolerance():
    want = np.array([[0.0, 1.0, 0.5]])
    assert "max abs err" in cs.check_scores(want * (1 + 1e-4), want, "ok")
    with pytest.raises(cs.SmokeFailure, match="hit taxa differ"):
        cs.check_scores(np.array([[1e-9, 1.0, 0.5]]), want, "pattern")
    with pytest.raises(cs.SmokeFailure, match="tol"):
        cs.check_scores(want * 1.01, want, "values")


def test_head_fastq_and_profile_parse(tmp_path):
    head = tmp_path / "head.fastq"
    cs.head_fastq(str(FIXTURES / "reads.fastq"), str(head), 5)
    lines = head.read_text().splitlines()
    assert len(lines) == 20 and lines[0].startswith("@")
    csv = tmp_path / "p.csv"
    csv.write_text("#taxID,Name,Unique counts k=12,Unique counts k=11\n"
                   "9,Some name,4,7\n")
    assert cs.profile_unique(str(csv), 2) == {"9": (4, 7)}


def _run_script(tmp_path, path_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH=str(path_dir))
    return subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


def _assert_no_result(r):
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    with pytest.raises(ValueError):
        json.loads(last)


def test_refuses_to_run_without_gpu(tmp_path):
    """nvidia-smi answers but JAX has no GPU backend: non-zero exit, no
    result line, and the backend named as the cause."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    smi = bin_dir / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'Stub GPU, 100.00 W'\n")
    smi.chmod(0o755)
    r = _run_script(tmp_path, bin_dir)
    _assert_no_result(r)
    assert "card: Stub GPU, 100.00 W" in r.stdout
    assert "default backend is 'cpu', not gpu" in r.stderr


def test_refuses_to_run_without_nvidia_smi(tmp_path):
    r = _run_script(tmp_path, tmp_path)
    _assert_no_result(r)
    assert "nvidia-smi" in r.stderr
