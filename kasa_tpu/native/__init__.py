"""ctypes bindings for the native loader (loader.cpp).

The shared library is built with g++ on first use from the committed
sources, into ``build/`` beside them (listed in ``.gitignore``).  Its
file name carries a hash of the sources, the compiler flags and the
host's CPU, so a library built for other sources or another CPU (it is
compiled with -march=native) is never loaded: it is simply not the
file this host looks for.  Every entry point degrades gracefully to
None when no compiler is available, so the pure-Python paths keep
working; ``lib_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "loader.cpp"), os.path.join(_DIR, "writer.cpp"),
         os.path.join(_DIR, "sortidx.cpp"),
         os.path.join(_DIR, "buildenc.cpp")]
BUILD_DIR = os.path.join(_DIR, "build")
# -ffp-contract=off: the score/error arithmetic must round exactly like
# the Python float32 path (no FMA fusion), or formatted floats drift by
# an ulp
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
          "-std=c++17"]
_lib = None
_tried = False
_error = None


def host_cpu() -> str:
    """What -march=native compiles for: the machine type plus the first
    processor's model name and feature flags."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                if not line.strip() and len(ident) > 1:
                    break
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def build_key(srcs=_SRCS, cpu: str | None = None) -> str:
    """Hash of the sources' bytes, the compiler flags and the CPU."""
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_FLAGS).encode())
    h.update((host_cpu() if cpu is None else cpu).encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"_kasa_loader-{build_key()}.so")


def _build(so: str) -> bool:
    global _error
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, *_SRCS, "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True)
    except OSError as e:
        _error = f"g++ not runnable: {e}"
        return False
    if r.returncode != 0:
        _error = "g++ failed: " + r.stderr.decode(errors="replace")[-2000:]
        return False
    os.replace(tmp, so)     # atomic: concurrent builders never see half
    return True


def lib_error() -> str | None:
    """Why get_lib() returned None (None when it loaded)."""
    return _error


def get_lib():
    """The loaded library, building it on first call; None if unavailable."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = lib_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.kasa_load_fastx.restype = ctypes.c_void_p
        lib.kasa_load_fastx.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.kasa_fill.restype = None
        lib.kasa_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.kasa_release.argtypes = [ctypes.c_void_p]
        lib.kasa_sanitize.restype = ctypes.c_int64
        lib.kasa_sanitize.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int]
        lib.kasa_sort_kmer_tax.restype = None
        lib.kasa_sort_kmer_tax.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.kasa_unpack_keys.restype = None
        lib.kasa_unpack_keys.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.kasa_sort_kmer_tax_dedup.restype = None
        lib.kasa_sort_kmer_tax_dedup.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64)]
        lib.kasa_encode_dna.restype = ctypes.c_int64
        lib.kasa_encode_dna.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.kasa_frequencies.restype = None
        lib.kasa_frequencies.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.kasa_umap_bytes.restype = ctypes.c_int64
        lib.kasa_umap_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kasa_rank_format.restype = ctypes.c_void_p
        lib.kasa_rank_format.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]   # scores R S
            + [ctypes.c_void_p] * 2                             # names
            + [ctypes.c_void_p] * 2                             # lengths coh
            + [ctypes.c_void_p] * 4                             # tax org
            + [ctypes.c_void_p]                                 # freqs
            + [ctypes.c_int64] + [ctypes.c_int] * 5             # nums
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            + [ctypes.POINTER(ctypes.c_int64)])
        lib.kasa_rank_format_sparse.restype = ctypes.c_void_p
        lib.kasa_rank_format_sparse.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 2                             # names
            + [ctypes.c_void_p] * 2                             # lengths coh
            + [ctypes.c_void_p] * 4                             # tax org
            + [ctypes.c_void_p]                                 # freqs
            + [ctypes.c_int64] + [ctypes.c_int] * 5             # nums
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            + [ctypes.POINTER(ctypes.c_int64)])
        lib.kasa_buf_ptr.restype = ctypes.c_void_p
        lib.kasa_buf_ptr.argtypes = [ctypes.c_void_p]
        lib.kasa_buf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError as e:
        _error = f"native library did not load: {e}"
        _lib = None
    return _lib


def load_fastx(path: str, is_fastq: bool):
    """Parse a fasta/fastq(.gz) file natively.

    Returns (seq, seq_off, names, name_off, nlines) numpy arrays or
    None when the native library is unavailable or IO failed."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    sb = ctypes.c_int64()
    nb = ctypes.c_int64()
    handle = lib.kasa_load_fastx(path.encode(), int(path.endswith(".gz")),
                                 int(is_fastq), ctypes.byref(n),
                                 ctypes.byref(sb), ctypes.byref(nb))
    if not handle:
        return None
    try:
        seq = np.empty(sb.value, np.uint8)
        seq_off = np.empty(n.value + 1, np.int64)
        names = np.empty(nb.value, np.uint8)
        name_off = np.empty(n.value + 1, np.int64)
        nlines = np.empty(n.value, np.int32)
        lib.kasa_fill(handle,
                      seq.ctypes.data_as(ctypes.c_void_p),
                      seq_off.ctypes.data_as(ctypes.c_void_p),
                      names.ctypes.data_as(ctypes.c_void_p),
                      name_off.ctypes.data_as(ctypes.c_void_p),
                      nlines.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.kasa_release(handle)
    return seq, seq_off, names, name_off, nlines


_FMT_CODE = {"json": 0, "jsonl": 1, "tsv": 2, "kraken": 3}


def _blob(strings) -> tuple[np.ndarray, np.ndarray]:
    bs = [s.encode("latin-1") for s in strings]
    off = np.zeros(len(bs) + 1, np.int64)
    if bs:
        np.cumsum([len(b) for b in bs], out=off[1:])
    cat = b"".join(bs)
    return np.frombuffer(cat, np.uint8).copy() if cat else np.zeros(0, np.uint8), off


class NativeRanker:
    """Batch rank+format through writer.cpp (the throughput path's
    replacement for per-read rank_read + ReadResultWriter.write_read;
    byte-identical output, tested in tests/test_native_writer.py).

    Construct once per identify run (tax/organism blobs are cached),
    call .format per batch.  `.ok` is False when the native library is
    unavailable -- callers fall back to the Python writer."""

    def __init__(self, idx_to_tax, organisms, freqs_max_k, min_k, max_k,
                 highest_k, protein, num_frames, threshold, num_beasts,
                 fmt, coherence_on, filter_on=False, error_threshold=0.5,
                 coherence_threshold=11.0):
        self.lib = get_lib()
        self.ok = self.lib is not None
        if not self.ok:
            return
        self.tax_blob, self.tax_off = _blob([str(t) for t in idx_to_tax])
        self.org_blob, self.org_off = _blob(organisms)
        self.freqs = np.ascontiguousarray(freqs_max_k, dtype=np.float64)
        self.params = (min_k, max_k, highest_k, int(protein), num_frames)
        self.threshold = float(threshold)
        self.num_beasts = int(num_beasts)
        self.fmt = _FMT_CODE[fmt]
        self.coherence_on = int(coherence_on)
        self.filter_on = int(filter_on)
        self.error_threshold = float(error_threshold)
        self.coherence_threshold = float(coherence_threshold)

    def format(self, scores: np.ndarray, names: list, lengths,
               read_num_start: int, coherence=None):
        """-> (formatted bytes, filtered mask (R,) uint8 | None)."""
        scores = np.ascontiguousarray(scores, dtype=np.float32)
        R = scores.shape[0]
        name_blob, name_off = _blob(names)
        lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
        coh = None
        if coherence is not None:
            coh = np.ascontiguousarray(coherence, dtype=np.float32)
        filtered = np.zeros(R, np.uint8) if self.filter_on else None
        out_len = ctypes.c_int64()

        def vp(a):
            return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

        h = self.lib.kasa_rank_format(
            vp(scores), R, scores.shape[1],
            vp(name_blob), vp(name_off), vp(lengths), vp(coh),
            vp(self.tax_blob), vp(self.tax_off),
            vp(self.org_blob), vp(self.org_off), vp(self.freqs),
            read_num_start, *self.params,
            ctypes.c_float(self.threshold), self.num_beasts, self.fmt,
            self.coherence_on, self.filter_on,
            ctypes.c_float(self.error_threshold),
            ctypes.c_float(self.coherence_threshold), vp(filtered),
            ctypes.byref(out_len))
        try:
            text = ctypes.string_at(self.lib.kasa_buf_ptr(h), out_len.value)
        finally:
            self.lib.kasa_buf_free(h)
        return text, filtered

    def format_sparse(self, hit_tax: np.ndarray, hit_ksc: np.ndarray,
                      hit_cnt: np.ndarray, names: list, lengths,
                      read_num_start: int, coherence=None):
        """Like format(), but from per-read compact hit lists:
        hit_tax/hit_ksc are (R, W) with hit_cnt[r] valid entries in
        ascending species order (kasa_rank_format_sparse)."""
        hit_tax = np.ascontiguousarray(hit_tax, dtype=np.int32)
        hit_ksc = np.ascontiguousarray(hit_ksc, dtype=np.float32)
        hit_cnt = np.ascontiguousarray(hit_cnt, dtype=np.int32)
        R, W = hit_tax.shape
        name_blob, name_off = _blob(names)
        lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
        coh = None
        if coherence is not None:
            coh = np.ascontiguousarray(coherence, dtype=np.float32)
        filtered = np.zeros(R, np.uint8) if self.filter_on else None
        out_len = ctypes.c_int64()

        def vp(a):
            return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

        h = self.lib.kasa_rank_format_sparse(
            vp(hit_tax), vp(hit_ksc), vp(hit_cnt), R, W,
            vp(name_blob), vp(name_off), vp(lengths), vp(coh),
            vp(self.tax_blob), vp(self.tax_off),
            vp(self.org_blob), vp(self.org_off), vp(self.freqs),
            read_num_start, *self.params,
            ctypes.c_float(self.threshold), self.num_beasts, self.fmt,
            self.coherence_on, self.filter_on,
            ctypes.c_float(self.error_threshold),
            ctypes.c_float(self.coherence_threshold), vp(filtered),
            ctypes.byref(out_len))
        try:
            text = ctypes.string_at(self.lib.kasa_buf_ptr(h), out_len.value)
        finally:
            self.lib.kasa_buf_free(h)
        return text, filtered


def sanitize_inplace(seq: np.ndarray, protein: bool) -> int | None:
    """In-place native sanitize; returns whitespace count or None."""
    lib = get_lib()
    if lib is None or not seq.flags.c_contiguous:
        return None
    return int(lib.kasa_sanitize(seq.ctypes.data_as(ctypes.c_void_p),
                                 len(seq), int(protein)))


def sort_kmer_tax(keys: np.ndarray, tax: np.ndarray, key_bits: int = 60,
                  nthreads: int = 2) -> bool:
    """In-place native (key, tax) lexicographic sort (sortidx.cpp).
    Returns False (arrays untouched) when the native lib is missing or
    the dtypes/layout do not match the fast path."""
    lib = get_lib()
    if (lib is None or keys.dtype != np.uint64 or tax.dtype != np.uint32
            or not keys.flags.c_contiguous or not tax.flags.c_contiguous
            or len(keys) != len(tax)):
        return False
    lib.kasa_sort_kmer_tax(
        len(keys), keys.ctypes.data_as(ctypes.c_void_p),
        tax.ctypes.data_as(ctypes.c_void_p), int(key_bits),
        max(int(nthreads), 1))
    return True


def encode_dna_keys(seq: np.ndarray, lut: np.ndarray, highest_k: int,
                    frames: int = 3) -> np.ndarray | None:
    """Native dnaTokMers twin (buildenc.cpp): sanitized bytes (marker
    appended) -> packed u64 keys of all VALID windows, frame-major.
    None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    w = len(seq) - 3 * highest_k + 1
    if w <= 0:
        return np.zeros(0, np.uint64)
    out = np.empty(w, np.uint64)
    n = lib.kasa_encode_dna(
        seq.ctypes.data_as(ctypes.c_void_p), len(seq),
        lut.ctypes.data_as(ctypes.c_void_p), highest_k, frames,
        out.ctypes.data_as(ctypes.c_void_p))
    return out[:n]


def frequencies_native(keys: np.ndarray, rows: np.ndarray,
                       num_cols: int, S: int,
                       nthreads: int = 2) -> np.ndarray | None:
    """Native GetFrequencyK counting pass; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    rows = np.ascontiguousarray(rows, np.int32)
    freq = np.zeros((S, num_cols), np.uint64)
    # each worker owns a private (S, num_cols) u64 accumulator; cap the
    # thread count so the combined footprint stays ~<= 1 GiB (a 1M-taxa
    # content file at 25 cols is 200 MB per thread)
    per_thread = max(int(S) * int(num_cols) * 8, 1)
    nthreads = max(1, min(int(nthreads), (1 << 30) // per_thread))
    lib.kasa_frequencies(
        keys.ctypes.data_as(ctypes.c_void_p),
        rows.ctypes.data_as(ctypes.c_void_p), len(keys), num_cols, S,
        freq.ctypes.data_as(ctypes.c_void_p), max(int(nthreads), 1))
    return freq


def unpack_keys(keys: np.ndarray, nthreads: int = 2) -> np.ndarray | None:
    """u64 packed keys -> (n, 2) int32 limbs; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    out = np.empty((len(keys), 2), np.int32)
    lib.kasa_unpack_keys(keys.ctypes.data_as(ctypes.c_void_p), len(keys),
                         out.ctypes.data_as(ctypes.c_void_p),
                         max(int(nthreads), 1))
    return out


def sort_dedup_kmer_tax(keys: np.ndarray, tax: np.ndarray,
                        key_bits: int = 60, nthreads: int = 2
                        ) -> int | None:
    """In-place native (key, tax) sort + exact-duplicate drop; returns
    the deduplicated count (valid prefix of both arrays) or None when
    the native lib/layout is unavailable."""
    lib = get_lib()
    if (lib is None or keys.dtype != np.uint64 or tax.dtype != np.uint32
            or not keys.flags.c_contiguous or not tax.flags.c_contiguous
            or len(keys) != len(tax)):
        return None
    out_n = ctypes.c_int64(len(keys))
    lib.kasa_sort_kmer_tax_dedup(
        len(keys), keys.ctypes.data_as(ctypes.c_void_p),
        tax.ctypes.data_as(ctypes.c_void_p), int(key_bits),
        max(int(nthreads), 1), ctypes.byref(out_n))
    return int(out_n.value)
