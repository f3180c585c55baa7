"""Throughput identify pipeline (``--engine tpu``).

End-to-end fast path: native file parse -> vectorized padded read
matrix -> ONE fused jit (encode + classify) per batch -> native
rank+format -> file.  No per-read Python work anywhere on the hot
path; host assembly for batch i+1 overlaps device compute for batch i
(async jax dispatch + lookahead queue).

Design notes (vs the parity pipeline in match/pipeline.py):

  * Reads are laid out as a (rows, maxlen) uint8 matrix, padded with
    'X'.  Since the false-k-mer marker is 'X' too (Read.hpp:1068-1078),
    a row is just the read bytes followed by 'X' to maxlen; the
    uniform window count W = maxlen - 3*highestK + 1 over-counts, but
    every window beyond the read's true count starts inside the marker
    region and therefore has a '^' letter at a checked position
    (min_k-1 ..), so the kernel's validity mask zeroes it at every k
    -- phantom windows contribute nothing to scores or counts.
  * Window extraction is a reshape: the flat buffer's window at offset
    r*maxlen + c (c < W) never crosses into row r+1 because a window
    spans 3*highestK chars <= maxlen - c.  No gather, no per-line
    slicing.
  * Scoring uses the uniform dense/scatter lowerings of
    match/device.py classify_batch with kmers_per_read = W (2W for
    --six: RC row and forward row of a read are adjacent).
  * Output text and --filter flags come from native/writer.cpp, which
    is byte-identical to the Python writer (tests/test_native_writer).

This path is the CLI identify default since round 4 (`--engine
exact` selects the bit-parity engine); it trades bit-for-bit float
accumulation order for throughput (integer counts still match the
exact engine -- see tests/test_identify_parity.py).
"""

from __future__ import annotations

import functools
import os
import time as _time
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from ..core.alphabet import build_sanitize_lut, build_revcomp_lut
from ..core.encode import dna_to_aa_codes, encode_windows
from ..host import fastx
from ..utils import timers

# reads per device batch: fewer, bigger batches amortise the fixed
# cost of each upload / fetch round trip (not measured on the GPU)
READS_PER_BATCH = int(os.environ.get("KASA_READS_PER_BATCH", 8192))
MAXLEN_CAP = 8192       # reads longer than this fall back to the parity path
# turbo packed-readback tuning lives in match/turbo.py
# (CSR_CAP_FACTOR: typical corpora average 1-3 hit taxa per read,
# overflow falls back to the dense (R, WOUT) fetch; COUNT_FLUSH
# bounds on-device f32 count drift)
from .turbo import CSR_CAP_FACTOR, COUNT_FLUSH


class FastPathUnavailable(RuntimeError):
    """Workload shape the fast path does not cover; caller falls back
    to the parity pipeline."""


# identify_multiple overlap (main.cpp:1118-1334's many-files job shop):
# while file i occupies the device, a worker thread pre-parses file
# i+1 (native load_fastx releases the GIL).  Populated by
# prefetch_parse(), consumed by fast_identify().
_PARSE_CACHE: dict = {}

# (fallback_reads, total_reads) of the last fast identify run -- the
# bench publishes the fraction (VERDICT r2 #9: monitor the fallback
# rate in production)
LAST_FALLBACK = (0, 0)
# the dispatch strategy of the last fast identify run (budget-tuning
# telemetry for tools/bench)
LAST_DISPATCH = None
# when a list, every batch's ranked hit lists are appended to it as
# (first read, hit counts (R,), taxon rows (R, W), scores (R, W)) --
# exactly what the ranker receives, host fallbacks included -- so a
# check can hold identify's own scores against an oracle
HIT_SINK: list | None = None


def bytes_per_entry_resident(num_k: int, num_limbs: int = 2) -> int:
    """Estimated DEVICE bytes per index entry for the resident turbo
    tables (compact r4 layout): keys 4*L + rowdat 4*(L+2) + grp2
    4*numK, plus ~20% slack for d_tax4.  Fixed costs (the 134 MB
    router, the hot mask) are deliberately excluded -- they are
    identical across the resident/sharded choices and negligible
    against any real device-memory budget."""
    return int((4 * num_limbs + 4 * (num_limbs + 2) + 4 * num_k) * 1.2)


def device_table_budget(cfg) -> int:
    """Bytes of device memory the index tables may occupy.

    The reference's -m bounds HOST RAM (its index scan happens in RAM,
    main.cpp:590); our tables live in device memory, a hardware
    property, so the budget comes from the device's own memory_stats:
    85% of what the allocator's limit leaves free (on a GPU the limit
    is JAX's preallocated share of the card).  The CPU backend keeps
    -m; KASA_DEVICE_BUDGET (bytes) is an explicit override.  A device
    that reports no memory_stats is an error, not a guess."""
    env = os.environ.get("KASA_DEVICE_BUDGET")
    if env:
        return int(env)
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return int(cfg.memory_avail * 0.8)
    st = dev.memory_stats()
    if not st or not st.get("bytes_limit"):
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no "
            "memory_stats; set KASA_DEVICE_BUDGET to size the index "
            "tables")
    in_use = int(st.get("bytes_in_use", 0))
    return int((int(st["bytes_limit"]) - in_use) * 0.85)


def prefetch_parse(path: str, executor) -> None:
    """Queue a native parse of `path` on `executor` so the NEXT
    fast_identify call finds it ready."""
    from ..native import load_fastx
    if path in _PARSE_CACHE:
        return
    fmt = fastx.sniff_format(path)
    _PARSE_CACHE[path] = executor.submit(load_fastx, path, fmt == "fastq")


@functools.partial(
    jax.jit,
    static_argnames=("num_steps", "sub_steps", "min_k", "max_k", "highest_k",
                     "num_species", "num_reads", "cap", "run_scan_w",
                     "dense_scores", "protein", "one_frame", "lines_per_read",
                     "w_per_line"))
def fused_classify(idx_limbs, grp_id, grp_start, d_tax, masks, weights,
                   run_start, run_end, prefix_tbl, idx_tax,
                   byte_mat, lut,
                   num_steps, sub_steps, min_k, max_k, highest_k,
                   num_species, num_reads, cap, run_scan_w, dense_scores,
                   protein, one_frame, lines_per_read, w_per_line):
    """(rows, maxlen) uint8 -> classify outputs, one XLA program."""
    from .device import classify_batch

    rows, maxlen = byte_mat.shape
    L = idx_limbs.shape[1]
    stride = 1 if protein else 3
    # tail pad: lets the flat window array reach rows*maxlen entries;
    # every window touching it is sliced away below
    flat = jnp.concatenate([
        byte_mat.reshape(-1),
        jnp.zeros((stride * highest_k,), byte_mat.dtype)])
    aa = dna_to_aa_codes(flat, lut, protein=protein)
    win = encode_windows(aa, highest_k, stride)           # (Wflat, L)
    win = win[:rows * maxlen].reshape(rows, maxlen, L)
    if one_frame and not protein:
        win = win[:, ::3]
    q = win[:, :w_per_line].reshape(rows * w_per_line, L)
    kpr = w_per_line * lines_per_read
    rid = jnp.zeros((q.shape[0],), jnp.int32)
    valid = jnp.ones((q.shape[0],), bool)
    return classify_batch(
        idx_limbs, grp_id, grp_start, d_tax, masks, weights,
        run_start, run_end, prefix_tbl, idx_tax, q, rid, valid,
        num_steps, sub_steps, min_k, max_k, highest_k, num_species,
        num_reads, cap, kmers_per_read=kpr, run_scan_w=run_scan_w,
        dense_scores=dense_scores)


class BatchAssembler:
    """Vectorized ragged -> padded matrix assembly (host, numpy)."""

    def __init__(self, highest_k: int, min_k: int, protein: bool,
                 six: bool, one_frame: bool):
        self.highest_k = highest_k
        self.min_k = min_k
        self.protein = protein
        self.six = six and not protein
        self.one_frame = one_frame
        self.sanitize = build_sanitize_lut(protein=protein)
        self.revcomp = build_revcomp_lut()
        self.padc = ord("^") if protein else ord("X")
        self.marker_len = (highest_k - min_k) if protein \
            else (highest_k - min_k) * 3

    def window_target(self, maxlen: int) -> int:
        """Uniform windows per line for a padded line of `maxlen`."""
        if self.protein:
            return maxlen - self.highest_k + 1
        if self.one_frame:
            return maxlen // 3 - self.highest_k + 1
        return maxlen - 3 * self.highest_k + 1

    def true_counts(self, lens: np.ndarray) -> np.ndarray:
        """calculatekMerCount per line (line = read + marker)."""
        ll = lens + self.marker_len
        if self.protein:
            c = np.where(ll > self.highest_k + 1, ll - self.highest_k + 1, 0)
        elif self.one_frame:
            d3 = ll // 3
            c = np.where(d3 > self.highest_k + 1, d3 - self.highest_k + 1, 0)
        else:
            c = np.where(ll > 3 * self.highest_k + 1,
                         ll - 3 * self.highest_k + 1, 0)
        if self.six:
            c = c * 2
        return c

    def assemble(self, blob: np.ndarray, offs: np.ndarray, maxlen: int,
                 rows_pad: int) -> np.ndarray:
        """blob: sanitized bytes; offs: (R+1,) read offsets.  Returns
        (rows_pad * lines_per_read, maxlen) uint8, 'X'/'^'-padded; for
        --six the RC line precedes the forward line of each read
        (emission order of putReadIntoLocalMemory, Read.hpp:612-630,
        which only matters for visual tools -- scoring sums per read)."""
        lpr = 2 if self.six else 1
        out = np.full((rows_pad * lpr, maxlen), self.padc, np.uint8)
        self.assemble_into(out, blob, offs, maxlen, lpr, 0)
        return out

    def assemble_multi(self, blobs: list, offs_list: list, maxlen: int,
                       rows_pad: int) -> np.ndarray:
        """Multi-mate (paired-end) assembly: each read owns
        len(blobs) * (2 if six else 1) adjacent rows -- mate m's
        line(s) at offset m * spm (readFastqa_pairedEnd emits first
        mate's line(s) then second's, sharing one read id,
        Read.hpp:834-1050)."""
        spm = 2 if self.six else 1
        lpr = spm * len(blobs)
        out = np.full((rows_pad * lpr, maxlen), self.padc, np.uint8)
        for m, (blob, offs) in enumerate(zip(blobs, offs_list)):
            self.assemble_into(out, blob, offs, maxlen, lpr, m * spm)
        return out

    def assemble_into(self, out: np.ndarray, blob: np.ndarray,
                      offs: np.ndarray, maxlen: int, lpr: int,
                      row_off: int) -> None:
        """Write one mate's line(s) into `out` (rows_pad * lpr, maxlen):
        read r's rows start at r * lpr + row_off (RC first under --six,
        then forward)."""
        R = len(offs) - 1
        lens = np.diff(offs)
        out_flat = out.reshape(-1)
        src = np.arange(len(blob), dtype=np.int64)
        rid = np.repeat(np.arange(R, dtype=np.int64), lens)
        within = src - offs[rid]
        if self.six:
            fwd_rows = lpr * rid + row_off + 1
            out_flat[fwd_rows * maxlen + within] = blob[src]
            # short reads are padded BEFORE RC (paddingOfSmallReads then
            # reverseComplement), so the RC row gets an 'X' prefix
            need = np.maximum(0, 3 * self.highest_k - self.marker_len - lens)
            rc_rows = lpr * rid + row_off
            rc_within = need[rid] + (lens[rid] - 1 - within)
            out_flat[rc_rows * maxlen + rc_within] = self.revcomp[blob[src]]
        else:
            out_flat[(lpr * rid + row_off) * maxlen + within] = blob[src]


def _bucket(n: int, minimum: int) -> int:
    size = minimum
    while size < n:
        size <<= 1
    return size


_LEN_BUCKETS_SEEN: set = set()
_LEN_BUCKET_CAP = 8     # distinct fine buckets before coarsening


def _len_bucket(n: int, minimum: int, step: int = 16) -> int:
    """Round the padded line length up to a multiple of `step`.

    Finer than power-of-two bucketing: a 150 bp read plus the 15-char
    false-k-mer marker is 165 chars; rounding to 256 would process 221
    windows per line where 176 -> 141 suffice (1.57x wasted device
    work).  Each distinct bucket compiles once; inputs cluster around
    their platform read length, so steady state sees a handful.  Mixed-
    length corpora (nanopore) would otherwise trigger unbounded
    recompiles, so after
    _LEN_BUCKET_CAP distinct fine buckets new lengths coarsen to
    power-of-two (reusing an existing fine bucket when one covers n
    within one step)."""
    n = max(n, minimum)
    fine = (n + step - 1) // step * step
    if fine in _LEN_BUCKETS_SEEN or len(_LEN_BUCKETS_SEEN) < _LEN_BUCKET_CAP:
        _LEN_BUCKETS_SEEN.add(fine)
        return fine
    covering = [b for b in _LEN_BUCKETS_SEEN if fine <= b <= fine + 4 * step]
    if covering:
        return min(covering)
    size = 1 << (fine - 1).bit_length()
    _LEN_BUCKETS_SEEN.add(size)
    return size


def select_turbo_dispatch(cfg, index_path, limbs, taxids, content,
                          highest_k, tax_rows=None):
    """Pick the dispatch strategy for this index: resident turbo
    (single chip or (dp, ip) mesh) or tiered chunk streaming; None
    when the turbo structure does not apply (classic path), raises
    FastPathUnavailable when no device strategy can hold the index."""
    from .turbo import turbo_supported, load_or_build_turbo
    devs = jax.devices()
    print(f"OUT: device {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}", flush=True)
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    tax_to_row = content.tax_to_idx
    num_limbs = limbs.shape[1] if len(taxids) else 2
    n_idx = len(taxids)
    # resident turbo caps the GLOBAL entry count (int32 grp2 indexing,
    # n < 2^28); the tiered path only needs its per-CHUNK tables to
    # index in int32, so RefSeq-scale indices (the 1 GB scale corpus
    # builds 999M entries) stay eligible for chunk streaming
    eligible_resident = turbo_supported(n_idx, num_limbs, min_k, max_k, S)
    eligible_tiered = (n_idx > 0 and num_limbs == 2
                       and num_k <= 6 and min_k >= 6
                       and S < (1 << 24))
    if not (eligible_resident or eligible_tiered):
        return None
    from .join import map_tax_rows

    def rows():
        return (tax_rows if tax_rows is not None
                else map_tax_rows(taxids, tax_to_row))
    content_path = cfg.content_file or index_path + "_content.txt"
    try:
        content_token = os.stat(content_path).st_mtime_ns
    except OSError:
        content_token = None
    from .tiered import (TieredTurboDispatch, bytes_per_entry_tiered,
                         TMAX)
    budget = device_table_budget(cfg)
    table_bytes = bytes_per_entry_resident(num_k, num_limbs) \
        * max(len(taxids), 1)
    # an over-budget index first tries to SHARD over the mesh's
    # "ip" axis (each chip holds 1/ip of the tables -- strictly
    # faster than streaming chunks); tiered streaming is the
    # fallback when even full-mesh sharding cannot fit
    min_ip = 1
    if not cfg.ram and table_bytes > budget and min_k >= 6:
        import jax as _jax
        ndev = len(_jax.devices())
        while min_ip < ndev and table_bytes // min_ip > budget:
            min_ip <<= 1
        if table_bytes // min_ip > budget or min_ip > ndev \
                or min_ip == 1:
            min_ip = 0          # sharding cannot fit -> tiered
    mesh_forced = max(
        int(os.environ.get("KASA_MESH_IP", "0") or 0),
        int(os.environ.get("KASA_MESH_DP", "0") or 0)) > 1
    if (eligible_tiered and not cfg.ram
            and table_bytes > budget
            and (min_ip == 0 or not eligible_resident)
            and not mesh_forced):
        # -m exceeded: stream limb0-run-aligned chunks through the
        # turbo structure instead of holding resident tables
        # (match/tiered.py); host handles T > TMAX groups
        chunk_entries = max(
            int(budget * 0.75) // bytes_per_entry_tiered(num_k),
            1 << 16)
        print(f"OUT: turbo tables ({table_bytes >> 20} MiB) exceed "
              f"the memory budget; tiered turbo streams "
              f"{chunk_entries}-entry chunks (T>{TMAX} groups on "
              "host)", flush=True)
        with timers.stage("tiered/tables"):
            return TieredTurboDispatch(
                index_path, limbs, rows(),
                highest_k, min_k, max_k, S, chunk_entries,
                cache_dir=(os.path.join(cfg.temp_path,
                           f"oocache_turbo_{cfg.call_idx}")
                           if cfg.temp_path else None))
    if eligible_resident:
        from .turbo import TurboRowOverflow
        try:
            with timers.stage("turbo/tables"):
                tt = load_or_build_turbo(
                    index_path, limbs, rows(),
                    highest_k, min_k, max_k, S,
                    content_token=content_token)
        except TurboRowOverflow as e:
            # multi-heavy index: int32 grp2 pointers would wrap.  The
            # tiered path's per-chunk tables stay int32-safe; else the
            # classic device loop takes over (correct, slower).
            if eligible_tiered:
                print(f"OUT: {e}; streaming tiered turbo instead",
                      flush=True)
                chunk_entries = max(
                    int(budget * 0.75) // bytes_per_entry_tiered(num_k),
                    1 << 16)
                with timers.stage("tiered/tables"):
                    return TieredTurboDispatch(
                        index_path, limbs, rows(),
                        highest_k, min_k, max_k, S, chunk_entries,
                        cache_dir=(os.path.join(
                            cfg.temp_path,
                            f"oocache_turbo_{cfg.call_idx}")
                            if cfg.temp_path else None))
            print(f"OUT: {e}; using the classic engine", flush=True)
            return None
        return make_turbo_dispatch(tt, limbs, taxids, tax_to_row,
                                   num_k, S, min_ip=max(min_ip, 1))
    raise FastPathUnavailable(
        "index too large for resident turbo and tiered "
        "streaming was excluded (-r or mesh override)")


def fast_identify(cfg, index_path: str, input_path: str,
                  out_file: str | None, profile_file: str | None,
                  content, freqs, limbs, taxids, highest_k: int,
                  tax_rows=None):
    """Drive the fast pipeline over one input file.  Returns the same
    tuple as pipeline.identify.  Raises FastPathUnavailable when the
    workload needs the parity pipeline."""
    import jax
    import jax.numpy as jnp
    from ..host import output as out_mod
    from ..native import NativeRanker, get_lib, load_fastx, sanitize_inplace
    from .engine import TpuEngine
    from .device import StackedTables
    from .join import DeviceIndex

    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    protein = cfg.translated

    if get_lib() is None:
        raise FastPathUnavailable("native library unavailable")

    paired = bool(cfg.paired_end_1)
    mates = []
    paths = ([cfg.paired_end_1, cfg.paired_end_2] if paired
             else [input_path])
    for p in paths:
        fmt = fastx.sniff_format(p)
        with timers.stage("fast/parse"):
            parsed = _PARSE_CACHE.pop(p, None)
            if parsed is not None and not isinstance(parsed, tuple):
                parsed = parsed.result()        # prefetch future
            if parsed is None:
                parsed = load_fastx(p, fmt == "fastq")
        if parsed is None:
            raise FastPathUnavailable("native parse failed")
        mates.append(parsed)
    seq, seq_off, name_blob, name_off, nlines = mates[0]
    R_total = len(seq_off) - 1
    lens = np.diff(seq_off)
    if paired:
        if len(mates[1][1]) - 1 != R_total:
            # the reference zips mates; unequal files end at the shorter
            R_total = min(R_total, len(mates[1][1]) - 1)
        lens2 = np.diff(mates[1][1])[:R_total]
        lens = lens[:R_total]
    if R_total == 0:
        raise FastPathUnavailable("empty input")
    maxraw = int(lens.max()) if R_total else 0
    if paired:
        maxraw = max(maxraw, int(lens2.max()))
    if maxraw > MAXLEN_CAP:
        raise FastPathUnavailable("giant reads need the chunked pipeline")

    for m in mates:
        if np.any((m[0] == ord(" ")) | (m[0] == ord("\t"))):
            raise RuntimeError("Spaces or tabs inside read, "
                               "please check your input.")
        sanitize_inplace(m[0], protein)

    asm = BatchAssembler(highest_k, min_k, protein, cfg.six_frames,
                         cfg.one_frame)
    lpr = (2 if (cfg.six_frames and not protein) else 1) * len(mates)

    # report lengths follow the reference's char counter (raw chars +
    # one newline per sequence line, match/ingest.py add_read); paired
    # mates share one read id with summed lengths and names joined
    # with trailing spaces (readFastqa_pairedEnd, Read.hpp:834-1050)
    rep_lens = (lens + nlines[:R_total]).astype(np.uint32)
    if paired:
        rep_lens = (rep_lens.astype(np.int64)
                    + lens2 + mates[1][4][:R_total]) \
            .astype(np.uint32)
        name_blob, name_off = _join_name_blobs(
            name_blob, name_off, mates[1][2], mates[1][3], R_total)

    # device tables
    disp = select_turbo_dispatch(cfg, index_path, limbs, taxids,
                                 content, highest_k, tax_rows=tax_rows)
    global LAST_DISPATCH
    LAST_DISPATCH = disp
    if disp is not None:
        mate_views = [(m[0], m[1]) for m in mates]
        return _fast_identify_turbo(
            cfg, disp, asm, lpr, mate_views, name_blob, name_off,
            rep_lens, lens, R_total, out_file, profile_file, content,
            freqs, highest_k, input_path)
    if paired:
        raise FastPathUnavailable("paired-end rides the turbo path only")

    with timers.stage("fast/tables"):
        dev = DeviceIndex(limbs, taxids, tax_to_row, highest_k, min_k,
                          max_k, S)
    tables = StackedTables.build(dev)
    run_scan_w = tables.max_run if (tables.max_run <= 16 and not protein
                                    and dev.num_limbs == 2 and min_k >= 6
                                    and not cfg.one_frame) else 0
    dense = S <= 512
    tabs = (tables.idx_limbs, tables.grp_id, tables.grp_start, tables.d_tax,
            tables.masks, tables.weights, tables.run_start, tables.run_end,
            tables.prefix_tbl, tables.idx_tax)
    from ..core.encode import build_codon_code_lut, custom_code_lut
    lut_np = custom_code_lut(cfg)
    lut = jnp.asarray(lut_np if lut_np is not None
                      else build_codon_code_lut(), dtype=jnp.int32)

    ranker = None
    if out_file or cfg.filter:
        ranker = NativeRanker(
            content.idx_to_tax, content.organisms, freqs[:, 0],
            min_k, max_k, highest_k, protein, cfg.num_frames,
            cfg.threshold, cfg.num_of_beasts, cfg.output_format,
            coherence_on=False, filter_on=cfg.filter,
            error_threshold=cfg.error_threshold,
            coherence_threshold=cfg.coherence_threshold)
        if not ranker.ok:
            raise FastPathUnavailable("native ranker unavailable")

    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    filtered_ids: list = []

    fh = None
    if out_file:
        fh = open(out_file, "wb")
        if cfg.output_format == "json":
            fh.write(b"[\n")
        elif cfg.output_format == "tsv":
            fh.write(b"#Read number\tSpecifier from input file\tMatched "
                     b"taxa\tNames\tScores{relative,k-mer}\tError\n")

    inflight: deque = deque()

    def drain(block_all=False):
        nonlocal num_kmers_in_input
        while inflight and (block_all or len(inflight) > 1):
            fut, r0, r1, nk = inflight.popleft()
            scores_d, call_d, cu_d, _tail = fut
            counts_all[:] += np.asarray(call_d, dtype=np.float64)
            counts_unique[:] += np.asarray(cu_d).astype(np.uint64)
            num_kmers_in_input += int(nk)
            if ranker is not None:
                with timers.stage("fast/rank+write"):
                    scores = np.asarray(scores_d)[:r1 - r0]
                    names = [
                        name_blob[name_off[i]:name_off[i + 1]]
                        .tobytes().decode("latin-1") + " "
                        for i in range(r0, r1)]
                    text, flags = ranker.format(scores, names,
                                                rep_lens[r0:r1], r0)
                    if fh is not None:
                        fh.write(text)
                    if flags is not None:
                        filtered_ids.extend(
                            (r0 + np.nonzero(flags)[0]).tolist())

    t_start = _time.perf_counter()
    rpb = READS_PER_BATCH
    for r0 in range(0, R_total, rpb):
        r1 = min(r0 + rpb, R_total)
        if cfg.verbose and r0:
            frac = r0 / R_total
            el = _time.perf_counter() - t_start
            print(f"OUT: Progress of current file: {frac * 100.0:.2f} %"
                  f" (ETA: {el / frac - el:.0f}s)", flush=True)
        blens = lens[r0:r1]
        with timers.stage("fast/assemble"):
            line_target = int(blens.max()) + asm.marker_len
            if not protein:
                maxlen = _len_bucket(line_target, 3 * highest_k)
            else:
                maxlen = _len_bucket(line_target, highest_k)
            rows_pad = _bucket(r1 - r0, 512)
            blob = seq[seq_off[r0]:seq_off[r1]]
            offs = (seq_off[r0:r1 + 1] - seq_off[r0]).astype(np.int64)
            mat = asm.assemble(blob, offs, maxlen, rows_pad)
            nk = int(asm.true_counts(blens).sum())
        with timers.stage("fast/dispatch"):
            w = asm.window_target(maxlen)
            fut = fused_classify(
                *tabs, jnp.asarray(mat), lut,
                tables.num_steps, tables.sub_steps, min_k, max_k,
                highest_k, S, rows_pad, 8, run_scan_w, dense,
                protein, cfg.one_frame, lpr, w)
            inflight.append((fut, r0, r1, nk))
        drain()
    drain(block_all=True)

    if fh is not None:
        if cfg.output_format == "json":
            fh.write(b"\n]")
        fh.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique, None, freqs,
            num_kmers_in_input, R_total, min_k, max_k, cfg.num_frames,
            coverage=False)

    if cfg.filter:
        from .pipeline import write_filtered
        write_filtered(cfg, input_path, filtered_ids)

    if cfg.verbose:
        timers.report()

    return counts_all, counts_unique, R_total, num_kmers_in_input



class SingleTurboDispatch:
    """Single-chip dispatch/decode strategy for the turbo drive loop
    (the mesh twin is parallel/turbo_mesh.MeshTurboDispatch)."""

    # batches observed before the multi budgets tighten to the corpus
    TUNE_AFTER = 6

    def __init__(self, tt, num_k: int, num_species: int):
        self.tt = tt
        self._acc_shape = (num_k, num_species)
        self._tabs = (tt.keys2, tt.rowdat, tt.router, tt.sub2, tt.grp2,
                      tt.d_tax4, tt.weights, tt.masks2, tt.hotmask,
                      tt.t_hot)
        # multi worklist / expansion budgets: every scatter+gather in
        # the multi path scales with them, so a corpus with few multi
        # slots should not pay the worst-case 2^19 sizing.  Explicit
        # env overrides win; otherwise budgets come from per-read
        # high-water HINTS persisted in the index's .tabs sidecar by
        # earlier runs.  Hints are adopted ONLY at strategy creation:
        # a mid-run budget swap means a mid-run compile inside the
        # run.
        from .turbo import MULTI_BUDGET, EXP_BUDGET
        env_mb = int(os.environ.get("KASA_MULTI_BUDGET", 0) or 0)
        env_eb = int(os.environ.get("KASA_EXP_BUDGET", 0) or 0)
        self._default_mb = env_mb or MULTI_BUDGET
        self._default_eb = env_eb or EXP_BUDGET
        self._env = bool(env_mb or env_eb)
        self._tune = not self._env \
            and not os.environ.get("KASA_NO_BUDGET_TUNE")
        # telemetry accumulates ON the cached tables so short runs
        # (the CLI warm-up, identify_multiple's small files) count
        # toward the TUNE_AFTER threshold of later runs
        st = getattr(tt, "_tune_state", None)
        if st is None:
            st = {"seen": 0, "hi": [0.0, 0.0]}    # per-READ rates
            hints = self._load_hints()
            if hints is not None:
                st = {"seen": self.TUNE_AFTER,
                      "hi": [float(hints[0]), float(hints[1])]}
            tt._tune_state = st
        self._st = st
        self._escalated = False
        # SNAPSHOT the hint values now: _budgets_for must return the
        # same sizes for a geometry across the whole run (live
        # telemetry crossing the threshold mid-run would re-jit)
        self._hints_ready = st["seen"] >= self.TUNE_AFTER
        self._hints = (float(st["hi"][0]), float(st["hi"][1]))

    # ---- persisted tuning hints (sidecar <tabs>/tuning.json)
    def _hints_path(self):
        d = getattr(self.tt, "_sidecar_dir", None)
        return os.path.join(d, "tuning.json") if d else None

    def _load_hints(self):
        p = self._hints_path()
        if not p:
            return None
        try:
            import json
            with open(p) as fh:
                h = json.load(fh)
            return (h["mtot_per_read"], h["eused_per_read"])
        except Exception:
            return None

    def _save_hints(self):
        p = self._hints_path()
        if not p:
            return
        try:
            import json
            with open(p + ".tmp", "w") as fh:
                json.dump({"mtot_per_read": self._st["hi"][0],
                           "eused_per_read": self._st["hi"][1]}, fh)
            os.replace(p + ".tmp", p)
        except OSError:
            pass

    def _budgets_for(self, rows_pad: int):
        """Static worklist/expansion budgets for this batch geometry:
        per-read hints x reads, 1.5x headroom, next power of two.
        Uses the hint SNAPSHOT taken at strategy creation -- stable
        for the whole run."""
        if self._env or not self._tune \
                or not self._hints_ready or self._escalated:
            return self._default_mb, self._default_eb

        def fit(rate, default):
            need = 3 * rate * rows_pad / 2
            b = 1 << 15
            while b < need:
                b <<= 1
            return min(b, default)
        return (fit(self._hints[0], self._default_mb),
                fit(self._hints[1], self._default_eb))

    def observe(self, packed: np.ndarray, rows_pad: int) -> None:
        """Budget telemetry from a decoded batch (writer thread)."""
        if not self._tune:
            return
        mtot, eused = int(packed[-4]), int(packed[-3])
        hi = self._st["hi"]
        grew = (mtot > hi[0] * rows_pad) or (eused > hi[1] * rows_pad)
        hi[0] = max(hi[0], mtot / rows_pad)
        hi[1] = max(hi[1], eused / rows_pad)
        self._st["seen"] += 1
        if grew or self._st["seen"] == self.TUNE_AFTER:
            self._save_hints()
        mb0, eb0 = self._budgets_for(rows_pad)
        if (mb0, eb0) != (self._default_mb, self._default_eb) \
                and (mtot >= mb0 - (mb0 >> 2)
                     or eused >= eb0 - (eb0 >> 2)):
            # a batch is approaching the tuned caps: fall back to the
            # worst-case sizing for the REST of this run (one compile
            # stall beats a budget-overflow host-fallback storm) and
            # leave the grown hints for the next run
            self._escalated = True

    def new_acc(self):
        import jax.numpy as jnp
        return (jnp.zeros(self._acc_shape, jnp.float32),
                jnp.zeros(self._acc_shape, jnp.int32))

    def reduce_acc(self, acc_ca, acc_cu):
        return np.asarray(acc_ca), np.asarray(acc_cu).astype(np.int64)

    def fetch(self, arr) -> np.ndarray:
        """Device -> host for a per-batch output array."""
        return np.asarray(arr)

    def round_rows(self, rows_pad: int) -> int:
        return rows_pad

    def csr_cap(self, rows_pad: int) -> int:
        return CSR_CAP_FACTOR * rows_pad

    def dispatch(self, mat, lut, acc_ca, acc_cu, rows_pad, protein,
                 one_frame, lpr, w, cap, unique=False):
        import jax.numpy as jnp
        from .turbo import fused_turbo_acc
        tt = self.tt
        mb, eb = self._budgets_for(rows_pad)
        return fused_turbo_acc(
            *self._tabs, jnp.asarray(mat), lut, acc_ca, acc_cu,
            tt.num_steps, tt.min_k, tt.max_k, tt.highest_k,
            self._acc_shape[1], rows_pad, protein, one_frame, lpr, w,
            cap, unique, multi_budget=mb, exp_budget=eb)

    def dispatch_files(self, mat, lut, file_of_read, num_files,
                       rows_pad, protein, one_frame, lpr, w, cap,
                       unique=False):
        """identify_multiple batches: per-file count matrices come back
        per batch ((num_files, numK, S)) instead of accumulating."""
        import jax.numpy as jnp
        from .turbo import fused_turbo_files
        tt = self.tt
        mb, eb = self._budgets_for(rows_pad)
        packed, ht, hk, ca, cu = fused_turbo_files(
            *self._tabs, jnp.asarray(mat), lut,
            jnp.asarray(file_of_read), tt.num_steps, tt.min_k,
            tt.max_k, tt.highest_k, self._acc_shape[1], rows_pad,
            protein, one_frame, lpr, w, cap, unique, mb, eb,
            num_files)
        if num_files == 1:
            ca, cu = ca[None], cu[None]
        return packed, ht, hk, ca, cu

    def decode(self, packed: np.ndarray, rows_pad: int, rb: int,
               cap: int, want_lists: bool, ht_d=None, hk_d=None):
        from .tiered import SingleTurboDispatch_decode
        return SingleTurboDispatch_decode(packed, rows_pad, rb, cap,
                                          want_lists, ht_d, hk_d)


def make_turbo_dispatch(tt, limbs, taxids, tax_to_row, num_k: int,
                        num_species: int, min_ip: int = 1):
    """Pick the single-chip or mesh strategy.  A mesh activates when
    more than one jax device is visible (or KASA_MESH_IP/DP force a
    shape, e.g. under the CPU-device dryrun); ip defaults to 1 --
    index-parallel shards exist for device-memory capacity (min_ip
    raises it when the caller knows the tables exceed one chip's
    budget), data-parallel rows are where throughput scales
    (see parallel/turbo_mesh.py).  The mesh is a plain reshape of the
    device list: the cards of one host reach each other all to all
    over NVLink, so only the algorithm decides the shape."""
    import jax
    devs = jax.devices()
    ndev = len(devs)
    ip = int(os.environ.get("KASA_MESH_IP", 0) or 0) or max(min_ip, 1)
    dp = int(os.environ.get("KASA_MESH_DP", 0) or 0) \
        or max(ndev // ip, 1)
    if dp * ip <= 1 or dp * ip > ndev or tt.min_k < 6 \
            or tt.keys2.shape[1] != 2:
        # (128-bit tables ride the single-chip strategy for now: the
        # sharded stacker pads 2-limb keys only)
        return SingleTurboDispatch(tt, num_k, num_species)
    from jax.sharding import Mesh
    from ..parallel.turbo_mesh import MeshTurboDispatch, ShardedTurboTables
    from .join import map_tax_rows
    with timers.stage("turbo/mesh-tables"):
        st = ShardedTurboTables.build(
            limbs, map_tax_rows(taxids, tax_to_row), tt.highest_k,
            tt.min_k, tt.max_k, num_species, ip, host_tables=tt)
        mesh = Mesh(np.asarray(devs[:dp * ip]).reshape(dp, ip),
                    ("dp", "ip"))
    print(f"OUT: turbo mesh active: dp={dp} x ip={ip} over {ndev} "
          "devices", flush=True)
    return MeshTurboDispatch(st, mesh)


def _join_name_blobs(blob1, off1, blob2, off2, R):
    """Paired-end specifier: "name1 name2" per read (each mate's name
    plus a trailing space is appended, Read.hpp:869-874; the drive loop
    adds the final trailing space)."""
    n1 = np.diff(off1[:R + 1])
    n2 = np.diff(off2[:R + 1])
    tot = n1 + 1 + n2
    off = np.zeros(R + 1, np.int64)
    np.cumsum(tot, out=off[1:])
    buf = np.full(int(off[-1]), ord(" "), np.uint8)
    src1 = np.arange(int(off1[R]), dtype=np.int64)
    rid1 = np.repeat(np.arange(R, dtype=np.int64), n1)
    buf[off[rid1] + (src1 - off1[rid1])] = blob1[src1]
    src2 = np.arange(int(off2[R]), dtype=np.int64)
    rid2 = np.repeat(np.arange(R, dtype=np.int64), n2)
    buf[off[rid2] + n1[rid2] + 1 + (src2 - off2[rid2])] = blob2[src2]
    return buf, off


def fast_identify_multi(cfg, index_path: str, files: list,
                        out_files: list, content, freqs, limbs, taxids,
                        highest_k: int, profile_files: list | None = None):
    """identify_multiple packing: classify a FOLDER of single-end
    files as one read stream with shared batches (small files no
    longer pay a whole padded batch each) and per-file output demux.

    The reference schedules files over a many-cores job shop
    (main.cpp:1118-1334); on a device mesh the natural unit is the
    batch, so files concatenate into one stream and the per-file
    boundaries only matter to the output writer.  With profile_files,
    boundary-spanning batches run the per-file count kernel
    (turbo.fused_turbo_files) so every file still gets exact count
    matrices (r5; the reference keeps per-task count arrays,
    main.cpp:1292-1326).

    Returns per-file (ca, cu, reads, num_kmers) tuples."""
    import jax.numpy as jnp
    from ..native import get_lib, load_fastx, sanitize_inplace

    min_k, max_k = cfg.lower_k, cfg.higher_k
    S = content.num_species
    protein = cfg.translated
    if get_lib() is None:
        raise FastPathUnavailable("native library unavailable")
    if cfg.paired_end_1 or cfg.filter or (cfg.six_frames and not protein):
        raise FastPathUnavailable("packed multi-file is single-end only")

    parsed = []
    for f in files:
        fmt = fastx.sniff_format(f)
        with timers.stage("fast/parse"):
            pr = _PARSE_CACHE.pop(f, None)
            if pr is not None and not isinstance(pr, tuple):
                pr = pr.result()
            if pr is None:
                pr = load_fastx(f, fmt == "fastq")
        if pr is None:
            raise FastPathUnavailable("native parse failed")
        parsed.append(pr)

    # concatenate the per-file blobs into one global stream
    seqs = [p[0] for p in parsed]
    seq = np.concatenate(seqs) if len(seqs) > 1 else seqs[0]
    seq_off_parts, name_off_parts = [], []
    soff = noff = 0
    bounds = [0]
    for p in parsed:
        seq_off_parts.append(p[1][:-1] + soff)
        soff += p[1][-1]
        name_off_parts.append(p[3][:-1] + noff)
        noff += p[3][-1]
        bounds.append(bounds[-1] + len(p[1]) - 1)
    seq_off = np.concatenate(seq_off_parts + [np.array([soff])])
    name_blob = np.concatenate([p[2] for p in parsed])
    name_off = np.concatenate(name_off_parts + [np.array([noff])])
    nlines = np.concatenate([p[4] for p in parsed])
    R_total = bounds[-1]
    if R_total == 0:
        raise FastPathUnavailable("empty inputs")
    lens = np.diff(seq_off)
    if int(lens.max()) > MAXLEN_CAP:
        raise FastPathUnavailable("giant reads need the chunked pipeline")
    if np.any((seq == ord(" ")) | (seq == ord("\t"))):
        raise RuntimeError("Spaces or tabs inside read, "
                           "please check your input.")
    sanitize_inplace(seq, protein)
    rep_lens = (lens + nlines[:R_total]).astype(np.uint32)

    disp = select_turbo_dispatch(cfg, index_path, limbs, taxids,
                                 content, highest_k)
    if disp is None:
        raise FastPathUnavailable("turbo structure unavailable")
    if profile_files and not hasattr(disp, "dispatch_files"):
        raise FastPathUnavailable(
            "per-file counts ride the single-chip turbo strategy")
    asm = BatchAssembler(highest_k, min_k, protein, False,
                         cfg.one_frame)
    segments = [dict(fid=i, start=bounds[i], end=bounds[i + 1],
                     out=out_files[i], fh=None,
                     profile=(profile_files[i] if profile_files
                              else None))
                for i in range(len(files))]
    _ca, _cu, _r, _nk = _fast_identify_turbo(
        cfg, disp, asm, 1, [(seq, seq_off)], name_blob, name_off,
        rep_lens, lens, R_total, "-", None, content, freqs, highest_k,
        files[0], segments=segments)
    out = []
    from ..host import output as out_mod
    for i, seg in enumerate(segments):
        nr = bounds[i + 1] - bounds[i]
        nk = int(asm.true_counts(lens[bounds[i]:bounds[i + 1]]).sum())
        if seg.get("profile"):
            out_mod.write_profile(
                seg["profile"], content.organisms, content.idx_to_tax,
                seg["ca"], seg["cu"], None, freqs, nk, nr,
                min_k, max_k, cfg.num_frames, coverage=False)
            out.append((seg["ca"], seg["cu"], nr, nk))
        else:
            out.append((None, None, nr, nk))
    return out


def _fast_identify_turbo(cfg, disp, asm, lpr, mate_views, name_blob,
                         name_off, rep_lens, lens, R_total, out_file,
                         profile_file, content, freqs, highest_k,
                         input_path, segments=None):
    """Turbo-kernel drive of the fast pipeline (match/turbo.py): same
    batching/output structure as fast_identify, but classification runs
    the gather-minimal kernel and ranking consumes compact per-read hit
    lists (native sparse writer).  Reads that exceed the kernel's
    static expansion budgets are recomputed exactly on the host.

    `disp` is the dispatch/decode strategy: SingleTurboDispatch for
    one chip, parallel/turbo_mesh.MeshTurboDispatch for a (dp, ip)
    device mesh -- the loop below is identical either way.

    Readback discipline: per batch the host fetches ONE packed int32
    array (hit counts + flags + CSR hit list); per-taxon count matrices
    accumulate on DEVICE and are flushed every COUNT_FLUSH batches
    (bounding f32 accumulation drift) and at EOF."""
    import jax
    import jax.numpy as jnp
    from ..host import output as out_mod
    from ..native import NativeRanker
    from ..core.encode import build_codon_code_lut, custom_code_lut
    from .turbo import host_classify_read, read_windows_np

    tt = disp.tt
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    protein = cfg.translated

    lut_np = custom_code_lut(cfg)
    lut_np = np.asarray(lut_np if lut_np is not None
                        else build_codon_code_lut(), dtype=np.int32)
    lut = jnp.asarray(lut_np)

    ranker = None
    if out_file or cfg.filter:
        ranker = NativeRanker(
            content.idx_to_tax, content.organisms, freqs[:, 0],
            min_k, max_k, highest_k, protein, cfg.num_frames,
            cfg.threshold, cfg.num_of_beasts, cfg.output_format,
            coherence_on=False, filter_on=cfg.filter,
            error_threshold=cfg.error_threshold,
            coherence_threshold=cfg.coherence_threshold)
        if not ranker.ok:
            raise FastPathUnavailable("native ranker unavailable")

    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    filtered_ids: list = []

    hdr = (b"[\n" if cfg.output_format == "json" else
           b"#Read number\tSpecifier from input file\tMatched "
           b"taxa\tNames\tScores{relative,k-mer}\tError\n"
           if cfg.output_format == "tsv" else b"")
    fh = None
    per_file_counts = segments is not None \
        and any(seg.get("profile") for seg in segments)
    if segments is not None:
        # identify_multiple packing: each output file frames its own
        # read range; batches may span file boundaries
        for seg in segments:
            seg["fh"] = open(seg["out"], "wb") if seg["out"] else None
            if seg["fh"] is not None and hdr:
                seg["fh"].write(hdr)
            if per_file_counts:
                seg["ca"] = np.zeros((num_k, S), np.float64)
                seg["cu"] = np.zeros((num_k, S), np.uint64)
    elif out_file:
        fh = open(out_file, "wb")
        if hdr:
            fh.write(hdr)

    num_k_ = num_k
    fallback_reads = 0
    additive = getattr(disp, "additive_fixup", False)
    rpb = getattr(disp, "reads_per_batch", None) or READS_PER_BATCH

    def read_q(mat, r, w):
        q = read_windows_np(mat[r * lpr:(r + 1) * lpr], lut_np,
                            highest_k, protein, cfg.one_frame, w)
        if cfg.unique:
            from .turbo import dedup_windows_np
            q = dedup_windows_np(q)
        return q

    def fallback(mat, r, w):
        return host_classify_read(tt, read_q(mat, r, w))

    # results pipeline: ONE writer thread consumes finished batches in
    # FIFO order (fetch -> decode -> host fallback -> native rank ->
    # file), fully overlapping device compute of batch i+1 with host
    # post-processing of batch i.  The reference overlaps exactly these
    # stages with its output thread (Compare.hpp:3391); round 3 did
    # fetch+rank inline and lost ~40% of e2e to it (VERDICT r3 #3a).
    import queue as _queue
    import threading as _threading
    work_q: _queue.Queue = _queue.Queue(maxsize=4)
    writer_exc: list = []

    def _seg_of(global_r):
        for seg in segments:
            if seg["start"] <= global_r < seg["end"]:
                return seg
        return segments[-1]

    def consume(item):
        nonlocal num_kmers_in_input, fallback_reads
        if True:
            (packed_d, ht_d, hk_d, r0, r1, nk, mat, w, rows_pad, cap,
             extra) = item
            rb = r1 - r0
            num_kmers_in_input += int(nk)
            with timers.stage("fast/fetch"):
                packed = disp.fetch(packed_d)
            if extra is not None:
                # per-file count matrices of this batch (identify_
                # multiple with profiles): fold into each segment's
                # host accumulator
                ca_d, cu_d, batch_segs = extra
                with timers.stage("fast/fetch-counts"):
                    ca_b = np.asarray(ca_d).astype(np.float64)
                    cu_b = np.asarray(cu_d).astype(np.uint64)
                for i, seg in enumerate(batch_segs):
                    seg["ca"] += ca_b[i]
                    seg["cu"] += cu_b[i]
            obs = getattr(disp, "observe", None)
            if obs is not None:
                obs(packed, rows_pad)
            hc, ofc, ofl, nflag, ht, hk = disp.decode(
                packed, rows_pad, rb, cap, ranker is not None,
                ht_d, hk_d)
            # without a ranker only count-overflow rows need recompute
            # (hit lists are never consumed); with one, every truncated
            # list (ofl superset of ofc) is rebuilt
            need_fix = ofl if ranker is not None else ofc
            if nflag and need_fix.any():
                with timers.stage("turbo/fallback"):
                    rows = np.nonzero(need_fix)[0]
                    fallback_reads += len(rows)
                    fixes = {}
                    wmax = ht.shape[1] if ht is not None else 0
                    for r in rows:
                        if per_file_counts:
                            _s = _seg_of(r0 + int(r))
                            tca, tcu = _s["ca"], _s["cu"]
                        else:
                            tca, tcu = counts_all, counts_unique
                        if additive:
                            # tiered contract: device counted every
                            # T <= TMAX group exactly; the host ADDS
                            # the big groups (ofc bit) and rebuilds
                            # truncated lists in full (ofl bit)
                            q = read_q(mat, int(r), w)
                            if ofc[r]:
                                _sc, ca2, cu2 = disp.host_big_counts(q)
                                tca[:] += ca2
                                tcu[:] += cu2.astype(np.uint64)
                            if ranker is None:
                                continue
                            scores = disp.host_full_list(q)
                        else:
                            scores, ca2, cu2 = fallback(mat, int(r), w)
                            if ofc[r]:
                                tca[:] += ca2
                                tcu[:] += cu2.astype(np.uint64)
                            if ranker is None:
                                continue
                        items = sorted((int(t), float(v))
                                       for t, v in scores.items()
                                       if v > 0.0)
                        fixes[int(r)] = items
                        wmax = max(wmax, len(items))
                    if ranker is not None:
                        if wmax > ht.shape[1]:
                            ht2 = np.zeros((rb, wmax), np.int32)
                            hk2 = np.zeros((rb, wmax), np.float32)
                            ht2[:, :ht.shape[1]] = ht
                            hk2[:, :ht.shape[1]] = hk
                            ht, hk = ht2, hk2
                        for r, items in fixes.items():
                            hc[r] = len(items)
                            for i, (t, v) in enumerate(items):
                                ht[r, i] = t
                                hk[r, i] = v
            if ranker is not None:
                if HIT_SINK is not None:
                    HIT_SINK.append((r0, hc.copy(), ht.copy(), hk.copy()))
                with timers.stage("fast/rank+write"):
                    names = [
                        name_blob[name_off[i]:name_off[i + 1]]
                        .tobytes().decode("latin-1") + " "
                        for i in range(r0, r1)]
                    if segments is None:
                        text, flags = ranker.format_sparse(
                            ht, hk, hc, names, rep_lens[r0:r1], r0)
                        if fh is not None:
                            fh.write(text)
                        if flags is not None:
                            filtered_ids.extend(
                                (r0 + np.nonzero(flags)[0]).tolist())
                    else:
                        # split the batch at file boundaries; read
                        # numbers restart per file
                        for seg in segments:
                            a = max(r0, seg["start"])
                            b = min(r1, seg["end"])
                            if b <= a:
                                continue
                            text, _fl = ranker.format_sparse(
                                ht[a - r0:b - r0], hk[a - r0:b - r0],
                                hc[a - r0:b - r0], names[a - r0:b - r0],
                                rep_lens[a:b], a - seg["start"])
                            if seg["fh"] is not None:
                                seg["fh"].write(text)

    def _writer_loop():
        while True:
            item = work_q.get()
            try:
                if item is None:
                    return
                if not writer_exc:
                    consume(item)
            except BaseException as e:       # surfaced by the producer
                writer_exc.append(e)
            finally:
                work_q.task_done()

    writer_thread = _threading.Thread(target=_writer_loop, daemon=True)
    writer_thread.start()

    def submit(item):
        if writer_exc:
            raise writer_exc[0]
        work_q.put(item)

    # device-resident count accumulators, flushed every COUNT_FLUSH
    # batches so f32 drift stays bounded (host totals are f64)
    acc_ca, acc_cu = disp.new_acc()
    sin_flush = 0

    def flush_counts():
        nonlocal acc_ca, acc_cu, sin_flush
        work_q.join()   # writer owns counts_* until the queue drains
        if writer_exc:
            raise writer_exc[0]
        with timers.stage("fast/fetch-counts"):
            ca_h, cu_h = disp.reduce_acc(acc_ca, acc_cu)
            counts_all[:] += ca_h.astype(np.float64)
            counts_unique[:] += cu_h.astype(np.uint64)
        acc_ca, acc_cu = disp.new_acc()
        sin_flush = 0

    t_start = _time.perf_counter()
    producer_ok = False
    try:
      for r0 in range(0, R_total, rpb):
        r1 = min(r0 + rpb, R_total)
        if cfg.verbose and r0:
            frac = r0 / R_total
            el = _time.perf_counter() - t_start
            print(f"OUT: Progress of current file: {frac * 100.0:.2f} %"
                  f" (ETA: {el / frac - el:.0f}s)", flush=True)
        with timers.stage("fast/assemble"):
            blobs, offs_list, nk = [], [], 0
            line_target = 3 * highest_k if not protein else highest_k
            for mseq, moff in mate_views:
                blens = np.diff(moff[r0:r1 + 1])
                line_target = max(line_target,
                                  int(blens.max()) + asm.marker_len)
                blobs.append(mseq[moff[r0]:moff[r1]])
                offs_list.append((moff[r0:r1 + 1] - moff[r0])
                                 .astype(np.int64))
                nk += int(asm.true_counts(blens).sum())
            if not protein:
                maxlen = _len_bucket(line_target, 3 * highest_k)
            else:
                maxlen = _len_bucket(line_target, highest_k)
            rows_pad = disp.round_rows(_bucket(r1 - r0, 512))
            if len(blobs) == 1:
                mat = asm.assemble(blobs[0], offs_list[0], maxlen,
                                   rows_pad)
            else:
                mat = asm.assemble_multi(blobs, offs_list, maxlen,
                                         rows_pad)
        if sin_flush >= COUNT_FLUSH:
            flush_counts()
        with timers.stage("fast/dispatch"):
            w = asm.window_target(maxlen)
            cap = disp.csr_cap(rows_pad)
            if per_file_counts:
                # identify_multiple with profiles: this batch's reads
                # may span files; the kernel splits its count matrices
                # by file (fused_turbo_files)
                batch_segs = [s for s in segments
                              if s["start"] < r1 and s["end"] > r0]
                Fb = 1
                while Fb < len(batch_segs):
                    Fb <<= 1
                fo = np.zeros(rows_pad, np.int32)
                for i, s in enumerate(batch_segs):
                    fo[max(s["start"], r0) - r0:
                       min(s["end"], r1) - r0] = i
                fo[r1 - r0:] = len(batch_segs) - 1
                packed_d, ht_d, hk_d, ca_d, cu_d = disp.dispatch_files(
                    mat, lut, fo, Fb, rows_pad, protein,
                    cfg.one_frame, lpr, w, cap, cfg.unique)
                extra = (ca_d, cu_d, batch_segs)
            else:
                packed_d, ht_d, hk_d, acc_ca, acc_cu = disp.dispatch(
                    mat, lut, acc_ca, acc_cu, rows_pad, protein,
                    cfg.one_frame, lpr, w, cap, cfg.unique)
                extra = None
            sin_flush += 1
            submit((packed_d, ht_d, hk_d, r0, r1, nk, mat, w,
                    rows_pad, cap, extra))
      flush_counts()
      producer_ok = True
    finally:
        # ALWAYS hand the writer its sentinel and join it -- an error
        # in submit/flush_counts must not leak the daemon thread or
        # the open output handles (ADVICE r4)
        work_q.put(None)
        writer_thread.join()
        if not producer_ok:
            handles = ([seg["fh"] for seg in segments]
                       if segments is not None else [fh])
            for h in handles:
                if h is not None:
                    try:
                        h.close()
                    except OSError:
                        pass
    if writer_exc:
        raise writer_exc[0]
    global LAST_FALLBACK
    LAST_FALLBACK = (fallback_reads, R_total)
    if fallback_reads:
        print(f"OUT: turbo host-fallback recomputed {fallback_reads} of "
              f"{R_total} reads "
              f"({100.0 * fallback_reads / max(R_total, 1):.3f} %)",
              flush=True)

    if segments is not None:
        for seg in segments:
            if seg["fh"] is not None:
                if cfg.output_format == "json":
                    seg["fh"].write(b"\n]")
                seg["fh"].close()
    elif fh is not None:
        if cfg.output_format == "json":
            fh.write(b"\n]")
        fh.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique, None, freqs,
            num_kmers_in_input, R_total, min_k, max_k, cfg.num_frames,
            coverage=False)

    if cfg.filter:
        from .pipeline import write_filtered
        write_filtered(cfg, input_path, filtered_ids)

    if cfg.verbose:
        timers.report()

    return counts_all, counts_unique, R_total, num_kmers_in_input
