"""The identify pipeline: fastq/fasta(.gz) -> per-read output + profile.

Orchestrates (mirroring CompareWithLib_partialSort, Compare.hpp:2733-3766):

  ingest (host)  ->  encode windows (device, core/encode.py)
                 ->  sort by k-mer (device or host-stable)
                 ->  match+score (exact engine match/exact.py for
                     bit-parity with the reference binary, or the fast
                     device engines match/turbo.py, match/join.py)
                 ->  per-read ranking (match/score.py)
                 ->  writers (host/output.py)

Engines:
  * "exact": reproduces the reference's accumulation order bit-for-bit
    (64-bit indices).  Library default; kept for output parity.
  * "tpu": the turbo device kernel; same integer counts, scores up to
    float reordering.  CLI identify default (round 4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..core import kmer
from ..core.encode import Encoder, custom_code_lut
from ..index import artifacts
from ..host import fastx
from ..host import output as out_mod
from ..utils import timers
from . import ingest as ingest_mod
from .engine import TpuEngine
from .exact import exact_identify_batch
from .join import DeviceIndex, match_and_score, sort_queries
from .score import rank_read


@dataclass
class ContentMeta:
    organisms: list     # row -> name (commas removed, Compare.hpp:135)
    idx_to_tax: list    # row -> taxid (int)
    tax_to_idx: dict    # taxid -> row
    num_species: int    # rows including row 0 = non_unique


def load_content_for_identify(path: str) -> ContentMeta:
    """loadContentAndFrequencyFiles content part (Compare.hpp:111-153)."""
    organisms = ["non_unique"]
    idx_to_tax = [0]
    tax_to_idx = {0: 0}
    taxids_as_strings = False
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) >= 5 and not taxids_as_strings:
                taxids_as_strings = True
            if len(parts) < 4:
                raise RuntimeError("Content file contains less than 4 columns")
            organisms.append(parts[0].replace(",", ""))
            tax = int(parts[4]) if taxids_as_strings else int(parts[1])
            idx_to_tax.append(tax)
            tax_to_idx[tax] = len(idx_to_tax) - 1
    return ContentMeta(organisms, idx_to_tax, tax_to_idx, len(idx_to_tax))


def load_frequencies(index_path: str, num_species: int, max_k: int, min_k: int
                     ) -> np.ndarray:
    """_f.txt -> (S, numK) freq matrix, column j -> k = maxK - j
    (Compare.hpp:165-179)."""
    freqs = np.zeros((num_species, max_k - min_k + 1), dtype=np.uint64)
    with open(index_path + "_f.txt") as fh:
        row = 0
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            num_of_k = len(parts) - 1
            for j, i in enumerate(range(max_k, min_k - 1, -1)):
                freqs[row, j] = int(parts[1 + num_of_k - i])
            row += 1
    return freqs


def encode_batch(batch: ingest_mod.ReadBatch, encoder: Encoder, highest_k: int,
                 protein: bool, one_frame: bool, want_positions: bool = False):
    """Device-encode all line buffers -> (query limbs (M,L), read ids (M,))
    [+ (positions (M,), frames (M,)) for --coherence: position = emission
    index within the line (iPositionInString, Read.hpp:84-220), frame =
    0 forward / 1 reverse-complement line]."""
    L = kmer.num_limbs(highest_k)
    empty = (np.zeros((0, L), np.int32), np.zeros(0, np.int32))
    if want_positions:
        empty = empty + (np.zeros(0, np.int32), np.zeros(0, np.int8))
    if not batch.buffers:
        return empty
    buf = np.concatenate(batch.buffers)
    starts = np.cumsum([0] + [len(b) for b in batch.buffers[:-1]])
    if protein:
        windows = np.asarray(encoder.encode_protein_buffer(buf, highest_k))
    else:
        windows = np.asarray(encoder.encode_dna_buffer(buf, highest_k))
    keep_parts, rid_parts, pos_parts, frm_parts = [], [], [], []
    for li, (s, cnt, rid) in enumerate(zip(starts, batch.line_counts,
                                           batch.line_read_ids)):
        if cnt == 0:
            continue
        if one_frame and not protein:
            keep_parts.append(windows[s:s + 3 * cnt:3])
        else:
            keep_parts.append(windows[s:s + cnt])
        rid_parts.append(np.full(cnt, rid, dtype=np.int32))
        if want_positions:
            pos_parts.append(np.arange(cnt, dtype=np.int32))
            frm_parts.append(np.full(cnt, batch.line_frames[li], np.int8))
    if not keep_parts:
        return empty
    out = (np.concatenate(keep_parts), np.concatenate(rid_parts))
    if want_positions:
        out = out + (np.concatenate(pos_parts), np.concatenate(frm_parts))
    return out


def stable_sort_queries(q_limbs: np.ndarray, read_ids: np.ndarray):
    """Host stable sort by k-mer (ties keep input order, which makes the
    reference's std::unique -e semantics reproducible)."""
    L = q_limbs.shape[1]
    order = np.lexsort(tuple(q_limbs[:, i] for i in range(L - 1, -1, -1)))
    return q_limbs[order], read_ids[order]


def unique_consecutive(q_limbs: np.ndarray, read_ids: np.ndarray):
    """-e: std::unique on (kmer, readID) over the sorted batch
    (Compare.hpp:3166-3177) -- consecutive duplicates only."""
    if len(read_ids) == 0:
        return q_limbs, read_ids
    keep = np.ones(len(read_ids), dtype=bool)
    same = np.all(q_limbs[1:] == q_limbs[:-1], axis=1) & (read_ids[1:] == read_ids[:-1])
    keep[1:] = ~same
    return q_limbs[keep], read_ids[keep]


def identify(cfg: Config, index_path: str | None = None,
             input_path: str | None = None, out_file: str | None = None,
             profile_file: str | None = None, engine: str | None = None):
    """Run the classifier over one input file, a directory of files, or
    a paired-end pair (CompareWithLib_partialSort, Compare.hpp:2733).

    engine: "exact" reproduces the reference binary bit-for-bit
    (library default; CLI identify defaults to "tpu"); "tpu" is the
    jit-compiled device kernel -- identical integer counts, scores
    equal up to float accumulation order (and without the reference's
    scoreMatchAVX drop quirk)."""
    engine = engine or getattr(cfg, "engine", None) or "exact"
    index_path = index_path or cfg.index_file or cfg.db_out
    input_path = input_path if input_path is not None else cfg.input
    out_file = out_file if out_file is not None else cfg.read_to_taxa_file
    profile_file = profile_file if profile_file is not None else cfg.table_file

    if input_path and os.path.isdir(input_path):
        # multiple inputs: per-file outputs named <q><name-noext><.end>
        # and <p><name-noext>.csv (Compare.hpp:2918-2928, 3052, 3079).
        # While file i occupies the device, a worker thread pre-parses
        # file i+1 (the reference's many-files-many-cores job shop,
        # main.cpp:1118-1334; here the index tables are shared on
        # device and host parsing is the stage worth overlapping)
        from concurrent.futures import ThreadPoolExecutor
        from .fast import prefetch_parse
        files = fastx.gather_input_files(input_path)
        if (engine == "tpu" and not cfg.filter
                and not cfg.paired_end_1 and not cfg.post_process
                and not cfg.visualize and not cfg.coverage
                and not cfg.sloppy and len(files) > 1
                and not os.environ.get("KASA_NO_MULTIPACK")):
            # packed multi-file fast path: one shared batch stream,
            # per-file output demux (fast.fast_identify_multi); with
            # profiles the kernel splits count matrices per file (r5)
            try:
                return _identify_multi_packed(cfg, index_path, files,
                                              input_path, out_file,
                                              profile_file)
            except Exception as e:
                from .fast import FastPathUnavailable
                if not isinstance(e, FastPathUnavailable):
                    raise
                print(f"OUT: packed multi-file unavailable ({e}); "
                      "running per file", flush=True)
        results = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for i, f in enumerate(files):
                if engine == "tpu" and i + 1 < len(files):
                    try:
                        prefetch_parse(files[i + 1], pool)
                    except Exception:
                        pass
                rel = f[len(input_path):].lstrip("/")
                parts = rel.split(".")
                name = parts[0] if len(parts) == 1 else ".".join(parts[:-1])
                o = out_file + name + out_mod.file_ending(cfg.output_format) \
                    if out_file else None
                p = profile_file + name + ".csv" if profile_file else None
                results.append(identify(cfg, index_path=index_path,
                                        input_path=f, out_file=o,
                                        profile_file=p, engine=engine))
        return results

    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    halved = itype == artifacts.INDEX_TYPE_HALF
    if halved:
        # reconstruct full k-mers from the halved artifact family; the
        # stored taxon values are already dense content rows
        from ..index.shrink import read_halved_reconstructed
        limbs, _keys, tax_rows_direct = read_halved_reconstructed(index_path)
    cfg.highest_k = highest_k
    cfg.clamp_ks()
    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1

    content = load_content_for_identify(cfg.content_file or index_path + "_content.txt")
    freqs = load_frequencies(index_path, content.num_species, max_k, min_k)
    S = content.num_species

    if halved:
        tax_rows = tax_rows_direct
        idx_to_tax_arr = np.asarray(content.idx_to_tax, dtype=np.uint32)
        taxids = idx_to_tax_arr[tax_rows]
    else:
        # vectorized: a python dict comprehension here cost ~39 s of
        # every identify call at 197M entries (profiled r4)
        from .join import map_tax_rows
        tax_rows = map_tax_rows(taxids, content.tax_to_idx) \
            if len(taxids) else np.zeros(0, np.int32)

    protein = cfg.translated

    from .oocore import bytes_per_entry as _bpe
    fits_resident = cfg.ram or (
        _bpe(limbs.shape[1], max_k - min_k + 1) * max(len(taxids), 1)
        <= int(cfg.memory_avail * 0.8))
    if engine == "tpu" \
            and not (cfg.post_process
                     or cfg.sloppy or cfg.visualize
                     or cfg.coverage):
        # halved indices join the fast path through their reconstructed
        # limbs (read_halved_reconstructed above); paired-end rides as
        # two lines per read; over-budget indices stream chunks through
        # the tiered turbo strategy (fast.py/tiered.py), with the
        # classic per-batch oocore loop below as the fallback
        # end-to-end throughput pipeline: native parse, fused
        # encode+classify jit, native rank+format (match/fast.py);
        # falls back to the per-batch engine loop below for workload
        # shapes it does not cover
        from .fast import FastPathUnavailable, fast_identify
        try:
            return fast_identify(cfg, index_path, input_path, out_file,
                                 profile_file, content, freqs, limbs,
                                 taxids, highest_k, tax_rows=tax_rows)
        except FastPathUnavailable as e:
            print(f"OUT: fast path unavailable ({e}); using the per-batch "
                  "tpu engine", flush=True)

    builder = ingest_mod.BatchBuilder(highest_k, min_k, protein=protein,
                                      six_frames=cfg.six_frames,
                                      one_frame=cfg.one_frame)
    encoder = Encoder(codon_code_lut=custom_code_lut(cfg),
                      sloppy=cfg.sloppy, device=(engine == "tpu"))

    # memory-bounded streaming with long-read chunking: single-end input
    # goes through the byte-exact ledger + mid-read chunk machinery
    # (match/chunking.py mirrors readFileAndGenerateInfos +
    # readFastqa_singleEnd, Read.hpp:372-609/1054-1232), so giant
    # contigs are split into ~100MB-of-k-mer chunks with a 3k-1-char
    # overhang and batches may close mid-read; partial scores are
    # carried in saved_scores (vSavedScores, Compare.hpp:2342-2426).
    score_rows = out_file is not None or cfg.filter
    if cfg.paired_end_1:
        max_kmers = max(int(cfg.memory_avail) // 64, 1 << 16)
        batches = ingest_mod.read_paired_batches(
            cfg.paired_end_1, cfg.paired_end_2, builder,
            max_kmers_per_batch=max_kmers)
    else:
        from . import chunking
        entries, _ = artifacts.read_info(index_path)
        soft0 = chunking.identify_soft_budget(
            cfg, index_path, content.organisms, content.idx_to_tax,
            min_k, max_k, itype, entries)
        elem = chunking.input_elem_size(highest_k > 12, cfg.post_process)
        is_fasta = fastx.sniff_format(input_path) == "fasta"
        open_fh = fastx.binary_opener(input_path)
        batches = chunking.chunked_batches(
            open_fh, is_fasta, builder, soft0, S, score_rows,
            cfg.post_process, elem)

    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    counts_total = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    num_reads_sum = 0
    filtered_ids: list = []
    saved_scores = None   # vSavedScores: partial scores of a read split across batches

    writer = None
    fh = None
    if out_file:
        # latin-1: codepoints 0-255 map to raw bytes 1:1 (the kraken
        # unclassified row emits length%256 as a raw byte)
        fh = open(out_file, "w", encoding="latin-1")
        writer = out_mod.ReadResultWriter(fh, cfg.output_format,
                                          num_of_beasts=cfg.num_of_beasts,
                                          coherence=cfg.post_process)

    dev = None
    idx_u64 = None
    if engine == "tpu" and cfg.coverage:
        # counts_total is a per-distinct-group-per-batch statistic the
        # turbo kernel doesn't accumulate; --coverage runs the join
        # engine (device matching + host group expansion,
        # match/join.py match_and_score coverage=True) instead of
        # falling all the way back to the exact numpy walk
        print("OUT: --coverage uses the join engine", flush=True)
        engine = "join"
    if engine == "tpu":
        # -m actually bounds the resident footprint: when the device
        # tables would not fit the budget, classify streams limb0-run-
        # aligned index chunks instead (match/oocore.py); -r forces
        # full residency like the reference's RAM mode
        # (Compare.hpp:182-318)
        from .oocore import TieredIndex, bytes_per_entry
        num_k_ = max_k - min_k + 1
        table_bytes = bytes_per_entry(limbs.shape[1], num_k_) * max(len(taxids), 1)
        budget = int(cfg.memory_avail * 0.8)
        if (not cfg.ram and table_bytes > budget
                and itype == artifacts.INDEX_TYPE_64 and min_k >= 6):
            chunk_entries = max(budget // bytes_per_entry(limbs.shape[1],
                                                          num_k_), 1 << 16)
            print(f"OUT: index tables ({table_bytes >> 20} MiB) exceed the "
                  f"memory budget; streaming {chunk_entries}-entry chunks",
                  flush=True)
            dev = TieredIndex(index_path, content.tax_to_idx, min_k, max_k,
                              S, chunk_entries,
                              cache_dir=(os.path.join(cfg.temp_path,
                                         f"oocache_{cfg.call_idx}")
                                         if cfg.temp_path else None))
        else:
            dev = TpuEngine(limbs, taxids, content.tax_to_idx, highest_k,
                            min_k, max_k, S)
    elif engine == "join":
        # legacy host-expansion device path (kept for comparison)
        dev = DeviceIndex(limbs, taxids, content.tax_to_idx, highest_k,
                          min_k, max_k, S)
    if engine != "tpu" and highest_k <= 12:
        idx_u64 = kmer.limbs_to_u64(limbs)

    for batch in batches:
        with timers.stage("identify/encode"):
            enc = encode_batch(batch, encoder, highest_k, protein,
                               cfg.one_frame, want_positions=cfg.post_process)
            q_limbs, read_ids = enc[0], enc[1]
        num_kmers_in_input += batch.num_kmers
        R = batch.num_reads

        coh = None
        if cfg.post_process:
            # --coherence: per-k-mer max matched k -> overlap-cluster
            # scores (postProcess, Compare.hpp:2607-2728); computed on
            # the unsorted batch, whose order is (readID, frame-line,
            # position) already
            from .coherence import coherence_scores, max_match_lengths
            if highest_k > 12:
                raise RuntimeError("--coherence supports 64-bit indices only")
            mlens = max_match_lengths(idx_u64 if idx_u64 is not None
                                      else kmer.limbs_to_u64(limbs),
                                      kmer.limbs_to_u64(q_limbs),
                                      min_k, max_k, highest_k)
            coh = coherence_scores(read_ids, enc[3], enc[2], mlens, R,
                                   cfg.six_frames)

        if engine == "tpu":
            with timers.stage("identify/match"):
                res = dev.classify(q_limbs, read_ids, R, unique=cfg.unique,
                                   want_scores=score_rows)
            scores = res.scores
        elif engine == "join":
            with timers.stage("identify/match"):
                res = match_and_score(dev, q_limbs, read_ids, R,
                                      unique=cfg.unique, coverage=cfg.coverage,
                                      want_scores=score_rows)
            scores = res.scores
        else:
          with timers.stage("identify/match"):
            q_limbs, read_ids = stable_sort_queries(q_limbs, read_ids)
            if cfg.unique:
                q_limbs, read_ids = unique_consecutive(q_limbs, read_ids)
            if highest_k <= 12:
                res = exact_identify_batch(
                    idx_u64, tax_rows, kmer.limbs_to_u64(q_limbs), read_ids,
                    min_k, max_k, highest_k, R, S,
                    coverage=cfg.coverage, want_scores=score_rows)
            else:
                # 128-bit compat engine: faithful walk emulation incl.
                # the reference's uint64-truncated comparator
                from .walk128 import walk_identify_128
                ih, il = kmer.limbs_to_u128_parts(limbs)
                qh, ql = kmer.limbs_to_u128_parts(q_limbs)
                ikeys = [(int(h) << 64) | int(l) for h, l in zip(ih, il)]
                qkeys = [(int(h) << 64) | int(l) for h, l in zip(qh, ql)]
                res = walk_identify_128(
                    ikeys, tax_rows, qkeys, read_ids,
                    min_k, max_k, highest_k, R, S,
                    coverage=cfg.coverage, want_scores=score_rows)
            scores = res.scores

        counts_all += res.counts_all
        counts_unique += res.counts_unique
        counts_total += res.counts_total

        if cfg.visualize:
            # debug aid (Compare.hpp:3330-3386): frame strings and the
            # faithful walk's _matchedkMers accumulate across batches
            # (the reference never clears either)
            from . import visualize as vis_mod
            from .walk128 import walk_identify_128
            if "_vis_frames" not in locals():
                _vis_frames, _vis_matched = [], []
            from ..core.alphabet import build_codon_lut
            lut = build_codon_lut()
            if cfg.codon_table:
                from ..core.alphabet import apply_custom_codon_table
                lut = apply_custom_codon_table(lut, cfg.codon_table,
                                               cfg.codon_id)
            vis_mod.frame_strings(batch, highest_k, lut, _vis_frames,
                                  protein=protein)
            if engine in ("tpu", "join"):
                vq, vr = stable_sort_queries(q_limbs, read_ids)
            else:
                vq, vr = q_limbs, read_ids  # already sorted (and -e deduped)
            if highest_k <= 12:
                ikeys = kmer.limbs_to_u64(limbs).tolist()
                qkeys = kmer.limbs_to_u64(vq).tolist()
            else:
                ih, il = kmer.limbs_to_u128_parts(limbs)
                qh, ql = kmer.limbs_to_u128_parts(vq)
                ikeys = [(int(h) << 64) | int(l) for h, l in zip(ih, il)]
                qkeys = [(int(h) << 64) | int(l) for h, l in zip(qh, ql)]
            walk_identify_128(ikeys, tax_rows, qkeys, vr, min_k, max_k,
                              highest_k, R, S, want_scores=False,
                              vis=_vis_matched,
                              idx_raw_tax=np.asarray(taxids))
            vis_mod.print_visualization(_vis_frames, _vis_matched)

        completed = R - 1 if batch.add_tail else R
        if score_rows:
          with timers.stage("identify/score+output"):
            def emit(readnum, name, length, score_row, coh_val):
                hits = rank_read(score_row, length, freqs[:, 0],
                                 min_k, max_k, highest_k, protein,
                                 cfg.num_frames, cfg.threshold,
                                 cfg.num_of_beasts)
                if writer is not None:
                    writer.write_read(readnum, name, length, hits,
                                      content.idx_to_tax, content.organisms,
                                      coherence_val=coh_val)
                # --filter: a read matching the index well is flagged as
                # contaminated (Compare.hpp:1597-1608, double arithmetic);
                # with --coherence a high coherence also flags it
                if cfg.filter and hits.spec_idx:
                    best = hits.best_score
                    max_score = max(hits.kmer_scores)
                    if (float(best) - float(max_score)) / float(best) \
                            < cfg.error_threshold:
                        filtered_ids.append(readnum)
                    elif coh is not None and \
                            float(coh_val) >= cfg.coherence_threshold:
                        filtered_ids.append(readnum)

            # saveResults (Compare.hpp:2324-2446): if the read continued
            # from the previous batch just finished and had saved partial
            # scores, row 0 merges with them (one float32 add per
            # species) and is emitted first
            row0 = 0
            if saved_scores is not None and batch.finished:
                merged = saved_scores + np.asarray(scores[0], np.float32)
                emit(num_reads_sum, batch.names[0], batch.lengths[0],
                     merged, (float(coh[0]) if coh is not None else 0.0))
                saved_scores = None
                row0 = 1
            for r in range(row0, completed):
                emit(num_reads_sum + r, batch.names[r], batch.lengths[r],
                     scores[r],
                     (float(coh[r]) if coh is not None else 0.0))
            if batch.add_tail:
                # park the unfinished last row's scores for the next batch
                tail = np.asarray(scores[R - 1], np.float32)
                if (tail[1:] > 0.0).any():
                    saved_scores = tail.copy() if saved_scores is None \
                        else saved_scores + tail
        num_reads_sum += completed

    if writer is not None:
        writer.close()
        fh.close()

    if profile_file:
        out_mod.write_profile(
            profile_file, content.organisms, content.idx_to_tax,
            counts_all, counts_unique,
            counts_total if cfg.coverage else None,
            freqs, num_kmers_in_input, num_reads_sum,
            min_k, max_k, cfg.num_frames, coverage=cfg.coverage)

    if cfg.filter:
        write_filtered(cfg, input_path, filtered_ids)

    if cfg.verbose:
        timers.report()

    return counts_all, counts_unique, num_reads_sum, num_kmers_in_input


def write_filtered(cfg: Config, input_path: str, filtered_ids: list):
    """--filter second pass (Compare.hpp:2448-2604): split the input
    into clean / contaminated files, paired-end aware, optional .gz."""
    import gzip as gzip_mod

    paired = bool(cfg.paired_end_1)
    paths = [cfg.paired_end_1, cfg.paired_end_2] if paired else [input_path]
    fmt = fastx.sniff_format(paths[0])
    ending = ".fasta" if fmt == "fasta" else ".fastq"
    gz = ".gz" if cfg.gzip_out else ""
    doomed = set(filtered_ids)

    def openw(path):
        if cfg.gzip_out:
            return gzip_mod.open(path, "wt")
        return open(path, "w")

    outs = {}
    for tag, base in (("clean", cfg.filtered_clean_out),
                      ("cont", cfg.filtered_contaminants_out)):
        if base == "_":
            continue
        if paired:
            outs[tag] = [openw(base + "_1" + ending + gz),
                         openw(base + "_2" + ending + gz)]
        else:
            outs[tag] = [openw(base + ending + gz)]

    iters = [fastx.iter_raw_records(p, fmt) for p in paths]
    rid = 0
    for blocks in zip(*iters):
        tag = "cont" if rid in doomed else "clean"
        rid += 1
        if tag not in outs:
            continue
        for fh, block in zip(outs[tag], blocks):
            for line in block:
                fh.write(line + "\n")
    for fhs in outs.values():
        for fh in fhs:
            fh.close()




def _identify_multi_packed(cfg, index_path, files, input_path, out_file,
                           profile_file=None):
    """Directory identify as ONE packed read stream (fast.py
    fast_identify_multi); output naming matches the per-file loop."""
    from .fast import fast_identify_multi
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    if itype == artifacts.INDEX_TYPE_HALF:
        from ..index.shrink import read_halved_reconstructed
        limbs, _keys, tax_rows_direct = read_halved_reconstructed(index_path)
    cfg.highest_k = highest_k
    cfg.clamp_ks()
    content = load_content_for_identify(
        cfg.content_file or index_path + "_content.txt")
    freqs = load_frequencies(index_path, content.num_species,
                             cfg.higher_k, cfg.lower_k)
    if itype == artifacts.INDEX_TYPE_HALF:
        taxids = np.array([content.idx_to_tax[r] for r in tax_rows_direct],
                          dtype=np.uint32)
    outs, profs = [], []
    for f in files:
        rel = f[len(input_path):].lstrip("/")
        parts = rel.split(".")
        name = parts[0] if len(parts) == 1 else ".".join(parts[:-1])
        outs.append(out_file + name + out_mod.file_ending(cfg.output_format)
                    if out_file else None)
        profs.append(profile_file + name + ".csv" if profile_file else None)
    return fast_identify_multi(cfg, index_path, files, outs, content,
                               freqs, limbs, taxids, highest_k,
                               profile_files=(profs if profile_file
                                              else None))


def identify_multiple(cfg: Config, engine: str | None = None):
    """identify_multiple mode (main.cpp:1118-1334): classify every file
    in a folder against one loaded index.  The reference parallelizes
    with a many-files-many-cores job shop; outputs are identical to
    running identify per file, which is what we do (one file's batches
    already keep the device busy)."""
    if not os.path.isdir(cfg.input):
        raise RuntimeError("identify_multiple requires a folder with multiple "
                           "files in it!")
    files = fastx.gather_input_files(cfg.input)
    if len(files) < 2:
        raise RuntimeError("identify_multiple requires a folder with at least "
                           "2 files in it!")
    return identify(cfg, engine=engine)
