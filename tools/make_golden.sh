#!/bin/bash
# Generate golden outputs from the reference kASA binary (prebuilt
# binaries/kASA_linux from the reference repo, copied to .golden_kASA).
# These are the parity targets for this framework's tests.
set -e
cd "$(dirname "$0")/.."
BIN=./.golden_kASA
TAX=/root/reference/example/taxonomy
G=${GOLDEN_DIR:-tests/golden}
TMP=${KASA_TMP:-/tmp/kasa_tmp}
mkdir -p $G $TMP

run() { "$BIN" "$@" > /dev/null 2>&1; }

# content file + index
run generateCF -c $G/exampleIndex_content.txt -i fixtures/example.fasta \
    -f $TAX/acc2tax/acc2Tax.txt -y $TAX/ -u species -n 1 -m 2 -t $TMP/ -x 1
run build -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/example.fasta \
    -n 1 -m 2 -t $TMP/ -x 2

# second index (for update/merge)
run generateCF -c $G/index2_content.txt -i fixtures/example2.fasta \
    -f $TAX/acc2tax/acc2Tax.txt -y $TAX/ -u species -n 1 -m 2 -t $TMP/ -x 11
run build -c $G/index2_content.txt -d $G/index2 -i fixtures/example2.fasta \
    -n 1 -m 2 -t $TMP/ -x 12

# identify: default k [7,12], json + profile
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_identify.json -p $G/reads_profile.csv -n 1 -m 2 -t $TMP/ -x 3
# tsv + jsonl + kraken
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_identify.tsv -p $G/reads_profile_tsv.csv --tsv -n 1 -m 2 -t $TMP/ -x 4
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_identify.jsonl --jsonl -n 1 -m 2 -t $TMP/ -x 5
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_identify.ktsv --kraken -n 1 -m 2 -t $TMP/ -x 6
# single k
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_k12.json -p $G/reads_k12_profile.csv -k 12 12 -n 1 -m 2 -t $TMP/ -x 7
# six frames
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_six.json -p $G/reads_six_profile.csv --six -n 1 -m 2 -t $TMP/ -x 8
# one frame
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_one.json -p $G/reads_one_profile.csv --one -n 1 -m 2 -t $TMP/ -x 9
# unique (-e)
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_unique.json -p $G/reads_unique_profile.csv -e -n 1 -m 2 -t $TMP/ -x 10
# fasta input
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fasta \
    -q $G/reads_fasta.json -p $G/reads_fasta_profile.csv -n 1 -m 2 -t $TMP/ -x 13
# gzipped input
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq.gz \
    -q $G/reads_gz.json -n 1 -m 2 -t $TMP/ -x 14
# paired-end
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex \
    -1 fixtures/reads_1.fastq -2 fixtures/reads_2.fastq \
    -q $G/reads_paired.json -p $G/reads_paired_profile.csv -n 1 -m 2 -t $TMP/ -x 15
# edge cases (tiny/multiline/N reads)
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/edge.fasta \
    -q $G/edge.json -p $G/edge_profile.csv -n 1 -m 2 -t $TMP/ -x 16
# coverage
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_cov.json -p $G/reads_cov_profile.csv --coverage -n 1 -m 2 -t $TMP/ -x 17
# translate mode
run translate -i fixtures/reads.fastq -o $G/reads_translated.fastq -n 1 -m 2 -t $TMP/ -x 18

echo "golden outputs in $G:"
ls $G

# dev modes: transform (CSR re-encoding) + fuckit (spaced-seed re-encoding)
run transform -d $G/exampleIndex -o $G/transformed -n 1 -m 2 -t $TMP/ -x 30
run fuckit -c $G/exampleIndex_content.txt -d $G/exampleIndex -o $G/fuckedIndex \
    -n 1 -m 2 -t $TMP/fk -x 31

# --visualize debug output (stdout minus OUT: lines), single read
head -4 fixtures/reads.fastq > fixtures/one_read.fastq
"$BIN" identify -c $G/exampleIndex_content.txt -d $G/exampleIndex \
    -i fixtures/one_read.fastq -q /dev/null --visualize -n 1 -m 2 -t $TMP/ -x 32 \
    2>/dev/null | grep -v "^OUT:" > $G/visualize_one_read.txt

# ---- 128-bit (k <= 25) build + identify
run build -c $G/exampleIndex_content.txt -d $G/exampleIndex128 -i fixtures/example.fasta \
    --kH 25 -n 1 -m 2 -t $TMP/ -x 33
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex128 -i fixtures/reads.fastq \
    -q $G/reads_128.json -p $G/reads_128_profile.csv -k 25 12 -n 1 -m 2 -t $TMP/ -x 34

# ---- protein (pre-translated, -z) content + build + identify
run generateCF -c $G/protIndex_content.txt -i fixtures/protein.fasta \
    -f $TAX/acc2tax/acc2Tax.txt -y $TAX/ -u species -n 1 -m 2 -t $TMP/ -x 35
run build -c $G/protIndex_content.txt -d $G/protIndex -i fixtures/protein.fasta \
    -z -n 1 -m 2 -t $TMP/ -x 36
run identify -c $G/protIndex_content.txt -d $G/protIndex -i fixtures/protein_reads.fasta \
    -z -q $G/prot_reads.json -p $G/prot_reads_profile.csv -n 1 -m 2 -t $TMP/ -x 37

# ---- sloppy build (-j): index (= copied _taxOnly), trie, _taxOnly.
# The frequency stage afterwards reads the replaced (u16) index as
# 12-byte pairs and dies -- sloppy identify is dead code in the
# reference too (Compare.hpp:3224-3246 commented out), so only the
# build artifacts are parity targets.
run build -c $G/exampleIndex_content.txt -d $G/exampleIndexSloppy -i fixtures/example.fasta \
    -j -n 1 -m 2 -t $TMP/ -x 38 || true
rm -f $G/exampleIndexSloppy_f.txt

# ---- shrink strategies 1 (EveryNth), 2 (TrieHalf), 3 (Entropy)
run shrink -s 2 -d $G/exampleIndex -o $G/exampleIndex_s \
    -c $G/exampleIndex_content.txt -n 1 -m 2 -t $TMP/ -x 39
run shrink -s 1 -g 50 -d $G/exampleIndex -o $G/exampleIndex_g50 \
    -c $G/exampleIndex_content.txt -n 1 -m 2 -t $TMP/ -x 40
run shrink -s 3 -d $G/exampleIndex -o $G/exampleIndex_ent \
    -c $G/exampleIndex_content.txt -n 1 -m 2 -t $TMP/ -x 41
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex_s -i fixtures/reads.fastq \
    -q $G/reads_half.json -p $G/reads_half_profile.csv -n 1 -m 2 -t $TMP/ -x 42

# ---- update / delete / merge
run update -d $G/exampleIndex -o $G/exampleIndex_u -i fixtures/example2.fasta \
    -f $TAX/acc2tax/acc2Tax.txt -y $TAX/ -u species -n 1 -m 2 -t $TMP/ -x 43
run delete -d $G/exampleIndex -o $G/exampleIndex_del -l $G/delnodes_test.dmp \
    -c $G/exampleIndex_content.txt -n 1 -m 2 -t $TMP/ -x 44
run merge --firstIndex $G/exampleIndex --secondIndex $G/index2 -o $G/index_merged \
    -c1 $G/exampleIndex_content.txt -c2 $G/index2_content.txt -n 1 -m 2 -t $TMP/ -x 45

# ---- coherence post-processing
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_coh.json -p $G/reads_coh_profile.csv --coherence -n 1 -m 2 -t $TMP/ -x 46

# ---- filtering (single + paired end)
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/reads.fastq \
    -q $G/reads_filt.json --filter $G/filt_clean $G/filt_cont -n 1 -m 2 -t $TMP/ -x 47
run identify -c $G/exampleIndex_content.txt -d $G/exampleIndex \
    -1 fixtures/reads_1.fastq -2 fixtures/reads_2.fastq \
    -q $G/readsp_filt.json --filter $G/filtp_clean $G/filtp_cont -n 1 -m 2 -t $TMP/ -x 48

# ---- identify_multiple over a folder (a.fastq = reads.fastq, b.fasta = edge.fasta)
mkdir -p fixtures/multi
cp fixtures/reads.fastq fixtures/multi/a.fastq
cp fixtures/edge.fasta fixtures/multi/b.fasta
# -n 2 -m 5: two files x one thread each (deterministic float order);
# -m 4 would trip the 2GB-per-task floor (main.cpp:1281-1290), collapse
# to one task and hand the big file 2 threads, reordering score adds
run identify_multiple -c $G/exampleIndex_content.txt -d $G/exampleIndex -i fixtures/multi/ \
    -q $G/multi_q_ -p $G/multi_p_ -n 2 -m 5 -t $TMP/ -x 49

# ---- custom alphabet (-a <gc.prt> <id>) build + identify
run build -c $G/exampleIndex_content.txt -d $G/alphaIndex -i fixtures/example.fasta \
    -a /root/reference/example/work/table.prt 1 -n 1 -m 2 -t $TMP/ -x 50
run identify -c $G/exampleIndex_content.txt -d $G/alphaIndex -i fixtures/reads.fastq \
    -a /root/reference/example/work/table.prt 1 \
    -q $G/reads_alpha.json -p $G/reads_alpha_profile.csv -n 1 -m 2 -t $TMP/ -x 51
