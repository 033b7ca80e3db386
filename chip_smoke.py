#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mmseqs2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Every phase raises on failure; nothing is
caught. Phases, each printing lines before the last:
  1. card: name and power limit (nvidia-smi);
  2. build: compile every CUDA kernel of the port, one nvcc per source of
     KERNEL_SOURCES, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes its stage launches, exact integer equality required; times
     from CUDA events (the kernels' the median of several calls, the plain
     versions' one call after the call that is compared), cells per second
     over the cells the inputs
     need, and the card's bound for those cells. sw_multi at the align
     stage's shapes, diag_rescore at the prefilter's (2^10 to 2^17
     candidates, windows of real protein lengths, edge cases, a flush's
     2^17 candidates in 2^21 slots, stale candidates past the valid count,
     a moved target store, the path's 17,408 candidates in 2^21 slots; each
     without and with the valid count), the gapless scan (gapless,
     gapless_score) and the single-profile SW entry points
     (sw_single, sw_offset, sw_score) at the shapes the exhaustive
     prefilter launches (one profile, Lq 128 to 4,096, Lt buckets 256 to
     2,048, 1,024 to 16,384 lanes, small and large bias, a case that
     saturates at the cap, all-negative, cheap gaps); every case passes
     the real query and target lengths as its caller does (sw_multi's:
     the forward pass's q_lens, the reverse pass's offsets, the longest
     window and the profiles' maximum), and one shape of each kernel runs
     again in the int32 form and with the lengths off (sw_multi: the Lq
     512 forward and reverse shapes; and the strip-mined SW shape in the
     int32 form); sw_score must equal sw_single's score; each row gives the
     form and the cells needed, padded and computed. Profile queries:
     sw_multi with the golden it_profile_0's PSSM profiles (Lq 512, 1,024
     and 2,048, both passes, the Lq 512 shapes also in the int32 form), and
     diag_rescore_profile (the profile form of the rescore) at the profile
     prefilter's shapes (2^10 to 2^17 candidates, a flush's 2^21 slots,
     edge diagonals, all-negative, stale candidates past the count, a moved
     store, windows at both ends of the store, slots in no order of query;
     then slots sorted by (query, target) as the path has them: 2^17, a
     flush's 2^21 slots, queries of 2,400 positions; each without and with
     the count), its rows made from it_profile_0; and posting_expand (B6,
     the posting expansion of the device candidate stage) at the flush
     shapes (128 queries, 2^10 to 2^21 expansions into entries of a
     real-size index's length, zero-count and pad triples, lists at both
     ends of the entries, 2^17 pad slots, a list longer than a tile and a
     run of 3,000 zero-count triples, 2^21 expansions into an index that
     fits the L2, and a real flush of 128 toy queries on the toy DB's
     index), with GB/s and its share of the byte bound; and fwbw (B5, the
     forward-backward alignment) at phase 14's commonest lengths (512
     pairs of 250-350 residues), at 512 x 512, on a ragged batch with
     1 x 700 and 700 x 1 edges and at the edge of its warp and block
     forms (256 pairs of 512 and 513 residues), each with the forms its
     pairs took: P within rtol 1e-4, atol
     1e-7 of the plain version's, the kernel's MAC fed the plain P equal
     to the plain MAC bit for bit, and end to end each pair's first
     maximum and cigar equal but where the two alignments tie under the
     plain P (phase 14's rule; printed), against its bound (f32
     operations);
  4. golden parity: the port's `align` on the 500-query toy set equals the
     reference MMseqs2 goldens (tests/golden/toy, tests/golden/alt): default
     and non-default scoring, --alt-ali, --corr-score-weight (--realign is
     the iterative search's first align, below);
     the port's `prefilter` of the toy set against itself equals the golden
     at the default sensitivity on all 500 queries (at -s 5.7: the
     iterative search's first prefilter, below), and
     `easy-search QUERY.fasta QUERY.fasta` equals golden_self.m8;
     `ungappedprefilter` of the toy set against itself equals the golden
     `upref` on all 500 queries, `makepaddedseqdb` the golden padded DB
     byte for byte; with a `gpuserver` (a subprocess) on that padded DB,
     `ungappedprefilter --gpu 1` and `gappedprefilter --gpu 1` give the
     bytes of the runs without a server, and the server launched both
     score-only kernels (gapless_score, sw_score); `search --prefilter-mode
     1` runs on the first 100 queries (a cut for time) and its first
     queries' entries equal a run with the CPU requested (beside phases
     3-4);
     clustering: `clust` (3 modes), `rescorediagonal` (3 modes),
     `kmermatcher` (v1 and three v2 flag sets), `linclust` and `cluster`
     with --linclust-version 1 equal their goldens (clu*, resc*, kmpref,
     km_*, linclu, casclu), and `prefilter` of the toy set against a
     `createindex` index equals the run without one. The profile search:
     `result2profile` (profdb), `search qdb qdb --num-iterations 2` with
     each step's output against its golden (it_pref_0, it_aln_0,
     it_profile_0, it_pref_tmp_1, it_pref_1, it_aln_tmp_1) and its result
     against italn, byte for byte (the third iteration, italn3, was cut
     for time: its new step, result2profile of profile queries, launches
     no kernel); `search`
     against profile targets (tprofile/refout) and `search
     --exhaustive-search` (sliced/refout, refout2); `search
     --num-iterations 2` of the toy's first 25 queries against its first
     250 equal on the card and the CPU, byte for byte. Nucleotide DBs
     (tests/golden/nucl): `search ndb ndb --search-type 3` (blastn: the
     host prefilter of exact 15-mers and the banded ksw2 aligner) equals
     `naln` and `--search-type 2` (translated: extractorfs, the prefilter
     and align over the ORFs on the card, offsetalignment) equals `taln`,
     entry by entry; the translated search launches diag_rescore and
     sw_multi, the nucleotide one neither. The MSA path: the MSA
     and profile tools against the goldens of the JAX package's tests
     (result2msa refmsa and refa3m, msa2profile refm2p and refm2p1,
     profile2pssm, profile2consensus, profile2repseq, expandaln exp_aln,
     exp_aln_rescore and efc, expand2profile exp_prof, filtera3m,
     msa2result, result2msa --allow-deletion, convertca3m, profile2neff,
     convertmsa, convertprofiledb, tsv2exprofiledb), each on its whole toy
     input in a subprocess with the card selected (host code: they launch
     nothing); and on the card `result2msa` of the toy's alignments with
     their backtraces stripped (the realignment through sw_multi) and
     `enrich` of three toy queries (one iteration), both equal byte for
     byte to a CPU run beside them (these sides start with phase 3).
     `fwbw` of tests/golden/fwbw/alnsub against reffw (integer fields,
     cigar and seq-id exact, the MAC score within 3) and every field
     against a CPU run; the alignx goldens (`alignall` through sw_multi
     on the card; `transitivealign` and `alignbykmer` of amino acids and
     nucleotides, host code) and the five `pairaln` goldens, byte for
     byte, in a subprocess with the card selected, as the MSA goldens;
     the exhaustive prefilter's nucleotide branches on
     tests/golden/nucl/ndb (4 of its queries ungapped against it, 2 toy
     queries gapped against it, makepaddedseqdb of it, and a gpuserver on
     that padded DB whose --gpu 1 run equals the run without a server) in
     a subprocess on the card (these start after phase 3), equal to a CPU
     run (started with phase 3). The
     CPU sides of
     phases 6, 7, 8 (started with phase 3), 9, 11, 12 and 13 run in
     subprocesses
     at the lowest priority (nice 19: the card's runs keep the host's
     cores) during this phase, which is correctness only: none of its
     seconds is
     a metric, and the phase ends by waiting for them, so that nothing
     measured after it runs beside them
     (the data of phases 6, 7 and 9, phase 5's, are made at its start
     from a copy of the generator as phase 5 finds it);
  5. real size, align only: `createdb` + `align -a` on N_TARGETS
     SwissProt-like targets and 1,000 queries with 300 synthetic prefilter
     candidates each (300,000 pairs), data made from a seed; launch counts
     (by form: each int32 launch names the bound that ruled out int16) and
     the cells the kernel computed against those needed, taken over this
     run; the first 16 queries' results equal a run with the CPU requested
     (plain versions);
  6. real size, the main path: `easy-search` of the same 1,000 queries
     against the same targets, from the FASTA files through createdb,
     prefilter, align and convertalis, no synthetic prefilter DB; every
     kernel's launch count is set to 0 just before and read just after;
     wall time, queries/s, the split of the wall, the queries that took the
     host-oracle route (and no posting_expand launch: up to 2^22 targets
     the postings expand on the host), the hits, sw_multi's launches by form and its
     computed cells against those needed; the first 32 queries' lines equal
     phase 4's run of them with the CPU requested. Beside the main path,
     not in its place: `createindex -s 5.7` of the target DB and
     easy-search against it, as bench.py does (the index build's seconds
     beside the wall, hit lines equal to the run without the index), then
     its prefilter step once more under torch.profiler (the main path's
     flushes: the same queries and index), with diag_rescore's launches
     and device time from the trace and, recorded in that run, their
     slots, valid counts and the distribution of their window lengths.
     (Phase 4's prefilter
     runs also show that a flush is dispatched with no synchronisation:
     PyTorch's sync debug mode raises on one);
  7. real size, the exhaustive prefilter: `ungappedprefilter` of the 1,000
     queries against the same targets (--max-seqs 300), counts set to 0
     just before and read just after: wall, queries/s, cells/s end to end,
     the split of the wall (upload, kernels by CUDA events, waiting for
     read-backs, host filter and write), launches (by kernel form) and
     read-backs per query, cells needed, padded and computed;
     the first 32 queries held against phase 4's run with the CPU requested
     on the first 500 targets (a cut for time: every hit of the card's run on
     those targets must be the CPU's, and every CPU hit that ranks inside
     the card's list must be in it); once more under torch.profiler for the
     busy and idle shares; then the same through a resident `gpuserver` on
     the padded target DB (start-up apart; the first 100 queries equal to a
     local run on that DB), and `gappedprefilter` of the 1,000 queries
     (wall, kernels, launches by form, cells needed and computed; once
     more under torch.profiler), no gapped hit below its gapless score,
     and a sub-DB run equal on the card and the CPU (phase 4's run); then
     both commands on the first 100 queries with the target store's
     budget forced to an eighth of the store, so that the targets go up in
     chunks: chunks, bytes and seconds of the uploads, and every entry
     equal to the resident runs';
  8. clustering at real size, on phase 5's targets: `easy-linclust` of the
     first 6,000 with the defaults, and `easy-cluster` of the first 2,000
     (cuts for time) at MMseqs2's README parameters (--min-seq-id 0.5 -c 0.8
     --cov-mode 1), every kernel's count set to 0 just before each and read
     just after: wall, sequences/s, clusters, the wall by step,
     align2clust's gapped calls with their sw_multi launches (by form) and
     read-backs, and each round's prefilter route (card or host), index
     seconds and launches; each output a full assignment; then both
     commands on a check set made from its own generator, 1,000 sequences
     of the same recipe (a cut for time) and 100 planted near-duplicates
     of them (2% substitutions, two thirds of them with one indel of 1-3
     letters, so that align2clust accepts pairs through its gapped
     fallback and through its ungapped rescore, both checked), whose
     three files equal
     those of the CPU subprocess started with phase 3; the card's
     easy-cluster of the check set runs under torch.profiler;
  9. the iterative profile search at real size: `search --num-iterations
     2` of the first 100 of phase 5's 1,000 queries (cuts for time: the
     index builds do not shrink with the queries; a third iteration, a
     second profile round, was cut) against its 50,000 targets (phase 5's target DB with phase 6's `createindex
     -s 5.7` index: iteration 0's prefilter loads it, iteration 1's
     profile prefilter builds its own, as no sequence index serves profile
     queries; a cut for time), every kernel's count set to 0 just
     before and read just after: wall, queries/s, and per iteration the
     hits, the prefilter's seconds (index build, the profile k-mer
     enumeration, dispatch, wait), flushes, diag_rescore launches by form,
     profile bytes uploaded and host-oracle queries, align's seconds with
     sw_multi's launches by form (each int32 launch with the bound that
     ruled out int16) and read-backs, and result2profile's, subtractdbs'
     and mergedbs' seconds; iteration 1's profile-query prefilter and
     align under torch.profiler in that run (their seconds include what
     tracing costs); the first 16 queries' entries equal phase 4's CPU
     subprocess's (by query name);
 10. large target DBs: one real flush of 128 queries on phase 6's index
     through the route past the packed key (the postings expand on the
     card) gives the packed route's hits, posting_expand held against its
     plain version on it; then `prefilter` of the 1,000 queries against
     the 50,000 targets with a --split-memory-limit under which the
     automatic split count is 3, whose entries must be phase 6's unsplit
     prefilter's: the wall, each split's index build and candidate stage,
     stage-0, the merge, the bytes spilled, posting_expand's and
     diag_rescore's launches, and from a trace of the run (the card's
     activity only) the card's busy share and posting_expand's device
     time;
 11. translated search at real size (blastx-style): `easy-search` of the
     first 250 of phase 5's protein queries (a cut for time) back-translated
     into DNA
     (synonymous codons drawn from the seed, a stop codon after each, random
     flanks of 0-150 nt, every second query reverse-complemented) against
     phase 6's target DB with its `createindex -s 5.7` index in place
     (nothing rebuilt), every kernel's count set to 0 just before and read
     just after: wall, DNA queries/s, the ORFs extracted, the seconds of
     extractorfs, prefilter, align, offsetalignment and convertalis, the
     launches of diag_rescore and sw_multi and their device time; the share
     of the queries whose best target is phase 6's for the protein query;
     the first 32 queries' lines equal to phase 4's CPU side's, by name;
 12. taxonomy at real size: `createtaxdb` of phase 6's target DB with a
     synthetic NCBI taxonomy from the seed (write_taxonomy: a species a
     planted family, about four taxa to each parent up to two
     superkingdoms, every 20th target unmapped), then `easy-taxonomy -s
     5.7` of the first 500 of phase 5's queries (cut from 1,000 for
     time) against it with phase 6's
     `createindex` index in place (a rebuild raises) and the taxonomy's
     other defaults (--lca-mode 3: lcaalign's three waves on the card),
     every kernel's count set to 0 just before and read just after: wall,
     queries/s, step seconds, the prefilter's and lcaalign's launches and
     read-backs, lcaalign's pairs by wave, the assignments by rank and
     against the planted species; the first 32 queries' _lca.tsv and
     _tophit_aln lines equal to phase 4's CPU side's, by name;
 13. the MSA path at real size (phase_msa): `result2msa` of the first 250
     queries of phase 5's prefilter lists (300 candidates a query, no
     backtraces: 75,000 pairs aligned again through sw_multi, a block of
     256 queries an align_batch), `msa2profile` of the first 16 of those
     MSAs (a cut for time), `sequence2profile --context-lib` of the 250
     queries with a 4,000-context library from the seed (B9, the context
     product, torch.matmul on the card) and `result2profile` of the first
     query's list (the align_query caller, reported), every kernel's
     count set to 0 just before each: seconds, pairs, sw_multi launches
     by form, read-backs, B1's and B9's device seconds (CUDA events), the
     busy share; B9 timed at the path's padded length against its f32
     bound; the first 16 queries' MSA and profile entries equal to phase
     4's CPU side's, B9's probabilities to the CPU's within rtol 1e-5,
     atol 1e-6;
 14. fwbw at real size (phase_fwbw): `fwbw` of phase 5's prefilter lists
     of its first 50 queries (15,000 pairs of median length 292), the
     counts set to 0 just before and read just after: pairs/s, B5's
     launches and device ms (CUDA events), the host's seconds by part, the
     busy share; the first 2 queries' records equal to a CPU run beside
     phases 12-13, but where a pair's two alignments tie under the CPU's P:
     their MAC values there within 1e-5 plus what rounding can move them
     (the two runs' P difference over their cells, the f32 DP's rounding;
     a near tie, printed);
then one JSON line listing every kernel (ten entry points), with its
launches on the clustering, iterative, translated, taxonomy and MSA
paths beside those of the path that launches it;
and as the last line {"ok": true, "device": {...}}. Exits non-zero without a
CUDA card or outside a checkout of the repository.
"""

import contextlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "toy"
WORK = ROOT / ".smoke_work"
SEED = 20261016
# every kernel source of the port, csrc/<name>.cu: a new kernel adds a name
KERNEL_SOURCES = ("sw", "rescore", "gapless", "expand", "fwbw")
# targets of the real-size phases: the size of the reference's small bench
# run (experiments/make_scale_db.py); the 1,000 queries stay
N_TARGETS = 50_000

# H100 SXM, published: 3.35 TB/s HBM3; int32 rate of the CUDA cores:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 Top/s (the fp32 row of
# the data sheet, 67 TFLOP/s, is 132 x 128 lanes x 2 (FMA) x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 instructions one affine-gap SW cell needs at the least, by form of
# the SW kernel (csrc/sw.cu lists them; every entry point: sw_multi,
# sw_offset, sw_single, sw_score). int32 form, in Hopper's DPX forms: H - go 1
# (shared by E and F), E and F one __viaddmax_s32 each, max(diag + s, E) one
# __viaddmax_s32, max(., F, 0) one __vimax_s32_relu, running best 1. The
# int16 form does the five recurrence steps as s16x2 DPX instructions for two
# cells each (__vadd2 for H - go, __viaddmax_s16x2 for E, F and
# max(diag + s, E), __viaddmax_s16x2_relu with F and 0) and the running (or
# column) max as one __vimax3_s16x2 per four cells: 2.75 a cell. Score-only
# and tracking count the same: tracking's compare is once per column. The
# data sheet gives no DPX rate; the bound takes one DPX instruction per int32
# lane and clock.
SW_OPS_PER_CELL = {"int32": 6, "int16": 2.75}
# int32 operations one cell of the ungapped diagonal rescore needs at the
# least: the score (lookup plus correction), the add-max-relu step of the
# running sum, the running best
RESCORE_OPS_PER_CELL = 3
# instructions one gapless cell needs at the least, by kernel and form
# (csrc/gapless.cu). int32 form: the add and the max with 0 in one
# __viaddmax_s32_relu, the cap, the running best with tracking; without
# tracking the cap goes. int16 form, both kernels: two cells per DPX
# instruction, so add + clamp to [0, cap] is one __viaddmin_s16x2_relu per
# two cells and the running (or column) max one __vimax3_s16x2 per four:
# 3/4 (the diagonal's permute and the tracking compare are once per column,
# not per cell). The data sheet gives no DPX rate; the bound takes one DPX
# instruction per int32 lane and clock, as for SW, so a share of the bound
# over 100% would mean the card issues DPX faster than int32.
GAPLESS_OPS_PER_CELL = {("gapless", "int32"): 3,
                        ("gapless_score", "int32"): 2,
                        ("gapless", "int16"): 0.75,
                        ("gapless_score", "int16"): 0.75}
# the posting expansion (B6, csrc/expand.cu): bytes each expansion must
# move (a u32 id and a u16 position of the index in, an int64 key and a u16
# diagonal out), each triple (the least the function needs in: starts
# int64, qpos and qid int32, and the list's length in 32 bits, as counts
# or as a running sum, since a flush's total stays below 2^31; the
# wrapper's interface passes both counts and an int64 running sum, 12 B
# more, which the bound does not credit) and each pad slot (its key and
# diagonal out); int32
# operations an expansion at the least: the entry's offset in its list and
# its index, the key's shift-or, the diagonal's subtraction
EXPAND_BYTES_PER_EXPANSION = 16
EXPAND_BYTES_PER_TRIPLE = 20
EXPAND_BYTES_PER_PAD = 10
EXPAND_OPS_PER_EXPANSION = 4
# the forward-backward alignment (B5, csrc/fwbw.cu): f32 operations one
# cell needs at the least (exp, log and a division one each), as the JAX
# algorithm the kernel evaluates has them: each direction of the partition
# function 20 (S/T and its exp 2, zm's three adds and multiply 4, zf's two
# multiplies, add and the row's division 4, ze's step 3 and its division 1,
# zm's division 1, the row max 1, the scan's composition 2, log zm and its
# offset 2), P 9 (two adds, S/T and the logsumexp's subtraction, exp; the
# logsumexp's max, subtraction, exp and sum), the MAC DP 21 (P - mact, the
# diagonal's add and subtraction, the up term, two maxes, j c, two adds, the
# running max, two subtractions and the floor's subtraction and max, the
# left term, three compares and three maxes, the row's max); bytes: the
# residues in (a pair's query and target) and the states out, a byte a cell,
# with 16 B of results a pair. The peak is the data sheet's f32 rate.
FWBW_OPS_PER_CELL = 70
FP32_FLOPS_PER_S = 67e12


_PHASE_T0 = [time.perf_counter()]


def phase_done(n):
    """Log the seconds phase n took (since the previous phase ended)."""
    now = time.perf_counter()
    log(f"phase {n}: {now - _PHASE_T0[0]:.2f} s")
    _PHASE_T0[0] = now


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out[0].strip()


def time_ms(fn, reps, warm=True):
    """Median of `reps` CUDA-event timings of fn, after a call that warms it
    (warm=False: the caller's last call of fn, on the same inputs, did)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps, sleep_cycles=2_000_000):
    """Median time of fn's work on the card: a spin of `sleep_cycles` (about
    1 ms) holds the card busy while the host enqueues the events and fn, so
    that the events time the card's work and not the host's enqueueing (a
    launch whose wrapper takes longer on the host than its kernel on the
    card would otherwise be timed at its wrapper's speed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sw_bound_ms(nq, lq, lt, lanes, cells, form):
    """Least time of one sw_multi launch: the `cells` its inputs need at
    the form's SW_OPS_PER_CELL int32 operations each, or its bytes (each
    input read once: profiles, letters, qsel, qoff, t_lens and q_lens; each
    output written once), whichever takes longer."""
    ops_s = cells * SW_OPS_PER_CELL[form] / INT32_OPS_PER_S
    nbytes = (nq * 32 * lq * 4 + nq * 4 + lt * lanes + 3 * 4 * lanes
              + 3 * 4 * lanes)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


# -- data from the seed --------------------------------------------------------

AA = "ARNDCQEGHILKMFPSTWYV"
# blosum62 background (ARNDCQEGHILKMFPSTWYV), as experiments/make_scale_db.py
PBACK = np.array([0.0789, 0.0540, 0.0448, 0.0536, 0.0125, 0.0402, 0.0669,
                  0.0716, 0.0219, 0.0566, 0.0977, 0.0594, 0.0239, 0.0396,
                  0.0484, 0.0684, 0.0541, 0.0113, 0.0306, 0.0656])
PBACK = PBACK / PBACK.sum()


def sw_case(rng, submat, nq, lq, lt, lanes, reverse, negative=False,
            big=False, mut_rate=0.3, pssm=None):
    """Inputs of one sw_multi launch as the align stage builds them: nq
    query profiles of the Lq bucket, lanes targets of the Lt bucket (half of
    them fragments of their query with mut_rate of their letters mutated),
    pad letter 31. The reverse pass takes the reversed profile (pad rows
    first) and qoff = lq - 1 - qend. With `pssm` (a list of (profile,
    letters) of profile queries, Aligner.init_profile_query's columns, each
    in this Lq bucket) the queries are nq of those instead of sequences.
    Also returns what the aligner passes with them: each profile's real
    length (the forward pass's q_lens), each lane's window end and target
    length; and the cells the launch needs: per lane, its window rows
    [qoff, end) times its real target length (pad rows and columns cannot
    raise the best score)."""
    from mmseqs2_tpu_torch.ops.encode import make_query_profile
    mat = submat.sub_matrix.astype(np.int32)
    aa_idx = np.array([submat.aa2num[c] for c in AA])
    profs, qseqs = [], []
    picks = (rng.choice(len(pssm), size=nq, replace=len(pssm) < nq)
             if pssm is not None else [None] * nq)
    for pick in picks:
        if pick is not None:
            prof, q = pssm[pick]
            profs.append(prof[:, ::-1] if reverse else prof)
            qseqs.append(q)
            continue
        n = int(rng.integers(lq // 2 + 1, lq + 1))
        q = aa_idx[rng.choice(20, size=n, p=PBACK)]
        prof = make_query_profile(q, mat, None, pad_len=lq, alpha_pad=32)
        if negative:
            prof = np.where(prof > -(1 << 20), -1 - np.abs(prof) % 7, prof)
        if big:
            prof[q[0], 0] = 255
        profs.append(prof[:, ::-1] if reverse else prof)
        qseqs.append(q)
    qsel = rng.integers(0, nq, size=lanes).astype(np.int32)
    tb = np.full((lt, lanes), 31, np.int8)
    tlen = np.zeros(lanes, np.int64)
    for b in range(lanes):
        n = int(rng.integers(lt // 2 + 1, lt + 1))
        t = aa_idx[rng.choice(20, size=n, p=PBACK)]
        if b % 2 == 0:
            q = qseqs[qsel[b]]
            m = min(len(q), n)
            frag = q[:m].copy()
            mut = rng.random(m) < mut_rate
            frag[mut] = aa_idx[rng.choice(20, size=int(mut.sum()), p=PBACK)]
            t[:m] = frag[::-1] if reverse else frag
        tb[:n, b] = t
        tlen[b] = n
    q_lens = np.array([len(q) for q in qseqs], np.int32)
    qlen = q_lens[qsel].astype(np.int64)
    if reverse:
        qend = (rng.random(lanes) * qlen).astype(np.int64)
        qoff = (lq - 1 - qend).astype(np.int32)
        ends = np.full(lanes, lq, np.int64)
    else:
        qoff = np.zeros(lanes, np.int32)
        ends = qlen
    cells = int(((ends - qoff) * tlen).sum())
    return (np.concatenate(profs), tb, qsel, qoff, q_lens, ends,
            tlen.astype(np.int32), cells)


def phase_kernels(rng):
    import torch
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import sw
    submat = get_submat("blosum62.out", 2.0, 0.0)
    cases = []
    for lq in (256, 512, 1024):
        for lt in (256, 512, 1024):
            for rev in (False, True):
                cases.append(dict(nq=16, lq=lq, lt=lt, lanes=4096,
                                  reverse=rev, go=11, ge=1))
    cases += [
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=False, go=13, ge=2),
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=True, go=13, ge=2),
        dict(nq=1, lq=4096, lt=1024, lanes=512, reverse=False, go=11, ge=1),
        dict(nq=1, lq=4096, lt=1024, lanes=512, reverse=True, go=11, ge=1),
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=False, go=11, ge=1,
             negative=True),
        dict(nq=16, lq=1024, lt=512, lanes=4096, reverse=False, go=11, ge=1,
             big=True),
    ]
    # align2clust's gapped fallback: one pair a call, so NQ 1 and one lane,
    # forward and reverse, at the aligner's length buckets (a near-duplicate
    # pair sits in one bucket, or in two neighbours), the target a copy of
    # its query with 2% of its letters mutated. These draw from their
    # own generator, so that the later phases' data stay those of the
    # earlier runs.
    rng_one = np.random.default_rng(SEED + 9)
    cases += [dict(nq=1, lq=lq, lt=lt, lanes=1, reverse=rev, go=11, ge=1,
                   one_lane=True)
              for lq, lt in ((64, 64), (128, 128), (256, 256), (512, 512),
                             (1024, 1024), (2048, 2048), (256, 512),
                             (512, 256))
              for rev in (False, True)]
    # profile queries (blastpgp's align of iterations >= 1): the golden
    # it_profile_0's PSSM profiles (pssm/4, the X row 0, pad rows -2^20,
    # Aligner.init_profile_query's columns) in their length buckets, both
    # passes; the Lq 512 shapes also run in the int32 form (as every Lq 512
    # shape does), and the Lq 2048 bucket's profiles reach it by their own
    # range. From their own generator, as the one-lane cases.
    rng_pssm = np.random.default_rng(SEED + 11)
    pssm = pssm_profiles(submat)
    cases += [dict(nq=nq, lq=lq, lt=lt, lanes=lanes, reverse=rev, go=11,
                   ge=1, pssm=True)
              for nq, lq, lt, lanes in ((16, 512, 512, 4096),
                                        (16, 1024, 1024, 4096),
                                        (8, 2048, 1024, 2048))
              for rev in (False, True)]
    log("kernels vs plain versions: tolerance 0 (integer outputs, exact "
        "equality); ms = median of CUDA-event timings")
    rows = []
    for c in cases:
        src = (rng_pssm if c.get("pssm") else rng_one if c.get("one_lane")
               else rng)
        pf, tb, qsel, qoff, q_lens, ends, tlen, cells = sw_case(
            src, submat, c["nq"], c["lq"], c["lt"], c["lanes"], c["reverse"],
            c.get("negative", False), c.get("big", False),
            0.02 if c.get("one_lane") else 0.3,
            pssm[c["lq"]] if c.get("pssm") else None)
        args = [torch.from_numpy(a).cuda() for a in (pf, tb, qsel)]
        qoff_d = torch.from_numpy(qoff).cuda()
        go, ge = c["go"], c["ge"]
        name = (f"nq={c['nq']} lq={c['lq']} lt={c['lt']} lanes={c['lanes']} "
                f"{'reverse' if c['reverse'] else 'forward'} "
                f"go/ge={go}/{ge}"
                + (" all-negative" if c.get("negative") else "")
                + (" bound>TPU-pack-limit" if c.get("big") else "")
                + (" pssm" if c.get("pssm") else ""))
        # the lengths as the aligner passes them: the forward pass q_lens
        # per profile and no offset, the reverse pass the offset alone; the
        # Lq 512 forward and reverse shapes run twice more, in the int32
        # form (one entry raised to 40,000) and with the lengths off
        variants = [(c, pf, True)]
        if (c["nq"], c["lq"], c["lt"], go) == (16, 512, 512, 11) and not (
                c.get("negative") or c.get("big")):
            raised = pf.copy()
            raised[0, 0] = 40_000
            variants += [(dict(c, variant="int32 form"), raised, True),
                         (dict(c, variant="lengths off"), pf, False)]
        for cv, pv, with_lengths in variants:
            pv_d = torch.from_numpy(pv).cuda()
            pmax = int(pv.max())
            if with_lengths:
                window = int((ends - qoff).max())
                kw = dict(go=go, ge=ge, prof_max=pmax, max_window=window,
                          t_lens=torch.from_numpy(tlen).cuda())
                if c["reverse"]:
                    kw["qoff"] = qoff_d
                else:
                    kw["q_lens"] = torch.from_numpy(q_lens).cuda()
                lane_ends, lane_t = ends, tlen
            else:
                window = int((c["lq"] - qoff).max())
                kw = dict(go=go, ge=ge, qoff=qoff_d, prof_max=pmax,
                          max_window=window)
                lane_ends = np.full(c["lanes"], c["lq"])
                lane_t = np.full(c["lanes"], c["lt"])
            form = sw.pick_form(window, pmax, go, ge)
            if c.get("big") and form != "int32":
                raise AssertionError("the bound>TPU-pack-limit case did not "
                                     "pick the int32 form")
            computed = int((sw.rows_computed(form, window, lane_ends, qoff)
                            * lane_t).sum())
            got = sw.sw_multi(pv_d, *args[1:], **kw)
            want = sw.sw_multi_plain(pv_d, *args[1:], **kw)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in
                      zip(got, want))
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            if c.get("negative"):
                equal = equal and bool((got[0] == 0).all()) and bool(
                    (got[2] == -1).all()) and bool(
                    (got[1] == c["lq"] - 1).all())
            ms = time_ms(lambda: sw.sw_multi(pv_d, *args[1:], **kw), 5)
            # the plain version's call above warmed it
            plain_ms = time_ms(lambda: sw.sw_multi_plain(pv_d, *args[1:],
                                                         **kw), 1, warm=False)
            bound, by = sw_bound_ms(c["nq"], c["lq"], c["lt"], c["lanes"],
                                    cells, form)
            padded = c["lanes"] * c["lq"] * c["lt"]
            vname = name + (f" {cv['variant']}" if "variant" in cv
                            else "") + f" [{form}]"
            row = dict(case=vname, equal=equal, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, form=form, lengths=with_lengths,
                       cells_real=cells, cells_padded=padded,
                       cells_computed=computed,
                       gcups_real=cells / ms / 1e6,
                       gcups_padded=padded / ms / 1e6, bound_ms=bound,
                       bound_by=by, bound_share=bound / ms,
                       max_score=int(got[0].max()))
            log("kernel-case " + json.dumps(row))
            if not equal:
                raise AssertionError(f"sw_multi differs from its plain "
                                     f"version: {vname} (max abs err {err})")
            rows.append((cv, row))
    forms = {(r["form"], c["reverse"]) for c, r in rows if c.get("pssm")}
    if len(forms) != 4:
        raise AssertionError(f"the pssm cases ran {sorted(forms)}, not both "
                             f"forms in both passes")
    return rows


def pssm_profiles(submat):
    """The golden it_profile_0's profiles as the aligner's profile queries
    see them (Aligner.init_profile_query: (32, Lq bucket) int32 columns and
    the query letters), by Lq bucket."""
    from mmseqs2_tpu_torch.align.aligner import Aligner
    aligner = Aligner(submat, 11, 1, None, device="cpu")
    out = {}
    for p in golden_profiles():
        ctx = aligner.init_profile_query(p)
        out.setdefault(ctx.profile.shape[1], []).append(
            (ctx.profile, ctx.q_num))
    return out


def single_case(rng, submat, lq, lt, lanes, kind="normal", n=None):
    """Inputs of one launch of the exhaustive prefilter: one query profile
    of the Lq bucket and `lanes` targets of the Lt bucket, pad letter 31,
    half of them mutated fragments of the query. "saturate" plants the
    query itself at varying offsets, so that the running score reaches the
    cap early and stays there (the first-column rule decides the end);
    "negative" scores every cell below 0. The query is n long (drawn from
    (lq / 2, lq] if None). Also returns the query's real length and the
    targets' real lengths (cells = their product, summed)."""
    from mmseqs2_tpu_torch.ops.encode import make_query_profile
    mat = submat.sub_matrix.astype(np.int32)
    aa_idx = np.array([submat.aa2num[c] for c in AA])
    if n is None:
        n = int(rng.integers(lq // 2 + 1, lq + 1))
    q = aa_idx[rng.choice(20, size=n, p=PBACK)]
    prof = make_query_profile(q, mat, None, pad_len=lq, alpha_pad=32)
    if kind == "negative":
        prof = np.where(prof > -(1 << 20), -1 - np.abs(prof) % 7, prof)
    tb = np.full((lt, lanes), 31, np.int8)
    tlen = rng.integers(lt // 2 + 1, lt + 1, size=lanes)
    for b in range(lanes):
        m = int(tlen[b])
        t = aa_idx[rng.choice(20, size=m, p=PBACK)]
        if kind == "saturate":
            k = min(n, m - 8)
            o = b % 8
            t[o:o + k] = q[:k]
        elif b % 2 == 0:
            k = min(n, m)
            frag = q[:k].copy()
            mut = rng.random(k) < 0.3
            frag[mut] = aa_idx[rng.choice(20, size=int(mut.sum()), p=PBACK)]
            t[:k] = frag
        tb[:m, b] = t
    return np.ascontiguousarray(prof.astype(np.int32)), tb, n, tlen


def single_bound_ms(lq, lt, lanes, cells, ops_per_cell, n_out, n_in=0):
    """Least time of one single-profile launch: `cells` at ops_per_cell
    int32 operations, or its bytes (the profile, the target letters, n_in
    int32 per lane in and n_out out), whichever takes longer."""
    ops_s = cells * ops_per_cell / INT32_OPS_PER_S
    nbytes = 32 * lq * 4 + lt * lanes + 4 * lanes * (n_in + n_out)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def phase_exhaustive_kernels(rng):
    """gapless and gapless_score, then sw_single, sw_offset and sw_score,
    against their plain versions on the card at the shapes the exhaustive
    prefilter launches. Returns {kernel name: [(case, row), ...]}."""
    import torch
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import gapless as gl
    from mmseqs2_tpu_torch.ops import sw
    submat = get_submat("blosum62.out", 2.0, 0.0)
    out = {k: [] for k in ("gapless", "gapless_score", "sw_single",
                           "sw_offset", "sw_score")}

    def tuple_of(x):
        return x if isinstance(x, tuple) else (x,)

    def sentinels(lq):
        """An all-negative lane reports (0, lq - 1, -1)."""
        return lambda got: bool((got[0] == 0).all()) and (len(got) == 1 or (
            bool((got[1] == lq - 1).all()) and bool((got[2] == -1).all())))

    def compare(name, kernel, plain, args, kw, c, label, cells, bound,
                extra_ok=None, extra=None):
        got, want = tuple_of(kernel(*args, **kw)), tuple_of(plain(*args, **kw))
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if extra_ok is not None:
            equal = equal and extra_ok(got)
        ms = time_ms(lambda: kernel(*args, **kw), 5)
        plain_ms = time_ms(lambda: plain(*args, **kw), 1, warm=False)
        padded = c["lanes"] * c["lq"] * c["lt"]
        # cells_computed: what the kernel computes (every padded cell unless
        # `extra` says otherwise)
        row = dict(kernel=name, case=label, equal=equal, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, cells_real=cells,
                   cells_padded=padded, cells_computed=padded,
                   gcells_real=cells / ms / 1e6,
                   gcells_padded=padded / ms / 1e6, bound_ms=bound[0],
                   bound_by=bound[1], bound_share=bound[0] / ms,
                   max_score=int(got[0].max()))
        row.update(extra or {})
        log("kernel-case " + json.dumps(row))
        if not equal:
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{label} (max abs err {err})")
        out[name].append((c, row))
        return got

    # every case passes single_case's real lengths (q_len, t_lens) and the
    # profile's maximum; the Lq 512 x Lt 512 x 16,384 arrays run twice more:
    # at cap 40,000, which picks the int32 form, and with the lengths off
    gapless_cases = [
        dict(lq=128, lt=256, lanes=16384, cap=251),
        dict(lq=256, lt=512, lanes=16384, cap=251),
        dict(lq=512, lt=512, lanes=16384, cap=251),
        dict(lq=512, lt=1024, lanes=4096, cap=251),
        dict(lq=1024, lt=2048, lanes=4096, cap=251),
        dict(lq=2048, lt=512, lanes=4096, cap=251),     # strip-mined in int32
        dict(lq=512, lt=512, lanes=4096, cap=255 - 100),    # large bias
        dict(lq=512, lt=512, lanes=4096, cap=251, kind="saturate"),
        dict(lq=512, lt=512, lanes=4096, cap=251, kind="negative"),
        dict(lq=4096, lt=256, lanes=1024, cap=251),     # strip-mined in both
    ]
    for c in gapless_cases:
        kind = c.get("kind", "normal")
        prof, tb, qlen, tlen = single_case(rng, submat, c["lq"], c["lt"],
                                           c["lanes"], kind)
        cells = int(qlen * tlen.sum())
        args = [torch.from_numpy(a).cuda() for a in (prof, tb)]
        t_lens = torch.from_numpy(tlen.astype(np.int32)).cuda()
        label = (f"lq={c['lq']} lt={c['lt']} lanes={c['lanes']} "
                 f"cap={c['cap']}" + ("" if kind == "normal" else f" {kind}"))
        ok = sentinels(c["lq"]) if kind == "negative" else None
        variants = [(c, c["cap"], True)]
        if (c["lq"], c["lt"], c["lanes"]) == (512, 512, 16384):
            variants += [(dict(c, variant="int32 form"), 40_000, True),
                         (dict(c, variant="lengths off"), c["cap"], False)]
        for cv, cap, with_lengths in variants:
            form = gl.pick_form(cap, prof.max())
            kw = dict(cap=cap, prof_max=int(prof.max()))
            if with_lengths:
                kw.update(q_len=qlen, t_lens=t_lens)
                computed = gl.rows_computed(form, qlen) * int(tlen.sum())
            else:
                computed = gl.rows_computed(form, c["lq"]) * c["lt"] \
                    * c["lanes"]
            vlabel = label + (f" cap={cap}" if cap != c["cap"] else "") + (
                "" if with_lengths else " lengths off") + f" [{form}]"
            extra = dict(form=form, lengths=with_lengths,
                         cells_computed=computed)
            res = {}
            for name, kernel, plain, n_out in (
                    ("gapless", gl.gapless, gl.gapless_plain, 3),
                    ("gapless_score", gl.gapless_score,
                     gl.gapless_score_plain, 1)):
                res[name] = compare(
                    name, kernel, plain, args, kw, cv, vlabel, cells,
                    single_bound_ms(c["lq"], c["lt"], c["lanes"], cells,
                                    GAPLESS_OPS_PER_CELL[(name, form)],
                                    n_out, 1 if with_lengths else 0),
                    ok, extra)
            if not torch.equal(res["gapless_score"][0], res["gapless"][0]):
                raise AssertionError(f"gapless_score differs from gapless's "
                                     f"score: {vlabel}")
            if kind == "saturate":
                at_cap = float((res["gapless"][0] == cap).float().mean())
                log(f"  saturate: {at_cap:.3f} of the lanes end at the cap")
                if at_cap < 0.9:
                    raise AssertionError("the saturating case does not "
                                         "saturate")

    # sw_single and sw_score take single_case's real lengths and the
    # profile's maximum, as gappedprefilter passes them; sw_offset takes them
    # too, with its longest window. The Lq 512 x Lt 512 x 16,384
    # arrays run twice more: in the int32 form (one profile entry raised so
    # that pick_form chooses it) and with the lengths off. The cases after
    # the first five draw from their own generator, so that the later
    # phases' data stay those of the earlier runs.
    sw_cases = [
        dict(lq=256, lt=512, lanes=4096, go=11, ge=1),
        dict(lq=512, lt=512, lanes=16384, go=11, ge=1),
        dict(lq=1024, lt=2048, lanes=4096, go=11, ge=1),
        dict(lq=2048, lt=512, lanes=1024, go=11, ge=1),     # strip-mined
        dict(lq=512, lt=512, lanes=4096, go=13, ge=2, kind="negative"),
        dict(lq=512, lt=512, lanes=4096, go=1, ge=1),       # cheap gaps
        # strip-mined in both forms: 2,900 rows take int16 (2,900 x 11 <
        # 32,768) in two chunks of 64-row strips, and int32 in three of 32
        dict(lq=4096, lt=256, lanes=1024, go=11, ge=1, n=2900),
    ]
    rng_sw = np.random.default_rng(SEED + 6)
    for k, c in enumerate(sw_cases):
        kind = c.get("kind", "normal")
        prof, tb, qlen, tlen = single_case(
            rng if k < 5 else rng_sw, submat, c["lq"], c["lt"], c["lanes"],
            kind, c.get("n"))
        cells = int(qlen * tlen.sum())
        prof_d, tb_d = [torch.from_numpy(a).cuda() for a in (prof, tb)]
        t_lens = torch.from_numpy(tlen.astype(np.int32)).cuda()
        gaps = dict(go=c["go"], ge=c["ge"])
        label = (f"lq={c['lq']} lt={c['lt']} lanes={c['lanes']} "
                 f"go/ge={c['go']}/{c['ge']}"
                 + ("" if kind == "normal" else f" {kind}"))
        dims = (c["lq"], c["lt"], c["lanes"])
        ok = sentinels(c["lq"]) if kind == "negative" else None
        if k < 5:
            qoff = rng.integers(0, qlen, size=c["lanes"]).astype(np.int32)
            cells_off = int(((qlen - qoff) * tlen).sum())
            window = int((qlen - qoff).max())
            form = sw.pick_form(window, int(prof.max()), c["go"], c["ge"])
            computed = int((sw.rows_computed(form, window, qlen, qoff)
                            * tlen).sum())
            compare("sw_offset", sw.sw_offset, sw.sw_offset_plain,
                    [prof_d, tb_d, torch.from_numpy(qoff).cuda()],
                    dict(gaps, q_len=qlen, t_lens=t_lens,
                         prof_max=int(prof.max()), max_window=window), c,
                    label + f" [{form}]", cells_off,
                    single_bound_ms(*dims, cells_off, SW_OPS_PER_CELL[form],
                                    3, 2),
                    ok, dict(form=form, lengths=True,
                             cells_computed=computed))
        variants = [(c, prof_d, True)]
        if dims == (512, 512, 16384) or c.get("n"):
            raised = prof_d.clone()
            raised[0, 0] = 40_000
            variants.append((dict(c, variant="int32 form"), raised, True))
        if dims == (512, 512, 16384):
            variants.append((dict(c, variant="lengths off"), prof_d, False))
        for cv, pv, with_lengths in variants:
            pmax = int(pv.max())
            rows = qlen if with_lengths else c["lq"]
            form = sw.pick_form(rows, pmax, c["go"], c["ge"])
            kw = dict(gaps, prof_max=pmax)
            if with_lengths:
                kw.update(q_len=qlen, t_lens=t_lens)
                computed = gl.rows_computed(form, qlen) * int(tlen.sum())
            else:
                computed = gl.rows_computed(form, c["lq"]) * c["lt"] \
                    * c["lanes"]
            vlabel = label + (f" {cv['variant']}" if "variant" in cv
                              else "") + f" [{form}]"
            extra = dict(form=form, lengths=with_lengths,
                         cells_computed=computed)
            single = compare(
                "sw_single", sw.sw_single, sw.sw_single_plain, [pv, tb_d],
                kw, cv, vlabel, cells,
                single_bound_ms(*dims, cells, SW_OPS_PER_CELL[form],
                                3, 1 if with_lengths else 0), ok, extra)
            score = compare(
                "sw_score", sw.sw_score, sw.sw_score_plain, [pv, tb_d], kw,
                cv, vlabel, cells,
                single_bound_ms(*dims, cells, SW_OPS_PER_CELL[form],
                                1, 1 if with_lengths else 0), ok, extra)
            if not torch.equal(score[0], single[0]):
                raise AssertionError(f"sw_score differs from sw_single's "
                                     f"score: {vlabel}")
    return out


def rescore_store(rng, n_t=N_TARGETS, n_q=128):
    """A target store and a query batch at the prefilter's shapes: random
    letters at SwissProt-like lengths; every fourth query is a mutated
    fragment of a target. Returns the store, the batch and, per query, the
    (target, offset) it was cut from (or (-1, 0))."""
    from mmseqs2_tpu_torch.data.submat import get_submat
    m = get_submat("blosum62.out", 2.0, -0.2).sub_matrix.astype(np.int32)
    alpha = m.shape[0]
    t_len = lengths(rng, n_t).astype(np.int32)
    t_off = np.concatenate([[0], np.cumsum(t_len[:-1], dtype=np.int64)])
    t_cat = rng.choice(20, size=int(t_len.sum()), p=PBACK).astype(np.int8)
    q_len = np.minimum(lengths(rng, n_q), 1500).astype(np.int32)
    lq = int(q_len.max())
    q_pad = np.full((n_q, lq), alpha - 1, np.uint8)
    corr = np.zeros((n_q, lq), np.int8)
    origin = np.full((n_q, 2), -1, np.int64)
    for b in range(n_q):
        n = int(q_len[b])
        q_pad[b, :n] = rng.choice(20, size=n, p=PBACK)
        corr[b, :n] = rng.integers(-2, 3, size=n)
        if b % 4 == 0:
            t = int(rng.integers(n_t))
            m_len = min(n, int(t_len[t]))
            o = int(rng.integers(0, int(t_len[t]) - m_len + 1))
            frag = t_cat[t_off[t] + o:t_off[t] + o + m_len].copy()
            mut = rng.random(m_len) < 0.2
            frag[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
            q_pad[b, :m_len] = frag
            origin[b] = (t, o)
    return dict(t_cat=t_cat, t_off=t_off, t_len=t_len, q_pad=q_pad,
                corr=corr, submat=m, q_len=q_len, origin=origin)


def rescore_case(rng, st, n_cand, slots=None, edge=False, negative=False,
                 stale=0, shift=0):
    """Candidates as the prefilter's candidate stage leaves them: n_cand
    valid ones at the front of `slots` slots, the rest invalid with qid and
    id I32_MAX. Random diagonals inside the pair's range; for the queries
    cut from a target, a share of candidates on the true diagonal (scores
    past 255). `edge` adds the extremes of the 16-bit diagonal, windows of
    0 and 1 cells and invalid slots in between; `negative` scores every
    cell below 0; `stale` of the slots past n_cand hold candidates with
    cvalid True, as a mask a count overrides; `shift` moves the target
    store by that many bytes (every t_off with it). Returns the wrapper's
    arguments (numpy) and the cells of the valid slots before n_cand."""
    slots = slots or n_cand
    n_q, n_t = len(st["q_len"]), len(st["t_len"])
    cqid = rng.integers(0, n_q, size=n_cand).astype(np.int64)
    cid = rng.integers(0, n_t, size=n_cand).astype(np.int64)
    true = (st["origin"][cqid, 0] >= 0) & (rng.random(n_cand) < 0.5)
    cid[true] = st["origin"][cqid[true], 0]
    lo = -(st["t_len"][cid].astype(np.int64) - 1)
    hi = st["q_len"][cqid].astype(np.int64) - 1
    d = (lo + rng.random(n_cand) * (hi - lo + 1)).astype(np.int64)
    d[true] = -st["origin"][cqid[true], 1]
    valid = np.ones(n_cand, bool)
    if edge:
        d[:6] = (-32768, 32767, hi[2], lo[3], hi[4] + 1, lo[5] - 1)
        valid[rng.random(n_cand) < 0.1] = False
        valid[:6] = True
    d = np.clip(d, -32768, 32767)
    qs, ts = np.maximum(d, 0), np.maximum(-d, 0)
    n = np.maximum(np.minimum(st["t_len"][cid] - ts,
                              st["q_len"][cqid] - qs), 0)
    cells = int(n[valid].sum())
    pad = slots - n_cand

    def full(a, fill, dtype):
        return np.concatenate([a, np.full(pad, fill)]).astype(dtype)
    cqid = np.where(valid, cqid, 2147483647)
    cid = np.where(valid, cid, 2147483647)
    submat = -1 - np.abs(st["submat"]) if negative else st["submat"]
    corr = -np.abs(st["corr"]) if negative else st["corr"]
    args = [full(cqid, 2147483647, np.int32), full(cid, 2147483647, np.int32),
            full(d & 0xFFFF, 0, np.int32), full(valid, False, bool),
            st["t_cat"], st["t_off"], st["t_len"], st["q_pad"], corr,
            np.ascontiguousarray(submat), st["q_len"]]
    if stale:
        sl = slice(n_cand, n_cand + stale)
        args[0][sl] = rng.integers(0, n_q, size=stale)
        args[1][sl] = rng.integers(0, n_t, size=stale)
        args[3][sl] = True
    if shift:
        args[4] = np.concatenate([np.zeros(shift, np.int8), args[4]])
        args[5] = args[5] + shift
    return args, cells


def rescore_bound_ms(args, cells, n_valid=None):
    """Least time of one diag_rescore launch: RESCORE_OPS_PER_CELL int32
    operations for each of the `cells` its windows hold, or the bytes it
    must move, whichever takes longer. The bytes, each once: the target
    bytes the windows touch, the query letters and corrections, the
    matrix, 12 B of target table per candidate, and per slot what the call
    needs of it: a candidate's slot (cvalid True, and before the count
    n_valid where one is given) 13 B in and 4 B out, any other slot before
    the count its cvalid and its output (5 B), a slot past the count its
    output (4 B). Returns (ms, bound_by, ms_all_slots): ms_all_slots is
    the bound as the first version of this phase counted it, 17 B for every
    slot and 12 B for every slot with cvalid True, kept beside the other so
    that shares of it stay comparable across versions of the kernel."""
    shared = (min(cells, args[4].nbytes) + args[7].nbytes + args[8].nbytes
              + args[9].nbytes + args[10].nbytes)
    ms, by = rescore_bound(args, cells, shared, n_valid)
    all_s = (shared + len(args[0]) * 17
             + min(int(args[3].sum()), len(args[6])) * 12) / HBM_BYTES_PER_S
    ops_s = cells * RESCORE_OPS_PER_CELL / INT32_OPS_PER_S
    return ms, by, max(ops_s, all_s) * 1e3


def rescore_bound(args, cells, shared, n_valid):
    """(ms, bound_by) of a rescore launch of either form: RESCORE_OPS_PER_
    CELL operations a cell, or `shared` bytes (the inputs every candidate
    shares) plus 12 B of target table per candidate and what each slot
    needs, whichever takes longer."""
    slots = len(args[0])
    upto = slots if n_valid is None else n_valid
    cand = int(args[3][:upto].sum())
    per_slot = cand * 17 + (upto - cand) * 5 + (slots - upto) * 4
    ops_s = cells * RESCORE_OPS_PER_CELL / INT32_OPS_PER_S
    bytes_s = (shared + per_slot + min(cand, len(args[6])) * 12
               ) / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


RESCORE_CASES = [
    dict(n_cand=1 << 10), dict(n_cand=1 << 13), dict(n_cand=1 << 15),
    dict(n_cand=1 << 17),
    dict(n_cand=1 << 17, slots=1 << 21),          # a flush's own shape
    dict(n_cand=1 << 12, edge=True),
    dict(n_cand=1 << 12, negative=True),
    # cases of the valid count: stale candidates past it, a moved store
    dict(n_cand=1 << 15, slots=1 << 17, stale=1 << 15),
    dict(n_cand=1 << 15, shift=7),
    # the shape easy-search's flushes launch (about 17,300 candidates in
    # 2^21 slots, phase 6's record)
    dict(n_cand=17_408, slots=1 << 21)]


def valid_cells(args, upto=None):
    """Cells of the windows of the slots with cvalid True (before `upto`),
    from the wrapper's numpy arguments."""
    cqid, cid, cdiag, cvalid = args[:4]
    t_len, q_len = args[6], args[10]
    sel = np.nonzero(cvalid[:upto])[0]
    d = (cdiag[sel].astype(np.int64) + 0x8000) % 0x10000 - 0x8000
    n = np.minimum(t_len[cid[sel]].astype(np.int64) - np.maximum(-d, 0),
                   q_len[cqid[sel]].astype(np.int64) - np.maximum(d, 0))
    return int(np.maximum(n, 0).sum())


def rescore_case_name(st, c, counted):
    return (f"candidates={c['n_cand']} slots={c.get('slots', c['n_cand'])}"
            f" targets={len(st['t_len'])} queries={len(st['q_len'])}"
            + (" edge-cases" if c.get("edge") else "")
            + (" all-negative" if c.get("negative") else "")
            + (f" stale={c['stale']}" if c.get("stale") else "")
            + (f" t_cat-shift={c['shift']}" if c.get("shift") else "")
            + (" n_valid" if counted else ""))


def phase_rescore_kernel(rng, counts=(False, True)):
    """diag_rescore against its plain version at the prefilter's shapes,
    each case without and with the valid count (the main path passes it;
    `counts=(False,)` runs a package whose wrapper takes none, as
    ab.py does with an older checkout). `ms` is the
    kernel's time on the card (device_ms), `call_ms` the call's as earlier
    versions of this phase timed it (time_ms: the wrapper's host time shows
    where it is longer than the kernel). The first seven cases draw their
    data as the first version of this phase did, so that an older checkout
    and this one see the same inputs from one seed."""
    import torch
    from mmseqs2_tpu_torch.ops import rescore
    st = rescore_store(rng)
    rows = []
    for c in RESCORE_CASES:
        np_args, cells = rescore_case(rng, st, **c)
        args = [torch.from_numpy(a).cuda() for a in np_args]
        n_valid = torch.tensor(c["n_cand"], dtype=torch.int32, device="cuda")
        for counted in counts:
            kw = dict(n_valid=n_valid) if counted else {}
            got = rescore.diag_rescore(*args, **kw)
            want = rescore.diag_rescore_plain(*args, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            equal = torch.equal(got, want)
            if c.get("negative"):
                equal = equal and bool((got == 0).all())
            if counted and c.get("stale"):
                equal = equal and not bool(got[c["n_cand"]:].any())
            ms = device_ms(lambda: rescore.diag_rescore(*args, **kw), 9)
            call_ms = time_ms(lambda: rescore.diag_rescore(*args, **kw), 5)
            plain_ms = time_ms(lambda: rescore.diag_rescore_plain(*args, **kw),
                               2)
            # the cells this run needs: without the count the stale slots
            # are candidates too
            run_cells = cells
            if c.get("stale") and not counted:
                run_cells = valid_cells(np_args)
            bound, by, bound_all = rescore_bound_ms(
                np_args, run_cells, c["n_cand"] if counted else None)
            name = rescore_case_name(st, c, counted)
            row = dict(case=name, equal=equal, max_abs_err=err, ms=ms,
                       call_ms=call_ms, plain_ms=plain_ms, cells=run_cells,
                       gcells_per_s=run_cells / ms / 1e6, bound_ms=bound,
                       bound_by=by, bound_share=bound / ms,
                       bound_ms_all_slots=bound_all,
                       bound_share_all_slots=bound_all / ms,
                       max_score=int(got.max()),
                       saturated=int((got > 255).sum()))
            log("rescore-case " + json.dumps(row))
            if not equal:
                raise AssertionError(f"diag_rescore differs from its plain "
                                     f"version: {name} (max abs err {err})")
            rows.append((dict(c, counted=counted), row))
    return rows


# -- the profile form of the rescore (B4') ------------------------------------

def golden_profiles():
    """The PSSM profiles of the golden it_profile_0 (the reference's
    iteration-0 profiles of the 500 toy queries), parsed."""
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.profile.io import parse_profile
    with DBReader(str(GOLDEN / "it_profile_0")) as r:
        return [parse_profile(r.get_data(i)) for i in range(r.size)]


def rescore_profile_store(rng, n_t=N_TARGETS, n_q=128):
    """A target store at the prefilter's shapes (as rescore_store) and a
    batch of n_q profile queries: the golden profiles of at most 1,500
    positions, their query letters, and each query's rescore profile as
    the profile prefilter builds it (pssm/4 truncated toward zero on the 20
    amino-acid columns, X at 0), packed into (n_q, Lq, 32) int8 rows.
    Every fourth query's letters, 20% mutated, are planted in a target
    (origin), so that its true diagonal scores high."""
    from mmseqs2_tpu_torch.commands.prefilter_kmer import profile_query
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops.rescore import PROFILE_WIDTH, profile_rows
    from mmseqs2_tpu_torch.prefilter.kmer_index import pattern_offsets
    m = get_submat("blosum62.out", 2.0, -0.2).sub_matrix.astype(np.int32)
    alpha = m.shape[0]
    profs = [p for p in golden_profiles() if 0 < p.length <= 1500][:n_q]
    t_len = lengths(rng, n_t).astype(np.int32)
    t_off = np.concatenate([[0], np.cumsum(t_len[:-1], dtype=np.int64)])
    t_cat = rng.choice(20, size=int(t_len.sum()), p=PBACK).astype(np.int8)
    q_len = np.array([p.length for p in profs], np.int32)
    lq = int(q_len.max())
    q_pad = np.full((n_q, lq), alpha - 1, np.uint8)
    prof = np.zeros((n_q, lq, PROFILE_WIDTH), np.int8)
    origin = np.full((n_q, 2), -1, np.int64)
    offsets, _ = pattern_offsets(6, True, "")
    for b, p in enumerate(profs):
        n = int(q_len[b])
        q_pad[b, :n] = p.query_num
        prof[b, :n] = profile_rows(profile_query(p, 6, alpha - 1,
                                                 offsets)[1])
        if b % 4 == 0:
            t = int(rng.integers(n_t))
            m_len = min(n, int(t_len[t]))
            o = int(rng.integers(0, int(t_len[t]) - m_len + 1))
            frag = q_pad[b, :m_len].astype(np.int8)
            mut = rng.random(m_len) < 0.2
            frag[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
            t_cat[t_off[t] + o:t_off[t] + o + m_len] = frag
            origin[b] = (t, o)
    return dict(t_cat=t_cat, t_off=t_off, t_len=t_len, q_pad=q_pad,
                corr=np.zeros((n_q, lq), np.int8), submat=m, q_len=q_len,
                origin=origin, prof=prof)


def long_query_store(st, lq=2400, every=8):
    """rescore_profile_store's store with every `every`-th query lengthened
    to lq positions (its profile rows repeated)."""
    n_q = len(st["q_len"])
    q_len = st["q_len"].copy()
    prof = np.zeros((n_q, lq, st["prof"].shape[2]), np.int8)
    prof[:, :st["prof"].shape[1]] = st["prof"]
    for b in range(0, n_q, every):
        n = int(q_len[b])
        prof[b] = np.resize(st["prof"][b, :n], (lq, prof.shape[2]))
        q_len[b] = lq
    return dict(st, q_len=q_len, prof=prof,
                q_pad=np.zeros((n_q, lq), np.uint8),
                corr=np.zeros((n_q, lq), np.int8))


def rescore_profile_case(rng, st, ends=False, order=None, long=False, **c):
    """rescore_case's candidates in the profile form's argument order
    (cqid, cid, cdiag, cvalid, t_cat, t_off, t_len, prof, q_len): `negative`
    scores every cell below 0; `ends` puts windows on the first and the
    last target of the store, at both ends of each; `order="query"` sorts
    the slots before n_cand by (query, target), valid first, as the
    prefilter's candidate stage hands them over (the other cases' slots
    are in no order of query); `long` draws on long_query_store(st).
    Returns the arguments and the cells of the valid slots before n_cand."""
    if long:
        st = long_query_store(st)
    args, cells = rescore_case(rng, st, **c)
    if order == "query":
        n = c["n_cand"]
        perm = np.lexsort((args[1][:n], args[0][:n], ~args[3][:n]))
        for i in range(4):
            args[i][:n] = args[i][:n][perm]
    prof = st["prof"]
    if c.get("negative"):
        prof = (-1 - np.abs(prof.astype(np.int16))).astype(np.int8)
    pargs = args[:7] + [prof, st["q_len"]]
    if ends:
        last = len(st["t_len"]) - 1
        tl0, tl1 = int(st["t_len"][0]), int(st["t_len"][last])
        ql0, ql1 = int(st["q_len"][0]), int(st["q_len"][1])
        for k, (q, t, d) in enumerate(((0, 0, 0), (0, 0, 1 - tl0),
                                       (0, 0, ql0 - 1), (1, last, 0),
                                       (1, last, 1 - tl1),
                                       (1, last, ql1 - 1))):
            pargs[0][k], pargs[1][k], pargs[2][k] = q, t, d & 0xFFFF
            pargs[3][k] = True
        cells = valid_cells(pargs[:7] + [None, None, None, st["q_len"]],
                            c["n_cand"])
    return pargs, cells


def rescore_profile_bound_ms(args, cells, n_valid=None):
    """Least time of one diag_rescore_profile launch, counted as
    rescore_bound_ms counts the letters form's: RESCORE_OPS_PER_CELL int32
    operations a cell, or the bytes, whichever takes longer. The bytes,
    each once: the target bytes the windows touch, the profile rows they
    read (32 B a cell, at most the profile tensor), the query lengths, 12 B
    of target table per candidate, and per slot what the call needs of it
    (as for the letters form)."""
    shared = (min(cells, args[4].nbytes) + min(32 * cells, args[7].nbytes)
              + args[8].nbytes)
    return rescore_bound(args, cells, shared, n_valid)


RESCORE_PROFILE_CASES = [
    dict(n_cand=1 << 10), dict(n_cand=1 << 13), dict(n_cand=1 << 15),
    dict(n_cand=1 << 17),
    dict(n_cand=1 << 17, slots=1 << 21),          # a flush's own shape
    dict(n_cand=1 << 12, edge=True),
    dict(n_cand=1 << 12, negative=True),
    dict(n_cand=1 << 15, slots=1 << 17, stale=1 << 15),
    dict(n_cand=1 << 15, shift=7),
    dict(n_cand=1 << 12, ends=True),
    # the path's order, slots sorted by (query, target), then with long
    # queries (2,400 positions, 75 KB of rows each)
    dict(n_cand=1 << 17, order="query"),
    dict(n_cand=1 << 17, slots=1 << 21, order="query"),
    dict(n_cand=1 << 15, order="query", long=True)]


def phase_rescore_profile_kernel():
    """diag_rescore_profile (B4') against its plain version at the profile
    prefilter's shapes, each case without and with the valid count: 2^10
    to 2^17 candidates, a flush's 2^21 slots, edge diagonals, all-negative
    scores, stale candidates past the count, a moved target store and
    windows at both ends of the store, all with slots in no order of
    query; then slots sorted by (query, target) as the path has them, at
    2^17 candidates, in a flush's 2^21 slots, and with every eighth query
    2,400 positions long; the profile rows are the golden it_profile_0's,
    so their range is real. From its own generator, so that the later
    phases' data stay those of the earlier runs."""
    import torch
    from mmseqs2_tpu_torch.ops import rescore
    rng = np.random.default_rng(SEED + 12)
    st = rescore_profile_store(rng)
    rows = []
    for c in RESCORE_PROFILE_CASES:
        np_args, cells = rescore_profile_case(rng, st, **c)
        args = [torch.from_numpy(a).cuda() for a in np_args]
        n_valid = torch.tensor(c["n_cand"], dtype=torch.int32, device="cuda")
        for counted in (False, True):
            kw = dict(n_valid=n_valid) if counted else {}
            got = rescore.diag_rescore_profile(*args, **kw)
            want = rescore.diag_rescore_profile_plain(*args, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            equal = torch.equal(got, want)
            if c.get("negative"):
                equal = equal and bool((got == 0).all())
            if counted and c.get("stale"):
                equal = equal and not bool(got[c["n_cand"]:].any())
            ms = device_ms(lambda: rescore.diag_rescore_profile(*args, **kw),
                           9)
            plain_ms = time_ms(
                lambda: rescore.diag_rescore_profile_plain(*args, **kw), 2)
            run_cells = cells
            if c.get("stale") and not counted:
                run_cells = valid_cells(np_args[:7] + [None, None, None,
                                                       np_args[8]])
            bound, by = rescore_profile_bound_ms(
                np_args, run_cells, c["n_cand"] if counted else None)
            name = (rescore_case_name(st, c, counted)
                    + (" store-ends" if c.get("ends") else "")
                    + (" by-query" if c.get("order") else "")
                    + (" long-queries" if c.get("long") else "")
                    + " profile")
            row = dict(case=name, equal=equal, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, cells=run_cells,
                       gcells_per_s=run_cells / ms / 1e6, bound_ms=bound,
                       bound_by=by, bound_share=bound / ms,
                       max_score=int(got.max()),
                       saturated=int((got > 255).sum()))
            log("rescore-profile-case " + json.dumps(row))
            if not equal:
                raise AssertionError(f"diag_rescore_profile differs from its "
                                     f"plain version: {name} (max abs err "
                                     f"{err})")
            rows.append((dict(c, counted=counted), row))
    return rows


# -- the posting expansion (B6) -------------------------------------------------

def expand_bound_ms(k, total, cap):
    """Least time of one posting_expand launch over k triples, total
    expansions and cap slots: its bytes (EXPAND_BYTES_PER_*) at the card's
    memory rate, or EXPAND_OPS_PER_EXPANSION int32 operations an expansion,
    whichever takes longer. Returns (ms, bound_by, bytes)."""
    nbytes = (total * EXPAND_BYTES_PER_EXPANSION + k * EXPAND_BYTES_PER_TRIPLE
              + (cap - total) * EXPAND_BYTES_PER_PAD)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = total * EXPAND_OPS_PER_EXPANSION / INT32_OPS_PER_S
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes)


def expand_entries(rng, n_targets=N_TARGETS):
    """Index entries of the size a real-size index holds (one a residue of
    N_TARGETS SwissProt-like targets): ids ascending as an index's lists
    hold them, positions below 2,000."""
    n = int(lengths(rng, n_targets).sum())
    seq = np.sort(rng.integers(0, n_targets, size=n)).astype(np.int32)
    pos = rng.integers(0, 2000, size=n).astype(np.uint16)
    return seq, pos


def expand_case(rng, n_exp, ent, n_q=128, mean_len=2.0, n_pad=64):
    """CSR triples of a flush of n_q queries and about n_exp expansions
    into the entries `ent`: list lengths geometric with mean mean_len, a
    tenth of the triples empty, the first list at the first entry and one
    ending at the last, n_pad pad triples (count 0) at the end. Returns the
    triples (starts, counts, qpos, qid)."""
    n_e = len(ent[0])
    k = max(n_exp // int(mean_len), 4)
    counts = rng.geometric(1 / mean_len, size=k)
    counts[rng.random(k) < 0.1] = 0
    starts = rng.integers(0, n_e - counts + 1)
    starts[1] = 0
    starts[k // 2] = n_e - counts[k // 2]
    qid = np.sort(rng.integers(0, n_q, size=k))
    qpos = rng.integers(0, 1500, size=k)
    pad = np.zeros(n_pad, np.int64)
    return (np.concatenate([starts, pad]).astype(np.int64),
            np.concatenate([counts, pad]).astype(np.int32),
            np.concatenate([qpos, pad]).astype(np.int32),
            np.concatenate([qid, pad + n_q - 1]).astype(np.int32))


def toy_flush(n_q=128):
    """A real flush's triples on a real index: the toy DB's index at -s
    5.7 (the prefilter's defaults) and its first n_q queries' stage-0, as
    the command prepares them. Returns (triples, entries)."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer as pk
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
    from mmseqs2_tpu_torch.prefilter.kmer_generator import (KmerGenerator,
                                                            SubKmerScores)
    seed = get_submat("VTML80.out", 8.0, -0.2)
    alpha = seed.alphabet_size - 1
    db = EncodedDB(open_seq_db(str(GOLDEN / "qdb")), seed)
    thr = pk.get_kmer_threshold(5.7, 6)
    table = pk.build_index(db, seed, 6, thr, True, 0.9, False, True, "")
    gen = KmerGenerator(
        6, alpha, SubKmerScores(seed.sub_matrix, alpha, 3).attach_disk_cache(),
        SubKmerScores(seed.sub_matrix, alpha, 2).attach_disk_cache())
    dev = DevicePrefilter(table, seed, get_submat("blosum62.out", 2.0, -0.2),
                          thr, 6, 300, generator=gen)
    prep = [dev.prepare_query(db.seq_num(i)) for i in range(n_q)]
    trip = (np.concatenate([p[0] for p in prep]),
            np.concatenate([p[1] for p in prep]),
            np.concatenate([p[2] for p in prep]),
            np.concatenate([np.full(len(p[1]), b, np.int32)
                            for b, p in enumerate(prep)]))
    return trip, (np.asarray(table.entries_seq).astype(np.int32),
                  np.asarray(table.entries_pos).astype(np.uint16))


def expand_row(label, trip, ent, cap, reps=9):
    """posting_expand against its plain version on the card (exact
    equality) for one flush: ms by CUDA events, the plain version's, GB/s
    over the bytes the flush needs, and the byte bound."""
    import torch
    from mmseqs2_tpu_torch.ops import expand
    t = [torch.from_numpy(a).cuda() for a in trip]
    e_seq = torch.from_numpy(ent[0]).cuda()
    e_pos = torch.from_numpy(ent[1].view(np.int16)).cuda()
    cum = torch.cumsum(t[1], 0, dtype=torch.int64)
    total_t = cum[-1]
    args = (t[0], t[1], t[2], t[3], cum, e_seq, e_pos, total_t, cap)
    got = expand.posting_expand(*args)
    want = expand.posting_expand_plain(*args)
    torch.cuda.synchronize()
    equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = int((got[1].int() - want[1].int()).abs().max()) if cap else 0
    keys_differ = int((got[0] != want[0]).sum())
    ms = device_ms(lambda: expand.posting_expand(*args), reps)
    plain_ms = time_ms(lambda: expand.posting_expand_plain(*args), 2)
    total, k = int(total_t), len(trip[0])
    bound, by, nbytes = expand_bound_ms(k, total, cap)
    row = dict(case=f"{label} triples={k} expansions={total} slots={cap} "
               f"entries={len(ent[0])}", equal=equal, max_abs_err=err,
               keys_differ=keys_differ, ms=ms, plain_ms=plain_ms,
               bytes=nbytes,
               gb_per_s=nbytes / ms / 1e6, bound_ms=bound, bound_by=by,
               bound_share=bound / ms, library_ms=None,
               zero_count_triples=int((trip[1] == 0).sum()))
    log("expand-case " + json.dumps(row))
    if not equal:
        raise AssertionError(f"posting_expand differs from its plain "
                             f"version: {row['case']} ({keys_differ} keys, "
                             f"diagonals by up to {err})")
    return row


EXPAND_CASES = [1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 21]


def phase_expand_kernel():
    """posting_expand (B6) against its plain version at the flush shapes:
    128 queries and 2^10 to 2^21 expansions into entries of a real-size
    index's length (zero-count and pad triples, lists at both ends of the
    entries), 2^21 expansions with 2^17 pad slots, 2^16 with a list longer
    than a tile and a run of 3,000 zero-count triples, 2^21 into an index
    of 3,000 targets (6 MB, L2-resident), and a real flush on a real index
    (the toy DB's, its first 128 queries). From its own
    generator, so that the later phases' data stay those of the earlier
    runs."""
    rng = np.random.default_rng(SEED + 13)
    ent = expand_entries(rng)
    rows = []
    for n in EXPAND_CASES:
        trip = expand_case(rng, n, ent)
        total = int(trip[1].sum())
        rows.append((dict(n=n), expand_row("synthetic", trip, ent, total)))
    trip = expand_case(rng, 1 << 21, ent)
    total = int(trip[1].sum())
    rows.append((dict(n=1 << 21, pad=True),
                 expand_row("synthetic+pad", trip, ent, total + (1 << 17))))
    # a list longer than a tile (TILE: 1,024 expansions) and a run of
    # 3,000 zero-count triples, more than a tile's batch of triples
    trip = expand_case(rng, 1 << 16, ent)
    trip[0][3], trip[1][3] = 0, 5_000
    for a in trip:
        a[1000:4000] = a[1000] if a is trip[3] else 0
    rows.append((dict(n=1 << 16, long_list=True), expand_row(
        "synthetic+long-list+zero-run", trip, ent, int(trip[1].sum()))))
    # 2^21 expansions into an index that fits the L2 (3,000 targets' 1 M
    # entries, 6 MB): the gathers hit the L2 instead of device memory
    small = expand_entries(rng, n_targets=3_000)
    trip = expand_case(rng, 1 << 21, small)
    rows.append((dict(n=1 << 21, l2_index=True), expand_row(
        "synthetic, L2-resident index", trip, small, int(trip[1].sum()))))
    trip, toy_ent = toy_flush()
    rows.append((dict(toy=True), expand_row(
        "toy-index flush of 128 queries", trip, toy_ent,
        int(trip[1].sum()))))
    return rows


# -- B5: the forward-backward alignment ----------------------------------------

def fwbw_bound_ms(pairs):
    """Least time of one B5 launch: FWBW_OPS_PER_CELL f32 operations a cell
    at the card's f32 rate, or its bytes (the residues of each pair in, a
    state byte a cell and 16 B of results a pair out) at its memory rate,
    whichever takes longer. Returns (ms, bound_by)."""
    cells = pairs.n_cells
    ops_s = cells * FWBW_OPS_PER_CELL / FP32_FLOPS_PER_S
    nbytes = (int(pairs.q_len.sum()) + int(pairs.t_len.sum()) + cells
              + 16 * pairs.size)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def path_value(P, t0, q0, cigar, mact=0.035):
    """MAC value of the alignment a fwbw record reports, under the (tlen,
    qlen) P, in float64, its match cells and its steps: P - mact a match
    cell, -mact/2 a gap, from the 0-based start (t0, q0) along the cigar
    (run-length or letter by letter; I moves along the query, D along the
    target). The DP's own start cell, where the backtrace stops and which
    the record leaves out, is not counted: the value is the record's, a
    little under the MAC score."""
    import re
    ops = "".join(op * int(n or 1)
                  for n, op in re.findall(r"(\d*)([MID])", cigar))
    t, q, v, cells = int(t0), int(q0), 0.0, []
    for op in ops:
        if op == "M":
            v += float(P[t, q]) - mact
            cells.append((t, q))
            t, q = t + 1, q + 1
        else:
            v -= mact / 2
            q, t = (q + 1, t) if op == "I" else (q, t + 1)
    return v, cells, len(ops)


def near_tie(p_card, p_ref, card, ref):
    """Whether two candidate alignments of one pair, the card's and the
    reference run's ((t_start, q_start, cigar) each), tie under the
    reference's P: their MAC values there lie within 1e-5 plus what the
    rounding can move one path's value against the other's, the two runs'
    P difference summed over the cells of both paths and the f32 DP's
    rounding (a half ulp of the value a step, over both paths' steps, in
    both runs). Returns (near, card's value, reference's value,
    tolerance)."""
    v_card, c1, n1 = path_value(p_ref, *card)
    v_ref, c2, n2 = path_value(p_ref, *ref)
    steps = n1 + n2
    tol = (1e-5 + sum(abs(float(p_card[c]) - float(p_ref[c]))
                      for c in set(c1) | set(c2))
           + 2 * steps * 2.0 ** -24 * max(abs(v_card), abs(v_ref)))
    return abs(v_card - v_ref) <= tol, v_card, v_ref, tol


def related_pairs(rng, submat, shapes, mut_rate=0.3):
    """(queries, targets) of residue codes for (tlen, qlen) shapes: a query
    from the background, its target the query's letters with mut_rate of
    them mutated, shifted by a few positions and cut or filled from the
    background to tlen, so that the pairs align with gaps."""
    aa_idx = np.array([submat.aa2num[c] for c in AA])
    qs, ts = [], []
    for tl, ql in shapes:
        q = aa_idx[rng.choice(20, size=int(ql), p=PBACK)]
        shift = int(rng.integers(0, 6))
        t = np.concatenate([aa_idx[rng.choice(20, size=shift, p=PBACK)],
                            q.copy()])
        mut = rng.random(len(t)) < mut_rate
        t[mut] = aa_idx[rng.choice(20, size=int(mut.sum()), p=PBACK)]
        if len(t) < tl:
            t = np.concatenate([t, aa_idx[rng.choice(
                20, size=int(tl) - len(t), p=PBACK)]])
        qs.append(q)
        ts.append(t[:int(tl)])
    return qs, ts


def fwbw_row(label, pairs, mat, reps=5):
    """B5 against its plain version on the card for one batch of pairs: P
    within rtol 1e-4, atol 1e-7 (the partition function's sums in another
    order); the kernel's MAC fed the plain P equal to the plain MAC bit for
    bit (states, score, first maximum, max P); end to end, each pair's
    first maximum and cigar equal to the plain version's but where the two
    alignments tie under the plain P (near_tie; printed); ms by CUDA events,
    the plain version's (its comparison call, timed on the host around a
    synchronisation), the bound."""
    import torch
    from mmseqs2_tpu_torch.ops import fwbw as F
    got = F.fwbw(pairs, mat, want_p=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = F.fwbw_plain(pairs, mat, want_p=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3     # the plain version once
    err = float((got["p"] - want["p"]).abs().max())
    p_close = bool(torch.allclose(got["p"], want["p"], rtol=1e-4,
                                  atol=1e-7))
    fed = F.fwbw(pairs, mat, p_in=want["p"])
    fed_equal = all(torch.equal(fed[k], want[k])
                    for k in ("bt", "score", "bi", "bj", "maxp"))
    host = lambda o: {k: o[k].cpu().numpy() for k in o}   # noqa: E731
    g, w = host(got), host(want)
    args = (pairs.cell_off.cpu().numpy(), pairs.q_len.cpu().numpy())
    gw = F.backtrace(g["bt"], *args, g["bi"], g["bj"])
    ww = F.backtrace(w["bt"], *args, w["bi"], w["bj"])
    near, bad = [], []
    for b in range(pairs.size):
        same = (g["bi"][b] == w["bi"][b] and g["bj"][b] == w["bj"][b]
                and gw["cigar"][b] == ww["cigar"][b])
        if same:
            continue
        t, q = int(pairs.t_len[b]), int(pairs.q_len[b])
        lo = int(pairs.cell_off[b])
        pc = g["p"][lo:lo + t * q].reshape(t, q)
        pr = w["p"][lo:lo + t * q].reshape(t, q)
        tie = near_tie(pc, pr, (gw["t_start"][b], gw["q_start"][b],
                                gw["cigar"][b]),
                       (ww["t_start"][b], ww["q_start"][b], ww["cigar"][b]))
        (near if tie[0] else bad).append((b, *tie[1:]))
    ms = device_ms(lambda: F.fwbw(pairs, mat), reps)
    bound, by = fwbw_bound_ms(pairs)
    # the kernel forms the pairs took (trees before the launch plan: none)
    plan = getattr(pairs, "plan", None)
    forms = plan.forms() if plan else None
    row = dict(case=f"{label}: {pairs.size} pairs, {pairs.n_cells} cells, "
               f"longest query {pairs.max_q}", forms=forms, p_close=p_close,
               max_abs_err=err, mac_fed_plain_p_equal=fed_equal,
               pairs_near_tie=len(near), pairs_differ=len(bad),
               equal=p_close and fed_equal and not bad, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               bound_share=bound / ms,
               gcells_per_s=pairs.n_cells / ms / 1e6, library_ms=None)
    log("fwbw-case " + json.dumps(row))
    for b, v_card, v_ref, tol in near:
        log(f"  near tie: pair {b}: card's alignment {v_card!r}, the plain "
            f"version's {v_ref!r} under the plain P (tolerance {tol!r})")
    if not row["equal"]:
        raise AssertionError(f"fwbw differs from its plain version: "
                             f"{row['case']} (P close {p_close}, MAC fed "
                             f"the plain P equal {fed_equal}, pairs "
                             f"{bad[:10]})")
    return row


def phase_fwbw_kernel():
    """B5 against its plain version at phase 14's commonest lengths (512
    related pairs, query and target 250-350 residues: phase 5's median is
    292), at 512 x 512 (64 pairs), on a ragged batch of 30 pairs of phase
    5's length distribution (50-2,000) with the edges 1 x 700 and 700 x 1,
    and at the edge of the kernel's two forms (128 pairs of 512-residue
    queries, a warp each, and 128 of 513, a block each; targets 100-200),
    with the command's matrix (BLOSUM62 at bit factor 2). From its own
    generator, so that the later phases' data stay those of the earlier
    runs."""
    import torch
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import fwbw as F
    rng = np.random.default_rng(SEED + 17)
    submat = get_submat("blosum62.out", 2.0, 0.0)
    mat = torch.from_numpy(np.asarray(submat.sub_matrix,
                                      np.float32)).cuda()
    cases = [
        ("commonest", rng.integers(250, 351, size=(512, 2))),
        ("512x512", np.full((64, 2), 512)),
        ("ragged", np.concatenate([lengths(rng, 60).reshape(30, 2),
                                   [[1, 700], [700, 1]]])),
        ("threshold", np.stack([rng.integers(100, 201, size=256),
                                np.repeat([512, 513], 128)], 1))]
    rows = []
    for label, shapes in cases:
        qs, ts = related_pairs(rng, submat, shapes)
        pairs = F.make_pairs(qs, ts, range(len(qs)), range(len(ts)), "cuda")
        rows.append((dict(label=label), fwbw_row(label, pairs, mat)))
    return rows


# -- CLI helpers -------------------------------------------------------------------

def run_cli(args, cpu=False):
    from mmseqs2_tpu_torch.cli import main
    env = "MMSEQS2_TPU_TORCH_DEVICE"
    old = os.environ.get(env)
    os.environ[env] = "cpu" if cpu else "cuda"
    try:
        rc = main([str(a) for a in args])
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
    if rc != 0:
        raise RuntimeError(f"command {args[0]} exited {rc}")


def entries(path):
    from mmseqs2_tpu_torch.db.reader import DBReader
    r = DBReader(str(path))
    return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def phase_golden():
    alt = GOLDEN.parent / "alt"
    qdb, pref = GOLDEN / "qdb", GOLDEN / "pref"
    for name, dbs, extra, gold in (
            ("default -a", (qdb, qdb, pref), ["-a"], GOLDEN / "aln"),
            ("blosum62 13/2", (qdb, qdb, pref),
             ["--sub-mat", "blosum62.out", "--gap-open", "13",
              "--gap-extend", "2"], GOLDEN / "aln_blosum62_13_2"),
            ("alt-ali 2", (alt / "qd", alt / "td", alt / "pf"),
             ["-a", "--alt-ali", "2", "-e", "1e5"], alt / "refalt2"),
            ("corr-score-weight 0.1", (alt / "q8", qdb, alt / "prefsub"),
             ["-a", "--corr-score-weight", "0.1", "-e", "10"],
             alt / "refcorr")):
        out = WORK / f"golden_{gold.name}"
        t0 = time.perf_counter()
        run_cli(["align", *dbs, out, *extra])
        wall = time.perf_counter() - t0
        got, want = entries(out), entries(gold)
        bad = [k for k in want if got.get(k) != want[k]]
        log(f"golden {name}: {len(want)} queries, {len(bad)} differ, "
            f"{wall:.2f} s")
        if bad or len(got) != len(want):
            raise AssertionError(f"golden parity ({name}) fails for "
                                 f"queries {bad[:10]}")


@contextlib.contextmanager
def no_sync_in_dispatch():
    """While this holds, every DevicePrefilter.match_batch_async runs with
    PyTorch told to raise on any synchronising call: a flush must be
    enqueued without one."""
    import torch
    from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
    dispatch = DevicePrefilter.match_batch_async

    def checked(self, *args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    DevicePrefilter.match_batch_async = checked
    try:
        yield
    finally:
        DevicePrefilter.match_batch_async = dispatch


def phase_golden_search():
    """The new commands on the card against the reference goldens: the
    k-mer prefilter of all 500 toy queries against themselves at the
    default sensitivity (`pref`), key by key (at -s 5.7, `it_pref_0`, it
    is phase_golden_profile's iterative search's first step),
    and easy-search of the toy FASTA against itself (`golden_self.m8`, as
    sorted lines: the output follows the result DB's data-file order)."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    qdb = GOLDEN / "qdb"
    for name, extra, gold in (("default", [], GOLDEN / "pref"),):
        out = WORK / f"golden_{gold.name}"
        prefilter_kmer.reset_stats()
        t0 = time.perf_counter()
        with no_sync_in_dispatch():
            run_cli(["prefilter", qdb, qdb, out, *extra])
        wall = time.perf_counter() - t0
        got, want = entries(out), entries(gold)
        bad = [k for k in want if got.get(k) != want[k]]
        st = prefilter_kmer.STATS
        log(f"golden prefilter {name}: {len(want)} queries, {len(bad)} "
            f"differ, {st['flushes']} flushes dispatched with 0 "
            f"synchronisations, {st['host_oracle_queries']} queries by the "
            f"host oracle, {wall:.2f} s")
        if bad or len(got) != len(want):
            raise AssertionError(f"golden parity (prefilter {name}) fails "
                                 f"for queries {bad[:10]}")
    fasta = GOLDEN / "QUERY.fasta"
    out = WORK / "golden_self.m8"
    t0 = time.perf_counter()
    run_cli(["easy-search", fasta, fasta, out, WORK / "golden_tmp"])
    wall = time.perf_counter() - t0
    got = sorted(out.read_text().splitlines())
    want = sorted((GOLDEN / "golden_self.m8").read_text().splitlines())
    n_bad = len(set(got) ^ set(want))
    log(f"golden easy-search: {len(want)} lines, {n_bad} differ, "
        f"{wall:.2f} s")
    if got != want:
        raise AssertionError("easy-search differs from golden_self.m8")


def phase_golden_nucl():
    """The nucleotide goldens (tests/golden/nucl, 61 synthetic DNA
    sequences): `search ndb ndb --search-type 3` (blastn: extractframes,
    splitsequence, the host prefilter of exact 15-mers, the banded ksw2
    aligner, offsetalignment) equal to `naln`, and `--search-type 2`
    (translated: extractorfs, then the protein prefilter and align over the
    ORFs on the card, offsetalignment) equal to `taln`, entry by entry; the
    translated search must launch diag_rescore and sw_multi, the nucleotide
    one neither. Returns the translated run's launches."""
    from mmseqs2_tpu_torch.ops import rescore, sw
    nucl = GOLDEN.parent / "nucl"
    launches = {}
    for search_type, gold in ((3, "naln"), (2, "taln")):
        sw.sw_multi.launches = rescore.diag_rescore.launches = 0
        out = WORK / f"golden_{gold}"
        t0 = time.perf_counter()
        run_cli(["search", nucl / "ndb", nucl / "ndb", out,
                 WORK / f"golden_{gold}_tmp", "--search-type", search_type])
        wall = time.perf_counter() - t0
        launches[gold] = dict(sw_multi=sw.sw_multi.launches,
                              diag_rescore=rescore.diag_rescore.launches)
        got, want = entries(out), entries(nucl / gold)
        bad = [k for k in want if got.get(k) != want[k]]
        log(f"golden search --search-type {search_type} ({gold}): "
            f"{len(want)} queries, {len(bad)} differ, launches "
            f"{launches[gold]}, {wall:.2f} s")
        if bad or len(got) != len(want):
            raise AssertionError(f"golden parity ({gold}) fails for queries "
                                 f"{bad[:10]}")
    if min(launches["taln"].values()) <= 0 or any(launches["naln"].values()):
        raise AssertionError(f"the translated search must launch both "
                             f"kernels and the nucleotide search neither: "
                             f"{launches}")
    return launches["taln"]


def sub_db(src, n, dst):
    """The first n entries of a sequence DB (and of its header DB)."""
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.db.writer import DBWriter
    for suffix in ("", "_h"):
        with DBReader(f"{src}{suffix}") as r, \
                DBWriter(f"{dst}{suffix}", r.base_type, r.extended_type) as w:
            for i in range(min(n, r.size)):
                w.write(r.get_db_key(i), r.get_data(i))
    return dst


@contextlib.contextmanager
def gpuserver(pad):
    """A resident server for the padded DB `pad`, started as a subprocess on
    the card. Yields the seconds it took to come up; on the way out it is
    asked to shut down and must exit with 0. It is killed if anything in
    between raised, and the exception goes on."""
    from mmseqs2_tpu_torch.server import device_server
    sock = device_server.socket_path_for(str(pad))
    if os.path.exists(sock):
        os.unlink(sock)         # left behind by a run that was cut
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               MMSEQS2_TPU_TORCH_DEVICE="cuda")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmseqs2_tpu_torch", "gpuserver", str(pad)],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL)
    try:
        while not os.path.exists(sock):
            if proc.poll() is not None:
                raise RuntimeError(f"gpuserver exited {proc.returncode}")
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("gpuserver did not come up in 300 s")
            time.sleep(0.05)
        yield time.perf_counter() - t0
        if not device_server.shutdown_server(str(pad)):
            raise RuntimeError("gpuserver was gone before its shutdown")
        if proc.wait(timeout=120) != 0:
            raise RuntimeError(f"gpuserver exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        if os.path.exists(sock):
            os.unlink(sock)


# A padded DB holds numeric codes, which both packages read through the ASCII
# table: every target letter becomes X and every score 0 (ROADMAP.md C). The
# runs against a padded DB open the thresholds, so that the compared entries
# hold hits.
WIDE = ["--min-ungapped-score", "-1", "-e", "1e30"]


def server_profile(rng):
    """phase_golden_exhaustive's seeded random profile (scores above 0
    against all-X targets), drawn from the main generator."""
    return rng.integers(-4, 8, size=(32, 256)).astype(np.int32)


def phase_golden_exhaustive(prof):
    """The exhaustive prefilter path on the toy set, on the card, with
    `prof` (server_profile) as the server's random profile. Returns the
    server's launches for the two commands sent through it."""
    from mmseqs2_tpu_torch.commands import prefilter_cmd
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.server import device_server
    qdb = GOLDEN / "qdb"
    out = WORK / "golden_upref"
    prefilter_cmd.reset_stats()
    t0 = time.perf_counter()
    run_cli(["ungappedprefilter", qdb, qdb, out])
    wall = time.perf_counter() - t0
    got, want = entries(out), entries(GOLDEN / "upref")
    bad = [k for k in want if got.get(k) != want[k]]
    st = prefilter_cmd.STATS
    log(f"golden ungappedprefilter: {len(want)} queries, {len(bad)} differ, "
        f"{st['hits']} hits, {st['launches']} launches and "
        f"{st['readbacks']} read-backs, {wall:.2f} s")
    if bad or len(got) != len(want):
        raise AssertionError(f"golden parity (upref) fails for queries "
                             f"{bad[:10]}")

    pad = WORK / "toy_pad"
    t0 = time.perf_counter()
    run_cli(["makepaddedseqdb", qdb, pad])
    gold = ROOT / "tests" / "golden" / "dbops" / "padded"
    bad = [suf for suf in ("", ".index", ".dbtype", ".lookup", "_h",
                           "_h.index", "_h.dbtype")
           if pathlib.Path(f"{pad}{suf}").read_bytes()
           != pathlib.Path(f"{gold}{suf}").read_bytes()]
    log(f"golden makepaddedseqdb: 7 files, {len(bad)} differ, "
        f"{time.perf_counter() - t0:.2f} s")
    if bad:
        raise AssertionError(f"makepaddedseqdb differs from the golden "
                             f"padded DB in {bad}")

    # a resident server on the padded DB: the commands through it (the
    # first 100 queries: phase 7 sends a server 1,000), and one seeded
    # random profile (scores above 0 against all-X targets) in both modes,
    # against the same work done here
    cmds = ("ungappedprefilter", "gappedprefilter")
    q100 = sub_db(qdb, 100, WORK / "toy_q100")
    with gpuserver(pad) as startup_s:
        t0 = time.perf_counter()
        for cmd in cmds:
            run_cli([cmd, q100, pad, WORK / f"toy_{cmd}_srv", "--gpu", "1",
                     *WIDE])
        srv_wall = time.perf_counter() - t0
        # the commands' launches, before the random profile's requests
        pong = device_server.ping_server(str(pad))
        srv_scores = [device_server.query_server(str(pad), prof, 251, mode)
                      for mode in (0, 1)]
    t0 = time.perf_counter()
    for cmd in cmds:
        run_cli([cmd, q100, pad, WORK / f"toy_{cmd}_loc", *WIDE])
    loc_wall = time.perf_counter() - t0
    n_lines = 0
    for cmd in cmds:
        a, b = entries(WORK / f"toy_{cmd}_srv"), entries(WORK / f"toy_{cmd}_loc")
        n_lines += sum(v.count(b"\n") for v in b.values())
        if a != b or not all(b.values()):
            raise AssertionError(f"{cmd} --gpu 1 differs from the run "
                                 f"without a server")
    store = prefilter_cmd.TargetStore(
        EncodedDB(open_seq_db(str(pad)), get_submat("blosum62.out", 2.0, 0.0)),
        "cuda")
    for mode, srv in zip((0, 1), srv_scores):
        loc = store.in_db_order(
            store.scan(prof, 251, mode, 11, 1).cpu().numpy())
        if not np.array_equal(loc, srv) or loc.max() <= 0:
            raise AssertionError(f"the server's scores (mode {mode}) differ "
                                 f"from a local scan")
    log(f"golden gpuserver: up in {startup_s:.2f} s, both commands with "
        f"--gpu 1 in {srv_wall:.2f} s equal the runs without a server "
        f"({loc_wall:.2f} s, {n_lines} lines); a random profile's scores "
        f"equal a local scan in both modes; for the commands the server "
        f"launched {json.dumps(pong['launches'])}")
    # both modes run the score-only kernels in the server
    if min(pong["launches"][k] for k in ("gapless_score", "sw_score")) <= 0:
        raise AssertionError("the server launched no gapless_score or no "
                             "sw_score kernel")

    # search --prefilter-mode 1: ungappedprefilter in the prefilter's place,
    # on the first 100 queries (a cut for time; --add-self-matches keeps
    # the self hit on scoreIdentical's route, as the same path does); its
    # first queries with the CPU requested run beside phases 3-4
    # (PM1_CPU_STEPS), and pm1_check holds them after the phase
    t0 = time.perf_counter()
    run_cli(["search", q100, qdb, WORK / "toy_search1",
             WORK / "toy_search1_tmp", "--prefilter-mode", "1",
             "--add-self-matches", "1"])
    log(f"search --prefilter-mode 1: 100 queries, "
        f"{time.perf_counter() - t0:.2f} s")
    return pong["launches"]


# search --prefilter-mode 1's CPU side (phase 4): its first PM1_CHECK
# queries, started with phase 3
PM1_CHECK = 2
PM1_CPU_STEPS = [
    ["sub_db", GOLDEN / "qdb", PM1_CHECK, WORK / "toy_q_chk"],
    ["search", WORK / "toy_q_chk", GOLDEN / "qdb", WORK / "toy_search1_cpu",
     WORK / "toy_search1_cpu_tmp", "--prefilter-mode", "1",
     "--add-self-matches", "1"]]


def pm1_check(side):
    """search --prefilter-mode 1 of phase 4 on the card against its CPU
    side: the first PM1_CHECK queries' entries equal."""
    got = entries(WORK / "toy_search1")
    cpu = entries(WORK / "toy_search1_cpu")
    bad = [k for k in cpu if cpu[k] != got.get(k)]
    log(f"search --prefilter-mode 1: {len(got)} queries, "
        f"{sum(v.count(b'\n') for v in got.values())} alignments; first "
        f"{PM1_CHECK} queries "
        f"({sum(v.count(b'\n') for v in cpu.values())} alignments) equal a "
        f"run with the CPU requested: {len(bad)} differ, CPU side "
        f"{side['cpu_s']:.2f} s")
    if bad or len(cpu) != PM1_CHECK or len(got) != 100 \
            or not all(cpu.values()):
        raise AssertionError(f"search --prefilter-mode 1 differs on the card "
                             f"and the CPU for queries {bad[:10]}")


# -- phase 4: fwbw, the alignment extras, nucleotide DBs in the exhaustive
# prefilter ---------------------------------------------------------------------

NUCL = GOLDEN.parent / "nucl"
FWBW_GOLDEN = GOLDEN.parent / "fwbw"
PAIR_FLAGS = {
    "ptop": [],
    "ptopd": ["--pairing-dummy-mode", "1"],
    "pprox": ["--pairing-filter", "1"],
    "pprox2": ["--pairing-filter", "1", "--pairing-prox-dist",
               "900000000000000000"],
    "pproxall2": ["--pairing-filter", "1", "--pairing-mode", "1",
                  "--pairing-dummy-mode", "1", "--pairing-prox-dist",
                  "900000000000000000"]}


def extra_cpu_steps():
    """This slice's phase-4 CPU side (cli_cpu_side, started with phase 3):
    `fwbw` of the golden's alnsub, the first 4 nucleotide queries'
    ungappedprefilter against nucl/ndb, the first 2 toy queries'
    gappedprefilter against it, makepaddedseqdb of it and the 4 queries
    against that padded DB."""
    nd = NUCL / "ndb"
    return [
        ["fwbw", GOLDEN / "qdb", GOLDEN / "qdb", FWBW_GOLDEN / "alnsub",
         WORK / "cpu_fw"],
        ["sub_db", nd, 4, WORK / "cpu_nq4"],
        ["ungappedprefilter", WORK / "cpu_nq4", nd, WORK / "cpu_nupref"],
        ["sub_db", GOLDEN / "qdb", 2, WORK / "cpu_q2"],
        ["gappedprefilter", WORK / "cpu_q2", nd, WORK / "cpu_ngpref",
         *WIDE],
        ["makepaddedseqdb", nd, WORK / "cpu_npad"],
        ["ungappedprefilter", WORK / "cpu_nq4", WORK / "cpu_npad",
         WORK / "cpu_npad_loc", *WIDE]]


# the goldens of commands/align_extra.py: name -> (command, input DBs,
# flags); run beside phase 4 in a subprocess with the card selected
# (alignall's sw_multi runs on the card; the others are host code), as the
# MSA goldens are
ALIGNX = GOLDEN.parent / "alignx"
PAIR = GOLDEN.parent / "pairaln"
HOST_EXTRA_GOLDENS = {
    "allaln": ("alignall", [GOLDEN / "qdb", GOLDEN / "clu0"], ["-a"]),
    "transaln": ("transitivealign", [GOLDEN / "qdb", GOLDEN / "aln"], []),
    "abk": ("alignbykmer", [GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "pref"],
            []),
    "nabk": ("alignbykmer", [NUCL / "ndb", NUCL / "ndb", ALIGNX / "nprefx"],
             []),
    **{name: ("pairaln", [PAIR / "pairq", PAIR / "tdb", PAIR / "aln"], flags)
       for name, flags in PAIR_FLAGS.items()}}


def host_extra_steps():
    """The side of HOST_EXTRA_GOLDENS: each command into
    WORK/golden_<name>."""
    return [[cmd, *dbs, WORK / f"golden_{name}", *flags]
            for name, (cmd, dbs, flags) in HOST_EXTRA_GOLDENS.items()]


def golden_differs(name):
    """Whether WORK/golden_<name> differs from its alignx/pairaln golden
    (data file and index)."""
    gold = (ALIGNX if name in ("allaln", "transaln", "abk", "nabk")
            else PAIR) / name
    return any(pathlib.Path(f"{WORK / f'golden_{name}'}{suf}").read_bytes()
               != pathlib.Path(f"{gold}{suf}").read_bytes()
               for suf in ("", ".index"))


def nucl_card_runs():
    """The nucleotide branches on the card (a subprocess beside phase 4,
    NUCL_CARD_SIDE): the first 4 queries of nucl/ndb against it
    (ungapped), the first 2 toy queries against it (gapped),
    makepaddedseqdb of it and a gpuserver on that padded DB, whose --gpu 1
    run of the 4 queries is held to the run without a server by
    extra_golden_check. Writes the launches to WORK/nucl_card.json."""
    from mmseqs2_tpu_torch.ops import gapless, sw
    from mmseqs2_tpu_torch.server import device_server
    nd = NUCL / "ndb"
    nq4 = sub_db(nd, 4, WORK / "nq4")
    run_cli(["ungappedprefilter", nq4, nd, WORK / "nupref"])
    run_cli(["gappedprefilter", sub_db(GOLDEN / "qdb", 2, WORK / "q2"), nd,
             WORK / "ngpref", *WIDE])
    run_cli(["makepaddedseqdb", nd, WORK / "npad"])
    with gpuserver(WORK / "npad"):
        run_cli(["ungappedprefilter", nq4, WORK / "npad", WORK / "npad_srv",
                 "--gpu", "1", *WIDE])
        served = device_server.ping_server(str(WORK / "npad"))["launches"]
    run_cli(["ungappedprefilter", nq4, WORK / "npad", WORK / "npad_loc",
             *WIDE])
    (WORK / "nucl_card.json").write_text(json.dumps(dict(
        gapless=gapless.gapless.launches, sw_single=sw.sw_single.launches,
        server_gapless_score=served["gapless_score"])))


NUCL_CARD_SIDE = r"""
from chip_smoke import nucl_card_runs
nucl_card_runs()
"""


def fwbw_records(path):
    """{query: {target: record fields}} of a fwbw result DB."""
    out = {}
    for k, data in entries(path).items():
        out[k] = {}
        for line in data.decode().splitlines():
            f = line.split("\t")
            out[k][int(f[0])] = f
    return out


def phase_golden_extra():
    """On the card: `fwbw` of tests/golden/fwbw/alnsub against reffw (the
    integer fields, cigar and seq-id exact, the MAC score within 3, as
    tests/test_fwbw.py holds the JAX package; extra_golden_check holds it
    to the CPU side's). The alignx, pairaln and nucleotide runs of this
    slice run in
    subprocesses beside phase 4 (HOST_EXTRA_GOLDENS, NUCL_CARD_SIDE)
    and are held by extra_golden_check. Returns fwbw's counters."""
    from mmseqs2_tpu_torch.commands import fwbw_cmd
    from mmseqs2_tpu_torch.ops import fwbw as F
    qdb = GOLDEN / "qdb"
    F.fwbw.launches = 0
    fwbw_cmd.reset_stats()
    t0 = time.perf_counter()
    run_cli(["fwbw", qdb, qdb, FWBW_GOLDEN / "alnsub", WORK / "golden_fw"])
    wall = time.perf_counter() - t0
    got, want = fwbw_records(WORK / "golden_fw"), fwbw_records(
        FWBW_GOLDEN / "reffw")
    bad = [(k, t) for k in want for t in want[k]
           if t not in got.get(k, {}) or got[k][t][2:] != want[k][t][2:]
           or abs(int(got[k][t][1]) - int(want[k][t][1])) > 3]
    log(f"golden fwbw: {len(want)} queries, {len(bad)} records differ, "
        f"{F.fwbw.launches} B5 launches, {wall:.2f} s")
    if bad or F.fwbw.launches <= 0 or set(got) != set(want):
        raise AssertionError(f"fwbw differs from reffw: {bad[:5]}")
    return dict(fwbw_cmd.STATS)


def extra_golden_check(side, host_side, nucl_side):
    """The sides of this slice's phase-4 runs: the card's `fwbw` of the
    golden against the CPU side's, every field of every record; the
    nucleotide runs on the card (NUCL_CARD_SIDE) against the CPU side's,
    every entry and the padded DB's files byte for byte, --gpu 1 equal to
    the run without a server, each run's kernels launched; and the alignx
    and pairaln goldens (HOST_EXTRA_GOLDENS), byte for byte."""
    pairs = [(WORK / a, WORK / b) for a, b in (
        ("nupref", "cpu_nupref"), ("ngpref", "cpu_ngpref"),
        ("npad_loc", "cpu_npad_loc"), ("npad_srv", "npad_loc"))]
    bad = [str(a.name) for a, b in pairs
           if entries(a) != entries(b) or not all(entries(a).values())]
    bad += [f"npad{suf}" for suf in ("", ".index", ".dbtype", "_h",
                                     "_h.index")
            if pathlib.Path(f"{WORK / 'npad'}{suf}").read_bytes()
            != pathlib.Path(f"{WORK / 'cpu_npad'}{suf}").read_bytes()]
    if fwbw_records(WORK / "golden_fw") != fwbw_records(WORK / "cpu_fw"):
        bad.append("fwbw")
    launches = json.loads((WORK / "nucl_card.json").read_text())
    gold = [name for name in HOST_EXTRA_GOLDENS if golden_differs(name)]
    log(f"phase 4 fwbw, and the nucleotide exhaustive prefilter, "
        f"makepaddedseqdb and gpuserver on the card (a subprocess, "
        f"{nucl_side['cpu_s']:.2f} s, launches {json.dumps(launches)}), "
        f"against the CPU side ({side['cpu_s']:.2f} s): {len(bad)} differ; "
        f"the alignx and "
        f"pairaln goldens (a subprocess with the card selected, "
        f"{host_side['cpu_s']:.2f} s): {len(HOST_EXTRA_GOLDENS)} outputs, "
        f"{len(gold)} differ")
    if bad or gold or min(launches.values()) <= 0:
        raise AssertionError(f"card and CPU differ: {bad}; goldens differ: "
                             f"{gold}; launches {launches}")


def phase_golden_cluster():
    """Clustering on the card against the reference goldens: `clust` in
    its three modes (clu0-clu2), `rescorediagonal` in three (resc0-resc2),
    `kmermatcher` v1 (kmpref) and v2 with three flag sets (km_*), the
    `linclust` and cascaded `cluster` workflows forced to
    --linclust-version 1 (linclu, casclu); then `createindex` of the toy DB
    and `prefilter` of all 500 queries against the prebuilt index, equal to
    the run without it (phase 4's `pref`)."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import rescore, sw
    qdb, aln, pref = GOLDEN / "qdb", GOLDEN / "aln", GOLDEN / "pref"
    cases = [(f"clust --cluster-mode {m}", ["clust", qdb, aln],
              ["--cluster-mode", m], f"clu{m}") for m in range(3)]
    cases += [(f"rescorediagonal --rescore-mode {m}",
               ["rescorediagonal", qdb, qdb, pref], ["--rescore-mode", m],
               f"resc{m}") for m in range(3)]
    cases += [("kmermatcher v1", ["kmermatcher", qdb],
               ["--linclust-version", 1], "kmpref")]
    cases += [(f"kmermatcher v2 {' '.join(flags) or 'default'}",
               ["kmermatcher", qdb], flags, gold) for flags, gold in (
                   ([], "km_default"), (["--include-adjacency", "0"], "km_ct"),
                   (["--include-count-table", "0"], "km_adj"))]
    cases += [(f"{cmd} --linclust-version 1", [cmd, qdb],
               ["--linclust-version", 1], gold)
              for cmd, gold in (("linclust", "linclu"), ("cluster", "casclu"))]
    for name, head, flags, gold in cases:
        out = WORK / f"golden_{gold}"
        tail = [WORK / f"golden_{gold}_tmp"] if head[0] in (
            "linclust", "cluster") else []
        sw_before = sw.sw_multi.launches
        rs_before = rescore.diag_rescore.launches
        t0 = time.perf_counter()
        run_cli([*head, out, *tail, *flags])
        wall = time.perf_counter() - t0
        got, want = entries(out), entries(GOLDEN / gold)
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        if head[0] == "rescorediagonal":    # the golden holds every query
            bad = [k for k in want if got.get(k) != want[k]]
        log(f"golden {name}: {len(want)} entries, {len(bad)} differ, "
            f"{wall:.2f} s (sw_multi {sw.sw_multi.launches - sw_before}, "
            f"diag_rescore {rescore.diag_rescore.launches - rs_before} "
            f"launches)")
        if bad:
            raise AssertionError(f"golden parity ({name}) fails for keys "
                                 f"{bad[:10]}")

    tdb = WORK / "toy_indexed"
    for suf in ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype"):
        shutil.copy(f"{qdb}{suf}", f"{tdb}{suf}")
    t0 = time.perf_counter()
    run_cli(["createindex", tdb, WORK / "toy_index_tmp"])
    index_s = time.perf_counter() - t0
    prefilter_kmer.reset_stats()
    t0 = time.perf_counter()
    run_cli(["prefilter", tdb, tdb, WORK / "toy_pref_indexed"])
    wall = time.perf_counter() - t0
    got, want = entries(WORK / "toy_pref_indexed"), entries(
        WORK / "golden_pref")
    bad = [k for k in want if got.get(k) != want[k]]
    log(f"golden prefilter against a createindex index: {len(want)} "
        f"queries, {len(bad)} differ from the run without it, createindex "
        f"{index_s:.2f} s, prefilter {wall:.2f} s (index load "
        f"{prefilter_kmer.STATS['index_s']:.2f} s)")
    if bad or len(got) != len(want):
        raise AssertionError(f"prefilter against the prebuilt index differs "
                             f"for queries {bad[:10]}")


def phase_golden_profile(n_queries=25, n_targets=250):
    """golden_profile_runs, and beside them, with the CPU requested, `search
    --num-iterations 2` of the toy's first n_queries against its first
    n_targets (the last iteration's own branch: its align at -e, its merge
    writing the result); then the same search on the card, whose data and
    index must equal the CPU's byte for byte."""
    q = sub_db(GOLDEN / "qdb", n_queries, WORK / "it2_q")
    t = sub_db(GOLDEN / "qdb", n_targets, WORK / "it2_t")
    side = {}
    with cli_cpu_side("search --num-iterations 2", [[
            "search", q, t, WORK / "it2_cpu", WORK / "it2_cpu_tmp",
            "--num-iterations", 2]], side):
        golden_profile_runs()
        wrappers = kernel_wrappers()
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        run_cli(["search", q, t, WORK / "it2_card", WORK / "it2_card_tmp",
                 "--num-iterations", 2])
        wall = time.perf_counter() - t0
    differ = [suf for suf in ("", ".index", ".dbtype")
              if pathlib.Path(f"{WORK / 'it2_card'}{suf}").read_bytes()
              != pathlib.Path(f"{WORK / 'it2_cpu'}{suf}").read_bytes()]
    launched = {n: w.launches - before[n] for n, w in wrappers.items()
                if w.launches != before[n]}
    n_hits = pathlib.Path(WORK / "it2_cpu").read_bytes().count(b"\n")
    log(f"search --num-iterations 2 of the toy's first {n_queries} against "
        f"its first {n_targets}: {n_hits} hits, card and CPU "
        f"{'differ in ' + str(differ) if differ else 'equal byte for byte'}"
        f", card {wall:.2f} s, CPU side {side['cpu_s']:.2f} s, launches "
        f"{json.dumps(launched)}")
    if differ or n_hits == 0 or not launched.get("diag_rescore_profile"):
        raise AssertionError(f"search --num-iterations 2 on the card: "
                             f"{differ or 'no hits or no profile rescore'}")


def golden_profile_runs():
    """The profile search on the card against the reference goldens:
    `result2profile` of the first 25 toy queries' alignments (profdb); the
    whole `search qdb qdb --num-iterations 2` with its intermediates kept,
    each step's output against its golden (pref_0: it_pref_0, prefilter
    -s 5.7; aln_0: it_aln_0, align
    --realign; profile_0: it_profile_0, result2profile; pref_tmp_1:
    it_pref_tmp_1, the profile-query prefilter; pref_1: it_pref_1,
    subtractdbs; aln_tmp_1: it_aln_tmp_1, the profile-query align) and its
    result against italn byte for byte; then
    `search` of sequences against profile targets (tprofile/refout) and
    `search --exhaustive-search` with and without its filter
    (sliced/refout, refout2). Each line gives the kernels' launches."""
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.db.writer import DBWriter
    wrappers = kernel_wrappers()
    qdb = GOLDEN / "qdb"

    def launched(before):
        return {n: w.launches - before[n] for n, w in wrappers.items()
                if w.launches != before[n]}

    def check(name, got, want, wall, launches):
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        log(f"golden {name}: {len(want)} entries, {len(bad)} differ, "
            f"{wall:.2f} s, launches {json.dumps(launches)}")
        if bad:
            raise AssertionError(f"golden parity ({name}) fails for keys "
                                 f"{bad[:10]}")

    sub = WORK / "golden_aln25"
    with DBReader(str(GOLDEN / "aln")) as r, \
            DBWriter(str(sub), dbt.DBTYPE_ALIGNMENT_RES) as w:
        for k in range(25):
            w.write(k, r.get_data(r.get_id(k)))
    before = {n: w.launches for n, w in wrappers.items()}
    t0 = time.perf_counter()
    run_cli(["result2profile", qdb, qdb, sub, WORK / "golden_profdb"])
    want = entries(GOLDEN / "profdb")
    check("result2profile (profdb)", entries(WORK / "golden_profdb"),
          {k: want[k] for k in range(25)}, time.perf_counter() - t0,
          launched(before))

    tmp = WORK / "golden_it2_tmp"
    before = {n: w.launches for n, w in wrappers.items()}
    t0 = time.perf_counter()
    with step_record() as steps:
        run_cli(["search", qdb, qdb, WORK / "golden_italn", tmp,
                 "--num-iterations", 2, "--remove-tmp-files", 0])
    wall = time.perf_counter() - t0
    log("golden search --num-iterations 2 steps " + json.dumps(
        [dict((k, r[k]) for k in ("command", "out", "s", "diag_rescore",
                                  "diag_rescore_profile", "sw_multi",
                                  "sw_multi_by_form") if k in r)
         for r in steps]))
    for out, gold in (("pref_0", "it_pref_0"), ("aln_0", "it_aln_0"),
                      ("profile_0", "it_profile_0"),
                      ("pref_tmp_1", "it_pref_tmp_1"),
                      ("pref_1", "it_pref_1"),
                      ("aln_tmp_1", "it_aln_tmp_1")):
        rec = next(r for r in steps if r["out"] == out)
        check(f"search --num-iterations 2: {out} ({gold})",
              entries(tmp / out), entries(GOLDEN / gold), rec["s"],
              {k: rec[k] for k in ("sw_multi", "diag_rescore",
                                   "diag_rescore_profile") if rec[k]})
    out = WORK / "golden_italn"
    same = [suf for suf in ("", ".index")
            if pathlib.Path(f"{out}{suf}").read_bytes()
            != (GOLDEN / f"italn{suf}").read_bytes()]
    verdict = f"differ in {same}" if same else "equal byte for byte"
    log(f"golden search --num-iterations 2 (italn): data and index "
        f"{verdict}, {wall:.2f} s, launches {json.dumps(launched(before))}")
    if same:
        raise AssertionError(f"the iterative search differs from italn "
                             f"({same})")
    if wrappers["diag_rescore_profile"].launches == before[
            "diag_rescore_profile"]:
        raise AssertionError("the profile-query prefilter launched no "
                             "diag_rescore_profile kernel")

    tp = GOLDEN.parent / "tprofile"
    sliced = GOLDEN.parent / "sliced"
    qsub = GOLDEN.parent / "fm" / "qsub"
    for name, args, gold in (
            ("search against profile targets (tprofile/refout)",
             [tp / "qs", tp / "profdb"], tp / "refout"),
            ("search --exhaustive-search (sliced/refout)",
             [qsub, GOLDEN / "it_profile_0", "--exhaustive-search", 1,
              "--exhaustive-search-filter", 0, "-a"], sliced / "refout"),
            ("search --exhaustive-search --exhaustive-search-filter 1 "
             "(sliced/refout2)",
             [qsub, GOLDEN / "it_profile_0", "--exhaustive-search", 1,
              "--exhaustive-search-filter", 1, "-a"], sliced / "refout2")):
        out = WORK / f"golden_{gold.parent.name}_{gold.name}"
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        run_cli(["search", *args[:2], out, f"{out}_tmp", *args[2:]])
        check(name, entries(out), entries(gold), time.perf_counter() - t0,
              launched(before))


def lengths(rng, n):
    return np.clip(rng.lognormal(mean=5.68, sigma=0.55, size=n), 50,
                   2000).astype(np.int64)


def write_fasta(path, names, seqs):
    aa = np.frombuffer(AA.encode(), dtype=np.uint8)
    with open(path, "w") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n{aa[s].tobytes().decode()}\n")


def family_targets(rng, n_targets, n_fam, prefix="T"):
    """SwissProt-like sequences drawn from n_fam planted families: each a
    copy of its family's ancestor with 15-45% of its letters mutated, 30%
    of them cut at both ends. Returns (sequences, names, families)."""
    ancestors = [rng.choice(20, size=int(L), p=PBACK)
                 for L in lengths(rng, n_fam)]
    tseqs, tnames, tfam = [], [], []
    for i in range(n_targets):
        f = int(rng.integers(n_fam))
        s = ancestors[f].copy()
        mut = rng.random(len(s)) < rng.uniform(0.15, 0.45)
        s[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
        if rng.random() < 0.3:
            lo = int(rng.integers(0, max(len(s) // 4, 1)))
            hi = len(s) - int(rng.integers(0, max(len(s) // 4, 1)))
            s = s[lo:max(hi, lo + 50)]
        tseqs.append(s)
        tnames.append(f"{prefix}{i}")
        tfam.append(f)
    return tseqs, tnames, tfam


def make_scale_data(rng, n_targets, n_queries):
    """SwissProt-like targets in planted families, queries as mutated
    fragments of targets plus 10% unrelated (experiments/make_scale_db.py's
    recipe). Returns per-query family (or -1) and the target families."""
    tseqs, tnames, tfam = family_targets(rng, n_targets,
                                         max(n_targets // 8, 1))
    qseqs, qnames, qfam = [], [], []
    for i in range(n_queries):
        if rng.random() < 0.1:
            qseqs.append(rng.choice(20, size=int(lengths(rng, 1)[0]),
                                    p=PBACK))
            qnames.append(f"Q{i}")
            qfam.append(-1)
            continue
        t = int(rng.integers(n_targets))
        s = tseqs[t].copy()
        mut = rng.random(len(s)) < rng.uniform(0.1, 0.35)
        s[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
        if rng.random() < 0.5 and len(s) > 120:
            lo = int(rng.integers(0, len(s) // 3))
            s = s[lo:lo + max(len(s) // 2, 100)]
        qseqs.append(s)
        qnames.append(f"Q{i}")
        qfam.append(tfam[t])
    write_fasta(WORK / "targets.fasta", tnames, tseqs)
    write_fasta(WORK / "queries.fasta", qnames, qseqs)
    return qfam, tfam


# the standard genetic code (NCBI table 1), codons in TCAG order
STANDARD_CODE = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEG"
                 "GGG")
CODONS = [a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG"]
SYNONYMS = {aa: [c for c, x in zip(CODONS, STANDARD_CODE) if x == aa]
            for aa in set(STANDARD_CODE)}
DNA_COMPLEMENT = str.maketrans("ACGT", "TGCA")
# the translated cell's DNA queries come from their own generator, drawn
# query by query: the first n of any run are the same bytes
DNA_SEED = SEED + 12


def dna_queries(n, path):
    """The first n of phase 5's protein queries back-translated into DNA
    (the translated search's queries): each codon drawn among the standard
    code's synonymous codons, a stop codon after the last, random flanks of
    0-150 nt on each side, every second query reverse-complemented; names
    are the protein queries'. Writes the FASTA file `path`."""
    rng = np.random.default_rng(DNA_SEED)
    records = (WORK / "queries.fasta").read_text().split(">")[1:n + 1]
    with open(path, "w") as f:
        for i, rec in enumerate(records):
            name, seq = rec.split("\n", 1)
            prot = seq.replace("\n", "") + "*"
            codons = [SYNONYMS[aa][int(rng.integers(len(SYNONYMS[aa])))]
                      for aa in prot]
            flanks = ["".join("ACGT"[b] for b in rng.integers(
                0, 4, size=int(rng.integers(0, 151)))) for _ in range(2)]
            dna = flanks[0] + "".join(codons) + flanks[1]
            if i % 2:
                dna = dna[::-1].translate(DNA_COMPLEMENT)
            f.write(f">{name}\n{dna}\n")
    return path


# the synthetic taxonomy's ranks from the species up, each taxid range's
# base, and the children a parent takes (about four to a genus, and so on)
TAX_RANKS = [("species", 1_000_000), ("genus", 200_000), ("family", 100_000),
             ("order", 50_000), ("class", 20_000), ("phylum", 10_000),
             ("superkingdom", 2)]
TAX_FANOUT = 4
TAX_UNMAPPED_EVERY = 20


def taxon_lineages(n_fam):
    """The synthetic taxonomy of phase 12: family f of family_targets is
    species TAX_RANKS[0][1] + f; each rank's taxon i hangs under the next
    rank's taxon i // TAX_FANOUT, the superkingdoms under the root (1).
    Returns {taxid: (parent, rank, name)}."""
    nodes = {1: (1, "no rank", "root")}
    count = n_fam
    for (rank, base), (_, up) in zip(TAX_RANKS, TAX_RANKS[1:] + [(None, 1)]):
        for i in range(count):
            parent = 1 if up == 1 else up + i // TAX_FANOUT
            nodes[base + i] = (parent, rank, f"{rank.capitalize()} {i}")
        count = (count + TAX_FANOUT - 1) // TAX_FANOUT
    return nodes


def write_taxonomy(tfam, directory):
    """NCBI dump files (names.dmp, nodes.dmp, merged.dmp, delnodes.dmp) of
    taxon_lineages and an accession-to-taxid mapping of phase 5's targets:
    target i ("T{i}") to its family's species, every TAX_UNMAPPED_EVERY-th
    target left out. Returns (dump directory, mapping file)."""
    directory.mkdir(exist_ok=True)
    nodes = taxon_lineages(max(tfam) + 1)
    with open(directory / "nodes.dmp", "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n"
                     for t, (p, r, _) in nodes.items())
    with open(directory / "names.dmp", "w") as f:
        f.writelines(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                     for t, (_, _, n) in nodes.items())
    for name in ("merged.dmp", "delnodes.dmp"):
        (directory / name).write_text("")
    mapping = directory / "acc2taxid.tsv"
    with open(mapping, "w") as f:
        f.writelines(f"T{i}\t{TAX_RANKS[0][1] + fam}\n"
                     for i, fam in enumerate(tfam)
                     if i % TAX_UNMAPPED_EVERY != TAX_UNMAPPED_EVERY - 1)
    return directory, mapping


def name_to_key(db):
    out = {}
    with open(f"{db}.lookup") as f:
        for line in f:
            key, acc, _ = line.rstrip("\n").split("\t")
            out[acc] = int(key)
    return out


def align_forms(st):
    """sw_multi's launches by form in one align run, held against the
    aligner's record: each int32 launch names the bound that ruled out the
    int16 form (the launch's longest window times its profiles' largest
    entry, or the gap open), and pick_form agrees with it."""
    from mmseqs2_tpu_torch.ops import sw
    forms = dict(sw.sw_multi.form_launches)
    bounds = st["int32_launches"]
    wrong = [b for b in bounds if sw.pick_form(
        b["window"], b["prof_max"], b["go"], b["ge"]) != "int32"]
    if len(bounds) != forms["int32"] or wrong:
        raise AssertionError(f"sw_multi's int32 launches ({forms}) and the "
                             f"aligner's record ({len(bounds)}, {wrong[:3]}) "
                             f"disagree")
    for b in {json.dumps(b, sort_keys=True) for b in bounds}:
        log(f"  int32 launch, ruled out int16 by: {b}")
    return forms


def scale_pref(rng, qdb, tdb, qfam, tfam, max_seqs):
    """Phase 5's synthetic prefilter lists, {query key: [target keys]}:
    each query's family members first, then random targets, max_seqs in
    all, drawn from rng (phase 13's CPU side replays the draws from a copy
    of the generator as phase 5 finds it)."""
    qkey, tkey = name_to_key(qdb), name_to_key(tdb)
    members = {}
    for i, f in enumerate(tfam):
        members.setdefault(f, []).append(tkey[f"T{i}"])
    all_t = np.array([tkey[f"T{i}"] for i in range(len(tfam))])
    pref = {}
    for i, f in enumerate(qfam):
        cand = list(members.get(f, []))[:max_seqs]
        seen = set(cand)
        while len(cand) < max_seqs:
            for t in rng.choice(all_t, size=max_seqs, replace=False):
                t = int(t)
                if t not in seen and len(cand) < max_seqs:
                    seen.add(t)
                    cand.append(t)
        pref[qkey[f"Q{i}"]] = cand
    return pref


def phase_real_size(rng, n_targets=N_TARGETS, n_queries=1_000, max_seqs=300,
                    n_check=16):
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.writer import DBWriter
    from mmseqs2_tpu_torch.ops import sw

    t0 = time.perf_counter()
    qfam, tfam = make_scale_data(rng, n_targets, n_queries)
    run_cli(["createdb", WORK / "queries.fasta", WORK / "qdb"])
    run_cli(["createdb", WORK / "targets.fasta", WORK / "tdb"])
    pref = scale_pref(rng, WORK / "qdb", WORK / "tdb", qfam, tfam, max_seqs)
    with DBWriter(str(WORK / "pref"), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in sorted(pref):
            w.write(k, "".join(f"{t}\t0\t0\n" for t in pref[k]).encode())
    first = sorted(pref)[:n_check]
    with DBWriter(str(WORK / "pref_check"), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in first:
            w.write(k, "".join(f"{t}\t0\t0\n" for t in pref[k]).encode())
    n_pairs = sum(len(v) for v in pref.values())
    log(f"real-size data (nothing cut): {n_targets} targets, {n_queries} "
        f"queries, {n_pairs} prefilter pairs, made in "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path: counts set to 0 just before, read just after
    aligner.reset_stats()
    sw.sw_multi.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["align", WORK / "qdb", WORK / "tdb", WORK / "pref",
             WORK / "aln", "-a"])
    wall = time.perf_counter() - t0
    launches = sw.sw_multi.launches
    st = dict(aligner.STATS)
    if launches <= 0:
        raise AssertionError("the align run launched no sw_multi kernel")
    kernel_s = st["kernel_ms"] / 1e3
    other = wall - st["scan_s"] - st["backtrace_s"]
    res = dict(
        pairs=st["pairs"], rev_pairs=st["rev_pairs"], wall_s=wall,
        host_other_s=other, scan_host_s=st["scan_s"], kernel_s=kernel_s,
        backtrace_s=st["backtrace_s"], pairs_per_s=st["pairs"] / wall,
        cells_real=st["cells_real"], cells_padded=st["cells_padded"],
        cells_computed=st["cells_computed"],
        computed_over_needed=st["cells_computed"] / st["cells_real"],
        gcups_real=st["cells_real"] / kernel_s / 1e9,
        gcups_padded=st["cells_padded"] / kernel_s / 1e9,
        launches=launches, launches_by_form=align_forms(st))
    log("real-size " + json.dumps(res))
    if st["pairs"] != n_pairs:
        raise AssertionError(f"{st['pairs']} pairs aligned, {n_pairs} "
                             f"expected")

    got = entries(WORK / "aln")
    if len(got) != n_queries or not any(got.values()):
        raise AssertionError("real-size align wrote no results")
    t0 = time.perf_counter()
    run_cli(["align", WORK / "qdb", WORK / "tdb", WORK / "pref_check",
             WORK / "aln_cpu", "-a"], cpu=True)
    cpu = entries(WORK / "aln_cpu")
    bad = [k for k in first if cpu[k] != got[k]]
    n_hits = sum(got[k].count(b"\n") for k in first)
    log(f"real-size CPU cross-check: first {n_check} queries ({n_hits} "
        f"hits), {len(bad)} differ, CPU run {time.perf_counter() - t0:.2f} s")
    if bad:
        raise AssertionError(f"card and CPU results differ for queries "
                             f"{bad[:10]}")
    return res


def device_spans_s(events):
    """Seconds in which the card ran anything (the union of the intervals
    of kernels, copies and memsets) in a chrome-trace event list, and the
    device time by name as {name: [count, seconds]}."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if t > end:
            busy += t - max(s, end)
            end = t
        k = by_name.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e.get("dur", 0.0)) / 1e6
    return busy / 1e6, by_name


def traced(fn):
    """fn() under torch.profiler with the card's activity only (what
    trace_summary reads; host events made the traces of long host-bound
    steps costly to write and read); returns the profiler and fn's wall
    seconds, the card synchronised at both ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def export_trace(prof, label):
    """A finished torch.profiler run's chrome trace, written at once (the
    next profiler session may take its device activity with it); returns
    the file's path."""
    path = WORK / f"{label}_trace.json"
    prof.export_chrome_trace(str(path))
    return path


def phase_trace(label, args, out, reference, untraced_wall, focus=None):
    """One command of a real-size phase once more, under torch.profiler,
    apart from the untraced run whose wall is the metric (trace_summary,
    with what tracing costs). The traced run must give the entries of
    `reference` (a DB) or its bytes (a flat file)."""
    prof, wall = traced(lambda: run_cli(args))
    path = export_trace(prof, label)
    if os.path.exists(f"{reference}.dbtype"):
        same = entries(out) == entries(reference)
    else:
        same = pathlib.Path(out).read_bytes() == \
            pathlib.Path(reference).read_bytes()
    if not same:
        raise AssertionError(f"the traced {label} run gave other results")
    return trace_summary(path, label, wall, untraced_wall, focus)


def trace_summary(path, label, wall, untraced_wall=None, focus=None):
    """From the exported trace (export_trace) of a torch.profiler run of
    `wall` seconds: the card's busy and idle shares of the wall, device
    time by kernel (and, for `focus`, the count and seconds of the kernels
    whose names hold it, with their share of the device time), and, given
    the wall of the same work untraced, what tracing costs."""
    with open(path) as f:
        busy, by_name = device_spans_s(json.load(f)["traceEvents"])
    path.unlink()
    if busy <= 0:
        raise AssertionError("the profiler trace holds no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    res = dict(
        traced_wall_s=wall, untraced_wall_s=untraced_wall,
        tracing_overhead=(None if untraced_wall is None
                          else wall / untraced_wall - 1),
        device_busy_s=busy, busy_share=busy / wall,
        idle_share=1 - busy / wall,
        device_s_by_name=[dict(name=n[:100], count=c, s=s)
                          for n, (c, s) in top])
    if focus:
        hit = [v for n, v in by_name.items() if focus in n]
        f_s = sum(v[1] for v in hit)
        res["focus"] = dict(name=focus, count=sum(v[0] for v in hit), s=f_s,
                            share_of_device_s=f_s / sum(
                                v[1] for v in by_name.values()))
    log(f"trace {label} " + json.dumps(res))
    return res


def m8_by_query(path):
    out = {}
    with open(path) as f:
        for line in f:
            out.setdefault(line.split("\t", 1)[0], []).append(line)
    return {q: sorted(v) for q, v in out.items()}


def phase_easy_search(check, n_queries=1_000):
    """The main path at real size: easy-search from the two FASTA files of
    phase_real_size through createdb, prefilter, align and convertalis; its
    first check['n_easy'] queries' lines held to the CPU side's easy-search
    of them (real_size_cpu_checks, phase 4)."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import expand, rescore, sw
    from mmseqs2_tpu_torch.workflow import engine

    tmp = WORK / "es_tmp"
    aligner.reset_stats()
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    # the main path: counts set to 0 just before, read just after
    sw.sw_multi.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    rescore.diag_rescore.launches = 0
    sw.sw_offset.launches = 0
    expand.posting_expand.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["easy-search", WORK / "queries.fasta", WORK / "targets.fasta",
             WORK / "es.m8", tmp, "--remove-tmp-files", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sw_multi=sw.sw_multi.launches,
                    diag_rescore=rescore.diag_rescore.launches)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the easy-search run launched no {name} "
                                 f"kernel")
    # up to 2^22 targets the main path expands its postings on the host
    if expand.posting_expand.launches:
        raise AssertionError("the easy-search run expanded its postings on "
                             "the card")
    steps = dict(engine.STEP_SECONDS)
    pst, ast = dict(prefilter_kmer.STATS), dict(aligner.STATS)
    got = m8_by_query(WORK / "es.m8")
    n_hits = sum(len(v) for v in got.values())
    res = dict(
        targets=N_TARGETS, queries=n_queries, wall_s=wall,
        queries_per_s=n_queries / wall, hits=n_hits,
        queries_with_hits=len(got), launches=launches,
        launches_sw_offset=sw.sw_offset.launches,
        createdb_s=steps["createdb"], prefilter_s=steps["prefilter"],
        align_s=steps["align"],
        convertalis_s=wall - steps["createdb"] - steps["search"],
        prefilter=dict(
            index_build_s=pst["index_s"], stage0_worker_sum_s=pst["prep_s"],
            dispatch_s=pst["dispatch_s"], wait_s=pst["wait_s"],
            write_s=pst["write_s"], flushes=pst["flushes"],
            host_oracle_queries=pst["host_oracle_queries"],
            prefilter_hits=pst["hits"]),
        align=dict(pairs=ast["pairs"], scan_host_s=ast["scan_s"],
                   kernel_s=ast["kernel_ms"] / 1e3,
                   backtrace_s=ast["backtrace_s"],
                   cells_real=ast["cells_real"],
                   cells_computed=ast["cells_computed"],
                   computed_over_needed=ast["cells_computed"]
                   / ast["cells_real"],
                   sw_multi_launches_by_form=align_forms(ast)))
    log("easy-search " + json.dumps(res))
    if pst["queries"] != n_queries or n_hits == 0:
        raise AssertionError("the easy-search run wrote no results")

    # the first queries with the CPU requested (plain versions), run
    # beside phase 4
    with open(WORK / "queries.fasta") as f:
        records = f.read().split(">")[1:]
    n_check = check["n_easy"]
    cpu = m8_by_query(check["easy_search_m8"])
    first = [r.split(None, 1)[0] for r in records[:n_check]]
    bad = [q for q in first if cpu.get(q) != got.get(q)]
    log(f"easy-search CPU cross-check: first {n_check} queries "
        f"({sum(len(v) for v in cpu.values())} lines), {len(bad)} differ, "
        f"CPU side {check['cpu_s']['easy-search']:.2f} s with phase 11's "
        f"(beside phase 4)")
    if bad or not cpu:
        raise AssertionError(f"card and CPU easy-search differ for queries "
                             f"{bad[:10]}")

    # beside the main path, not in its place: the same search against a
    # target DB indexed beforehand; then its prefilter step once more,
    # traced (the flushes are the main path's: the same index and queries;
    # a traced rerun without the index would build it once more, a cut for
    # time), which also records each flush's rescore (slots, valid
    # candidates, window lengths), work that the untraced runs whose walls
    # are the metrics do not do
    indexed = phase_index_search(res, n_queries)
    prefilter_kmer.reset_stats()
    rescore.diag_rescore.launches = 0
    prefilter_kmer.RECORD_RESCORE = True
    try:
        trace = phase_trace(
            "prefilter against the prebuilt index",
            ["prefilter", tmp / "query", WORK / "tdb",
             WORK / "pref_idx_traced", "-s", "5.7"],
            WORK / "pref_idx_traced", tmp / "search_tmp" / "pref_0",
            indexed["prefilter_s"], focus="rescore_kernel")
    finally:
        prefilter_kmer.RECORD_RESCORE = False
    trace["diag_rescore"] = rescore_record(
        prefilter_kmer.STATS["rescore"], rescore.diag_rescore.launches,
        trace["focus"])
    log("rescore-record " + json.dumps(trace["diag_rescore"]))
    indexed["trace"] = trace
    return res, trace


def phase_index_search(easy, n_queries):
    """easy-search of phase 6 once more, against the target DB indexed
    beforehand by `createindex -s 5.7` (bench.py's protocol): the index
    build's seconds beside the search's wall, and the hit lines equal to
    those of the run without the index."""
    import torch
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.workflow import engine
    tdb = WORK / "tdb"           # phase 5's createdb of targets.fasta
    t0 = time.perf_counter()
    run_cli(["createindex", tdb, WORK / "ci_tmp", "-s", "5.7"])
    index_s = time.perf_counter() - t0
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["easy-search", WORK / "queries.fasta", tdb, WORK / "es_idx.m8",
             WORK / "es_idx_tmp"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, want = m8_by_query(WORK / "es_idx.m8"), m8_by_query(WORK / "es.m8")
    bad = sorted(set(got) ^ set(want)) + [q for q in want
                                          if got.get(q) != want[q]]
    res = dict(index_s=index_s, wall_s=wall, queries_per_s=n_queries / wall,
               wall_with_index_s=wall + index_s,
               prefilter_s=engine.STEP_SECONDS["prefilter"],
               index_load_s=prefilter_kmer.STATS["index_s"],
               hits=sum(len(v) for v in got.values()),
               wall_without_index_s=easy["wall_s"])
    log("easy-search with a prebuilt index " + json.dumps(res))
    if bad:
        raise AssertionError(f"easy-search against the prebuilt index "
                             f"differs for queries {bad[:10]}")
    return res


def route_flush(n_q=128):
    """The route past the packed key on one real flush of phase 6's target
    DB: its createindex index, loaded as the prefilter loads it, and the
    first n_q queries of phase 5's query DB, prepared as the command
    prepares them, matched by the packed route and by the route: a second
    DevicePrefilter of the same index with the flag that a DB past 2^22
    targets sets (device_expansion), whose prepare_query leaves the lists
    unexpanded and whose match_batch sends the flush to posting_expand on
    the card. The hits must be the same, the packed route must upload no
    index entries, and posting_expand is held against its plain version on
    the flush's triples."""
    import torch
    from mmseqs2_tpu_torch.commands import prefilter_kmer as pk
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import expand
    from mmseqs2_tpu_torch.prefilter.device import DevicePrefilter
    from mmseqs2_tpu_torch.prefilter.index_io import (index_path_for,
                                                      load_index)
    from mmseqs2_tpu_torch.prefilter.kmer_generator import (KmerGenerator,
                                                            SubKmerScores)
    from mmseqs2_tpu_torch.prefilter.query_matcher import QueryMatcher
    table, meta = load_index(index_path_for(str(WORK / "tdb")))
    seed = get_submat("VTML80.out", 8.0, -0.2)
    ungapped = get_submat("blosum62.out", 2.0, -0.2)
    alpha, k = seed.alphabet_size - 1, table.k
    thr = pk.get_kmer_threshold(5.7, k)
    if meta.get("kmer_thr") != thr:
        raise AssertionError(f"phase 6's index has threshold "
                             f"{meta.get('kmer_thr')}, not {thr}")
    gen = KmerGenerator(
        k, alpha, SubKmerScores(seed.sub_matrix, alpha, 3).attach_disk_cache(),
        SubKmerScores(seed.sub_matrix, alpha, 2).attach_disk_cache())
    host = QueryMatcher(table, seed, ungapped, thr, k, 300, generator=gen)
    dev = DevicePrefilter(table, seed, ungapped, thr, k, 300, generator=gen,
                          host_fallback=host)
    route_dev = DevicePrefilter(table, seed, ungapped, thr, k, 300,
                                generator=gen, host_fallback=host)
    route_dev.device_expansion = True
    qdb = EncodedDB(open_seq_db(str(WORK / "qdb")), seed)
    queries = [qdb.seq_num(i) for i in range(n_q)]
    prepared = [dev.prepare_query(q) for q in queries]
    route_prepared = [route_dev.prepare_query(q) for q in queries]
    if any(p[5] is not None for p in route_prepared):
        raise AssertionError("the route's stage-0 expanded on the host")
    idents = [-1] * n_q
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = dev.match_batch(queries, idents, prepared=prepared)
    t1 = time.perf_counter()
    if dev._d_entries is not None:
        raise AssertionError("the packed route uploaded the index entries")
    expand.posting_expand.launches = 0
    route = route_dev.match_batch(queries, idents, prepared=route_prepared)
    t2 = time.perf_counter()
    launches = expand.posting_expand.launches
    bad = [b for b in range(n_q) if route[b] != packed[b]]
    trip = (np.concatenate([p[0] for p in route_prepared]),
            np.concatenate([p[1] for p in route_prepared]),
            np.concatenate([p[2] for p in route_prepared]),
            np.concatenate([np.full(len(p[1]), b, np.int32)
                            for b, p in enumerate(route_prepared)]))
    total = int(trip[1].sum())
    res = dict(queries=n_q, triples=len(trip[0]), expansions=total,
               hits=sum(map(len, route)), packed_route_s=t1 - t0,
               route_s=t2 - t1, posting_expand_launches=launches,
               entries_bytes_uploaded=sum(
                   t.numel() * t.element_size()
                   for t in route_dev._d_entries),
               host_oracle_queries=dev.host_oracle_queries
               + route_dev.host_oracle_queries)
    log("route past the packed key " + json.dumps(res))
    if bad or launches < 1:
        raise AssertionError(f"the route past the packed key differs from "
                             f"the packed route for queries {bad[:10]} "
                             f"({launches} posting_expand launches)")
    ent = (np.asarray(table.entries_seq).astype(np.int32),
           np.asarray(table.entries_pos).astype(np.uint16))
    res["kernel"] = expand_row(f"real flush of {n_q} queries on phase 6's "
                               f"index", trip, ent, total)
    return res


def split_prefilter(easy, min_splits=3):
    """Target-split mode at real size: `prefilter` of phase 5's 1,000
    queries against its 50,000 targets (phase 6's createdb DBs) at -s 5.7,
    with the --split-memory-limit under which _auto_split_count gives
    min_splits splits; every kernel's count set to 0 just before and read
    just after: the wall, each split's index build and candidate stage,
    stage-0, the merge, the bytes spilled, the device calls and the
    launches, and from a trace of the run (the card's activity only; its
    wall is the traced run's) the card's busy share and posting_expand's
    device time, beside phase 6's unsplit prefilter of the same inputs,
    whose entries (its tmp's pref_0) the run must give entry for entry."""
    from mmseqs2_tpu_torch.commands import prefilter_kmer as pk
    from mmseqs2_tpu_torch.commands.common import open_seq_db
    tmp = WORK / "es_tmp"
    treader = open_seq_db(str(tmp / "target"))
    need = int((6 + 1) * treader.total_residues() + 16 * treader.size) * 2
    limit = need // min_splits + 1
    out = WORK / "pref_split"
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    pk.reset_stats()
    # under torch.profiler: posting_expand's device time on the path
    prof, wall = traced(lambda: run_cli(
        ["prefilter", tmp / "query", tmp / "target", out, "-s", "5.7",
         "--split-memory-limit", limit]))
    trace = trace_summary(export_trace(prof, "split prefilter"),
                          "split prefilter", wall,
                          focus="posting_expand_kernel")
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    st = dict(pk.STATS)
    n_splits = len(st["split_index_s"])
    got, want = entries(out), entries(tmp / "search_tmp" / "pref_0")
    bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    res = dict(
        splits=n_splits, split_memory_limit_bytes=limit,
        index_footprint_bytes=need, queries=st["queries"], wall_s=wall,
        queries_per_s=st["queries"] / wall,
        split_index_build_s=st["split_index_s"],
        split_candidate_stage_s=st["split_candidates_s"],
        stage0_worker_sum_s=st["prep_s"], merge_s=st["split_merge_s"],
        spill_bytes=st["split_spill_bytes"], device_calls=st["flushes"],
        hits=st["hits"], launches=launches,
        posting_expand_path=dict(
            launches=trace["focus"]["count"], s=trace["focus"]["s"],
            ms_per_launch=1e3 * trace["focus"]["s"]
            / max(trace["focus"]["count"], 1)),
        busy_share=trace["busy_share"],
        spill_left=os.path.exists(f"{out}.split_tmp"),
        unsplit=dict(prefilter_s=easy["prefilter_s"],
                     index_build_s=easy["prefilter"]["index_build_s"],
                     stage0_worker_sum_s=easy["prefilter"][
                         "stage0_worker_sum_s"],
                     flushes=easy["prefilter"]["flushes"],
                     hits=easy["prefilter"]["prefilter_hits"]))
    log("split prefilter " + json.dumps(res))
    log(f"automatic target split: {n_splits} splits; entries equal to the "
        f"unsplit prefilter's: {len(want) - len(bad)} of {len(want)}")
    if n_splits < min_splits or res["spill_left"]:
        raise AssertionError(f"{n_splits} splits, spill left: "
                             f"{res['spill_left']}")
    if bad or not want:
        raise AssertionError(f"the split prefilter differs from the unsplit "
                             f"one for queries {bad[:10]}")
    for name in ("posting_expand", "diag_rescore"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the split prefilter launched no {name}")
    return res


def phase_large_db(easy):
    """Large target DBs: the route past the packed key on a real flush
    (route_flush), then target-split mode at real size (split_prefilter)."""
    return dict(route=route_flush(), split=split_prefilter(easy))


def rescore_record(log_, launches, focus):
    """The traced prefilter's diag_rescore launches: the kernel's device
    time from the trace (sum and per launch), slots and valid candidates
    per launch as the prefilter recorded them, and the distribution of
    window lengths (cells per valid candidate) from the summed
    histogram."""
    from mmseqs2_tpu_torch.prefilter.device import WINDOW_BIN
    if not len(log_) == launches == focus["count"] > 0:
        raise AssertionError(f"{launches} diag_rescore launches, "
                             f"{len(log_)} recorded, {focus['count']} "
                             f"traced")
    hist = sum(r["windows"] for r in log_)
    n = int(hist.sum())
    cum = np.cumsum(hist)
    # bin b holds windows of [b, b + 1) * WINDOW_BIN cells: a quantile is
    # given as its bin's upper end
    def quantile(p):
        return int(np.searchsorted(cum, p * n) + 1) * WINDOW_BIN
    mids = (np.arange(len(hist)) + 0.5) * WINDOW_BIN
    return dict(
        launches=launches, trace_ms_sum=focus["s"] * 1e3,
        trace_ms_per_launch=focus["s"] * 1e3 / launches,
        slots=[r["slots"] for r in log_], valid=[r["valid"] for r in log_],
        windows=dict(
            valid_candidates=n, bin_cells=WINDOW_BIN,
            mean_cells_approx=float((hist * mids).sum() / max(n, 1)),
            quantiles_le={f"p{int(p * 100)}": quantile(p) for p in
                          (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)},
            share_le={str(c): float(cum[c // WINDOW_BIN - 1] / max(n, 1))
                      for c in (32, 64, 128, 256, 512)}))


def pref_hits(data):
    """[(key, score), ...] of one prefilter entry, in its order."""
    return [(int(f[0]), int(f[1])) for f in
            (line.split(b"\t") for line in data.splitlines())]


def real_cells(qdb, tdb, n_queries=None):
    """Cells the exhaustive prefilter needs: query residues (of the first
    n_queries) times target residues."""
    from mmseqs2_tpu_torch.db.reader import DBReader
    with DBReader(str(qdb)) as q, DBReader(str(tdb)) as t:
        qres = int(q.lengths[:n_queries].sum()) - 2 * len(q.lengths[:n_queries])
        return qres * t.total_residues()


def phase_exhaustive(check, n_queries=1_000, max_seqs=300,
                     n_server_check=100):
    """This slice at real size: the exhaustive prefilter of phase 5's query
    and target DBs, locally, through a resident server and gapped; the
    first check['n_exhaustive'] queries against the first
    check['n_exhaustive_targets'] targets, and gappedprefilter of the
    first check['n_gapped'] against them, held to the CPU side's runs
    (real_size_cpu_checks, phase 4) on createdb's DBs of the same files,
    which must be phase 5's DBs byte for byte."""
    import torch
    from mmseqs2_tpu_torch.commands import prefilter_cmd
    from mmseqs2_tpu_torch.ops import gapless as gl
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.server import device_server
    qdb, tdb = WORK / "qdb", WORK / "tdb"
    wrappers = dict(gapless=gl.gapless, gapless_score=gl.gapless_score,
                    sw_single=sw.sw_single, sw_offset=sw.sw_offset,
                    sw_score=sw.sw_score)

    def zero_counts():
        prefilter_cmd.reset_stats()
        for w in wrappers.values():
            w.launches = 0
            w.form_launches = dict.fromkeys(w.form_launches, 0)
        torch.cuda.synchronize()

    def timed(args):
        t0 = time.perf_counter()
        run_cli(args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def report(label, wall, n_q, cells, extra):
        st = dict(prefilter_cmd.STATS)
        res = dict(
            queries=n_q, targets=N_TARGETS, wall_s=wall,
            queries_per_s=n_q / wall, cells_real=cells,
            gcells_per_s_end_to_end=cells / wall / 1e9, hits=st["hits"],
            cells_padded=st["cells_padded"],
            cells_computed=st["cells_computed"],
            computed_over_needed=st["cells_computed"] / cells,
            store_bytes=st["store_bytes"],
            upload_s=st["store_s"], kernel_s=st["kernel_ms"] / 1e3,
            readback_wait_s=st["wait_s"], server_s=st["server_s"],
            host_filter_write_s=st["host_s"],
            rest_s=wall - st["store_s"] - st["wait_s"] - st["server_s"]
            - st["host_s"],
            launches_per_query=st["launches"] / n_q,
            readbacks_per_query=st["readbacks"] / n_q, **extra)
        if st["kernel_ms"]:
            res["gcells_per_s_kernel"] = cells / st["kernel_ms"] / 1e6
        log(f"{label} " + json.dumps(res))
        if st["queries"] != n_q:
            raise AssertionError(f"{label}: {st['queries']} queries, {n_q} "
                                 f"expected")
        return res

    # a. ungappedprefilter, all queries: counts set to 0 just before, read
    # just after
    cells = real_cells(qdb, tdb)
    args = ["ungappedprefilter", qdb, tdb, WORK / "upref", "--max-seqs",
            max_seqs]
    zero_counts()
    wall = timed(args)
    launches = {k: w.launches for k, w in wrappers.items()}
    forms = dict(gl.gapless.form_launches)
    if launches["gapless"] <= 0:
        raise AssertionError("the ungappedprefilter run launched no gapless "
                             "kernel")
    if forms["int16"] != launches["gapless"]:
        raise AssertionError(f"the ungappedprefilter run did not launch the "
                             f"16-bit form alone: {forms}")
    ungapped = report("ungappedprefilter", wall, n_queries, cells,
                      dict(launches=launches["gapless"],
                           launches_by_form=forms))
    got = entries(WORK / "upref")
    if len(got) != n_queries or ungapped["hits"] == 0:
        raise AssertionError("the ungappedprefilter run wrote no results")

    # b. the first queries with the CPU requested (phase 4's CPU side),
    # against the first n_check_targets targets (a cut for time) and with
    # no --max-seqs cut: a pair's score does not depend on the other targets
    n_check, n_check_targets = check["n_exhaustive"], check[
        "n_exhaustive_targets"]
    for mine, theirs in ((qdb, check["x_qdb"]), (tdb, check["x_tdb"])):
        for suffix in ("", ".index", "_h", "_h.index"):
            if pathlib.Path(f"{mine}{suffix}").read_bytes() != \
                    pathlib.Path(f"{theirs}{suffix}").read_bytes():
                raise AssertionError(f"the CPU side's {theirs}{suffix} is "
                                     f"not {mine}{suffix}")
    cpu = entries(check["upref"])
    t_keys = set(entries(check["t_chk"]))
    bad, n_common = [], 0
    for k in cpu:
        card, want = pref_hits(got[k]), dict(pref_hits(cpu[k]))
        seen = {t: s for t, s in card if t in t_keys}
        n_common += len(seen)
        ok = all(want.get(t) == s for t, s in seen.items())
        if len(card) == max_seqs:       # cut: only what ranks inside counts
            last = (-abs(card[-1][1]), card[-1][0])
            want = {t: s for t, s in want.items() if (-abs(s), t) <= last}
        if not ok or want != seen:
            bad.append(k)
    log(f"ungappedprefilter CPU cross-check (cut for time: the first "
        f"{n_check} queries against the first {n_check_targets} targets): "
        f"{n_common} hits in common, {len(bad)} queries differ, CPU side "
        f"{check['cpu_s']['exhaustive prefilter']:.2f} s with the gapped "
        f"one (beside phase 4)")
    if bad or len(cpu) != n_check or n_common == 0:
        raise AssertionError(f"card and CPU ungappedprefilter differ for "
                             f"queries {bad[:10]}")

    # c. once more under the profiler
    trace = phase_trace("ungappedprefilter",
                        [*args[:3], WORK / "upref_traced", *args[4:]],
                        WORK / "upref_traced", WORK / "upref", wall)

    # d. through a resident server on the padded target DB; the server's
    # launches are its own process's, read from its ping
    pad = WORK / "tdb_pad"
    t0 = time.perf_counter()
    run_cli(["makepaddedseqdb", tdb, pad, "--mask", "0"])
    pad_s = time.perf_counter() - t0
    srv_args = ["ungappedprefilter", qdb, pad, WORK / "upref_srv",
                "--max-seqs", max_seqs, *WIDE]
    with gpuserver(pad) as startup_s:
        before = device_server.ping_server(str(pad))["launches"]
        zero_counts()
        wall_srv = timed([*srv_args, "--gpu", "1"])
        after = device_server.ping_server(str(pad))["launches"]
    srv_launches = after["gapless_score"] - before["gapless_score"]
    if srv_launches <= 0 or any(w.launches for w in wrappers.values()):
        raise AssertionError("the --gpu 1 run did not go through the "
                             "server's gapless_score kernel")
    server = report("ungappedprefilter --gpu 1", wall_srv, n_queries,
                    real_cells(qdb, pad),
                    dict(launches=srv_launches, makepaddedseqdb_s=pad_s,
                         server_startup_s=startup_s))
    q_srv = sub_db(qdb, n_server_check, WORK / "q_first")
    run_cli(["ungappedprefilter", q_srv, pad, WORK / "upref_pad_loc",
             "--max-seqs", max_seqs, *WIDE])
    loc, srv = entries(WORK / "upref_pad_loc"), entries(WORK / "upref_srv")
    bad = [k for k in loc if loc[k] != srv.get(k)]
    log(f"gpuserver cross-check: first {n_server_check} queries "
        f"({sum(v.count(b'\n') for v in loc.values())} lines) against a run "
        f"without the server, {len(bad)} differ")
    if bad or len(loc) != n_server_check or not all(loc.values()):
        raise AssertionError(f"--gpu 1 and the local run differ for queries "
                             f"{bad[:10]}")

    # e. gappedprefilter, all queries: counts set to 0 just before, read
    # just after
    g_args = ["gappedprefilter", qdb, tdb, WORK / "gpref", "--max-seqs",
              max_seqs]
    zero_counts()
    wall_g = timed(g_args)
    g_launches = sw.sw_single.launches
    g_forms = dict(sw.sw_single.form_launches)
    if g_launches <= 0:
        raise AssertionError("the gappedprefilter run launched no sw_single "
                             "kernel")
    gapped = report("gappedprefilter", wall_g, n_queries, cells,
                    dict(launches=g_launches, launches_by_form=g_forms))
    gapped_trace = phase_trace(
        "gappedprefilter", [*g_args[:3], WORK / "gpref_traced", *g_args[4:]],
        WORK / "gpref_traced", WORK / "gpref", wall_g)
    # a gapped score is at least the gapless one of the same pair
    gp, low = entries(WORK / "gpref"), 0
    for k, data in gp.items():
        un = dict(pref_hits(got[k]))
        low += sum(1 for t, s in pref_hits(data) if s < un.get(t, 0))
    # and a sub-DB run equals the CPU side's bytes
    q8 = sub_db(qdb, check["n_gapped"], WORK / "q8")
    t_chk = sub_db(tdb, n_check_targets, WORK / "t_chk")
    run_cli(["gappedprefilter", q8, t_chk, WORK / "gpref_sub", "-e", "10"])
    a, b = entries(WORK / "gpref_sub"), entries(check["gpref"])
    log(f"gappedprefilter cross-check: {low} hits score below their gapless "
        f"score; {check['n_gapped']} queries against {n_check_targets} "
        f"targets ({sum(v.count(b'\n') for v in b.values())} hits) on the "
        f"card and with the CPU requested (phase 4's CPU side): "
        f"{'equal' if a == b else 'DIFFER'}")
    if low or a != b or not any(b.values()) or gapped["hits"] == 0:
        raise AssertionError("gappedprefilter differs on the card and the "
                             "CPU")

    # f. past the store budget: the first n_server_check queries with the
    # budget forced to about an eighth of the store, so that the targets go
    # up in chunks; the entries must equal the resident runs'
    chunked = {}
    budget = ungapped["store_bytes"] // 8
    prefilter_cmd.STORE_BUDGET = budget
    try:
        for label, cmd, ref in (("ungapped", "ungappedprefilter", "upref"),
                                ("gapped", "gappedprefilter", "gpref")):
            zero_counts()
            wall_c = timed([cmd, q_srv, tdb, WORK / f"{ref}_chunked",
                            "--max-seqs", max_seqs])
            st = dict(prefilter_cmd.STATS)
            full = entries(WORK / ref)
            got_c = entries(WORK / f"{ref}_chunked")
            bad = [k for k in got_c if got_c[k] != full.get(k)]
            chunked[label] = dict(
                queries=n_server_check, budget_bytes=budget,
                chunks=st["chunks"], upload_bytes=st["store_bytes"],
                upload_s=st["store_s"], wall_s=wall_c,
                launches=st["launches"], kernel_s=st["kernel_ms"] / 1e3,
                host_s=st["host_s"], entries_differ=len(bad))
            log(f"{cmd} chunked " + json.dumps(chunked[label]))
            if bad or len(got_c) != n_server_check or st["chunks"] < 2:
                raise AssertionError(f"the chunked {cmd} differs from the "
                                     f"resident run for queries {bad[:10]}")
    finally:
        prefilter_cmd.STORE_BUDGET = None
    return dict(ungapped=ungapped, trace=trace, server=server, gapped=gapped,
                gapped_trace=gapped_trace, chunked=chunked)


@contextlib.contextmanager
def step_record(trace=None):
    """While this holds, every workflow step that runs records its command,
    its output's name, its wall seconds, and what it launched and read back
    (a step inside a step counts in both): sw_multi by form,
    diag_rescore and diag_rescore_profile, the aligner's read-backs and its
    host seconds (scan, backtrace); for a prefilter step also its route
    (the card's flushes, or the host matcher when it dispatched none), its
    index seconds, its stage-0 seconds (summed over the workers; for
    profile queries their k-mer enumeration), its dispatch and wait
    seconds, the profile bytes its flushes uploaded and the queries the
    host oracle took. A step whose output is named in `trace` (a dict:
    output name -> trace label) runs under torch.profiler (traced), its
    trace exported at once and its path under "trace_path" in its record.
    Yields the list of records."""
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import rescore, sw
    from mmseqs2_tpu_torch.workflow import engine
    step = engine.Workflow.step
    records = []
    trace = trace or {}

    pf_keys = ("index_s", "prep_s", "dispatch_s", "wait_s", "profile_bytes",
               "host_oracle_queries")

    def snap():
        return (sw.sw_multi.launches, dict(sw.sw_multi.form_launches),
                rescore.diag_rescore.launches, aligner.STATS["readbacks"],
                prefilter_kmer.STATS["flushes"],
                {k: prefilter_kmer.STATS[k] for k in pf_keys},
                rescore.diag_rescore_profile.launches,
                aligner.STATS["scan_s"], aligner.STATS["backtrace_s"])

    def recorded(self, out_db, command_name, args, par=None):
        if not engine.not_exists(out_db) and not self.force_reuse:
            return step(self, out_db, command_name, args, par)
        before = snap()
        label = trace.get(os.path.basename(out_db))
        if label:
            prof, wall = traced(lambda: step(self, out_db, command_name,
                                             args, par))
            trace_path = export_trace(prof, label)
        else:
            t0 = time.perf_counter()
            step(self, out_db, command_name, args, par)
            wall = time.perf_counter() - t0
        after = snap()
        rec = dict(
            command=command_name, out=os.path.basename(out_db),
            s=wall, sw_multi=after[0] - before[0],
            sw_multi_by_form={k: after[1][k] - before[1][k]
                              for k in after[1]},
            diag_rescore=after[2] - before[2],
            diag_rescore_profile=after[6] - before[6],
            readbacks=after[3] - before[3], scan_host_s=after[7] - before[7],
            backtrace_s=after[8] - before[8])
        if command_name == "prefilter":
            rec.update(route="card" if after[4] > before[4] else "host",
                       flushes=after[4] - before[4],
                       **{k: after[5][k] - before[5][k] for k in pf_keys})
        if label:
            rec["trace_path"] = trace_path
        records.append(rec)
    engine.Workflow.step = recorded
    try:
        yield records
    finally:
        engine.Workflow.step = step


def cluster_outputs_check(prefix, n_seqs):
    """An easy-* clustering's three files: every input sequence in exactly
    one cluster of _cluster.tsv, each representative its own member, one
    _rep_seq.fasta record a cluster, and _all_seqs.fasta a representative
    line a cluster plus every member's record. Returns the cluster count."""
    tsv = pathlib.Path(f"{prefix}_cluster.tsv").read_text().splitlines()
    pairs = [line.split("\t") for line in tsv]
    reps = {r for r, _ in pairs}
    members = [m for _, m in pairs]
    reps_fa = pathlib.Path(f"{prefix}_rep_seq.fasta").read_bytes()
    all_fa = pathlib.Path(f"{prefix}_all_seqs.fasta").read_bytes()
    if (len(members) != n_seqs or len(set(members)) != n_seqs
            or not reps <= set(members)
            or reps_fa.count(b">") != len(reps)
            or all_fa.count(b">") != n_seqs + len(reps)):
        raise AssertionError(f"{prefix}: not one cluster for every sequence "
                             f"({len(pairs)} lines, {len(reps)} clusters)")
    return len(reps)


def kernel_wrappers():
    """Every kernel's wrapper by the kernel's name; each counts its
    launches in `.launches`."""
    from mmseqs2_tpu_torch.ops import expand, gapless, rescore, sw
    return dict(sw_multi=sw.sw_multi, diag_rescore=rescore.diag_rescore,
                diag_rescore_profile=rescore.diag_rescore_profile,
                gapless=gapless.gapless, gapless_score=gapless.gapless_score,
                sw_single=sw.sw_single, sw_offset=sw.sw_offset,
                sw_score=sw.sw_score, posting_expand=expand.posting_expand)


def run_clustering(cmd, fasta, label, flags, focus=None):
    """One easy-* clustering on the card, every kernel's count set to 0
    just before and read just after: wall, sequences/s, clusters, the wall
    by step, align2clust's work (its gapped calls, their sw_multi launches
    by form and their read-backs) and each prefilter and align round's
    route, index seconds and launches. Given `focus`, the run is traced
    (torch.profiler; its wall includes what tracing costs) and its
    trace_summary is under "trace"."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import align2clust, prefilter_kmer
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.workflow import engine
    n_seqs = pathlib.Path(fasta).read_bytes().count(b">")
    aligner.reset_stats()
    align2clust.reset_stats()
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    torch.cuda.synchronize()

    def run():
        run_cli([cmd, fasta, WORK / label, WORK / f"{label}_tmp", *flags])
    with step_record() as steps:
        if focus:
            prof, wall = traced(run)
        else:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    trace_path = export_trace(prof, cmd) if focus else None
    n_clu = cluster_outputs_check(WORK / label, n_seqs)
    a2c = [r for r in steps if r["command"] == "align2clust"]
    a2c_forms = {k: sum(r["sw_multi_by_form"][k] for r in a2c)
                 for k in sw.sw_multi.form_launches}
    rounds = [dict((k, r[k]) for k in ("command", "out", "s", "route",
                                       "index_s", "flushes", "diag_rescore",
                                       "sw_multi", "readbacks") if k in r)
              for r in steps if r["command"] in ("prefilter", "align",
                                                 "rescorediagonal",
                                                 "kmermatcher")]
    res = dict(
        command=cmd, flags=flags, seqs=n_seqs, wall_s=wall,
        seqs_per_s=n_seqs / wall, clusters=n_clu,
        step_s=dict(engine.STEP_SECONDS),
        launches=dict({n: w.launches for n, w in wrappers.items()},
                      sw_multi_by_form=dict(sw.sw_multi.form_launches)),
        align2clust=dict(align2clust.STATS, runs=len(a2c),
                         s=sum(r["s"] for r in a2c),
                         sw_multi=sum(r["sw_multi"] for r in a2c),
                         sw_multi_by_form=a2c_forms,
                         readbacks=sum(r["readbacks"] for r in a2c)),
        aligner=dict(pairs=aligner.STATS["pairs"],
                     kernel_s=aligner.STATS["kernel_ms"] / 1e3,
                     scan_host_s=aligner.STATS["scan_s"],
                     backtrace_s=aligner.STATS["backtrace_s"],
                     readbacks=aligner.STATS["readbacks"]),
        rounds=rounds)
    log(f"clustering {label} " + json.dumps(res))
    if focus:
        res["trace"] = trace_summary(trace_path, cmd, wall, focus=focus)
    return res


def same_cluster_files(a, b):
    return [suf for suf in ("_cluster.tsv", "_rep_seq.fasta",
                            "_all_seqs.fasta")
            if pathlib.Path(f"{a}{suf}").read_bytes()
            != pathlib.Path(f"{b}{suf}").read_bytes()]


# MMseqs2's README example of easy-cluster (its "Clustering" section)
README_CLUSTER = ["--min-seq-id", "0.5", "-c", "0.8", "--cov-mode", "1"]


# the CPU side of phase 8's cross-check, run in a subprocess during phases
# 3 and 4
# (argv: FASTA, work directory, easy-cluster's flags)
CPU_CHECK = r"""
import sys
from mmseqs2_tpu_torch.cli import main
fasta, work, flags = sys.argv[1], sys.argv[2], sys.argv[3:]
for cmd, label, extra in (("easy-linclust", "linclust", []),
                          ("easy-cluster", "cluster", flags)):
    assert main([cmd, fasta, f"{work}/chk_{label}_cpu",
                 f"{work}/chk_{label}_cpu_tmp", *extra]) == 0
"""


def near_duplicates(seqs, n, rng):
    """n copies of sequences of `seqs`, each with 2% of its letters
    mutated; two thirds of them also take one insertion or deletion of 1-3
    letters at 30-70% of their length, so that the ungapped rescore on the
    prefilter's diagonal misses coverage and align2clust's gapped fallback
    has to accept them."""
    out = []
    for k, j in enumerate(rng.choice(len(seqs), size=n, replace=False)):
        s = seqs[j].copy()
        mut = rng.random(len(s)) < 0.02
        s[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
        if k % 3:
            at = int(len(s) * rng.uniform(0.3, 0.7))
            d = int(rng.integers(1, 4))
            s = (np.concatenate([s[:at], rng.choice(20, size=d, p=PBACK),
                                 s[at:]]) if k % 3 == 1
                 else np.concatenate([s[:at], s[at + d:]]))
        out.append(s)
    return out


@contextlib.contextmanager
def cluster_cpu_check(n_check=1_000, n_dup=100):
    """Phase 8's check set and its CPU side. The set, from its own
    generator: n_check sequences of phase 5's recipe (as many families as
    the 50,000 targets have, so that it is composed like their first
    n_check) and n_dup planted near-duplicates of them. A subprocess runs
    easy-linclust and easy-cluster on it with the CPU requested while the
    block runs (phases 3 and 4: no number of phase 4 is a metric, and
    phase 3's kernel times are the card's own, from CUDA events); leaving
    the block waits for it, so nothing measured after it runs beside it.
    Yields a dict with the set's path; `cpu_s` once done."""
    rng = np.random.default_rng(SEED + 10)
    seqs, names, _ = family_targets(rng, n_check, max(N_TARGETS // 8, 1),
                                    prefix="C")
    dups = near_duplicates(seqs, n_dup, rng)
    check = WORK / "check.fasta"
    write_fasta(check, names + [f"D{k}" for k in range(n_dup)], seqs + dups)
    out = dict(fasta=check, n_check=n_check, n_dup=n_dup)
    with cpu_side("clustering", CPU_CHECK,
                  [check, WORK, *README_CLUSTER], out):
        yield out
    log(f"clustering CPU side: {n_check} + {n_dup} sequences, "
        f"easy-linclust and easy-cluster in {out['cpu_s']:.2f} s")


@contextlib.contextmanager
def cpu_side(label, script, args, out, device="cpu"):
    """Runs `script` (python -c, argv `args`) with the CPU requested in a
    subprocess while the block runs, at the lowest priority (nice 19), so
    that the card's runs beside it keep the host's cores; leaving the block
    waits for it (sets out['cpu_s'], the seconds the script itself took)
    and raises with its stderr if it failed. The subprocess is killed if
    the block raises. device="cuda" selects the card instead (phase 4's
    host-only MSA goldens, which launch nothing)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4",
               MMSEQS2_TPU_TORCH_DEVICE=device)
    stem = WORK / f"cpu_side_{label.replace(' ', '_')}"
    timed = (f"import os as _os, time as _t\n_os.nice(19)\n"
             f"_t0 = _t.perf_counter()\n{script}\n"
             f"open({str(stem) + '.s'!r}, 'w').write("
             f"repr(_t.perf_counter() - _t0))\n")
    err_path = pathlib.Path(f"{stem}.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", timed, *map(str, args)], env=env,
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err)
    try:
        yield
        rc = proc.wait(timeout=900)
        if rc != 0:
            raise RuntimeError(f"the CPU side of the {label} cross-check "
                               f"failed (rc {rc}): "
                               + err_path.read_text()[-3000:])
        out["cpu_s"] = float(pathlib.Path(f"{stem}.s").read_text())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


# a CPU side that runs its steps one after another (argv: a JSON list of
# steps, each a CLI command's arguments or ["sub_db", src, n, dst])
CLI_CPU_CHECK = r"""
import json, sys
from chip_smoke import sub_db
from mmseqs2_tpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    if argv[0] == "sub_db":
        sub_db(argv[1], int(argv[2]), argv[3])
    else:
        assert main(argv) == 0, argv
"""


def cli_cpu_side(label, steps, out, device="cpu"):
    """cpu_side of CLI_CPU_CHECK on `steps`."""
    return cpu_side(label, CLI_CPU_CHECK,
                    [json.dumps([[str(a) for a in st] for st in steps])], out,
                    device)


@contextlib.contextmanager
def real_size_cpu_checks(rng, n_easy=32, n_iterative=16, iterations=2,
                         n_exhaustive=32, n_exhaustive_targets=500,
                         n_gapped=8, n_msa=16, n_targets=N_TARGETS,
                         n_queries=1_000):
    """The CPU sides of phases 6, 7, 9, 11, 12 and 13: phase 5's FASTA files
    made now, from a copy of the generator as phase 5 will find it (phase 5
    makes the same bytes again; its families and phase 12's taxonomy are
    kept in the yielded dict), and three subprocesses that run with the
    CPU requested while the block runs (phase 4: correctness only):
    `easy-search` of the first n_easy queries against all the targets, then
    the translated `easy-search` of the first n_easy DNA queries
    (dna_queries) against them, then `createtaxdb` of the targets and
    `easy-taxonomy -s 5.7` of the first n_easy queries, all against one
    `createindex -s 5.7` of the targets (the card's phase 6 builds its
    index inside its prefilter; phase 6 shows both routes equal);
    `search --num-iterations` of the first n_iterative, with no prebuilt
    index (the card's phase 9 loads phase 6's for iteration 0, so the two
    routes are held equal); and, on createdb's
    DBs of the two files (phase 5's bytes), `ungappedprefilter` of the
    first n_exhaustive queries against the first n_exhaustive_targets
    targets and `gappedprefilter` of the first n_gapped against them; and
    phase 13's (msa_cpu_run): `result2msa`, `msa2profile` and
    `sequence2profile --context-lib` of the first n_msa queries.
    Leaving the block waits for them. Yields a dict with their results'
    paths and, once done, their seconds."""
    import copy
    gen = copy.deepcopy(rng)
    qfam, tfam = make_scale_data(gen, n_targets, n_queries)
    dump, mapping = write_taxonomy(tfam, WORK / "taxdump")
    records = (WORK / "queries.fasta").read_text().split(">")[1:]

    def first(n):
        path = WORK / f"cpu_check_queries_{n}.fasta"
        path.write_text("".join(">" + r for r in records[:n]))
        return path

    w, tf = WORK, WORK / "targets.fasta"
    out = dict(easy_search_m8=w / "es_cpu.m8", n_easy=n_easy,
               translated_m8=w / "tr_cpu.m8", taxonomy=w / "tax_cpu",
               qfam=qfam, tfam=tfam, taxdump=dump, taxmap=mapping,
               res=w / "it_cpu_res", qdb=w / "it_cpu_q",
               n_check=n_iterative, iterations=iterations,
               x_qdb=w / "x_cpu_q", x_tdb=w / "x_cpu_t",
               t_chk=w / "x_cpu_t_chk", upref=w / "upref_cpu",
               gpref=w / "gpref_sub_cpu", n_exhaustive=n_exhaustive,
               n_exhaustive_targets=n_exhaustive_targets, n_gapped=n_gapped)
    steps = {
        "easy-search": [
            ["createdb", tf, w / "es_cpu_t"],
            ["createindex", w / "es_cpu_t", w / "es_cpu_ci", "-s", "5.7"],
            ["easy-search", first(n_easy), w / "es_cpu_t",
             out["easy_search_m8"], w / "es_cpu_tmp"],
            ["easy-search", dna_queries(
                n_easy, w / f"dna_queries_{n_easy}.fasta"), w / "es_cpu_t",
             out["translated_m8"], w / "tr_cpu_tmp"],
            ["createtaxdb", w / "es_cpu_t", w / "tax_cpu_ctmp",
             "--ncbi-tax-dump", dump, "--tax-mapping-file", mapping],
            ["easy-taxonomy", first(n_easy), w / "es_cpu_t", out["taxonomy"],
             w / "tax_cpu_tmp", "-s", "5.7"]],
        "iterative search": [
            ["createdb", first(n_iterative), out["qdb"]],
            ["createdb", tf, w / "it_cpu_t"],
            ["search", out["qdb"], w / "it_cpu_t", out["res"],
             w / "it_cpu_tmp", "--num-iterations", iterations]],
        "exhaustive prefilter": [
            ["createdb", WORK / "queries.fasta", out["x_qdb"]],
            ["createdb", tf, out["x_tdb"]],
            ["sub_db", out["x_qdb"], n_exhaustive, w / "x_cpu_q_chk"],
            ["sub_db", out["x_tdb"], n_exhaustive_targets, out["t_chk"]],
            ["sub_db", out["x_qdb"], n_gapped, w / "x_cpu_q8"],
            ["ungappedprefilter", w / "x_cpu_q_chk", out["t_chk"],
             out["upref"], "--max-seqs", 1_000_000],
            ["gappedprefilter", w / "x_cpu_q8", out["t_chk"], out["gpref"],
             "-e", 10]]}
    # phase 13's CPU side: phase 5's prefilter lists replayed from the
    # generator as phase 5 will find it, the first n_msa queries' MSAs,
    # profiles and context profiles
    spec = WORK / "msa_cpu_spec.json"
    spec.write_text(json.dumps(dict(
        state=gen.bit_generator.state, qfam=[int(f) for f in qfam],
        tfam=[int(f) for f in tfam], max_seqs=MSA_MAX_SEQS, n=n_msa,
        crf=str(context_library()))))
    out.update(msa=w / "msa_cpu", msa_profile=w / "msa_cpu_prof",
               s2p=w / "s2p_cpu", n_msa=n_msa)
    sides = {name: {} for name in [*steps, "msa"]}
    with contextlib.ExitStack() as stack:
        for name, st in steps.items():
            stack.enter_context(cli_cpu_side(name, st, sides[name]))
        stack.enter_context(cpu_side("msa", MSA_CPU_CHECK, [spec],
                                     sides["msa"]))
        yield out
    out["cpu_s"] = {name: side["cpu_s"] for name, side in sides.items()}
    log(f"real-size CPU sides: easy-search of the first {n_easy} queries "
        f"x {n_targets} targets, then the translated one of their DNA and "
        f"their easy-taxonomy, in {out['cpu_s']['easy-search']:.2f} s, "
        f"search --num-iterations {iterations} of the first {n_iterative} "
        f"in {out['cpu_s']['iterative search']:.2f} s, ungappedprefilter of "
        f"the first {n_exhaustive} x {n_exhaustive_targets} and "
        f"gappedprefilter of the first {n_gapped} in "
        f"{out['cpu_s']['exhaustive prefilter']:.2f} s, result2msa, "
        f"msa2profile and sequence2profile of the first {n_msa} in "
        f"{out['cpu_s']['msa']:.2f} s")


def iteration_steps(steps, it, last, result="it_res"):
    """The records of iteration `it`'s steps (step_record), by role; the
    last iteration's merge writes the search's `result`."""
    names = dict(pref=f"pref_{it}", pref_tmp=f"pref_tmp_{it}",
                 aln_tmp="aln_0" if it == 0 else f"aln_tmp_{it}",
                 merged=None if it == 0 else (result if last
                                              else f"aln_{it}"),
                 profile=None if last else f"profile_{it}")
    by_out = {r["out"]: r for r in steps}
    return {role: by_out.get(name) for role, name in names.items()}


def phase_iterative(check, n_queries=100, iterations=2):
    """blastpgp at real size: `search --num-iterations` of the first
    n_queries records of phase 5's queries against its targets (phase 5's
    createdb of them, with phase 6's `createindex -s 5.7` index: iteration
    0's prefilter loads it, iteration 1's builds its profile index), every
    kernel's count set to 0
    just before and read just after. Prints the wall, queries/s and, per
    iteration, hits, the prefilter's seconds (index build, stage-0 with
    the profile k-mer enumeration, dispatch, wait), its route, flushes and
    diag_rescore launches by form, the profile bytes uploaded and the
    host-oracle queries, align's seconds (scan host, backtrace) with
    sw_multi's launches by form and its read-backs, and result2profile's,
    subtractdbs' and mergedbs' seconds. Iteration 1's profile-query
    prefilter and align steps run under torch.profiler in this run (a
    rerun of the prefilter would build its index once more): busy share
    and device time by kernel. The first check['n_check'] queries' entries
    must equal the CPU side's (phase 4)."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.workflow import engine
    # the first n_queries query records (the CPU side's first ones among
    # them; createdb's keys follow no record order, so results are held
    # against the CPU side's by query name) and phase 5's target DB, which
    # phase 6 indexed
    records = (WORK / "queries.fasta").read_text().split(">")[1:]
    (WORK / "it_queries.fasta").write_text(
        "".join(">" + r for r in records[:n_queries]))
    qdb = WORK / "it_q"
    run_cli(["createdb", WORK / "it_queries.fasta", qdb])
    tdb = WORK / "tdb"
    if not os.path.exists(f"{tdb}.idx"):
        raise AssertionError("phase 6's createindex index is missing")
    # every index build of the run is counted: iteration 0 must load the
    # prebuilt index, each profile iteration builds its own
    builds = []
    build_index = prefilter_kmer.build_index

    def counted_build(*args, **kwargs):
        builds.append(1)
        return build_index(*args, **kwargs)
    tmp = WORK / "it_tmp"
    aligner.reset_stats()
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced_steps = dict(pref_tmp_1="profile-query prefilter",
                        aln_tmp_1="profile-query align")
    prefilter_kmer.build_index = counted_build
    try:
        with step_record(trace=traced_steps) as steps:
            run_cli(["search", qdb, tdb, WORK / "it_res", tmp,
                     "--num-iterations", iterations, "--remove-tmp-files", 0])
    finally:
        prefilter_kmer.build_index = build_index
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(builds) != iterations - 1:
        raise AssertionError(f"the iterative search built {len(builds)} "
                             f"indexes, not one a profile iteration: "
                             f"iteration 0 did not load phase 6's")
    launches = {n: w.launches for n, w in wrappers.items()}
    for name in ("sw_multi", "diag_rescore", "diag_rescore_profile"):
        if launches[name] <= 0:
            raise AssertionError(f"the iterative search launched no {name} "
                                 f"kernel")
    res_entries = entries(WORK / "it_res")
    per_it = []
    for it in range(iterations):
        last = it == iterations - 1
        r = iteration_steps(steps, it, last)
        pref = r["pref"] if it == 0 else r["pref_tmp"]
        aln = r["aln_tmp"]
        merged = WORK / "it_res" if last else tmp / (
            "aln_0" if it == 0 else f"aln_{it}")
        row = dict(
            iteration=it,
            hits_new=sum(v.count(b"\n") for v in entries(
                tmp / aln["out"]).values()),
            hits_total=sum(v.count(b"\n") for v in entries(
                merged).values()),
            prefilter=dict((k, pref[k]) for k in (
                "s", "route", "flushes", "index_s", "prep_s", "dispatch_s",
                "wait_s", "profile_bytes", "host_oracle_queries",
                "diag_rescore", "diag_rescore_profile")),
            align=dict((k, aln[k]) for k in (
                "s", "scan_host_s", "backtrace_s", "sw_multi",
                "sw_multi_by_form", "readbacks")))
        if it > 0:
            row["subtractdbs_s"] = r["pref"]["s"]
            row["mergedbs_s"] = r["merged"]["s"]
        if r["profile"] is not None:
            row["result2profile_s"] = r["profile"]["s"]
            row["result2profile_sw_multi"] = r["profile"]["sw_multi"]
        per_it.append(row)
    n_hits = sum(v.count(b"\n") for v in res_entries.values())
    res = dict(
        queries=n_queries, targets=N_TARGETS, iterations=iterations,
        index_builds=len(builds), wall_s=wall, queries_per_s=n_queries / wall, hits=n_hits,
        queries_with_hits=sum(1 for v in res_entries.values() if v),
        launches=dict(launches,
                      sw_multi_by_form=dict(sw.sw_multi.form_launches)),
        step_s=dict(engine.STEP_SECONDS), per_iteration=per_it,
        int32_launches=sorted({json.dumps(b, sort_keys=True) for b in
                               aligner.STATS["int32_launches"]}))
    log("iterative-search " + json.dumps(res))
    if len(res_entries) != n_queries or n_hits == 0:
        raise AssertionError("the iterative search wrote no results")

    cpu = entries(check["res"])
    cpu_key, card_key = name_to_key(check["qdb"]), name_to_key(qdb)
    bad = [name for name, k in cpu_key.items()
           if cpu[k] != res_entries.get(card_key[name])]
    log(f"iterative search CPU cross-check: first {len(cpu)} queries "
        f"({sum(v.count(b'\n') for v in cpu.values())} hits), {len(bad)} "
        f"differ; CPU side {check['cpu_s']['iterative search']:.2f} s "
        f"(beside phase 4)")
    if bad or len(cpu) != check["n_check"]:
        raise AssertionError(f"card and CPU iterative search differ for "
                             f"queries {bad[:10]}")

    # iteration 1's profile-query steps, traced in the run
    traces = {}
    for out, label in traced_steps.items():
        rec = next(r for r in steps if r["out"] == out)
        role, focus = (("prefilter", "rescore_profile_kernel")
                       if rec["command"] == "prefilter"
                       else ("align", "sw_kernel"))
        traces[role] = trace_summary(rec.pop("trace_path"), label, rec["s"],
                                     focus=focus)
    return res, traces


def phase_clustering(check, n_linclust=10_000, n_cluster=2_000):
    """Clustering at real size on phase 5's SwissProt-like targets:
    easy-linclust of the first n_linclust with the defaults, easy-cluster of
    the first n_cluster at MMseqs2's README parameters (both cuts for the
    script's time: PERF.md section 4). Then both on the check set of
    cluster_cpu_check, on the card (align2clust must accept pairs by its
    ungapped rescore and by its gapped fallback), their files equal to the
    CPU side's, the card's easy-cluster of it traced in that run (the
    check set, not the n_cluster run: a cut for time)."""
    records = (WORK / "targets.fasta").read_text().split(">")[1:]
    heads = {}
    for n in (n_linclust, n_cluster):
        heads[n] = WORK / f"targets_{n}.fasta"
        heads[n].write_text("".join(">" + r for r in records[:n]))

    lin = run_clustering("easy-linclust", heads[n_linclust], "linclust", [])
    cas = run_clustering("easy-cluster", heads[n_cluster], "cluster",
                         README_CLUSTER)
    for name, res in (("sw_multi", cas), ("diag_rescore", cas),
                      ("sw_multi", lin)):
        if res["launches"][name] <= 0:
            raise AssertionError(f"{res['command']} launched no {name} "
                                 f"kernel")

    cross = {}
    for cmd, flags in (("easy-linclust", []),
                       ("easy-cluster", README_CLUSTER)):
        label = cmd.replace("easy-", "")
        cross[label] = run_clustering(
            cmd, check["fasta"], f"chk_{label}", flags,
            focus="sw_kernel" if cmd == "easy-cluster" else None)
        bad = same_cluster_files(WORK / f"chk_{label}",
                                 WORK / f"chk_{label}_cpu")
        a2c = cross[label]["align2clust"]
        log(f"clustering CPU cross-check: {cmd} of {check['n_check']} "
            f"sequences and {check['n_dup']} planted near-duplicates, "
            f"{cross[label]['clusters']} clusters (align2clust accepted "
            f"{a2c['ungapped_accepted']} ungapped, {a2c['gapped_accepted']} "
            f"gapped), {len(bad)} of 3 files differ from the CPU side's; "
            f"card {cross[label]['wall_s']:.2f} s, CPU side of both "
            f"commands {check['cpu_s']:.2f} s (beside phases 3 and 4)")
        if bad:
            raise AssertionError(f"{cmd}: the card's and the CPU's {bad} "
                                 f"differ")
    a2c = cross["linclust"]["align2clust"]
    if a2c["gapped_accepted"] <= 0 or a2c["ungapped_accepted"] <= 0:
        raise AssertionError(f"the check set's easy-linclust did not accept "
                             f"pairs by both routes of align2clust: {a2c}")
    return dict(linclust=lin, cluster=cas, cross_check=dict(
        cross, cpu_both_s=check["cpu_s"]), trace=cross["cluster"]["trace"])


def first_lines(path):
    """The first m8 line of each query in file order (its best hit), by
    query name."""
    out = {}
    with open(path) as f:
        for line in f:
            out.setdefault(line.split("\t", 1)[0], line)
    return out


def phase_translated(check, n_queries=500, n_traced=512):
    """Translated search at real size (blastx-style, cell
    translated_es_250x50k): `easy-search` of the first n_queries of phase
    5's protein queries as DNA (dna_queries) against phase 6's target DB
    with its `createindex -s 5.7` index in place (nothing is rebuilt):
    extractorfs, the protein prefilter and align over the ORFs on the card,
    offsetalignment, convertalis; every kernel's count set to 0 just before
    and read just after. Prints the wall, queries/s (DNA queries), the ORFs
    extracted, the seconds of each step, the launches of diag_rescore and
    sw_multi and their device time (the aligner's CUDA events for sw_multi;
    diag_rescore's a launch from a traced rerun of the prefilter on the
    first n_traced ORFs, times its launches), and the
    share of the queries whose best target is phase 6's for the same
    protein query. The first check['n_easy'] queries' lines must equal the
    CPU side's (phase 4), by query name."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.workflow import engine
    fasta = dna_queries(n_queries, WORK / "dna_queries.fasta")
    tdb, tmp, out = WORK / "tdb", WORK / "tr_tmp", WORK / "tr.m8"
    if not os.path.exists(f"{tdb}.idx"):
        raise AssertionError("phase 6's createindex index is missing")
    aligner.reset_stats()
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    build_index = prefilter_kmer.build_index

    def no_build(*args, **kwargs):
        raise AssertionError("the translated search rebuilt the target "
                             "index instead of loading phase 6's")
    prefilter_kmer.build_index = no_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        run_cli(["easy-search", fasta, tdb, out, tmp,
                 "--remove-tmp-files", 0])
        torch.cuda.synchronize()
    finally:
        prefilter_kmer.build_index = build_index
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    require_launches(launches, ("sw_multi", "diag_rescore"),
                     "the translated easy-search")
    steps = dict(engine.STEP_SECONDS)
    pst, ast = dict(prefilter_kmer.STATS), dict(aligner.STATS)
    orfs = entries(tmp / "search_tmp" / "q_orfs_aa")
    got = m8_by_query(out)
    n_hits = sum(len(v) for v in got.values())
    res = dict(
        card=card_line(), queries=n_queries, targets=N_TARGETS, wall_s=wall,
        queries_per_s=n_queries / wall, orfs=len(orfs),
        orf_residues=sum(len(v) - 1 for v in orfs.values()), hits=n_hits,
        queries_with_hits=len(got),
        step_s={k: steps[k] for k in (
            "createdb", "extractorfs", "prefilter", "align",
            "offsetalignment")},
        convertalis_s=wall - steps["createdb"] - steps["search"],
        launches=dict(diag_rescore=launches["diag_rescore"],
                      sw_multi=launches["sw_multi"],
                      sw_multi_by_form=dict(sw.sw_multi.form_launches),
                      others={n: v for n, v in launches.items()
                              if n not in ("diag_rescore", "sw_multi")}),
        prefilter=dict(index_load_s=pst["index_s"],
                       stage0_worker_sum_s=pst["prep_s"],
                       dispatch_s=pst["dispatch_s"], wait_s=pst["wait_s"],
                       flushes=pst["flushes"],
                       host_oracle_queries=pst["host_oracle_queries"],
                       prefilter_hits=pst["hits"]),
        align=dict(pairs=ast["pairs"], scan_host_s=ast["scan_s"],
                   sw_multi_device_s=ast["kernel_ms"] / 1e3,
                   backtrace_s=ast["backtrace_s"],
                   readbacks=ast["readbacks"]))
    if n_hits == 0:
        raise AssertionError("the translated easy-search wrote no results")

    # the best target of each DNA query against phase 6's best target for
    # the same protein query (printed, not a gate: the ORF's flanks and
    # the other frames' ORFs may rank a target of the same family first)
    best, best_prot = first_lines(out), first_lines(WORK / "es.m8")
    names = [r.split(None, 1)[0] for r in fasta.read_text().split(">")[1:]]
    same = sum(1 for q in names if q in best and q in best_prot
               and best[q].split("\t")[1] == best_prot[q].split("\t")[1])
    res["best_target_as_protein_search"] = same / n_queries

    # the prefilter step once more on the first n_traced ORFs, traced:
    # diag_rescore's device time a launch (a cut for time: the whole step
    # again would cost its wall once more)
    orf_db = tmp / "search_tmp" / "q_orfs_aa"
    sub = sub_db(orf_db, n_traced, WORK / "tr_orfs_sub")
    prefilter_kmer.reset_stats()
    prof, traced_wall = traced(lambda: run_cli(
        ["prefilter", sub, tdb, WORK / "tr_pref_traced", "-s", "5.7"]))
    path = export_trace(prof, "translated prefilter")
    full = entries(tmp / "search_tmp" / "pref")
    part = entries(WORK / "tr_pref_traced")
    if part != {k: full[k] for k in entries(sub)}:
        raise AssertionError("the traced translated prefilter gave other "
                             "results")
    trace = trace_summary(path, f"translated prefilter, first {n_traced} "
                          f"ORFs", traced_wall, focus="rescore_kernel")
    n_traced_launches = trace["focus"]["count"]
    res["diag_rescore_trace"] = dict(
        orfs=len(part), launches=n_traced_launches,
        ms_per_launch=1e3 * trace["focus"]["s"] / max(n_traced_launches, 1),
        busy_share=trace["busy_share"], traced_wall_s=traced_wall)
    res["diag_rescore_device_s_estimate"] = (
        res["diag_rescore_trace"]["ms_per_launch"] / 1e3
        * launches["diag_rescore"])
    log("translated-search " + json.dumps(res))

    n_check = check["n_easy"]
    cpu = m8_by_query(check["translated_m8"])
    bad = [q for q in names[:n_check] if cpu.get(q) != got.get(q)]
    log(f"translated search CPU cross-check: first {n_check} queries "
        f"({sum(len(v) for v in cpu.values())} lines), {len(bad)} differ")
    if bad or not cpu:
        raise AssertionError(f"card and CPU translated search differ for "
                             f"queries {bad[:10]}")
    return res


def require_launches(launches, names, what):
    """Raise unless each kernel of `names` launched in the run `what`."""
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what} launched no {name} kernel")


def lca_assignments(path, qfam, n_fam):
    """phase 12's assignments against the planted families: each query of
    the _lca.tsv file by the rank of its taxon, and the shares of the
    queries with a planted family assigned its species, or a taxon above
    it on its lineage (genus to superkingdom), or off its lineage, or
    nothing; the unrelated queries (family -1) assigned anything."""
    nodes = taxon_lineages(n_fam)
    by_rank, right, above, wrong, none, unrelated = {}, 0, 0, 0, 0, 0
    lines = pathlib.Path(path).read_text().splitlines()
    for line in lines:
        name, taxid, rank = line.split("\t")[:3]
        by_rank[rank] = by_rank.get(rank, 0) + 1
        fam = qfam[int(name[1:])]
        taxid = int(taxid)
        if fam < 0:
            unrelated += taxid != 0
            continue
        lineage, t = [], TAX_RANKS[0][1] + fam
        while t != 1:
            lineage.append(t)
            t = nodes[t][0]
        if taxid == 0:
            none += 1
        elif taxid == lineage[0]:
            right += 1
        elif taxid in lineage:
            above += 1
        else:
            wrong += 1
    planted = sum(1 for f in qfam if f >= 0)
    return dict(lines=len(lines), by_rank=by_rank,
                right_species=right / planted,
                right_genus_or_above=above / planted,
                off_lineage=wrong / planted, unassigned=none / planted,
                unrelated_assigned=unrelated)


def phase_taxonomy(check, n_queries):
    """Taxonomy at real size (cell taxonomy_es_1000x50k): `createtaxdb` of
    phase 6's target DB with the synthetic taxonomy that phase 4 wrote
    (write_taxonomy: a species a planted family), then `easy-taxonomy -s
    5.7` of phase 5's first n_queries queries against it, phase 6's
    `createindex -s 5.7` index in place (a rebuild raises; the taxonomy's
    own default, -s 2, would rebuild it: a cut for time), the other
    taxonomy defaults kept (--lca-mode 3: search --lca-search runs
    lcaalign's three waves on the card; --max-accept 30, --max-rejected
    5); every kernel's count set to 0 just before and read just after.
    Prints the wall, queries/s, each step's seconds, the prefilter's and
    lcaalign's launches and read-backs (step_record), lcaalign's pairs by
    wave (those its loops reached, and all it computed), and the
    assignments by rank against the planted species. Every query has one
    _lca.tsv line; the first check['n_easy'] queries' _lca.tsv and
    _tophit_aln lines must equal the CPU side's (phase 4), by name."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import align_cmd, prefilter_kmer
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.workflow import engine
    tdb, tmp, prefix = WORK / "tdb", WORK / "tax_tmp", WORK / "tax"
    if not os.path.exists(f"{tdb}.idx"):
        raise AssertionError("phase 6's createindex index is missing")
    fasta = WORK / "tax_queries.fasta"
    records = (WORK / "queries.fasta").read_text().split(">")[1:]
    fasta.write_text("".join(">" + r for r in records[:n_queries]))
    t0 = time.perf_counter()
    run_cli(["createtaxdb", tdb, WORK / "tax_ctmp", "--ncbi-tax-dump",
             check["taxdump"], "--tax-mapping-file", check["taxmap"]])
    createtaxdb_s = time.perf_counter() - t0

    aligner.reset_stats()
    prefilter_kmer.reset_stats()
    align_cmd.reset_lca_stats()
    engine.STEP_SECONDS.clear()
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches, 0)
    build_index = prefilter_kmer.build_index

    def no_build(*args, **kwargs):
        raise AssertionError("the taxonomy search rebuilt the target index "
                             "instead of loading phase 6's")
    prefilter_kmer.build_index = no_build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with step_record() as steps:
            run_cli(["easy-taxonomy", fasta, tdb, prefix, tmp, "-s", "5.7",
                     "--remove-tmp-files", 0])
        torch.cuda.synchronize()
    finally:
        prefilter_kmer.build_index = build_index
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    require_launches(launches, ("sw_multi", "diag_rescore"),
                     "the easy-taxonomy run")
    # by command: the search's record and its align step's share a name
    by_cmd = {r["command"]: r for r in steps}
    keep = ("s", "sw_multi", "sw_multi_by_form", "diag_rescore",
            "readbacks", "scan_host_s", "backtrace_s")
    res = dict(
        card=card_line(), queries=n_queries, targets=N_TARGETS, wall_s=wall,
        queries_per_s=n_queries / wall, createtaxdb_s=createtaxdb_s,
        step_s=dict(engine.STEP_SECONDS),
        prefilter={k: by_cmd["prefilter"][k] for k in keep + (
            "route", "flushes", "index_s", "prep_s", "dispatch_s",
            "wait_s")},
        lcaalign={k: by_cmd["lcaalign"][k] for k in keep},
        lca_pairs_by_wave=dict(align_cmd.LCA_STATS),
        launches=dict(diag_rescore=launches["diag_rescore"],
                      sw_multi=launches["sw_multi"],
                      sw_multi_by_form=dict(sw.sw_multi.form_launches),
                      others={n: v for n, v in launches.items()
                              if n not in ("diag_rescore", "sw_multi")}),
        readbacks=aligner.STATS["readbacks"],
        sw_multi_device_s=aligner.STATS["kernel_ms"] / 1e3,
        assigned=lca_assignments(f"{prefix}_lca.tsv",
                                 check["qfam"][:n_queries],
                                 max(check["tfam"]) + 1))
    log("taxonomy " + json.dumps(res))
    if res["assigned"]["lines"] != n_queries:
        raise AssertionError(f"easy-taxonomy wrote "
                             f"{res['assigned']['lines']} _lca.tsv lines "
                             f"for {n_queries} queries")

    names = [r.split(None, 1)[0] for r in records[:check["n_easy"]]]
    for suffix in ("_lca.tsv", "_tophit_aln"):
        got = m8_by_query(f"{prefix}{suffix}")
        cpu = m8_by_query(f"{check['taxonomy']}{suffix}")
        bad = [q for q in names if cpu.get(q) != got.get(q)]
        log(f"taxonomy CPU cross-check, {suffix}: first {len(names)} "
            f"queries ({sum(len(v) for v in cpu.values())} lines), "
            f"{len(bad)} differ")
        if bad or not cpu:
            raise AssertionError(f"card and CPU easy-taxonomy differ in "
                                 f"{suffix} for queries {bad[:10]}")
    return res


# -- phase 4's MSA goldens ----------------------------------------------------

def msa_test_helpers():
    """tests/test_torch_msa.py's input helpers (build_ca3m, enrich_inputs,
    sub_results, first_entries), shared with the CPU tests."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_msa
    return test_torch_msa


def msa_host_goldens():
    """The MSA and profile tools against the reference goldens that the
    JAX package's tests use, every one on the toy's whole input (phase 4's
    host-only side: these commands launch nothing). Writes each golden's
    verdict and seconds to WORK/msa_host_goldens.json and raises if any
    differs."""
    from mmseqs2_tpu_torch.db import dbtype as dbt
    h = msa_test_helpers()
    g, util, out = GOLDEN.parent, GOLDEN / "util", WORK / "msa_goldens"
    out.mkdir(exist_ok=True)
    for suf in (".tsv", "_h.tsv", "_seq.tsv", "_aln.tsv"):
        shutil.copy(g / "convert" / f"exin{suf}", out / f"exin{suf}")
    ca3m = h.build_ca3m(out / "ca3m")

    def db(path, sufs=("", ".index")):
        return [pathlib.Path(f"{path}{s}").read_bytes() for s in sufs]

    cases = [
        ("result2msa (refmsa)", ["result2msa", GOLDEN / "qdb",
                                 GOLDEN / "qdb", GOLDEN / "it_aln_0",
                                 out / "msa"],
         lambda: db(out / "msa") == db(util / "refmsa")),
        ("result2msa a3m (refa3m)",
         ["result2msa", GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "it_aln_0",
          out / "a3m", "--msa-format-mode", 5],
         lambda: db(out / "a3m") == db(util / "refa3m"))]
    for mode, gold in ((0, "refm2p"), (1, "refm2p1")):
        cases.append((f"msa2profile --match-mode {mode} ({gold})",
                      ["msa2profile", util / "refmsa", out / gold,
                       "--match-mode", mode],
                      lambda gold=gold: db(out / gold, ("", ".index",
                                                        ".dbtype"))
                      == db(util / gold, ("", ".index", ".dbtype"))))
    cases += [
        ("profile2pssm (refpssm.tsv)",
         ["profile2pssm", GOLDEN / "it_profile_0", out / "pssm.tsv"],
         lambda: db(out / "pssm.tsv", ("",)) == db(util / "refpssm.tsv",
                                                   ("",)))]
    for cmd, gold in (("profile2consensus", "refcons"),
                      ("profile2repseq", "refrep")):
        cases.append((f"{cmd} ({gold})", [cmd, GOLDEN / "it_profile_0",
                                          out / gold],
                      lambda gold=gold: db(out / gold) == db(util / gold)))
    for extra, gold in ((["--expansion-mode", 0], GOLDEN / "exp_aln"),
                        (["--expansion-mode", 1], GOLDEN / "exp_aln_rescore"),
                        (["--expand-filter-clusters", 1],
                         g / "efc" / "refefc")):
        cases.append((f"expandaln {' '.join(map(str, extra))} ({gold.name})",
                      ["expandaln", GOLDEN / "qdb", GOLDEN / "qdb",
                       GOLDEN / "aln", GOLDEN / "aln", out / gold.name,
                       *extra],
                      lambda gold=gold: entries(out / gold.name)
                      == entries(gold)))
    cases += [
        ("expand2profile (exp_prof)",
         ["expand2profile", GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "aln",
          GOLDEN / "aln", out / "exp_prof"],
         lambda: entries(out / "exp_prof") == entries(GOLDEN / "exp_prof")),
        ("filtera3m (bigfilt.a3m)",
         ["filtera3m", g / "msares" / "big.a3m", out / "filt.a3m",
          "--max-seq-id", 0.9, "--diff", 5],
         lambda: db(out / "filt.a3m", ("",))
         == db(g / "msares" / "bigfilt.a3m", ("",))),
        ("result2msa of aln (for msa2result)",
         ["result2msa", GOLDEN / "qdb", GOLDEN / "qdb", GOLDEN / "aln",
          out / "aln_msa"], lambda: True),
        ("msa2result --match-mode 1 (m2r_*)",
         ["msa2result", out / "aln_msa", out / "m2r_seq", out / "m2r_res",
          "--match-mode", 1],
         lambda: all(db(out / n) == db(g / "msares" / n)
                     for n in ("m2r_res", "m2r_seq", "m2r_seq_h")))]
    for mode, gold in ((2, "refdeld"), (5, "refdeld5")):
        d = g / "msadel"
        cases.append((f"result2msa --allow-deletion, mode {mode} ({gold})",
                      ["result2msa", d / "dqd", d / "dtd", d / "daln",
                       out / gold, "--msa-format-mode", mode,
                       "--allow-deletion"],
                      lambda gold=gold, d=d: db(out / gold, ("",))
                      == db(d / gold, ("",))))
    conv = g / "convert"
    cases += [
        ("convertca3m (convca3m)", ["convertca3m", ca3m, out / "convca3m"],
         lambda: db(out / "convca3m") == db(g / "domain" / "convca3m")),
        ("profile2neff (neff.txt)",
         ["profile2neff", g / "tprofile" / "profdb", out / "neff.txt"],
         lambda: db(out / "neff.txt", ("",))
         == db(g / "dbops" / "neff.txt", ("",))),
        ("convertmsa (refmsa)", ["convertmsa", conv / "test.sto",
                                 out / "cmsa"],
         lambda: db(out / "cmsa") == db(conv / "refmsa")),
        ("convertmsa --identifier-field 0 (refmsa0)",
         ["convertmsa", conv / "test.sto", out / "cmsa0",
          "--identifier-field", 0],
         lambda: db(out / "cmsa0") == db(conv / "refmsa0")),
        ("convertprofiledb (refprof)",
         ["convertprofiledb", conv / "hhmdb", out / "cprof"],
         lambda: db(out / "cprof") == db(conv / "refprof")
         and db(out / "cprof_h") == db(conv / "refprof_h")
         and db(out / "cprof", (".dbtype",))
         == db(conv / "refprof", (".dbtype",))),
        ("tsv2exprofiledb (refex*)", ["tsv2exprofiledb", out / "exin",
                                      out / "ex"],
         lambda: all(db(f"{out / 'ex'}{suf}") == db(conv / f"refex{suf}")
                     for suf in ("", "_aln", "_seq", "_seq_h")))]
    verdicts = []
    import importlib.util
    if importlib.util.find_spec("zstandard") is None:
        # its golden is compressed, and the DB writer compresses with
        # zstandard, which this machine lacks; tests/test_torch_convert.py
        # holds it on the CPU
        cases = [c for c in cases if c[1][0] != "tsv2exprofiledb"]
        verdicts.append(dict(golden="tsv2exprofiledb (refex*)", s=0.0,
                             equal=None, not_run="no zstandard module"))
    for name, args, same in cases:
        t0 = time.perf_counter()
        run_cli(args)
        verdicts.append(dict(golden=name, s=time.perf_counter() - t0,
                             equal=bool(same())))
    (WORK / "msa_host_goldens.json").write_text(json.dumps(verdicts))
    bad = [v["golden"] for v in verdicts if v["equal"] is False]
    if bad:
        raise AssertionError(f"MSA goldens differ: {bad}")


MSA_HOST_GOLDENS = r"""
from chip_smoke import msa_host_goldens
msa_host_goldens()
"""


@contextlib.contextmanager
def msa_golden_sides():
    """Phase 4's MSA path: its inputs, and two subprocesses at nice 19 while
    the block runs (phases 3 and 4: none of their seconds is a metric, and
    phase 3's kernel times are the card's own, from CUDA events):
    msa_host_goldens with the card selected (host code only), and with the
    CPU requested the runs that phase_golden_msa makes on the card:
    `result2msa` of the toy's alignments with their backtraces stripped
    (every hit aligned again) and `enrich` of three toy queries (one
    iteration; tests/test_torch_msa.py's inputs). Yields a dict of the
    inputs and the CPU side's outputs; leaving the block waits for both
    sides."""
    h = msa_test_helpers()
    w = WORK / "msa_golden"
    w.mkdir(exist_ok=True)
    strip = h.sub_results(GOLDEN / "aln", sorted(entries(GOLDEN / "aln")),
                          w / "strip", strip=True)
    q, tprof = h.enrich_inputs(w)
    out = dict(strip=strip, q=q, tprof=tprof, strip_cpu=w / "strip_cpu",
               enrich_cpu=w / "enrich_cpu")
    steps = [["result2msa", GOLDEN / "qdb", GOLDEN / "qdb", strip,
              out["strip_cpu"]],
             ["enrich", q, GOLDEN / "qdb", tprof, GOLDEN / "aln",
              out["enrich_cpu"], w / "enrich_cpu_tmp", "--num-iterations",
              1]]
    host = {}
    with cli_cpu_side("msa goldens", steps, out), \
            cpu_side("msa host goldens", MSA_HOST_GOLDENS, [], host,
                     device="cuda"):
        yield out
    out["host_s"] = host["cpu_s"]
    for v in json.loads((WORK / "msa_host_goldens.json").read_text()):
        verdict = ("not run: " + v["not_run"] if "not_run" in v
                   else "equal" if v["equal"] else "DIFFERS")
        log(f"golden {v['golden']} (host code, the card selected): "
            f"{verdict}, {v['s']:.2f} s")


def phase_golden_msa(side):
    """On the card, beside msa_golden_sides: `result2msa` of the toy's
    alignments with their backtraces stripped (the realignment through
    sw_multi, blocks of 256 queries) and `enrich` of three toy queries, one
    iteration (search against the profile targets, result2profile, the
    profile prefilter and align, expandaln), each with its launches;
    msa_golden_check holds them to the CPU side once it is done."""
    from mmseqs2_tpu_torch.commands import msa_tools
    wrappers = kernel_wrappers()
    w = WORK / "msa_golden"

    def launched(before):
        return {n: v.launches - before[n] for n, v in wrappers.items()
                if v.launches != before[n]}

    res = {}
    before = {n: v.launches for n, v in wrappers.items()}
    msa_tools.reset_stats()
    t0 = time.perf_counter()
    run_cli(["result2msa", GOLDEN / "qdb", GOLDEN / "qdb", side["strip"],
             w / "strip_card"])
    res["result2msa"] = dict(s=time.perf_counter() - t0,
                             launches=launched(before),
                             stats=dict(msa_tools.STATS))
    if not res["result2msa"]["launches"].get("sw_multi"):
        raise AssertionError("result2msa of the stripped alignments "
                             "launched no sw_multi kernel")
    before = {n: v.launches for n, v in wrappers.items()}
    t0 = time.perf_counter()
    with step_record() as steps:
        run_cli(["enrich", side["q"], GOLDEN / "qdb", side["tprof"],
                 GOLDEN / "aln", w / "enrich_card", w / "enrich_card_tmp",
                 "--num-iterations", 1])
    res["enrich"] = dict(
        s=time.perf_counter() - t0, launches=launched(before),
        steps=[dict((k, r[k]) for k in ("command", "out", "s", "sw_multi",
                                        "diag_rescore",
                                        "diag_rescore_profile",
                                        "readbacks")) for r in steps])
    if not res["enrich"]["launches"].get("sw_multi"):
        raise AssertionError("enrich launched no sw_multi kernel")
    return res


def msa_golden_check(side, res):
    """phase_golden_msa's outputs against the CPU side's, byte for byte."""
    w = WORK / "msa_golden"
    for name, card, cpu in (("result2msa, backtraces stripped",
                             w / "strip_card", side["strip_cpu"]),
                            ("enrich, 3 queries, 1 iteration",
                             w / "enrich_card", side["enrich_cpu"])):
        differ = [suf for suf in ("", ".index", ".dbtype")
                  if pathlib.Path(f"{card}{suf}").read_bytes()
                  != pathlib.Path(f"{cpu}{suf}").read_bytes()]
        key = name.split(",")[0]
        log(f"golden {name}: card and CPU "
            f"{'differ in ' + str(differ) if differ else 'equal byte for byte'}"
            f", card {res[key]['s']:.2f} s, launches "
            f"{json.dumps(res[key]['launches'])}")
        if differ or not entries(card):
            raise AssertionError(f"{name}: the card and the CPU differ")
    log("golden msa record " + json.dumps(res))
    log(f"MSA goldens' sides: CPU {side['cpu_s']:.2f} s, host-only goldens "
        f"{side['host_s']:.2f} s")


# -- phase 13: the MSA path ---------------------------------------------------

# phase 5's prefilter lists: candidates a query
MSA_MAX_SEQS = 300
# the context library of phase 13's sequence2profile (from its own
# generator: the reference's K4000.crf is not in the repository)
N_CONTEXTS = 4_000
CONTEXT_WLEN = 13
# H100 SXM, published: 67 TFLOP/s in float32 outside the tensor cores (the
# context-score product runs with TF32 off)
F32_FLOPS_PER_S = 67e12


def context_library(path=None):
    """N_CONTEXTS contexts of window CONTEXT_WLEN drawn from the seed,
    written as a CRF file (profile/cs.dump_crf, weights to 1/1000) under
    WORK; returns its path. Written once: phase 4 writes it for the CPU
    side, phase 13 reads it."""
    path = pathlib.Path(path or WORK / "k4000.crf")
    if path.exists():
        return path
    from mmseqs2_tpu_torch.profile import cs
    rng = np.random.default_rng(SEED + 16)
    w = (rng.normal(size=(N_CONTEXTS, CONTEXT_WLEN, 21)) * 0.5).astype(
        np.float32)
    w[:, :, 20] = 0.0
    lib = cs.ContextLibrary(w, rng.normal(size=N_CONTEXTS).astype(np.float32),
                            rng.normal(size=(N_CONTEXTS, 20)))
    path.write_text(cs.dump_crf(lib))
    return path


def msa_inputs(qdb, tdb, pref, n, prefix):
    """The first n queries (by key) of a prefilter DB of phase 5's lists:
    their prefilter DB and their query sub-DB (for sequence2profile)."""
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.writer import DBWriter
    keys = sorted(pref)[:n]
    with DBWriter(f"{prefix}_pref", dbt.DBTYPE_PREFILTER_RES) as w:
        for k in keys:
            w.write(k, "".join(f"{t}\t0\t0\n" for t in pref[k]).encode())
    pathlib.Path(f"{prefix}_keys").write_text(
        "".join(f"{k}\n" for k in keys))
    run_cli(["createsubdb", f"{prefix}_keys", qdb, f"{prefix}_q"])
    return pathlib.Path(f"{prefix}_pref"), pathlib.Path(f"{prefix}_q")


def msa_cpu_run(spec_path):
    """Phase 13's CPU side (phase 4, a subprocess with the CPU requested):
    createdb of phase 5's FASTA files, its prefilter lists replayed from the
    generator's state as phase 5 finds it, then `result2msa`, `msa2profile`
    and `sequence2profile --context-lib` of the first n queries."""
    spec = json.loads(pathlib.Path(spec_path).read_text())
    q, t = WORK / "msa_cpu_qdb", WORK / "msa_cpu_tdb"
    run_cli(["createdb", WORK / "queries.fasta", q], cpu=True)
    run_cli(["createdb", WORK / "targets.fasta", t], cpu=True)
    rng = np.random.default_rng()
    rng.bit_generator.state = spec["state"]
    pref = scale_pref(rng, q, t, spec["qfam"], spec["tfam"],
                      spec["max_seqs"])
    sub_pref, sub_q = msa_inputs(q, t, pref, spec["n"], WORK / "msa_cpu")
    run_cli(["result2msa", q, t, sub_pref, WORK / "msa_cpu"], cpu=True)
    run_cli(["msa2profile", WORK / "msa_cpu", WORK / "msa_cpu_prof"],
            cpu=True)
    run_cli(["sequence2profile", sub_q, WORK / "s2p_cpu", "--context-lib",
             spec["crf"]], cpu=True)


MSA_CPU_CHECK = r"""
import sys
from chip_smoke import msa_cpu_run
msa_cpu_run(sys.argv[1])
"""


def b9_record(lib, lengths, reps=20):
    """B9, the context-score product, at the path's most common padded
    length: device ms (CUDA events, the card held busy while the host
    enqueues), the numpy product's ms on the host (the plain version: the
    product of a library under 512 contexts), and the bound: the f32
    FLOPs (2 L K wlen*21 and the bias) at F32_FLOPS_PER_S, or the bytes (X,
    W^T and the bias read once, the scores written once) at
    HBM_BYTES_PER_S, whichever takes longer. `lengths` are the run's query
    lengths."""
    import collections
    import torch
    from mmseqs2_tpu_torch.profile import cs
    buckets = collections.Counter()
    for L in lengths:
        Lp = 64
        while Lp < L:
            Lp *= 2
        buckets[Lp] += 1
    Lp = buckets.most_common(1)[0][0]
    dev = torch.device("cuda")
    Wt, b = cs._device_weights(lib, dev)
    K, D = lib.size, lib.wlen * 21
    rng = np.random.default_rng(SEED + 17)
    X = np.zeros((Lp, lib.wlen, 21), np.float32)
    X[np.arange(Lp)[:, None], np.arange(lib.wlen)[None, :],
      rng.integers(0, 21, size=(Lp, lib.wlen))] = 1.0
    X = X.reshape(Lp, D)
    x = torch.from_numpy(X).to(dev)
    ms = device_ms(lambda: torch.matmul(x, Wt) + b[None, :], reps)
    got = (torch.matmul(x, Wt) + b[None, :]).cpu().numpy()
    Wf = lib.weights.reshape(K, D)
    t0 = time.perf_counter()
    want = X @ Wf.T + lib.biases[None, :]
    plain_ms = (time.perf_counter() - t0) * 1e3
    flops = 2 * Lp * D * K + Lp * K
    nbytes = (Lp * D + D * K + K + Lp * K) * 4
    ops_s, bytes_s = flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(
        name="context_scores (B9)", route="torch.matmul",
        source="mmseqs2_tpu_torch/profile/cs.py",
        replaces="mmseqs2_tpu/profile/cs.py:166",
        at=f"L {Lp} (padded; {buckets[Lp]} of {len(lengths)} queries) x "
           f"{D} x K {K}, f32", ms=ms, plain_ms=plain_ms,
        bound_ms=max(ops_s, bytes_s) * 1e3,
        bound_by="operations" if ops_s >= bytes_s else "bytes",
        gflops_per_s=flops / ms / 1e6,
        max_abs_err=float(np.abs(got - want).max()),
        buckets={str(k): v for k, v in sorted(buckets.items())})


def phase_msa(check, n_queries=250, n_profile=16, n_realign=1):
    """The MSA path at real size (cell msa_250x50k), on phase 5's 50,000
    targets and prefilter lists (300 candidates a query, no backtraces),
    every kernel's count set to 0 just before each step and read just
    after: (a) `result2msa` of the first n_queries queries (every pair
    aligned again through Aligner.align_batch, a block of 256 queries a
    batch: sw_multi on the card); (b) `msa2profile` of the first n_profile
    of those MSAs (a cut for time: the profile stack's host code takes
    about half a second an MSA of 301 rows); (c) `sequence2profile
    --context-lib` of the same n_queries queries with N_CONTEXTS contexts
    (B9, the context-score product, on the card); and, reported and not
    redesigned, (d) `result2profile` of the first n_realign queries'
    lists, whose key-only hits go through Aligner.align_query a query.
    Prints for each step its seconds, pairs aligned, sw_multi launches by
    form, read-backs, B1's device seconds (CUDA events), B9's products and
    device ms, and the card's busy share (kernel seconds over the wall).
    The first check['n_msa'] queries' MSA and profile entries must equal
    the CPU side's (phase 4), and B9's probabilities on the card the
    CPU's within rtol 1e-5, atol 1e-6 (the tests' tolerance)."""
    import torch
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.commands import msa_tools
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.ops import sw
    from mmseqs2_tpu_torch.profile import cs
    qdb, tdb = WORK / "qdb", WORK / "tdb"
    with DBReader(str(WORK / "pref")) as r:
        pref = {r.get_db_key(i): [int(line.split(b"\t")[0]) for line in
                                  r.get_data(i).split(b"\n") if line]
                for i in range(r.size)}
    sub_pref, sub_q = msa_inputs(qdb, tdb, pref, n_queries, WORK / "msa")
    crf = context_library()
    wrappers = kernel_wrappers()

    def step(args):
        """One command on the card, counts set to 0 just before."""
        aligner.reset_stats()
        msa_tools.reset_stats()
        cs.reset_stats()
        for w in wrappers.values():
            w.launches = 0
        sw.sw_multi.form_launches = dict.fromkeys(sw.sw_multi.form_launches,
                                                  0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = aligner.STATS
        kernel_s = st["kernel_ms"] / 1e3 + cs.STATS["product_ms"] / 1e3
        return dict(
            s=wall, pairs=st["pairs"], rev_pairs=st["rev_pairs"],
            sw_multi=sw.sw_multi.launches,
            sw_multi_by_form=dict(sw.sw_multi.form_launches),
            readbacks=st["readbacks"], b1_device_s=st["kernel_ms"] / 1e3,
            scan_host_s=st["scan_s"], backtrace_s=st["backtrace_s"],
            b9_products=cs.STATS["products"],
            b9_device_s=cs.STATS["product_ms"] / 1e3,
            busy_share=kernel_s / wall,
            others={n: w.launches for n, w in wrappers.items()
                    if w.launches and n != "sw_multi"})

    res = dict(card=card_line(), queries=n_queries, targets=N_TARGETS,
               candidates=MSA_MAX_SEQS)
    res["result2msa"] = step(["result2msa", qdb, tdb, sub_pref,
                              WORK / "msa"])
    res["result2msa"].update(msa_stats=dict(msa_tools.STATS),
                             pairs_per_s=res["result2msa"]["pairs"]
                             / res["result2msa"]["s"])
    if (res["result2msa"]["pairs"] != n_queries * MSA_MAX_SEQS
            or res["result2msa"]["sw_multi"] <= 0):
        raise AssertionError(f"result2msa realigned "
                             f"{res['result2msa']['pairs']} pairs with "
                             f"{res['result2msa']['sw_multi']} sw_multi "
                             f"launches")
    msa_n = msa_test_helpers().first_entries(
        WORK / "msa", n_profile, WORK / "msa_n", dbt.DBTYPE_MSA_DB)
    res["msa2profile"] = step(["msa2profile", msa_n, WORK / "msa_prof"])
    res["msa2profile"]["msas"] = n_profile
    res["sequence2profile"] = step(["sequence2profile", sub_q, WORK / "s2p",
                                    "--context-lib", crf])
    if res["sequence2profile"]["b9_products"] != n_queries:
        raise AssertionError("sequence2profile ran "
                             f"{res['sequence2profile']['b9_products']} "
                             f"context products for {n_queries} queries")
    rp_pref, _ = msa_inputs(qdb, tdb, pref, n_realign, WORK / "msa_rp")
    res["result2profile"] = step(["result2profile", qdb, tdb, rp_pref,
                                  WORK / "msa_rp_prof"])
    res["result2profile"]["queries"] = n_realign
    res["wall_s"] = sum(res[k]["s"] for k in (
        "result2msa", "msa2profile", "sequence2profile"))

    # B9 at the path's shape; its probabilities on the card and the CPU
    lib = cs.load_crf(crf.read_text())
    with DBReader(str(sub_q)) as r:
        lengths = [r.get_seq_len(i) for i in range(r.size)]
    res["b9"] = b9_record(lib, lengths)
    res["b9"]["launches"] = res["sequence2profile"]["b9_products"]
    from mmseqs2_tpu_torch.commands.common import get_sub_mat
    from mmseqs2_tpu_torch.params import Params
    enc = get_sub_mat(Params()).make_aa2num_table()
    worst = 0.0
    env = "MMSEQS2_TPU_TORCH_DEVICE"
    with DBReader(str(sub_q)) as r:
        for i in range(check["n_msa"]):
            q_num = enc[np.frombuffer(r.get_seq(i), np.uint8)].astype(
                np.int64)
            card = cs.compute_sequence_cs(q_num, lib)
            old = os.environ.get(env)
            os.environ[env] = "cpu"
            try:
                cpu = cs.compute_sequence_cs(q_num, lib)
            finally:
                os.environ[env] = old
            np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-6)
            worst = max(worst, float(np.abs(card - cpu).max()))
    res["b9"]["probabilities_max_abs_err"] = worst
    log("msa " + json.dumps(res))

    # the CPU side's first queries, entry by entry
    for name, ours, cpu in (
            ("result2msa", WORK / "msa", check["msa"]),
            ("msa2profile", WORK / "msa_prof", check["msa_profile"]),
            ("sequence2profile", WORK / "s2p", check["s2p"])):
        got, want = entries(ours), entries(cpu)
        keys = sorted(want)[:check["n_msa"]]
        bad = [k for k in keys if got.get(k) != want[k]]
        log(f"msa CPU cross-check, {name}: first {len(keys)} queries, "
            f"{len(bad)} differ")
        if name == "sequence2profile":
            # the profile bytes round the probabilities (held above within
            # the tolerance), so a byte may move; counted, not required
            res["b9"]["profile_entries_equal"] = len(keys) - len(bad)
            continue
        if bad or len(keys) != check["n_msa"]:
            raise AssertionError(f"card and CPU {name} differ for queries "
                                 f"{bad[:10]}")
    return res


# -- phase 14: fwbw at real size --------------------------------------------------

# phase 14: the queries of phase 5's prefilter lists (the input of its
# `align -a`, 300 candidates a query) it aligns, and the first of them held
# to a CPU run
FWBW_QUERIES = 50
FWBW_CHECK = 2


def sub_result(src, n, dst):
    """The entries of the n smallest keys of a result DB."""
    from mmseqs2_tpu_torch.db.reader import DBReader
    from mmseqs2_tpu_torch.db.writer import DBWriter
    with DBReader(str(src)) as r, \
            DBWriter(str(dst), r.base_type, r.extended_type) as w:
        for k in sorted(int(k) for k in r.keys)[:n]:
            w.write(k, r.get_data(r.get_id(k)))
    return dst


@contextlib.contextmanager
def fwbw_cpu_side(out):
    """Phase 14's CPU side: `fwbw` of phase 5's prefilter lists of its
    first FWBW_CHECK queries with the CPU requested, started before phase
    12 and waited for before phase 14 (it runs beside phases 12-13 at nice
    19: their host work is mostly one thread)."""
    aln = sub_result(WORK / "pref", FWBW_CHECK, WORK / "fw_aln_check")
    with cli_cpu_side("fwbw", [["fwbw", WORK / "qdb", WORK / "tdb", aln,
                                WORK / "fw_cpu"]], out):
        yield


def pair_p(qkey, tkey):
    """One pair's P on the card (B5) and on the CPU (the plain version),
    (tlen, qlen) numpy each, from phase 5's DBs with the command's
    matrix."""
    import torch
    from mmseqs2_tpu_torch.commands.common import EncodedDB, open_seq_db
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import fwbw as F
    submat = get_submat("blosum62.out", 2.0, 0.0)
    q, t = (EncodedDB(open_seq_db(str(WORK / db)), submat)
            for db in ("qdb", "tdb"))
    qs = [q.seq_num(q.reader.get_id(qkey))]
    ts = [t.seq_num(t.reader.get_id(tkey))]
    mat = torch.from_numpy(np.asarray(submat.sub_matrix, np.float32))
    card = F.fwbw(F.make_pairs(qs, ts, [0], [0], "cuda"), mat.cuda(),
                  want_p=True)
    cpu = F.fwbw_plain(F.make_pairs(qs, ts, [0], [0], "cpu"), mat,
                       want_p=True)
    shape = (len(ts[0]), len(qs[0]))
    return (card["p"].cpu().numpy().reshape(shape),
            cpu["p"].numpy().reshape(shape))


def phase_fwbw(side, n_queries=FWBW_QUERIES):
    """`fwbw` of phase 5's prefilter lists (the pairs its `align -a`
    aligns: 300 candidates a query, median length 292; its alignment
    output keeps about 7 a query, too few to load the card) for its first
    n_queries queries, the counts set to 0 just before and read just after:
    pairs/s, B5 launches and device ms (CUDA events), the host's seconds by
    part, the busy share; the first
    FWBW_CHECK queries' records equal to the CPU side's (fwbw_cpu_side),
    but where the two runs' alignments of a pair tie under the CPU's P
    (near_tie: printed)."""
    import torch
    from mmseqs2_tpu_torch.commands import fwbw_cmd
    from mmseqs2_tpu_torch.ops import fwbw as F
    aln = sub_result(WORK / "pref", n_queries, WORK / "fw_aln")
    F.fwbw.launches = 0
    fwbw_cmd.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["fwbw", WORK / "qdb", WORK / "tdb", aln, WORK / "fw"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = F.fwbw.launches
    st = dict(fwbw_cmd.STATS)
    res = dict(queries=st["queries"], pairs=st["pairs"], cells=st["cells"],
               wall_s=wall, pairs_per_s=st["pairs"] / wall,
               launches=launches, batches=st["batches"],
               b5_device_ms=st["kernel_ms"],
               busy_share=st["kernel_ms"] / 1e3 / wall,
               pack_s=st["pack_s"], readback_wait_s=st["wait_s"],
               backtrace_s=st["backtrace_s"], records_write_s=st["write_s"])
    log("fwbw " + json.dumps(res))
    if launches <= 0 or st["queries"] != n_queries or st["pairs"] == 0:
        raise AssertionError("the fwbw run launched no B5 kernel or did not "
                             "write every query")
    card, cpu = fwbw_records(WORK / "fw"), fwbw_records(WORK / "fw_cpu")
    near, bad = [], []
    for k in cpu:
        if set(card.get(k, {})) != set(cpu[k]):
            bad.append((k, "targets"))
            continue
        for t, fields in cpu[k].items():
            if card[k][t] == fields:
                continue
            # record: key score seqid evalue qstart qend qlen tstart tend
            # tlen cigar
            mine = card[k][t]
            tie = near_tie(*pair_p(k, t), (mine[7], mine[4], mine[10]),
                           (fields[7], fields[4], fields[10]))
            (near if tie[0] else bad).append(
                dict(query=k, target=t, card=mine, cpu=fields,
                     card_value=tie[1], cpu_value=tie[2], tolerance=tie[3]))
    res["check"] = dict(queries=len(cpu),
                        records=sum(len(v) for v in cpu.values()),
                        near_ties=near, differ=len(bad),
                        cpu_s=side["cpu_s"])
    log(f"fwbw: first {len(cpu)} queries ({res['check']['records']} "
        f"records) against the CPU side: {len(bad)} differ, near ties "
        f"{json.dumps(near)}, CPU side {side['cpu_s']:.2f} s (beside "
        f"phases 12-13)")
    if bad or len(cpu) != FWBW_CHECK:
        raise AssertionError(f"fwbw differs on the card and the CPU: "
                             f"{json.dumps(bad[:5])}")
    return res


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "mmseqs2_tpu_torch").is_dir() or not GOLDEN.is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["MMSEQS2_TPU_TORCH_DEVICE"] = "cuda"
    t_start = time.perf_counter()
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    rng = np.random.default_rng(SEED)

    # 1. card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    from mmseqs2_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        reports = list(pool.map(kernels.build, KERNEL_SOURCES))
    log(f"build: {', '.join(f'csrc/{n}.cu' for n in KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, report in zip(KERNEL_SOURCES, reports):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    phase_done(2)

    # 3. kernels against their plain versions, while phase 8's CPU side
    # (its own data) and phase 4's MSA goldens' sides (toy data, host code
    # only) start; 4. golden parity on the card, while the CPU
    # sides of phases 6, 7 and 9 run too (on phase 5's data, made now from
    # a copy of the generator as phase 5 will find it: the server's
    # profile, the phase's one draw, is drawn first); leaving the block
    # waits for every side
    with contextlib.ExitStack() as sides:
        check = sides.enter_context(cluster_cpu_check())
        msa_side = sides.enter_context(msa_golden_sides())
        extra_side, host_side, nucl_side, pm1_side = {}, {}, {}, {}
        sides.enter_context(cli_cpu_side("fwbw and nucleotide exhaustive",
                                         extra_cpu_steps(), extra_side))
        sides.enter_context(cli_cpu_side("search --prefilter-mode 1",
                                         PM1_CPU_STEPS, pm1_side))
        rows = phase_kernels(rng)
        rrows = phase_rescore_kernel(rng)
        xrows = phase_exhaustive_kernels(rng)
        prows = phase_rescore_profile_kernel()
        erows = phase_expand_kernel()
        fwrows = phase_fwbw_kernel()
        phase_done(3)

        prof = server_profile(rng)
        rcheck = sides.enter_context(real_size_cpu_checks(rng))
        # this slice's runs on the card beside phase 4 (after phase 3,
        # whose kernel times are the card's own): the alignx and pairaln
        # goldens, the nucleotide exhaustive prefilter and its gpuserver
        sides.enter_context(cli_cpu_side("alignx and pairaln goldens",
                                         host_extra_steps(), host_side,
                                         device="cuda"))
        sides.enter_context(cpu_side("nucleotide exhaustive on the card",
                                     NUCL_CARD_SIDE, [], nucl_side,
                                     device="cuda"))
        phase_golden()
        phase_golden_search()
        srv_launches = phase_golden_exhaustive(prof)
        phase_golden_cluster()
        phase_golden_profile()
        nucl_launches = phase_golden_nucl()
        msa_golden = phase_golden_msa(msa_side)
        extra = phase_golden_extra()
    msa_golden_check(msa_side, msa_golden)
    extra_golden_check(extra_side, host_side, nucl_side)
    pm1_check(pm1_side)
    phase_done(4)

    # 5. the align stage alone at real size (its traced rerun went when
    # phase 7 came: phase 6 and 7 trace their own steps)
    real = phase_real_size(rng)
    phase_done(5)

    # 6. the main path at real size: easy-search, then a traced prefilter
    easy, easy_trace = phase_easy_search(rcheck)
    phase_done(6)

    # 7. the exhaustive prefilter at real size
    exh = phase_exhaustive(rcheck)
    phase_done(7)

    # 8. clustering at real size (easy-linclust of 6,000: a cut for time,
    # from 10,000, when phase 14 came)
    clu = phase_clustering(check, n_linclust=6_000)
    phase_done(8)

    # 9. the iterative profile search at real size
    it, it_traces = phase_iterative(rcheck)
    phase_done(9)

    # 10. large target DBs: the route past the packed key, target splits
    big = phase_large_db(easy)
    phase_done(10)

    # 11. translated search at real size: 250 DNA queries (a cut for time,
    # from 500, when phase 14 came) against phase 6's indexed target DB
    tr = phase_translated(rcheck, n_queries=250)
    phase_done(11)

    # 12-13, while phase 14's CPU side runs (phase 5's first queries; beside
    # the phases whose host work is mostly one thread)
    fw_side = {}
    with fwbw_cpu_side(fw_side):
        # 12. taxonomy at real size: easy-taxonomy against phase 6's indexed
        # target DB with the synthetic taxonomy attached (500 queries: the
        # script passed 950 s with 1,000 on a slow host)
        tax = phase_taxonomy(rcheck, n_queries=500)
        phase_done(12)

        # 13. the MSA path at real size: result2msa's realignment (B1),
        # msa2profile, sequence2profile with a 4,000-context library (B9)
        msa = phase_msa(rcheck)
        phase_done(13)

    # 14. fwbw at real size: phase 5's prefilter lists of its first 50
    # queries (15,000 pairs)
    fw = phase_fwbw(fw_side)
    phase_done(14)

    # kernels line; launches are those of the run of the path that
    # launches the kernel: easy-search, ungappedprefilter, the server's
    # process under ungappedprefilter --gpu 1 (gapless_score) and under
    # phase 4's gappedprefilter --gpu 1 (sw_score), gappedprefilter;
    # easy-search's for sw_offset, which has no caller and which phase 3
    # launches; and beside them each kernel's launches on the clustering
    # path (phase 8's real-size easy-linclust and easy-cluster runs) and on
    # the iterative search's (phase 9) and, for sw_multi and diag_rescore,
    # the translated search's (phase 11, and phase 4's golden run);
    # diag_rescore_profile's are phase 9's, the path that launches it
    clu_launches = {name: dict(
        easy_linclust=clu["linclust"]["launches"][name],
        easy_cluster=clu["cluster"]["launches"][name])
        for name in kernel_wrappers()}
    rep = next(r for c, r in rows if c["nq"] == 16 and c["lq"] == 512
               and c["lt"] == 512 and not c["reverse"] and c["go"] == 11
               and not c.get("negative") and not c.get("big")
               and "variant" not in c)
    rrep = next(r for c, r in rrows if c["n_cand"] == 1 << 17
                and "slots" not in c and not c["counted"])
    rflush = next(r for c, r in rrows if c["n_cand"] == 1 << 17
                  and c.get("slots") == 1 << 21 and c["counted"])
    rpath = next(r for c, r in rrows if c["n_cand"] == 17_408
                 and c["counted"])
    kern = [dict(
        name="sw_multi", route="cuda",
        source="mmseqs2_tpu_torch/csrc/sw.cu",
        replaces="mmseqs2_tpu/ops/pallas_sw.py:106",
        launches=easy["launches"]["sw_multi"],
        launches_by_form=easy["align"]["sw_multi_launches_by_form"],
        launches_align_only=real["launches"],
        launches_align_only_by_form=real["launches_by_form"],
        max_abs_err=max(r["max_abs_err"] for _, r in rows),
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in rows),
        at=rep["case"], launches_clustering=clu_launches["sw_multi"],
        launches_iterative=it["launches"]["sw_multi"],
        launches_iterative_by_form=it["launches"]["sw_multi_by_form"],
        launches_translated=tr["launches"]["sw_multi"],
        launches_translated_golden=nucl_launches["sw_multi"],
        launches_taxonomy=tax["launches"]["sw_multi"],
        launches_taxonomy_lcaalign=tax["lcaalign"]["sw_multi"],
        launches_msa=msa["result2msa"]["sw_multi"],
        launches_msa_golden=msa_golden["result2msa"]["launches"][
            "sw_multi"]),
        dict(
        name="diag_rescore", route="cuda",
        source="mmseqs2_tpu_torch/csrc/rescore.cu",
        replaces="mmseqs2_tpu/prefilter/pallas_rescore.py:38",
        launches=easy["launches"]["diag_rescore"],
        max_abs_err=max(r["max_abs_err"] for _, r in rrows),
        ms=rrep["ms"], plain_ms=rrep["plain_ms"], bound_ms=rrep["bound_ms"],
        bound_by=rrep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in rrows),
        at=rrep["case"], call_ms=rrep["call_ms"],
        flush_shape_ms=rflush["ms"], flush_shape_bound_ms=rflush["bound_ms"],
        flush_shape_at=rflush["case"], path_shape_ms=rpath["ms"],
        path_shape_bound_ms=rpath["bound_ms"], path_shape_at=rpath["case"],
        path_trace_launches=easy_trace["diag_rescore"]["launches"],
        path_trace_ms_per_launch=easy_trace["diag_rescore"][
            "trace_ms_per_launch"],
        launches_clustering=clu_launches["diag_rescore"],
        launches_iterative=it["launches"]["diag_rescore"],
        launches_translated=tr["launches"]["diag_rescore"],
        launches_translated_golden=nucl_launches["diag_rescore"],
        launches_taxonomy=tax["launches"]["diag_rescore"])]
    prep = next(r for c, r in prows if c["n_cand"] == 1 << 17
                and "slots" not in c and not c["counted"]
                and "order" not in c)
    pflush = next(r for c, r in prows if c["n_cand"] == 1 << 17
                  and c.get("slots") == 1 << 21 and c["counted"]
                  and "order" not in c)
    porder = next(r for c, r in prows if c["n_cand"] == 1 << 17
                  and "slots" not in c and not c["counted"]
                  and c.get("order"))
    porder_flush = next(r for c, r in prows if c["n_cand"] == 1 << 17
                        and c.get("slots") == 1 << 21 and c["counted"]
                        and c.get("order"))
    kern.append(dict(
        name="diag_rescore_profile", route="cuda",
        source="mmseqs2_tpu_torch/csrc/rescore.cu",
        replaces="mmseqs2_tpu/prefilter/device_stages.py:377",
        launches=it["launches"]["diag_rescore_profile"],
        max_abs_err=max(r["max_abs_err"] for _, r in prows),
        ms=prep["ms"], plain_ms=prep["plain_ms"], bound_ms=prep["bound_ms"],
        bound_by=prep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in prows), at=prep["case"],
        flush_shape_ms=pflush["ms"], flush_shape_bound_ms=pflush["bound_ms"],
        flush_shape_at=pflush["case"], path_order_ms=porder["ms"],
        path_order_bound_ms=porder["bound_ms"],
        path_order_at=porder["case"], path_order_flush_ms=porder_flush["ms"],
        path_order_flush_bound_ms=porder_flush["bound_ms"],
        path_trace=it_traces["prefilter"].get("focus"),
        launches_clustering=clu_launches["diag_rescore_profile"]))
    replaces = dict(gapless="mmseqs2_tpu/ops/pallas_sw.py:396",
                    gapless_score="mmseqs2_tpu/ops/pallas_sw.py:503",
                    sw_single="mmseqs2_tpu/ops/pallas_sw.py:396",
                    sw_offset="mmseqs2_tpu/ops/pallas_sw.py:420",
                    sw_score="mmseqs2_tpu/ops/pallas_sw.py:493")
    # launches by form: the local runs' for gapless and sw_single; the
    # server counts its own process's launches and reports no forms
    path_forms = dict(
        gapless=dict(launches_by_form=exh["ungapped"]["launches_by_form"]),
        sw_single=dict(launches_by_form=exh["gapped"]["launches_by_form"]))
    path_launches = dict(gapless=exh["ungapped"]["launches"],
                         gapless_score=exh["server"]["launches"],
                         sw_single=exh["gapped"]["launches"],
                         sw_offset=easy["launches_sw_offset"],
                         sw_score=srv_launches["sw_score"])
    for name, krows in xrows.items():
        xrep = next(r for c, r in krows if c["lq"] == 512 and c["lt"] == 512
                    and c["lanes"] == 16384 and "variant" not in c)
        kern.append(dict(
            name=name, route="cuda",
            source="mmseqs2_tpu_torch/csrc/"
            + ("gapless.cu" if name.startswith("gapless") else "sw.cu"),
            replaces=replaces[name], launches=path_launches[name],
            max_abs_err=max(r["max_abs_err"] for _, r in krows),
            ms=xrep["ms"], plain_ms=xrep["plain_ms"],
            bound_ms=xrep["bound_ms"], bound_by=xrep["bound_by"],
            library_ms=None, equal=all(r["equal"] for _, r in krows),
            at=xrep["case"], launches_clustering=clu_launches[name],
            **path_forms.get(name, {})))
    erep = next(r for c, r in erows if c.get("n") == 1 << 21
                and not c.get("pad") and not c.get("l2_index"))
    kern.append(dict(
        name="posting_expand", route="cuda",
        source="mmseqs2_tpu_torch/csrc/expand.cu",
        replaces="mmseqs2_tpu/prefilter/device_stages.py:236",
        launches=big["split"]["launches"]["posting_expand"],
        launches_route_past_key=big["route"]["posting_expand_launches"],
        max_abs_err=max(r["max_abs_err"] for _, r in erows
                        + [(None, big["route"]["kernel"])]),
        ms=erep["ms"], plain_ms=erep["plain_ms"], bound_ms=erep["bound_ms"],
        bound_by=erep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in erows)
        and big["route"]["kernel"]["equal"], at=erep["case"],
        real_flush_ms=big["route"]["kernel"]["ms"],
        real_flush_bound_ms=big["route"]["kernel"]["bound_ms"],
        real_flush_at=big["route"]["kernel"]["case"],
        path_split=big["split"]["posting_expand_path"],
        launches_clustering=clu_launches["posting_expand"],
        launches_iterative=it["launches"]["posting_expand"]))
    frep = next(r for c, r in fwrows if c["label"] == "commonest")
    f512 = next(r for c, r in fwrows if c["label"] == "512x512")
    kern.append(dict(
        name="fwbw", route="cuda", source="mmseqs2_tpu_torch/csrc/fwbw.cu",
        replaces="mmseqs2_tpu/ops/fwbw.py:46", launches=fw["launches"],
        max_abs_err=max(r["max_abs_err"] for _, r in fwrows),
        ms=frep["ms"], plain_ms=frep["plain_ms"], bound_ms=frep["bound_ms"],
        bound_by=frep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in fwrows), at=frep["case"],
        ms_512=f512["ms"], plain_ms_512=f512["plain_ms"],
        bound_ms_512=f512["bound_ms"], at_512=f512["case"],
        forms={c["label"]: r["forms"] for c, r in fwrows},
        path_device_ms=fw["b5_device_ms"], path_pairs=fw["pairs"],
        path_cells=fw["cells"],
        launches_golden=extra["launches"]))
    shutil.rmtree(WORK)
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
