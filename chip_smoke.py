"""On-card smoke run of the PyTorch/CUDA port (dashing2_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA Hopper
card (H100), CUDA's nvcc, g++ and zlib:

    python3 chip_smoke.py

It builds every kernel of the port's main paths from the checkout's
sources and drives both `--fastcmp 0.5` jobs, the `--fastcmp 1|2|4`
jobs, the default full-register job (no `--fastcmp`), a job of every
other measure, the asymmetric output, query panels (`-Q`), the LSH
neighbour jobs (`--topk`, `-T`, `--greedy`, `--index-save/-load`),
FullSetSketch sketching (`--full-setsketch`, `--fastcmp-bytes`),
`cmp --presketched`, exact k-mer sets and count dictionaries
(`--set`, `--countdict`), the weighted sketches (`-B`, `-P`, `-c`), the
k-mer database (`-s`, `-N`) and `contain`, the interval inputs
(`--bed`, `--bigwig`, `--leafcutter`), `wsketch` and the edit-distance
space (`-E`, `--parse-by-seq`, `--compute-edit-distance`, `--greedy
...f`) and the chunked route (`--parse-by-seq` outside `-E`,
`--filterset`, `--by-chrom`, `.xz`/`.bz2` inputs), the sketch cache
(`--cache`, `--outprefix`), the minimizer sequences (`--seq`,
`--long-kmers`, `printmin`) and u128 exact sets (`--set`/`--countdict
--long-kmers`) through the port's own CLI.
It exits non-zero when a phase fails (nothing is caught), when torch sees
no card, or when the port is not importable:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: nvcc for csrc/tri_eq.cu, csrc/tri_comb.cu, csrc/gtlt.cu,
   csrc/int_counts.cu, csrc/weighted_draws.cu, csrc/omh.cu,
   csrc/oph_rows.cu (its `oph_rows` and `hash_rows` entries),
   csrc/css.cu and csrc/countsketch.cu (sm_90a),
   the earlier dense-bucket CountSketch kernel
   (experiments/countsketch_dense.cu, phase 44's yardstick) and g++ for
   the native sketcher, FASTA reader, formatter, Myers edit distance
   and span edit distance, all started together; build seconds and
   ptxas' register/spill report;
3. kernels against plain, on the card: exact u16 equality of
   `tri_eq_counts` and `tri_eq_counts_plain` for n in {1, 2, 63, 129,
   1000, 1025, 4097} and m in {30, 62, 64, 96, 98, 100, 126, 128, 130,
   256, 1024} (m not a multiple of the kernels' 32-register k step is
   where their pad rule bites; 96 and 98 sit at the edge of tri_comb's
   96-register decode chunks, 126-130 at the decode's 127-register
   limit), the diagonal m, and of `tri_comb_counts` and
   `tri_comb_counts_plain` (eq and gt) for the same n and m, with
   planted identical, all-0x00 and all-0xFF rows, and a matrix of equal
   rows (every register equal: a full chunk's eq in every chunk); of
   `gtlt_self_counts` and `gtlt_self_counts_plain`, and of
   `gtlt_counts` and `gtlt_counts_plain` (gt and lt, against a second
   matrix and on the row-block route's row slices), for the same n and
   m, with u64 registers of which about half have the top bit set and
   planted identical rows, equal registers, all-zero and all-ones rows;
   the similarity tables (b-bit, and full in both forms) built on the
   card must equal the CPU-built tables bit for bit; and of
   `int_counts_self` (eq and gtlt modes) and `int_counts` (eq, gt, lt,
   against a second matrix and on row slices) with their plain versions,
   u8 and u16 registers, for the same n and m, with planted identical,
   all-zero and all-max rows, equal registers and top-bit values; the
   b-bit tables of every width (fused and numpy forms) and the a/b
   complement epilogue over every (gt, lt) built on the card must equal
   the CPU's bit for bit; and `weighted_draws` against
   `weighted_draws_plain` (keys, winners, values) bit for bit, ICWS and
   ProbMinHash, m in {64, 1000, 1024}, streams of 0, 1, 2047, 2048,
   2049, 5000 and 20000 positions with counts up to 10^6 and repeats
   planted inside and across the 2048-position rows, and streams whose
   weights hold zeros and negative values (masked), one of them all
   masked (key +inf, winner 0, value 0), one of 70000 positions; over
   the masked streams sketch/weighted.py's split path (pieces of 32768
   positions, merged on the host) equals the plain version over the
   whole streams (registers and winners); both timed on 64 items x
   20000 positions at m = 1024;
4. golden digests: the port's CLI on the card over the seeded n=777
   corpus must reproduce the SHA-256s in
   tests/goldens/torch_port_{bbit,ab}_nibble.json, torch_port_full.json,
   torch_port_u8_bbit.json, torch_port_u16_ab.json and (the panel and
   neighbour jobs) torch_port_{panel,knn,dedup}.json, which CPU tests tie
   to the JAX package's output;
5. b-bit main path at full size: N = 10240 genomes, 512 ancestors x 20
   mutants at 0.5-5% divergence, through
   `sketch -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs --binary-output
   -o ns.sig --cmpout out.bin -F list.txt` on the card (phase 17 reads
   ns.sig). Checks the output size,
   that the tri_eq launch counter moved during the run, that the
   kernel's full (N, N) count matrix equals the plain version's, and
   that every emitted value is the similarity table at the plain
   counts. Prints the phase walls and unique pairs/s;
6. a/b main path at full size: the same corpus through
   `sketch -k 31 -S 1024 --fastcmp 0.5 --binary-output --cmpout out.bin
   -F list.txt`. Checks the output size, that the tri_comb launch
   counter moved during the run, that the kernel's full (N, N) eq and gt
   equal the plain version's, that the card's a/b epilogue equals the
   CPU's bit for bit on every (gt, lt) in [0, m]^2 at the job's b, and
   that every emitted value is the CPU epilogue at the plain counts.
   Prints the wall, unique pairs/s and the spans;
7. default full-register job at full size: the same corpus through
   `sketch -k 31 -S 1024 --binary-output --cmpout out.bin -F list.txt`
   (self-pairs route, `gtlt_self_counts`). Checks the output size, that
   the gtlt_self launch counter moved during the run, that the kernel's
   full (N, N) counts equal the plain version's, and that every emitted
   value is the table at the plain counts. Prints the wall, unique
   pairs/s, the spans and the kernel's and plain version's times;
8. the `--fastcmp 1 --bbit-sigs`, `--fastcmp 1`, `--fastcmp 2
   --bbit-sigs` and `--fastcmp 2` jobs on the same corpus (self-pairs
   route, `int_counts_self` in eq or gtlt mode), and `--fastcmp 4` (u32
   a/b registers, `gtlt_self_counts`). Each checks the output size, that
   its kernel's launch counter moved during the run, that the kernel's
   full (N, N) counts equal the plain version's (u8 and u16), that the
   card's epilogue equals the CPU's over every count (the b-bit table,
   or the a/b value at every (gt, lt) in [0, m]^2 at the job's b), and
   that every emitted value is the CPU epilogue at the plain counts.
   Prints the wall, unique pairs/s, the spans and the kernel's and plain
   version's times;
9. row-block jobs above SELF_MAX: N = 20480 genomes, 1024 ancestors x 20
   mutants, through the default job's argv (row-block route, one
   `gtlt_counts` launch per 4096-row block), then through `--fastcmp 1`
   (one `int_counts` launch per block). Each checks the output size,
   that its rectangular launch counter moved once per row block and the
   self-pairs counters not at all, and that every emitted value is the
   CPU epilogue at the plain version's counts, 1024 rows at a time.
   Times `gtlt_counts` and `int_counts` on one full-width block
   (4096 x 20480) against their plain versions;
10. every measure on the N = 10240 corpus (its sketches reused):
   `--fastcmp 0.5 --bbit-sigs --mash-distance` (tri_eq), `--fastcmp 0.5
   --union-size` (tri_comb), the default job with `--containment
   --asymmetric-all-pairs` (gtlt_self, the full square), `--fastcmp 1
   --intersection` (int_counts_self, gtlt mode), `--fastcmp 2 --bbit-sigs
   --symmetric-containment` (int_counts_self, eq mode) and `--bbit-sigs`
   without `--fastcmp` (equality-compared full registers: gtlt_self on the
   raw bits). Each checks the output size, that its kernel's launch
   counter moved, and that every emitted value equals the CPU epilogue
   at the plain version's counts and the job's cardinalities, bit for
   bit (POISSON_LLR's table is built on the host, so it holds too);
11. the nibble row-block route on the N = 20480 corpus: `--fastcmp 0.5
   --bbit-sigs` and `--fastcmp 0.5`, nibbles unpacked on the card once
   and one `int_counts` launch per row block, tri_eq and tri_comb never.
   Each checks the output and every emitted value as phase 9 does; the
   b-bit job times `int_counts` on one unpacked 4096 x 20480 block
   against its plain version, with its bound;
12. panels (`-Q`) on the N = 10240 corpus: references are the 9216
   genomes whose index is not a multiple of 10, queries every tenth
   genome (1024; each has siblings among the references). The default
   job (`gtlt_counts`), `--fastcmp 0.5 --bbit-sigs` (unpacked nibbles,
   `int_counts`) and `--fastcmp 1 --containment` (u8 a/b, `int_counts`,
   the pair's cardinalities). Each checks its launch counters (one
   rectangular launch per 4096-row reference block, no self-pairs
   launch), the output's size (9216 x 1024 f32) and every value against
   the CPU epilogue at the plain version's rectangular counts, and times
   its kernel on one 4096 x 1024 block against the plain version, with
   its bound;
13. neighbour graphs on the same sketches: `--topk 10 --index-save`
   (full registers, a native-format index), `-T 0.3 --fastcmp 1
   --bbit-sigs`, `--greedy 0.3 --fastcmp 0.5 --bbit-sigs`, and `--topk
   10 --index-load` of the saved index. Each checks that no hand kernel
   launched (pair lists are counted by ops/pair_counts.py, plain
   PyTorch on the card), that its output bytes equal
   `neighbor_graph_main` in-process over the same sketches with
   device="cpu" (the loaded-index run: the built-index run's), and that
   the card's pair counts equal the CPU's over every pair the job
   refined; it prints the edge or cluster count, the pairs refined and
   the spans of both runs. (The reference's `.ssi` layout is held byte
   for byte by the CPU tests; its save and load walk one Python record
   a bucket, 1536 subtables x N of them at m = 1024.)
14. the JAX package's FullSetSketch golden: `sketch -k 17 -S 128 --full`
   over tests/make_fixtures.py's six genomes on the card must write the
   bytes of tests/goldens/full_sim.bin;
15. FullSetSketch at full width on the first 5120 genomes of the
   N = 10240 corpus: `sketch --full-setsketch -o fss.sig --cmpout
   fss.bin` (the CSetSketch draws of every item on csrc/css.cu, then
   one gtlt_self launch, no other kernel);
   every emitted value equals the table at the plain counts of the
   written registers; the distinct k-mers of 8 items spread over the
   corpus go through the same draws on the CPU: the card's registers
   and cardinalities equal the CPU's bit for bit (the port's own f64 log,
   ops/fixedmath.py), and so do the passes and the 32 x 32 (gt, lt)
   counts. Prints the pass histogram and the spans (`sketch/read`,
   `sketch/hash`, `sketch/count`, `sketch/css`);
16. `--full-setsketch --fastcmp-bytes` (u8 a/b registers, a = 20,
   b = 1.2) over the first 1024 genomes: the draws on css.cu, one
   int_counts_self launch, no other kernel; the card's
   epilogue equals the CPU's on every (gt, lt), every value the CPU
   epilogue at the plain counts of the written registers;
17. `cmp --presketched --full` over fss.sig, and `cmp --presketched
   --fastcmp 0.5 --bbit-sigs` over phase 5's `-o` output: one launch
   each (gtlt_self, tri_eq) and the bytes of the sketch job that wrote
   the file;
18. exact k-mer sets: `sketch --set --cmpout set.bin` over the first
   5120 genomes of the N = 10240 corpus, its intersections joined on the card
   (cmp/wcompare.py, no hand kernel: none is launched). The
   cardinalities equal the set sizes; 4096 sampled values (every pair
   of 8 families, the rest random pairs among 512 genomes) equal
   `exact_measures` at the intersections of the port's torch engine on
   CPU tensors, and the card's pair lookup gives the same counts.
   Prints the join's budget, sub-blocks and entries, and the spans;
19. `--countdict --containment --asymmetric-all-pairs` over the first
   1024 genomes: the whole square byte-equal to the same job with
   `--device cpu`;
20. a `--set -Q` panel over the first 1024 genomes, every tenth a
   query: byte-equal to `--device cpu`;
21. `--set --topk 10 --index-save` over the first 5120 genomes, then
   the same job with
   `--index-load`: equal bytes over the same candidate pairs; the card's
   pair counts equal the CPU's on 2048 of them. Prints the candidate
   count and the `cmp/exact-pairs` span;
22. `--countdict --greedy 0.3` over the first 1024 genomes: byte-equal
   to `--device cpu`;
23. `sketch -B -o wmh.sig` all pairs over the first 5120 genomes of the
   N = 10240 corpus (run before phases
   18-22): the draws on weighted_draws.cu, one gtlt_self launch over the
   registers' bits; the registers of 32 items spread over the corpus
   equal the plain version's on the card bit for bit and their
   cardinalities their total counts; the card's gtlt_self counts equal
   the plain version's and every emitted value is the equality table at
   them. Prints the draws' seconds and rate and the spans;
24. `-P -c 1048576` over the first 8 genomes at -S 256: one
   countsketch call for the batch of 8 genomes; byte-equal to
   `--device cpu`;
25. `-P --topk 10` over the first 5120 genomes: the draws on the card,
   no other kernel;
   the bytes equal `neighbor_graph_main` on the CPU over the same
   sketches;
26. `sketch -S 1024 -s -N -o db` over the N = 10240 corpus (no kernel):
   db.kmer64 holds 10240 x 1024 keys, db.kmercounts.f64 their counts;
   then `contain db.kmer64` over 64 queries of 50 corpus genomes each,
   1% of their bases mutated (about 1 Mbp a query), binary and text,
   the lookup on the card; the binary bytes equal `--device cpu`'s, and
   each query covers more than half of its genomes' keys;
27. `sketch --bed` over 8 peak files (10,000-20,000 intervals of
   200-1,000 bp over 24 chromosomes, 60% of each file's peaks from its
   family's set of four): the one-permutation default (host), then
   `--full-setsketch` (css.cu), `-B --normalize-intervals`
   and `-P` (weighted_draws.cu), all pairs (one gtlt_self launch each);
   each also over the first 4 files with `--device cpu`, equal bytes
   (the weighted jobs over those files cut to their first 4 intervals);
   the weighted jobs also write `-o`, and the registers, winners and
   cardinalities of the two shortest files (millions of positions,
   drawn by the job in pieces of 32768 positions) equal the kernel's
   over their whole, unsplit streams (the plain version draws about 17
   ms a 2048-position row on an NVIDIA H100 80GB HBM3 at 700 W, too
   slow there; phase 3 holds the kernel to it over whole masked streams
   longer than a piece);
28. `sketch --bigwig -P` and `-B --by-chrom` over 8 tracks of 2
   chromosomes of 10 Mbp and an unplaced contig of 175,055 bp, half
   covered by spans of 10-200 bp (a tenth of the values negative, a
   twentieth 0); each also over the first 2 tracks cut to 4 kb with
   `--device cpu`, equal bytes; with `-o`, the written registers,
   winners and cardinalities of the captured items equal a reference
   over their whole streams: in the `--by-chrom` job contigs (about
   83,000 positions, three pieces, masked positions among them) the
   plain version's, the two shortest chromosomes or tracks the
   kernel's;
29. `sketch --leafcutter -B` over one perind table of 100 samples x
   20,000 junctions; its first 25 junctions also with `--device cpu`,
   equal bytes; with `-o`, the written registers, winners and
   cardinalities of the first samples (96 rows of 2048 positions in
   all) equal the plain version's on the card;
30. `wsketch -B`, `-P` and `-q` (`--u32 --f32`, u64 indptr; -q on
   css.cu with its winners) over a
   10,000-row count matrix of 1,000-3,000 non-zeros a row; the first 32
   rows (4 for -B) also with `--device cpu`: their rows of every output
   file equal;
31. the OrderMinHash kernel (csrc/omh.cu) against its plain version on
   the card, bit for bit: tests/omh_planted.py's streams (f64 key ties
   planted by inverting wanghash, keys that round to 2^64, phantom slots
   before and after a real winner at position 0, one and no valid
   window) and random streams of 1 to 20000 positions (the kernel's
   1024-position staging steps and 8192-position pieces), m in {1, 7,
   130, 1024} (ell 2; ell 3 refused, no launch); the card's k-mers,
   occurrence ranks and valid flags equal the CPU's over sequences
   shorter than k, with N runs and all-A runs. Then the edit corpus
   (io/corpus.py `edited_sequences`, seed 13: 512 families x 16 members
   of 1,000-4,000 bp, each 1-3% edited by substitutions, insertions and
   deletions in equal parts, N runs and poly-A tracts planted; about 20
   Mbp in one FASTA): one launch over its 8192 sequences timed with CUDA
   events, with its bound, and the plain version on its first 64
   sequences;
32. `sketch -E --parse-by-seq -k 15 -S 1024` all pairs at N = 8192: the
   OMH words compared for equality (one gtlt_self launch), `--fastcmp
   0.5` (tri_eq) and `--fastcmp 1` (int_counts_self, eq mode); each
   output's size, its launches, and every value equal to the CPU
   epilogue at the plain version's counts of the registers written with
   `-o`; 32 sampled sequences' registers equal the plain version's on
   the CPU and the cardinalities the base counts;
33. `-E --parse-by-seq --compute-edit-distance --topk 10` at N = 8192:
   OMH on the card (no other kernel), LSH candidates over the
   registers, exact distances on the host (native/myers_ed.cpp); 1000
   sampled edges' distances equal `myers_one`, every row ascending; the
   job over the first 32 sequences byte-equal to `--device cpu`;
34. `-E --parse-by-seq --greedy 0.3f` at N = 8192: every cluster's
   representative sequence equals its input record byte for byte and
   the clusters hold every sequence once; over the first 32 sequences
   byte-equal to `--device cpu`;
35. `-E --parse-by-seq --compute-edit-distance` all pairs over the
   first 256 sequences, binary: 1000 sampled values equal `myers_one`;
36. whole-file `-E` (each genome file one item, about 20,000 positions,
   three pieces) over the first 1024 genomes of the N = 10240 corpus,
   `-o`: one omh and one gtlt_self launch; 8 genomes' written registers
   equal the plain version's on the card; the first 8 genomes'
   comparison byte-equal to `--device cpu`;
37. the chunked route's kernel (csrc/oph_rows.cu) against its plain
   version on the card, registers and counts bit for bit, over the
   first 256 records of the by-record corpus (io/corpus.py
   `edited_sequences`, seed 14: 2,048 families x 16 members of
   1,000-6,000 bp, each 1-5% edited, N runs in every 16th record, 16
   records cut below k; about 114 Mbp in one FASTA) in each encoding:
   2-bit DNA k = 31 canonical, window-50 minimizers with downsampling,
   spaced seeds, the rolling hash at k = 48, the 128-bit low word at
   k = 40, a filterset, and protein k = 7 over 256 random protein
   records; then the whole corpus at k = 31, m = 1024 in the chunked
   route's batches: the kernel's registers equal the native engine's
   (`oph_rows_native` over the same rows, merged per record), the
   kernel timed with CUDA events over the prebuilt batches, with the
   bound; on the first 256 records the wrapper, the bare C entry
   on prebuilt arguments and the plain version timed;
38. `sketch --parse-by-seq -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs -o`
   all pairs over the first 8,192 records: oph_rows and one tri_eq
   launch; every value equal to the CPU epilogue at the plain counts
   of the written registers; the first 64 records' registers equal the
   chunked route's on the CPU; the names the records';
39. `--parse-by-seq --topk 10` over the first 8,192 records: oph_rows
   the only hand kernel; the graph byte-equal to neighbor_graph_main on
   the card over the native engine's registers of phase 37;
40. `--filterset` over the first 5,120 genomes of the N = 10240 corpus
   with a 256 kb filter FASTA cut from 64 of them: the full-register
   all-pairs job on the file driver (one gtlt_self launch); the chunked
   route's registers on the card with the same set equal the file
   driver's; the filter changes every one of the 64 genomes' registers;
   `:b` with the raw u64 list of the FASTA's hashes gives the FASTA
   filter's bytes (matrix and `-o`);
41. 256 genomes of that corpus as 4 contigs each, plain, `.xz` and
   `.bz2`: the file driver's bytes on the plain files (matrix and `-o`)
   equal the chunked route's on the `.xz` and `.bz2` files, on the plain
   files with `--by-chrom`, and on the `.xz` files with `--by-chrom`;
42. `--full-setsketch`, `--set` and `-B` with `--parse-by-seq` over the
   first 2,048 records: each output's size and launches (css.cu for
   `--full-setsketch`), and the job over the first 64 records (32 for
   `--full-setsketch`, 8 for `-B`) byte-equal to `--device cpu`;
43. (after 15) the CSetSketch kernel (csrc/css.cu) on phase 15's own
   operands, captured as the job launched it: on the first 8 items of
   its first launch (6144 rows x m 1024), registers, cutoffs and winners
   bit for bit == the plain version's on the card; over their first
   2048 rows the plain early-exit walk (`css_walk_plain`, a torch step
   a row) == the kernel's pass, its count of evaluated draws ==
   `walk_draws`' from the kernel's output; the kernel == plain bit for
   bit on tests/css_planted.py's rows (equal rows and own-row hits where
   its 32-row steps meet, caps of 0, 1, 33 and 95) at m 1, 33 and 1024;
   then the kernel alone over every launch of the job, timed with CUDA
   events, against its bound, the PR 18 kernel's walk-loop instructions
   (CSS_INT_OPS, CSS_F64_OPS: a fixed yardstick) charged to every draw
   the early exit evaluates (and, printed beside it, to every kept
   draw); and the lane slots a draw of the PR 18 schedule (a thread a
   register: a warp's longest of 32 walks, a block's of 128) and of
   this kernel's (a warp a register, 32 rows a step), from the walks'
   lengths;
44. (after 46) the CountSketch kernel (csrc/countsketch.cu) on three
   sets of streams: (a) phase 24's 8 streams and (c) phase 46's 8,192,
   captured as the jobs called it, and (b) 8 streams of 5,000,000
   hashes made on the card from a seeded generator (a 5 Mbp bacterial
   genome's 31-mers, 5 hashes repeated 1,000 times and one 100,000
   times in each) at cssize 2^20, and the first of them again at
   2^31 - 1: on each, every stream's count and non-zero buckets ==
   the plain version's, == `torch.bincount`'s (a stream at a time) and
   == the earlier dense-bucket kernel's whole function's (a zeroed
   cssize-sized array a stream, the kernel, `torch.nonzero`, the
   gather and the cast), exactly; the four timed (the kernel route
   with ids and sums left on the card), with the bound (CS_OPS and the
   function's own bytes) and each one's share of it;
45. (after the weighted phases) `sketch --cache --outprefix D` over the
   first 256 genomes of the N = 10240 corpus for the one-permutation
   `-o`, `--full-setsketch`, `--full-setsketch --fastcmp-bytes`,
   `--set`, `--countdict` and `-B` jobs, all pairs: a cold run, a warm
   run (no route sketches: no route's span, no draw launched, the
   route entry never called) and a run with every third genome's
   artifacts deleted (the route called with exactly those genomes);
   every output (matrix, `-o`, artifacts) == the cold run's byte for
   byte; the artifacts of the first 16 genomes (1 for `-B`) == a
   `--device cpu` run's;
46. (after 42) `sketch -k 31 -S 256 -P -c 1048576 --parse-by-seq
   --binary-output` all pairs over the first 8,192 records (phase 38's):
   one countsketch call a batch of hashes, the draws on
   weighted_draws.cu, one gtlt_self launch; its wall and `sketch/hash`,
   `/count` and `/weighted` spans; the job over the first 64 records
   byte-equal to `--device cpu`;
47. (after 46) csrc/oph_rows.cu's `hash_rows` entry (the port of the
   XLA engines `_hash_chunk_batch` and `_hash_chunk_batch128`) against
   its plain version on the card, the kept tokens (and the high words
   of full keys) and the rows' counts bit for bit: over phase 37's
   first 256 records, with tests/seq_planted.py's rows beside them (a
   homopolymer, tandem repeats of period 5 and nwin, N runs of 1 to
   nwin bases), in phase 37's encodings and the 128-bit code's full
   keys with minimizers, then over the whole corpus in the --seq
   route's batches at `-k 15 -w 31` and `--long-kmers -k 40 -w 60`
   (full keys); the kernel timed by CUDA events over those
   batches, after a warm-up, through its wrapper (the tokens' launch,
   the scan of the segments' counts, the placement launch, the read of
   the total) and as the bare launches of its two C entries, with the
   bound (HASH_ROLL_OPS and HASH_MINI_OPS a valid position,
   HASH_MASK_OPS a position the minimizers select; a byte a base read,
   8 or 16 a kept token written); the plain version on the first 256
   records;
48. `sketch --seq --parse-by-seq -k 15 -w 31 -o` and `--long-kmers -k
   40 -w 60 -o` over all 32,768 records: hash_rows the only hand
   kernel; the written file's 32,768 sequences, names, lengths (the
   cardinalities) and token width; over the first 64 records the card's
   `-o` bytes == `--device cpu`'s, `printmin` of both the same text,
   and the sequences == the whole run's first 64; the `sketch/read`,
   `/chunk`, `/hash-rows` spans and the wall;
49. `--seq -k 15 -w 31` all pairs over the first 256 records with `-o`
   (card == `--device cpu` bytes; 200 values == the longer length
   minus `span_edit_distance`, the numpy DP, over the written
   sequences), and `--topk 10` over the first 1,024 (card ==
   `--device cpu` bytes); the distances on the host
   (native/span_ed.cpp);
50. (after 22) `sketch --set` and `--countdict` with `-k 40
   --long-kmers --cache --outprefix D` all pairs over the first 1024
   genomes of the N = 10240 corpus: no hand kernel (the joins in torch
   on the card over the u128 keys' ranks); 1024 `.kmerset128` files
   (sorted distinct keys after the cardinality; a count dictionary's
   `.kmercounts.f64` of as many counts summing to it); `cmp
   --presketched` over the `--set` job's files == its bytes; each job,
   and the presketched load, over the first 16 genomes: card bytes ==
   `--device cpu` bytes.

Each main path runs with every launch counter set to 0 just before its
CLI call and read just after it. Each phase prints its wall, and phases
26-42 their jobs' spans.

Beside each kernel's time the script reckons its bound (the least time
the card could take for the same work, from this run's shapes: the
larger of its operations over the peak rate of their type and its bytes
over the memory rate, `_bound`) and times one PyTorch call that computes
the same function where there is one (`library_ms`, a yardstick the port
never calls): `torch._int_mm` over the int8 one-hot operands of the JAX
package's enc_onehot_T / enc_combined_T for tri_eq and tri_comb (all N^2
pairs; the expansion is done before the timed window), `torch.cdist(x,
x, p=0)` over the f32 registers for int_counts_self in eq mode (the
unequal-register count, eq = m - d). No single call computes (gt, lt)
counts, so gtlt_self_counts, gtlt_counts and int_counts have none;
nor does one call draw weighted registers (weighted_draws), select and
fold OrderMinHash words (omh), encode, select and bucket-min k-mers
(oph_rows) or encode, select and mask them (hash_rows), or draw
CSetSketch registers (css); the CountSketch's is
`torch.bincount(idx, weights=sign, minlength=cssize)` a stream over the
bucket ids and signs (made before its window), then `torch.nonzero` and
the gather. The kernels line gives
int_counts_self twice: `int_counts_self` with the
u8 a/b job's gtlt-mode times (no library call) and `int_counts_self_eq`
with the u8 b-bit job's eq-mode times and its library call.

Reductions: the north-star job uses 50 kb genomes; phases 5-8, 10, 12,
13, 15-22 and 23-25 use 20 kb and phase 9 10 kb. Phase 16 takes the
first 1024 genomes, as phases 19, 20 and 22 do, and phase 15 checks 8
items on the CPU (the port's own f64 log made the CSetSketch draws
slower; the time went to the weighted phases, and the whole stays well
inside the run's limit on a slower host). Phases 15, 18, 21, 23 and 25
take the first HALF_N = 5120 genomes, and phase 27 16 BED files instead
of 32, to make room for phase 35's exact job (about 90 s of host Myers
distances over 1024 sequences; 768 since phases 37-42, 512 since
phase 37 also times the bare launch); to make room for phases 47-50,
phase 27 takes 8 BED files, phase 35 256 sequences and phase 39 the
first 8,192 records: each spends most of its time on
host reading, expansion, hashing and counting, or on draws, in proportion to its
items, and its kernels' launches and shapes are timed elsewhere. The
comparison's work depends only on N and m; 20 kb genomes still carry
about 20k distinct 31-mers and 10 kb genomes about 10k (both more than m
= 1024, so every register fills and the jobs stay out of the OPH
small-input regime). The cuts only shorten sketching and the generated
FASTA: about 205 MB for phases 5-8 (written once, read by all of them)
and 205 MB for phase 9, against 520 MB and 1 GB at 50 kb. Phases 26-30
run at full size on the card; their `--device cpu` checks run on cuts
(named in each phase), because the plain draws take 100-400 ns each on
the CPU. Phases 31-36 run at full width (m = 1024) over 8192 sequences;
their `--device cpu` checks run on cuts (32 sequences, 8 genomes: the
plain OMH on the CPU takes seconds for a few dozen sequences at m =
1024, the cut jobs' `cpu` walls say how many), and the exact all-pairs
job takes the first 256 sequences (32,640 host Myers distances, about
0.17-0.19 ms a pair on 8 threads). Phases 37-42 run at full width over
the 32,768-record corpus (phases 38 and 39 its first 8,192 records,
phase 42 its first 2,048), 5,120 genomes (phase 40)
and 256 genomes (phase 41); the
CPU checks of phase 42 run over 64 records for `--set`, 32 for
`--full-setsketch` and 8 for `-B` (the plain CSetSketch and weighted
draws are slow on the CPU: 10.8 s for 64 records and 8.6 s for 16);
phase 46 runs over phase 38's 8,192 records and its `--device cpu`
check over the first 64 (the plain `-P` draws at m = 256: 5.7-10.9 s
on the H100 machine's host).
Phase 45 runs over the first 256 genomes (its jobs' work scales with
their items; the kernels' shapes are timed in phases 43 and 44) and its
`--device cpu` check over 16 genomes, 1 for `-B` (the plain weighted
draws take 260-500 ns each on the CPU: 15.3 s for 2 genomes on the
H100 machine's host). Phases 47-49 run over phase 37's whole corpus
(the kernel and the `-o` jobs), its first 256 records (all pairs: the
span DP costs O(n^2) a pair on the host) and its first 1,024
(`--topk 10`); their `--device cpu` checks over 64 records and the
comparisons' own inputs. Phase 50 runs over the first 1024 genomes
(host hashing and counting of 20k u128 keys a genome, as in the JAX
package) and its CPU checks over 16.

The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
NORTH_STAR_N, NS_ANCESTORS, NS_MUTANTS, NS_LENGTH = 10240, 512, 20, 20000
# genomes of the cut FullSetSketch, --set, --set --topk, -B and -P
# --topk jobs (phases 15, 18, 21, 23 and 25): the first half of the
# north-star corpus
HALF_N = NORTH_STAR_N // 2
NS_SEED = 11
ROWS_N, ROWS_ANCESTORS, ROWS_MUTANTS, ROWS_LENGTH = 20480, 1024, 20, 10000
ROWS_SEED = 12
# item counts of the kernel-vs-plain phase: tile edges and ragged tails
KERNEL_SIZES = (1, 2, 63, 129, 1000, 1025, 4097)
# register counts of tri_eq's and tri_comb's kernel-vs-plain phase
NIBBLE_MS = (30, 62, 64, 96, 98, 100, 126, 128, 130, 256, 1024)
# peak rates of one H100 SXM at 700 W: int8 tensor operations (dense,
# from NVIDIA's H100 datasheet) and, for the integer kernels, the
# SM's 64 INT32 lanes and 16 popcount lanes a clock x 132 SMs x 1.98 GHz
# boost (Hopper's SM layout), its 128 FP32 lanes (an f32 operation or
# fused multiply-add each: the datasheet's 67 TFLOP/s counts an fma as
# two) and its 64 FP64 lanes (the datasheet's 33.5 TFLOP/s, an fma as
# two); device memory 3.35 TB/s
RATES = {"int8": 1.979e15, "int32": 132 * 64 * 1.98e9,
         "popc": 132 * 16 * 1.98e9, "f32": 132 * 128 * 1.98e9,
         "f64": 132 * 64 * 1.98e9}
HBM = 3.35e12


def _say(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches, by CUDA events."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _bound(ops: float, kind: str, nbytes: float):
    """(bound ms, what sets it): the larger of `ops` operations at the
    peak rate of `kind` and `nbytes` (each input read once, each output
    written once) at the memory rate."""
    t_ops = ops / RATES[kind] * 1e3
    t_bytes = nbytes / HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _library_ms(fn, reps: int) -> float:
    """Mean device time of one PyTorch call, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    return _cuda_ms(fn, reps)


def _nibble_operands(packed, combined: bool):
    """The (N, 16m) int8 operands of the JAX package's nibble products,
    transposed: enc_onehot_T's [a == v] and, with `combined`,
    enc_combined_T's [a == v] - 128 [a < v], register-major
    k = 16 r + v in its register order (low nibbles, then high)."""
    import torch
    regs = torch.cat([packed & 0xF, packed >> 4], dim=1)
    lv = torch.arange(16, dtype=torch.uint8, device=packed.device)
    n, m = regs.shape
    eq = (regs.unsqueeze(2) == lv).to(torch.int8).reshape(n, 16 * m)
    if not combined:
        return eq, eq
    lt = (regs.unsqueeze(2) < lv).to(torch.int8).reshape(n, 16 * m)
    return eq, eq + lt * -128


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    _say(f"[device] nvidia-smi: {smi}")
    _say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from dashing2_tpu_torch import native
    from dashing2_tpu_torch.ops import countsketch as CS
    from dashing2_tpu_torch.ops import css as CSS
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.ops import omh as OP
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.ops import weighted_draws as WD
    builds = {"tri_eq": NT.load_kernel, "tri_comb": NC.load_kernel,
              "gtlt": G.load_kernel, "int_counts": IC.load_kernel,
              "weighted_draws": WD.load_kernel, "omh": OP.load_kernel,
              "oph_rows": OR.load_kernel,
              "css": CSS.load_kernel,
              "countsketch": CS.load_kernel,
              "countsketch_dense": _cs_dense_lib,
              "ophsketch": native.load_oph_lib,
              "fastx": native.load_fastx_lib,
              "emitfmt": native.load_emit_lib,
              "myersed": native.load_myers_lib,
              "spaned": native.load_span_lib}

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        secs = {name: f.result() for name, f in futs.items()}
    _say(f"[build] all {len(builds)} in {time.perf_counter() - t0:.3f} s, in "
         "parallel: " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    for name in ("tri_eq", "tri_comb", "gtlt", "int_counts",
                 "weighted_draws", "omh", "oph_rows", "css",
                 "countsketch"):
        for ln in native.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                _say(f"[build] ptxas {name}: {ln.strip()}")


def _planted(rng, n: int, m: int):
    import numpy as np
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    if n >= 2:
        a[n - 1] = a[0]
    if n >= 4:
        a[1] = 0x00
        a[2] = 0xFF
    if n >= 64:
        a[60:63] = a[5]
    return a


def phase_kernel_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    rng = np.random.default_rng(2026)
    worst_eq = 0
    for m in NIBBLE_MS:
        for n in KERNEL_SIZES:
            a = torch.from_numpy(_planted(rng, n, m)).cuda()
            got = NT.tri_eq_counts(a, m).to(torch.int32)
            want = NT.tri_eq_counts_plain(a, m).to(torch.int32)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            worst_eq = max(worst_eq, err)
            assert err == 0, f"kernel != plain at n={n} m={m}: {err}"
            diag = got.diagonal()
            assert int(diag.min()) == int(diag.max()) == m
        tc = sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
        th = sim_table("nibble-bbit", m, 0.5, "cpu").numpy()
        assert np.array_equal(tc.view(np.uint32), th.view(np.uint32)), m
    _say("[kernel] tri_eq_counts == plain (exact u16, diagonal m) at n in "
         "{1, 2, 63, 129, 1000, 1025, 4097} x m in {"
         + ", ".join(map(str, NIBBLE_MS)) + "}; "
         "card-built sim table == CPU table bit for bit")
    rng = np.random.default_rng(2027)
    worst_comb = 0
    for m in NIBBLE_MS:
        equal = np.broadcast_to(_planted(rng, 1, m), (300, m // 2)).copy()
        for a in [_planted(rng, n, m) for n in KERNEL_SIZES] + [equal]:
            a = torch.from_numpy(a).cuda()
            n = a.shape[0]
            got = NC.tri_comb_counts(a, m)
            want = NC.tri_comb_counts_plain(a, m)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("eq", "gt")):
                err = int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                worst_comb = max(worst_comb, err)
                assert err == 0, f"tri_comb {what} != plain at n={n} m={m}"
            assert int(got[0].diagonal().to(torch.int32).min()) == m
            assert int(got[1].diagonal().to(torch.int32).max()) == 0
        assert int(got[0].to(torch.int32).min()) == m      # equal rows
    _say("[kernel] tri_comb_counts == plain (exact u16 eq and gt) at n in "
         "{1, 2, 63, 129, 1000, 1025, 4097} x m in {"
         + ", ".join(map(str, NIBBLE_MS)) + "}, and on 300 equal rows")
    return worst_eq, worst_comb


def _planted_u64(rng, n: int, m: int):
    """(n, m) u64 registers as int64, about half with the top bit set,
    with identical rows, equal registers, all-zero and all-ones rows."""
    import numpy as np
    a = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 4:
        a[2] = 0
        a[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if n >= 64:
        a[60:63] = a[5]
    return a.view(np.int64)


def _max_err(got, want) -> int:
    import torch
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def phase_gtlt_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.ops import gtlt as G
    rng = np.random.default_rng(2028)
    worst_self = worst_rect = 0
    for m in (30, 64, 256, 1024):
        for n in KERNEL_SIZES:
            a = torch.from_numpy(_planted_u64(rng, n, m)).cuda()
            b = torch.from_numpy(_planted_u64(rng, n // 2 + 1, m)).cuda()
            got = G.gtlt_self_counts(a)
            err = _max_err(got, G.gtlt_self_counts_plain(a))
            assert err == 0, f"gtlt_self != plain at n={n} m={m}: {err}"
            assert int(got.diagonal().to(torch.int32).max()) == 0
            worst_self = max(worst_self, err)
            # against a second matrix, and the row-block route's slices
            s = n // 3
            for x, y in ((a, b), (a[s:s + 64], a[s:])):
                for g, w in zip(G.gtlt_counts(x, y),
                                G.gtlt_counts_plain(x, y)):
                    err = _max_err(g, w)
                    assert err == 0, f"gtlt != plain at n={n} m={m}: {err}"
                    worst_rect = max(worst_rect, err)
            torch.cuda.synchronize()
    _say("[kernel] gtlt_self_counts == plain and gtlt_counts == plain (gt "
         "and lt; against a second matrix and on row slices) exactly at n "
         "in {1, 2, 63, 129, 1000, 1025, 4097} x m in {30, 64, 256, 1024}")
    for m in (30, 200, 1024):
        for fused in (True, False):
            tc = sim_table("full", m, 8.0, "cuda", fused).cpu().numpy()
            th = sim_table("full", m, 8.0, "cpu", fused).numpy()
            assert np.array_equal(tc.view(np.uint32), th.view(np.uint32)), m
    _say("[kernel] card-built full sim tables (fused and numpy forms) == "
         "CPU tables bit for bit at m in {30, 200, 1024}")
    return worst_self, worst_rect


def _planted_int(rng, n: int, m: int, dt):
    """(n, m) u8 or u16 registers as the kernels take them (u16 as int16
    bit patterns), with identical rows, equal registers, all-zero and
    all-max rows, and values on both sides of the top bit."""
    import numpy as np
    top = int(np.iinfo(dt).max)
    a = rng.integers(0, top + 1, size=(n, m), dtype=np.uint64).astype(dt)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 5:
        a[2] = 0
        a[3] = top
        a[4, 0::2] = (top + 1) // 2
        a[4, 1::2] = (top + 1) // 2 - 1
    if n >= 64:
        a[60:63] = a[5]
    return a.view(np.int16) if dt == np.uint16 else a


def phase_int_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import int_counts as IC
    rng = np.random.default_rng(2029)
    worst_self = worst_rect = 0
    for dt in (np.uint8, np.uint16):
        for m in (30, 64, 256, 1024):
            for n in KERNEL_SIZES:
                a = torch.from_numpy(_planted_int(rng, n, m, dt)).cuda()
                b = torch.from_numpy(
                    _planted_int(rng, n // 2 + 1, m, dt)).cuda()
                for mode in ("eq", "gtlt"):
                    got = IC.int_counts_self(a, mode)
                    err = _max_err(got, IC.int_counts_self_plain(a, mode))
                    assert err == 0, \
                        f"int_counts_self {mode} != plain at n={n} m={m}"
                    worst_self = max(worst_self, err)
                    diag = got.diagonal().to(torch.int32)
                    assert int(diag.min()) == int(diag.max()) == \
                        (m if mode == "eq" else 0)
                s = n // 3
                for x, y in ((a, b), (a[s:s + 64], a[s:])):
                    for g, w in zip(IC.int_counts(x, y),
                                    IC.int_counts_plain(x, y)):
                        err = _max_err(g, w)
                        assert err == 0, f"int_counts != plain at n={n} m={m}"
                        worst_rect = max(worst_rect, err)
                torch.cuda.synchronize()
    _say("[kernel] int_counts_self == plain (eq and gtlt modes) and "
         "int_counts == plain (eq, gt, lt; against a second matrix and on "
         "row slices) exactly, u8 and u16, at n in {1, 2, 63, 129, 1000, "
         "1025, 4097} x m in {30, 64, 256, 1024}")
    for fd in (0.5, 1.0, 2.0, 4.0):
        kind = "nibble-bbit" if fd == 0.5 else "bbit"
        for m in (30, 256, 1024):
            for fused in (True, False):
                tc = sim_table(kind, m, fd, "cuda", fused).cpu().numpy()
                th = sim_table(kind, m, fd, "cpu", fused).numpy()
                assert np.array_equal(tc.view(np.uint32),
                                      th.view(np.uint32)), (fd, m, fused)
    for fd, b in ((1.0, 1.0545), (2.0, 1.000206), (4.0, 1.0000000031)):
        for m in (30, 1024):
            c = torch.arange(m + 1, dtype=torch.int32)
            cg, cl = torch.meshgrid(c, c, indexing="ij")
            for fused in (True, False):
                on_cpu = E.compressed_ab_measures32(
                    cg, cl, m, b, fd, Measure.SIMILARITY, fused=fused,
                    gb_form="complement")
                on_card = E.compressed_ab_measures32(
                    cg.cuda(), cl.cuda(), m, b, fd, Measure.SIMILARITY,
                    fused=fused, gb_form="complement").cpu()
                assert torch.equal(on_cpu.view(torch.int32),
                                   on_card.view(torch.int32)), (fd, m, fused)
    _say("[kernel] card-built b-bit tables (fd 0.5, 1, 2, 4; fused and numpy "
         "forms) and a/b complement epilogues over every (gt, lt) (fd 1, 2, "
         "4) == CPU bit for bit at m in {30, 256, 1024} (tables) and "
         "{30, 1024} (epilogues)")
    return worst_self, worst_rect


def _corpus(name: str, seed: int, n_anc: int, n_mut: int, length: int,
            divergence=(0.005, 0.05)) -> str:
    from dashing2_tpu_torch.io.corpus import write_corpus
    d = os.path.join(WORK, name)
    paths = write_corpus(os.path.join(d, "fa"), seed, n_anc, n_mut, length,
                         divergence)
    lst = os.path.join(d, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    return lst


def _split(lst: str, every: int):
    """(references list, queries list) next to `lst`: the items whose
    index is not a multiple of `every`, and the others."""
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    d = os.path.dirname(lst)
    refs, queries = os.path.join(d, "refs.txt"), os.path.join(d, "queries.txt")
    with open(refs, "w") as f:
        f.write("\n".join(p for i, p in enumerate(paths) if i % every) + "\n")
    with open(queries, "w") as f:
        f.write("\n".join(paths[::every]) + "\n")
    return refs, queries


def phase_golden(name: str):
    from dashing2_tpu_torch import cli
    with open(os.path.join(ROOT, "tests", "goldens", name)) as f:
        gold = json.load(f)
    c = gold["corpus"]
    lst = _corpus("golden", c["seed"], c["n_ancestors"], c["n_mutants"],
                  c["length"], tuple(c["divergence"]))
    out = os.path.join(WORK, "golden", "out.bin")
    files = {"list.txt": lst, "out.bin": out}
    if "queries_every" in gold:
        files["refs.txt"], files["queries.txt"] = _split(
            lst, gold["queries_every"])
    argv = [files.get(x, x) for x in gold["argv"]] + ["--device", "cuda"]
    assert cli.main(argv) == 0
    with open(out, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    assert (len(data), digest) == (gold["bytes"], gold["sha256"]), digest
    _say(f"[golden] {name} n={gold['n']} m={gold['m']}: sha256 {digest} "
         "matches the committed JAX digest")


def _run_cli(tag: str, argv, n: int, counters, pairs=None):
    """One CLI call with every launch counter set to 0 just before it;
    returns (wall seconds, spans, launches per counter name). `pairs`:
    the pairs the job compares (default N(N-1)/2, the unique pairs; 0
    for jobs whose pairs are known only after the run)."""
    from dashing2_tpu_torch import cli, timing
    timing.reset_spans()
    for mod in counters.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    spans = timing.spans()
    assert rc == 0, rc
    if pairs is None:
        pairs = n * (n - 1) // 2
    rate = (f" for {pairs} pairs: {pairs / wall:.6e} pairs/s" if pairs
            else "")
    _say(f"[{tag}] CLI wall {wall:.3f} s{rate}; launches {launches}")
    return wall, spans, launches


def _say_spans(tag: str, spans, keys) -> None:
    for key in keys:
        _say(f"[{tag}] span {key}: {spans.get(key, 0.0):.6f} s")


def _sketch(lst: str):
    """The corpus' sketches, once for both main paths' kernel checks
    (_prep densifies them in place on first use; a second _prep finds
    nothing left to densify)."""
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.sketch.core import sketch_fastx
    with open(lst) as f:
        groups = [ln.strip() for ln in f if ln.strip()]
    return sketch_fastx(Dashing2DistOptions(k=31, sketchsize=1024), groups)


def _rows_equal(vals, n: int, row_fn) -> None:
    """Every row i of the condensed output equals row_fn(i0, i1)[i - i0]
    over [i + 1, n), for row blocks [i0, i1)."""
    import numpy as np
    off = 0
    for i0 in range(0, n - 1, 1024):
        i1 = min(i0 + 1024, n - 1)
        want = row_fn(i0, i1)
        for i in range(i0, i1):
            row = vals[off:off + n - 1 - i]
            assert np.array_equal(row.view(np.uint32),
                                  want[i - i0, i + 1:].view(np.uint32)), i
            off += n - 1 - i


def _histogram(vals) -> list:
    import numpy as np
    return np.histogram(vals, bins=[0, 1e-9, 0.1, 0.5, 0.9, 1.0001]
                        )[0].tolist()


def phase_main_bbit(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.ops import nibble_tri as NT

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out.bin")
    sig = os.path.join(WORK, "northstar", "ns.sig")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--bbit-sigs", "--binary-output", "-o", sig, "--cmpout", out,
            "-F", lst]
    _, spans, launches = _run_cli("main", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["tri_eq"] >= 1, "the main path never launched tri_eq"
    _say_spans("main", spans, (
        "sketch", "sketch/native-files", "sketch/finalize", "write-sketches",
        "compare+emit", "cmp/prep", "cmp/table", "cmp/h2d", "cmp/kernel",
        "cmp/epilogue", "cmp/d2h", "emit/write"))

    # the same job's registers, once more, for the kernel-vs-plain check
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=1)
    creps, _ = C._prep(opts, sketches)
    packed = torch.from_numpy(creps.data).cuda()
    NT.tri_eq_counts(packed, m)                       # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: NT.tri_eq_counts(packed, m), 20)
    NT.tri_eq_counts_plain(packed, m)                 # warm-up
    plain_ms = _cuda_ms(lambda: NT.tri_eq_counts_plain(packed, m), 3)
    got = NT.tri_eq_counts(packed, m)
    want = NT.tri_eq_counts_plain(packed, m)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    assert err == 0, f"kernel != plain on the main path's registers: {err}"
    t0 = time.perf_counter()
    counts = want.cpu().numpy()
    d2h = time.perf_counter() - t0
    del got, want
    _say(f"[main] tri_eq kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} counts equal; u16 d2h copy {d2h:.6f} s")
    onehot, _ = _nibble_operands(packed, combined=False)
    library_ms = _library_ms(lambda: torch._int_mm(onehot, onehot.t()), 5)
    del onehot
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 16 * m * 2, "int8",
                                n * m // 2 + 2 * n * n)
    _say(f"[main] tri_eq bound {bound_ms:.6f} ms ({bound_by}: N(N+1)/2 "
         f"pairs x 16m int8 MACs x 2 at 1,979 TOP/s); kernel at "
         f"{100 * bound_ms / kernel_ms:.1f}% of it; library torch._int_mm "
         f"over the (N, 16m) int8 one-hot {library_ms:.6f} ms (mean of 5; "
         "all N^2 pairs, the expansion before the timed window)")

    # every emitted value is the table at the plain version's counts
    table = C.sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[counts[i0:i1]])
    _say(f"[main] output == table[plain counts] for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["tri_eq"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_main_ab(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import nibble_comb as NC

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out_ab.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("ab", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["tri_comb"] >= 1, "the a/b path never launched tri_comb"
    _say_spans("ab", spans, (
        "sketch", "sketch/native-files", "sketch/finalize", "compare+emit",
        "cmp/prep", "cmp/h2d", "cmp/kernel", "cmp/epilogue", "cmp/d2h",
        "emit/write"))

    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5)
    creps, _ = C._prep(opts, sketches)
    packed = torch.from_numpy(creps.data).cuda()
    NC.tri_comb_counts(packed, m)                     # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: NC.tri_comb_counts(packed, m), 20)
    NC.tri_comb_counts_plain(packed, m)               # warm-up
    plain_ms = _cuda_ms(lambda: NC.tri_comb_counts_plain(packed, m), 3)
    got = NC.tri_comb_counts(packed, m)
    want = NC.tri_comb_counts_plain(packed, m)
    err = 0
    for g, w, what in zip(got, want, ("eq", "gt")):
        e = int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
        assert e == 0, f"tri_comb {what} != plain on the job's registers"
        err = max(err, e)
    eq = want[0].cpu().to(torch.int32)
    gt = want[1].cpu().to(torch.int32)
    del got, want
    _say(f"[ab] tri_comb kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} eq and gt equal")
    onehot, comb = _nibble_operands(packed, combined=True)
    library_ms = _library_ms(lambda: torch._int_mm(onehot, comb.t()), 5)
    del onehot, comb
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 16 * m * 2, "int8",
                                n * m // 2 + 4 * n * n)
    _say(f"[ab] tri_comb bound {bound_ms:.6f} ms ({bound_by}: one int8 "
         f"product, as enc_combined_T's); kernel at "
         f"{100 * bound_ms / kernel_ms:.1f}% of it; library torch._int_mm "
         f"one-hot x combined {library_ms:.6f} ms (mean of 5; all N^2 "
         "pairs, the encoding before the timed window, no decode)")

    # the card's epilogue == the CPU's on every (gt, lt) at the job's b
    bf = max(creps.b, 1.0 + 1e-9)
    table, gbinv = C._gb_args(bf, m)
    c = torch.arange(m + 1, dtype=torch.int32)
    cg, cl = torch.meshgrid(c, c, indexing="ij")
    for fused in (True, False):
        on_cpu = E.compressed_ab_measures32(
            cg, cl, m, bf, 0.5, Measure.SIMILARITY, table, gbinv, fused)
        on_card = E.compressed_ab_measures32(
            cg.cuda(), cl.cuda(), m, bf, 0.5, Measure.SIMILARITY, table,
            gbinv, fused).cpu()
        assert torch.equal(on_cpu.view(torch.int32),
                           on_card.view(torch.int32)), fused
    _say(f"[ab] card epilogue == CPU epilogue bit for bit on all "
         f"{(m + 1) ** 2} (gt, lt) at b = {bf!r} (fused and numpy forms)")

    # every emitted value is the CPU epilogue at the plain counts
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: E.compressed_ab_measures32(
        gt[i0:i1], m - eq[i0:i1] - gt[i0:i1], m, bf, 0.5,
        Measure.SIMILARITY, table, gbinv).numpy())
    _say(f"[ab] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["tri_comb"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


FULL_SPANS = ("sketch", "sketch/native-files", "sketch/finalize",
              "compare+emit", "cmp/prep", "cmp/table", "cmp/h2d",
              "cmp/kernel", "cmp/epilogue", "cmp/d2h", "emit/write")


def _full_regs(sketches, m: int):
    """The job's ordered u64 registers on the card (int64 bit patterns),
    from the sketches the CLI run made again."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    opts = Dashing2DistOptions(k=31, sketchsize=m)
    C._prep(opts, sketches)
    bits = C._ordered_cached(opts, sketches)
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int64)).cuda()


def phase_main_full(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import gtlt as G

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out_full.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--binary-output",
            "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("full", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["gtlt_self"] >= 1, "the full path never launched gtlt_self"
    _say_spans("full", spans, FULL_SPANS)

    regs = _full_regs(sketches, m)
    G.gtlt_self_counts(regs)                          # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: G.gtlt_self_counts(regs), 20)
    G.gtlt_self_counts_plain(regs)                    # warm-up
    plain_ms = _cuda_ms(lambda: G.gtlt_self_counts_plain(regs), 3)
    got = G.gtlt_self_counts(regs)
    want = G.gtlt_self_counts_plain(regs)
    err = _max_err(got, want)
    assert err == 0, f"gtlt_self != plain on the job's registers: {err}"
    counts = want.cpu().numpy().astype(np.int32)
    del got, want, regs
    _say(f"[full] gtlt_self kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} counts equal")
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 2 * 2 * m, "int32",
                                8 * n * m + 2 * n * n)
    _say(f"[full] gtlt_self bound {bound_ms:.6f} ms ({bound_by}: one 32-bit "
         "integer operation per word of each register pair per count, gt "
         f"and lt); kernel at {100 * bound_ms / kernel_ms:.1f}% of it; "
         "library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the table at the plain counts (gt + gt^T)
    table = C.sim_table("full", m, 8.0, "cpu", fused=True).numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[counts[i0:i1]
                                              + counts[:, i0:i1].T])
    _say(f"[full] output == table[plain gt + lt] for all {n * (n - 1) // 2} "
         f"pairs; similarity counts in [0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) "
         f"[.9,1]: {_histogram(vals)}")
    return dict(launches=launches["gtlt_self"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _int_job(sketches, m: int, fd: float, bbit: bool, n: int):
    """The options, compressed registers (on the card, as pairwise_matrix
    passes them to the kernels) and kind of a `--fastcmp fd` job, from
    the sketches the CLI run made again."""
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd,
                               truncation_method=int(bbit))
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    return opts, creps, kind, C._device_regs(data, torch.device("cuda"))


def _job_epilogue(tag: str, kind: str, opts, creps, n: int):
    """The job's epilogue on the CPU as a function of its counts, after
    holding the card's to it bit for bit over every count: the (m+1)
    table for b-bit kinds, the (m+1)^2 table over every (gt, lt) for
    a/b kinds. Returns fn(eq, gt, lt) of int64 host arrays."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    m = opts.sketchsize
    on_cpu = C._epilogue(kind, opts, creps, n, torch.device("cpu"))
    on_card = C._epilogue(kind, opts, creps, n, torch.device("cuda"))
    c = torch.arange(m + 1, dtype=torch.int32)
    eq_kind = kind.endswith("bbit") or kind == "eqfull"
    if eq_kind:
        host = on_cpu(c, None, None, None, None)
        card = on_card(c.cuda(), None, None, None, None).cpu()
    else:
        cg, cl = torch.meshgrid(c, c, indexing="ij")
        host = on_cpu(None, cg, cl, None, None)
        card = on_card(None, cg.cuda(), cl.cuda(), None, None).cpu()
    assert torch.equal(host.view(torch.int32), card.view(torch.int32)), tag
    table = host.numpy()
    _say(f"[{tag}] card epilogue == CPU epilogue bit for bit on all "
         f"{table.size} counts" + ("" if eq_kind else
                                   f" (gt, lt) at b = {creps.b!r}"))
    if eq_kind:
        return lambda eq, gt, lt: table[eq]
    return lambda eq, gt, lt: table[gt, lt]


INT_JOBS = (("u8-bbit", 1.0, True), ("u8-ab", 1.0, False),
            ("u16-bbit", 2.0, True), ("u16-ab", 2.0, False))


def phase_main_int(tag: str, fd: float, bbit: bool, lst: str, sketches,
                   counters):
    """One `--fastcmp 1|2` job at full size (self-pairs route,
    int_counts_self), checked as the nibble jobs are."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", f"{fd:g}"] \
        + (["--bbit-sigs"] if bbit else []) \
        + ["--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["int_counts_self"] >= 1, \
        f"the {tag} job never launched int_counts_self"
    _say_spans(tag, spans, FULL_SPANS)

    opts, creps, kind, regs = _int_job(sketches, m, fd, bbit, n)
    mode = "eq" if bbit else "gtlt"
    IC.int_counts_self(regs, mode)                    # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: IC.int_counts_self(regs, mode), 20)
    IC.int_counts_self_plain(regs, mode)              # warm-up
    plain_ms = _cuda_ms(lambda: IC.int_counts_self_plain(regs, mode), 3)
    got = IC.int_counts_self(regs, mode)
    want = IC.int_counts_self_plain(regs, mode)
    err = _max_err(got, want)
    assert err == 0, f"int_counts_self != plain on the {tag} registers"
    counts = want.cpu().numpy().astype(np.int64)
    del got, want
    _say(f"[{tag}] int_counts_self ({mode}) kernel {kernel_ms:.6f} ms (CUDA "
         f"events, mean of 20 after a warm-up); plain {plain_ms:.6f} ms "
         f"(mean of 3); full {n}x{n} counts equal")
    width = regs.element_size()
    ncounts = 1 if bbit else 2          # eq; or neq and gt (lt = m - eq - gt)
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * ncounts * m * width / 4,
                                "popc", width * n * m + 2 * n * n)
    library_ms = None
    if bbit:
        x = (regs.to(torch.int32) & 0xFFFF).to(torch.float32)   # u8, u16
        library_ms = _library_ms(lambda: torch.cdist(x, x, p=0), 3)
        del x
    del regs
    _say(f"[{tag}] int_counts_self bound {bound_ms:.6f} ms ({bound_by}: one "
         "popcount per 32-bit word of each register pair per count); kernel "
         f"at {100 * bound_ms / kernel_ms:.1f}% of it; library " + (
             f"torch.cdist(x, x, p=0) over the f32 registers {library_ms:.6f}"
             " ms (mean of 3; the unequal-register count, eq = m - d)"
             if bbit else "none (no single PyTorch call computes gt/lt "
             "counts)"))

    # every emitted value is the CPU epilogue at the plain counts
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(
        counts[i0:i1], counts[i0:i1], counts[:, i0:i1].T))
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["int_counts_self"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_main_u32(lst: str, sketches, counters):
    """`--fastcmp 4` (u32 a/b registers) at full size: widened to int64,
    counted by gtlt_self_counts."""
    import numpy as np
    from dashing2_tpu_torch.ops import gtlt as G

    n, m, tag = NORTH_STAR_N, 1024, "u32-ab"
    out = os.path.join(WORK, "northstar", "out_u32.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "4",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["gtlt_self"] >= 1 and launches["int_counts_self"] == 0, \
        launches
    _say_spans(tag, spans, FULL_SPANS)
    opts, creps, kind, regs = _int_job(sketches, m, 4.0, False, n)
    assert kind == "ab" and creps.data.dtype == np.uint32
    counts = G.gtlt_self_counts_plain(regs).cpu().numpy().astype(np.int64)
    del regs
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(
        None, counts[i0:i1], counts[:, i0:i1].T))
    _say(f"[{tag}] output == CPU epilogue at the plain gt/lt counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")


def phase_rowblock(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import gtlt as G

    n, m = ROWS_N, 1024
    assert n > C.SELF_MAX
    out = os.path.join(WORK, "rowblock", "out.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--binary-output",
            "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("rows", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    block = C._block_size(Dashing2DistOptions(k=31, sketchsize=m))
    blocks = -(-n // block)
    assert launches["gtlt"] == blocks and launches["gtlt_self"] == 0, \
        (launches, blocks)
    _say(f"[rows] {blocks} row blocks of {block}: gtlt launched once each")
    _say_spans("rows", spans, FULL_SPANS)

    regs = _full_regs(sketches, m)
    rows, cols = regs[:block], regs
    G.gtlt_counts(rows, cols)                         # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: G.gtlt_counts(rows, cols), 20)
    G.gtlt_counts_plain(rows, cols)                   # warm-up
    plain_ms = _cuda_ms(lambda: G.gtlt_counts_plain(rows, cols), 3)
    err = 0
    for g, w in zip(G.gtlt_counts(rows, cols),
                    G.gtlt_counts_plain(rows, cols)):
        err = max(err, _max_err(g, w))
    assert err == 0, f"gtlt != plain on the job's first block: {err}"
    _say(f"[rows] gtlt kernel {kernel_ms:.6f} ms on one {block}x{n} block "
         f"(CUDA events, mean of 20 after a warm-up); plain {plain_ms:.6f} "
         "ms (mean of 3); gt and lt equal")
    bound_ms, bound_by = _bound(block * n * 2 * 2 * m, "int32",
                                8 * (block + n) * m + 4 * block * n)
    _say(f"[rows] gtlt bound {bound_ms:.6f} ms ({bound_by}: one 32-bit "
         "integer operation per word of each register pair per count, gt "
         f"and lt); kernel at {100 * bound_ms / kernel_ms:.1f}% of it; "
         "library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the CPU epilogue at the plain counts
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        gt, lt = G.gtlt_counts_plain(regs[i0:i1], regs[i0:])
        sim = E.full_setsketch_measures32(gt.cpu(), lt.cpu(), m,
                                          Measure.SIMILARITY, fused=False)
        return C._expand_upper(sim.numpy(), i0, n)
    _rows_equal(vals, n, want)
    _say(f"[rows] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["gtlt"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_rowblock_int(lst: str, sketches, counters):
    """`--fastcmp 1` (u8 a/b) above SELF_MAX: one int_counts launch per
    row block, the numpy-route epilogue."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m, tag = ROWS_N, 1024, "rows-u8"
    out = os.path.join(WORK, "rowblock", "out_u8.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "1",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    opts, creps, kind, regs = _int_job(sketches, m, 1.0, False, n)
    block = C._block_size(opts)
    blocks = -(-n // block)
    assert launches["int_counts"] == blocks \
        and launches["int_counts_self"] == 0 \
        and launches["gtlt"] == launches["gtlt_self"] == 0, (launches, blocks)
    _say(f"[{tag}] {blocks} row blocks of {block}: int_counts launched once "
         "each")
    _say_spans(tag, spans, FULL_SPANS)

    rows = regs[:block]
    IC.int_counts(rows, regs)                         # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: IC.int_counts(rows, regs), 20)
    IC.int_counts_plain(rows, regs)                   # warm-up
    plain_ms = _cuda_ms(lambda: IC.int_counts_plain(rows, regs), 3)
    err = 0
    for g, w in zip(IC.int_counts(rows, regs), IC.int_counts_plain(rows, regs)):
        err = max(err, _max_err(g, w))
    assert err == 0, f"int_counts != plain on the job's first block: {err}"
    _say(f"[{tag}] int_counts kernel {kernel_ms:.6f} ms on one {block}x{n} "
         f"u8 block (CUDA events, mean of 20 after a warm-up); plain "
         f"{plain_ms:.6f} ms (mean of 3); eq, gt and lt equal")
    bound_ms, bound_by = _bound(block * n * 2 * m / 4, "popc",
                                (block + n) * m + 6 * block * n)
    _say(f"[{tag}] int_counts bound {bound_ms:.6f} ms ({bound_by}: one "
         "popcount per 32-bit word of each register pair for eq and for gt; "
         f"lt = m - eq - gt); kernel at {100 * bound_ms / kernel_ms:.1f}% of "
         "it; library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the CPU epilogue at the plain counts
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        _, gt, lt = IC.int_counts_plain(regs[i0:i1], regs[i0:])
        sim = epi(None, gt.cpu().numpy().astype(np.int64),
                  lt.cpu().numpy().astype(np.int64))
        return C._expand_upper(sim, i0, n)
    _rows_equal(vals, n, want)
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["int_counts"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# tag, the job's flags, the self-pairs kernel it launches, and the
# options its flags build (measure by name)
MEASURE_JOBS = (
    ("mash-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs",
                          "--mash-distance"], "tri_eq",
     dict(fd_level=0.5, truncation_method=1, measure="POISSON_LLR")),
    ("union-nibble-ab", ["--fastcmp", "0.5", "--union-size"], "tri_comb",
     dict(fd_level=0.5, measure="UNION_SIZE")),
    ("containment-full-asym", ["--containment", "--asymmetric-all-pairs"],
     "gtlt_self", dict(measure="CONTAINMENT")),
    ("intersection-u8-ab", ["--fastcmp", "1", "--intersection"],
     "int_counts_self", dict(fd_level=1.0, measure="INTERSECTION")),
    ("symcontain-u16-bbit", ["--fastcmp", "2", "--bbit-sigs",
                             "--symmetric-containment"], "int_counts_self",
     dict(fd_level=2.0, truncation_method=1,
          measure="SYMMETRIC_CONTAINMENT")),
    ("eqfull", ["--bbit-sigs"], "gtlt_self", dict(truncation_method=1)),
)


def _plain_self_counts(kind: str, regs, m: int):
    """The (n, n) u16 matrix of the kind's self-pairs kernel, from its
    plain version on the card."""
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    if kind == "nibble-bbit":
        return NT.tri_eq_counts_plain(regs, m)
    if kind == "nibble-ab":
        return NC.tri_comb_counts_plain(regs, m)[1]
    return IC.int_counts_self_plain(regs, "eq" if kind in C._EQ_KINDS
                                    else "gtlt")


def phase_measure(tag: str, flags, counter: str, kw, lst: str, sketches,
                  counters):
    """One job of a measure other than SIMILARITY (or of the
    equality-compared full registers) at full size, self-pairs route."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure

    n, m = NORTH_STAR_N, 1024
    asym = "--asymmetric-all-pairs" in flags
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m)] + flags + [
        "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * (n * n if asym
                                        else n * (n - 1) // 2)
    assert launches[counter] >= 1, f"the {tag} job never launched {counter}"
    _say_spans(tag, spans, FULL_SPANS)

    kw = dict(kw, measure=Measure[kw.get("measure", "SIMILARITY")])
    opts = Dashing2DistOptions(k=31, sketchsize=m, **kw)
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    regs = C._device_regs(data, torch.device("cuda"))
    mat = _plain_self_counts(kind, regs, m).cpu().to(torch.int32)
    del regs
    cards = torch.from_numpy(np.asarray(sketches.cardinalities,
                                        np.float64).astype(np.float32))
    epi = C._epilogue(kind, opts, creps, n, torch.device("cpu"))

    def want(i0, i1):
        c0 = 0 if asym else i0
        v = epi(mat[i0:i1, c0:], mat[i0:i1, c0:], mat[c0:, i0:i1].T,
                cards[i0:i1, None], cards[None, c0:]).numpy()
        return v if asym else C._expand_upper(v, i0, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    if asym:
        sq = vals.reshape(n, n)
        for i0 in range(0, n, 1024):
            assert np.array_equal(sq[i0:i0 + 1024].view(np.uint32),
                                  want(i0, min(i0 + 1024, n))
                                  .view(np.uint32)), i0
    else:
        _rows_equal(vals, n, want)
    _say(f"[{tag}] {kind} {opts.measure.name}: output == CPU epilogue at the "
         f"plain counts and the job's cardinalities for all "
         f"{n * n if asym else n * (n - 1) // 2} values; min "
         f"{float(vals.min())!r} max {float(vals.max())!r}")
    return launches


def phase_rowblock_nibble(tag: str, bbit: bool, lst: str, sketches,
                          counters):
    """`--fastcmp 0.5 [--bbit-sigs]` above SELF_MAX: nibbles unpacked on
    the card, one int_counts launch per row block, the numpy-route
    epilogue; the b-bit job times one unpacked block."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m = ROWS_N, 1024
    out = os.path.join(WORK, "rowblock", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5"] + (
        ["--bbit-sigs"] if bbit else []) + [
        "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=int(bbit))
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    block = C._block_size(opts)
    blocks = -(-n // block)
    assert launches["int_counts"] == blocks \
        and launches["tri_eq"] == launches["tri_comb"] == 0 \
        and launches["int_counts_self"] == 0, (launches, blocks)
    _say(f"[{tag}] {blocks} row blocks of {block}: int_counts launched once "
         "each on the unpacked nibbles, tri_eq and tri_comb never")
    _say_spans(tag, spans, FULL_SPANS + ("cmp/unpack",))

    regs = C._unpack_nibbles(C._device_regs(data, torch.device("cuda")))
    if bbit:
        rows = regs[:block]
        IC.int_counts(rows, regs)                     # warm-up
        torch.cuda.synchronize()
        kernel_ms = _cuda_ms(lambda: IC.int_counts(rows, regs), 20)
        IC.int_counts_plain(rows, regs)               # warm-up
        plain_ms = _cuda_ms(lambda: IC.int_counts_plain(rows, regs), 3)
        for g, w in zip(IC.int_counts(rows, regs),
                        IC.int_counts_plain(rows, regs)):
            assert _max_err(g, w) == 0, "int_counts != plain on nibbles"
        nr = rows.shape[0]
        bound_ms, bound_by = _bound(nr * n * 2 * m / 4, "popc",
                                    (nr + n) * m + 6 * nr * n)
        _say(f"[{tag}] int_counts kernel {kernel_ms:.6f} ms on one "
             f"{nr}x{n} unpacked-nibble block (CUDA events, mean of 20 "
             f"after a warm-up); plain {plain_ms:.6f} ms (mean of 3); eq, gt "
             f"and lt equal; bound {bound_ms:.6f} ms ({bound_by}); kernel at "
             f"{100 * bound_ms / kernel_ms:.1f}% of it")

    epi = C._epilogue(kind, opts, creps, n, torch.device("cpu"))
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        eq, gt, lt = (x.cpu() for x in IC.int_counts_plain(regs[i0:i1],
                                                           regs[i0:]))
        return C._expand_upper(epi(eq, gt, lt, None, None).numpy(), i0, n)
    _rows_equal(vals, n, want)
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return launches


# tag, the job's flags, its rectangular counter, and the options its
# flags build (measure by name)
PANEL_JOBS = (
    ("panel-full", [], "gtlt", dict()),
    ("panel-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs"], "int_counts",
     dict(fd_level=0.5, truncation_method=1)),
    ("panel-u8-ab-containment", ["--fastcmp", "1", "--containment"],
     "int_counts", dict(fd_level=1.0, measure="CONTAINMENT")),
)
PANEL_EVERY = 10            # every tenth genome is a query


def _panel_sketches(sketches, every: int):
    """The sketches in the panel job's order: references (index not a
    multiple of `every`), then queries."""
    import numpy as np
    from dashing2_tpu_torch.result import SketchingResult
    n = len(sketches.names)
    perm = np.concatenate([np.nonzero(np.arange(n) % every)[0],
                           np.arange(0, n, every)])
    return SketchingResult(
        names=[sketches.names[i] for i in perm],
        cardinalities=np.asarray(sketches.cardinalities)[perm].copy(),
        signatures=np.asarray(sketches.signatures)[perm].copy(),
        nq=len(range(0, n, every)))


def phase_panel(tag: str, flags, counter: str, kw, refs: str, queries: str,
                panel, counters):
    """One `-Q` panel job at full size: rectangles only, every value held
    to the CPU epilogue at the plain counts; its kernel timed on one
    4096-row reference block against all the queries."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC

    m, nq = 1024, panel.nq
    n = len(panel.names)
    nf = n - nq
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m)] + flags + [
        "--binary-output", "--cmpout", out, "-F", refs, "-Q", queries]
    wall, spans, launches = _run_cli(tag, argv, n, counters, nf * nq)
    assert os.path.getsize(out) == 4 * nf * nq
    kw = dict(kw, measure=Measure[kw.get("measure", "SIMILARITY")])
    opts = Dashing2DistOptions(k=31, sketchsize=m, **kw)
    block = C._block_size(opts)
    blocks = -(-nf // block)
    others = [k for k in counters if k != counter]
    assert launches[counter] == blocks \
        and all(launches[k] == 0 for k in others), (launches, blocks)
    _say(f"[{tag}] {nf} references x {nq} queries: {counter} launched once "
         f"for each of {blocks} row blocks of {block}, no other kernel")
    _say_spans(tag, spans, FULL_SPANS + ("cmp/unpack",))

    creps, _ = C._prep(opts, panel)
    kind, data = C._representation(opts, panel, creps)
    regs = C._device_regs(data, torch.device("cuda"))
    if kind.startswith("nibble"):
        regs = C._unpack_nibbles(regs)
    rows, cols = regs[:block], regs[nf:]
    if counter == "gtlt":
        kernel, plain = G.gtlt_counts, G.gtlt_counts_plain
        bound_ms, bound_by = _bound(block * nq * 2 * 2 * m, "int32",
                                    8 * (block + nq) * m + 4 * block * nq)
    else:
        kernel, plain = IC.int_counts, IC.int_counts_plain
        bound_ms, bound_by = _bound(block * nq * 2 * m / 4, "popc",
                                    (block + nq) * m + 6 * block * nq)
    kernel(rows, cols)                                # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: kernel(rows, cols), 20)
    plain(rows, cols)                                 # warm-up
    plain_ms = _cuda_ms(lambda: plain(rows, cols), 3)
    err = max(_max_err(g, w) for g, w in zip(kernel(rows, cols),
                                             plain(rows, cols)))
    assert err == 0, f"{counter} != plain on the {tag} block: {err}"
    _say(f"[{tag}] {counter} kernel {kernel_ms:.6f} ms on one {block}x{nq} "
         f"block (CUDA events, mean of 20 after a warm-up); plain "
         f"{plain_ms:.6f} ms (mean of 3); counts equal; bound "
         f"{bound_ms:.6f} ms ({bound_by}); kernel at "
         f"{100 * bound_ms / kernel_ms:.1f}% of it")

    # every emitted value is the CPU epilogue at the plain counts
    epi = C._epilogue(kind, opts, creps, n, torch.device("cpu"), panel=True)
    cards = torch.from_numpy(np.asarray(panel.cardinalities,
                                        np.float64).astype(np.float32))
    vals = np.fromfile(out, dtype=np.float32).reshape(nf, nq)
    assert np.isfinite(vals).all()
    for i0 in range(0, nf, 1024):
        i1 = min(i0 + 1024, nf)
        if counter == "gtlt":
            gt, lt = (x.cpu() for x in plain(regs[i0:i1], cols))
            eq = m - gt.to(torch.int32) - lt.to(torch.int32)
        else:
            eq, gt, lt = (x.cpu() for x in plain(regs[i0:i1], cols))
        want = epi(eq, gt, lt, cards[i0:i1, None], cards[None, nf:]).numpy()
        assert np.array_equal(vals[i0:i1].view(np.uint32),
                              want.view(np.uint32)), i0
    del regs, rows, cols
    _say(f"[{tag}] {kind} {opts.measure.name}: output == CPU epilogue at "
         f"the plain counts for all {nf * nq} values; min "
         f"{float(vals.min())!r} max {float(vals.max())!r}; values in "
         f"[0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches[counter], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


GRAPH_SPANS = ("compare+emit", "lsh-index-build", "lsh-candidates", "refine",
               "emit-neighbors", "dedup-cluster", "dedup-emit", "cmp/h2d",
               "cmp/table", "cmp/pairs", "cmp/pairs-epilogue")
# the KNN job saves its index; the last job loads it and must give the
# same bytes
GRAPH_JOBS = (
    ("knn-full", ["--topk", "10", "--index-save", "IDX"]),
    ("thresh-u8-bbit", ["-T", "0.3", "--fastcmp", "1", "--bbit-sigs"]),
    ("greedy-nibble-bbit", ["--greedy", "0.3", "--fastcmp", "0.5",
                            "--bbit-sigs"]),
    ("knn-index-load", ["--topk", "10", "--index-load", "IDX"]),
)


def _cli_opts(argv):
    """The options the port's CLI builds from `argv` (after "sketch")."""
    import argparse
    from dashing2_tpu_torch import cli
    p = argparse.ArgumentParser()
    cli._add_shared(p)
    return cli._build_opts(p.parse_args(argv[1:]))


def _copy_sketches(sketches):
    import numpy as np
    from dashing2_tpu_torch.result import SketchingResult
    return SketchingResult(
        names=list(sketches.names),
        cardinalities=np.array(sketches.cardinalities, copy=True),
        signatures=np.array(sketches.signatures, copy=True))


def phase_graph(tag: str, flags, lst: str, sketches, counters, outs):
    """One neighbour-graph or dedup job at full size on the card, held
    byte for byte to the same function on the CPU over the same
    sketches (the CPU run saves no index; a job that loads one is held
    to the run that saved it instead, in main); the card's pair counts
    held to the CPU's over every pair the job refined."""
    import numpy as np
    import torch
    from dashing2_tpu_torch import timing
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.cmp import graph as PG
    from dashing2_tpu_torch.ops.pair_counts import pair_counts

    n, m = NORTH_STAR_N, 1024
    idx = os.path.join(WORK, "northstar", "knn.idx")
    flags = [idx if x == "IDX" else x for x in flags]
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m)] + flags + [
        "--binary-output", "--cmpout", out, "-F", lst]
    seen = []
    real = C.measure_pairs

    def counted(opts, result, creps, ia, ib, device="cuda"):
        seen.append((np.array(ia, np.int64), np.array(ib, np.int64)))
        return real(opts, result, creps, ia, ib, device=device)
    C.measure_pairs = counted
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters, 0)
    finally:
        C.measure_pairs = real
    assert not any(launches.values()), launches
    with open(out, "rb") as f:
        got = f.read()
    outs[tag] = got
    head = np.frombuffer(got[:16], np.uint64)
    npairs = sum(len(a) for a, _ in seen)
    what = ("clusters" if "greedy" in tag else "edges")
    count = int(head[0] if "greedy" in tag else head[1])
    _say(f"[{tag}] {count} {what} over {n} items; {npairs} pairs refined "
         f"in {len(seen)} measure_pairs calls; no hand kernel launched")
    _say_spans(tag, spans, GRAPH_SPANS)

    # the same function in-process on the CPU, over the same sketches
    opts = _cli_opts(argv)
    if not opts.index_load:
        opts.outfile_path = out + ".cpu"
        opts.index_save = ""
        timing.reset_spans()
        t0 = time.perf_counter()
        PG.neighbor_graph_main(opts, _copy_sketches(sketches), device="cpu")
        cpu_wall = time.perf_counter() - t0
        with open(opts.outfile_path, "rb") as f:
            assert f.read() == got, f"{tag}: card output != CPU output"
        _say(f"[{tag}] output bytes == neighbor_graph_main on the CPU "
             f"({len(got)} bytes; CPU run {cpu_wall:.3f} s, card CLI run "
             f"{wall:.3f} s incl. sketching)")
        _say_spans(tag + " cpu", timing.spans(), GRAPH_SPANS)

    # the card's pair counts == the CPU's over every refined pair
    res = _copy_sketches(sketches)
    creps, _ = C._prep(opts, res)
    kind, data = C._representation(opts, res, creps)
    regs = C._device_regs(data, torch.device("cuda"))
    if kind.startswith("nibble"):
        regs = C._unpack_nibbles(regs)
    if seen:
        ia = torch.from_numpy(np.concatenate([a for a, _ in seen]))
        ib = torch.from_numpy(np.concatenate([b for _, b in seen]))
        on_card = pair_counts(regs, ia.cuda(), ib.cuda())
        torch.cuda.synchronize()
        ms = _cuda_ms(lambda: pair_counts(regs, ia.cuda(), ib.cuda()), 5)
        host = pair_counts(regs.cpu(), ia, ib)
        for g, w in zip(on_card, host):
            assert torch.equal(g.cpu(), w), f"{tag}: pair counts differ"
        _say(f"[{tag}] card pair counts == CPU pair counts over all {npairs} "
             f"pairs ({kind}); pair_counts on the card {ms:.6f} ms for them "
             "(CUDA events, mean of 5, index copies included)")
    return dict(wall=wall, spans=spans, pairs=npairs, count=count)


FSS_SPANS = ("sketch", "sketch/read", "sketch/hash", "sketch/count",
             "sketch/css", "sketch/finalize", "write-sketches",
             "load-presketched", "compare+emit", "cmp/prep", "cmp/table",
             "cmp/h2d", "cmp/kernel", "cmp/epilogue", "cmp/d2h",
             "emit/write")
# the card's CSetSketch registers against the CPU's, of this many items:
# the same torch code, its f64 log the port's own (ops/fixedmath.py), so
# bit for bit
CSS_SAMPLE = 8


def _css_capture():
    """Wrap css_sketch_many so that a CLI run leaves the passes of every
    item and the distinct hashes of CSS_SAMPLE items spread over the
    corpus; returns (record, undo)."""
    import numpy as np
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    real = SK.css_sketch_many
    rec = {}

    def wrapped(items, m, device="cpu", **kw):
        t0 = time.perf_counter()
        regs, passes = real(items, m, device, **kw)
        rec["seconds"] = time.perf_counter() - t0
        pick = np.linspace(0, len(items) - 1, CSS_SAMPLE).astype(int)
        rec.update(passes=passes, pick=pick,
                   items=[np.array(items[i]) for i in pick],
                   distinct=int(sum(len(x) for x in items)))
        return regs, passes
    SK.css_sketch_many = wrapped

    def undo():
        SK.css_sketch_many = real
    return rec, undo


def _ulps(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isinf(a) & np.isinf(b))
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(same, 0, d)


def phase_fss(lst: str, counters):
    """`--full-setsketch` at full width over the first HALF_N genomes
    (`lst`): the CSetSketch draws on the card, one gtlt_self launch,
    every value held to the table at the plain counts; the card's
    registers of CSS_SAMPLE items held to the CPU's bit for bit, with
    equal counts among them."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import sketch_kernels as SK

    n, m, tag = HALF_N, 1024, "fss"
    out = os.path.join(WORK, "northstar", "fss.bin")
    sig = os.path.join(WORK, "northstar", "fss.sig")
    argv = ["sketch", "-k", "31", "-S", str(m), "--full-setsketch",
            "--binary-output", "-o", sig, "--cmpout", out, "-F", lst]
    rec, undo = _css_capture()
    ops, undo_ops = _capture_css()
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters)
    finally:
        undo()
        undo_ops()
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    others = [k for k in counters if k not in ("gtlt_self", "css")]
    assert launches["gtlt_self"] == 1 and launches["css"] >= 1 \
        and all(launches[k] == 0 for k in others), launches
    hist = np.bincount(rec["passes"])
    _say(f"[{tag}] css launched {launches['css']} time(s), gtlt_self "
         f"once, no other kernel; CSetSketch "
         f"passes (count: items) " + ", ".join(
             f"{p}: {c}" for p, c in enumerate(hist) if c)
         + f"; {rec['distinct']} distinct k-mers "
         f"({rec['distinct'] / n:.1f} an item); css_sketch_many "
         f"{rec['seconds']:.3f} s ({1e3 * rec['seconds'] / n:.4f} ms an "
         "item, host wall incl. uploads)")
    _say_spans(tag, spans, FSS_SPANS)

    # every emitted value is the table at the plain counts
    cards, regs = formats.read_stacked_signatures(sig)
    assert regs.dtype == np.float64 and regs.shape == (n, m)
    assert np.isfinite(cards).all() and cards.min() > 0
    bits = torch.from_numpy(np.ascontiguousarray(
        C._ordered_bits(Dashing2DistOptions(k=31, sketchsize=m), regs)
    ).view(np.int64)).cuda()
    counts = G.gtlt_self_counts_plain(bits).cpu().numpy().astype(np.int32)
    del bits
    table = C.sim_table("full", m, 8.0, "cpu", fused=True).numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[counts[i0:i1]
                                              + counts[:, i0:i1].T])
    _say(f"[{tag}] output == table[plain gt + lt] for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")

    # the card's registers of the sample against the CPU's
    t0 = time.perf_counter()
    cpu_regs, cpu_passes = SK.css_sketch_many(rec["items"], m, "cpu")
    cpu_s = time.perf_counter() - t0
    card_regs = regs[rec["pick"]]
    want = np.where(np.isfinite(cpu_regs), cpu_regs, 0.0)
    assert np.array_equal(card_regs.view(np.int64), want.view(np.int64)), \
        f"card css registers != CPU's " \
        f"({int(_ulps(card_regs, want).max())} ulp)"
    assert np.array_equal(cpu_passes, rec["passes"][rec["pick"]])
    cpu_cards = np.array([SK.css_cardinality(r) for r in cpu_regs])
    assert np.array_equal(cards[rec["pick"]], cpu_cards)
    pair = []
    for x in (card_regs, want):
        b = torch.from_numpy(np.ascontiguousarray(C._ordered_bits(
            Dashing2DistOptions(k=31, sketchsize=m), x)).view(np.int64))
        pair.append(G.gtlt_self_counts_plain(b).numpy())
    assert np.array_equal(pair[0], pair[1]), "card and CPU counts differ"
    _say(f"[{tag}] card css registers == CPU css registers bit for bit "
         f"on {CSS_SAMPLE} items x {m}, and their cardinalities; their "
         f"(gt, lt) counts equal exactly ({CSS_SAMPLE}x{CSS_SAMPLE}); "
         f"CPU css {cpu_s:.3f} s for "
         f"them ({1e3 * cpu_s / CSS_SAMPLE:.3f} ms an item)")
    return dict(launches=launches, wall=wall, css_s=rec["seconds"],
                css_operands=ops)


def phase_fss_bytes(lst: str, counters):
    """`--full-setsketch --fastcmp-bytes` over the first EXACT_SUBSET
    genomes (`lst`): the registers quantised to u8 a/b (a = 20, b = 1.2),
    one int_counts_self launch (gtlt mode), every value held to the CPU
    epilogue at the plain counts."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m, tag = EXACT_SUBSET, 1024, "fss-u8-ab"
    out = os.path.join(WORK, "northstar", "fss_u8.bin")
    sig = os.path.join(WORK, "northstar", "fss_u8.sig")
    argv = ["sketch", "-k", "31", "-S", str(m), "--full-setsketch",
            "--fastcmp-bytes", "--binary-output", "-o", sig, "--cmpout",
            out, "-F", lst]
    wall, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    others = [k for k in counters if k not in ("int_counts_self", "css")]
    assert launches["int_counts_self"] == 1 and launches["css"] >= 1 \
        and all(launches[k] == 0 for k in others), launches
    _say(f"[{tag}] css launched {launches['css']} time(s), "
         "int_counts_self once, no other kernel")
    _say_spans(tag, spans, FSS_SPANS)
    # the header counts f64-sized registers (m / 8 for u8), so the reader
    # returns the u8 registers' bytes as f64
    _, regs = formats.read_stacked_signatures(sig)
    regs = regs.view(np.uint8)
    assert regs.shape == (n, m)
    opts = _cli_opts(argv)
    creps = C.CompressedReps(data=regs, a=opts.compressed_a,
                             b=opts.compressed_b, truncation=0)
    counts = IC.int_counts_self_plain(
        torch.from_numpy(regs).cuda(), "gtlt").cpu().numpy().astype(np.int64)
    epi = _job_epilogue(tag, "ab", opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(
        None, counts[i0:i1], counts[:, i0:i1].T))
    _say(f"[{tag}] u8 values in [{int(regs.min())}, {int(regs.max())}]; "
         f"output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches, wall=wall)


# tag, the cmp job's flags, the stacked file it reads and the sketch
# job's output its bytes must equal, the one kernel it launches and the
# items in the file
PRESKETCHED_JOBS = (
    ("cmp-fss", ["--full"], "fss.sig", "fss.bin", "gtlt_self", HALF_N),
    ("cmp-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs"], "ns.sig",
     "out.bin", "tri_eq", NORTH_STAR_N),
)


def phase_presketched(tag: str, flags, sig: str, want: str, counter: str,
                      n: int, counters):
    """`cmp --presketched` over a sketch job's `-o` output: the bytes of
    that job's --cmpout, one launch of its kernel."""
    d = os.path.join(WORK, "northstar")
    out = os.path.join(d, f"out_{tag}.bin")
    argv = ["cmp", "-k", "31", "--presketched"] + flags + [
        "--binary-output", "--cmpout", out, os.path.join(d, sig)]
    wall, spans, launches = _run_cli(tag, argv, n, counters)
    others = [k for k in counters if k != counter]
    assert launches[counter] == 1 \
        and all(launches[k] == 0 for k in others), launches
    with open(out, "rb") as f, open(os.path.join(d, want), "rb") as g:
        got, ref = f.read(), g.read()
    assert got == ref, f"{tag}: cmp --presketched != the sketch job's bytes"
    _say(f"[{tag}] {counter} launched once; output == the sketch job's "
         f"{want} byte for byte ({len(got)} bytes)")
    _say_spans(tag, spans, FSS_SPANS)
    os.remove(out)
    return dict(launches=launches, wall=wall)


EXACT_SPANS = ("sketch", "sketch/read", "sketch/hash", "sketch/count",
               "compare+emit", "cmp/exact-h2d", "cmp/exact-join", "cmp/d2h",
               "cmp/exact-measures", "cmp/exact-pairs", "emit/write",
               "lsh-index-build", "lsh-candidates", "refine",
               "dedup-cluster", "dedup-emit")


def _say_exact_spans(tag: str, spans) -> None:
    _say_spans(tag, spans, [k for k in EXACT_SPANS if k in spans])
# the jobs held byte for byte to a --device cpu run take the first
# EXACT_SUBSET genomes of the N = 10240 corpus (the CPU join of all of
# them would take minutes); the sampled all-pairs check takes
# EXACT_SAMPLE pairs: every pair of EXACT_FAMILIES families of 20, the
# rest random pairs among 512 random genomes
EXACT_SUBSET, EXACT_SAMPLE, EXACT_FAMILIES = 1024, 4096, 8


def _capture_exact():
    """Keep the result of every sketch_fastx call and every ExactJoin the
    port makes until `undo` is called."""
    from dashing2_tpu_torch.cmp import wcompare as W
    from dashing2_tpu_torch.sketch import core as SC
    rec = {"results": [], "joins": []}
    real_sketch, real_join = SC.sketch_fastx, W.ExactJoin

    def sketch(*args, **kw):
        rec["results"].append(real_sketch(*args, **kw))
        return rec["results"][-1]

    class Join(real_join):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            rec["joins"].append(self)

    SC.sketch_fastx, W.ExactJoin = sketch, Join

    def undo():
        SC.sketch_fastx, W.ExactJoin = real_sketch, real_join
    return rec, undo


def _hold_pairs(tag: str, res, ia, ib):
    """The card's pair lookup over the exact sets of `res` against the
    port's torch engine on CPU tensors, over the pairs' items only; returns
    the intersection sizes."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import wcompare as W
    from dashing2_tpu_torch.result import SketchingResult
    t0 = time.perf_counter()
    card = W.exact_intersections_pairs(res, ia, ib, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    items = np.unique(np.concatenate([ia, ib]))
    sub = SketchingResult(
        names=[res.names[i] for i in items],
        kmer_sets=[res.kmer_sets[i] for i in items],
        kmer_set_counts=(None if res.kmer_set_counts is None else
                         [res.kmer_set_counts[i] for i in items]))
    t0 = time.perf_counter()
    cpu = W.exact_intersections_pairs(sub, np.searchsorted(items, ia),
                                      np.searchsorted(items, ib),
                                      device="cpu")
    cpu_s = time.perf_counter() - t0
    assert np.array_equal(card, cpu), f"{tag}: card pair counts != CPU's"
    padded = W.padded_sets(res, torch.device("cuda"))
    route = "padded lookup" if padded is not None else "posting join"
    _say(f"[{tag}] card pair counts == CPU pair counts over {len(ia)} "
         f"pairs ({route}; "
         f"card {card_s:.3f} s incl. the padded table's first build, CPU "
         f"{cpu_s:.3f} s over {len(items)} items)")
    return cpu


def phase_exact_set(lst: str, counters):
    """`sketch --set` all-pairs over the first HALF_N genomes (`lst`):
    no hand kernel launched, the intersections joined on the card; the
    cardinalities equal the set sizes; EXACT_SAMPLE emitted values equal
    `exact_measures` at the CPU engine's intersections."""
    import numpy as np
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.enums import Measure

    n, tag = HALF_N, "set"
    out = os.path.join(WORK, "northstar", "set.bin")
    argv = ["sketch", "-k", "31", "--set", "--binary-output", "--cmpout",
            out, "-F", lst]
    rec, undo = _capture_exact()
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters)
    finally:
        undo()
    assert not any(launches.values()), launches
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    res, join = rec["results"][0], rec["joins"][0]
    sizes = np.array([len(s) for s in res.kmer_sets])
    assert np.array_equal(res.cardinalities, sizes.astype(np.float64))
    _say(f"[{tag}] no hand kernel launched; {int(sizes.sum())} keys "
         f"({sizes.mean():.1f} an item, {int(sizes.max())} at most); the "
         f"cardinalities == the set sizes; join budget {join.budget} "
         f"entries, {join.subblocks} sub-blocks, {join.entries} entries "
         "expanded")
    _say_exact_spans(tag, spans)

    rng = np.random.default_rng(NS_SEED)
    pairs = []
    for f in rng.choice(n // NS_MUTANTS, EXACT_FAMILIES, replace=False):
        a, b = np.triu_indices(NS_MUTANTS, k=1)
        pairs.append(np.stack([a, b], 1) + f * NS_MUTANTS)
    pool = rng.choice(n, min(n, 512), replace=False)
    need = EXACT_SAMPLE - sum(map(len, pairs))
    ab = rng.choice(pool, size=(2 * need, 2))
    ab = np.sort(ab[ab[:, 0] != ab[:, 1]][:need], axis=1)
    pairs.append(ab)
    ia, ib = np.concatenate(pairs).T
    assert len(ia) == EXACT_SAMPLE
    isz = _hold_pairs(tag, res, ia, ib)
    want = E.exact_measures(isz, res.cardinalities[ia],
                            res.cardinalities[ib], Measure.SIMILARITY,
                            31).astype(np.float32)
    vals = np.fromfile(out, dtype=np.float32)
    got = vals[ia * n - ia * (ia + 1) // 2 + ib - ia - 1]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isfinite(vals).all() and vals.min() >= 0 and vals.max() <= 1
    _say(f"[{tag}] {EXACT_SAMPLE} sampled values == exact_measures at the "
         f"CPU engine's intersections (family pairs' similarity counts in "
         f"[0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) [.9,1]: "
         f"{_histogram(want[:EXACT_SAMPLE - need])}); all values in "
         f"[0, 1]: {_histogram(vals)}")
    return dict(launches=launches, wall=wall)


def _subset_lists(lst: str):
    """(the first EXACT_SUBSET genomes' list, its references, its queries:
    every tenth) in a directory of their own."""
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()][:EXACT_SUBSET]
    d = os.path.join(os.path.dirname(lst), "subset")
    os.makedirs(d, exist_ok=True)
    sub = os.path.join(d, "list.txt")
    with open(sub, "w") as f:
        f.write("\n".join(paths) + "\n")
    return (sub,) + _split(sub, PANEL_EVERY)


# tag and flags of the exact jobs over the first EXACT_SUBSET genomes,
# each held byte for byte to the same job with --device cpu
EXACT_CPU_JOBS = (
    ("countdict-containment-asym", ["--countdict", "--containment",
                                    "--asymmetric-all-pairs", "-F", "SUB"]),
    ("set-panel", ["--set", "-F", "REFS", "-Q", "QUERIES"]),
    ("countdict-greedy", ["--countdict", "--greedy", "0.3", "-F", "SUB"]),
)


def phase_exact_vs_cpu(tag: str, flags, lists, counters):
    sub, refs, queries = lists
    names = {"SUB": sub, "REFS": refs, "QUERIES": queries}
    flags = [names.get(x, x) for x in flags]
    outs = []
    for dev in ("cuda", "cpu"):
        out = os.path.join(os.path.dirname(sub), f"{tag}-{dev}.bin")
        argv = ["sketch", "-k", "31", "--binary-output", "--cmpout", out,
                "--device", dev] + flags
        wall, spans, launches = _run_cli(f"{tag} {dev}", argv, EXACT_SUBSET,
                                         counters, 0)
        assert not any(launches.values()), launches
        _say_exact_spans(f"{tag} {dev}", spans)
        with open(out, "rb") as f:
            outs.append(f.read())
        os.remove(out)
    assert outs[0] == outs[1], f"{tag}: card bytes != CPU bytes"
    _say(f"[{tag}] card output == --device cpu output byte for byte "
         f"({len(outs[0])} bytes); no hand kernel launched")


def phase_exact_knn(lst: str, counters):
    """`--set --topk 10 --index-save`, then `--index-load` of that index,
    over the first HALF_N genomes (`lst`): equal bytes; the card's pair
    counts held to the CPU's over EXACT_SAMPLE / 2 of the refined
    pairs."""
    import numpy as np
    from dashing2_tpu_torch.cmp import core as C

    n = HALF_N
    d = os.path.join(WORK, "northstar")
    idx = os.path.join(d, "set.idx")
    outs, seen = [], []
    real = C.measure_pairs

    def counted(opts, result, creps, ia, ib, device="cuda"):
        seen.append((np.array(ia, np.int64), np.array(ib, np.int64)))
        return real(opts, result, creps, ia, ib, device=device)
    for tag, extra in (("set-knn-save", ["--index-save", idx]),
                       ("set-knn-load", ["--index-load", idx])):
        out = os.path.join(d, f"{tag}.bin")
        argv = ["sketch", "-k", "31", "--set", "--topk", "10",
                "--binary-output", "--cmpout", out, "-F", lst] + extra
        rec, undo = _capture_exact()
        C.measure_pairs = counted
        try:
            wall, spans, launches = _run_cli(tag, argv, n, counters, 0)
        finally:
            C.measure_pairs = real
            undo()
        assert not any(launches.values()), launches
        with open(out, "rb") as f:
            outs.append(f.read())
        npairs = sum(len(a) for a, _ in seen[-1:])
        edges = int(np.frombuffer(outs[-1][:16], np.uint64)[1])
        _say(f"[{tag}] {npairs} candidate pairs, all refined in one "
             f"measure_pairs call; {edges} edges over {n} items; index "
             f"{os.path.getsize(idx)} bytes; cmp/exact-pairs "
             f"{spans.get('cmp/exact-pairs', 0.0):.6f} s")
        _say_exact_spans(tag, spans)
    assert len(seen) == 2 and all(np.array_equal(x, y) for x, y in
                                  zip(seen[0], seen[1]))
    assert outs[0] == outs[1], "the loaded index gave another graph"
    _say("[set-knn] --index-load run == the --index-save run, byte for "
         "byte, over the same candidate pairs")
    ia, ib = seen[0]
    pick = np.random.default_rng(NS_SEED).choice(
        len(ia), min(EXACT_SAMPLE // 2, len(ia)), replace=False)
    _hold_pairs("set-knn", rec["results"][0], ia[pick], ib[pick])


# phase 50: u128 exact sets (`--set`/`--countdict --long-kmers`) over the
# first EXACT_SUBSET genomes, with --cache; CPU checks over U128_CPU
U128_ARGS = ["-k", "40", "--long-kmers"]
U128_CPU = 16
U128_JOBS = (("set128", ["--set"]), ("countdict128", ["--countdict"]))


def phase_u128_sets(lists, counters):
    """`sketch --set` and `--countdict` with `-k 40 --long-kmers --cache
    --outprefix D` all pairs over the first EXACT_SUBSET genomes: no hand
    kernel (the joins in torch on the card, on the keys' ranks); every
    genome's `.kmerset128` (and `.kmercounts.f64`) written, the
    cardinalities the set sizes (the count sums); `cmp --presketched`
    over the --set job's `.kmerset128` files == the --set job's bytes;
    each job and the presketched load of the first U128_CPU genomes'
    files: card bytes == --device cpu bytes."""
    import numpy as np
    from dashing2_tpu_torch import u128 as U
    sub = lists[0]
    with open(sub) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    d = os.path.join(os.path.dirname(sub), "u128")
    os.makedirs(d, exist_ok=True)
    cut = _write_list(os.path.join(d, "cut.txt"), paths[:U128_CPU])
    n = EXACT_SUBSET
    runs = {}
    for tag, flags in U128_JOBS:
        prefix = os.path.join(d, tag)
        os.makedirs(prefix)
        out = os.path.join(d, f"{tag}.bin")
        argv = ["sketch"] + U128_ARGS + flags + ["--binary-output"]
        wall, spans, launches = _run_cli(tag, argv + [
            "--cache", "--outprefix", prefix, "--cmpout", out, "-F", sub],
            n, counters)
        assert not any(launches.values()), launches
        _say_exact_spans(tag, spans)
        assert os.path.getsize(out) == 4 * n * (n - 1) // 2
        vals = np.fromfile(out, dtype=np.float32)
        assert np.isfinite(vals).all() and (vals >= 0).all() \
            and (vals <= 1).all()
        keys = sorted(os.path.join(prefix, f) for f in os.listdir(prefix)
                      if f.endswith(".kmerset128"))
        assert len(keys) == n, len(keys)
        card = float(np.fromfile(keys[0], np.float64, count=1)[0])
        raw = np.fromfile(keys[0], np.uint64, offset=8).reshape(-1, 2)
        u = U.from_words(raw[:, 1], raw[:, 0])
        assert len(u) > 10000 and np.array_equal(
            np.lexsort((u["lo"], u["hi"])), np.arange(len(u))) and len(
            U.unique_counts(u)[0]) == len(u)
        if tag == "set128":
            assert card == len(u)
            pre = os.path.join(d, "presketched.bin")
            _run_cli("set128 presketched", [
                "cmp", "--presketched", "--binary-output", "--cmpout", pre]
                + keys, n, counters)
            _same_bytes([out, pre])
            os.remove(pre)
            cut_keys = keys[:U128_CPU]
        else:
            counts = np.fromfile(keys[0][:keys[0].rfind(".")]
                                 + ".kmercounts.f64", np.float64)
            assert len(counts) == len(u) and card == counts.sum()
        _vs_cpu(f"{tag} cut", argv + ["-F", cut], out + ".cut", U128_CPU,
                counters)
        runs[tag] = dict(wall=wall, launches=launches)
        _say(f"[{tag}] {n} genomes: {n} .kmerset128 files, the first "
             f"holding {len(u)} sorted u128 keys (cardinality {card})")
        os.remove(out)
    _vs_cpu("set128 presketched cut", ["cmp", "--presketched",
                                       "--binary-output"] + cut_keys,
            os.path.join(d, "pre-cut"), U128_CPU, counters)
    shutil.rmtree(d, ignore_errors=True)
    return runs


# ----------------------------------------------------------------------
# weighted sketches (-B, -P): csrc/weighted_draws.cu
# ----------------------------------------------------------------------

# register counts and stream lengths of the draw kernel's check: no
# position, one, the edges of the 2048-position rows, and a genome's
# distinct 31-mers
WEIGHTED_MS = (64, 1000, 1024)
WEIGHTED_LENS = (0, 1, 2047, 2048, 2049, 5000, 20000)
# one draw's operations, counted from the sequence in
# csrc/weighted_draws.cu: a wanghash chain of 64-bit integer operations
# is about 34 int32 lane operations (13 u64 operations, two lanes each,
# the two multiplies three), a keyed u64 two more; an f32 log is 28 f32
# operations (each fused multiply-add one), a u64 -> f64 -> f32
# conversion 3. ICWS: 5 chains, 5 conversions, 4 logs and 13 more f32
# operations (clamps, adds, division, floor, fma); ProbMinHash: 1 chain,
# 1 conversion, 1 log and 2 more
WEIGHTED_OPS = {"icws": (5 * 36, 5 * 3 + 4 * 28 + 13),
                "pmh": (36, 3 + 28 + 2)}
# the timed launch: WEIGHTED_TIME_ITEMS genomes' worth of 20000 distinct
# 31-mers at m = 1024 (512 blocks, enough to fill the card; a launch of
# the N = 10240 job holds about 800 items)
WEIGHTED_TIME_ITEMS = 64
WEIGHTED_SAMPLE = 32
# the long masked stream: three pieces of the split path (PIECE = 32768
# positions), the last one partial
MASKED_LONG = 70000


def _weighted_streams(rng, lens):
    """Each stream's distinct u64 hashes and counts (most 1-3, one in 50
    up to 10^6), with planted repeats: position 5 at 7 (one row) and
    position 100 at 2100 and 4196 (three rows), so that equal keys meet
    inside a row and across rows."""
    import numpy as np
    out = []
    for n in lens:
        h = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        c = np.where(rng.random(n) < 0.02,
                     rng.integers(1, 10 ** 6 + 1, n),
                     rng.integers(1, 4, n)).astype(np.float64)
        for a, b in ((5, 7), (100, 2100), (100, 4196)):
            if b < n:
                h[b], c[b] = h[a], c[a]
        out.append((h, c))
    return out


def _masked_streams(rng):
    """Streams whose weights hold zeros and negative values (a weight of
    0 or less is masked: its log-weight is -inf), one whose every weight
    is 0 or less, over three 2048-position rows, one whose first two
    rows are masked, and one of MASKED_LONG positions, longer than a
    piece of the split path (sketch/weighted.py's PIECE)."""
    import numpy as np
    out = []
    for n, masked in ((1, False), (2049, False), (5000, False),
                      (5000, True), (20000, False), (MASKED_LONG, False)):
        h = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        c = rng.integers(1, 10 ** 6 + 1, n).astype(np.float64)
        u = rng.random(n)
        c[u < 0.2] = 0.0
        c[u > 0.9] *= -1.0
        if masked:
            c = -np.abs(c)
        out.append((h, c))
    out[4][1][:4096] = 0.0
    return out


def _weighted_tensors(kind: str, streams, dev):
    import numpy as np
    import torch
    from dashing2_tpu_torch.sketch import weighted as PW
    lnws = PW._lnw_many(kind, [h for h, _ in streams],
                        [c for _, c in streams])
    off = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(h) for h, _ in streams], out=off[1:])
    h = np.concatenate([h for h, _ in streams]).view(np.int64)
    w = np.concatenate(lnws).astype(np.float32)
    return (torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(off).to(dev))


def phase_weighted_vs_plain():
    """weighted_draws against weighted_draws_plain on the card, bit for
    bit (keys, winners, values), both kinds, every m of WEIGHTED_MS over
    the planted streams; then both timed at the main path's shape."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.ops import weighted_draws as WD
    from dashing2_tpu_torch.sketch import weighted as PW
    rng = np.random.default_rng(NS_SEED)
    streams = _weighted_streams(rng, WEIGHTED_LENS)
    masked = _masked_streams(rng)
    cases = 0
    for tag, items in (("counts", streams), ("masked", masked)):
        for kind in WD.KINDS:
            args = _weighted_tensors(kind, items, "cuda")
            for m in WEIGHTED_MS:
                got = WD.weighted_draws(kind, *args, m)
                torch.cuda.synchronize()
                want = WD.weighted_draws_plain(kind, *args, m)
                for g, w, what in zip(got, want, ("key", "winner", "value")):
                    g, w = g.cpu(), w.cpu()
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    assert torch.equal(g, w), (tag, kind, m, what)
                if tag == "masked":
                    # the all-masked item: key +inf, winner 0, value 0
                    key, win, val = (t[3].cpu() for t in got)
                    assert torch.isinf(key).all() and not win.any() \
                        and not val.any()
                    # the split path (pieces of PIECE positions, merged
                    # on the host) == the plain version over the whole,
                    # unsplit streams
                    hs = [h for h, _ in items]
                    sigs, ids = PW._sketch_many_streams(
                        kind, hs, PW._lnw_many(kind, hs,
                                               [c for _, c in items]),
                        m, "cuda")
                    plain = want[2].cpu().numpy().astype(np.float64)
                    assert np.array_equal(sigs.view(np.int64),
                                          plain.view(np.int64)), \
                        (kind, m, "split registers")
                    assert np.array_equal(ids, want[1].cpu().numpy()), \
                        (kind, m, "split winners")
                cases += 1
    _say(f"[weighted] weighted_draws == weighted_draws_plain bit for bit "
         f"(keys, winners, values) at {cases} shapes: both kinds, m in "
         f"{WEIGHTED_MS}, stream lengths {WEIGHTED_LENS} with planted "
         "repeats inside and across 2048-position rows, and streams with "
         "weights of 0 and below (masked), one all masked, one of "
         f"{MASKED_LONG} positions; over the masked streams the split "
         f"path (pieces of {PW.PIECE} positions merged on the host) == "
         "the plain version over the whole streams (registers, winners)")
    # times at the main path's shape
    runs = {}
    big = _weighted_streams(rng, (20000,) * WEIGHTED_TIME_ITEMS)
    m = 1024
    for kind in WD.KINDS:
        args = _weighted_tensors(kind, big, "cuda")
        WD.weighted_draws(kind, *args, m)
        torch.cuda.synchronize()
        ms = _cuda_ms(lambda: WD.weighted_draws(kind, *args, m), 3)
        plain_ms = _cuda_ms(lambda: WD.weighted_draws_plain(kind, *args, m),
                            1)
        draws = 20000 * WEIGHTED_TIME_ITEMS * m
        n_int, n_f32 = WEIGHTED_OPS[kind]
        nbytes = 12 * 20000 * WEIGHTED_TIME_ITEMS \
            + 12 * WEIGHTED_TIME_ITEMS * m
        t_int = draws * n_int / RATES["int32"] * 1e3
        t_f32 = draws * n_f32 / RATES["f32"] * 1e3
        t_bytes = nbytes / HBM * 1e3
        bound_ms = max(t_int, t_f32, t_bytes)
        runs[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes" if t_bytes >= max(t_int, t_f32)
                          else "operations", err=0)
        _say(f"[weighted] {kind} {WEIGHTED_TIME_ITEMS} items x 20000 "
             f"positions x m {m} ({draws} draws): kernel {ms:.3f} ms "
             f"(CUDA events, mean of 3; {draws / ms / 1e6:.3f} G draws/s), "
             f"plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms "
             f"(int32 {t_int:.3f} ms, f32 {t_f32:.3f} ms, bytes "
             f"{t_bytes:.4f} ms: {100 * bound_ms / ms:.1f}% reached)")
    return runs


def _capture_weighted(fn_name: str):
    """Wrap sketch/weighted.py's `fn_name` (bagminhash_many or
    probminhash_many) so that a CLI run leaves WEIGHTED_SAMPLE items'
    (hashes, counts) spread over the corpus, and the draw seconds;
    returns (record, undo)."""
    import numpy as np
    from dashing2_tpu_torch.sketch import weighted as PW
    real = getattr(PW, fn_name)
    rec = {}

    def wrapped(uniq, counts, m, device="cuda"):
        t0 = time.perf_counter()
        out = real(uniq, counts, m, device)
        rec["seconds"] = time.perf_counter() - t0
        pick = np.linspace(0, len(uniq) - 1, WEIGHTED_SAMPLE).astype(int)
        rec.update(pick=pick, items=[(np.array(uniq[i]), np.array(counts[i]))
                                     for i in pick],
                   positions=int(sum(len(u) for u in uniq)))
        return out
    setattr(PW, fn_name, wrapped)

    def undo():
        setattr(PW, fn_name, real)
    return rec, undo


WEIGHTED_SPANS = ("sketch", "sketch/read", "sketch/hash", "sketch/count",
                  "sketch/weighted", "sketch/h2d", "sketch/draws",
                  "write-sketches", "compare+emit", "cmp/prep", "cmp/h2d",
                  "cmp/kernel", "cmp/epilogue", "cmp/d2h", "emit/write")


def phase_wmh(lst: str, counters):
    """`sketch -B -o wmh.sig` all pairs over the first HALF_N genomes
    (`lst`): the draws on weighted_draws.cu, one gtlt_self launch over
    the registers' bits; the registers of WEIGHTED_SAMPLE items held to
    the plain version on the card bit for bit, the cardinalities to the
    total counts, every emitted value to the equality table at the
    card's counts."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import weighted_draws as WD

    n, m, tag = HALF_N, 1024, "wmh"
    out = os.path.join(WORK, "northstar", "wmh.bin")
    sig = os.path.join(WORK, "northstar", "wmh.sig")
    argv = ["sketch", "-k", "31", "-S", str(m), "-B", "--binary-output",
            "-o", sig, "--cmpout", out, "-F", lst]
    rec, undo = _capture_weighted("bagminhash_many")
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters)
    finally:
        undo()
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    others = [k for k in counters if k not in ("gtlt_self", "weighted_draws")]
    assert launches["gtlt_self"] == 1 and launches["weighted_draws"] >= 1 \
        and all(launches[k] == 0 for k in others), launches
    draws = rec["positions"] * m
    _say(f"[{tag}] weighted_draws launched {launches['weighted_draws']} "
         f"times, gtlt_self once, no other kernel; {rec['positions']} "
         f"distinct k-mers ({rec['positions'] / n:.1f} an item), {draws} "
         f"draws; bagminhash_many {rec['seconds']:.3f} s "
         f"({draws / rec['seconds'] / 1e9:.3f} G draws/s, host wall incl. "
         "uploads)")
    _say_spans(tag, spans, WEIGHTED_SPANS)

    cards, regs = formats.read_stacked_signatures(sig)
    assert regs.dtype == np.float64 and regs.shape == (n, m)
    assert ((regs > 0) & (regs < 1)).all()
    # the sample's registers: the plain version on the card
    streams = rec["items"]
    args = _weighted_tensors("icws", streams, "cuda")
    t0 = time.perf_counter()
    _, _, val = WD.weighted_draws_plain("icws", *args, m)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    want = val.cpu().numpy().astype(np.float64)
    assert np.array_equal(regs[rec["pick"]].view(np.int64),
                          want.view(np.int64)), "registers != plain"
    assert np.array_equal(cards[rec["pick"]],
                          [c.sum() for _, c in streams])
    _say(f"[{tag}] registers of {WEIGHTED_SAMPLE} items == the plain "
         f"version on the card bit for bit ({plain_s:.3f} s for them); "
         "their cardinalities == their total counts")
    # every value: the equality table at the card's eq counts
    bits = torch.from_numpy(np.ascontiguousarray(regs).view(np.int64)).cuda()
    gt = G.gtlt_self_counts(bits)
    plain = G.gtlt_self_counts_plain(bits)
    torch.cuda.synchronize()
    assert torch.equal(gt, plain), "gtlt_self != plain"
    g = gt.cpu().numpy().astype(np.int32)
    del bits, gt, plain
    table = C.measure_table("eqfull", m, 8.0, Measure.SIMILARITY,
                            fused=True).numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[
        m - g[i0:i1] - g[:, i0:i1].T])
    _say(f"[{tag}] output == equality table[m - gt - lt] at the card's "
         f"counts (== plain) for all {n * (n - 1) // 2} pairs; similarity "
         f"counts in [0,1e-9) [.1,.5) ...: {_histogram(vals)}")
    return dict(launches=launches["weighted_draws"], wall=wall,
                seconds=rec["seconds"], draws=draws)


def phase_pmh_countsketch(lst: str, counters):
    """`-P -c 1048576` over the first 8 genomes at -S 256 on the card,
    byte-equal to the same job with --device cpu."""
    d = os.path.join(WORK, "northstar")
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()][:8]
    sub = os.path.join(d, "first8.txt")
    with open(sub, "w") as f:
        f.write("\n".join(paths) + "\n")
    tag = "pmh-c"
    argv = ["sketch", "-k", "31", "-S", "256", "-P", "-c", "1048576",
            "--binary-output", "-F", sub]
    outs = []
    for dev in ("cuda", "cpu"):
        out = os.path.join(d, f"pmh_c_{dev}.bin")
        if dev == "cuda":
            streams, undo = _capture_countsketch()
        try:
            wall, spans, launches = _run_cli(f"{tag} {dev}", argv + [
                "--cmpout", out, "--device", dev], len(paths), counters)
        finally:
            if dev == "cuda":
                undo()
        with open(out, "rb") as f:
            outs.append(f.read())
        if dev == "cuda":
            card = launches
            _say_spans(tag, spans, WEIGHTED_SPANS)
    assert card["weighted_draws"] >= 1 and card["gtlt_self"] == 1, card
    assert card["countsketch"] == len(streams) == 1, card
    assert streams[0][1].shape[0] == len(paths) + 1
    assert outs[0] == outs[1] and len(outs[0]) == 4 * 8 * 7 // 2
    _say(f"[{tag}] countsketch called once for the batch of "
         f"{len(paths)} genomes; card bytes == --device cpu bytes "
         f"({len(outs[0])} bytes)")
    return dict(launches=card["weighted_draws"],
                countsketch=card["countsketch"], streams=_cs_set(streams))


def phase_pmh_knn(lst: str, counters):
    """`-P --topk 10` over the first HALF_N genomes (`lst`): the draws
    on the card (the neighbour
    job's pair counts run plain PyTorch on the card, no hand kernel);
    the output bytes == neighbor_graph_main on the CPU over the same
    sketches."""
    from dashing2_tpu_torch import timing
    from dashing2_tpu_torch.cmp import graph as PG
    from dashing2_tpu_torch.sketch import core as SC
    n, m, tag = HALF_N, 1024, "pmh-knn"
    out = os.path.join(WORK, "northstar", "pmh_knn.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "-P", "--topk", "10",
            "--binary-output", "--cmpout", out, "-F", lst]
    real = SC.sketch_fastx
    kept = []

    def keep(opts, groups, device="cuda"):
        res = real(opts, groups, device=device)
        kept.append(_copy_sketches(res))
        return res
    SC.sketch_fastx = keep
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters, 0)
    finally:
        SC.sketch_fastx = real
    others = [k for k in counters if k != "weighted_draws"]
    assert launches["weighted_draws"] >= 1 \
        and all(launches[k] == 0 for k in others), launches
    with open(out, "rb") as f:
        got = f.read()
    _say_spans(tag, spans, WEIGHTED_SPANS + GRAPH_SPANS[1:])
    opts = _cli_opts(argv)
    opts.outfile_path = out + ".cpu"
    timing.reset_spans()
    t0 = time.perf_counter()
    PG.neighbor_graph_main(opts, kept[0], device="cpu")
    cpu_wall = time.perf_counter() - t0
    with open(opts.outfile_path, "rb") as f:
        assert f.read() == got, f"{tag}: card output != CPU output"
    _say(f"[{tag}] weighted_draws launched {launches['weighted_draws']} "
         f"times, no other kernel; output bytes == neighbor_graph_main on "
         f"the CPU ({len(got)} bytes; CPU graph {cpu_wall:.3f} s)")
    return dict(launches=launches["weighted_draws"], wall=wall)


# ----------------------------------------------------------------------
# interval inputs (--bed, --bigwig, --leafcutter), wsketch, -s + contain
# ----------------------------------------------------------------------

INTERVAL_SEED = 13
INTERVAL_M = 1024
# BED: peak files of a transcription factor's ChIP-seq size, sharing
# intervals by family, over 24 chromosomes
# (16 files, to leave phase 35 room in the run's time limit)
BED_FILES, BED_FAMILIES, BED_SHARED = 8, 4, 0.6
BED_INTERVALS = (10000, 20000)
BED_WIDTH = (200, 1000)
BED_CHROMS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]
BED_CHROM_LEN = 50_000_000
# the --device cpu checks: the first BED_CPU_FILES files whole for the
# set-space jobs, cut to their first BED_CPU_INTERVALS intervals for the
# weighted ones (the plain ICWS draws run at a few hundred ns on the CPU)
BED_CPU_FILES, BED_CPU_INTERVALS = 4, 4
# the items of each weighted interval job held to a reference over their
# whole streams (_capture_interval_draws): as many as fit this many
# 2048-position rows of the plain version, and the shortest
# INTERVAL_LONG of those longer than that
INTERVAL_PLAIN_ROWS, INTERVAL_LONG = 96, 2
BED_JOBS = (("bed-oph", []), ("bed-fss", ["--full-setsketch"]),
            ("bed-bmh-norm", ["-B", "--normalize-intervals"]),
            ("bed-pmh", ["-P"]))
# BigWig: tracks of 2 chromosomes of 10 Mbp and one unplaced contig (of
# the length of GRCh38's chr1_KI270706v1_random), about half covered by
# spans of 10-200 bp, in two families; the CPU check over the first
# BW_CPU_TRACKS tracks cut to their first BW_CPU_LEN bases
BW_TRACKS, BW_SPAN = 8, (10, 200)
BW_CHROMS = (("chr1", 10_000_000), ("chr2", 10_000_000),
             ("chr1_KI270706v1_random", 175_055))
BW_CPU_TRACKS, BW_CPU_LEN = 2, 4_000
BW_JOBS = (("bw-pmh", ["-P"]), ("bw-bmh-by-chrom", ["-B", "--by-chrom"]))
# LeafCutter: one perind table; the CPU check over its first LF_CPU_LINES
# junctions
LF_SAMPLES, LF_JUNCTIONS, LF_CPU_LINES = 100, 20000, 25
# wsketch: a single-cell count matrix (u32 gene ids of a 30000-gene
# vocabulary, f32 counts, u64 indptr); the CPU check over its first rows
# (32 rows, 4 for -B: the plain draws take 100-700 ns each on the CPU)
WS_ROWS, WS_NNZ, WS_GENES = 10000, (1000, 3000), 30000
WS_JOBS = (("ws-bmh", ["-B"], 4), ("ws-pmh", ["-P"], 32),
           ("ws-set", ["-q"], 32))
# contain: queries of CONTAIN_GENOMES corpus genomes, each mutated at
# CONTAIN_RATE, screened against the corpus' -s database
CONTAIN_QUERIES, CONTAIN_GENOMES, CONTAIN_RATE = 64, 50, 0.01
INTERVAL_SPANS = ("sketch", "sketch/read", "sketch/intervals",
                  "sketch/css", "sketch/weighted", "sketch/h2d",
                  "sketch/draws", "compare+emit", "cmp/kernel")
WS_SPANS = ("sketch/css", "sketch/weighted", "sketch/h2d", "sketch/draws",
            "wsketch/write")
CONTAIN_SPANS = ("contain/db", "contain/hash", "contain/lookup",
                 "contain/emit")


def _write_bigwig(path: str, chroms, per_block: int = 1024) -> None:
    """A BigWig of bedGraph blocks of `per_block` items: `chroms` maps a
    name to (starts, ends, values) arrays. The layout of
    tests/test_subcommands.py's `_write_bigwig_multi` (header, a flat
    chrom B+ tree, zlib blocks after a u64 block count, one R-tree leaf
    node), with several blocks a chromosome and numpy item packing."""
    import struct
    import zlib
    import numpy as np
    names = list(chroms)
    key_size = max(len(n.encode()) for n in names)
    tree = struct.pack("<IIIIQQ", 0x78CA8C91, len(names), key_size, 8,
                       len(names), 0) + struct.pack("<BBH", 1, 0, len(names))
    for cid, n in enumerate(names):
        tree += n.encode().ljust(key_size, b"\0") + struct.pack(
            "<II", cid, int(chroms[n][1][-1]) if len(chroms[n][1]) else 0)
    data_off = 64 + len(tree)
    rec = np.dtype([("s", "<u4"), ("e", "<u4"), ("v", "<f4")])
    data, leaves = [], []
    off = data_off + 8
    for cid, n in enumerate(names):
        s, e, v = chroms[n]
        for b in range(0, len(s), per_block):
            items = np.empty(min(per_block, len(s) - b), rec)
            items["s"], items["e"] = s[b:b + per_block], e[b:b + per_block]
            items["v"] = v[b:b + per_block]
            comp = zlib.compress(struct.pack(
                "<IIIIIBBH", cid, int(items["s"][0]), int(items["e"][-1]),
                0, 0, 1, 0, len(items)) + items.tobytes())
            leaves.append((cid, int(items["s"][0]), int(items["e"][-1]),
                           off, len(comp)))
            data.append(comp)
            off += len(comp)
    index_off = off
    rtree = struct.pack("<IIQIIIIQIi", 0x2468ACE0, 256, len(leaves), 0,
                        leaves[0][1], len(names) - 1, leaves[-1][2],
                        index_off, 512, 0)
    rtree += struct.pack("<BBH", 1, 0, len(leaves))
    for cid, s0, e0, o, size in leaves:
        rtree += struct.pack("<IIIIQQ", cid, s0, cid, e0, o, size)
    hdr = struct.pack("<IHHQQQHHQQIQ", 0x888FFC26, 4, 0, 64, data_off,
                      index_off, 0, 0, 0, 0, 1 << 15, 0)
    with open(path, "wb") as f:
        f.write(hdr + tree + struct.pack("<Q", len(data)))
        for comp in data:
            f.write(comp)
        f.write(rtree)


def _write_list(path: str, paths) -> str:
    with open(path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return path


def _bed_files(d: str):
    """BED_FILES peak files: each takes BED_SHARED of its peaks from its
    family's peak set and draws the rest, sorted by chromosome and start;
    returns the list file and the paths."""
    import numpy as np
    rng = np.random.default_rng(INTERVAL_SEED)
    os.makedirs(d, exist_ok=True)
    fams = []
    for _ in range(BED_FAMILIES):
        n = BED_INTERVALS[1]
        fams.append((rng.integers(0, len(BED_CHROMS), n),
                     rng.integers(0, BED_CHROM_LEN - BED_WIDTH[1], n),
                     rng.integers(BED_WIDTH[0], BED_WIDTH[1] + 1, n)))
    paths = []
    for i in range(BED_FILES):
        c, s, w = fams[i % BED_FAMILIES]
        n = int(rng.integers(BED_INTERVALS[0], BED_INTERVALS[1] + 1))
        k = int(BED_SHARED * n)
        pick = rng.choice(len(c), k, replace=False)
        c = np.concatenate([c[pick], rng.integers(0, len(BED_CHROMS), n - k)])
        s = np.concatenate([s[pick], rng.integers(
            0, BED_CHROM_LEN - BED_WIDTH[1], n - k)])
        w = np.concatenate([w[pick], rng.integers(
            BED_WIDTH[0], BED_WIDTH[1] + 1, n - k)])
        order = np.lexsort((s, c))
        p = os.path.join(d, f"peaks{i:02d}.bed")
        with open(p, "w") as f:
            f.write("".join(f"{BED_CHROMS[a]}\t{b}\t{b + e}\tpeak{j}\t0\n"
                            for j, (a, b, e) in enumerate(zip(
                                c[order], s[order], w[order]))))
        paths.append(p)
    return _write_list(os.path.join(d, "list.txt"), paths), paths


def _cut_files(d: str, paths, lines: int):
    """Copies of `paths` cut to their first `lines` lines."""
    os.makedirs(d, exist_ok=True)
    out = []
    for p in paths:
        q = os.path.join(d, os.path.basename(p))
        with open(p) as f, open(q, "w") as g:
            for _, ln in zip(range(lines), f):
                g.write(ln)
        out.append(q)
    return _write_list(os.path.join(d, "list.txt"), out)


def _same_bytes(paths) -> int:
    """The files' shared size; asserts they hold the same bytes."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    assert all(b == blobs[0] for b in blobs[1:]), paths
    return len(blobs[0])


def _capture_interval_draws():
    """Wrap sketch/intervals.py's `_draw_batch` and sketch/weighted.py's
    `_sketch_many_streams` so that a weighted interval job leaves the
    items to hold afterwards, each as (row, distinct items, weight sums,
    winners): items of the job taken in order while their streams fit
    INTERVAL_PLAIN_ROWS rows of ROW_L positions in all ("short"), and
    the INTERVAL_LONG shortest of those longer than that alone ("long").
    Returns (record, undo)."""
    import numpy as np
    from dashing2_tpu_torch.ops.weighted_draws import ROW_L
    from dashing2_tpu_torch.sketch import intervals as SI
    from dashing2_tpu_torch.sketch import weighted as PW
    real_batch, real_streams = SI._draw_batch, PW._sketch_many_streams
    rec = dict(short=[], long=[], rows=0, kind=None)
    wins = []

    def streams(kind, *args, **kw):
        sigs, ids = real_streams(kind, *args, **kw)
        rec["kind"] = kind
        wins.append(ids)
        return sigs, ids

    def batch(opts, items, sigs, cards, dev):
        real_batch(opts, items, sigs, cards, dev)
        if not wins:
            return
        ids = wins.pop()
        for j, (row, p) in enumerate(items):
            rows = -(-len(p[1]) // ROW_L)
            held = (row, p[1], p[2], ids[j])
            if rows > INTERVAL_PLAIN_ROWS:
                rec["long"] = sorted(rec["long"] + [held],
                                     key=lambda x: len(x[1]))[:INTERVAL_LONG]
            elif rec["rows"] + rows <= INTERVAL_PLAIN_ROWS:
                rec["rows"] += rows
                rec["short"].append(held)
    SI._draw_batch, PW._sketch_many_streams = batch, streams

    def undo():
        SI._draw_batch, PW._sketch_many_streams = real_batch, real_streams
    return rec, undo


def _hold_interval_draws(tag: str, rec, sig: str, n: int, m: int):
    """The registers, winners and cardinalities of the items `rec` holds
    (_capture_interval_draws) against their whole, unsplit streams on
    the card: the short items' against weighted_draws_plain, the long
    items' against the kernel (held to the plain version over whole
    masked streams longer than a piece in phase 3; the plain version
    draws about 17 ms a 2048-position row at m = 1024 on an NVIDIA H100
    80GB HBM3 at 700 W, too slow for streams of millions of positions). The registers and cardinalities
    are those the job wrote to `sig` (-o). Returns whether a short item
    was split into pieces and held masked positions."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import weighted_draws as WD
    from dashing2_tpu_torch.sketch import weighted as PW
    cards, regs = formats.read_stacked_signatures(sig)
    assert regs.dtype == np.float64 and regs.shape == (n, m), regs.shape
    kind, split_masked = rec["kind"], False
    for what, held, fn in (("plain version", rec["short"],
                            WD.weighted_draws_plain),
                           ("kernel", rec["long"], WD.weighted_draws)):
        if not held:
            continue
        t0 = time.perf_counter()
        args = _weighted_tensors(kind, [(u, w) for _, u, w, _ in held],
                                 "cuda")
        _, win, val = fn(kind, *args, m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del args
        win = win.cpu().numpy()
        val = val.cpu().numpy().astype(np.float64)
        for i, (row, u, w, ids) in enumerate(held):
            assert np.array_equal(regs[row].view(np.int64),
                                  val[i].view(np.int64)), (tag, row, what)
            assert np.array_equal(ids, win[i]), (tag, row, what, "winners")
            assert cards[row] == w.sum(), (tag, row, "cardinality")
        sizes = [len(u) for _, u, _, _ in held]
        masked = [int((w <= 0).sum()) for _, _, w, _ in held]
        split = [s > PW.PIECE for s in sizes]
        if fn is WD.weighted_draws_plain:
            split_masked = any(a and b for a, b in zip(split, masked))
        _say(f"[{tag}] {len(held)} items of {min(sizes)}-{max(sizes)} "
             f"positions ({sum(split)} split into pieces of {PW.PIECE} by "
             f"the job, {sum(masked)} masked positions): registers, "
             f"winners and cardinalities == the {what} over their whole "
             f"streams on the card ({secs:.3f} s)")
    return split_masked


def _interval_job(tag: str, argv, n: int, counters, weighted: bool):
    """One all-pairs interval job on the card: its launches (the draws
    on weighted_draws.cu for -B/-P, one gtlt_self over the f64 rows, no
    other kernel) and output size; for -B/-P also `-o`, and the
    registers of captured items held (_hold_interval_draws). Returns
    (wall, launches, whether a held item was split and masked)."""
    import numpy as np
    out = argv[argv.index("--cmpout") + 1]
    split_masked = False
    if weighted:
        sig = out + ".sig"
        argv = argv + ["-o", sig]
        rec, undo = _capture_interval_draws()
    try:
        wall, spans, launches = _run_cli(tag, argv, n, counters)
    finally:
        if weighted:
            undo()
    want = {"gtlt_self": 1}
    if weighted:
        assert launches["weighted_draws"] >= 1, launches
        want["weighted_draws"] = launches["weighted_draws"]
    if "--full-setsketch" in argv:
        assert launches["css"] >= 1, launches
        want["css"] = launches["css"]
    assert all(launches[k] == want.get(k, 0) for k in counters), launches
    vals = np.fromfile(out, np.float32)
    assert len(vals) == n * (n - 1) // 2 and np.isfinite(vals).all()
    assert ((vals >= 0) & (vals <= 1)).all()
    _say(f"[{tag}] {n} items, one gtlt_self launch"
         + (f", {launches['weighted_draws']} weighted_draws launches"
            if weighted else "") + f"; similarity in [0,1e-9) [.1,.5) ...: "
         f"{_histogram(vals)}")
    _say_spans(tag, spans, INTERVAL_SPANS)
    if weighted:
        split_masked = _hold_interval_draws(tag, rec, sig, n, INTERVAL_M)
    return wall, launches, split_masked


def _vs_cpu(tag: str, argv, out: str, n: int, counters):
    """The job (`argv` without --cmpout) on the card and with --device
    cpu: equal bytes of the comparison."""
    files = []
    for dev in ("cuda", "cpu"):
        files.append(f"{out}.{dev}")
        _run_cli(f"{tag} {dev}", argv + ["--cmpout", files[-1], "--device",
                                         dev], n, counters)
    size = _same_bytes(files)
    _say(f"[{tag}] card bytes == --device cpu bytes ({size} bytes)")


def phase_bed(counters):
    """BED_FILES peak files through `sketch --bed` on the card: the
    one-permutation default (host), --full-setsketch (CSetSketch draws),
    -B --normalize-intervals and -P (weighted_draws.cu), all pairs;
    each also over the first BED_CPU_FILES files with --device cpu."""
    d = os.path.join(WORK, "bed")
    t0 = time.perf_counter()
    lst, paths = _bed_files(d)
    sizes = [os.path.getsize(p) for p in paths]
    _say(f"[bed] {BED_FILES} files, {sum(sizes) / 1e6:.1f} MB of BED, "
         f"written in {time.perf_counter() - t0:.3f} s")
    sub = _write_list(os.path.join(d, "first.txt"), paths[:BED_CPU_FILES])
    cut = _cut_files(os.path.join(d, "cut"), paths[:BED_CPU_FILES],
                     BED_CPU_INTERVALS)
    runs = {}
    for tag, flags in BED_JOBS:
        weighted = "-B" in flags or "-P" in flags
        base = ["sketch", "--bed", "-S", str(INTERVAL_M), "-p", "8"] \
            + flags + ["--binary-output"]
        wall, launches, _ = _interval_job(tag, base + [
            "--cmpout", os.path.join(d, tag + ".bin"), "-F", lst],
            BED_FILES, counters, weighted)
        runs[tag] = dict(wall=wall, launches=launches)
        _vs_cpu(tag + " first files", base + ["-F", cut if weighted
                                              else sub],
                os.path.join(d, tag + ".first.bin"), BED_CPU_FILES,
                counters)
    return runs


def _bw_tracks(d: str, length: int, tracks: int):
    """BW_TRACKS tracks (the first `tracks`) of the BW_CHROMS cut to
    `length` bases: in each family the same spans, with other values;
    one value in 10 negative, one in 20 zero."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(INTERVAL_SEED + 1)
    layouts = []
    for _ in range(2):
        lay = {}
        for c, clen in BW_CHROMS:
            n = clen // sum(BW_SPAN)
            span = rng.integers(BW_SPAN[0], BW_SPAN[1] + 1, n)
            gap = rng.integers(BW_SPAN[0], BW_SPAN[1] + 1, n)
            s = np.cumsum(span + gap) - span
            keep = s + span <= clen
            lay[c] = (s[keep], (s + span)[keep])
        layouts.append(lay)
    paths = []
    for t in range(BW_TRACKS):
        chroms = {}
        for c, (s, e) in layouts[t % 2].items():
            v = rng.gamma(2.0, 3.0, len(s)).astype(np.float32)
            u = rng.random(len(s))
            v[u < 0.1] *= -1
            v[u > 0.95] = 0
            keep = e <= length
            chroms[c] = (s[keep].astype(np.uint32), e[keep].astype(np.uint32),
                         v[keep])
        if t < tracks:
            p = os.path.join(d, f"track{t}.bw")
            _write_bigwig(p, chroms)
            paths.append(p)
    return _write_list(os.path.join(d, "list.txt"), paths), paths


def phase_bigwig(counters):
    """BW_TRACKS BigWig tracks through `sketch --bigwig -P` and `-B
    --by-chrom` on the card (weighted_draws.cu), all pairs, the
    registers of captured items held over their whole streams (in the
    --by-chrom job an unplaced contig's stream, split into pieces and
    with masked positions, held to the plain version); each job also
    over the first BW_CPU_TRACKS tracks cut to BW_CPU_LEN bases with
    --device cpu."""
    d = os.path.join(WORK, "bigwig")
    t0 = time.perf_counter()
    lst, paths = _bw_tracks(d, max(c for _, c in BW_CHROMS), BW_TRACKS)
    cut, _ = _bw_tracks(os.path.join(d, "cut"), BW_CPU_LEN, BW_CPU_TRACKS)
    _say(f"[bigwig] {BW_TRACKS} tracks, "
         f"{sum(os.path.getsize(p) for p in paths) / 1e6:.1f} MB, written "
         f"in {time.perf_counter() - t0:.3f} s")
    runs = {}
    for tag, flags in BW_JOBS:
        by_chrom = "--by-chrom" in flags
        n = BW_TRACKS * (len(BW_CHROMS) if by_chrom else 1)
        base = ["sketch", "--bigwig", "-S", str(INTERVAL_M), "-p", "8"] \
            + flags + ["--binary-output"]
        wall, launches, split_masked = _interval_job(tag, base + [
            "--cmpout", os.path.join(d, tag + ".bin"), "-F", lst], n,
            counters, True)
        assert split_masked or not by_chrom, \
            f"{tag}: no split item with masked positions held to plain"
        runs[tag] = dict(wall=wall, launches=launches)
        _vs_cpu(tag + " cut tracks", base + ["-F", cut],
                os.path.join(d, tag + ".cut.bin"),
                BW_CPU_TRACKS * (n // BW_TRACKS), counters)
    return runs


def _leafcutter_table(path: str, lines: int) -> None:
    """A perind counts table: LF_SAMPLES samples x the first `lines` of
    LF_JUNCTIONS junctions ("chrom:start:end:cluster"), tokens
    "num/denom" with about a third of the numerators 0."""
    import numpy as np
    rng = np.random.default_rng(INTERVAL_SEED + 2)
    chrom = rng.integers(1, 23, LF_JUNCTIONS)
    start = rng.integers(0, 50_000_000, LF_JUNCTIONS)
    width = rng.integers(100, 20000, LF_JUNCTIONS)
    num = np.where(rng.random((LF_JUNCTIONS, LF_SAMPLES)) < 0.33, 0,
                   rng.geometric(0.05, (LF_JUNCTIONS, LF_SAMPLES)))
    den = num + rng.integers(0, 50, (LF_JUNCTIONS, LF_SAMPLES))
    den[den == 0] = 1
    with open(path, "w") as f:
        f.write("chrom " + " ".join(f"sample{i}" for i in range(LF_SAMPLES))
                + "\n")
        for j in range(lines):
            f.write(f"chr{chrom[j]}:{start[j]}:{start[j] + width[j]}:"
                    f"clu_{j // 3}_+ " + " ".join(
                        f"{a}/{b}" for a, b in zip(num[j], den[j])) + "\n")


def phase_leafcutter(counters):
    """One perind table of LF_SAMPLES samples x LF_JUNCTIONS junctions
    through `sketch --leafcutter -B` on the card; its first LF_CPU_LINES
    junctions also with --device cpu."""
    d = os.path.join(WORK, "leafcutter")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    table = os.path.join(d, "run_perind.counts")
    _leafcutter_table(table, LF_JUNCTIONS)
    cut = os.path.join(d, "cut_perind.counts")
    _leafcutter_table(cut, LF_CPU_LINES)
    _say(f"[leafcutter] {LF_SAMPLES} samples x {LF_JUNCTIONS} junctions, "
         f"{os.path.getsize(table) / 1e6:.1f} MB, written in "
         f"{time.perf_counter() - t0:.3f} s")
    base = ["sketch", "--leafcutter", "-B", "-S", str(INTERVAL_M),
            "--binary-output"]
    wall, launches, _ = _interval_job("lf-bmh", base + [
        "--cmpout", os.path.join(d, "lf.bin"), table], LF_SAMPLES, counters,
        True)
    _vs_cpu("lf-bmh cut table", base + [cut], os.path.join(d, "cut.bin"),
            LF_SAMPLES, counters)
    return {"lf-bmh": dict(wall=wall, launches=launches)}


def _count_matrix():
    """The count matrix: (u32 gene ids, f32 counts, u64 indptr). A row
    holds the distinct genes of WS_NNZ draws, 40% of them from its cell
    type's program (20 types), sorted, with counts 1 + geometric."""
    import numpy as np
    rng = np.random.default_rng(INTERVAL_SEED + 3)
    progs = [rng.choice(WS_GENES, 4000, replace=False) for _ in range(20)]
    nnz = rng.integers(WS_NNZ[0], WS_NNZ[1] + 1, WS_ROWS)
    genes = []
    for r in range(WS_ROWS):
        own = int(0.4 * nnz[r])
        genes.append(np.unique(np.concatenate([
            progs[r % 20][rng.integers(0, 4000, own)],
            rng.integers(0, WS_GENES, int(nnz[r]) - own)])).astype(np.uint32))
    indptr = np.zeros(WS_ROWS + 1, np.uint64)
    np.cumsum([len(g) for g in genes], out=indptr[1:])
    ids = np.concatenate(genes)
    return ids, (1 + rng.geometric(0.4, len(ids))).astype(np.float32), indptr


def _csr(d: str, matrix, rows: int):
    """The matrix's first `rows` rows as wsketch inputs; their paths."""
    ids, w, indptr = matrix
    end = int(indptr[rows])
    os.makedirs(d, exist_ok=True)
    out = []
    for name, arr in (("ids.u32", ids[:end]), ("w.f32", w[:end]),
                      ("indptr.u64", indptr[:rows + 1])):
        p = os.path.join(d, name)
        arr.tofile(p)
        out.append(p)
    return out


def phase_wsketch(counters):
    """A WS_ROWS-row count matrix through `wsketch -B`, `-P` and `-q` on
    the card (--u32 --f32, u64 indptr): -B/-P on weighted_draws.cu, -q
    the CSetSketch draws in torch; the first rows of each (WS_JOBS) also
    with --device cpu, their rows of every output file equal."""
    import numpy as np
    d = os.path.join(WORK, "wsketch")
    t0 = time.perf_counter()
    matrix = _count_matrix()
    full = _csr(d, matrix, WS_ROWS)
    _say(f"[wsketch] {WS_ROWS} rows, "
         f"{os.path.getsize(full[0]) // 4} non-zeros, written in "
         f"{time.perf_counter() - t0:.3f} s")
    runs = {}
    m = INTERVAL_M
    for tag, flags, cpu_rows in WS_JOBS:
        pref = os.path.join(d, tag)
        argv = ["wsketch", "-S", str(m), "--u32", "--f32"] + flags
        wall, spans, launches = _run_cli(tag, argv + ["-o", pref] + full,
                                         WS_ROWS, counters, 0)
        kernel = "css" if tag == "ws-set" else "weighted_draws"
        assert launches[kernel] >= 1 and all(
            launches[k] == 0 for k in counters if k != kernel), launches
        _say_spans(tag, spans, WS_SPANS)
        sub = _csr(os.path.join(d, f"first{cpu_rows}"), matrix, cpu_rows)
        cpref = os.path.join(d, tag + "-cpu")
        _run_cli(f"{tag} first {cpu_rows} rows cpu", argv + [
            "-o", cpref, "--device", "cpu"] + sub, cpu_rows, counters, 0)
        regs = np.fromfile(f"{pref}.sampled.regs.stacked.{WS_ROWS}.{m}.f64",
                           np.uint8)
        cregs = np.fromfile(f"{cpref}.sampled.regs.stacked.{cpu_rows}.{m}"
                            ".f64", np.uint8)
        cards = regs[16:16 + 8 * WS_ROWS].view(np.float64)
        sigs = regs[16 + 8 * WS_ROWS:].view(np.float64).reshape(WS_ROWS, m)
        assert np.array_equal(cregs[16:16 + 8 * cpu_rows].view(np.float64),
                              cards[:cpu_rows])
        assert np.array_equal(cregs[16 + 8 * cpu_rows:].view(np.int64),
                              sigs[:cpu_rows].view(np.int64).reshape(-1))
        for suffix in ("indices", "hashes"):
            a = np.fromfile(f"{pref}.sampled.{suffix}.stacked.{WS_ROWS}.{m}"
                            ".i64", np.uint64).reshape(WS_ROWS, m)
            b = np.fromfile(f"{cpref}.sampled.{suffix}.stacked.{cpu_rows}."
                            f"{m}.i64", np.uint64).reshape(cpu_rows, m)
            assert np.array_equal(a[:cpu_rows], b), suffix
        with open(f"{pref}.sampled.info.txt") as f, \
                open(f"{cpref}.sampled.info.txt") as g:
            assert f.read().splitlines()[:cpu_rows] == g.read().splitlines()
        assert (sigs != 0).any(axis=1).all() and (cards > 0).all()
        _say(f"[{tag}] {WS_ROWS} rows on the card; the first {cpu_rows} "
             "rows' registers, winners, hashes and weights == --device cpu")
        runs[tag] = dict(wall=wall, launches=launches)
    return runs


def _contain_queries(lst: str, d: str):
    """CONTAIN_QUERIES query files of CONTAIN_GENOMES corpus genomes
    each (one record a genome), every base replaced with probability
    CONTAIN_RATE; returns the list file and each query's genomes."""
    import numpy as np
    rng = np.random.default_rng(INTERVAL_SEED + 4)
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    os.makedirs(d, exist_ok=True)
    out, picks = [], []
    for q in range(CONTAIN_QUERIES):
        pick = np.sort(rng.choice(len(paths), CONTAIN_GENOMES,
                                  replace=False))
        recs = []
        for g in pick:
            with open(paths[g], "rb") as f:
                seq = np.frombuffer(b"".join(f.read().split(b"\n")[1:]),
                                    np.uint8).copy()
            hit = rng.random(len(seq)) < CONTAIN_RATE
            seq[hit] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, int(hit.sum()))]
            recs.append(b">g%d\n" % g + seq.tobytes() + b"\n")
        p = os.path.join(d, f"query{q:02d}.fa")
        with open(p, "wb") as f:
            f.write(b"".join(recs))
        out.append(p)
        picks.append(pick)
    return _write_list(os.path.join(d, "queries.txt"), out), picks


def phase_contain(lst: str, counters):
    """`sketch -S 1024 -s -N -o db` over the N = 10240 corpus, then
    `contain db.kmer64` over CONTAIN_QUERIES mutated queries, binary and
    text, the lookup on the card, and both again with --device cpu:
    equal bytes. Each query covers most of its genomes' database keys."""
    import numpy as np
    from dashing2_tpu_torch.io import formats
    d = os.path.join(WORK, "northstar", "contain")
    os.makedirs(d, exist_ok=True)
    n, m = NORTH_STAR_N, INTERVAL_M
    db = os.path.join(d, "db")
    wall, spans, launches = _run_cli(
        "save-kmers", ["sketch", "-k", "31", "-S", str(m), "-s", "-N", "-o",
                       db, "-F", lst], n, counters, 0)
    assert not any(launches.values()), launches
    assert os.path.getsize(db + ".kmer64") == 24 + 8 * n * m
    assert os.path.getsize(db + ".kmercounts.f64") == 8 * n * m
    kdb = formats.read_kmer_db(db + ".kmer64")
    counts = np.fromfile(db + ".kmercounts.f64", np.float64)
    assert kdb.k == 31 and kdb.kmers.shape == (n, m) and (counts >= 1).all()
    _say(f"[save-kmers] {n * m} database keys "
         f"({len(np.unique(kdb.kmers))} distinct), counts of registers "
         f"{counts.min():.0f}-{counts.max():.0f}; CLI wall {wall:.3f} s")
    t0 = time.perf_counter()
    qlst, picks = _contain_queries(lst, os.path.join(d, "q"))
    _say(f"[contain] {CONTAIN_QUERIES} queries of {CONTAIN_GENOMES} genomes "
         f"({CONTAIN_RATE:.0%} mutated) written in "
         f"{time.perf_counter() - t0:.3f} s")
    runs = {}
    for form, flags, devs in (("binary", ["--binary-output"],
                               ("cuda", "cpu")), ("text", [], ("cuda",))):
        outs = []
        for dev in devs:
            out = os.path.join(d, f"contain.{form}.{dev}")
            w, spans, launches = _run_cli(
                f"contain {form} {dev}", ["contain"] + flags + [
                    "--cmpout", out, "-F", qlst, db + ".kmer64", "--device",
                    dev], CONTAIN_QUERIES, counters, 0)
            assert not any(launches.values()), launches
            _say_spans(f"contain {form} {dev}", spans, CONTAIN_SPANS)
            outs.append(out)
            runs[f"{form} {dev}"] = w
        size = _same_bytes(outs)
        _say(f"[contain {form}] {size} bytes"
             + (" == --device cpu bytes" if len(outs) > 1 else ""))
    res = formats.read_contain(os.path.join(d, "contain.binary.cuda"))
    cov = res["coverage_matrix"]
    assert cov.shape == (CONTAIN_QUERIES, n)
    own = np.array([cov[q, picks[q]].min() for q in range(CONTAIN_QUERIES)])
    other = np.array([np.delete(cov[q], picks[q]).mean()
                      for q in range(CONTAIN_QUERIES)])
    assert (own > 0.5).all(), own.min()
    _say(f"[contain] coverage of a query's own genomes: min {own.min():.4f}, "
         f"mean {own.mean():.4f}; of the others: mean {other.mean():.4f}")
    return runs


# ----------------------------------------------------------------------
# the edit-distance space (-E): csrc/omh.cu, exact edit distances
# ----------------------------------------------------------------------

# 512 families x 16 members of 1,000-4,000 bp, each member 1-3% edited
# (substitutions, insertions, deletions) from its ancestor, with planted
# N runs and poly-A tracts (io/corpus.py `edited_sequences`): about 20
# Mbp, the gene-length sequences or amplicons an edit-distance dedup or
# neighbour search runs over
EDIT_SEED = 13
EDIT_FAMILIES, EDIT_MEMBERS = 512, 16
EDIT_N = EDIT_FAMILIES * EDIT_MEMBERS
EDIT_K, EDIT_M = 15, 1024
EDIT_ARGS = ["-k", str(EDIT_K), "-S", str(EDIT_M)]
# register counts and stream lengths of the kernel's check: one
# register, m not a multiple of the 128-register tile, the main path's;
# one position, the edges of the kernel's 1024-position staging steps and
# its 8192-position pieces, a stream of three pieces
OMH_MS = (1, 7, 130, 1024)
OMH_LENS = (1, 1023, 1024, 1025, 8191, 8192, 8193, 20000)
# one valid (position, register) of omh_select: the instructions the
# function needs, the staged word xor the register's salt, the u64
# wanghash chain and the u64 compare with the worst kept key, counted in
# the SASS of csrc/omh.cu by `python3 experiments/omh_sass_ops.py` (nvcc
# and cuobjdump on an NVIDIA H100 machine; every one of the 7 loads of a
# staged word gives the same slice): OMH_ALU on the integer ALU and
# OMH_IMAD IMADs on the FMA pipe (the loop's counter and address
# arithmetic, the valid test, branches and the rare rounding and insert
# left out). ALU and IMAD each issue 64 lanes a clock per SM, the two
# together at most 128, so the bound charges the largest of OMH_ALU,
# OMH_IMAD and (OMH_ALU + OMH_IMAD) / 2 at the int32 rate
OMH_ALU, OMH_IMAD = 20, 9
OMH_OPS = max(OMH_ALU, OMH_IMAD, (OMH_ALU + OMH_IMAD) / 2)
OMH_PLAIN_SLICE = 64         # sequences the plain version is timed over
EDIT_SAMPLE = 32             # sequences held to the plain version on the CPU
EDIT_CUT = 32                # sequences of the --device cpu runs (jobs 3, 4)
EDIT_EDGES = 1000            # edges held to myers_one
# the exact all-pairs job: the first EDIT_ALLPAIRS_N sequences (130,816
# pairs of host Myers distances, about 0.17-0.19 ms a pair on the 8
# threads of an H100 machine's host; 1024 sequences, then 768, until
# the chunked route's phases needed the room)
EDIT_ALLPAIRS_N = 256
EDIT_WHOLE_N = 1024          # whole-file -E over the N = 10240 genomes
EDIT_WHOLE_SAMPLE = 8
EDIT_WHOLE_CUT = 8
EDIT_SPANS = ("sketch", "sketch/read", "sketch/omh", "write-sketches",
              "compare+emit", "cmp/prep", "cmp/h2d", "cmp/kernel",
              "cmp/epilogue", "cmp/d2h", "cmp/editdist", "lsh-index-build",
              "lsh-candidates", "refine", "dedup-cluster", "dedup-emit",
              "emit/write")


def _edit_corpus():
    """(FASTA path, {name: sequence}, records) of the edit corpus under
    build/, and the FASTAs of its first EDIT_CUT and EDIT_ALLPAIRS_N
    records."""
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    d = os.path.join(WORK, "edit")
    recs = edited_sequences(EDIT_SEED, EDIT_FAMILIES, EDIT_MEMBERS)
    fa = write_fasta(os.path.join(d, "seqs.fa"), recs)
    write_fasta(os.path.join(d, "cut.fa"), recs[:EDIT_CUT])
    write_fasta(os.path.join(d, "first.fa"), recs[:EDIT_ALLPAIRS_N])
    return fa, recs


def _codes(seqs):
    from dashing2_tpu_torch.enums import Alphabet
    from dashing2_tpu_torch.ops.kmers import encode_ascii
    return [encode_ascii(s, Alphabet.DNA) for s in seqs]


def phase_omh_vs_plain(recs):
    """omh_registers against omh_registers_plain on the card, bit for bit:
    the planted streams of tests/omh_planted.py (f64 key ties, keys that
    round to 2^64, phantoms before and after a real winner, one and no
    valid window) and random streams of OMH_LENS positions, for every m
    of OMH_MS (ell 2: another depth raises, no launch); the card's
    streams (k-mers and occurrence ranks) equal the CPU's over sequences
    shorter than k, with N runs, all-A runs and fewer valid windows than
    ell; then one launch over the corpus' 8192 sequences timed with CUDA
    events over prebuilt arguments (the piece table on the card), and
    the plain version on the first OMH_PLAIN_SLICE of them."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.ops import omh as OP
    from dashing2_tpu_torch.sketch import omh as PO
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from omh_planted import planted_items, ragged
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(EDIT_SEED)
    items = planted_items()
    for n in OMH_LENS:
        km = rng.integers(0, 1 << 40, n, dtype=np.uint64)
        items.append((km, rng.integers(0, 4, n).astype(np.int64),
                      rng.random(n) > 0.1))
    km, occ, va, off = ragged(items)
    args = [torch.from_numpy(x).cuda() for x in (km.view(np.int64), occ,
                                                 va, off)]
    for m in OMH_MS:
        got = OP.omh_registers(*args, m, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, OP.omh_registers_plain(*args, m, 2)), \
            ("omh", m)
    before = OP.launches.launches
    try:
        OP.omh_registers(*args, 7, 3)
        raise AssertionError("omh_registers took ell = 3")
    except ValueError:
        assert OP.launches.launches == before
    # the streams the sketch builds on the card == the CPU's
    a = np.full(EDIT_K + 40, ord("A"), np.uint8).tobytes()
    seqs = [b"ACGT" * 3, b"ACGTACGTACGTACG", b"N" * 30,
            b"ACGTTGCA" * 2 + b"N" * 20, a, b"ACGT" * 50 + b"N" * 40 + a]
    seqs += [s for _, s in recs[:8]]
    codes = _codes(seqs)
    cpu = PO._streams(codes, EDIT_K, torch.device("cpu"))
    card = PO._streams(codes, EDIT_K, torch.device("cuda"))
    for c, g in zip(cpu, card):
        assert torch.equal(c, g.cpu()), "streams"
    got = OP.omh_registers(*card, EDIT_M, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, OP.omh_registers_plain(*card, EDIT_M, 2))
    _say(f"[omh] omh_registers == omh_registers_plain bit for bit at "
         f"{len(OMH_MS) + 1} shapes: planted ties, phantoms and one or no "
         f"valid window, streams of {OMH_LENS} positions, m in {OMH_MS} "
         "(ell 2; ell 3 refused); the card's k-mers, occurrence ranks and "
         "valid flags == the CPU's over sequences shorter than k, with N "
         "runs, all-A runs and one valid window")

    # one launch over the corpus, at the main path's shape
    t0 = time.perf_counter()
    codes = _codes([s for _, s in recs])
    streams = PO._streams(codes, EDIT_K, torch.device("cuda"))
    torch.cuda.synchronize()
    t_streams = time.perf_counter() - t0
    host_off = PO.stream_offsets([len(c) for c in codes], EDIT_K)
    pieces = OP.piece_table(host_off, "cuda")
    OP.omh_registers(*streams, EDIT_M, 2, pieces=pieces)
    torch.cuda.synchronize()
    ms = _cuda_ms(lambda: OP.omh_registers(*streams, EDIT_M, 2,
                                           pieces=pieces), 3)
    full = OP.omh_registers(*streams, EDIT_M, 2)
    kmers, occ, valid, offsets = streams
    end = int(host_off[OMH_PLAIN_SLICE])
    part = (kmers[:end], occ[:end], valid[:end],
            offsets[:OMH_PLAIN_SLICE + 1])
    part_pieces = OP.piece_table(host_off[:OMH_PLAIN_SLICE + 1], "cuda")
    slice_ms = _cuda_ms(lambda: OP.omh_registers(*part, EDIT_M, 2,
                                                 pieces=part_pieces), 3)
    OP.omh_registers_plain(*part, EDIT_M, 2)
    plain_ms = _cuda_ms(lambda: OP.omh_registers_plain(*part, EDIT_M, 2), 1)
    assert torch.equal(full[:OMH_PLAIN_SLICE],
                       OP.omh_registers_plain(*part, EDIT_M, 2))
    npos, nvalid = int(kmers.numel()), int(valid.sum())
    bound_ms, bound_by = _bound(nvalid * EDIT_M * OMH_OPS, "int32",
                                17 * npos + 8 * EDIT_N * EDIT_M)
    _say(f"[omh] {EDIT_N} sequences, {npos} positions ({nvalid} valid), "
         f"m {EDIT_M}: streams on the card {t_streams:.3f} s (host "
         f"encode, copy, k-mers and occurrence ranks); kernel {ms:.3f} ms "
         f"(CUDA events, mean of 3, piece table prebuilt); bound "
         f"{bound_ms:.3f} ms ({bound_by}: {OMH_ALU} ALU and {OMH_IMAD} "
         f"IMAD instructions a valid (position, register), charged as "
         f"{OMH_OPS} at the int32 rate), {100 * bound_ms / ms:.1f}% "
         f"reached; on the first {OMH_PLAIN_SLICE} sequences kernel "
         f"{slice_ms:.3f} ms, plain {plain_ms:.3f} ms (one run), equal "
         "registers; library: none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=0, library_ms=None,
                plain_shape=f"the first {OMH_PLAIN_SLICE} of the {EDIT_N} "
                f"sequences ms and bound_ms cover (kernel there "
                f"{slice_ms:.3f} ms)")


EDIT_PAIR_JOBS = (("edit-full", [], "gtlt_self"),
                  ("edit-nibble", ["--fastcmp", "0.5"], "tri_eq"),
                  ("edit-u8", ["--fastcmp", "1"], "int_counts_self"))


def phase_edit_allpairs(fa: str, recs, counters):
    """`sketch -E --parse-by-seq` all pairs at N = 8192: the full OMH
    words compared for equality (one gtlt_self launch), `--fastcmp 0.5`
    (tri_eq) and `--fastcmp 1` (int_counts_self, eq mode). Each: the
    output's size, its launches, and every value == the CPU epilogue at
    the plain version's counts of the written registers (`-o`); 32
    sampled sequences' registers == the plain version's on the CPU."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.result import SketchingResult
    from dashing2_tpu_torch.sketch import omh as PO
    n, m = EDIT_N, EDIT_M
    d = os.path.join(WORK, "edit")
    sig = os.path.join(d, "edit.sig")
    runs = {}
    for tag, flags, counter in EDIT_PAIR_JOBS:
        out = os.path.join(d, f"{tag}.bin")
        argv = ["sketch", "-E", "--parse-by-seq"] + EDIT_ARGS + flags + [
            "--binary-output", "--cmpout", out] + (
            ["-o", sig] if not runs else []) + [fa]
        wall, spans, launches = _run_cli(tag, argv, n, counters)
        assert os.path.getsize(out) == 4 * n * (n - 1) // 2
        assert launches["omh"] >= 1, f"{tag}: omh never launched"
        assert launches[counter] == 1, (tag, launches)
        _say_spans(tag, spans, EDIT_SPANS)
        cards, sigs = formats.read_stacked_signatures(sig)
        if not runs:
            sample = np.sort(np.random.default_rng(EDIT_SEED).choice(
                n, EDIT_SAMPLE, replace=False))
            want = PO.omh_sketch_many(_codes([recs[i][1] for i in sample]),
                                      EDIT_K, m, device="cpu")
            assert np.array_equal(sigs.view(np.uint64)[sample], want)
            assert np.array_equal(cards, [len(s) for _, s in recs])
            _say(f"[{tag}] the written registers of {EDIT_SAMPLE} sampled "
                 "sequences == the plain version's on the CPU; "
                 "cardinalities == the base counts")
        res = SketchingResult(names=[nm for nm, _ in recs],
                              cardinalities=cards, signatures=sigs)
        opts = _cli_opts(argv)
        creps, res = C._prep(opts, res)
        kind, data = C._representation(opts, res, creps)
        regs = C._device_regs(data, torch.device("cuda"))
        if kind == "nibble-bbit":
            counts = NT.tri_eq_counts_plain(regs, m)
        else:
            counts = IC.int_counts_self_plain(regs, "eq")
        counts = counts.cpu().numpy().astype(np.int64)
        del regs
        epi = _job_epilogue(tag, kind, opts, creps, n)
        vals = np.fromfile(out, dtype=np.float32)
        assert np.isfinite(vals).all()
        _rows_equal(vals, n, lambda i0, i1: epi(counts[i0:i1], None, None))
        _say(f"[{tag}] output == CPU epilogue at the plain counts ({kind}) "
             f"for all {n * (n - 1) // 2} pairs; similarity counts in "
             f"[0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
        runs[tag] = dict(wall=wall, launches=launches)
        os.remove(out)
    return runs


def _myers_one(a: bytes, b: bytes) -> int:
    import ctypes
    import numpy as np
    from dashing2_tpu_torch.native import load_myers_lib
    lib = load_myers_lib()
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    x = np.frombuffer(a + b"\0", np.uint8)
    y = np.frombuffer(b + b"\0", np.uint8)
    return int(lib.myers_one(x.ctypes.data_as(u8p), len(a),
                             y.ctypes.data_as(u8p), len(b)))


def phase_edit_knn(fa: str, recs, counters):
    """`-E --parse-by-seq --compute-edit-distance --topk 10` at N = 8192:
    OMH registers on the card (omh the only kernel), LSH candidates over
    them, exact edit distances on the host; EDIT_EDGES sampled edges'
    distances == myers_one of their sequences, each row ascending; the
    bytes of the job over the first EDIT_CUT sequences == --device
    cpu's."""
    import numpy as np
    from dashing2_tpu_torch.io import formats
    n = EDIT_N
    d = os.path.join(WORK, "edit")
    out = os.path.join(d, "knn.bin")
    flags = ["sketch", "-E", "--parse-by-seq", "--compute-edit-distance",
             "--topk", "10", "--binary-output"] + EDIT_ARGS
    wall, spans, launches = _run_cli("edit-knn", flags + ["--cmpout", out,
                                                          fa], n, counters, 0)
    assert launches["omh"] >= 1 and not any(
        v for k, v in launches.items() if k != "omh"), launches
    _say_spans("edit-knn", spans, EDIT_SPANS)
    indptr, indices, data = formats.read_knn_csr(out)
    assert len(indptr) == n + 1 and len(indices) > 0
    rows = np.repeat(np.arange(n), np.diff(indptr.astype(np.int64)))
    for i in range(n):
        r = data[int(indptr[i]):int(indptr[i + 1])]
        assert (np.diff(r) >= 0).all(), i
    pick = np.random.default_rng(EDIT_SEED).choice(
        len(indices), min(EDIT_EDGES, len(indices)), replace=False)
    for e in pick:
        assert _myers_one(recs[rows[e]][1], recs[indices[e]][1]) \
            == data[e], e
    fam = np.array([int(nm.split("_")[0][3:]) for nm, _ in recs])
    same = float(np.mean(fam[rows] == fam[indices]))
    _say(f"[edit-knn] {len(indices)} edges over {n} sequences "
         f"({100 * same:.1f}% within a family); {len(pick)} sampled edges' "
         "distances == myers_one; rows ascending")
    _vs_cpu("edit-knn cut", flags + [os.path.join(d, "cut.fa")],
            out + ".cut", EDIT_CUT, counters)
    os.remove(out)
    return dict(wall=wall, launches=launches)


def phase_edit_greedy(fa: str, recs, counters):
    """`-E --parse-by-seq --greedy 0.3f` at N = 8192: the clusters as
    FASTA, every representative's sequence its input record byte for
    byte; the bytes over the first EDIT_CUT sequences == --device
    cpu's."""
    n = EDIT_N
    d = os.path.join(WORK, "edit")
    out = os.path.join(d, "dedup.fa")
    flags = ["sketch", "-E", "--parse-by-seq", "--greedy", "0.3f"] \
        + EDIT_ARGS
    wall, spans, launches = _run_cli("edit-greedy", flags + [
        "--cmpout", out, fa], n, counters, 0)
    assert launches["omh"] >= 1 and not any(
        v for k, v in launches.items() if k != "omh"), launches
    _say_spans("edit-greedy", spans, EDIT_SPANS)
    seqs = dict(recs)
    with open(out, "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[-1] == b"" and len(lines) % 2 == 1
    members = 0
    for hdr, seq in zip(lines[0:-1:2], lines[1:-1:2]):
        head = hdr.split(b" ")
        name = head[0].split(b"_", 1)[1].decode()
        assert seqs[name] == seq, name
        members += 1 + (len(head[1].split(b",")) - 1 if len(head) > 1
                        else 0)
    assert members == n, members
    _say(f"[edit-greedy] {len(lines) // 2} clusters of {n} sequences; "
         "every representative's sequence == its input record")
    _vs_cpu("edit-greedy cut", flags + [os.path.join(d, "cut.fa")],
            out + ".cut", EDIT_CUT, counters)
    os.remove(out)
    return dict(wall=wall, launches=launches)


def phase_edit_allpairs_exact(recs, counters):
    """`-E --parse-by-seq --compute-edit-distance` all pairs over the
    first EDIT_ALLPAIRS_N sequences, binary: the size, and 1000 sampled
    values == myers_one."""
    import numpy as np
    n = EDIT_ALLPAIRS_N
    d = os.path.join(WORK, "edit")
    out = os.path.join(d, "ed_all.bin")
    wall, spans, launches = _run_cli("edit-exact", [
        "sketch", "-E", "--parse-by-seq", "--compute-edit-distance",
        "--binary-output", "--cmpout", out] + EDIT_ARGS + [
        os.path.join(d, "first.fa")], n, counters)
    assert launches["omh"] >= 1
    _say_spans("edit-exact", spans, EDIT_SPANS)
    vals = np.fromfile(out, np.float32)
    assert len(vals) == n * (n - 1) // 2
    ia, ib = np.triu_indices(n, 1)
    for p in np.random.default_rng(EDIT_SEED).choice(len(vals), 1000,
                                                     replace=False):
        assert _myers_one(recs[ia[p]][1], recs[ib[p]][1]) == vals[p], p
    npairs = len(vals)
    _say(f"[edit-exact] {npairs} exact distances over {n} sequences, "
         f"{1e3 * spans.get('cmp/editdist', 0.0) / npairs:.4f} ms a pair "
         "(cmp/editdist span); 1000 sampled values == myers_one")
    os.remove(out)
    return dict(wall=wall, launches=launches)


def phase_edit_whole(lst: str, counters):
    """Whole-file `-E` (one item a genome file, streams of about 20,000
    positions, 3 pieces each) over the first EDIT_WHOLE_N genomes of the
    N = 10240 corpus, `-o`: EDIT_WHOLE_SAMPLE genomes' written registers
    == the plain version's on the card; the bytes over the first
    EDIT_WHOLE_CUT genomes == --device cpu's."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.io.fastx import read_fastx
    from dashing2_tpu_torch.ops import omh as OP
    from dashing2_tpu_torch.sketch import omh as PO
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()][:EDIT_WHOLE_N]
    d = os.path.join(WORK, "edit")
    sub = _write_list(os.path.join(d, "whole.txt"), paths)
    cut = _write_list(os.path.join(d, "whole_cut.txt"),
                      paths[:EDIT_WHOLE_CUT])
    out, sig = os.path.join(d, "whole.bin"), os.path.join(d, "whole.sig")
    flags = ["sketch", "-E", "--binary-output"] + EDIT_ARGS
    wall, spans, launches = _run_cli("edit-whole", flags + [
        "-o", sig, "--cmpout", out, "-F", sub], EDIT_WHOLE_N, counters)
    assert launches["omh"] >= 1 and launches["gtlt_self"] == 1, launches
    _say_spans("edit-whole", spans, EDIT_SPANS)
    _, sigs = formats.read_stacked_signatures(sig)
    pick = np.sort(np.random.default_rng(EDIT_SEED).choice(
        EDIT_WHOLE_N, EDIT_WHOLE_SAMPLE, replace=False))
    codes = [np.concatenate(_codes([s for _, s in read_fastx(paths[i])]))
             for i in pick]
    streams = PO._streams(codes, EDIT_K, torch.device("cuda"))
    want = OP.omh_registers_plain(*streams, EDIT_M, 2).cpu().numpy()
    assert np.array_equal(sigs.view(np.uint64)[pick], want.view(np.uint64))
    _say(f"[edit-whole] {EDIT_WHOLE_SAMPLE} genomes' written registers "
         f"(streams of {min(len(c) for c in codes) - EDIT_K + 1}-"
         f"{max(len(c) for c in codes) - EDIT_K + 1} positions, pieces of "
         f"{OP.PIECE}) == the plain version's on the card")
    _vs_cpu("edit-whole cut", flags + ["-F", cut], out + ".cut",
            EDIT_WHOLE_CUT, counters)
    os.remove(out)
    return dict(wall=wall, launches=launches)


def phase_edit(lst: str, counters):
    """Phases 31-36, the edit-distance space."""
    t0 = time.perf_counter()
    fa, recs = _edit_corpus()
    _say(f"[edit] corpus: {EDIT_N} sequences, "
         f"{sum(len(s) for _, s in recs)} bp, written in "
         f"{time.perf_counter() - t0:.3f} s")
    runs = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        _say(f"[wall] phase {name}: {time.perf_counter() - t1:.3f} s")
        return out
    kernel = timed("omh kernel", phase_omh_vs_plain, recs)
    runs.update(timed("edit all-pairs jobs", phase_edit_allpairs, fa, recs,
                      counters))
    runs["edit-knn"] = timed("edit-knn job", phase_edit_knn, fa, recs,
                             counters)
    runs["edit-greedy"] = timed("edit-greedy job", phase_edit_greedy, fa,
                                recs, counters)
    runs["edit-exact"] = timed("edit-exact job", phase_edit_allpairs_exact,
                               recs, counters)
    runs["edit-whole"] = timed("edit-whole job", phase_edit_whole, lst,
                               counters)
    _say(f"[wall] edit-distance phases: {time.perf_counter() - t0:.3f} s")
    shutil.rmtree(os.path.join(WORK, "edit"), ignore_errors=True)
    kernel["launches"] = sum(r["launches"]["omh"] for r in runs.values())
    return kernel, runs


# ----------------------------------------------------------------------
# phases 37-42: the chunked route (--parse-by-seq, --filterset,
# --by-chrom, .xz/.bz2) on csrc/oph_rows.cu
# ----------------------------------------------------------------------

# 2,048 families x 16 members of 1,000-6,000 bp, each member 1-5% edited
# (io/corpus.py `edited_sequences`), N runs in every 16th record, 16
# records cut below k: about 115 Mbp, the gene or contig catalogues
# users compare record by record
BYSEQ_SEED = 14
BYSEQ_FAMILIES, BYSEQ_MEMBERS = 2048, 16
BYSEQ_N = BYSEQ_FAMILIES * BYSEQ_MEMBERS
BYSEQ_K, BYSEQ_M = 31, 1024
BYSEQ_ARGS = ["-k", str(BYSEQ_K), "-S", str(BYSEQ_M)]
BYSEQ_SLICE = 256            # records of the per-encoding check
BYSEQ_PAIRS_N = 8192         # records of the all-pairs job (phase 38)
BYSEQ_COUNTING_N = 2048      # records of the counting-route jobs (42)
BYSEQ_KNN_N = 8192           # records of the --topk 10 job (39)
# records of phase 42's --device cpu runs: --set, --full-setsketch and
# -B (the plain CSetSketch and weighted draws are slow on the CPU)
BYSEQ_CUTS = {"set": 64, "fss": 32, "bmh": 8}
BYSEQ_CUT = BYSEQ_CUTS["set"]   # also phase 38's check on the CPU
FILTER_PIECES, FILTER_PIECE = 64, 4096   # phase 40's 256 kb filter FASTA
CONTIG_GENOMES = 256         # genomes of phase 41, each as 4 contigs
# the least integer work of one valid position: its 2-bit k-mer rolled
# one base, forward and reverse complement, and their unsigned min (15
# 32-bit lane instructions), the maskfn and bucket wanghash chains (30
# each: every u64 add, xor and shift two lane instructions, a multiply
# by a small constant three) and the bucket's address and atomic (5).
# Reckoned from that least form, not from csrc/oph_rows.cu's SASS; kept
# as it was when the kernel built each code from its k bases, so that
# the yardstick does not move with the design
OPH_OPS = 80
# the per-encoding check: (tag, options); protein over random records
OPH_CASES = (("dna-k31", dict(k=31)),
             ("mini-w50-ds", dict(k=31, w=50, kmer_downsample_frac=0.5)),
             ("spaced", dict(k=11, spacing="0,2,0,1,0x5,3")),
             ("roll-k48", dict(k=48)),
             ("u128-k40", dict(k=40, use128=True)),
             ("filterset", dict(k=31)),
             ("protein-k7", dict(k=7, alphabet="PROTEIN")))
CHUNKED_SPANS = ("sketch", "sketch/read", "sketch/chunk", "sketch/oph-rows",
                 "sketch/finalize", "sketch/native-files", "write-sketches",
                 "compare+emit", "cmp/prep", "cmp/kernel", "cmp/d2h",
                 "lsh-index-build", "lsh-candidates", "refine", "emit/write")


def _byseq_corpus():
    """(FASTA path, records) of the by-record corpus under build/, and
    the FASTAs of its first BYSEQ_SLICE, BYSEQ_PAIRS_N, BYSEQ_COUNTING_N,
    BYSEQ_KNN_N, SEQ_KNN_N and BYSEQ_CUTS records."""
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    d = os.path.join(WORK, "byseq")
    recs = edited_sequences(BYSEQ_SEED, BYSEQ_FAMILIES, BYSEQ_MEMBERS,
                            length=(1000, 6000), edits=(0.01, 0.05),
                            n_every=16)
    # 16 records shorter than k, whose registers stay empty
    for i in range(0, BYSEQ_N, BYSEQ_N // 16):
        recs[i] = (recs[i][0], recs[i][1][:BYSEQ_K - 1 - i % 7])
    fa = write_fasta(os.path.join(d, "byseq.fa"), recs)
    for name, n in (("slice", BYSEQ_SLICE), ("pairs", BYSEQ_PAIRS_N),
                    ("counting", BYSEQ_COUNTING_N), ("knn", BYSEQ_KNN_N),
                    (f"first{SEQ_KNN_N}", SEQ_KNN_N)):
        write_fasta(os.path.join(d, f"{name}.fa"), recs[:n])
    for n in set(BYSEQ_CUTS.values()):
        write_fasta(os.path.join(d, f"cut{n}.fa"), recs[:n])
    return fa, recs


def _rows_of(opts, paths, batch_codes=1 << 40):
    """(items, chunk length, hash kwargs, [(rows, item index)]) of the
    chunked route over `paths`."""
    from dashing2_tpu_torch.sketch import core as PC
    items = list(PC._load_items(opts, paths))
    chunk_len = PC._auto_chunk_len(items)
    return (items, chunk_len, PC._hash_kwargs(opts, chunk_len),
            list(PC._iter_chunk_batches(opts, items, chunk_len,
                                        batch_codes)))


def _valid_windows(items, k: int) -> int:
    """Windows of k bases with no INVALID code, over every record."""
    import numpy as np
    total = 0
    for it in items:
        for c in it.codes:
            if len(c) < k:
                continue
            bad = np.concatenate([[0], np.cumsum(c == 0xFF)])
            total += int((bad[k:] == bad[:-k]).sum())
    return total


def phase_oph_vs_plain(fa: str, recs):
    """oph_rows against oph_rows_plain on the card, registers and counts
    bit for bit, over the first BYSEQ_SLICE records in each encoding
    (OPH_CASES: 2-bit DNA, window-50 minimizers with downsampling, spaced
    seeds, the rolling hash, the 128-bit low word, a filterset of a third
    of the slice's hashes, protein over random records); then the whole
    corpus at k = 31, m = 1024: the kernel's registers == the native
    engine's (`oph_rows_native` on the host's threads, rows merged per
    record). The kernel timed by CUDA events over the prebuilt batches
    on the card; the plain version on the first BYSEQ_SLICE records."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.enums import Alphabet
    from dashing2_tpu_torch.io.corpus import write_fasta
    from dashing2_tpu_torch.native import load_oph_lib
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.sketch import core as PC
    d = os.path.join(WORK, "byseq")
    rng = np.random.default_rng(BYSEQ_SEED)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    pfa = write_fasta(os.path.join(d, "protein.fa"), [
        (f"p{i}", rng.choice(letters, int(rng.integers(100, 2000))).tobytes())
        for i in range(BYSEQ_SLICE)])
    slice_fa = os.path.join(d, "slice.fa")
    for tag, kw in OPH_CASES:
        kw = dict(kw)
        if "alphabet" in kw:
            kw["alphabet"] = Alphabet[kw["alphabet"]]
        opts = Dashing2Options(sketchsize=BYSEQ_M, parse_by_seq=True, **kw)
        items, _, hkw, batches = _rows_of(
            opts, [pfa if "alphabet" in kw else slice_fa])
        rows = torch.from_numpy(batches[0][0]).cuda()
        rid = torch.from_numpy(batches[0][1]).cuda()
        fs = None
        if tag == "filterset":
            hashed, valid = OR.hash_chunk_batch(rows, hkw)
            hv = np.unique(hashed[valid].cpu().numpy().view(np.uint64))
            fs = torch.from_numpy(hv[::3].copy().view(np.int64)).cuda()
        want = OR.oph_rows_plain(rows, rid, len(items), BYSEQ_M, hkw, fs,
                                 True)
        got = OR.oph_rows(rows, rid, len(items), BYSEQ_M, hkw, fs, True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), (tag, "registers")
        assert torch.equal(got[1], want[1]), (tag, "counts")
        _say(f"[oph] {tag}: oph_rows == oph_rows_plain, registers and "
             f"counts, {len(items)} records in {rows.shape[0]} rows of "
             f"{rows.shape[1]} codes; {int((got[0] != -1).sum())} of "
             f"{got[0].numel()} registers filled"
             + (f"; filterset of {fs.numel()} hashes" if fs is not None
                else ""))

    # the whole corpus: the kernel == the native engine
    opts = Dashing2Options(k=BYSEQ_K, sketchsize=BYSEQ_M, parse_by_seq=True)
    t0 = time.perf_counter()
    items, chunk_len, hkw, batches = _rows_of(opts, [fa],
                                              PC.BATCH_CODES["cuda"])
    n, m = len(items), BYSEQ_M
    t_rows = time.perf_counter() - t0
    rows_np = np.concatenate([r for r, _ in batches])
    rid_np = np.concatenate([i for _, i in batches])
    t0 = time.perf_counter()
    nat_r, nat_c = PC._native_oph_rows(load_oph_lib(), rows_np, hkw, m,
                                       False)
    t_native = time.perf_counter() - t0
    host_regs, _ = PC.merge_rows(nat_r, nat_c, rid_np, n)
    del nat_r, nat_c
    on_card = [(torch.from_numpy(r).cuda(),
                torch.from_numpy(i - i[0]).cuda(), int(i[0]),
                int(i[-1]) + 1) for r, i in batches]

    def run():
        return [OR.oph_rows(r, i, i1 - i0, m, hkw)[0]
                for r, i, i0, i1 in on_card]
    outs = run()
    torch.cuda.synchronize()
    kern = np.full((n, m), PC.U64MAX, np.uint64)
    for (_, _, i0, i1), g in zip(on_card, outs):
        np.minimum(kern[i0:i1], g.cpu().numpy().view(np.uint64),
                   out=kern[i0:i1])
    del outs
    assert np.array_equal(kern, host_regs), "!= native engine"
    ms = _cuda_ms(run, 3)
    empty = int((kern == PC.U64MAX).all(axis=1).sum())
    # the first BYSEQ_SLICE records: the wrapper, the bare C entry on
    # prebuilt arguments (CUDA events around `lib.oph_rows` only, each
    # launch into registers filled beforehand), the plain version
    r0, i0 = on_card[0][0], on_card[0][1]
    cut = int(np.searchsorted(batches[0][1], BYSEQ_SLICE))
    part = (r0[:cut].contiguous(), i0[:cut].contiguous())
    slice_ms = _cuda_ms(lambda: OR.oph_rows(*part, BYSEQ_SLICE, m, hkw), 3)
    bare_ms = _bare_oph_ms(part, BYSEQ_SLICE, m, hkw, 3)
    OR.oph_rows_plain(*part, BYSEQ_SLICE, m, hkw)
    plain_ms = _cuda_ms(lambda: OR.oph_rows_plain(*part, BYSEQ_SLICE, m,
                                                  hkw), 1)
    nvalid = _valid_windows(items, BYSEQ_K)
    nbases = sum(len(c) for it in items for c in it.codes)
    bound_ms, bound_by = _bound(nvalid * OPH_OPS, "int32",
                                nbases + 8 * n * m)
    _say(f"[oph] whole corpus: {n} records ({empty} empty: shorter than "
         f"k), {nbases} bases, {nvalid} valid 31-mers, in {len(rows_np)} "
         f"rows of {rows_np.shape[1]} codes (chunk length {chunk_len}) and "
         f"{len(batches)} batches; kernel registers == oph_rows_native's "
         f"(host, {t_native:.3f} s on {os.cpu_count()} threads; rows built "
         f"in {t_rows:.3f} s); kernel over the batches (CUDA events, mean "
         f"of 3, registers only, "
         f"{'shared' if OR.use_smem_buckets(m) else 'global'} bucket-min): "
         f"{ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}: {OPH_OPS} "
         f"int32 lane instructions a valid position, reckoned), "
         f"{100 * bound_ms / ms:.1f}% reached; on the first {BYSEQ_SLICE} "
         f"records the wrapper "
         f"{slice_ms:.3f} ms, the bare launch {bare_ms:.3f} ms, plain "
         f"{plain_ms:.3f} ms (one run); library: none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, err=0, library_ms=None, slice_ms=slice_ms,
                slice_bare_ms=bare_ms,
                plain_shape=f"the first {BYSEQ_SLICE} of the {n} records ms "
                f"and bound_ms cover (kernel there {slice_ms:.3f} ms)"), \
        host_regs


def _bare_oph_ms(part, n_items: int, m: int, hkw, reps: int) -> float:
    """Mean device time of the bare C entry `oph_rows` on prebuilt
    Params, rows and registers: CUDA events around the library calls
    only (the wrapper's `kernel_params`, register fill and checks are
    outside the window)."""
    import ctypes
    import torch
    from dashing2_tpu_torch.ops import oph_rows as OR
    rows, rid = part
    lib = OR.load_kernel()
    params = OR.kernel_params(hkw, rows.shape[0], rows.shape[1], m, 0)
    regs = [torch.full((n_items, m), -1, dtype=torch.int64, device="cuda")
            for _ in range(reps + 1)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(g):
        assert lib.oph_rows(ctypes.byref(params), rows.data_ptr(),
                            rid.data_ptr(), None, g.data_ptr(), None,
                            stream) == 0
    launch(regs[-1])                              # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for g in regs[:reps]:
        launch(g)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_byseq_allpairs(recs, counters):
    """`sketch --parse-by-seq -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs`
    all pairs over the first BYSEQ_PAIRS_N records, `-o`: one tri_eq
    launch; every value == the CPU epilogue at the plain counts of the
    written registers; the first BYSEQ_CUT records' registers == the
    chunked route's on the CPU (`--device cpu`'s plain version)."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.result import SketchingResult
    from dashing2_tpu_torch.sketch.core import sketch_fastx
    n, m = BYSEQ_PAIRS_N, BYSEQ_M
    d = os.path.join(WORK, "byseq")
    out, sig = os.path.join(d, "pairs.bin"), os.path.join(d, "pairs.sig")
    argv = ["sketch", "--parse-by-seq"] + BYSEQ_ARGS + [
        "--fastcmp", "0.5", "--bbit-sigs", "--binary-output", "--cmpout",
        out, "-o", sig, os.path.join(d, "pairs.fa")]
    wall, spans, launches = _run_cli("byseq-pairs", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["oph_rows"] >= 1 and launches["tri_eq"] == 1, launches
    _say_spans("byseq-pairs", spans, CHUNKED_SPANS)
    cards, sigs = formats.read_stacked_signatures(sig)
    opts = _cli_opts(argv)
    cpu = sketch_fastx(opts, [os.path.join(d, f"cut{BYSEQ_CUT}.fa")],
                       device="cpu")
    assert np.array_equal(sigs[:BYSEQ_CUT].view(np.uint64),
                          np.asarray(cpu.signatures).view(np.uint64))
    names, _ = formats.read_names_file(sig + ".names.txt")
    assert names == [nm for nm, _ in recs[:n]]
    res = SketchingResult(names=names, cardinalities=cards, signatures=sigs)
    creps, res = C._prep(opts, res)
    kind, data = C._representation(opts, res, creps)
    regs = C._device_regs(data, torch.device("cuda"))
    counts = NT.tri_eq_counts_plain(regs, m).cpu().numpy().astype(np.int64)
    del regs
    epi = _job_epilogue("byseq-pairs", kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(counts[i0:i1], None, None))
    _say(f"[byseq-pairs] {BYSEQ_CUT} records' written registers == the "
         f"plain version's on the CPU; names == the records'; output == "
         f"CPU epilogue at the plain counts ({kind}) for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    os.remove(out)
    return dict(wall=wall, launches=launches)


def phase_byseq_knn(fa: str, recs, host_regs, counters):
    """`--parse-by-seq --topk 10` over the first BYSEQ_KNN_N records:
    registers on the card (oph_rows the only hand kernel), LSH
    candidates and pair counts; the graph == neighbor_graph_main on the
    card over the native engine's registers of phase 37."""
    import numpy as np
    from dashing2_tpu_torch.cmp import graph as PG
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.result import SketchingResult
    from dashing2_tpu_torch.sketch.core import _finalize_one_perm
    n, m = BYSEQ_KNN_N, BYSEQ_M
    d = os.path.join(WORK, "byseq")
    out = os.path.join(d, "knn.bin")
    argv = ["sketch", "--parse-by-seq", "--topk", "10", "--binary-output"] \
        + BYSEQ_ARGS + ["--cmpout", out, os.path.join(d, "knn.fa")]
    wall, spans, launches = _run_cli("byseq-knn", argv, n, counters, 0)
    assert launches["oph_rows"] >= 1 and not any(
        v for k, v in launches.items() if k != "oph_rows"), launches
    _say_spans("byseq-knn", spans, CHUNKED_SPANS)
    opts = _cli_opts(argv)
    opts.outfile_path = out + ".host"
    names = [nm for nm, _ in recs[:n]]
    res = _finalize_one_perm(opts, SketchingResult(names=names),
                             host_regs[:n].copy(), None, n, m)
    PG.neighbor_graph_main(opts, res, device="cuda")
    size = _same_bytes([out, out + ".host"])
    indptr, indices, _ = formats.read_knn_csr(out)
    rows = np.repeat(np.arange(n), np.diff(indptr.astype(np.int64)))
    fam = np.array([int(nm.split("_")[0][3:]) for nm in names])
    same = float(np.mean(fam[rows] == fam[indices]))
    _say(f"[byseq-knn] {len(indices)} edges over {n} records "
         f"({100 * same:.1f}% within a family) == the graph of the native "
         f"engine's registers ({size} bytes)")
    os.remove(out)
    return dict(wall=wall, launches=launches)


def _genome_paths(lst: str, n: int):
    with open(lst) as f:
        return [ln.strip() for ln in f if ln.strip()][:n]


def phase_filterset(lst: str, counters):
    """--filterset over the first HALF_N genomes of the N = 10240 corpus,
    with a 256 kb filter FASTA cut from 64 of them: the full-register
    all-pairs job (file driver with the set, one gtlt_self launch); the
    chunked route's registers on the card (oph_rows) with the same set
    == the file driver's; the filter changes registers; `:b` with the
    raw u64 list of the FASTA's hashes gives the FASTA filter's bytes."""
    import numpy as np
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.io import formats
    from dashing2_tpu_torch.io.corpus import write_fasta
    from dashing2_tpu_torch.io.fastx import read_fastx
    from dashing2_tpu_torch.sketch import core as PC
    paths = _genome_paths(lst, HALF_N)
    d = os.path.join(WORK, "byseq")
    filt = write_fasta(os.path.join(d, "filter.fa"), [
        (f"f{i}", next(read_fastx(p))[1][:FILTER_PIECE])
        for i, p in enumerate(paths[:FILTER_PIECES])])
    half = _write_list(os.path.join(d, "half.txt"), paths)
    hv = PC._filterset_array(Dashing2Options(k=31, filterset_path=filt))
    raw = os.path.join(d, "filter.u64")
    hv.tofile(raw)
    runs = {}
    files = {}
    for tag, arg in (("filterset", filt), ("filterset-raw", raw + ":b")):
        out, sig = os.path.join(d, f"{tag}.bin"), os.path.join(d, f"{tag}.sig")
        argv = ["sketch", "-k", "31", "-S", "1024", "--filterset", arg,
                "--binary-output", "--cmpout", out, "-o", sig, "-F", half]
        wall, spans, launches = _run_cli(tag, argv, HALF_N, counters)
        assert launches["gtlt_self"] == 1 and launches["oph_rows"] == 0, \
            launches
        _say_spans(tag, spans, CHUNKED_SPANS)
        runs[tag] = dict(wall=wall, launches=launches)
        files[tag] = (out, sig)
    for i in range(2):
        _same_bytes([files["filterset"][i], files["filterset-raw"][i]])
    _, sigs = formats.read_stacked_signatures(files["filterset"][1])
    opts = _cli_opts(["sketch", "-k", "31", "-S", "1024", "--filterset",
                      filt])
    t0 = time.perf_counter()
    counters["oph_rows"].reset_launches()
    card = PC._sketch_chunked(opts, paths, "cuda")
    t_card = time.perf_counter() - t0
    assert counters["oph_rows"].launches >= 1
    assert np.array_equal(np.asarray(card.signatures), sigs)
    plain = PC._sketch_files(Dashing2Options(k=31, sketchsize=1024),
                             paths[:FILTER_PIECES])
    changed = int((plain.signatures != sigs[:FILTER_PIECES]).any(axis=1)
                  .sum())
    assert changed > 0
    _say(f"[filterset] {len(hv)} filter hashes from {FILTER_PIECES} pieces "
         f"of {FILTER_PIECE} bp; the chunked route's registers on the card "
         f"({t_card:.3f} s) == the file driver's with the set; {changed} of "
         f"the first {FILTER_PIECES} genomes' registers changed by it; the "
         "raw list's bytes == the FASTA filter's (matrix and -o)")
    for out, sig in files.values():
        os.remove(out)
    return runs


def phase_contigs(lst: str, counters):
    """CONTIG_GENOMES genomes as 4 contigs each, plain, .xz and .bz2: the
    file driver's bytes on the plain files (matrix and -o) == the
    chunked route's on the .xz and the .bz2 files, on the plain files
    with --by-chrom, and on the .xz files with --by-chrom."""
    import bz2
    import lzma
    from dashing2_tpu_torch.io.corpus import write_fasta
    from dashing2_tpu_torch.io.fastx import read_fastx
    d = os.path.join(WORK, "contigs")
    lists = {"plain": [], "xz": [], "bz2": []}
    t0 = time.perf_counter()
    for i, p in enumerate(_genome_paths(lst, CONTIG_GENOMES)):
        seq = next(read_fastx(p))[1]
        q = len(seq) // 4
        fa = write_fasta(os.path.join(d, f"g{i}.fa"), [
            (f"g{i}_c{j}", seq[j * q:(j + 1) * q if j < 3 else len(seq)])
            for j in range(4)])
        with open(fa, "rb") as f:
            data = f.read()
        lists["plain"].append(fa)
        for suffix, pack in (("xz", lambda b: lzma.compress(b, preset=1)),
                             ("bz2", lambda b: bz2.compress(b, 1))):
            with open(fa + "." + suffix, "wb") as f:
                f.write(pack(data))
            lists[suffix].append(fa + "." + suffix)
    lst_files = {k: _write_list(os.path.join(d, f"{k}.txt"), v)
                 for k, v in lists.items()}
    _say(f"[contigs] {CONTIG_GENOMES} genomes as 4 contigs, plain, .xz and "
         f".bz2, written in {time.perf_counter() - t0:.3f} s")
    runs = {}
    outs = []
    for tag, which, flags in (("contigs-plain", "plain", []),
                              ("contigs-xz", "xz", []),
                              ("contigs-bz2", "bz2", []),
                              ("contigs-by-chrom", "plain", ["--by-chrom"]),
                              ("contigs-xz-by-chrom", "xz", ["--by-chrom"])):
        out, sig = os.path.join(d, f"{tag}.bin"), os.path.join(d, f"{tag}.sig")
        wall, spans, launches = _run_cli(tag, [
            "sketch", "-k", "31", "-S", "1024", "--binary-output",
            "--cmpout", out, "-o", sig] + flags + ["-F", lst_files[which]],
            CONTIG_GENOMES, counters)
        assert launches["gtlt_self"] == 1, launches
        assert (launches["oph_rows"] >= 1) == (tag != "contigs-plain"), \
            launches
        _say_spans(tag, spans, CHUNKED_SPANS)
        runs[tag] = dict(wall=wall, launches=launches)
        outs.append((out, sig))
    for i in range(2):
        size = _same_bytes([o[i] for o in outs])
        _say(f"[contigs] {'matrix' if i == 0 else '-o registers'}: the "
             f"file driver's bytes on the plain files == the chunked "
             f"route's on .xz, .bz2, --by-chrom and .xz --by-chrom ({size} "
             "bytes)")
    shutil.rmtree(d, ignore_errors=True)
    return runs


BYSEQ_COUNTING_JOBS = (("byseq-fss", ["--full-setsketch"], "gtlt_self",
                        BYSEQ_CUTS["fss"]),
                       ("byseq-set", ["--set"], None, BYSEQ_CUTS["set"]),
                       ("byseq-bmh", ["-B"], "weighted_draws",
                        BYSEQ_CUTS["bmh"]))


def phase_byseq_counting(counters):
    """`--full-setsketch`, `--set` and `-B` with `--parse-by-seq` over the
    first BYSEQ_COUNTING_N records (one item a record, the counting
    route): each job's size and launches, and its bytes over the first
    records (BYSEQ_CUTS) == --device cpu's."""
    n = BYSEQ_COUNTING_N
    d = os.path.join(WORK, "byseq")
    runs = {}
    for tag, flags, counter, cut in BYSEQ_COUNTING_JOBS:
        out = os.path.join(d, f"{tag}.bin")
        argv = ["sketch", "--parse-by-seq"] + BYSEQ_ARGS + flags + [
            "--binary-output"]
        wall, spans, launches = _run_cli(tag, argv + [
            "--cmpout", out, os.path.join(d, "counting.fa")], n, counters)
        assert os.path.getsize(out) == 4 * n * (n - 1) // 2
        assert launches["oph_rows"] == 0, launches
        assert counter is None or launches[counter] >= 1, launches
        assert (launches["css"] >= 1) == ("--full-setsketch" in flags), \
            launches
        _say_spans(tag, spans, FSS_SPANS)
        cut_fa = os.path.join(d, f"cut{cut}.fa")
        _vs_cpu(f"{tag} cut", argv + [cut_fa], out + ".cut", cut, counters)
        runs[tag] = dict(wall=wall, launches=launches)
        os.remove(out)
    return runs


def phase_byseq_countsketch(counters):
    """`sketch -k 31 -S 256 -P -c 1048576 --parse-by-seq --binary-output`
    all pairs over the first BYSEQ_PAIRS_N records (phase 38's): one
    countsketch call a batch of CS.BATCH_HASHES hashes, the draws on
    weighted_draws.cu, one gtlt_self launch; its bytes over the first
    BYSEQ_CUTS["set"] records == --device cpu's. Returns its wall,
    launches and the streams it counted (set (c) of phase 44)."""
    from dashing2_tpu_torch.ops import countsketch as CS
    n = BYSEQ_PAIRS_N
    d = os.path.join(WORK, "byseq")
    tag = "byseq-pmh-c"
    out = os.path.join(d, f"{tag}.bin")
    argv = ["sketch", "--parse-by-seq", "-k", str(BYSEQ_K), "-S", "256",
            "-P", "-c", "1048576", "--binary-output"]
    rec, undo = _capture_countsketch()
    try:
        wall, spans, launches = _run_cli(tag, argv + [
            "--cmpout", out, os.path.join(d, "pairs.fa")], n, counters)
    finally:
        undo()
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    hv, offsets, _ = _cs_set(rec)
    batches = -(-hv.shape[0] // CS.BATCH_HASHES)
    assert offsets.shape[0] == n + 1 and launches["countsketch"] == len(
        rec) == batches, (launches, len(rec))
    assert launches["weighted_draws"] >= 1 and launches["gtlt_self"] == 1
    assert all(launches[k] == 0 for k in launches
               if k not in ("countsketch", "weighted_draws", "gtlt_self"))
    _say(f"[{tag}] {n} records, {hv.shape[0]} hashes: {len(rec)} "
         f"countsketch call(s), one a batch")
    _say_spans(tag, spans, ("sketch", "sketch/read", "sketch/hash",
                            "sketch/count", "sketch/weighted",
                            "compare+emit"))
    cut = BYSEQ_CUTS["set"]
    _vs_cpu(f"{tag} cut", argv + [os.path.join(d, f"cut{cut}.fa")],
            out + ".cut", cut, counters)
    os.remove(out)
    return dict(wall=wall, launches=launches, streams=_cs_set(rec))


# ----------------------------------------------------------------------
# phases 47-49: minimizer sequences (--seq, printmin) on csrc/oph_rows.cu's
# hash_rows entry
# ----------------------------------------------------------------------

# the --seq jobs' settings: 15-mers in windows of 31 (u64 tokens), and
# --long-kmers 40-mers in windows of 60 (full 128-bit tokens)
SEQ_ARGS = ["-k", "15", "-w", "31"]
SEQ128_ARGS = ["--long-kmers", "-k", "40", "-w", "60"]
SEQ_PAIRS_N = BYSEQ_SLICE    # records of the --seq all-pairs job (49)
SEQ_KNN_N = 1024             # records of the --seq --topk 10 job (49)
SEQ_CUT = 64                 # records of the --device cpu runs (48)
SEQ_SAMPLE = 200             # all-pairs values held to the numpy DP (49)
# the least integer work of hash_rows, reckoned as OPH_OPS is (32-bit
# lane instructions): a valid position's rolled code (15; the 128-bit
# code's two words 30) and, with w > k, its minimizer scan (12: a van
# Herk/Gil-Werman window minimum's prefix and suffix u64 mins and their
# min, and the tie test); the maskfn chain (30; full keys' two words 60)
# only where a position is masked: every valid one with w <= k, only
# those the minimizers select with w > k
HASH_ROLL_OPS, HASH_MASK_OPS, HASH_MINI_OPS = 15, 30, 12
# the per-encoding check: phase 37's encodings, and the 128-bit code's
# full keys with minimizers
HASH_CASES = OPH_CASES + (("u128-full-w60", dict(k=40, w=60, use128=True)),)
SEQ_SPANS = ("sketch", "sketch/read", "sketch/chunk", "sketch/hash-rows",
             "write-sketches", "compare+emit", "cmp/mmer-dist",
             "lsh-index-build", "lsh-candidates", "refine", "emit/write")


def _hash_bound(items, k: int, w: int, full: bool, kept: int):
    """(bound ms, what sets it, valid positions) of hash_rows over
    `items` at the int32 rate: HASH_ROLL_OPS (and with w > k
    HASH_MINI_OPS) a valid position, HASH_MASK_OPS a masked one (with
    w > k the selected positions, here the `kept` tokens: the timed jobs
    have no downsample or filterset), ROLL and MASK twice for full keys;
    beside 1 byte read a base and 8 bytes (16 for full keys) written a
    kept token."""
    nvalid = _valid_windows(items, k)
    nbases = sum(len(c) for it in items for c in it.codes)
    words = 2 if full else 1
    nmasked = kept if w > k else nvalid
    ops = (nvalid * (words * HASH_ROLL_OPS
                     + (HASH_MINI_OPS if w > k else 0))
           + nmasked * words * HASH_MASK_OPS)
    bound_ms, bound_by = _bound(ops, "int32",
                                nbases + (16 if full else 8) * kept)
    return bound_ms, bound_by, nvalid


def _bare_hash_ms(batches, hkw, x2, reps: int) -> float:
    """Mean device time of the bare C entries `hash_rows` and
    `hash_place` over the batches on prebuilt Params, slabs, outputs and
    offsets (those of a first call): CUDA events around the library
    calls only, no scan and no host sync."""
    import ctypes
    import torch
    from dashing2_tpu_torch.ops import oph_rows as OR
    lib = OR.load_kernel()
    stream = torch.cuda.current_stream().cuda_stream
    words = 2 if x2 is not None else 1
    calls = []
    for r in batches:
        prm = OR.kernel_params(hkw, r.shape[0], r.shape[1], 0, 0,
                               xormask2_hi=x2)
        nblk = r.shape[0] * OR.segments(prm)
        cap = OR.token_capacity(prm)
        counts = torch.empty(nblk, dtype=torch.int64, device="cuda")
        starts = torch.empty_like(counts)
        cursor = torch.empty(1, dtype=torch.int64, device="cuda")
        slab = torch.empty((words, cap), dtype=torch.int64, device="cuda")
        out = torch.empty_like(slab)
        ptrs = [t[i].data_ptr() if i < words else None
                for t in (slab, out) for i in (0, 1)]
        args = (ctypes.byref(prm), r.data_ptr(), None, None, ptrs[0],
                ptrs[1], cap, counts.data_ptr(), starts.data_ptr(),
                cursor.data_ptr(), stream)
        assert lib.hash_rows(*args) == 0
        offsets = torch.cumsum(counts, 0) - counts
        assert int(cursor) <= cap
        calls.append((args, (nblk, counts.data_ptr(), starts.data_ptr(),
                             offsets.data_ptr(), ptrs[0], ptrs[1], cap,
                             ptrs[2], ptrs[3], stream),
                      (counts, starts, cursor, slab, out, offsets)))

    def launch():
        for main, place, _ in calls:
            assert lib.hash_rows(*main) == 0
            assert lib.hash_place(*place) == 0
    launch()                                      # warm-up
    torch.cuda.synchronize()
    return _cuda_ms(launch, reps)


def phase_hash_rows_vs_plain(fa: str):
    """hash_rows against hash_rows_plain on the card, tokens (and the
    high words of full keys) and the rows' counts bit for bit: over the
    first BYSEQ_SLICE records in each encoding of HASH_CASES (phase 37's
    and the 128-bit code's full keys with minimizers), with
    tests/seq_planted.py's rows beside them (a homopolymer, tandem
    repeats of period 5 and nwin, N runs of 1 to nwin bases at several
    offsets), then over the whole corpus at the --seq jobs' settings
    (SEQ_ARGS; SEQ128_ARGS, full keys) in the --seq route's batches. The
    kernel timed by CUDA events over those prebuilt batches, after a
    warm-up, through its wrapper (the tokens' launch, the scan of the
    segments' counts, the placement launch, the rows' sums, the read of
    the total) and as the bare launches; the plain version on the first
    BYSEQ_SLICE records."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.enums import Alphabet, KmerSketchResultType
    from dashing2_tpu_torch.ops import kmers as K
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.sketch import core as PC
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from seq_planted import planted_rows
    finally:
        sys.path.pop(0)
    d = os.path.join(WORK, "byseq")
    slice_fa = os.path.join(d, "slice.fa")
    seq = KmerSketchResultType.FULL_MMER_SEQUENCE
    for tag, kw in HASH_CASES:
        kw = dict(kw)
        if "alphabet" in kw:
            kw["alphabet"] = Alphabet[kw["alphabet"]]
        opts = Dashing2Options(parse_by_seq=True, kmer_result=seq, **kw)
        _, _, hkw, batches = _rows_of(
            opts, [os.path.join(d, "protein.fa") if "alphabet" in kw
                   else slice_fa])
        nwin = hkw["w"] - hkw["k"] + 1 if hkw["w"] > hkw["k"] else 1
        planted = planted_rows(batches[0][0].shape[1],
                               K.alphabet_size(hkw["alphabet"]), nwin,
                               BYSEQ_SEED)
        rows = torch.from_numpy(np.concatenate([batches[0][0], planted])
                                ).cuda()
        x2 = opts.xormask2_hi if tag.startswith("u128-full") else None
        fs = None
        if tag == "filterset":
            lo, _, _ = OR.hash_rows_plain(rows, hkw)
            hv = np.unique(lo.cpu().numpy().view(np.uint64))
            fs = torch.from_numpy(hv[::3].copy().view(np.int64)).cuda()
        want = OR.hash_rows_plain(rows, hkw, fs, x2)
        got = OR.hash_rows(rows, hkw, fs, x2)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("tokens", "high words",
                                         "counts")):
            assert (g is None) == (w is None) and (
                g is None or torch.equal(g, w)), (tag, what)
        _say(f"[hash] {tag}: hash_rows == hash_rows_plain, "
             f"{int(got[2].sum())} tokens of {rows.shape[0]} rows of "
             f"{rows.shape[1]} codes ({len(planted)} planted, "
             f"{int(got[2][-len(planted):].sum())} tokens)"
             + ("; full keys" if x2 else "")
             + (f"; filterset of {fs.numel()} hashes" if fs is not None
                else ""))
    run = {}
    for tag, args in (("seq", SEQ_ARGS), ("seq128", SEQ128_ARGS)):
        k, w = int(args[args.index("-k") + 1]), int(args[args.index("-w")
                                                          + 1])
        opts = Dashing2Options(k=k, w=w, use128="--long-kmers" in args,
                               parse_by_seq=True, kmer_result=seq)
        items, chunk_len, hkw, batches = _rows_of(opts, [fa],
                                                  PC.BATCH_CODES["cuda"])
        x2 = opts.xormask2_hi if "--long-kmers" in args else None
        on_card = [torch.from_numpy(r).cuda() for r, _ in batches]
        kept = 0
        for r in on_card:
            got = OR.hash_rows(r, hkw, None, x2)
            want = OR.hash_rows_plain(r, hkw, None, x2)
            for g, w_ in zip(got, want):
                assert (g is None) == (w_ is None) and (
                    g is None or torch.equal(g, w_)), tag
            kept += int(got[2].sum())
            del got, want
        torch.cuda.empty_cache()
        # warmed up first: the caching allocator holds the wrapper's
        # buffers from then on, as it does across the route's batches
        ms = _library_ms(lambda: [OR.hash_rows(r, hkw, None, x2)
                                  for r in on_card], 3)
        bare_ms = _bare_hash_ms(on_card, hkw, x2, 3)
        bound_ms, bound_by, nvalid = _hash_bound(items, k, w, x2 is not None,
                                                 kept)
        cut = int(np.searchsorted(batches[0][1], BYSEQ_SLICE))
        part = on_card[0][:cut].contiguous()
        slice_ms = _library_ms(lambda: OR.hash_rows(part, hkw, None, x2), 3)
        OR.hash_rows_plain(part, hkw, None, x2)
        plain_ms = _cuda_ms(lambda: OR.hash_rows_plain(part, hkw, None, x2),
                            1)
        _say(f"[hash] {tag} ({' '.join(args)}): {len(items)} records in "
             f"{sum(len(r) for r in on_card)} rows of {on_card[0].shape[1]} "
             f"codes (chunk length {chunk_len}), {len(on_card)} batches; "
             f"kernel tokens and counts == plain's over the whole corpus; "
             f"{nvalid} valid windows, {kept} kept tokens; through the "
             f"wrapper over the batches (CUDA events, mean of 3) {ms:.3f} "
             f"ms, the bare launches (tokens and placement) {bare_ms:.3f} "
             f"ms; bound "
             f"{bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% "
             f"reached; on the first {BYSEQ_SLICE} records the wrapper "
             f"{slice_ms:.3f} ms, plain {plain_ms:.3f} ms (one run); "
             "library: none")
        run[tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, err=0, library_ms=None,
                        bare_ms=bare_ms, slice_ms=slice_ms)
        del on_card
        torch.cuda.empty_cache()
    out = dict(run["seq"])
    out["full_keys"] = run["seq128"]
    out["plain_shape"] = (f"the first {BYSEQ_SLICE} of the {BYSEQ_N} "
                          f"records ms and bound_ms cover (kernel there "
                          f"{run['seq']['slice_ms']:.3f} ms)")
    return out


def _printmin_text(path: str) -> str:
    import io
    from dashing2_tpu_torch.io.printmin import printmin_main
    buf = io.StringIO()
    assert printmin_main(path, out=buf) == 0
    return buf.getvalue()


def phase_seq_sketch(tag: str, args, fa: str, recs, counters):
    """`sketch --seq --parse-by-seq -o` over all BYSEQ_N records (`args`:
    SEQ_ARGS or SEQ128_ARGS): hash_rows the only hand kernel; the
    written sequences' count, lengths, names and token width; the job
    over the first SEQ_CUT records on the card and with --device cpu:
    equal `-o` bytes and equal `printmin` text, and its sequences == the
    whole run's first SEQ_CUT."""
    import numpy as np
    from dashing2_tpu_torch.io import formats
    d = os.path.join(WORK, "byseq")
    out = os.path.join(d, f"{tag}.seq")
    argv = ["sketch", "--seq", "--parse-by-seq"] + args + ["-o", out]
    wall, spans, launches = _run_cli(tag, argv + [fa], BYSEQ_N, counters, 0)
    assert launches["hash_rows"] >= 1 and not any(
        v for key, v in launches.items() if key != "hash_rows"), launches
    _say_spans(tag, spans, SEQ_SPANS)
    data = formats.read_mmer_sequences(out)
    names, cards = formats.read_names_file(out + ".names.txt")
    assert data["nseqs"] == BYSEQ_N and names == [n for n, _ in recs]
    lens = np.array([len(s) for s in data["seqs"]])
    assert np.array_equal(cards, lens) and data["use128"] == (
        "--long-kmers" in args)
    cut = os.path.join(d, f"cut{SEQ_CUT}.fa")
    files = [f"{out}.cut.{dev}" for dev in ("cuda", "cpu")]
    for f, dev in zip(files, ("cuda", "cpu")):
        _run_cli(f"{tag} cut {dev}", argv[:-1] + [f, cut, "--device", dev],
                 SEQ_CUT, counters, 0)
    size = _same_bytes(files)
    text = _printmin_text(files[0])
    assert text == _printmin_text(files[1]) and text.count("\n") == SEQ_CUT
    first = formats.read_mmer_sequences(files[0])["seqs"]
    assert all(np.array_equal(a, b) for a, b in zip(first, data["seqs"]))
    _say(f"[{tag}] {BYSEQ_N} sequences, {int(lens.sum())} tokens "
         f"({'u128' if data['use128'] else 'u64'}), lengths "
         f"{int(lens.min())}-{int(lens.max())}, mean {lens.mean():.1f}; "
         f"the first {SEQ_CUT} records: card -o == --device cpu -o "
         f"({size} bytes), printmin text equal ({len(text)} characters), "
         f"== the whole run's first {SEQ_CUT}")
    for f in files + [out, out + ".names.txt"]:
        os.remove(f)
    return dict(wall=wall, launches=launches)


def phase_seq_compare(recs, counters):
    """The --seq comparisons (SEQ_ARGS): all pairs over the first
    SEQ_PAIRS_N records with `-o`, binary: card == --device cpu bytes,
    every value finite and at most the longer sequence's length,
    SEQ_SAMPLE values == max length - the numpy DP (`span_edit_distance`)
    over the written sequences; `--topk 10` over the first SEQ_KNN_N
    records: card == --device cpu bytes."""
    import numpy as np
    from dashing2_tpu_torch.cmp.editdist import span_edit_distance
    from dashing2_tpu_torch.io import formats
    d = os.path.join(WORK, "byseq")
    runs = {}
    n = SEQ_PAIRS_N
    out, sig = os.path.join(d, "seqpairs.bin"), os.path.join(d, "seqpairs.seq")
    argv = (["sketch", "--seq", "--parse-by-seq"] + SEQ_ARGS
            + ["--binary-output", "-o", sig, os.path.join(d, "slice.fa")])
    files = []
    for dev in ("cuda", "cpu"):
        files.append(f"{out}.{dev}")
        wall, spans, launches = _run_cli(
            f"seq-pairs {dev}", argv + ["--cmpout", files[-1], "--device",
                                        dev], n, counters)
        if dev == "cuda":
            runs["seq-pairs"] = dict(wall=wall, launches=launches)
            _say_spans("seq-pairs", spans, SEQ_SPANS)
    size = _same_bytes(files)
    assert size == 4 * n * (n - 1) // 2
    vals = np.fromfile(files[0], dtype=np.float32)
    seqs = formats.read_mmer_sequences(sig)["seqs"]
    lens = np.array([len(s) for s in seqs])
    ia, ib = np.triu_indices(n, 1)
    assert np.isfinite(vals).all() and (vals >= 0).all() and (
        vals <= np.maximum(lens[ia], lens[ib])).all()
    rng = np.random.default_rng(BYSEQ_SEED)
    pick = rng.choice(len(vals), SEQ_SAMPLE, replace=False)
    for p in pick:
        i, j = int(ia[p]), int(ib[p])
        want = max(lens[i], lens[j]) - span_edit_distance(seqs[i], seqs[j])
        assert vals[p] == np.float32(want), (i, j)
    _say(f"[seq-pairs] {n} records: card bytes == --device cpu bytes "
         f"({size} bytes); {SEQ_SAMPLE} values == max length - the numpy "
         f"DP; value histogram (matching tokens a pair) quartiles "
         f"{np.percentile(vals, [25, 50, 75]).tolist()}")
    for f in files + [sig, sig + ".names.txt"]:
        os.remove(f)
    n = SEQ_KNN_N
    out = os.path.join(d, "seqknn.bin")
    argv = (["sketch", "--seq", "--parse-by-seq", "--topk", "10"] + SEQ_ARGS
            + ["--binary-output", os.path.join(d, f"first{n}.fa")])
    files = []
    for dev in ("cuda", "cpu"):
        files.append(f"{out}.{dev}")
        wall, spans, launches = _run_cli(
            f"seq-knn {dev}", argv + ["--cmpout", files[-1], "--device",
                                      dev], n, counters, 0)
        if dev == "cuda":
            runs["seq-knn"] = dict(wall=wall, launches=launches)
            _say_spans("seq-knn", spans, SEQ_SPANS)
    size = _same_bytes(files)
    indptr, indices, _ = formats.read_knn_csr(files[0])
    names = [nm for nm, _ in recs[:n]]
    rows = np.repeat(np.arange(n), np.diff(indptr.astype(np.int64)))
    fam = np.array([int(nm.split("_")[0][3:]) for nm in names])
    same = float(np.mean(fam[rows] == fam[indices]))
    _say(f"[seq-knn] {len(indices)} edges over {n} records "
         f"({100 * same:.1f}% within a family); card bytes == --device cpu "
         f"bytes ({size} bytes)")
    for f in files:
        os.remove(f)
    return runs


def phase_chunked(lst: str, counters):
    """Phases 37-42 and 46, the chunked route, and phases 47-49, the
    minimizer sequences over the same corpus."""
    t0 = time.perf_counter()
    fa, recs = _byseq_corpus()
    _say(f"[byseq] corpus: {BYSEQ_N} records, "
         f"{sum(len(s) for _, s in recs)} bp, written in "
         f"{time.perf_counter() - t0:.3f} s")
    runs = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        _say(f"[wall] phase {name}: {time.perf_counter() - t1:.3f} s")
        return out
    kernel, host_regs = timed("oph_rows kernel", phase_oph_vs_plain, fa,
                              recs)
    runs["byseq-pairs"] = timed("byseq all-pairs job", phase_byseq_allpairs,
                                recs, counters)
    runs["byseq-knn"] = timed("byseq-knn job", phase_byseq_knn, fa, recs,
                              host_regs, counters)
    del host_regs
    runs.update(timed("filterset jobs", phase_filterset, lst, counters))
    runs.update(timed("contig jobs", phase_contigs, lst, counters))
    runs.update(timed("byseq counting jobs", phase_byseq_counting,
                      counters))
    runs["byseq-pmh-c"] = timed("byseq -P -c job", phase_byseq_countsketch,
                                counters)
    _say(f"[wall] chunked-route phases: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    hash_run = timed("hash_rows kernel", phase_hash_rows_vs_plain, fa)
    for tag, args in (("seq-sketch", SEQ_ARGS),
                      ("seq128-sketch", SEQ128_ARGS)):
        runs[tag] = timed(f"{tag} job", phase_seq_sketch, tag, args, fa,
                          recs, counters)
    runs.update(timed("seq comparison jobs", phase_seq_compare, recs,
                      counters))
    _say(f"[wall] minimizer-sequence phases: "
         f"{time.perf_counter() - t0:.3f} s")
    shutil.rmtree(os.path.join(WORK, "byseq"), ignore_errors=True)
    kernel["launches"] = sum(r["launches"]["oph_rows"] for r in runs.values())
    hash_run["launches"] = sum(r["launches"]["hash_rows"]
                               for r in runs.values())
    return kernel, runs, hash_run


# ----------------------------------------------------------------------
# the CSetSketch draws (csrc/css.cu), the CountSketch
# (csrc/countsketch.cu) and --cache/--outprefix
# ----------------------------------------------------------------------

# items of the css check against its plain version: the FullSetSketch
# job's first pass, cut to what the plain version's (items, rows, m) f64
# draws hold
CSS_CHECK_ITEMS = 8
# rows of those items the plain early-exit walk (a torch step a row) is
# held to the full pass and the draw count over
CSS_WALK_ROWS = 2048
# the bound's yardstick for a css draw: the integer-lane and f64
# instructions of one trip of the PR 18 kernel's walk loop (its SASS,
# counted by `_loop_ops`), kept fixed so that the bound of a launch does
# not move when the kernel changes
CSS_INT_OPS = 102
CSS_F64_OPS = 47
# register counts of the css check on tests/css_planted.py's rows
CSS_PLANTED_MS = (1, 33, 1024)
# genomes of the cache phase, and of its --device cpu comparison (the -B
# job's over CACHE_CPU_BMH: the plain weighted draws take 260-500 ns
# each on the CPU, 20k positions x 1024 registers a genome)
CACHE_N = 256
CACHE_CPU = 16
CACHE_CPU_BMH = 1
CACHE_JOBS = (("cache-oph", ["-S", "1024"], True),
              ("cache-fss", ["-S", "1024", "--full-setsketch"], True),
              ("cache-fss-u8", ["-S", "1024", "--full-setsketch",
                                "--fastcmp-bytes"], True),
              ("cache-set", ["--set"], False),
              ("cache-countdict", ["--countdict"], False),
              ("cache-bmh", ["-S", "1024", "-B"], True))
# the spans of a route that sketches (a warm run has none of them)
SKETCH_ROUTE_SPANS = ("sketch/native-files", "sketch/read", "sketch/hash",
                      "sketch/count", "sketch/css", "sketch/weighted",
                      "sketch/cache-write")

_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_SKIP = ("BRA", "BSSY", "BSYNC", "NOP", "EXIT", "CALL", "RET",
              "WARPSYNC", "BAR", "YIELD", "DEPBAR")


def _sass_loop_ops(lib_name: str, function: str, marker: str):
    """`_loop_ops` over the SASS of the built library `lib_name`
    (cuobjdump -sass)."""
    from dashing2_tpu_torch import native
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", native._libs[lib_name]._name],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    return _loop_ops(text, function, marker)


def _loop_ops(text: str, function: str, marker: str):
    """Instructions of one trip of the innermost loop of `function` (a
    part of its mangled name) that holds the first `marker` (an opcode
    prefix) in the SASS `text`: the f64 pipe's (D* operations, MUFU.*64*,
    conversions to or from F64) and the integer lanes' (every other ALU
    instruction; loads, stores, branches and barriers left out), each
    divided by the marker's copies in the loop (an unrolled loop holds
    several trips). Returns (f64, int32, trips, loop lines)."""
    insns, labels, keep = [], {}, False
    pending = []
    for ln in text.splitlines():
        if "Function :" in ln:
            keep = function in ln
            continue
        if not keep:
            continue
        lab = _SASS_LABEL.match(ln)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _SASS_INSN.search(ln)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        if body.startswith("@"):
            body = body.split(None, 1)[1]
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append((addr, body.split(None, 1)[0], body))
    if not insns:
        raise ValueError(f"no function {function} in the SASS of {lib_name}")
    marks = [a for a, op, _ in insns if op.startswith(marker)]
    if not marks:
        raise ValueError(f"no {marker} in {function}")
    loops = []
    for addr, op, body in insns:
        if not op.startswith("BRA"):
            continue
        tgt = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", body.split(None, 1)[1])
        to = labels.get(tgt.group(1)) if tgt.group(1) else int(tgt.group(2),
                                                              16)
        if to is not None and to <= marks[0] <= addr:
            loops.append((addr - to, to, addr))
    if not loops:
        raise ValueError(f"no loop around {marker} in {function}")
    _, lo, hi = min(loops)
    body = [(op, b) for a, op, b in insns if lo <= a <= hi]
    trips = sum(op.startswith(marker) for op, _ in body)
    f64 = alu = 0
    for op, _ in body:
        base = op.split(".")[0]
        if base.startswith(_SASS_SKIP) or base.startswith(("LD", "ST",
                                                          "RED", "ATOM")):
            continue
        if base.startswith("D") or (base in ("MUFU", "F2F", "I2F", "F2I")
                                    and "64" in op and (
                                        base == "MUFU" or "F64" in op)):
            f64 += 1
        else:
            alu += 1
    return f64 / trips, alu / trips, trips, [b for _, b in body]


def _capture_css():
    """Wrap ops/css.py's css_pass so that a CLI run leaves a copy of the
    operands of every launch on the card; returns (record, undo)."""
    from dashing2_tpu_torch.ops import css as CSS
    real = CSS.css_pass
    rec = []

    def wrapped(sx1, srv, k, threshold, m, return_ids=False):
        if sx1.is_cuda:
            rec.append((sx1.clone(), srv.clone(), k.clone(),
                        threshold.clone(), m))
        return real(sx1, srv, k, threshold, m, return_ids)
    CSS.css_pass = wrapped

    def undo():
        CSS.css_pass = real
    return rec, undo


def phase_css_vs_plain(launches):
    """csrc/css.cu on the `--full-setsketch` job's own operands (phase
    15's launches): on the first CSS_CHECK_ITEMS items of the first
    launch, registers, cutoffs and winners == css_pass_plain's bit for
    bit, and the early-exit walk's draws counted by css_walk_plain ==
    walk_draws' count from the kernel's registers and winners; the same
    on tests/css_planted.py's rows (equal rows and own-row hits where the
    kernel's 32-row steps meet, caps of 0, 1, 33 and 95) at
    CSS_PLANTED_MS; then the kernel alone over every launch of the job,
    timed with CUDA events, against its bound over all kept (row,
    register) draws and over the draws the early exit evaluates, each
    draw charged CSS_INT_OPS and CSS_F64_OPS; and the lane slots a draw
    of the walk's schedules, from the walks' lengths: the PR 18 kernel's
    (a thread a register, a warp or block of 128 running until its
    longest walk ends) and this kernel's (a warp a register, 32 rows a
    step)."""
    import torch
    from dashing2_tpu_torch.ops import css as CSS
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from css_planted import planted_rows
    finally:
        sys.path.pop(0)

    def same(got, want, what):
        for g, w, name in zip(got, want, ("registers", "tcut", "winners")):
            assert torch.equal(g.view(torch.int64) if g.is_floating_point()
                               else g, w.view(torch.int64)
                               if w.is_floating_point() else w), \
                f"{what}: {name} != plain"
    sx1, srv, k, t, m = launches[0]
    cut = [x[:CSS_CHECK_ITEMS].contiguous() for x in (sx1, srv, k, t)]
    got = CSS.css_pass(*cut, m, return_ids=True)
    torch.cuda.synchronize()
    want = CSS.css_pass_plain(*cut, m, return_ids=True)
    same(got, want, "the job's rows")
    err = float((got[0] - want[0]).abs().nan_to_num(0.0).max())
    for pm in CSS_PLANTED_MS:
        (px1, prv, pk, pt), winners = planted_rows(pm, seed=pm + 21)
        planted = [x.cuda() for x in (px1, prv, pk, pt)]
        pgot = CSS.css_pass(*planted, pm, return_ids=True)
        same(pgot, CSS.css_pass_plain(*planted, pm, return_ids=True),
             f"planted rows at m {pm}")
        ids = pgot[2].cpu()
        assert all(int(ids[i, j]) == d for (i, j), d in winners.items())
    # the walk over the first CSS_WALK_ROWS rows (the items' caps cut)
    short = [cut[0][:, :CSS_WALK_ROWS].contiguous(),
             cut[1][:, :CSS_WALK_ROWS].contiguous(),
             cut[2].clamp(max=CSS_WALK_ROWS), cut[3]]
    walk = CSS.css_walk_plain(*short, m)
    full = CSS.css_pass(*short, m, return_ids=True)
    assert all(torch.equal(a, b) for a, b in zip(walk[:3], full))
    walked = CSS.walk_draws(short[0], short[2], short[3], full[0], full[2])
    assert torch.equal(walked, walk[3]), "walk_draws != the plain walk"
    plain_ms = _cuda_ms(lambda: CSS.css_pass_plain(*cut, m), 1)
    cut_ms = _cuda_ms(lambda: CSS.css_pass(*cut, m), 3)
    # the whole job: every launch timed, the draws counted
    ms, kept_rows, nbytes, walks = 0.0, 0, 0, []
    for sx1, srv, k, t, m in launches:
        CSS.css_pass(sx1, srv, k, t, m)
        torch.cuda.synchronize()
        ms += _cuda_ms(lambda: CSS.css_pass(sx1, srv, k, t, m), 3)
        regs, _, ids = CSS.css_pass(sx1, srv, k, t, m, return_ids=True)
        keep = (torch.arange(sx1.shape[1], device=sx1.device)[None, :]
                < k[:, None]) & (sx1 <= t[:, None])
        rows = int(keep.sum())
        kept_rows += rows
        walks.append(CSS.walk_draws(sx1, k, t, regs, ids))
        nbytes += 16 * rows + 8 * sx1.shape[0] * (m + 1)
        del regs, ids, keep
    items = sum(x[0].shape[0] for x in launches)
    all_draws = kept_rows * m
    drawn = sum(int(w.sum()) for w in walks)
    slots = {name: sum(fn(w, g) * int(w.sum()) for w in walks) / drawn
             for name, fn, g in (("warp", CSS.lane_slot_ratio, 32),
                                 ("block", CSS.lane_slot_ratio, 128),
                                 ("steps", CSS.step_slot_ratio, 32))}
    t_f64 = drawn * CSS_F64_OPS / RATES["f64"] * 1e3
    t_alu = drawn * CSS_INT_OPS / RATES["int32"] * 1e3
    t_bytes = nbytes / HBM * 1e3
    bound_ms = max(t_f64, t_alu, t_bytes)
    bound_all = max(all_draws * CSS_F64_OPS / RATES["f64"],
                    all_draws * CSS_INT_OPS / RATES["int32"]) * 1e3
    bound_by = "bytes" if t_bytes >= max(t_f64, t_alu) else "operations"
    _say(f"[css] kernel == css_pass_plain bit for bit (registers, tcut, "
         f"winners) on the first {CSS_CHECK_ITEMS} items of the "
         f"--full-setsketch job's first launch ({cut[0].shape[1]} rows x m "
         f"{m}) and on the planted rows at m {CSS_PLANTED_MS} (the planted "
         f"winners win); there kernel {cut_ms:.3f} ms, plain "
         f"{plain_ms:.3f} ms; over their first {CSS_WALK_ROWS} rows the "
         f"plain early-exit walk == the kernel's pass, and its "
         f"{int(walk[3].sum())} evaluated draws == walk_draws' count from "
         "the kernel's output")
    _say(f"[css] lane slots a draw of the walk: {slots['warp']:.4f} for a "
         f"thread a register (PR 18: its warp runs until its longest of 32 "
         f"walks ends), {slots['block']:.4f} over a block of 128 such "
         f"threads; {slots['steps']:.4f} for a warp a register, 32 rows a "
         "step (this kernel)")
    _say(f"[css] the job's {len(launches)} launch(es) over {items} items: "
         f"kernel {ms:.3f} ms (CUDA events, mean of 3 each); {kept_rows} "
         f"kept rows, {all_draws} kept (row, register) draws, {drawn} "
         f"evaluated by the early exit ({100 * drawn / all_draws:.2f}%); "
         f"bound {bound_ms:.3f} ms over the evaluated draws at "
         f"{CSS_INT_OPS} int32 and {CSS_F64_OPS} f64 instructions a draw "
         f"(f64 {t_f64:.3f}, int32 {t_alu:.3f}, bytes {t_bytes:.4f} ms: "
         f"{100 * bound_ms / ms:.1f}% reached), {bound_all:.3f} ms over all "
         f"kept draws ({100 * bound_all / ms:.1f}%); library: none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_all_ms=bound_all, err=err,
                library_ms=None, draws=drawn, all_draws=all_draws,
                lane_slots=slots,
                plain_shape=f"the first {CSS_CHECK_ITEMS} of the {items} "
                f"items ms and bound_ms cover (kernel there {cut_ms:.3f} "
                "ms)")


def _capture_countsketch():
    """Wrap ops/countsketch.py's countsketch_batch so that a CLI run
    leaves a copy of every batch it took on the card: (hashes on the
    card, offsets, cssize)."""
    from dashing2_tpu_torch.ops import countsketch as CS
    real = CS.countsketch_batch
    rec = []

    def wrapped(hv, offsets, cssize):
        if hv.is_cuda:
            rec.append((hv.clone(), offsets.clone(), cssize))
        return real(hv, offsets, cssize)
    CS.countsketch_batch = wrapped

    def undo():
        CS.countsketch_batch = real
    return rec, undo


def _cs_set(rec):
    """The captured batches of one job as one set (hashes, offsets,
    cssize): the batches' streams in order."""
    import torch
    hv = torch.cat([r[0] for r in rec])
    offs = [rec[0][1]]
    for r in rec[1:]:
        offs.append(r[1][1:] + offs[-1][-1])
    return hv, torch.cat(offs), rec[0][2]


# set (b) of the CountSketch phase: 8 streams of a 5 Mbp bacterial
# genome's 31-mers, 5 hashes repeated 1,000 times and one 100,000 times
# in each, at cssize 2^20 (and the first stream again at 2^31 - 1)
CS_BACTERIA, CS_BACTERIA_N, CS_BACTERIA_SEED = 8, 5_000_000, 5
# the bound's yardstick for a CountSketch hash: the int32 lane
# instructions of the least form of its work, reckoned once and kept
# fixed: the u64 modulo by a precomputed reciprocal (a 64 x 64 high
# product 8, q * cssize 3, the remainder 2, two conditional
# subtractions 6), the sign 2 and the accumulate 1
CS_OPS = 22
# the earlier dense-bucket kernel, built beside the port's as the
# phase's yardstick
CS_DENSE_SOURCE = os.path.join(ROOT, "experiments", "countsketch_dense.cu")


def _cs_bacterial(n_streams: int, cssize: int):
    """Set (b) on the card from a seeded generator: n_streams streams of
    CS_BACTERIA_N random u64 hashes, each with 5 hashes planted 1,000
    times and one 100,000 times at random places."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(CS_BACTERIA_SEED)
    n = CS_BACTERIA_N
    parts = []
    for _ in range(n_streams):
        hi = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda")
        lo = torch.randint(0, 1 << 32, (n,), generator=g, device="cuda")
        hv = (hi << 32) | lo
        pos = torch.randperm(n, generator=g, device="cuda")[:105000]
        reps = torch.repeat_interleave(hv[:6], torch.tensor(
            [1000] * 5 + [100000], device="cuda"))
        hv[pos] = reps
        parts.append(hv)
    offsets = torch.arange(n_streams + 1, dtype=torch.int64) * n
    return torch.cat(parts), offsets, cssize


def _cs_dense_lib():
    import ctypes
    from dashing2_tpu_torch import native
    lib = native.build_shared("countsketch_dense", [CS_DENSE_SOURCE],
                              native.nvcc_command(CS_DENSE_SOURCE))
    lib.countsketch.restype = ctypes.c_int
    lib.countsketch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_ulonglong, ctypes.c_void_p,
                                ctypes.c_void_p]
    return lib


def cs_dense_function(lib, hv, offsets, cssize: int):
    """The dense-bucket route's whole function over a set, a stream at a time,
    ids and sums left on the card: a cssize-sized int32 bucket array
    zeroed, the kernel, `torch.nonzero`, the gather, |.| and the cast to
    f64 (as ops/countsketch.py did before the batched entry)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for s in range(offsets.shape[0] - 1):
        h = hv[int(offsets[s]):int(offsets[s + 1])]
        b = torch.zeros(cssize, dtype=torch.int32, device="cuda")
        assert lib.countsketch(h.data_ptr(), h.shape[0], cssize,
                               b.data_ptr(), stream) == 0
        nz = torch.nonzero(b).squeeze(1)
        out.append((nz, b[nz].abs().to(torch.float64)))
    return out


def _cs_library(prepped, cssize: int):
    """torch.bincount(idx, weights=sign, minlength=cssize) a stream, then
    nonzero and the gather: the same output, from ids and signs made
    before its window."""
    import torch
    out = []
    for idx, sign in prepped:
        b = torch.bincount(idx, weights=sign, minlength=cssize)
        nz = torch.nonzero(b).squeeze(1)
        out.append((nz, b[nz].abs()))
    return out


def _cs_hold(tag, want, per_stream) -> None:
    """per_stream [(ids, sums)] == the rows `want` (K, 2), in order."""
    import torch
    ids = torch.cat([i for i, _ in per_stream])
    sums = torch.cat([v for _, v in per_stream])
    assert torch.equal(ids, want[:, 0].to(torch.int64)), tag
    assert torch.equal(sums.to(torch.float64),
                       want[:, 1].to(torch.float64)), tag


def phase_countsketch_vs_plain(sets, dense_lib):
    """csrc/countsketch.cu on three sets of streams: (a) phase 24's 8
    genomes, (b) 8 bacterial-genome streams (and one at cssize 2^31 - 1),
    (c) phase 46's 8,192 records. On each, the kernel's counts and rows
    == the plain version's, == torch.bincount's (a stream at a time,
    nonzero and gather) and == the dense-bucket route's function, exactly;
    the kernel route (ids and sums on the card, no host copy in the
    window), the plain version, the library call and the dense function
    timed by CUDA events; the bound (CS_OPS, and 8 bytes a hash, a
    non-zero bucket and a stream offset) and each one's share of it."""
    import torch
    from dashing2_tpu_torch.ops import countsketch as CS
    from dashing2_tpu_torch.ops import hashes as DH
    reps = {"a": (20, 5, 5), "b": (5, 3, 3), "b31": (2, 1, 1),
            "c": (5, 1, 1)}
    res = {}
    for tag, (hv, offsets, cssize) in sets.items():
        t0 = time.perf_counter()
        n, S = hv.shape[0], offsets.shape[0] - 1
        out, counts = CS.countsketch_batch(hv, offsets, cssize)
        torch.cuda.synchronize()
        pout, pcounts = CS.countsketch_batch_plain(hv, offsets, cssize)
        assert torch.equal(counts, pcounts), tag
        k = int(counts.sum())
        assert torch.equal(out[:k], pout[:k]), tag
        rows = out[:k]
        del pout
        _cs_hold(f"{tag} dense", rows, cs_dense_function(dense_lib, hv,
                                                         offsets, cssize))
        prepped = []
        for s in range(S):
            h = hv[int(offsets[s]):int(offsets[s + 1])]
            prepped.append((DH.u64_mod(h, cssize), torch.where(
                (h & 1) != 0, 1.0, -1.0).to(torch.float64)))
        _cs_hold(f"{tag} bincount", rows, _cs_library(prepped, cssize))
        del rows, out
        r_new, r_lib, r_old = reps[tag]
        ms = _library_ms(lambda: CS.countsketch_batch(hv, offsets, cssize),
                         r_new)
        plain_ms = _library_ms(
            lambda: CS.countsketch_batch_plain(hv, offsets, cssize), r_lib)
        library_ms = _library_ms(lambda: _cs_library(prepped, cssize), r_lib)
        old_ms = _library_ms(lambda: cs_dense_function(
            dense_lib, hv, offsets, cssize), r_old)
        del prepped
        nbytes = 8 * n + 8 * k + 8 * (S + 1)
        bound_ms, bound_by = _bound(n * CS_OPS, "int32", nbytes)
        res[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        old_ms=old_ms, bound_ms=bound_ms, bound_by=bound_by,
                        bytes=nbytes, hashes=n, streams=S, nonzero=k,
                        cssize=cssize, share=bound_ms / ms,
                        old_share=bound_ms / old_ms)
        _say(f"[countsketch] set {tag}: {S} streams, {n} hashes, cssize "
             f"{cssize}, {k} non-zero buckets; kernel == plain == "
             f"torch.bincount == the dense function, exactly; kernel route "
             f"{ms:.4f} ms (CUDA events, mean of {r_new}), dense function "
             f"{old_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bincount "
             f"{library_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: "
             f"{nbytes} bytes, {CS_OPS} int32 lane instructions a hash); "
             f"{100 * bound_ms / ms:.2f}% reached (dense "
             f"{100 * bound_ms / old_ms:.2f}%); phase wall "
             f"{time.perf_counter() - t0:.3f} s")
        torch.cuda.empty_cache()
    c = res["c"]
    return dict(ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                bound_by=c["bound_by"], err=0, library_ms=c["library_ms"],
                sets=res)


def _cache_files(d: str):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def phase_cache(lst: str, counters):
    """`sketch --cache --outprefix D` over the first CACHE_N genomes of
    the N = 10240 corpus, for the one-permutation `-o`,
    `--full-setsketch`, `--full-setsketch --fastcmp-bytes`, `--set`,
    `--countdict` and `-B` jobs: a cold run; a warm run that sketches
    nothing (no route's span, no draw launched) and loads every
    artifact; a run with every third genome's artifacts deleted, which
    sketches only those and rewrites them. Every output (the matrix,
    `-o`, the artifacts) equals the cold run's byte for byte; the
    artifacts of the first CACHE_CPU genomes (CACHE_CPU_BMH for -B)
    equal a `--device cpu` run's."""
    from dashing2_tpu_torch import cli
    from dashing2_tpu_torch.sketch import core
    d = os.path.join(WORK, "northstar", "cache")
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()][:CACHE_N]
    real = core._sketch_routes
    sketched = []

    def routes(opts, groups, device):
        sketched.append(list(groups))
        return real(opts, groups, device)
    core._sketch_routes = routes
    try:
        return {tag: _cache_job(tag, flags, sig, paths, d, counters,
                                sketched, cli.main)
                for tag, flags, sig in CACHE_JOBS}
    finally:
        core._sketch_routes = real


def _cache_job(tag: str, flags, sig: bool, paths, d: str, counters,
               sketched, cli_main):
    """One job of phase_cache: cold, warm and partial runs, then the
    --device cpu run over the first genomes."""
    pd = os.path.join(d, tag)
    os.makedirs(pd)
    outs, walls, total = [], [], {}
    for run in ("cold", "warm", "partial"):
        if run == "partial":
            gone = [os.path.basename(p) + "." for p in paths[::3]]
            for name in os.listdir(pd):
                if name.startswith(tuple(gone)):
                    os.remove(os.path.join(pd, name))
        sketched.clear()
        out = os.path.join(d, f"{tag}-{run}.bin")
        argv = ["sketch", "-k", "31"] + flags + [
            "--cache", "--outprefix", pd, "--binary-output", "--cmpout",
            out] + (["-o", out + ".sig"] if sig else []) + paths
        wall, spans, launches = _run_cli(f"{tag} {run}", argv,
                                         CACHE_N, counters)
        walls.append(wall)
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v
        assert sketched == ({"cold": [paths], "warm": [],
                             "partial": [paths[::3]]}[run]), \
            (tag, run, [len(g) for g in sketched])
        data = open(out, "rb").read() + (
            open(out + ".sig", "rb").read() if sig else b"")
        outs.append((data, _cache_files(pd)))
        route = sorted(k for k in SKETCH_ROUTE_SPANS if k in spans)
        if run == "warm":
            assert not route, f"{tag}: the warm run sketched: {route}"
            assert launches["css"] == launches["weighted_draws"] \
                == launches["countsketch"] == 0, launches
        else:
            assert route, f"{tag}: the {run} run sketched nothing"
        if "--full-setsketch" in flags and run != "warm":
            assert launches["css"] >= 1, launches
        if "-B" in flags and run != "warm":
            assert launches["weighted_draws"] >= 1, launches
    assert len(outs[0][1]) >= CACHE_N, (tag, len(outs[0][1]))
    assert outs[1] == outs[0] and outs[2] == outs[0], \
        f"{tag}: a warm or partial run changed a byte"
    # the first genomes' artifacts against a --device cpu run's
    ncpu = CACHE_CPU_BMH if "-B" in flags else CACHE_CPU
    cd = os.path.join(d, tag + "-cpu")
    os.makedirs(cd)
    t0 = time.perf_counter()
    assert cli_main(["sketch", "-k", "31"] + flags + [
        "--cache", "--outprefix", cd, "--device", "cpu"]
        + paths[:ncpu]) == 0
    cpu_s = time.perf_counter() - t0
    cpu_files = _cache_files(cd)
    assert len(cpu_files) >= ncpu
    assert all(outs[0][1][f] == b for f, b in cpu_files.items()), tag
    _say(f"[{tag}] {CACHE_N} genomes: cold {walls[0]:.3f} s, warm "
         f"{walls[1]:.3f} s (no route ran, no draw launched), a third "
         f"deleted {walls[2]:.3f} s; every output byte == the cold "
         f"run's; {len(outs[0][1])} artifacts, those of the first "
         f"{ncpu} == --device cpu's ({cpu_s:.3f} s)")
    shutil.rmtree(pd, ignore_errors=True)
    shutil.rmtree(cd, ignore_errors=True)
    return dict(walls=walls, launches=total)


def phase_jax_golden(name: str):
    """The port's CLI on the card with the JAX package's golden config
    `name` (tests/golden_configs.py), over its fixtures
    (tests/make_fixtures.py), against the committed file."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from golden_configs import CONFIGS, LENGTH, N_GENOMES
        from make_fixtures import make
    finally:
        sys.path.pop(0)
    from dashing2_tpu_torch import cli
    d = os.path.join(WORK, "fixtures")
    paths = make(d, n_genomes=N_GENOMES, length=LENGTH, seed=42)
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    args, _ = CONFIGS[name]
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert cli.main(list(args) + ["--device", "cuda"]) == 0
        with open(name, "rb") as f:
            got = f.read()
    finally:
        os.chdir(cwd)
    with open(os.path.join(ROOT, "tests", "goldens", name), "rb") as f:
        want = f.read()
    assert got == want, (name, "fixtures sha256 " + h.hexdigest())
    _say(f"[golden] {name}: the port's bytes on the card == the committed "
         f"JAX golden ({len(got)} bytes)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    import dashing2_tpu_torch  # noqa: F401  (fails outside a checkout)
    from dashing2_tpu_torch.ops import countsketch as CS
    from dashing2_tpu_torch.ops import css as CSS
    from dashing2_tpu_torch.ops import fixedmath as FM
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.ops import omh as OP
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.ops import weighted_draws as WD
    # one process on this machine: the plain versions' CPU runs (phases
    # 15 and 24) may use every core, in chunks that torch spreads over
    # its threads (the port's defaults keep CPU ops on one thread, for
    # processes that share the cores)
    FM._CPU_CHUNK = 1 << 18
    WD._PLAIN_CHUNK["cpu"] = 1 << 21
    counters = {"tri_eq": NT, "tri_comb": NC, "gtlt_self": G.self_launches,
                "gtlt": G.rect_launches, "int_counts_self": IC.self_launches,
                "int_counts": IC.rect_launches,
                "weighted_draws": WD.launches, "omh": OP.launches,
                "oph_rows": OR.launches, "css": CSS.launches,
                "countsketch": CS.launches, "hash_rows": OR.hash_launches}
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _say(f"[wall] phase {name}: {time.perf_counter() - t0:.3f} s")
        return out
    smi = timed("device", phase_device)
    timed("build", phase_build)
    worst_eq, worst_comb = timed("kernels", phase_kernel_vs_plain)
    worst_self, worst_rect = timed("gtlt kernels", phase_gtlt_vs_plain)
    worst_int_self, worst_int_rect = timed("int_counts kernels",
                                           phase_int_vs_plain)
    weighted_runs = timed("weighted_draws kernel", phase_weighted_vs_plain)
    try:
        for gold in ("torch_port_bbit_nibble.json",
                     "torch_port_ab_nibble.json", "torch_port_full.json",
                     "torch_port_u8_bbit.json", "torch_port_u16_ab.json",
                     "torch_port_panel.json", "torch_port_knn.json",
                     "torch_port_dedup.json"):
            timed(f"golden {gold}", phase_golden, gold)
        t0 = time.perf_counter()
        lst = _corpus("northstar", NS_SEED, NS_ANCESTORS, NS_MUTANTS,
                      NS_LENGTH)
        _say(f"[main] corpus: {NORTH_STAR_N} genomes x {NS_LENGTH} bp "
             f"written in {time.perf_counter() - t0:.3f} s")
        sketches = timed("sketch for the checks", _sketch, lst)
        eq_run = timed("b-bit job", phase_main_bbit, lst, sketches, counters)
        comb_run = timed("a/b job", phase_main_ab, lst, sketches, counters)
        self_run = timed("full job", phase_main_full, lst, sketches,
                         counters)
        int_runs = {tag: timed(f"{tag} job", phase_main_int, tag, fd, bbit,
                               lst, sketches, counters)
                    for tag, fd, bbit in INT_JOBS}
        timed("u32-ab job", phase_main_u32, lst, sketches, counters)
        measure_runs = {tag: timed(f"{tag} job", phase_measure, tag, flags,
                                   counter, kw, lst, sketches, counters)
                        for tag, flags, counter, kw in MEASURE_JOBS}
        refs, queries = _split(lst, PANEL_EVERY)
        panel = _panel_sketches(sketches, PANEL_EVERY)
        panel_runs = {tag: timed(f"{tag} job", phase_panel, tag, flags,
                                 counter, kw, refs, queries, panel, counters)
                      for tag, flags, counter, kw in PANEL_JOBS}
        del panel
        outs = {}
        for tag, flags in GRAPH_JOBS:
            timed(f"{tag} job", phase_graph, tag, flags, lst, sketches,
                  counters, outs)
        assert outs["knn-index-load"] == outs["knn-full"], \
            "the loaded index gave another graph"
        _say("[graph] --index-load run == the --index-save run (and so the "
             "CPU run), byte for byte")
        del sketches
        timed("golden full_sim.bin", phase_jax_golden, "full_sim.bin")
        lists = _subset_lists(lst)
        with open(lst) as f:
            half = _write_list(os.path.join(os.path.dirname(lst), "half.txt"),
                               [ln.strip() for ln in f
                                if ln.strip()][:HALF_N])
        fss_runs = {"fss": timed("fss job", phase_fss, half, counters)}
        css_run = timed("css kernel", phase_css_vs_plain,
                        fss_runs["fss"].pop("css_operands"))
        fss_runs["fss-u8-ab"] = timed("fss-u8-ab job", phase_fss_bytes,
                                      lists[0], counters)
        for tag, flags, sig, want, counter, n in PRESKETCHED_JOBS:
            fss_runs[tag] = timed(f"{tag} job", phase_presketched, tag,
                                  flags, sig, want, counter, n, counters)
        t0 = time.perf_counter()
        w_jobs = {"wmh": timed("wmh job", phase_wmh, half, counters),
                  "pmh-c": timed("pmh-c jobs", phase_pmh_countsketch, lst,
                                 counters),
                  "pmh-knn": timed("pmh-knn job", phase_pmh_knn, half,
                                   counters)}
        _say(f"[wall] weighted phases: {time.perf_counter() - t0:.3f} s")
        cache_runs = timed("cache jobs", phase_cache, lst, counters)
        t0 = time.perf_counter()
        i_jobs = {"contain": timed("save-kmers and contain jobs",
                                   phase_contain, lst, counters)}
        i_jobs["bed"] = timed("bed jobs", phase_bed, counters)
        i_jobs["bigwig"] = timed("bigwig jobs", phase_bigwig, counters)
        i_jobs["leafcutter"] = timed("leafcutter job", phase_leafcutter,
                                     counters)
        i_jobs["wsketch"] = timed("wsketch jobs", phase_wsketch, counters)
        _say("[wall] interval, wsketch and contain phases: "
             f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        timed("set job", phase_exact_set, half, counters)
        for tag, flags in EXACT_CPU_JOBS[:2]:
            timed(f"{tag} job", phase_exact_vs_cpu, tag, flags, lists,
                  counters)
        timed("set-knn jobs", phase_exact_knn, half, counters)
        timed(f"{EXACT_CPU_JOBS[2][0]} job", phase_exact_vs_cpu,
              *EXACT_CPU_JOBS[2], lists, counters)
        timed("u128 set jobs", phase_u128_sets, lists, counters)
        _say(f"[wall] exact-set phases: {time.perf_counter() - t0:.3f} s")
        omh_run, e_runs = phase_edit(lst, counters)
        oph_run, c_runs, hash_run = phase_chunked(lst, counters)
        cs_sets = {"a": w_jobs["pmh-c"].pop("streams"),
                   "b": _cs_bacterial(CS_BACTERIA, 1 << 20),
                   "b31": _cs_bacterial(1, (1 << 31) - 1),
                   "c": c_runs["byseq-pmh-c"].pop("streams")}
        cs_run = timed("countsketch kernel", phase_countsketch_vs_plain,
                       cs_sets, _cs_dense_lib())
        del cs_sets
        shutil.rmtree(os.path.join(WORK, "northstar"), ignore_errors=True)
        t0 = time.perf_counter()
        lst = _corpus("rowblock", ROWS_SEED, ROWS_ANCESTORS, ROWS_MUTANTS,
                      ROWS_LENGTH)
        _say(f"[rows] corpus: {ROWS_N} genomes x {ROWS_LENGTH} bp written "
             f"in {time.perf_counter() - t0:.3f} s")
        sketches = timed("sketch for the row-block checks", _sketch, lst)
        rect_run = timed("row-block job", phase_rowblock, lst, sketches,
                         counters)
        int_rect_run = timed("u8 row-block job", phase_rowblock_int, lst,
                             sketches, counters)
        nibble_rows = {tag: timed(f"{tag} row-block job",
                                  phase_rowblock_nibble, tag, bbit, lst,
                                  sketches, counters)
                       for tag, bbit in (("rows-nibble-bbit", True),
                                         ("rows-nibble-ab", False))}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    _say(f"[wall] all phases: {time.perf_counter() - t_start:.3f} s")
    # int_counts_self: launches summed over the four --fastcmp 1|2 jobs,
    # times and bound of the u8 a/b job's gtlt mode; int_counts_self_eq:
    # the same kernel in eq mode, launches of the two b-bit jobs, times,
    # bound and library call of the u8 b-bit job (each job's are printed
    # above)
    int_self_run = dict(int_runs["u8-ab"],
                        launches=sum(r["launches"] for r in int_runs.values()),
                        err=max(r["err"] for r in int_runs.values()))
    int_self_eq_run = dict(int_runs["u8-bbit"], launches=sum(
        int_runs[t]["launches"] for t in ("u8-bbit", "u16-bbit")))
    # the measure jobs' and nibble row-block jobs' launches join their
    # kernels' counts (times and bounds stay those printed above)
    for run, key, tags in (
            (eq_run, "tri_eq", ("mash-nibble-bbit",)),
            (comb_run, "tri_comb", ("union-nibble-ab",)),
            (self_run, "gtlt_self", ("containment-full-asym", "eqfull")),
            (int_self_run, "int_counts_self", ("intersection-u8-ab",
                                               "symcontain-u16-bbit")),
            (int_self_eq_run, "int_counts_self", ("symcontain-u16-bbit",))):
        run["launches"] += sum(measure_runs[t][key] for t in tags)
    int_rect_run["launches"] += sum(r["int_counts"]
                                    for r in nibble_rows.values())
    # the FullSetSketch and presketched jobs' launches join their kernels'
    # counts (their times are those of the jobs above at the same shapes)
    for run, key in ((self_run, "gtlt_self"),
                     (int_self_run, "int_counts_self"), (eq_run, "tri_eq")):
        run["launches"] += sum(r["launches"][key] for r in fss_runs.values())
    # the interval jobs' gtlt_self launches join its count (their
    # weighted draws join weighted_draws below)
    i_runs = [r for key in ("bed", "bigwig", "leafcutter")
              for r in i_jobs[key].values()]
    self_run["launches"] += sum(r["launches"]["gtlt_self"] for r in i_runs)
    # the cache jobs' comparisons join their kernels' counts
    for run, key in ((self_run, "gtlt_self"),
                     (int_self_run, "int_counts_self")):
        run["launches"] += sum(r["launches"][key]
                               for r in cache_runs.values())
    # the edit-distance jobs' comparisons join their kernels' counts
    for run, key, tags in ((self_run, "gtlt_self", ("edit-full",
                                                    "edit-whole")),
                           (eq_run, "tri_eq", ("edit-nibble",)),
                           (int_self_eq_run, "int_counts_self",
                            ("edit-u8",))):
        run["launches"] += sum(e_runs[t]["launches"][key] for t in tags)
    # the chunked route's comparisons and draws join their kernels' counts
    for run, key, tags in ((self_run, "gtlt_self", (
            "filterset", "filterset-raw", "contigs-plain", "contigs-xz",
            "contigs-bz2", "contigs-by-chrom", "contigs-xz-by-chrom",
            "byseq-fss", "byseq-pmh-c")), (eq_run, "tri_eq",
                                           ("byseq-pairs",))):
        run["launches"] += sum(c_runs[t]["launches"][key] for t in tags)
    # the panel jobs' rectangles join gtlt_counts and int_counts (their
    # own block times and bounds are printed above)
    for run, key in ((rect_run, "gtlt"), (int_rect_run, "int_counts")):
        run["launches"] += sum(r["launches"] for tag, _, c, _ in PANEL_JOBS
                               if c == key for r in [panel_runs[tag]])
    kernels = []
    for name, src, line, worst, run in (
            ("tri_eq_counts", "tri_eq.cu", 447, worst_eq, eq_run),
            ("tri_comb_counts", "tri_comb.cu", 367, worst_comb, comb_run),
            ("gtlt_self_counts", "gtlt.cu", 162, worst_self, self_run),
            ("gtlt_counts", "gtlt.cu", 45, worst_rect, rect_run),
            ("int_counts_self", "int_counts.cu", 239, worst_int_self,
             int_self_run),
            ("int_counts_self_eq", "int_counts.cu", 239, worst_int_self,
             int_self_eq_run),
            ("int_counts", "int_counts.cu", 239, worst_int_rect,
             int_rect_run)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dashing2_tpu_torch/csrc/{src}",
            "replaces": f"dashing2_tpu/ops/pallas_cmp.py:{line}",
            "launches": run["launches"],
            "max_abs_err": max(worst, run["err"]),
            "ms": run["ms"],
            "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"],
            "bound_by": run["bound_by"],
            "library_ms": run["library_ms"],
        })
    # the weighted draws: the -B job's kind (ICWS) timed, launches of the
    # three weighted jobs and of the interval and wsketch jobs
    wrun = weighted_runs["icws"]
    kernels.append({
        "name": "weighted_draws",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/weighted_draws.cu",
        "replaces": "dashing2_tpu/sketch/weighted.py:115",
        "launches": sum(r["launches"] for r in w_jobs.values())
        + sum(r["launches"]["weighted_draws"] for r in i_runs
              + list(i_jobs["wsketch"].values())
              + list(cache_runs.values()))
        + sum(c_runs[t]["launches"]["weighted_draws"]
              for t in ("byseq-bmh", "byseq-pmh-c")),
        "max_abs_err": wrun["err"],
        "ms": wrun["ms"],
        "plain_ms": wrun["plain_ms"],
        "bound_ms": wrun["bound_ms"],
        "bound_by": wrun["bound_by"],
        "library_ms": None,
    })
    # the OrderMinHash registers: the corpus launch timed, launches of
    # the edit-distance jobs
    kernels.append({
        "name": "omh",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/omh.cu",
        "replaces": "dashing2_tpu/sketch/omh.py:50",
        "launches": omh_run["launches"],
        "max_abs_err": omh_run["err"],
        "ms": omh_run["ms"],
        "plain_ms": omh_run["plain_ms"],
        "bound_ms": omh_run["bound_ms"],
        "bound_by": omh_run["bound_by"],
        "library_ms": None,
        "plain_shape": omh_run["plain_shape"],
    })
    # the chunked route's registers: the corpus' batches timed, launches
    # of the chunked-route jobs
    kernels.append({
        "name": "oph_rows",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/oph_rows.cu",
        "replaces": "dashing2_tpu/sketch/core.py:146",
        "launches": oph_run["launches"],
        "max_abs_err": oph_run["err"],
        "ms": oph_run["ms"],
        "plain_ms": oph_run["plain_ms"],
        "bound_ms": oph_run["bound_ms"],
        "bound_by": oph_run["bound_by"],
        "library_ms": None,
        "slice_ms": oph_run["slice_ms"],
        "slice_bare_ms": oph_run["slice_bare_ms"],
        "plain_shape": oph_run["plain_shape"],
    })
    # the CSetSketch draws: the --full-setsketch job's launches timed,
    # launches of every job that draws them
    kernels.append({
        "name": "css",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/css.cu",
        "replaces": "dashing2_tpu/ops/sketch_kernels.py:622",
        "launches": sum(r["launches"]["css"] for r in list(
            fss_runs.values()) + i_runs
            + list(i_jobs["wsketch"].values())
            + list(cache_runs.values()))
        + c_runs["byseq-fss"]["launches"]["css"],
        "max_abs_err": css_run["err"],
        "ms": css_run["ms"],
        "plain_ms": css_run["plain_ms"],
        "bound_ms": css_run["bound_ms"],
        "bound_by": css_run["bound_by"],
        "library_ms": None,
        "bound_all_draws_ms": css_run["bound_all_ms"],
        "lane_slots": css_run["lane_slots"],
        "plain_shape": css_run["plain_shape"],
    })
    # the minimizer sequences' hash stream: the --seq settings over the
    # by-record corpus timed (and the --long-kmers full keys under
    # "full_keys"), launches of the --seq jobs
    kernels.append({
        "name": "hash_rows",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/oph_rows.cu",
        "replaces": "dashing2_tpu/sketch/core.py:59",
        "launches": hash_run["launches"],
        "max_abs_err": hash_run["err"],
        "ms": hash_run["ms"],
        "plain_ms": hash_run["plain_ms"],
        "bound_ms": hash_run["bound_ms"],
        "bound_by": hash_run["bound_by"],
        "library_ms": None,
        "bare_ms": hash_run["bare_ms"],
        "slice_ms": hash_run["slice_ms"],
        "full_keys": hash_run["full_keys"],
        "plain_shape": hash_run["plain_shape"],
    })
    # the CountSketch: set (c), the by-record -P -c job's batch, timed
    # (sets (a), (b) and (c) under "sets"); launches of both -P -c jobs
    kernels.append({
        "name": "countsketch",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/countsketch.cu",
        "replaces": "dashing2_tpu/ops/sketch_kernels.py:724",
        "launches": w_jobs["pmh-c"]["countsketch"]
        + c_runs["byseq-pmh-c"]["launches"]["countsketch"],
        "max_abs_err": cs_run["err"],
        "ms": cs_run["ms"],
        "plain_ms": cs_run["plain_ms"],
        "bound_ms": cs_run["bound_ms"],
        "bound_by": cs_run["bound_by"],
        "library_ms": cs_run["library_ms"],
        "sets": cs_run["sets"],
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
