#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (roaringregex_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
its check fails:

1. the card's name and power limit; build the CUDA kernels from
   roaringregex_tpu_torch/csrc with nvcc for sm_90a (one nvcc per source,
   all started together), with nvcc's register report and the build time;
2. kernel against plain PyTorch version on the card, for all fifty-one entry
   points, on random batches from a numpy seed plus edge records (empty,
   len == L, bytes >= 0x80, byte 0); integer outputs, tolerance 0:
   rrx_swar_stats and rrx_word_stats on the SWAR and u32-word test
   patterns, seeded and unseeded, lead 0 and h; the span kernels
   rrx_swar_reverse and rrx_swar_anchor_end (random starts with -1 and 0,
   lazy and longest) on every SWAR test pattern, rrx_swar_lazy_spans and
   rrx_swar_greedy_spans at cap 1, 2 and 16 (greedy overflow) on the
   non-nullable ones; the six matmul-tier kernels on record tiles of 8 to
   256 states (seeded, unseeded and lead stats; seeded and unseeded flags;
   reverse; anchor lazy and longest; lazy and greedy spans at caps 1, 2 and
   16, greedy overflow); the three counting-tier kernels on 16 plans (body
   lengths k = 1..8, 1..4 branches, nullable, a{300}, a{270,}; seeded and
   unseeded stats at lead 0 and m*k, seeded and unseeded flags, reverse);
   the four multi-pattern kernels (the P-channel forms of rrx_word_stats
   and rrx_nfa_stats, rrx_nfa_reverse_mb, rrx_nfa_lazy_spans_mb) on 9
   pattern sets (tests/test_multipattern.py's four, config 6, K7 and K16 as
   7 and 16 patterns, 12 one-letter patterns, nullable and `$` channels),
   with the channel bookkeeping in registers (P <= 8) and in global rows,
   stats seeded/unseeded/nullable/lead, spans at caps 1, 2 and 16 (cap 1
   overflows); the four long-string window kernels (rrx_long_carry,
   rrx_long_flags, rrx_long_count with and without the final state,
   rrx_long_reverse) on 7 programs (W = 1, 2 and 8, `^` and `$` at the
   string's edges, cyclic ones), strings of 0-3 bytes, 1 MiB and 4 MiB with
   bytes 0x00, 0x80 and 0xff and plants cut by the window edges, windows
   of 256 and 4096 bytes, seeded and unseeded, from the empty set, from
   random entry states with random seed gates and from the summary pass's
   basis states; the five bitband kernels (rrx_bitband_stats, _flags,
   _reverse, _anchor_end, _spans) on the 8 bitband programs of the tier
   (bench config 10 and 7 multiblock and sparse chains: W = 16 to 56,
   rank-1 columns, negative triangle gaps, `^` and `$` rows, the accept
   OR-fold) on 256-record batches with chains planted, stats seeded,
   unseeded and nullable, two accept channels on config 10, flags seeded
   and unseeded, reverse, anchored rescans lazy and longest from random and
   candidate starts (-1 and 0 included), spans lazy and longest at caps 1,
   2 and 16 (cap 1 overflows), and records past a live count (stats, flags
   and reverse); the register steps of rrx_bitband_stats, _flags and
   _reverse also on NW = 3 and 4 (x(ab|c){700,800}y,
   x(ab|c){1000,1300}y), two specs with every edge on a diagonal (offsets
   -2..4 and -300, -298), hand-built tables whose top lane holds state
   words (W = 32, 96 and 128, diagonals of both signs past 32 NW states, rank-1
   columns, gaps of both signs) and 32 accept channels on config 10,
   seeded, unseeded, nullable and live, and the reverse on config 10's
   records whose reverse state stays live on every step and records where
   it is empty on most (the step skipped); the three
   container kernels (rrx_sparse_stats, _flags, _reverse) on the 9
   container programs of the probe table (multiblock and sparse, config 13,
   a program at the 120-block cap whose table takes the global form, a full
   U block, config 10 with RRX_BITBAND=0, a nullable one, K120) and two
   past the engine's caps ((abc|de){1,420} and {1,800}: 3 and 4 state
   words a lane of the forward step), a hand-built partition with full
   blocks on and off the diagonal (with one accept channel, and with one
   per block), and MultiPattern sets of 2, 40 and 100 channels, in the
   shared and the global table form, stats seeded, unseeded and nullable,
   flags seeded and unseeded, reverse (on the program's accept set, the
   channel sets too), records past a live count, and seeded stats and
   reverse with the register steps' block-parallel form everywhere and
   their walk everywhere (walk_max -1 and 128); the six wide
   matmul-tier kernels (rrx_nfa_wide_stats, _flags, _reverse, _anchor_end,
   _lazy_spans, _greedy_spans: tiles of 257..1024 states, one warp per
   record) on 10 dense multiblock programs, one at each W = 12, 16, 20, 24,
   28 and 32, banded and not, keyword runs and a nullable K40*, with
   keyword runs and x(ab|c){k}y chains planted across the bounds, stats
   seeded, unseeded and at a lead, flags, reverse, anchored lazy and
   longest from -1, 0 and random starts, lazy and greedy spans at caps 1, 2
   and 16 (cap 1 overflows), and P = 3 accept channels (K40+, cat|dog and
   [0-9]{3} as one union) seeded, unseeded, nullable and at a lead; the
   reverse (the band step) also in the other band split of each program,
   the reverse and the flags (the band step, seeded and unseeded, two
   records a warp at W <= 16 and also at 32 lanes a record) on odd counts
   of records of every length around the 16-byte chunks and the flag and
   hit words (0 included) of x(ab|c){300,}y and K60+, and on hand-built
   tiles at W = 12, 16 and 32 with diagonals planted (random residual
   edges, or the seed row alone), both splits; the two
   wide multi-channel span kernels (rrx_nfa_wide_reverse_mb, both splits,
   rrx_nfa_wide_lazy_spans_mb) on that union, on K40+ with the `$`
   channels cat$ and [0-9]?$, and on 40 channels over K40+'s tile (lanes
   past 32 keep their bookkeeping in global rows), at caps 1, 2 and 16;
   the four wide long-string window kernels (rrx_long_wide_carry, _flags,
   _count with and without the final state, _reverse: one warp per window)
   on K60 (W = 16), [a-z]{300}x (W = 12), K120 (W = 28) and
   x(ab|c){300,340}y (W = 32), strings of 0-3 bytes and 1 MiB in windows
   of 256 bytes (lead 0 and the overlap), 4 MiB in windows of 4096 at W =
   16 and 32, seeded and unseeded, from the empty set and random entry
   states with random gates, and 3 windows a block (rep 3); the band step
   of _flags, _count and _reverse again on those four programs with every edge
   walked (max_diags=0) and at 32 lanes a window (the default at W <= 16
   is two windows a warp), and on hand-built tiles at W = 12, 16 and 32
   with diagonals planted at -70..64 (with random residual edges, or the
   seed row alone), each in every form, odd window counts included; the
   four stream-fed kernels (rrx_stream_stats, _flags, _reverse, _first_end: the
   packed backend over a mask stream) on 1 MB batches (1024 records of 1024
   B) of 9 programs at W = 1 (nullable and anchored ones too), 2, 4, 8, 12,
   16 and 32 and 2 MultiPattern sets (P = 3 at W = 1 and 12), stats seeded,
   unseeded and nullable, flags seeded and unseeded, reverse, first end lazy
   and longest from -1, 0 and random starts; the slotted multi-pattern SWAR
   kernel (rrx_swar_multi_stats) on 5 sets of 1-4 patterns (config 6,
   tests/test_multipattern.py's a* and x$, ^, $ and nullable members) on
   edge batches of 61, 64 and 256 B with the sets' matches planted, seeded
   and unseeded; the three stream-fed container kernels
   (rrx_sparse_stream_stats, _flags, _reverse) over the mask streams of
   K120, config 13, a nullable program, a full U block, the 120-block cap
   and config 10 (BitbandScanner's container tables), in each table form
   that fits (shared and global), stats seeded, unseeded and nullable, flags
   seeded and unseeded, reverse, each also equal to the byte kernels'
   outputs on the same records;
3. the match-stats path, with its launch counts set to 0 first: bench
   config 1 (cat|dog over 10 MB of 1024-byte records) through
   ScanEngine.match_stats, which must take the (4, 256, 3) window split,
   checked against an independent numpy count of cat/dog; then
   Pattern.search_batch and fullmatch_batch for configs 2 and 3 and a
   u32-word pattern against Python's re on 2,000 records; then cat|dog
   over 1 GiB of 1024-byte records through the engine (the counts are
   read after it);
4. the span path, with every launch count set to 0 first: bench config 7
   (cat|dog over the same 10 MB, lazy and greedy spans at cap 32) through
   ScanEngine.lazy_spans / greedy_spans, every record's spans checked
   against Python's re.finditer; then the span API on 2,000 records of
   <= 256 B: finditer_batch (longest) against re for POSIX-safe patterns,
   lazy finditer_batch against re with lazy quantifiers and for fixed-length
   patterns, against the plain version for a+ and a|ab, search and match
   against re, and lazy spans of a?$, b*$ and (ab)?$ (a span ending at
   EOS, then the empty match at len) against re (the counts are read after
   it);
5. the matmul-tier path (33..256-state programs, csrc/scan_nfa.cu), with
   every launch count set to 0 first: a 49-state and a 211-state keyword
   alternation over 1 GiB of 1024-byte log-text records (numpy seed,
   keywords planted) through ScanEngine.match_stats, checked against the
   plain version on a slice and against Python's re on 3,000 records; lazy
   and greedy spans of both at config 7's 10 MB shape, every record against
   re.finditer; the API (search_batch, count_batch, fullmatch_batch,
   finditer_batch, search, match) on 2,000 records against re, u32-word
   spans and nullable greedy spans against the plain version, lazy spans of
   [a-c]{0,40}$ against re (the counts are read after it);
6. the counting tier, the bitmaps and the seeded alias, with every launch
   count set to 0 first: bench config 4 (a{1,300}) over 10 MB of 1024-byte
   records (make_corpus, seed 0) and over 1 GiB of random lowercase with
   planted a-runs of 1-400 bytes, through ScanEngine.match_stats,
   fullmatch_flags and the anchored rescan, against a numpy run-length
   reference (all of 10 MB; 16,384 records of the 1 GiB batch, where the
   plain version is checked too); bench config 13 ((abc|de){1,300}) over 10
   MB and 1 GiB through its 6-state seeded alias on the SWAR tier, search
   and first end against numpy and re on 3,000 records (its own container
   tier: phase 11);
   ends_batch and starts_batch of a SWAR, a u32-word, a matmul-tier and a
   counting program against the sets re gives; finditer_batch of counting
   programs in host rounds (each round's anchored rescan on
   rrx_stream_first_end) against re (greedy, and lazy against the lazy
   quantifier); the counts are read after it;
8. (run before 7) the multi-pattern path, with every launch count set to
   0 first: MultiPattern on bench config 6 (["cat|dog", "[0-9]{3}",
   "err(or)?", "ab(cd)*e"], u32-word tier, P = 4) over config 1's 10 MB
   corpus through count_batch, search_batch, grep and lazy finditer_batch,
   and over 1 GiB of lowercase with every channel's words planted through
   the engine and lazy_spans_mb; K7 as 7 patterns (matmul tier, P = 7)
   over phase 5's 1 GiB log text; the `$` channels of ["a?$", "b*$",
   "cat"] against re; the counts are read after it; then checked: counts,
   search and spans per pattern against the single-pattern engines (every
   record), numpy (cat|dog, [0-9]{3}) and re (10 MB; K7 on 3,000 records);
9. (run before 7) one long string, with every launch count set to 0
   first: Pattern.long on one 1 GiB string per config: config 8 (phase 3's
   text as one string; SWAR and matmul windows, search, fullmatch through
   summary + replay) against numpy; config 9 (a-runs of 1-400 B) against
   numpy; config 12 pure ASCII and with 2,000 bytes >= 0x80 (the flags and
   the segmented running OR) against numpy; config 14 with an 8,001-byte
   abab run across window edges (speculative windows) and a(bb)*c with a
   6,000-byte b-run (failed validation, summary + replay) against numpy;
   K30 over phase 5's log text as one file (W = 8 overlapped windows)
   against torch compares; then at 10 MB ends_bitmap and starts_bitmap
   against re and the plain versions on the CPU, finditer_long against re
   (lazy, greedy, and the cyclic route through the reversed program) and
   the torch-op LongScanner's fullmatch against re.fullmatch; every
   long-string kernel must have been launched;
10. (run before 7) the bitband path, with every launch count set to 0
   first: bench config 10 (x(ab|c){400,520}y, 1563 states, sparse) through
   ScanEngine.match_stats with its prefilter over 10 MB (bench.make_corpus's
   plant rule: the B / 4 bucket) and 1 GiB of 1024-byte records, and at 10
   MB with plants in 2% (under B / 16) and 60% of the records (past the
   bucket: the full-batch pass), each against re and (10 MB) against the
   unfiltered scan, with torch's sync debug mode set to raise on any host
   sync inside the call; finditer_batch lazy and longest against
   re.finditer, the anchored longest rescan from each first match start,
   ends_batch and starts_batch against the plain versions and re at 10 MB;
   then the 7 other programs of the tier at 10 MB through the Pattern API
   (search, fullmatch and spans against re, counts against the plain
   version); the counts are read after it;
7. times with CUDA events (the kernel's the median of 5-7 runs after
   warm-up, the plain version's one run) of kernel and plain version: the
   stats kernels at config 1 and 1 GiB, the SWAR span kernels at config
   7's 10 MB shape and at 1 GiB, the matmul-tier kernels
   (and rrx_nfa_flags) at 10 MB and 1 GiB (plain versions on a
   4,096-record slice there: phase 7's 1 GiB plain runs and comparisons
   take the first 4,096 records, the path phases' 16,384), the counting
   kernels on config 4 at 10 MB
   and 1 GiB, with registers, theoretical occupancy, grid fill and the bound
   of each (bytes over 3.35 TB/s, or integer operations over 16.7 T/s), each
   compared again with its plain version; ScanEngine.ends_bitmap end to end
   at 10 MB and one scan_xla.first_end_from call at the API's shape; the
   four multi-pattern kernels at 10 MB and 1 GiB with registers and
   occupancy of both bookkeeping variants, and the combined engine calls
   against P single-pattern calls on the same data; the four long-string
   kernels at 1 GiB in the geometry of their path (plain versions on 1
   MiB), and each long config's count_ends end to end at 1 GiB; the five
   bitband kernels on config 10 at 10 MB and 1 GiB with every record
   scanned (plain versions on the 10 MB batch and on 4,096 records of the
   1 GiB one), with registers, spills, occupancy, scheduler cycles a
   record-step and the bound of PERF.md section 2 (rrx_bitband_stats,
   _flags and _reverse on the register steps beside _anchor_end and
   _spans on the shared-buffer step; the reverse's bound from
   reverse_busy's census of the steps that run its band step), and config
   10's match_stats end
   to end split into the prefilter scan, the kernel on the compacted
   bucket (its cycles and grid fill), the full-batch pass and the glue;
   rrx_bitband_reverse on the bucket, on 10 MB whose every step runs the
   band step and 10 MB whose every step skips it, and config 10's
   ScanEngine.ends_bitmap, starts_bitmap and Pattern.finditer_batch end to
   end at 10 MB;
   the three container kernels on K120 at 10 MB and 1 GiB with every record
   scanned (plain versions on the 10 MB batch and on 4,096 records of the
   1 GiB one), registers, occupancy and the bound of PERF.md section 2 from
   a census of the run's data (the 1 GiB times with 3 runs), and four
   container shapes end to end at 10 MB, split into prefilter, kernel and
   glue (rrx_sparse_reverse on x(abc|de){1,300}y's bucket beside them; at 1
   GiB that bucket's reverse only against its plain version), K120's
   ScanEngine.starts_bitmap and Pattern.finditer_batch end to end at 10
   MB; the register steps of rrx_sparse_stats, _flags and _reverse on
   K120's 10 MB of log text, config 13's chain batch and x[ab]{0,400}c's
   chain records: the sweeps of walk_max (forward and reverse) that fixed
   ops/scan_sparse.WALK_MAX, then time, census bound, scheduler cycles a
   record-step, occupancy and registers beside the old step
   (rrx_sparse_stream_stats, _flags and _reverse on the same records' mask
   stream);
11. (run before 7) the container path, with every launch count set to 0
   first: K120 (K30's words and 90 more, 826 states) through
   ScanEngine.match_stats over phase 5's log text at 10 MB and 1 GiB
   against the plain version (10 MB; 16,384 records of 1 GiB) and re on
   3,000 records; MultiPattern of 40 keywords (40 accept channels)
   count_batch at 10 MB and its engine scan at 1 GiB, per-word counts
   against re; config 13's fullmatch_batch on its make_corpus shape (every
   fourth record cut to an abcde... chain) at 10 MB and fullmatch_flags at
   1 GiB against re and the chain count, and its greedy finditer_batch (host
   rounds) on 2,000 records against re; x(abc|de){1,300}y behind its
   prefilter with a plant in 12.5% of the records at 10 MB and 1 GiB against
   re, with torch's sync debug mode set to raise; K120's ends_batch,
   starts_batch and lazy finditer_batch on 2,000 records against re; every
   container kernel must have been launched;
12. (run before 7) the dense multiblock path, with every launch count set
   to 0 first: K60+ (60 keywords as a run, 412 states, s_tile 512, W = 16)
   over phase 5's log text and x(ab|c){300,}y (903 states, s_tile 1024, W
   = 32) over the same text with x(ab|c){295..340}y chains planted in 12.5%
   of the records, each at 10 MB and 1 GiB through ScanEngine.match_stats
   against re on 3,000 records and the plain version on 16,384 (10 MB: all
   of it); at 10 MB lazy and greedy spans against re.finditer on every
   record, the longest anchored rescan from each first start against the
   first greedy span, ends_bitmap and starts_bitmap against re on 3,000
   records; MultiPattern([K40+, cat|dog, [0-9]{3}]) count_batch and lazy
   finditer_batch (one combined scan on the wide multi-channel kernels) at
   10 MB against the single patterns and re on 3,000 records;
   Pattern.long(K60) on the wide window kernels (FastLongScanner):
   count_ends and search over phase 5's 1 GiB log text as one string
   against torch compares, its bitmaps and finditer_long at 10 MB against
   re; Pattern.long(x(ab|c){300,340}y) count_ends over the 1 GiB chain
   batch as one string against re; K60's unseeded fullmatch on the torch-op
   LongScanner against re; every wide kernel of the path must have been
   launched (rrx_long_wide_carry serves only the summary and speculative
   modes, which take narrow tiles: phase 2 holds it). Phase 7 then times
   the six wide record kernels on both programs at 10 MB and 1 GiB (plain
   versions once, on the 10 MB batch and on 4,096 records of the 1 GiB
   one, outputs compared there), with registers, occupancy, grid fill and
   the bound, and match_stats end to end; the reverse, the flags and the
   stats (the band step) also in the other split (the run fails if the
   default is the slower; the flags' and the stats' at 1 GiB; the
   reverse's other split timed at 10 MB only), the flags (at 10 MB) and
   the stats of K60+ also at 32 lanes a record, in scheduler cycles a
   record-step with their spills, beside rrx_stream_reverse,
   rrx_stream_flags and rrx_stream_stats (the Wide walk) on the same 10 MB
   records, and
   x(ab|c){300,}y's starts_bitmap and lazy finditer_batch and both
   programs' ends_bitmap end to end at 10 MB; the two wide multi-channel
   span kernels and the union's stats on the P = 3 union at 10 MB and 1
   GiB the same way, with cycles and spills, the reverse's other split,
   rrx_stream_stats on the same records and the union's lazy
   MultiPattern.finditer_batch end to end at 10 MB; and the
   four wide window kernels at 1 GiB in K60's overlapped geometry (plain
   versions on 1 MiB), with count_ends end to end for K60 and
   x(ab|c){300,340}y, FastLongScanner.flags end to end for both, and the
   band step's registers, spills (a band kernel that spills fails) and
   occupancy (its A/B timings are PERF.md's); the four stream
   kernels at 10 MB on cat|dog (W = 1), K30 (W = 8) and config 4 (W = 12,
   the rescans) and at 1 GiB on cat|dog
   (a 4 GiB stream), with the stream's bytes as their input in the bound,
   the stream's build time, occupancy and registers; match_stats end to end
   on the default route, the packed and the XLA backend at 10 MB; the three
   stream-fed container kernels over the mask streams of K120 (10 MB and
   128 MB, a 14 GiB stream, compared only) and config 13 (10 MB), the
   stream's build timed apart, the bound the larger of the stream's bytes and the
   container census, the byte kernel on the same records beside each; the
   slotted SWAR kernel on config 6 at 10 MB and 1 GiB beside the default
   route's rrx_word_stats[P] on the same data;
13. (run before 7) the packed and XLA backends, with every launch count set
   to 0 first: cat|dog (config 1's 10 MB) and K30 (10 MB of log text) with
   backend="packed": match_stats, ends_bitmap and starts_bitmap equal to the
   default route and re, finditer_batch in host rounds equal to it and re;
   config 4's finditer_batch (lazy and greedy) at 10 MB on the default route
   against re, its anchored rescans on rrx_stream_first_end, timed per host
   round; the C3 programs (abc|de){1,420} and x(abc|de){1,420}y on the XLA
   backend at 1 MB: count_batch, fullmatch_batch and lazy and greedy spans
   against re, timed; C2: Pattern.long of x(abc|de){1,300}y and config 10 on
   the torch-op LongScanner, count_ends of a 64 KiB string against re,
   timed; every stream kernel must have been launched;
14. (run before 7) the slotted SWAR and the stream-fed container methods,
   with every launch count set to 0 first: MultiPattern(config 6) with
   RRX_SWAR_MULTI=1 (SwarMultiScanner): count_batch over config 1's 10 MB
   against re and the u32-word tier's counts of phase 8, its engine scan of
   phase 8's 1 GiB batch against the u32-word tier's; SparseScanner's
   match_stats, forward_flags and reverse_hits over the mask stream of K120
   (10 MB of log text) and of config 13 (phase 11's chain batch), and
   BitbandScanner's over config 10's (phase 10's 10 MB batch; its container
   tables built at the first stream call), seeded and unseeded, against the
   byte path's methods on the same records; all four kernels must have
   been launched.

Prints the run's seconds, the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Needs torch built for CUDA, numpy and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

SWAR_PATTERNS = [
    "cat|dog", "(ab)*c+d?", "(cat|dog)*", "^ab?c$", "[a-c]x{0,2}$", "a*",
    "(a|b)(c|d)", "a\\.b", "[^a-c]", "a+b", "a.b", "...", "(a|.)c",
    "(a|$)*", "$?", "(a$)?", "(^|a)b*",
]
WORD_PATTERNS = [
    "(ab|cd)+e{2,3}fgh", "abcdefghij", "[a-f]{2,6}z", "(cat|dog|bird)+",
    "a{10,20}", "^[a-z]{3,8}[.]log$", "(ab)*c+d?", "x(yz|zy)*x$",
    "a*b*c*d*e*", "[^a]{1,3}|[ab]a{2}a?(a|bc)|0{2}(a|b)",
    ".[ab]x|q{2}[cd]y{2}z",
]
WORD_BENCH = "(cat|dog|bird)+"
# log-triage keyword alternations (no keyword is a prefix of another, so
# Python's re gives the lazy and the greedy spans alike)
K7_WORDS = ["error", "warning", "critical", "fatal", "exception", "timeout", "refused"]
K16_WORDS = ["error", "warn", "fail", "denied", "refused", "timeout", "exception", "fatal",
             "panic", "critical", "abort", "killed", "segfault", "overflow", "corrupt",
             "unreachable"]
K30_WORDS = K16_WORDS + ["invalid", "missing", "expired", "forbidden", "unauthorized",
                         "unavailable", "conflict", "deadlock", "retry", "dropped", "rejected",
                         "throttled", "oom", "leak"]
K7, K16, K30 = ("(" + "|".join(ws) + ")" for ws in (K7_WORDS, K16_WORDS, K30_WORDS))
HTTP = "^(GET|POST|PUT|DELETE|HEAD|OPTIONS|PATCH) /[a-z0-9/._-]* HTTP/1\\.[01]$"
# record tiles of 8 (nullable SWAR-size), 16 and 32 (u32-word-size), 64,
# 128 and 256 states for the matmul-tier kernels
NFA_PATTERNS = ["a*", "(cat|dog)*", "(a|$)*"] + WORD_PATTERNS + [
    K7, K7 + "*", HTTP, K16, "x(ab|c){20,40}y", K30, "(a|bc){1,60}"]
NFA_PLANTS = [b"error", b"warning timeout", b"x critical", b"GET /a/b.c HTTP/1.1",
              b"POST / HTTP/1.0", b"xababccababcy", b"xabababababcccccccccababababcccy",
              b"abcbcbca", b"cat", b"dogcat", b"aaaaaaaaaaaa", b"abcdcdeeefgh", b"oomleakretry",
              b"segfaulterror", b"abcdefghij"]
STATS_SOURCE = "roaringregex_tpu_torch/csrc/scan_bits.cu"
SPANS_SOURCE = "roaringregex_tpu_torch/csrc/scan_spans.cu"
NFA_SOURCE = "roaringregex_tpu_torch/csrc/scan_nfa.cu"
COUNT_SOURCE = "roaringregex_tpu_torch/csrc/scan_count.cu"
REPLACES = {
    "rrx_swar_stats": "roaringregex_tpu/ops/scan_swar.py:526",
    "rrx_word_stats": "roaringregex_tpu/ops/scan_word.py:169",
    "rrx_swar_reverse": "roaringregex_tpu/ops/scan_swar.py:627",
    "rrx_swar_lazy_spans": "roaringregex_tpu/ops/scan_swar.py:710",
    "rrx_swar_anchor_end": "roaringregex_tpu/ops/scan_swar.py:807",
    "rrx_swar_greedy_spans": "roaringregex_tpu/ops/scan_swar.py:1385",
    "rrx_nfa_stats": "roaringregex_tpu/ops/scan_pallas.py:1218",
    "rrx_nfa_reverse": "roaringregex_tpu/ops/scan_pallas.py:1532",
    "rrx_nfa_anchor_end": "roaringregex_tpu/ops/scan_pallas.py:1659",
    "rrx_nfa_lazy_spans": "roaringregex_tpu/ops/scan_pallas.py:1740",
    "rrx_nfa_greedy_spans": "roaringregex_tpu/ops/scan_pallas.py:3038",
    "rrx_nfa_flags": "roaringregex_tpu/ops/scan_pallas.py:1393",
    "rrx_count_stats": "roaringregex_tpu/ops/scan_pallas.py:4098",
    "rrx_count_flags": "roaringregex_tpu/ops/scan_pallas.py:4274",
    "rrx_count_reverse": "roaringregex_tpu/ops/scan_pallas.py:4362",
    "rrx_word_stats[P]": "roaringregex_tpu/ops/scan_word.py:169",
    "rrx_nfa_stats[P]": "roaringregex_tpu/ops/scan_pallas.py:1218",
    "rrx_nfa_reverse_mb": "roaringregex_tpu/ops/scan_pallas.py:1827",
    "rrx_nfa_lazy_spans_mb": "roaringregex_tpu/ops/scan_pallas.py:1889",
}
LONG_SOURCE = "roaringregex_tpu_torch/csrc/scan_long.cu"
REPLACES |= {
    "rrx_long_carry": "roaringregex_tpu/ops/scan_pallas.py:3343",
    "rrx_long_flags": "roaringregex_tpu/ops/scan_pallas.py:3416",
    # with a final-state pointer also _count_v0_final_kernel_lb (:3650)
    "rrx_long_count": "roaringregex_tpu/ops/scan_pallas.py:3550",
    "rrx_long_reverse": "roaringregex_tpu/ops/scan_pallas.py:3488",
}
LONG_KERNELS = ("rrx_long_carry", "rrx_long_flags", "rrx_long_count", "rrx_long_reverse")
BITBAND_SOURCE = "roaringregex_tpu_torch/csrc/scan_bitband.cu"
REPLACES |= {
    "rrx_bitband_stats": "roaringregex_tpu/ops/scan_bitband.py:605",
    "rrx_bitband_flags": "roaringregex_tpu/ops/scan_bitband.py:692",
    "rrx_bitband_reverse": "roaringregex_tpu/ops/scan_bitband.py:806",
    "rrx_bitband_anchor_end": "roaringregex_tpu/ops/scan_bitband.py:741",
    # _bb_spans_call's rounds (:1156): _bb_reverse_pl (:1213) and the
    # anchored rescans of _bitband_anchor_kernel_b
    "rrx_bitband_spans": "roaringregex_tpu/ops/scan_bitband.py:1213",
}
BITBAND_KERNELS = ("rrx_bitband_stats", "rrx_bitband_flags", "rrx_bitband_reverse",
                   "rrx_bitband_anchor_end", "rrx_bitband_spans")
# bench config 10 (bench.py:315) and its plant, and the other programs of
# the bitband tier: multiblock chains (one rank-1 column, gaps (-1, 4, 5),
# BOS and EOS rows, the accept OR-fold, a band of one byte) and an
# unbounded sparse one
CONFIG10 = "x(ab|c){400,520}y"
PLANT10 = b"x" + b"ab" * 200 + b"c" * 210 + b"y"
BITBAND_MB = ["x{2,300}y", "(ab|c){100,130}", "x(ab|c){100,200}(y|z+)", "(a(ab|c){100,200}b)+",
              "^x(ab|c){100,200}y$", "x(ab|c){100,200}", "x(ab|c){400,}y"]
BITBAND_PATTERNS = [CONFIG10] + BITBAND_MB
SPARSE_SOURCE = "roaringregex_tpu_torch/csrc/scan_sparse.cu"
REPLACES |= {
    "rrx_sparse_stats": "roaringregex_tpu/ops/scan_pallas.py:1984",
    "rrx_sparse_flags": "roaringregex_tpu/ops/scan_pallas.py:2083",
    "rrx_sparse_reverse": "roaringregex_tpu/ops/scan_pallas.py:2141",
}
SPARSE_KERNELS = ("rrx_sparse_stats", "rrx_sparse_flags", "rrx_sparse_reverse")
NFA_WIDE_SOURCE = "roaringregex_tpu_torch/csrc/scan_nfa_wide.cu"
# the matmul-tier kernels at record tiles of 257..1024 states (one warp per
# record), in rrx_nfa_wide_occupancy's order
WIDE_KERNELS = ("rrx_nfa_wide_stats", "rrx_nfa_wide_reverse", "rrx_nfa_wide_anchor_end",
                "rrx_nfa_wide_lazy_spans", "rrx_nfa_wide_greedy_spans", "rrx_nfa_wide_flags")
REPLACES |= {
    "rrx_nfa_wide_stats": "roaringregex_tpu/ops/scan_pallas.py:1218",
    "rrx_nfa_wide_reverse": "roaringregex_tpu/ops/scan_pallas.py:1532",
    "rrx_nfa_wide_anchor_end": "roaringregex_tpu/ops/scan_pallas.py:1659",
    "rrx_nfa_wide_lazy_spans": "roaringregex_tpu/ops/scan_pallas.py:1740",
    "rrx_nfa_wide_greedy_spans": "roaringregex_tpu/ops/scan_pallas.py:3038",
    "rrx_nfa_wide_flags": "roaringregex_tpu/ops/scan_pallas.py:1393",
}
# the multi-channel span kernels (scan_nfa_wide.cu) and the long-string
# window kernels (scan_long_wide.cu, one warp per window) at tiles of
# 257..1024 states
LONG_WIDE_SOURCE = "roaringregex_tpu_torch/csrc/scan_long_wide.cu"
WIDE_MB_KERNELS = ("rrx_nfa_wide_reverse_mb", "rrx_nfa_wide_lazy_spans_mb")
LONG_WIDE_KERNELS = ("rrx_long_wide_carry", "rrx_long_wide_flags", "rrx_long_wide_count",
                     "rrx_long_wide_reverse")
REPLACES |= {
    "rrx_nfa_wide_reverse_mb": "roaringregex_tpu/ops/scan_pallas.py:1827",
    "rrx_nfa_wide_lazy_spans_mb": "roaringregex_tpu/ops/scan_pallas.py:1889",
    "rrx_long_wide_carry": "roaringregex_tpu/ops/scan_pallas.py:3343",
    "rrx_long_wide_flags": "roaringregex_tpu/ops/scan_pallas.py:3416",
    # with a final-state pointer also _count_v0_final_kernel_lb (:3650)
    "rrx_long_wide_count": "roaringregex_tpu/ops/scan_pallas.py:3550",
    "rrx_long_wide_reverse": "roaringregex_tpu/ops/scan_pallas.py:3488",
}
# the stream-fed kernels (scan_stream.cu): the packed backend's primitives
# and the counting tier's anchored rescans over a mask stream, one thread per
# record up to 256 states and one warp per record past them
STREAM_SOURCE = "roaringregex_tpu_torch/csrc/scan_stream.cu"
STREAM_KERNELS = ("rrx_stream_stats", "rrx_stream_flags", "rrx_stream_reverse",
                  "rrx_stream_first_end")
REPLACES |= {
    "rrx_stream_stats": "roaringregex_tpu/ops/scan_pallas.py:75",
    "rrx_stream_flags": "roaringregex_tpu/ops/scan_pallas.py:153",
    "rrx_stream_reverse": "roaringregex_tpu/ops/scan_pallas.py:199",
    "rrx_stream_first_end": "roaringregex_tpu/ops/scan_pallas.py:981",
}
# the slotted multi-pattern SWAR scan (scan_bits.cu, RRX_SWAR_MULTI=1) and
# the stream-fed container kernels (scan_sparse.cu: the mask-stream methods
# of SparseScanner and BitbandScanner)
SWAR_MULTI_KERNELS = ("rrx_swar_multi_stats",)
SPARSE_STREAM_KERNELS = ("rrx_sparse_stream_stats", "rrx_sparse_stream_flags",
                         "rrx_sparse_stream_reverse")
REPLACES |= {
    # _run_swar_multi (:1493) launches _swar_multi_kernel (:428)
    "rrx_swar_multi_stats": "roaringregex_tpu/ops/scan_swar.py:1500",
    "rrx_sparse_stream_stats": "roaringregex_tpu/ops/scan_pallas.py:867",
    "rrx_sparse_stream_flags": "roaringregex_tpu/ops/scan_pallas.py:916",
    "rrx_sparse_stream_reverse": "roaringregex_tpu/ops/scan_pallas.py:955",
}
# container programs past the container kernels' caps (153 partial blocks,
# 2,176 lanes): the XLA backend's route, as in the JAX engine
C3_PATTERNS = ["(abc|de){1,420}", "x(abc|de){1,420}y"]


def keywords(n: int):
    """K30's words and n - 30 more from numpy seed 8 (lowercase, 5-9
    letters, none a prefix of another, so Python's re gives the lazy and
    the greedy spans alike)."""
    import numpy as np

    rng = np.random.default_rng(8)
    words = list(K30_WORDS)
    while len(words) < n:
        w = bytes(rng.integers(97, 123, size=int(rng.integers(5, 10))).astype(np.uint8)).decode()
        if not any(a.startswith(w) or w.startswith(a) for a in words):
            words.append(w)
    return words


# keyword log triage past ~35 words: K120 (826 states, multiblock) routes to
# the container tier
K120_WORDS = keywords(120)
K120 = "(" + "|".join(K120_WORDS) + ")"
CONFIG13_X = "x(abc|de){1,300}y"  # config 13 behind context: the prefilter's route
# the dense multiblock tier (the matmul tier at record tiles of 384..1024
# states, W = 12..32 state words): keyword runs (K+, whose follow matrix is
# dense), banded repetition chains, a nullable K40*; one program at each W
K40P, K60P, K80P, K120P, K130P = ("(" + "|".join(keywords(n)) + ")+"
                                  for n in (40, 60, 80, 120, 130))
CHAIN300 = "x(ab|c){300,}y"
WIDE_PATTERNS = [K40P, "x(ab|c){120,}y", K40P[:-1] + "*", K60P, K80P, "(a|bc)*d(ab|c){200,}e",
                 "x(ab|c){250,}y", K120P, K130P, CHAIN300]
WIDE_MP = [K40P, "cat|dog", "[0-9]{3}"]  # a dense multiblock union, P = 3
WIDE_MP_C1 = [K40P, "cat$", "[0-9]?$"]  # `$` channels: a span at EOS, then (len, len)
# one long string of a dense program of 257..1024 states with a horizon: the
# window kernels of scan_long_wide.cu, W = 16, 12, 28 and 32
K60 = "(" + "|".join(keywords(60)) + ")"
CHAIN340 = "x(ab|c){300,340}y"
LONG_WIDE_PATTERNS = [K60, "[a-z]{300}x", K120, CHAIN340]
PLANT13X = b"x" + b"abcde" * 100 + b"y"
# the container programs of the probe table: two multiblock programs,
# config 13 and its x...y form (78 partial blocks), (abc|de){1,360} at the
# 120-block cap (its table does not fit a block's shared memory: the global
# form), x[ab]{0,400}c and config 10 with RRX_BITBAND=0 (the first with a
# full U block), a nullable program and K120
SPARSE_PATTERNS = ["(ab|c){2,120}d", "a*b{1,300}", CONFIG13_X, "(abc|de){1,300}",
                   "(abc|de){1,360}", "x[ab]{0,400}c", "x(ab|c){400,520}y",
                   "(a|b)*c{0,2}(abc){0,100}", K120]
# programs past the engine's container caps that the container kernels
# still take (3 and 4 state words a lane of the forward step; global form)
SPARSE_WIDE = ["(abc|de){1,420}", "(abc|de){1,800}"]
# chain records with dense blocks of live states for the forward step's
# times, and the walk_max values of its sweep
XAB = "x[ab]{0,400}c"
WALK_SWEEP = (-1, 0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 128)
CLOCK_GHZ = 1.98  # the H100 SXM's boost clock
# MultiPattern sets on the container tier: 2 channels (config 10 and cat|dog,
# with RRX_BITBAND=0), 40 and 100 keywords
SPARSE_SETS = [["x(ab|c){400,520}y", "cat|dog"], keywords(40), keywords(100)]
# one-long-string configs (bench.py:298-346) and a speculative case that
# fails validation ((ab)*c never does: its seeded state set depends on one
# byte)
CONFIG8, CONFIG9, CONFIG12, CONFIG14, SPEC_FAIL = (
    "cat|dog", "a{1,300}", ".*(cat|dog).*", "(ab)*c", "a(bb)*c")
# programs for the long kernels against their plain versions: W = 1, 2 and 8,
# anchors at the string's edges, cyclic (summary basis) programs
LONG_PATTERNS = ["cat|dog", "(ab)*c", "^ab", "ab$", SPEC_FAIL, K7, K30]
# lazy spans that end at EOS and then the empty match at len (C1), on the
# SWAR tier, the matmul tier and as MultiPattern channels, against re
C1_SWAR = ("a?$", "b*$", "(ab)?$")
C1_NFA = "[a-c]{0,40}$"
C1_MP = ["a?$", "b*$", "cat"]
SPAN_KERNELS = ("rrx_swar_reverse", "rrx_swar_lazy_spans", "rrx_swar_anchor_end",
                "rrx_swar_greedy_spans")
NFA_KERNELS = ("rrx_nfa_stats", "rrx_nfa_reverse", "rrx_nfa_anchor_end", "rrx_nfa_lazy_spans",
               "rrx_nfa_greedy_spans")
COUNT_KERNELS = ("rrx_count_stats", "rrx_count_flags", "rrx_count_reverse")
# the multi-pattern path's kernels: the P-channel forms of the u32-word and
# matmul stats kernels (counted apart from their one-channel forms) and the
# multi-channel reverse and lazy-span kernels
MP_KERNELS = ("rrx_word_stats[P]", "rrx_nfa_stats[P]", "rrx_nfa_reverse_mb",
              "rrx_nfa_lazy_spans_mb")
CONFIG6 = ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"]
# Python re forms of config 6's lazy spans: err(or)? ends at the shortest end
CONFIG6_LAZY_RE = ["cat|dog", "[0-9]{3}", "err(or)??", "ab(cd)*e"]
# config 6's match ends by Python re, per pattern: lookaheads whose group
# ends at every end (err(or)? ends after err and after error)
CONFIG6_ENDS_RE = [[rb"(?=(cat|dog))"], [rb"(?=([0-9]{3}))"], [rb"(?=(err))", rb"(?=(error))"],
                   [rb"(?=(ab(?:cd)*e))"]]
# sets for the slotted SWAR kernel against its plain version: config 6 (and
# tests/test_multipattern.py's first slotted set), its second (a nullable and
# a `$` channel), and sets of 1, 2 and 3 patterns with ^, $ and nullable
# members
SWAR_MULTI_SETS = [CONFIG6, ["a*", "x$"], ["(ab)*c+d?"], ["^ab?c$", "(a|$)*"],
                   ["[a-c]x{0,2}$", "(cat|dog)*", "^x"]]
# pattern sets for kernel == plain: tests/test_multipattern.py's four, config
# 6, K7 as 7 patterns, K16 as 16 (matmul tier, P >= 16), 12 one-letter
# patterns (u32-word tier, P > 8), and nullable and `$` channels
MP_SETS = [
    ["cat", "dog", "bird"], ["cat|dog", "[0-9]+", "(ab)*c"], ["a*", "err(or)?", "^x"],
    ["[a-f]{3}", "z", "foo$"], CONFIG6, K7_WORDS, K16_WORDS, list("abcdefghijkl"),
    ["a*", "x$", "^ab", "(cd)+$", "e?"],
]
MP_PLANTS = [b"cat", b"dog", b"error", b"err", b"123", b"4567", b"abe", b"abcdcde", b"xfoo",
             b"ababc", b"cdcd", b"warning timeout", b"panic abort", b"xab", b"bird"]
# counting plans for kernel == plain: body lengths k = 1..8, 1..4 branches,
# nullable (m = 0), exact a{300}, unbounded a{270,}
COUNT_PATTERNS = [
    "a{1,300}", "a{3,280}", "[a-c]{2,400}", "a{270,}", "x{0,300}", "a{300}", "(ab|cd){1,400}",
    "(ab|cx){2,280}", "(abc|xbc|bca){1,200}", "(ab){0,40}", "(abcd){1,60}", "(abcde){2,30}",
    "(abcdef|bcdefa){1,20}", "(abcdefg){1,9}", "(abcdefgh|bbbbbbbb|aaaaaaaa|cccccccc){1,5}",
    "(ab){40}",
]
CONFIG4, CONFIG13 = "a{1,300}", "(abc|de){1,300}"
# the stream-fed container kernels against their plain versions: K120,
# config 13, a nullable program, a full U block and the 120-block cap (the
# global table form); config 10 through BitbandScanner's container tables
SPARSE_STREAM_PATTERNS = [K120, CONFIG13, "(a|b)*c{0,2}(abc){0,100}", "x[ab]{0,400}c",
                          "(abc|de){1,360}", CONFIG10]
# programs for the stream-fed kernels against their plain versions: W = 1
# (nullable and anchored ones too), 2, 4, 8, 12, 16 and 32, and P = 3
# accept channels at W = 1 and 12
STREAM_PATTERNS = ["cat|dog", "a?(cat|dog)*", "^ab?c$", K7, "x(ab|c){20,40}y", K30, CONFIG4,
                   K60P, CHAIN300]
STREAM_SETS = [["cat", "dog", "a{2,5}"], WIDE_MP]
# counting tier step floor: class-table load, the progress shift-OR-AND,
# the body-end test and clear, the run's add, min and select
COUNT_STEP_OPS = 8
# the card's rates for the bounds: HBM 3.35 TB/s (NVIDIA's H100 SXM data
# sheet); 32-bit integer issue 16.7 T operations/s = 132 SMs x 64 int32
# operations per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 1.98 GHz, the clock at which the
# data sheet's 67 TFLOP/s float32 peak is 132 x 128 FMA lanes x 2 flops
HBM_BYTES_PER_MS = 3.35e9
INT_OPS_PER_MS = 132 * 64 * 1.98e6
# patterns whose Python-re greedy match is the POSIX leftmost-longest one
# (tests/test_greedy.py), with their lazy-quantifier forms: re's match of
# the lazy form from the leftmost start is the shortest one
RE_SAFE = {
    "a+": "a+?", "(ab)+": "(ab)+?", "a{2,6}": "a{2,6}?", "[a-c]+": "[a-c]+?",
    "ab*c?": "ab*?c??", "x[0-9]*": "x[0-9]*?",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def edge_batch(rng, np, R: int, L: int, alphabet: bytes):
    """Random records over ``alphabet`` plus the edge records."""
    a = np.frombuffer(alphabet, np.uint8)
    data = rng.choice(a, size=(R, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[0] = 0  # empty
    lengths[1:4] = L  # len == L: the EOS step is the stream's last
    data[4, :4] = [ord("a"), 0xFE, ord("b"), 0x80]  # bytes >= 0x80
    data[5, :3] = [ord("a"), 0x00, ord("b")]  # byte 0 inside the record
    data[6, :] = 0  # all zero bytes
    data[7, :] = 0xFF
    lengths[4:8] = np.array([4, 3, L, L], np.int32)
    return data, lengths


def nfa_batch(rng, np, R: int, L: int):
    """An edge batch over the keyword and HTTP alphabet, with a plant
    (keywords, request lines, repetitions) in every third record."""
    data, lengths = edge_batch(rng, np, R, L, b"abcdefghijlogqtxyzrwnu.$ /GETHP1\x00")
    for i in range(8, R, 3):
        w = NFA_PLANTS[int(rng.integers(len(NFA_PLANTS)))][:L]
        at = int(rng.integers(0, L - len(w) + 1))
        data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    return data, lengths


def log_text(np, seed: int, R: int, L: int, words):
    """[R, L] uint8 lowercase log text (letters, one space in 7 bytes) from
    a numpy seed, with one keyword planted in every second record."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz" + b" " * 4, np.uint8)
    data = alphabet[rng.integers(0, alphabet.size, size=(R, L), dtype=np.uint8)]
    rows = rng.permutation(R)[: R // 2]
    kw = rng.integers(0, len(words), size=rows.size)
    for k, word in enumerate(words):
        rk = rows[kw == k]
        cols = rng.integers(0, L - len(word) + 1, size=rk.size)
        for j, ch in enumerate(word.encode()):
            data[rk, cols + j] = ch
    return data


# diagonals planted in the hand-built tiles of the band step's comparisons
BAND_PLANTED = (-70, -33, -1, 0, 1, 31, 32, 64)


def band_planted(S: int, residual: bool, rng, dev, dead: bool = True):
    """A hand-built tile of S states for the band step: each diagonal of
    BAND_PLANTED with 60% of its edges, random residual edges (or the seed
    row alone), random mask rows (bytes >= 0x80 zero, and the dead step's
    unless ``dead``: the record reverse needs it zero), a random accept
    row; its tables with the diagonals kept whatever the residual."""
    import numpy as np
    import torch

    from roaringregex_tpu_torch.ops import scan_pallas as P_

    W = -(-S // 32)
    F = np.zeros((S, S), bool)
    for d in BAND_PLANTED:
        src = np.arange(max(0, -d), min(S, S - d))
        keep = src[rng.random(src.size) < 0.6]
        F[keep, keep + d] = True
    if residual:
        F |= rng.random((S, S)) < 0.004
    else:
        F[0] = rng.random(S) < 0.2
    mbits = rng.random((P_.N_SYMS, S)) < 0.7
    mbits[0x80:256] = False
    if not dead:  # the dead step's row is zero, as nfa_tables builds it
        mbits[P_.sb.SYM_DEAD] = False
    acc = P_._pack_rows((rng.random(S) < 0.05)[None, :], W)
    tab = np.concatenate([P_._pack_rows(F, W), P_._pack_rows(F.T, W), P_._pack_rows(mbits, W),
                          acc])
    tables = P_.NfaTables(torch.from_numpy(tab.reshape(-1).view(np.int32).copy()).to(dev), S)
    return P_.with_band(tables, P_.BANDED_MAX_DIAGS, rows=tab)


# hand-built bitband tables for the register step of rrx_bitband_stats whose
# top lane holds state words (W = 32 NW): diagonals of both signs, near and
# past 32 NW states, rank-1 columns (as state indices), triangle gaps of both
# signs on the window [8, W)
BB_PLANTED = {32: ((-70, -33, -1, 0, 1, 31, 32, 64, 100), (5, 1000), (-3, 5, 40)),
              96: ((-200, -97, -1, 0, 1, 5, 31, 33, 64, 95, 96, 97, 300), (6, 3000), (-20, 3, 33)),
              128: ((-300, -129, -1, 1, 127, 128, 129, 500), (7, 4000), (-40, 2, 5))}
BB_PLANTED_ALPHABET = b"abcdef0123456789xyzq"


def bitband_planted(W: int, rng, dev):
    """Random bitband tables of W words under BB_PLANTED[W]: mask rows at
    half density, rank-1 rows at 5%, the exit and family rows at 30% and
    zero outside the triangle's window (as the tier's tables are), one
    accept row at 5%; byte runs 0-9, a-f and x-z."""
    import numpy as np
    import torch

    from roaringregex_tpu_torch.ops import scan_bitband as BB

    diags, cols, gaps = BB_PLANTED[W]
    runs = ((48, 57), (97, 102), (120, 122))
    spec = BB.BitbandSpec(W=W, diags=diags, rank1=tuple((c // 32, c % 32) for c in cols),
                          tri_gaps=gaps, tri_win=(8, W), runs=runs, bos_nz=True, eos_nz=True)

    def rows(n, dens, window=False):
        bits = (rng.random((n, W, 32)) < dens).astype(np.uint64)
        r = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2, dtype=np.uint64)
        if window:
            r[:, :8] = 0
        return r.astype(np.uint32)

    tab = np.concatenate([rows(3 + len(runs), 0.5), rows(len(diags), 0.5), rows(len(cols), 0.05),
                          rows(1 + len(gaps), 0.3, True), rows(2, 0.05)])
    t = torch.from_numpy(tab.reshape(-1).view(np.int32).copy()).to(dev)

    class Named:
        pattern = f"hand-built W = {W}"

    meta = torch.from_numpy(BB.bitband_meta(spec, Named, 1)).to(dev)
    return BB.with_e_rows(BB.BitbandTables(t, t.clone(), meta, spec, 1, None, None))


def reverse_busy(tables, d, ln) -> tuple:
    """(busy, steps) of rrx_bitband_reverse's register step over records d
    [R, L] with lengths ln: of the record-steps from each record's step len
    + 1 down to 0, those whose u = R & mask[sym] is non-empty, which run the
    band step (the others skip to the symbol's E row), by the plain stepper
    on d's device. The bound of PERF.md section 2 counts the reverse's
    operations on the busy steps only."""
    import torch

    from roaringregex_tpu_torch.ops import scan_bits

    pt = tables.plain(d.device)
    R, L = d.shape
    lnv = ln.to(torch.int64).clamp(0, L)
    r = pt.empty(R, d.device)
    busy = torch.zeros((), dtype=torch.int64, device=d.device)
    for t in range(L + 1, -1, -1):
        sym = scan_bits._sym(d, lnv, t)
        busy += (((r & pt.mask(sym)) != 0).any(dim=1) & (t <= lnv + 1)).sum()
        r = pt.rev(r, sym)
    return int(busy.item()), int((lnv + 2).sum().item())


def key_stats(words, text: bytes):
    """(count of distinct match ends, first end or -1) of an alternation of
    ``words``, none a prefix of another, by Python's re: at most one word
    starts at each position."""
    rx = re.compile(b"(?=(" + b"|".join(w.encode() for w in words) + b"))")
    ends = sorted({m.start() + len(m.group(1)) for m in rx.finditer(text)})
    return len(ends), ends[0] if ends else -1


def registers(ptxas: str):
    """{mangled kernel name: registers} from nvcc's -Xptxas -v report."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
    return out


def spills(ptxas: str):
    """{mangled kernel name: spill store + load bytes} from nvcc's -Xptxas -v
    report."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = int(m.group(1)) + int(m.group(2))
    return out


def bound(read: float, written: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes that must move over
    the card's memory rate and the integer operations over its issue rate."""
    b, o = (read + written) / HBM_BYTES_PER_MS, ops / INT_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


def state_words(prog) -> int:
    """The 32-bit words of a program's own states: what one step of its
    state set must touch (a record tile's padding words are always zero)."""
    return -(-prog.n_states // 32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    import numpy as np

    from roaringregex_tpu_torch.api import MultiPattern, Pattern
    from roaringregex_tpu_torch.api import compile as rrx_compile
    from roaringregex_tpu_torch.compiler.program import compile_program
    from roaringregex_tpu_torch.engine import ScanEngine
    from roaringregex_tpu_torch.ops import (_build, scan_bitband, scan_bits, scan_packed,
                                            scan_pallas, scan_sparse, scan_swar, scan_word,
                                            scan_xla)
    from roaringregex_tpu_torch.utils.config import get_config, set_config

    dev = torch.device("cuda:0")
    card = card_line()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, {n_sm} SMs)")

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {_build.BUILD.path} ({'nvcc ' + ' '.join(_build.ARCH_FLAGS)}; "
          f"built={_build.BUILD.built}, nvcc {_build.BUILD.seconds:.1f}s, total {build_s:.1f}s)")
    for line in _build.BUILD.ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    regs = registers(_build.BUILD.ptxas)
    spilled = spills(_build.BUILD.ptxas)

    def regs_of(kernel: str) -> str:
        """Registers of every instantiation of ``kernel`` (by mangled name)."""
        got = sorted(f"{n}: {r}" for n, r in regs.items() if re.search(r"\d" + kernel, n))
        return "; ".join(got) if got else "not reported (library built before this run)"

    entries = {
        "rrx_swar_stats": (scan_swar.swar_stats, scan_swar.swar_spec, scan_swar.swar_tables, SWAR_PATTERNS),
        "rrx_word_stats": (scan_word.word_stats, scan_word.word_spec, scan_word.word_tables, WORD_PATTERNS),
    }
    span_wrappers = {
        "rrx_swar_reverse": scan_swar.swar_reverse,
        "rrx_swar_lazy_spans": scan_swar.swar_lazy_spans,
        "rrx_swar_anchor_end": scan_swar.swar_anchor_end,
        "rrx_swar_greedy_spans": scan_swar.swar_greedy_spans,
    }
    nfa_wrappers = {
        "rrx_nfa_stats": scan_pallas.nfa_stats,
        "rrx_nfa_reverse": scan_pallas.nfa_reverse,
        "rrx_nfa_anchor_end": scan_pallas.nfa_anchor_end,
        "rrx_nfa_lazy_spans": scan_pallas.nfa_lazy_spans,
        "rrx_nfa_greedy_spans": scan_pallas.nfa_greedy_spans,
        "rrx_nfa_flags": scan_pallas.nfa_flags,
    }
    count_wrappers = {
        "rrx_count_stats": scan_pallas.count_stats,
        "rrx_count_flags": scan_pallas.count_flags,
        "rrx_count_reverse": scan_pallas.count_reverse,
    }
    class Count:
        """One of a wrapper's launch counts: ``attr`` counts the P-channel
        kernel of a stats wrapper (channel_launches) or a matmul-tier,
        multi-channel or long-string wrapper's kernel for tiles past 256
        states (wide_launches)."""

        def __init__(self, wrapper, attr):
            self.wrapper, self.attr = wrapper, attr

        @property
        def launches(self):
            return getattr(self.wrapper, self.attr)

        @launches.setter
        def launches(self, n):
            setattr(self.wrapper, self.attr, n)

    mp_wrappers = {
        "rrx_word_stats[P]": Count(scan_word.word_stats, "channel_launches"),
        "rrx_nfa_stats[P]": Count(scan_pallas.nfa_stats, "channel_launches"),
        "rrx_nfa_reverse_mb": scan_pallas.nfa_reverse_mb,
        "rrx_nfa_lazy_spans_mb": scan_pallas.nfa_lazy_spans_mb,
    }
    long_wrappers = {
        "rrx_long_carry": scan_pallas.long_carry,
        "rrx_long_flags": scan_pallas.long_flags,
        "rrx_long_count": scan_pallas.long_count,
        "rrx_long_reverse": scan_pallas.long_reverse,
    }
    bitband_wrappers = {
        "rrx_bitband_stats": scan_bitband.bitband_stats,
        "rrx_bitband_flags": scan_bitband.bitband_flags,
        "rrx_bitband_reverse": scan_bitband.bitband_reverse,
        "rrx_bitband_anchor_end": scan_bitband.bitband_anchor_end,
        "rrx_bitband_spans": scan_bitband.bitband_spans,
    }
    sparse_wrappers = {
        "rrx_sparse_stats": scan_sparse.sparse_stats,
        "rrx_sparse_flags": scan_sparse.sparse_flags,
        "rrx_sparse_reverse": scan_sparse.sparse_reverse,
    }
    wide_wrappers = {name: Count(nfa_wrappers[name.replace("_wide", "")], "wide_launches")
                     for name in WIDE_KERNELS}
    wide_mb_wrappers = {name: Count(mp_wrappers[name.replace("_wide", "")], "wide_launches")
                        for name in WIDE_MB_KERNELS}
    long_wide_wrappers = {name: Count(long_wrappers[name.replace("_wide", "")], "wide_launches")
                          for name in LONG_WIDE_KERNELS}
    stream_wrappers = {
        "rrx_stream_stats": scan_packed.match_stats,
        "rrx_stream_flags": scan_packed.forward_flags,
        "rrx_stream_reverse": scan_packed.reverse_hits,
        "rrx_stream_first_end": scan_packed.first_end_from,
    }
    new_wrappers = {
        "rrx_swar_multi_stats": scan_swar.swar_multi_stats,
        "rrx_sparse_stream_stats": scan_sparse.sparse_stream_stats,
        "rrx_sparse_stream_flags": scan_sparse.sparse_stream_flags,
        "rrx_sparse_stream_reverse": scan_sparse.sparse_stream_reverse,
    }
    wrappers = ({name: e[0] for name, e in entries.items()} | span_wrappers | nfa_wrappers
                | count_wrappers | mp_wrappers | long_wrappers | bitband_wrappers | sparse_wrappers
                | wide_wrappers | wide_mb_wrappers | long_wide_wrappers | stream_wrappers
                | new_wrappers)
    base_cfg = get_config()
    max_err = {name: 0 for name in wrappers}

    def compare(name, got, want, tag, labels=("cnt", "first", "last", "full")):
        for label, x, y in zip(labels, got, want, strict=True):
            if x.shape != y.shape:
                fail(f"{name} {tag} {label}: shape {tuple(x.shape)} != plain {tuple(y.shape)}")
            x64, y64 = x.to(torch.int64), y.to(torch.int64)
            err = int((x64 - y64).abs().max().item()) if x.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err != 0:
                bad = torch.nonzero(x64 != y64)[:5].tolist()
                fail(f"{name} {tag} {label}: kernel != plain at {bad}")

    def launches():
        return {name: w.launches for name, w in wrappers.items()}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    # -- phase 2: kernel against plain on the card ------------------------
    rng = np.random.default_rng(0)
    n_cmp = 0
    t0 = time.perf_counter()
    for name, (wrapper, spec_fn, tables_fn, patterns) in entries.items():
        before = wrapper.launches
        for pattern in patterns:
            prog = compile_program(pattern)
            spec = spec_fn(prog)
            if spec is None:
                fail(f"{pattern!r} does not fit {name}")
            tables = scan_bits.device_tables(*tables_fn(spec), dev)
            h = prog.horizon or 3
            for R, L in ((1000, 61), (1024, 64)):
                data, lengths = edge_batch(rng, np, R, L, b"abcdefghijlogqtxyz.\x00")
                d = torch.from_numpy(data).to(dev)
                ln = torch.from_numpy(lengths).to(dev)
                for seeded in (True, False):
                    for lead in (0, h):
                        kw = dict(seeded=seeded, lead=lead, nullable=prog.nullable)
                        got = wrapper(d, ln, tables, **kw)
                        want = scan_bits.stats_plain(d, ln, tables, **kw)
                        compare(name, got, want, f"{pattern!r} R={R} L={L} {kw}")
                        n_cmp += 1
        if wrapper.launches <= before:
            fail(f"{name}: launch count did not rise in the comparison")
    torch.cuda.synchronize()
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches, both stats entry points "
          f"({time.perf_counter() - t0:.1f}s)")

    def check_spans(tables, d, ln, tag, *, starts=None, caps=(1, 2, 16), spans=True):
        """Every span kernel against its plain version on one batch; the
        lazy and greedy kernels read the (checked) hit words of the reverse
        kernel. Returns (hits, number of records greedy left over cap)."""
        R, L = d.shape
        hits = scan_swar.swar_reverse(d, ln, tables)
        compare("rrx_swar_reverse", [hits], [scan_bits.reverse_plain(d, ln, tables)], tag, ("hits",))
        if starts is None:
            st = rng.integers(-1, L + 2, size=R).astype(np.int32)
            st[:8], st[8:16] = 0, -1
            starts = torch.from_numpy(st).to(dev)
        for longest in (False, True):
            compare("rrx_swar_anchor_end",
                    [scan_swar.swar_anchor_end(d, ln, tables, starts, longest=longest)],
                    [scan_bits.anchor_plain(d, ln, tables, starts, longest=longest)],
                    f"{tag} longest={longest}", ("end",))
        n_over = 0
        for cap in caps if spans else ():
            compare("rrx_swar_lazy_spans", scan_swar.swar_lazy_spans(d, ln, tables, hits, cap),
                    scan_bits.lazy_spans_plain(d, ln, tables, hits, cap),
                    f"{tag} cap={cap}", ("starts", "ends", "cnt"))
            got = scan_swar.swar_greedy_spans(d, ln, tables, hits, cap)
            compare("rrx_swar_greedy_spans", got,
                    scan_bits.greedy_spans_plain(d, ln, tables, hits, cap),
                    f"{tag} cap={cap}", ("starts", "ends", "cnt", "over"))
            n_over += int(got[3].sum().item())
        return hits, n_over

    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0
    for pattern in SWAR_PATTERNS:
        prog = compile_program(pattern)
        tables = scan_bits.device_tables(*scan_swar.swar_tables(scan_swar.swar_spec(prog)), dev)
        for R, L in ((1000, 61), (1024, 64)):
            data, lengths = edge_batch(rng, np, R, L, b"abcdefghijlogqtxyz.\x00")
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            n_over += check_spans(tables, d, ln, f"{pattern!r} R={R} L={L}",
                                  spans=not prog.nullable)[1]
            n_cmp += 1
    torch.cuda.synchronize()
    for name in SPAN_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("greedy overflow (over) was never exercised")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches x {len(SWAR_PATTERNS)} SWAR "
          f"patterns' span kernels (reverse, anchor lazy/longest, lazy and greedy at caps 1, 2, "
          f"16; greedy over set on {n_over} records) ({time.perf_counter() - t0:.1f}s)")

    def check_nfa(tables, d, ln, tag, *, nullable, lead=3, starts=None, caps=(1, 2, 16)):
        """Every matmul-tier kernel against its plain version on one batch;
        the span kernels read the (checked) hit words of the reverse kernel.
        Returns (hits, number of records greedy left over cap). Tiles past
        256 states run (and count their errors under) the wide kernels."""
        P = scan_pallas
        R, L = d.shape
        wide = tables.s_tile > P.REG_S_TILE

        def nm(name):
            return name.replace("rrx_nfa_", "rrx_nfa_wide_") if wide else name

        for seeded in (True, False):
            for ld in sorted({0, lead}):
                kw = dict(seeded=seeded, lead=ld, nullable=nullable)
                compare(nm("rrx_nfa_stats"), P.nfa_stats(d, ln, tables, **kw),
                        P.stats_plain(d, ln, tables, **kw), f"{tag} {kw}")
            compare(nm("rrx_nfa_flags"), [P.nfa_flags(d, ln, tables, seeded=seeded)],
                    [P.flags_plain(d, ln, tables, seeded=seeded)], f"{tag} seeded={seeded}",
                    ("flags",))
        hits = P.nfa_reverse(d, ln, tables)
        compare(nm("rrx_nfa_reverse"), [hits], [scan_bits.reverse_plain(d, ln, tables)], tag,
                ("hits",))
        if starts is None:
            st = rng.integers(-1, L + 2, size=R).astype(np.int32)
            st[:8], st[8:16] = 0, -1
            starts = torch.from_numpy(st).to(dev)
        for longest in (False, True):
            compare(nm("rrx_nfa_anchor_end"),
                    [P.nfa_anchor_end(d, ln, tables, starts, longest=longest)],
                    [scan_bits.anchor_plain(d, ln, tables, starts, longest=longest)],
                    f"{tag} longest={longest}", ("end",))
        n_over = 0
        for cap in caps:
            compare(nm("rrx_nfa_lazy_spans"), P.nfa_lazy_spans(d, ln, tables, hits, cap),
                    scan_bits.lazy_spans_plain(d, ln, tables, hits, cap), f"{tag} cap={cap}",
                    ("starts", "ends", "cnt"))
            got = P.nfa_greedy_spans(d, ln, tables, hits, cap, nullable=nullable)
            compare(nm("rrx_nfa_greedy_spans"), got,
                    scan_bits.greedy_spans_plain(d, ln, tables, hits, cap, nullable=nullable),
                    f"{tag} cap={cap}", ("starts", "ends", "cnt", "over"))
            n_over += int(got[3].sum().item())
        return hits, n_over

    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0
    tiles = set()
    for pattern in NFA_PATTERNS:
        prog = compile_program(pattern)
        tables = scan_pallas.device_nfa_tables(prog, dev)
        tiles.add(prog.s_tile)
        for R, L in ((1000, 61), (1024, 64)):
            data, lengths = nfa_batch(rng, np, R, L)
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            n_over += check_nfa(tables, d, ln, f"{pattern!r} R={R} L={L}",
                                nullable=prog.nullable, lead=prog.horizon or 3)[1]
            n_cmp += 1
    torch.cuda.synchronize()
    for name in NFA_KERNELS + ("rrx_nfa_flags",):
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("matmul-tier greedy overflow (over) was never exercised")
    if tiles != {8, 16, 32, 64, 128, 256}:
        fail(f"matmul-tier comparisons covered record tiles {sorted(tiles)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(NFA_PATTERNS)} patterns "
          f"(record tiles {sorted(tiles)}) through the six matmul-tier kernels (stats seeded/"
          f"unseeded/lead, flags seeded/unseeded, reverse, anchor lazy/longest, lazy and greedy at "
          f"caps 1, 2, 16; greedy over set on {n_over} records) ({time.perf_counter() - t0:.1f}s)")

    def wide_batch(R: int, L: int):
        """An edge batch over the alphabet of the dense multiblock programs,
        with a plant in every second record: runs of 1-3 keywords, or a
        chain x(ab|c){k}y or abcd(ab|c){k}e with k on both sides of the
        programs' bounds (120, 200, 250, 300), cut at L."""
        data, lengths = edge_batch(rng, np, R, L, b"abcdefgiklmnorstuwxy \x00")
        words = [w.encode() for w in keywords(130)]
        for i in range(8, R, 2):
            if i % 4 == 0:
                w = b"".join(words[j] for j in rng.integers(0, len(words), size=int(rng.integers(1, 4))))
            else:
                k = int(rng.choice([118, 122, 198, 203, 248, 252, 299, 300, 321, 345]))
                toks = b"".join(b"ab" if rng.random() < 0.3 else b"c" for _ in range(k))
                w = (b"x" if i % 3 else b"abcd") + toks + (b"y" if i % 5 else b"e")
            w = w[:L]
            at = int(rng.integers(0, L - len(w) + 1))
            data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
        return data, lengths

    def other_split(tables, diags):
        """The tables with a record kernel's other band split (``diags``:
        its default's offsets, ``rec_diags`` for the reverses, ``fwd_diags``
        for the flags): every edge walked where the default keeps
        diagonals, else the diagonals kept (max_diags=8)."""
        return scan_pallas.with_band(tables, 0 if diags else scan_pallas.BANDED_MAX_DIAGS)

    def check_wide_reverse(tables, d, ln, tag):
        """rrx_nfa_wide_reverse (the band step) in both splits against the
        plain reverse; returns the splits' diagonal counts."""
        want = scan_bits.reverse_plain(d, ln, tables)
        splits = set()
        for tb in (tables, other_split(tables, tables.rec_diags)):
            compare("rrx_nfa_wide_reverse", [scan_pallas.nfa_reverse(d, ln, tb)], [want],
                    f"{tag} diagonals {tb.rec_diags}", ("hits",))
            splits.add(len(tb.rec_diags))
        return splits

    def check_wide_flags(tables, d, ln, tag):
        """rrx_nfa_wide_flags (the band step) seeded and unseeded in both
        splits and, where W <= 16, at 32 lanes a record as well as two
        records a warp, against flags_plain; returns the (diagonal count,
        lanes) pairs run."""
        forms = set()
        for seeded in (True, False):
            want = scan_pallas.flags_plain(d, ln, tables, seeded=seeded)
            for tb in (tables, other_split(tables, tables.fwd_diags)):
                for tl in ((tb, tb._replace(band_lanes=32)) if tb.band_lanes == 16 else (tb,)):
                    compare("rrx_nfa_wide_flags", [scan_pallas.nfa_flags(d, ln, tl, seeded=seeded)],
                            [want], f"{tag} seeded={seeded} diagonals {tl.fwd_diags} "
                            f"{tl.band_lanes} lanes a record", ("flags",))
                    forms.add((len(tl.fwd_diags), tl.band_lanes))
        return forms

    STATS_FORMS = ((0, False), (3, False), (0, True), (3, True))  # (lead, nullable)

    def check_wide_stats(tables, d, ln, tag):
        """rrx_nfa_wide_stats (the band step) seeded and unseeded, with lead
        0 and 3, nullable and not, in both splits and, for one channel where
        W <= 16, at 32 lanes a record as well as two records a warp, exactly
        against stats_plain; returns the (diagonal count, lanes, seeded,
        lead, nullable) forms run."""
        forms = set()
        for seeded in (True, False):
            for ld, nullable in STATS_FORMS:
                kw = dict(seeded=seeded, lead=ld, nullable=nullable)
                want = scan_pallas.stats_plain(d, ln, tables, **kw)
                for tb in (tables, other_split(tables, tables.fwd_diags)):
                    two = tb.band_lanes == 16 and tb.P == 1
                    for tl in ((tb, tb._replace(band_lanes=32)) if two else (tb,)):
                        lanes = 32 if tl.P > 1 else tl.band_lanes
                        compare("rrx_nfa_wide_stats", scan_pallas.nfa_stats(d, ln, tl, **kw),
                                want, f"{tag} {kw} diagonals {tl.fwd_diags} {lanes} lanes a "
                                f"record")
                        forms.add((len(tl.fwd_diags), lanes, seeded, ld, nullable))
        return forms

    def stats_forms_missing(forms, want_splits):
        """The (diagonal count, lanes) pairs of ``want_splits`` that did not
        run every seeded / lead / nullable form."""
        return sorted((nd, lanes) for nd, lanes in want_splits
                      if any((nd, lanes, sd, ld, nl) not in forms
                             for sd in (True, False) for ld, nl in STATS_FORMS))

    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0
    words_w = set()
    rev_splits = set()
    for pattern in WIDE_PATTERNS:
        prog = compile_program(pattern)
        tables = scan_pallas.device_nfa_tables(prog, dev)
        words_w.add(-(-prog.s_tile // 32))
        for R, L in ((1000, 61), (512, 400)):
            data, lengths = wide_batch(R, L)
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            n_over += check_nfa(tables, d, ln, f"{pattern[:40]!r} R={R} L={L}",
                                nullable=prog.nullable, lead=prog.horizon or 3)[1]
            if L == 400:  # the reverse's other band split
                rev_splits |= check_wide_reverse(tables, d, ln, f"{pattern[:40]!r} R={R} L={L}")
            n_cmp += 1
    # the reverse's and the flags' band step on an odd count of records of
    # every length around the 16-byte chunks and the 32-step flag and hit
    # words (0 included), shuffled so that the two records of a warp differ,
    # on the chain and K60+, and on hand-built tiles with diagonals planted at
    # BAND_PLANTED (random residual edges, or the seed row alone), both
    # splits each, the flags at both lane counts where W <= 16
    edge_len = np.array([0, 1, 2, 14, 15, 16, 17, 18, 30, 31, 32, 33, 34, 47, 48, 49, 62, 63, 64,
                         65, 95, 96, 97, 127, 128, 129, 255, 256, 257, 318, 319, 320], np.int32)
    flag_forms = set()
    stats_forms = set()
    for pattern in (CHAIN300, K60P):
        tables = scan_pallas.device_nfa_tables(compile_program(pattern), dev)
        data, _ = wide_batch(511, 320)
        lengths = rng.permutation(np.resize(edge_len, 511)).astype(np.int32)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        tag = f"{pattern[:40]!r} R=511, lengths at the chunk edges"
        rev_splits |= check_wide_reverse(tables, d, ln, tag)
        flag_forms |= check_wide_flags(tables, d, ln, tag)
        stats_forms |= check_wide_stats(tables, d, ln, tag)
        n_cmp += 1
    for S, residual in ((384, True), (512, True), (1024, True), (384, False), (1024, False)):
        tables = band_planted(S, residual, rng, dev, dead=False)
        data, lengths = wide_batch(255, 200)
        lengths[: edge_len.size] = np.minimum(edge_len, 200)
        lengths = rng.permutation(lengths).astype(np.int32)
        form = "residual" if residual else "seed row"
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        rev_splits |= check_wide_reverse(tables, d, ln, f"hand-built S={S} {form}")
        flag_forms |= check_wide_flags(tables, d, ln, f"hand-built S={S} {form} R=255")
        stats_forms |= check_wide_stats(tables, d, ln, f"hand-built S={S} {form} R=255")
        n_cmp += 1
    if not {0, 1, 4, len(BAND_PLANTED)} <= rev_splits:
        fail(f"rrx_nfa_wide_reverse comparisons covered only {sorted(rev_splits)} diagonals")
    if not {(0, 16), (1, 16), (0, 32), (1, 32), (4, 32), (len(BAND_PLANTED), 16)} <= flag_forms:
        fail(f"rrx_nfa_wide_flags comparisons covered only {sorted(flag_forms)}")
    missing = stats_forms_missing(stats_forms, ((0, 16), (1, 16), (0, 32), (1, 32), (4, 32),
                                                (len(BAND_PLANTED), 16)))
    if missing:
        fail(f"rrx_nfa_wide_stats: (diagonals, lanes) {missing} missed a seeded/lead/nullable form")
    # P = 3 accept channels on a dense multiblock union
    mp_w = MultiPattern(WIDE_MP, dev)
    tables = mp_w.engine.device_scanner.nfa
    if tables.P != 3 or tables.s_tile <= scan_pallas.REG_S_TILE:
        fail(f"MultiPattern {WIDE_MP[1:]} + K40+: P {tables.P}, s_tile {tables.s_tile}")
    mp_forms = set()
    for R, L in ((1000, 61), (512, 400)):
        data, lengths = wide_batch(R, L)
        data[8::7, :7] = np.frombuffer(b"cat 123", np.uint8)
        d = torch.from_numpy(data).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        mp_forms |= check_wide_stats(tables, d, ln, f"P = 3 R={R} L={L}")
        n_cmp += 1
    missing = stats_forms_missing(mp_forms, ((len(tables.fwd_diags), 32), (0, 32)))
    if missing:
        fail(f"rrx_nfa_wide_stats P = 3: (diagonals, lanes) {missing} missed a form")
    torch.cuda.synchronize()
    for name in WIDE_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("wide greedy overflow (over) was never exercised")
    if words_w != {12, 16, 20, 24, 28, 32}:
        fail(f"wide comparisons covered W = {sorted(words_w)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(WIDE_PATTERNS)} dense "
          f"multiblock programs (W = {sorted(words_w)}, banded and not, one nullable) and a P = 3 "
          f"union through the six wide kernels (stats seeded/unseeded/lead/nullable/P = 3, flags "
          f"seeded/unseeded, reverse, anchor lazy/longest, lazy and greedy at caps 1, 2, 16; greedy "
          f"over set on {n_over} records); the reverse's, the flags' and the stats' band step "
          f"in both splits (diagonal counts {sorted(rev_splits)}; flags (diagonals, lanes a "
          f"record) {sorted(flag_forms)}; stats {sorted({f[:2] for f in stats_forms})} x seeded "
          f"and not x lead 0 / 3 x nullable and not, P = 3 in both splits), on odd counts of "
          f"records of length 0 and at the chunk edges, and on hand-built tiles "
          f"({time.perf_counter() - t0:.1f}s)")

    def counting_batch(R: int, L: int):
        """An edge batch over a counting alphabet, with an a-run, a body
        repetition or a run of a body byte planted in every second record."""
        data, lengths = edge_batch(rng, np, R, L, b"abcdx0123")
        plants = [b"a", b"ab", b"abc", b"abcd", b"bca", b"cd", b"bcdefa", b"abcdefgh", b"b"]
        for i in range(8, R, 2):
            w = plants[int(rng.integers(len(plants)))]
            n = int(rng.integers(1, L // len(w) + 1))
            run = (w * n)[:L]
            at = int(rng.integers(0, L - len(run) + 1))
            data[i, at : at + len(run)] = np.frombuffer(run, np.uint8)
        return data, lengths

    def check_count(ct, d, ln, tag, *, nullable, lead):
        """The three counting kernels against their plain versions on one batch."""
        P = scan_pallas
        for seeded in (True, False):
            for ld in sorted({0, lead}):
                kw = dict(seeded=seeded, lead=ld, nullable=nullable)
                compare("rrx_count_stats", P.count_stats(d, ln, ct, **kw),
                        P.count_stats_plain(d, ln, ct, **kw), f"{tag} {kw}")
            compare("rrx_count_flags", [P.count_flags(d, ln, ct, seeded=seeded)],
                    [P.count_flags_plain(d, ln, ct, seeded=seeded)], f"{tag} seeded={seeded}",
                    ("flags",))
        compare("rrx_count_reverse", [P.count_reverse(d, ln, ct)],
                [P.count_reverse_plain(d, ln, ct)], tag, ("hits",))

    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0
    shapes = set()
    for pattern in COUNT_PATTERNS:
        prog = compile_program(pattern)
        plan = scan_pallas.counting_plan(prog)
        if plan is None:
            fail(f"{pattern!r} has no counting plan")
        ct = scan_pallas.device_count_tables(plan, dev)
        shapes.add((ct.k, ct.n_br))
        for R, L in ((1000, 61), (1024, 320)):
            data, lengths = counting_batch(R, L)
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            check_count(ct, d, ln, f"{pattern!r} R={R} L={L}", nullable=prog.nullable,
                        lead=ct.m * ct.k)
            n_cmp += 1
    torch.cuda.synchronize()
    for name in COUNT_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if {k for k, _ in shapes} != set(range(1, 9)) or {b for _, b in shapes} != {1, 2, 3, 4}:
        fail(f"counting comparisons covered (k, branches) {sorted(shapes)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(COUNT_PATTERNS)} counting "
          f"plans ((k, branches) {sorted(shapes)}) through the three counting kernels (stats "
          f"seeded/unseeded at lead 0 and m*k, flags seeded/unseeded, reverse) "
          f"({time.perf_counter() - t0:.1f}s)")

    def mp_batch(R: int, L: int):
        """An edge batch over the multi-pattern sets' alphabet, with a plant
        (keywords, digit runs, abcdcde) in every second record."""
        data, lengths = edge_batch(rng, np, R, L, b"abcdefgilnortuwxz0123 ")
        for i in range(8, R, 2):
            w = MP_PLANTS[int(rng.integers(len(MP_PLANTS)))][:L]
            at = int(rng.integers(0, L - len(w) + 1))
            data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
        return data, lengths

    def check_mp(sc, d, ln, tag, *, caps=(1, 2, 16), lead=3):
        """The P-channel kernels of one multi-pattern scanner against their
        plain versions on one batch; the span kernel reads the (checked)
        hit words of the reverse kernel. Returns (hits, records over cap 1)."""
        P = scan_pallas
        for seeded in (True, False):
            for nullable in (False, True):
                kw = dict(seeded=seeded, lead=0, nullable=nullable)
                if isinstance(sc, scan_word.WordScanner):
                    compare("rrx_word_stats[P]", scan_word.word_stats(d, ln, sc.tables, **kw),
                            scan_bits.stats_plain(d, ln, sc.tables, **kw), f"{tag} {kw}")
                compare("rrx_nfa_stats[P]", P.nfa_stats(d, ln, sc.nfa, **kw),
                        P.stats_plain(d, ln, sc.nfa, **kw), f"{tag} {kw}")
            kw = dict(seeded=seeded, lead=lead, nullable=False)
            compare("rrx_nfa_stats[P]", P.nfa_stats(d, ln, sc.nfa, **kw),
                    P.stats_plain(d, ln, sc.nfa, **kw), f"{tag} {kw}")
        hits = P.nfa_reverse_mb(d, ln, sc.nfa, sc.span)
        compare("rrx_nfa_reverse_mb", [hits], [P.reverse_mb_plain(d, ln, sc.nfa, sc.span)], tag,
                ("hits",))
        n_over = 0
        for cap in caps:
            got = P.nfa_lazy_spans_mb(d, ln, sc.nfa, sc.span, hits, cap)
            compare("rrx_nfa_lazy_spans_mb", got,
                    P.lazy_spans_mb_plain(d, ln, sc.nfa, sc.span, hits, cap), f"{tag} cap={cap}",
                    ("starts", "ends", "cnt"))
            if cap == 1:
                n_over += int((got[2] > 1).any(dim=1).sum().item())
        return hits, n_over

    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0
    routes = set()
    for pats in MP_SETS:
        mp = MultiPattern(pats, dev)
        sc = mp.engine.device_scanner
        routes.add((type(sc).__name__, mp.P > scan_pallas.MB_REG_CHANNELS))
        for R, L in ((1000, 61), (1024, 64)):
            data, lengths = mp_batch(R, L)
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            n_over += check_mp(sc, d, ln, f"{pats} R={R} L={L}")[1]
            n_cmp += 1
    torch.cuda.synchronize()
    for name in MP_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("the multi-channel spans never overflowed cap 1")
    want_routes = {(t, big) for t in ("WordScanner", "PallasScanner") for big in (False, True)}
    if routes != want_routes:
        fail(f"multi-pattern comparisons covered (scanner, P > 8) {sorted(routes)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(MP_SETS)} pattern sets "
          f"(u32-word and matmul tiers, channels in registers and in global rows) through the four "
          f"P-channel kernels (word and matmul stats seeded/unseeded/nullable/lead, reverse_mb, "
          f"lazy_spans_mb at caps 1, 2, 16; cap 1 overflowed on {n_over} records) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the long-string window kernels: strings of 0-3 bytes and 1-4 MiB,
    # windows of 256 and 4096 bytes (lead 0 and an overlap), seeded and
    # unseeded, from the empty set, from random entry states with random
    # seed gates, and (S <= 32: the summary pass) from the basis states
    P_ = scan_pallas
    t0 = time.perf_counter()
    n_cmp = 0
    before = {name: long_wrappers[name].launches for name in LONG_KERNELS}

    # the plain count with the final state is the walk's cnt and tail (the
    # same with and without it) and its last state set (long_carry_plain's
    # result: both end on _long_walk's last step), so one plain walk is the
    # reference of the carry and of both counts
    def check_long(tables, d, geom, tag, v0=None, gate=None):
        for seeded in (True, False):
            kw = dict(seeded=seeded)
            want = P_.long_count_plain(d, geom, tables, v0, gate, final=True, **kw)
            compare("rrx_long_carry", [P_.long_carry(d, geom, tables, v0, gate, **kw)],
                    [want[2]], tag, ("vout",))
            compare("rrx_long_count", P_.long_count(d, geom, tables, v0, gate, final=True, **kw),
                    want, tag, ("cnt", "tail", "vout"))
            compare("rrx_long_count", P_.long_count(d, geom, tables, v0, gate, **kw)[:2],
                    want[:2], tag, ("cnt", "tail"))
            if geom.rep == 1:
                compare("rrx_long_flags", [P_.long_flags(d, geom, tables, v0, gate, **kw)],
                        [P_.long_flags_plain(d, geom, tables, v0, gate, **kw)], tag, ("flags",))
        if geom.rep == 1:
            g2 = geom._replace(T=geom.T + 9)  # a suffix overlap past the owned steps
            compare("rrx_long_reverse", [P_.long_reverse(d, g2, tables)],
                    [P_.long_reverse_plain(d, g2, tables)], tag, ("hits",))

    long_alpha = np.frombuffer(b"abcdegortwx\x00\x80\xff", np.uint8)
    long_plants = [b"ab", b"cat", b"dog", b"abababc", b"abbbbc", b"error", b"timeout",
                   b"oomleak", b"segfault"]

    def long_string(n):
        arr = rng.choice(long_alpha, size=n).astype(np.uint8)
        for k in range(n // 64):  # plants across window edges (matches the owned ranges cut)
            w = long_plants[k % len(long_plants)]
            at = int(rng.integers(0, n - len(w) + 1))
            arr[at : at + len(w)] = np.frombuffer(w, np.uint8)
        if n >= 4:  # `^` and `$` fire in the first and the last window
            arr[:2] = arr[-2:] = np.frombuffer(b"ab", np.uint8)
        return torch.from_numpy(arr).to(dev)

    def rand_v0(nw, Wd):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=(nw, Wd), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    # the plain versions take ~10 torch launches per window step, so the
    # 4096-byte windows (4,100 steps) run on the largest string only
    for pattern in LONG_PATTERNS:
        prog = compile_program(pattern)
        tables = P_.device_nfa_tables(prog, dev)
        Wd = -(-tables.s_tile // 32)
        for n in (0, 1, 2, 3, (1 << 20) + 7, (4 << 20) - 5):
            d = long_string(n)
            geoms = [(256, 0), (256, 7)] if n < (4 << 20) - 5 else [(4096, 13)]
            for blk, lead in geoms:
                nb = -(-(n + 2) // blk)
                geom = P_.LongGeom(n, nb, blk, lead, blk + lead)
                tag = f"{pattern[:24]!r} n={n} block={blk} lead={lead}"
                if blk == 256:
                    check_long(tables, d, geom, tag)
                gate = torch.from_numpy(rng.random(nb) < 0.5).to(dev)
                check_long(tables, d, geom, tag + " random v0", rand_v0(nb, Wd), gate)
                n_cmp += 1 + (blk == 256)
            if prog.s_tile <= 32 and n == (1 << 20) + 7:  # the summary pass's basis
                S = prog.n_states
                nb = -(-(n + 2) // 256)
                basis = torch.zeros((S + 1, tables.s_tile), dtype=torch.bool, device=dev)
                basis[torch.arange(S), torch.arange(S)] = True
                vb = P_._state_words(basis, tables.s_tile).repeat(nb, 1)
                gb = (torch.arange(nb * (S + 1), device=dev) % (S + 1)) == S
                check_long(tables, d, P_.LongGeom(n, nb * (S + 1), 256, 0, 256, S + 1),
                           f"{pattern!r} n={n} summary basis", vb, gb)
                n_cmp += 1
    torch.cuda.synchronize()
    for name in LONG_KERNELS:
        if long_wrappers[name].launches <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    print(f"phase 2: kernel == plain on the card, {n_cmp} string/window cases of "
          f"{len(LONG_PATTERNS)} programs (W = 1, 2, 8) through the four long-string kernels "
          f"(carry, count with and without the final state, flags, reverse; seeded and unseeded; "
          f"empty, random and basis entry states) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the wide multi-channel span kernels (rows 21-22 at W > 8): the P = 3
    # union, the union with `$` channels (a span at EOS, then the empty match
    # at len) and a P = 40 accept map on K40+'s tile (channels past lane 31
    # keep their bookkeeping in global rows), at caps 1, 2 and 16
    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0

    def check_mb_wide(tables, span, d, ln, tag):
        hits = P_.nfa_reverse_mb(d, ln, tables, span)
        compare("rrx_nfa_wide_reverse_mb", [hits], [P_.reverse_mb_plain(d, ln, tables, span)], tag,
                ("hits",))
        tb_o = other_split(tables, tables.rec_diags)  # the other split, the same hit words
        compare("rrx_nfa_wide_reverse_mb", [P_.nfa_reverse_mb(d, ln, tb_o, span)], [hits],
                f"{tag} diagonals {tb_o.rec_diags}", ("hits",))
        over = 0
        tb_f = other_split(tables, tables.fwd_diags)  # the lazy spans' other split
        for cap in (1, 2, 16):
            want = P_.lazy_spans_mb_plain(d, ln, tables, span, hits, cap)
            for tb in (tables, tb_f):
                got = P_.nfa_lazy_spans_mb(d, ln, tb, span, hits, cap)
                compare("rrx_nfa_wide_lazy_spans_mb", got, want,
                        f"{tag} cap={cap} diagonals {tb.fwd_diags}", ("starts", "ends", "cnt"))
                splits_mb.add(len(tb.fwd_diags))
            if cap == 1:
                over += int((got[2] > 1).any(dim=1).sum().item())
        return over

    splits_mb = set()

    prog40 = compile_program(K40P)
    S40 = prog40.s_tile
    owner = rng.integers(0, 40, size=S40)
    acc40 = np.zeros((S40, 40), np.uint8)
    acc40[np.arange(S40), owner] = np.asarray(prog40.accept)[:S40] != 0
    f0 = np.flatnonzero(np.asarray(prog40.F[0, :S40]))
    sgm40 = np.zeros((40, S40), np.uint8)
    sgm40[owner[f0], f0] = 1
    posm40 = np.zeros((S40, 40), np.uint8)
    posm40[np.arange(S40), owner] = 1
    posm40[0] = 0
    mb_sets = []
    for pats in (WIDE_MP, WIDE_MP_C1):
        sc_ = MultiPattern(pats, dev).engine.device_scanner
        mb_sets.append((f"MultiPattern K40+ {' '.join(pats[1:])}", sc_.nfa, sc_.span))
    span40 = P_.span_channels(sgm40, posm40, 40, S40).view(np.int32).copy()
    mb_sets.append(("K40+'s tile, 40 channels", P_.device_nfa_tables(prog40, dev, acc40, 40),
                    torch.from_numpy(span40).to(dev)))
    for tag, tables, span in mb_sets:
        if tables.s_tile <= P_.REG_S_TILE:
            fail(f"{tag}: s_tile {tables.s_tile}, not a wide tile")
        for R, L in ((1000, 61), (512, 400)):
            data, lengths = wide_batch(R, L)
            data[8::7, :7] = np.frombuffer(b"cat 123", np.uint8)
            for i in range(9, R, 5):  # a digit or cat at the record's end: the `$` channels
                e = int(lengths[i])
                if e >= 3:
                    data[i, e - 3 : e] = np.frombuffer(b"cat" if i % 2 else b" 45", np.uint8)
            d = torch.from_numpy(data).to(dev)
            ln = torch.from_numpy(lengths).to(dev)
            n_over += check_mb_wide(tables, span, d, ln, f"{tag} R={R} L={L}")
            n_cmp += 1
    torch.cuda.synchronize()
    for name in WIDE_MB_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("the wide multi-channel spans never overflowed cap 1")
    if not {0, 1} <= splits_mb:
        fail(f"rrx_nfa_wide_lazy_spans_mb ran only the splits of {sorted(splits_mb)} diagonals")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(mb_sets)} channel sets on "
          f"wide tiles (P = 3, P = 3 with `$` channels, P = 40) through rrx_nfa_wide_reverse_mb and "
          f"rrx_nfa_wide_lazy_spans_mb at caps 1, 2, 16, both in both splits (cap 1 overflowed "
          f"on {n_over} records) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the wide long-string window kernels (rows 26-30 at W > 8): strings of
    # 0-3 bytes and 1 MiB with keywords, x(ab|c){k}y chains and 300-letter
    # runs planted, windows of 256 bytes (lead 0 and the program's overlap),
    # seeded and unseeded, from the empty set and from random entry states
    # with random seed gates, 3 windows a block (rep 3); 4 MiB in windows of
    # 4096 (the overlap) at W = 16 and 32 only (the plain versions cost ~10
    # torch launches a window step: ~6 s a program there)
    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0
    wide_plants = [w.encode() for w in keywords(120)] + [
        b"x" + b"c" * 320 + b"y", b"x" + b"ab" * 150 + b"c" * 20 + b"y", b"x" + b"abc" * 110 + b"y"]

    def long_string_w(n):
        arr = rng.choice(np.frombuffer(b"abcdefgiklmnorstuwxy \x00\x80\xff", np.uint8),
                         size=n).astype(np.uint8)
        for k in range(n // 64):
            w = wide_plants[k % len(wide_plants)] if k % 7 else bytes(
                rng.integers(97, 123, size=300).astype(np.uint8)) + b"x"
            at = int(rng.integers(0, max(n - len(w), 0) + 1))
            arr[at : at + len(w)] = np.frombuffer(w, np.uint8)[: n - at]
        return torch.from_numpy(arr).to(dev)

    words_lw = set()
    for pattern in LONG_WIDE_PATTERNS:
        prog = compile_program(pattern)
        tables = P_.device_nfa_tables(prog, dev)
        Wd = -(-tables.s_tile // 32)
        words_lw.add(Wd)
        o = prog.horizon + 2
        for n in (0, 1, 2, 3, (1 << 20) + 7) + (((4 << 20) - 5,) if Wd in (16, 32) else ()):
            d = long_string_w(n)
            geoms = [(256, 0), (256, o)] if n < (4 << 20) - 5 else [(4096, o)]
            for blk, lead in geoms:
                nb = -(-(n + 2) // blk)
                geom = P_.LongGeom(n, nb, blk, lead, blk + lead)
                tag = f"{pattern[:24]!r} n={n} block={blk} lead={lead}"
                if blk == 256:
                    check_long(tables, d, geom, tag)
                gate = torch.from_numpy(rng.random(nb) < 0.5).to(dev)
                check_long(tables, d, geom, tag + " random v0", rand_v0(nb, Wd), gate)
                n_cmp += 1 + (blk == 256)
            if n == (1 << 20) + 7:
                nb = -(-(n + 2) // 256)
                gate = torch.from_numpy(rng.random(3 * nb) < 0.5).to(dev)
                check_long(tables, d, P_.LongGeom(n, 3 * nb, 256, 0, 256, 3),
                           f"{pattern[:24]!r} n={n} rep 3", rand_v0(3 * nb, Wd), gate)
                n_cmp += 1
    torch.cuda.synchronize()
    for name in LONG_WIDE_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if words_lw != {12, 16, 28, 32}:
        fail(f"wide long comparisons covered W = {sorted(words_lw)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} string/window cases of "
          f"{len(LONG_WIDE_PATTERNS)} programs (W = {sorted(words_lw)}) through the four wide "
          f"long-string kernels (carry, count with and without the final state, flags, reverse; "
          f"seeded and unseeded; empty and random entry states; rep 3) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the band step of rrx_long_wide_flags, _count and _reverse (every
    # comparison above ran its default split): the four programs again with every edge
    # walked (max_diags=0) and, at W <= 16, at 32 lanes a window; hand-built
    # tiles at W = 12, 16 and 32 with diagonals planted at -70..64 (random
    # residual edges, or the seed row alone), each split both ways and at
    # both lane counts; 1 MiB strings in windows of 256, an odd window count
    # (two windows a warp leave one half idle), rep 3, random entry states
    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0

    def check_band(tables, d, geom, tag, v0=None, gate=None):
        nonlocal n_cmp
        for seeded in (True, False):
            kw = dict(seeded=seeded)
            want = P_.long_count_plain(d, geom, tables, v0, gate, final=True, **kw)
            for final in (True, False):  # one plain walk: cnt and tail are the same
                got = P_.long_count(d, geom, tables, v0, gate, final=final, **kw)
                compare("rrx_long_count", [x for x in got if x is not None],
                        list(want[: 2 + final]), f"{tag} final={final}",
                        ("cnt", "tail", "vout")[: 2 + final])
                n_cmp += 1
        if geom.rep == 1:
            for seeded in (True, False):  # the flags windows: T = lead + block
                compare("rrx_long_flags",
                        [P_.long_flags(d, geom, tables, v0, gate, seeded=seeded)],
                        [P_.long_flags_plain(d, geom, tables, v0, gate, seeded=seeded)],
                        f"{tag} seeded={seeded}", ("flags",))
                n_cmp += 1
            g2 = geom._replace(T=geom.T + 9)
            compare("rrx_long_reverse", [P_.long_reverse(d, g2, tables)],
                    [P_.long_reverse_plain(d, g2, tables)], tag, ("hits",))
            n_cmp += 1

    def band_forms(tables):
        """The tables' own split, then each other split, the diagonals kept
        (max_diags=8) or every edge walked (max_diags=0), then 32 lanes a
        window at W <= 16."""
        forms = [("default", tables)]
        for md in (P_.BANDED_MAX_DIAGS, 0):
            tb = P_.with_band(tables, md)
            if tb.diags != tables.diags:
                forms.append((f"max_diags={md}", tb))
        if tables.band_lanes == 16:
            forms.append(("32 lanes", tables._replace(band_lanes=32)))
        return forms

    def band_strings(tables, tag, o):
        Wd = -(-tables.s_tile // 32)
        for n in (3, (1 << 20) + 7):
            d = long_string_w(n)
            nb = -(-(n + 2) // 256)
            check_band(tables, d, P_.LongGeom(n, nb, 256, 0, 256), f"{tag} n={n}")
            nw = nb | 1  # an odd window count, from random entry states
            gate = torch.from_numpy(rng.random(nw) < 0.5).to(dev)
            check_band(tables, d, P_.LongGeom(n, nw, 256, o, 256 + o),
                       f"{tag} n={n} nw={nw} lead={o} random v0", rand_v0(nw, Wd), gate)
        gate = torch.from_numpy(rng.random(3 * nb) < 0.5).to(dev)
        check_band(tables, d, P_.LongGeom(n, 3 * nb, 256, 0, 256, 3), f"{tag} n={n} rep 3",
                   rand_v0(3 * nb, Wd), gate)

    band_seen = set()
    for pattern in LONG_WIDE_PATTERNS:
        prog = compile_program(pattern)
        for form, tables in band_forms(P_.device_nfa_tables(prog, dev))[1:]:
            band_strings(tables, f"{pattern[:24]!r} {form}", prog.horizon + 2)
            band_seen.add((-(-tables.s_tile // 32), form, tables.band_lanes))
    for S, residual in ((384, True), (512, True), (1024, True), (384, False), (512, False),
                        (1024, False)):
        tables = band_planted(S, residual, rng, dev)
        if tables.diags != BAND_PLANTED:
            fail(f"hand-built tile of {S} states kept the diagonals {tables.diags}")
        for form, tb in band_forms(tables):
            tag = f"hand-built S={S} {'residual' if residual else 'seed row only'} {form}"
            band_strings(tb, tag, 13)
            band_seen.add((-(-S // 32), form, tb.band_lanes))
    torch.cuda.synchronize()
    for name in ("rrx_long_wide_flags", "rrx_long_wide_count", "rrx_long_wide_reverse"):
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the band comparisons")
    if {(12, "default", 16), (16, "32 lanes", 32), (32, "max_diags=0", 32),
            (32, "max_diags=8", 32)} - band_seen:
        fail(f"band comparisons covered only {sorted(band_seen)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} band-step cases (rrx_long_wide_flags "
          f"seeded and unseeded, rrx_long_wide_count with and without the final state, "
          f"rrx_long_wide_reverse) of {len(LONG_WIDE_PATTERNS)} "
          f"programs with the other split (diagonals kept, or every edge walked) and at 32 lanes a "
          f"window, and hand-built "
          f"tiles at W = 12, 16, 32 with diagonals at {BAND_PLANTED} (random residual edges, or "
          f"the seed row alone), each form; odd window counts, rep 3, random entry states "
          f"({time.perf_counter() - t0:.1f}s)")

    # the bitband kernels: every program of the tier on a 256-record edge
    # batch with a chain of its body planted in every second record (one
    # copy too few, m, m..n, n, one too many; cut by the record's end)
    BB = scan_bitband

    def chain(pattern: str, k: int, L: int) -> bytes:
        """k copies of the pattern's repeated body with its head and tail,
        at most L bytes: x{k}y, a(ab|c){k}b or x(ab|c){k} + y or z."""
        if pattern.startswith("x{"):
            return (b"x" * k)[: L - 1] + b"y"
        nab = int(rng.integers(0, max(0, min(k, L - k - 2)) + 1))
        body = [b"ab"] * nab + [b"c"] * (k - nab)
        rng.shuffle(body)
        if pattern.startswith("(a("):
            return b"a" + b"".join(body) + b"b"
        return b"x" + b"".join(body) + bytes([int(rng.choice(list(b"yz")))])

    def bitband_batch(pattern: str, R: int, L: int):
        data, lengths = edge_batch(rng, np, R, L, b"xabcyz")
        m = re.search(r"\{(\d+),(\d*)\}", pattern)
        lo, hi = int(m.group(1)), int(m.group(2) or int(m.group(1)) + 40)
        for i in range(8, R, 2):
            k = int(rng.choice([lo - 1, lo, int(rng.integers(lo, hi + 1)), hi, hi + 1]))
            w = chain(pattern, k, L)[:L]
            at = 0 if pattern.startswith("^") else int(rng.integers(0, L - len(w) + 1))
            data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
            if pattern.startswith("^") and i % 4 == 0:
                lengths[i] = len(w)  # the whole record: ^...$ can match
            elif rng.random() < 0.7:
                lengths[i] = max(lengths[i], at + len(w))
        return data, lengths

    def first_starts(hits, ln):
        """[R] int32: each record's first candidate start (from the hit
        words), -1 where it has none."""
        hb = scan_bits.hit_bits(hits, hits.shape[0] * 32)
        sbm = torch.cat([hb[:, :1] | hb[:, 1:2], hb[:, 2:]], dim=1)
        cols = torch.arange(sbm.shape[1], device=dev)[None, :]
        sbm = sbm & (cols <= ln.to(torch.int64)[:, None])
        return torch.where(sbm.any(dim=1), sbm.to(torch.uint8).argmax(dim=1), -1).to(torch.int32)

    def check_bitband(tables, d, ln, tag, caps):
        """The five bitband kernels against their plain versions on one
        batch; returns the records whose spans overflowed."""
        R, L = d.shape
        want_fl, want_st = {}, {}
        for seeded in (True, False):
            for nullable in ((False, True) if seeded else (False,)):
                kw = dict(seeded=seeded, nullable=nullable)
                want_st[seeded, nullable] = BB.stats_plain(d, ln, tables, **kw)
                compare("rrx_bitband_stats", BB.bitband_stats(d, ln, tables, **kw),
                        want_st[seeded, nullable], f"{tag} {kw}")
            want_fl[seeded] = BB.flags_plain(d, ln, tables, seeded=seeded)
            compare("rrx_bitband_flags", [BB.bitband_flags(d, ln, tables, seeded=seeded)],
                    [want_fl[seeded]], f"{tag} seeded={seeded}", ("flags",))
        hits = BB.bitband_reverse(d, ln, tables)
        want_rev = scan_bits.reverse_plain(d, ln, tables)
        compare("rrx_bitband_reverse", [hits], [want_rev], tag, ("hits",))
        # anchored rescans from each record's first candidate start (every
        # second record), random starts (-1 .. L) and 0
        st = torch.from_numpy(rng.integers(-1, L + 1, size=R).astype(np.int32)).to(dev)
        st = torch.where(torch.arange(R, device=dev) % 2 == 0, first_starts(hits, ln), st)
        st[:3] = torch.tensor([0, -1, 0], dtype=torch.int32)
        n_over = 0
        for longest in (False, True):
            compare("rrx_bitband_anchor_end",
                    [BB.bitband_anchor_end(d, ln, tables, st, longest=longest)],
                    [scan_bits.anchor_plain(d, ln, tables, st, longest=longest)],
                    f"{tag} longest={longest}", ("end",))
            for cap in caps:
                got = BB.bitband_spans(d, ln, tables, hits, cap, longest=longest)
                compare("rrx_bitband_spans", got,
                        scan_bits.greedy_spans_plain(d, ln, tables, hits, cap, longest=longest),
                        f"{tag} cap={cap} longest={longest}", ("starts", "ends", "cnt", "over"))
                n_over += int(got[3].sum().item())
        # live (the prefilter's passes): records at or past it return at
        # once; records are independent, so the plain versions' first n
        # records are the reference
        n = R // 3
        live = torch.tensor([n], dtype=torch.int32, device=dev)
        got = BB.bitband_stats(d, ln, tables, seeded=True, nullable=False, live=live)
        compare("rrx_bitband_stats", [x[:n] for x in got],
                [x[:n] for x in want_st[True, False]], f"{tag} live={n}")
        compare("rrx_bitband_reverse", [BB.bitband_reverse(d, ln, tables, live)[:, :n]],
                [want_rev[:, :n]], f"{tag} live={n}", ("hits",))
        cols = n * tables.C
        compare("rrx_bitband_flags",
                [BB.bitband_flags(d, ln, tables, seeded=True, live=live)[:, :cols]],
                [want_fl[True][:, :cols]], f"{tag} live={n}", ("flags",))
        return n_over

    t0 = time.perf_counter()
    before = launches()
    n_cmp = n_over = 0
    shapes = set()
    for pattern in BITBAND_PATTERNS:
        prog = compile_program(pattern)
        spec = BB.bitband_spec(prog)
        if spec is None:
            fail(f"{pattern!r} does not decompose (bitband_spec)")
        tables = BB.device_bitband_tables(prog, spec, dev)
        shapes.add((spec.W, len(spec.diags), len(spec.rank1), spec.tri_gaps))
        L = {CONFIG10: 1024, "x(ab|c){400,}y": 1024, "x{2,300}y": 320,
             "(ab|c){100,130}": 320}.get(pattern, 512)
        data, lengths = bitband_batch(pattern, 256, L)
        d = torch.from_numpy(data).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        caps = (1, 2, 16) if pattern in (CONFIG10, "(a(ab|c){100,200}b)+") else (2,)
        n_over += check_bitband(tables, d, ln, f"{pattern!r} R=256 L={L}", caps)
        n_cmp += 1
        if pattern == CONFIG10:
            # two accept channels on one program: the program's accept set
            # and every fifth state
            acc2 = np.zeros((prog.s_pad, 2), np.uint8)
            acc2[: prog.n_states, 0] = np.asarray(prog.accept)[: prog.n_states]
            acc2[: prog.n_states, 1] = np.arange(prog.n_states) % 5 == 2
            t2 = BB.device_bitband_tables(prog, spec, dev, acc2)
            for seeded in (True, False):
                kw = dict(seeded=seeded, nullable=False)
                compare("rrx_bitband_stats", BB.bitband_stats(d, ln, t2, **kw),
                        BB.stats_plain(d, ln, t2, **kw), f"{pattern!r} 2 channels {kw}")
                compare("rrx_bitband_flags", [BB.bitband_flags(d, ln, t2, seeded=seeded)],
                        [BB.flags_plain(d, ln, t2, seeded=seeded)],
                        f"{pattern!r} 2 channels seeded={seeded}", ("flags",))
    # the register steps of rrx_bitband_stats and rrx_bitband_reverse on the
    # specs that the programs above leave out: NW = 3 and 4, every edge on a
    # diagonal (offsets -2..4; -300 and -298, 9 lanes away), hand-built tables
    # whose top lane holds state words (NW = 1, 3 and 4), and 32 accept
    # channels on config 10 (the reverse on the accept set)
    def check_bb_stats(tables, d, ln, tag):
        want = {}
        for seeded in (True, False):
            for nullable in (False, True):
                kw = dict(seeded=seeded, nullable=nullable)
                want[seeded, nullable] = BB.stats_plain(d, ln, tables, **kw)
                compare("rrx_bitband_stats", BB.bitband_stats(d, ln, tables, **kw),
                        want[seeded, nullable], f"{tag} {kw}")
        n = d.shape[0] // 3
        live = torch.tensor([n], dtype=torch.int32, device=dev)
        got = BB.bitband_stats(d, ln, tables, seeded=True, nullable=False, live=live)
        compare("rrx_bitband_stats", [x[:n] for x in got], [x[:n] for x in want[True, False]],
                f"{tag} live={n}")
        # the flags on the same register step, seeded and unseeded, and the
        # seeded ones' live slice
        want_f = {}
        for seeded in (True, False):
            want_f[seeded] = BB.flags_plain(d, ln, tables, seeded=seeded)
            compare("rrx_bitband_flags", [BB.bitband_flags(d, ln, tables, seeded=seeded)],
                    [want_f[seeded]], f"{tag} seeded={seeded}", ("flags",))
        cols = n * tables.C
        compare("rrx_bitband_flags",
                [BB.bitband_flags(d, ln, tables, seeded=True, live=live)[:, :cols]],
                [want_f[True][:, :cols]], f"{tag} live={n}", ("flags",))
        want = scan_bits.reverse_plain(d, ln, tables)
        compare("rrx_bitband_reverse", [BB.bitband_reverse(d, ln, tables)], [want], tag, ("hits",))
        compare("rrx_bitband_reverse", [BB.bitband_reverse(d, ln, tables, live)[:, :n]],
                [want[:, :n]], f"{tag} live={n}", ("hits",))
        shapes.add((tables.spec.W, len(tables.spec.diags), len(tables.spec.rank1),
                    tables.spec.tri_gaps))

    def all_diagonal(prog):
        spec = BB.bitband_spec(prog)
        e = prog.nfa.get_edges()
        offs = tuple(sorted(set((e[:, 1].astype(np.int64) - e[:, 0].astype(np.int64)).tolist())))
        return spec._replace(diags=offs, rank1=(), tri_gaps=(), tri_win=(0, spec.W))

    n_regs = len(shapes)
    for pattern in ("x(ab|c){700,800}y", "x(ab|c){1000,1300}y"):
        # records shorter than a match: accept channels on every fifth
        # state and on a random tenth show the whole state set
        prog = compile_program(pattern)
        acc3 = np.zeros((prog.s_pad, 3), np.uint8)
        acc3[: prog.n_states, 0] = np.asarray(prog.accept)[: prog.n_states]
        acc3[: prog.n_states, 1] = np.arange(prog.n_states) % 5 == 2
        acc3[: prog.n_states, 2] = rng.random(prog.n_states) < 0.1
        tables = BB.device_bitband_tables(prog, BB.bitband_spec(prog), dev, acc3)
        data, lengths = bitband_batch(pattern, 128, 512)
        check_bb_stats(tables, torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev),
                       f"{pattern!r} R=128 L=512, 3 channels")
    for pattern, body in (("x(ab|c){400,}y", None), ("((ab|c){100}d)+", b"d")):
        prog = compile_program(pattern)
        tables = BB.device_bitband_tables(prog, all_diagonal(prog), dev)
        if body is None:
            data, lengths = bitband_batch(pattern, 128, 1024)
        else:  # runs of 100 copies of (ab|c) and a d, one in three corrupted
            data, lengths = edge_batch(rng, np, 128, 1024, b"abcd")
            for i in range(8, 128):
                runs_ = b"".join(b"".join(rng.choice([b"ab", b"c"], size=100 - (k % 3 == 2)))
                                 + b"d" for k in range(int(rng.integers(1, 6))))[:1024]
                data[i, : len(runs_)] = np.frombuffer(runs_, np.uint8)
        check_bb_stats(tables, torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev),
                       f"{pattern!r} every edge on a diagonal {tables.spec.diags}")
    for W in BB_PLANTED:
        tables = bitband_planted(W, rng, dev)
        data, lengths = edge_batch(rng, np, 128, 512, BB_PLANTED_ALPHABET)
        check_bb_stats(tables, torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev),
                       f"hand-built W={W}")
    prog = compile_program(CONFIG10)
    acc32 = (rng.random((prog.s_pad, 32)) < 0.02).astype(np.uint8)
    acc32[prog.n_states:] = 0
    acc32[: prog.n_states, 0] = np.asarray(prog.accept)[: prog.n_states]
    t32 = BB.device_bitband_tables(prog, BB.bitband_spec(prog), dev, acc32)
    data, lengths = bitband_batch(CONFIG10, 128, 1024)
    check_bb_stats(t32, torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev),
                   "config 10, 32 accept channels")
    # the reverse step's two regimes on config 10: records whose reverse
    # state stays live throughout (runs of 300 c's each closed by a y, every
    # step continues a partial match) and records where it is empty on most
    # steps (lowercase without y: u = R & mask empty, the step skipped)
    tb_rev = BB.device_bitband_tables(prog, BB.bitband_spec(prog), dev)
    busy_d = np.frombuffer((b"c" * 300 + b"y") * 4, np.uint8)[:1024]
    data = np.tile(busy_d, (128, 1)).copy()
    data[64:] = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxz", np.uint8), size=(64, 1024))
    lengths = rng.integers(900, 1025, size=128).astype(np.int32)
    lengths[:64] = rng.choice([301, 602, 903], size=64)  # each ends in its last y
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
    busy = [reverse_busy(tb_rev, d[a:b], ln[a:b]) for a, b in ((0, 64), (64, 128))]
    if not (busy[0][0] > 0.9 * busy[0][1] and busy[1][0] < 0.1 * busy[1][1]):
        fail(f"config 10's live and empty reverse batches: busy steps {busy}")
    compare("rrx_bitband_reverse", [BB.bitband_reverse(d, ln, tb_rev)],
            [scan_bits.reverse_plain(d, ln, tb_rev)],
            f"config 10, live / empty reverse state (busy steps {busy})", ("hits",))
    if {16, 24, 32, 40, 56, 80, 96, 128} - {w for w, *_ in shapes}:
        fail(f"bitband stats comparisons covered only W in {sorted(w for w, *_ in shapes)}")
    torch.cuda.synchronize()
    for name in BITBAND_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if n_over == 0:
        fail("bitband span overflow (over) was never exercised")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of 256 records of the "
          f"{len(BITBAND_PATTERNS)} bitband programs ((W, diagonals, rank-1, gaps) "
          f"{sorted(shapes)}) through the five bitband kernels (stats seeded/unseeded/nullable, "
          f"flags seeded/unseeded, two accept channels, reverse, anchor lazy/longest, spans lazy "
          f"and longest at caps 1, 2, 16 (cap 1 overflowed on {n_over} records), live records); "
          f"rrx_bitband_stats, _flags and _reverse (the register steps) also on "
          f"{len(shapes) - n_regs} more specs (NW = 3 and 4, every edge on a diagonal, hand-built "
          f"at W = 32, 96 and 128) and 32 accept channels, stats seeded/unseeded x nullable, flags "
          f"seeded/unseeded, and live; the reverse on records whose "
          f"state stays live and where it is empty "
          f"({time.perf_counter() - t0:.1f}s)")

    # the container kernels: every container program of the probe table on
    # a 192-record edge batch with chains of its body (or its keywords)
    # planted, both table forms, a full (U) block, a hand-built partition,
    # 1, 2, 40 and 100 accept channels, nullable stats and live records
    SP = scan_sparse

    def sparse_plant(pattern: str, k: int) -> bytes:
        """One match-shaped plant of k copies of the program's body (a
        keyword of K120)."""
        if pattern == K120:
            return K120_WORDS[k % len(K120_WORDS)].encode()
        if pattern.startswith("(a|b)*"):
            return b"ab" * (k % 5) + b"c" + b"abc" * min(k, 100)
        if pattern.startswith("a*b"):
            return b"a" * (k % 7) + b"b" * k
        if pattern.startswith("x[ab]"):
            return b"x" + bytes(rng.choice(np.frombuffer(b"ab", np.uint8), size=k)) + b"c"
        if "ab|c" in pattern:
            body = b"".join(rng.choice([b"ab", b"c"], size=k, p=[0.2, 0.8]))
            return b"x" + body + b"y" if pattern.startswith("x") else body + b"d"
        body = b"".join(rng.choice([b"abc", b"de"], size=k))
        return b"x" + body + b"y" if pattern.startswith("x") else body

    def sparse_batch(pattern: str, R: int, L: int):
        data, lengths = edge_batch(rng, np, R, L, b"xabcdeyz")
        m = re.search(r"\{(\d+),(\d*)\}", pattern)
        lo, hi = (int(m.group(1)), int(m.group(2) or int(m.group(1)) + 40)) if m else (1, 40)
        for i in range(8, R, 2):
            k = int(rng.choice([max(lo - 1, 0), lo, int(rng.integers(lo, hi + 1)), hi, hi + 1]))
            w = sparse_plant(pattern, k)[:L]
            at = 0 if i % 8 == 0 else int(rng.integers(0, L - len(w) + 1))
            data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
            if i % 8 == 0:
                lengths[i] = len(w)  # the whole record: an unseeded scan can match
        return data, lengths

    def check_sparse(tables, d, ln, tag, nullable, forms):
        """The three container kernels against their plain versions (on the
        card) in each table form that fits their kind (SP.table_form);
        stats seeded and unseeded (and nullable), flags seeded and
        unseeded, reverse (on the program's accept set, whatever the
        channels), and live; seeded stats and reverse also with every
        source block in the block-parallel form and with every live state
        walked (walk_max -1 and 128)."""
        R = d.shape[0]
        want = {}
        for seeded in (True, False):
            for nl in ((False, True) if nullable else (False,)):
                want["stats", seeded, nl] = SP.sparse_stats_plain(d, ln, tables, seeded=seeded,
                                                                  nullable=nl)
            want["flags", seeded] = SP.sparse_flags_plain(d, ln, tables, seeded=seeded)
        want_rev = SP.sparse_reverse_plain(d, ln, tables)
        n = R // 3
        live = torch.tensor([n], dtype=torch.int32, device=dev)
        walk_forms = [f for f in forms if f == "global" or SP.table_form(tables) == "shared"]
        rev_forms = [f for f in forms if f == "global" or SP.table_form(tables, "walk_r") == "shared"]
        for form in walk_forms:
            for key, w in want.items():
                if key[0] == "stats":
                    got = SP.sparse_stats(d, ln, tables, seeded=key[1], nullable=key[2], form=form)
                    compare("rrx_sparse_stats", got, w, f"{tag} {form} seeded={key[1]} "
                            f"nullable={key[2]}")
                elif key[0] == "flags":
                    compare("rrx_sparse_flags", [SP.sparse_flags(d, ln, tables, seeded=key[1],
                                                                 form=form)], [w],
                            f"{tag} {form} seeded={key[1]}", ("flags",))
            for wm in (-1, 128):
                got = SP.sparse_stats(d, ln, tables, seeded=True, nullable=False, form=form,
                                      walk_max=wm)
                compare("rrx_sparse_stats", got, want["stats", True, False],
                        f"{tag} {form} walk_max={wm}")
            got = SP.sparse_stats(d, ln, tables, seeded=True, nullable=False, live=live, form=form)
            compare("rrx_sparse_stats", [x[:n] for x in got],
                    [x[:n] for x in want["stats", True, False]], f"{tag} {form} live={n}")
            got = SP.sparse_flags(d, ln, tables, seeded=False, live=live, form=form)
            compare("rrx_sparse_flags", [got[:, : n * tables.C]],
                    [want["flags", False][:, : n * tables.C]], f"{tag} {form} live={n}", ("flags",))
        for form in rev_forms:
            for wm in (-1, SP.WALK_MAX, 128):
                compare("rrx_sparse_reverse", [SP.sparse_reverse(d, ln, tables, form=form,
                                                                 walk_max=wm)],
                        [want_rev], f"{tag} {form} walk_max={wm}", ("hits",))
            got = SP.sparse_reverse(d, ln, tables, live=live, form=form)
            compare("rrx_sparse_reverse", [got[:, :n]], [want_rev[:, :n]],
                    f"{tag} {form} live={n}", ("hits",))
        return int(want["stats", True, False][0].sum().item())

    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0
    seen_forms, seen_u = set(), 0
    seen_nj = set()
    for pattern in SPARSE_PATTERNS + SPARSE_WIDE:
        prog = compile_program(pattern)
        tables = SP.device_sparse_tables(prog, dev)
        auto = SP.table_form(tables)
        seen_forms.add(auto)
        seen_nj.add(-(-tables.W // 32))
        seen_u += int(prog.sparse_partition[3].sum())
        L = 1024 if pattern == CONFIG10 else 512
        data, lengths = sparse_batch(pattern, 192, L)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        forms = ("shared", "global") if SP.table_form(tables, "walk_r") == "shared" else ("global",)
        ends = check_sparse(tables, d, ln, f"{pattern[:40]!r} R=192 L={L}", prog.nullable, forms)
        n_cmp += 1
        print(f"  {pattern[:40]!r}: {prog.n_states} states, W = {tables.W}, "
              f"{len(prog.sparse_partition[0])} partial and {int(prog.sparse_partition[3].sum())} "
              f"full blocks, auto form {auto} (reverse {SP.table_form(tables, 'walk_r')}): "
              f"{ends} seeded match ends")
    if seen_nj != {1, 2, 3, 4}:
        fail(f"the container programs took {sorted(seen_nj)} state words a lane, not 1-4")
    # a hand-built partition (on x[ab]{0,400}c's 4 x 4 blocks): random
    # partial blocks, full blocks on and off the diagonal, a source block
    # that feeds both
    prog = compile_program("x[ab]{0,400}c")
    rh = np.random.default_rng(21)
    pbh = (rh.random((5, 128, 128)) < 0.02).astype(np.uint8)
    prow_h, pcol_h = np.array([0, 0, 1, 2, 3], np.int32), np.array([0, 1, 1, 3, 2], np.int32)
    U_h = np.zeros((4, 4), np.uint8)
    U_h[0, 2] = U_h[1, 1] = U_h[3, 0] = 1
    prog._spart = (pbh, prow_h, pcol_h, U_h)
    tables = SP.device_sparse_tables(prog, dev)
    data, lengths = sparse_batch("x[ab]{0,400}c", 192, 512)
    d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
    check_sparse(tables, d, ln, "hand-built partition", False, ("shared", "global"))
    # the same with one accept channel per block (a random tenth of its
    # states), so that every block's states reach an output
    amap_h = (rh.random((512, 4)) < 0.1) & (np.arange(512)[:, None] // 128 == np.arange(4))
    tables = SP.device_sparse_tables(prog, dev, accept_map=amap_h.astype(np.uint8))
    check_sparse(tables, d, ln, "hand-built partition, a channel per block", False,
                 ("shared", "global"))
    n_cmp += 2
    seen_u += int(U_h.sum())
    # accept channels: 2 (config 10 with cat|dog), 40 and 100 keywords
    for pats in SPARSE_SETS:
        set_config(get_config().with_(bitband=False))
        try:
            mp = MultiPattern(pats, dev)
        finally:
            set_config(base_cfg)
        if not isinstance(mp.engine.device_scanner, SP.SparseScanner):
            fail(f"MultiPattern of {len(pats)} routed to {type(mp.engine.device_scanner).__name__}")
        tables = mp.engine.device_scanner.tables
        words = [p.encode() for p in pats if "{" not in p]
        data, lengths = edge_batch(rng, np, 192, 512, b"abcdefghijklmnoprstuwxy ")
        for i in range(8, 192, 2):
            for _ in range(3):
                # config 10's channel: 420 copies of (ab|c) in 452 bytes
                w = (words[int(rng.integers(len(words)))] if len(pats) > 2
                     else b"x" + b"ab" * 30 + b"c" * 390 + b"y")
                at = int(rng.integers(0, 512 - len(w) + 1))
                data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        ends = check_sparse(tables, d, ln, f"MultiPattern of {len(pats)}", False,
                            ("shared", "global"))
        n_cmp += 1
        print(f"  MultiPattern of {len(pats)} ({mp.program.n_states} states, C = {tables.C}): "
              f"{ends} seeded channel match ends")
    torch.cuda.synchronize()
    for name in SPARSE_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if seen_forms != {"shared", "global"} or seen_u == 0:
        fail(f"the container programs took forms {seen_forms} and {seen_u} full blocks")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of 192 records through the three "
          f"container kernels (stats seeded/unseeded/nullable, flags seeded/unseeded, reverse, "
          f"live records; shared and global table forms, {seen_u} full blocks, C = 1, 2, 4, 40, "
          f"100 (reverse on the accept set); both register steps at 1-4 state words a lane, "
          f"walk_max -1, {SP.WALK_MAX} and 128) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the four stream-fed kernels on 1 MB batches (1024 records of 1024 B):
    # W = 1, 2, 4, 8 (one thread per record), 12, 16 and 32 (one warp per
    # record), nullable and anchored programs, P = 3 accept channels
    def stream_batch(R: int, L: int):
        """wide_batch's keyword runs and chains, with NFA_PLANTS and a-runs of
        1-400 bytes in other records."""
        data, lengths = wide_batch(R, L)
        for i in range(9, R, 4):
            w = (b"a" * int(rng.integers(1, 401)) if i % 8 == 1
                 else NFA_PLANTS[int(rng.integers(len(NFA_PLANTS)))])[:L]
            at = int(rng.integers(0, L - len(w) + 1))
            data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
        return data, lengths

    def check_stream(nfa, tabs, d, ln, tag, *, nullable):
        """Each stream kernel against its plain version on one batch; returns
        the records with a seeded match end."""
        SP = scan_packed
        words = SP.mask_stream_from_bytes(tabs, d, ln)
        st = torch.from_numpy(rng.integers(-1, d.shape[1], size=d.shape[0]).astype(np.int32)).to(dev)
        st[::5] = 0
        for seeded in (True, False):
            kw = dict(seeded=seeded, nullable=nullable)
            got = SP.match_stats(nfa, words, ln, **kw)
            compare("rrx_stream_stats", got, SP.match_stats_plain(nfa, words, ln, **kw),
                    f"{tag} {kw}", ("cnt", "first", "any"))
            if seeded:
                hits = int((got[0] > 0).sum())
            if not nfa.channels:
                compare("rrx_stream_flags", [SP.forward_flags(nfa, words, seeded=seeded)],
                        [SP.forward_flags_plain(nfa, words, seeded=seeded)],
                        f"{tag} seeded={seeded}", ("flags",))
        if nfa.channels:
            return hits
        compare("rrx_stream_reverse", [SP.reverse_hits(nfa, words)],
                [SP.reverse_hits_plain(nfa, words)], tag, ("hits",))
        for longest in (False, True):
            compare("rrx_stream_first_end",
                    [SP.first_end_from(nfa, words, ln, st, longest=longest)],
                    [SP.first_end_plain(nfa, words, ln, st, longest=longest)],
                    f"{tag} longest={longest}", ("end",))
        return hits

    t0 = time.perf_counter()
    before = launches()
    words_s = set()
    n_cmp = 0
    for pattern in STREAM_PATTERNS:
        prog = compile_program(pattern)
        tabs = scan_packed.packed_tables(prog, dev)
        words_s.add(tabs["Wt"])
        data, lengths = stream_batch(1024, 1024)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        hits = check_stream(tabs["nfa"], tabs, d, ln, f"{pattern[:40]!r}", nullable=prog.nullable)
        n_cmp += 1
        print(f"  stream kernels, {pattern[:40]!r} (s_tile {prog.s_tile}, W = {tabs['Wt']}): "
              f"{hits} records with a seeded match end")
    for pats in STREAM_SETS:
        mp = MultiPattern(pats, dev)
        tabs = scan_packed.packed_tables(mp.program, dev, mp.accept_map, len(pats))
        data, lengths = stream_batch(1024, 1024)
        data[8::7, :7] = np.frombuffer(b"cat 123", np.uint8)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        hits = check_stream(tabs["nfa"], tabs, d, ln, f"MultiPattern of {len(pats)}",
                            nullable=False)
        n_cmp += 1
        print(f"  stream stats, MultiPattern of {len(pats)} (s_tile {mp.program.s_tile}, P = "
              f"{tabs['nfa'].P}): {hits} seeded channel hits")
    torch.cuda.synchronize()
    for name in STREAM_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if not {1, 2, 4, 8, 12, 16, 32} <= words_s:
        fail(f"stream comparisons covered W = {sorted(words_s)}")
    print(f"phase 2: kernel == plain on the card, {n_cmp} 1 MB batches through the four stream "
          f"kernels (W = {sorted(words_s)}; stats seeded/unseeded/nullable/P = 3, flags "
          f"seeded/unseeded, reverse, first end lazy/longest from -1, 0 and random starts) "
          f"({time.perf_counter() - t0:.1f}s)")

    # the slotted multi-pattern SWAR kernel: 5 sets (P = 1..4; ^, $ and
    # nullable members) on edge batches with the sets' matches planted (at
    # byte 0 in every fourth record, where unseeded scans match), seeded and
    # unseeded
    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0
    set_config(base_cfg.with_(swar_multi=True))  # RRX_SWAR_MULTI=1
    try:
        multi_scanners = [MultiPattern(pats, dev).engine.device_scanner for pats in SWAR_MULTI_SETS]
    finally:
        set_config(base_cfg)
    n_ends = []
    for pats, sc in zip(SWAR_MULTI_SETS, multi_scanners):
        if not isinstance(sc, scan_swar.SwarMultiScanner):
            fail(f"MultiPattern {pats} with RRX_SWAR_MULTI=1 routed to {type(sc).__name__}")
        ends = 0
        for R, L in ((1000, 61), (1024, 64), (4096, 256)):
            data, lengths = edge_batch(rng, np, R, L, b"catdoger0123 abcdex$^")
            for i in range(8, R, 2):
                w = MP_PLANTS[int(rng.integers(len(MP_PLANTS)))][:L]
                at = 0 if i % 4 == 0 else int(rng.integers(0, L - len(w) + 1))
                data[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
            d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
            for seeded in (True, False):
                got = scan_swar.swar_multi_stats(d, ln, sc.tables, seeded=seeded)
                compare("rrx_swar_multi_stats", got,
                        scan_swar.swar_multi_stats_plain(d, ln, sc.tables, seeded=seeded),
                        f"{pats} R={R} L={L} seeded={seeded}")
                ends += int(got[0].sum())
            n_cmp += 1
        n_ends.append(ends)
    torch.cuda.synchronize()
    if launches()["rrx_swar_multi_stats"] <= before["rrx_swar_multi_stats"]:
        fail("rrx_swar_multi_stats: launch count did not rise in the comparison")
    print(f"phase 2: kernel == plain on the card, {n_cmp} batches of {len(SWAR_MULTI_SETS)} slotted "
          f"sets (P = {[len(p) for p in SWAR_MULTI_SETS]}) through rrx_swar_multi_stats, seeded "
          f"and unseeded ({n_ends} match ends) ({time.perf_counter() - t0:.1f}s)")

    # the three stream-fed container kernels: K120, config 13, a nullable
    # program, a full U block, the 120-block cap (global form) and config 10
    # (BitbandScanner's container tables), on edge batches with the
    # programs' chains planted, over their mask streams; each form the table
    # fits (shared and global), stats seeded/unseeded/nullable, flags
    # seeded/unseeded, reverse, and each output against the byte kernels'
    # on the same records
    def check_sparse_stream(tables, prog, d, ln, tag, forms):
        words = scan_packed.mask_stream_from_bytes(scan_packed.stream_tables(prog, dev), d, ln)
        plain, byte = {}, {}
        for seeded in (True, False):
            for nl in ((False, True) if prog.nullable else (False,)):
                plain["stats", seeded, nl] = SP.sparse_stream_stats_plain(
                    tables, words, ln, seeded=seeded, nullable=nl)
                c_, f_, _, _ = SP.sparse_stats(d, ln, tables, seeded=seeded, nullable=nl)
                byte["stats", seeded, nl] = (c_[:, 0], f_[:, 0], c_[:, 0] > 0)
            plain["flags", seeded] = SP.sparse_stream_flags_plain(tables, words, seeded=seeded)
            byte["flags", seeded] = SP.sparse_flags(d, ln, tables, seeded=seeded)
        plain["reverse"] = SP.sparse_stream_reverse_plain(tables, words)
        byte["reverse"] = SP.sparse_reverse(d, ln, tables)
        for form in forms:
            for key, want in plain.items():
                if key[0] == "stats":
                    got = SP.sparse_stream_stats(tables, words, ln, seeded=key[1], nullable=key[2],
                                                 form=form)
                    name, labels = "rrx_sparse_stream_stats", ("cnt", "first", "any")
                    kt = f"{tag} {form} seeded={key[1]} nullable={key[2]}"
                else:
                    got = [SP.sparse_stream_flags(tables, words, seeded=key[1], form=form)
                           if key[0] == "flags" else SP.sparse_stream_reverse(tables, words, form=form)]
                    want = [want]
                    name = ("rrx_sparse_stream_flags" if key[0] == "flags"
                            else "rrx_sparse_stream_reverse")
                    labels = (key[0],)
                    kt = f"{tag} {form} {key}"
                compare(name, got, want, kt, labels)
                for label, x, y in zip(labels, got, byte[key] if key[0] == "stats" else [byte[key]],
                                       strict=True):
                    if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                        fail(f"{name} {kt} {label}: the stream-fed result != the byte path's")
        return int(plain["stats", True, False][0].sum().item())

    t0 = time.perf_counter()
    before = launches()
    n_cmp = 0
    seen_forms = set()
    for pattern in SPARSE_STREAM_PATTERNS:
        tables_prog = compile_program(pattern)
        if pattern == CONFIG10:
            bsc = ScanEngine(tables_prog, device=dev).device_scanner
            if not isinstance(bsc, scan_bitband.BitbandScanner):
                fail(f"config 10 routed to {type(bsc).__name__}")
            tables = bsc._stream_tables()
            R_s, L_s = 64, 1024
        else:
            tables = SP.device_sparse_tables(tables_prog, dev)
            R_s, L_s = 128, 384
        auto = SP.table_form(tables)
        forms = ("shared", "global") if auto == "shared" else ("global",)
        seen_forms.update(forms)
        data, lengths = sparse_batch(pattern, R_s, L_s)
        d, ln = torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)
        ends = check_sparse_stream(tables, tables_prog, d, ln, f"{pattern[:40]!r} R={R_s} L={L_s}",
                                   forms)
        n_cmp += 1
        print(f"  stream-fed container kernels, {pattern[:40]!r} ({tables_prog.n_states} states, "
              f"W = {tables.W}, auto form {auto}): {ends} seeded match ends")
    torch.cuda.synchronize()
    for name in SPARSE_STREAM_KERNELS:
        if launches()[name] <= before[name]:
            fail(f"{name}: launch count did not rise in the comparison")
    if seen_forms != {"shared", "global"}:
        fail(f"the stream-fed container comparisons took forms {seen_forms}")
    print(f"phase 2: kernel == plain == the byte kernels on the card, {n_cmp} batches through the "
          f"three stream-fed container kernels (stats seeded/unseeded/nullable, flags "
          f"seeded/unseeded, reverse; shared and global table forms) "
          f"({time.perf_counter() - t0:.1f}s)")

    # -- phase 3: the match-stats path (counts from here to its 1 GiB run) --
    import bench

    reset_launches()
    data, lengths = bench.make_corpus(10_000_000, 1024, seed=0)
    B0 = data.shape[0]
    G = compile_program("cat|dog").G
    pad = -B0 % G
    data_p = np.pad(data, ((0, pad), (0, 0)))
    lengths_p = np.pad(lengths, (0, pad))
    eng = ScanEngine(compile_program("cat|dog"), device=dev)
    win = eng.device_scanner._swar_window(data_p.shape[1], data_p.shape[0], True)
    if win != (4, 256, 3):
        fail(f"config 1 window route {win}, expected (4, 256, 3)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt, first, anym = eng.match_stats(data_p, lengths_p, seeded=True)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    cnt, first, anym = (x.cpu().numpy()[:B0] for x in (cnt, first, anym))
    hits = np.zeros(data.shape, bool)  # hits[r, j]: a match ends after byte j
    for word in (b"cat", b"dog"):
        w = np.frombuffer(word, np.uint8)
        hits[:, 2:] |= (data[:, :-2] == w[0]) & (data[:, 1:-1] == w[1]) & (data[:, 2:] == w[2])
    want_cnt = hits.sum(axis=1)
    want_first = np.where(hits.any(axis=1), hits.argmax(axis=1) + 1, -1)
    if not (np.array_equal(cnt, want_cnt) and np.array_equal(first, want_first)
            and np.array_equal(anym, want_cnt > 0)):
        fail("config 1 (cnt, first, any) disagree with the numpy count")
    print(f"phase 3: config 1 cat|dog, {B0} records x 1024 B, window route {win}: "
          f"matches={int(cnt.sum())} records_with_match={int(anym.sum())} == numpy count "
          f"(first call {first_call_s * 1e3:.1f} ms)")

    def sample(seed, n, maxlen, alphabet, plants):
        r = np.random.default_rng(seed)
        a = np.frombuffer(alphabet, np.uint8)
        out = []
        for _ in range(n):
            t = bytearray(r.choice(a, size=int(r.integers(0, maxlen + 1))).tobytes())
            if r.random() < 0.5:
                w = plants[int(r.integers(len(plants)))]
                at = int(r.integers(0, len(t) + 1))
                t[at:at] = w
            out.append(bytes(t))
        return out

    c2, _ = bench.make_corpus(2000 * 256, 256, seed=2, plant=(b"x" * 250 + b"ab.log",))
    cuts = np.random.default_rng(3).integers(200, 257, size=c2.shape[0])
    samples = {
        "[a-z]+\\.log$": [bytes(row[:k]) for row, k in zip(c2, cuts)]
        + [bytes(row) for row in c2[:200]],
        "(ab)*c+d?": sample(4, 2000, 40, b"abcdx", [b"ababccd", b"abc", b"ccc", b"abd"]),
        "^[a-z]{3,8}[.]log$": sample(5, 2000, 10, b"abcxyz.", [b".log", b"abcd.log"]),
    }
    api_batches = []
    for pattern, texts in samples.items():
        pat = rrx_compile(pattern, dev)
        api_batches.append((pat, texts))
        rx = re.compile(pattern.encode())
        got_s = pat.search_batch(texts)
        got_f = pat.fullmatch_batch(texts)
        want_s = np.array([rx.search(t) is not None for t in texts])
        want_f = np.array([rx.fullmatch(t) is not None for t in texts])
        if not (np.array_equal(got_s, want_s) and np.array_equal(got_f, want_f)):
            fail(f"{pattern!r}: search/fullmatch disagree with re")
        print(f"phase 3: {pattern!r} ({type(pat.engine.device_scanner).__name__}) on "
              f"{len(texts)} records: search {int(got_s.sum())} / fullmatch "
              f"{int(got_f.sum())} hits == re")

    R, L = 1 << 20, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    big = torch.randint(ord("a"), ord("z") + 1, (R, L), dtype=torch.uint8, device=dev, generator=gen)
    prng = np.random.default_rng(6)
    for word in (b"cat", b"dog"):
        rows = torch.from_numpy(prng.integers(0, R, size=R // 8)).to(dev)
        cols = torch.from_numpy(prng.integers(0, L - 3, size=R // 8)).to(dev)
        for i, ch in enumerate(word):
            big[rows, cols + i] = ch
    big_len = torch.full((R,), L, dtype=torch.int32, device=dev)
    if eng.device_scanner._swar_window(L, R, True) is not None:
        fail("1 GiB batch should not window")
    bcnt, bfirst, bany = eng.match_stats(big, big_len, seeded=True)
    torch.cuda.synchronize()
    stats_launches = {name: launches()[name] for name in entries}
    for name, n in stats_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the match-stats path")
    print(f"match-stats path launches: {stats_launches}")
    nbytes = R * L
    print(f"phase 3: cat|dog over {R} records x {L} B ({nbytes} bytes): "
          f"matches={int(bcnt.sum().item())} records_with_match={int(bany.sum().item())}")

    # -- phase 4: the span path (counts from here to the end of its API run)
    reset_launches()
    rx = re.compile(b"cat|dog")
    want7 = [[m.span() for m in rx.finditer(bytes(row))] for row in data]
    cap7 = 32
    spans7 = {}
    for policy in ("lazy", "greedy"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if policy == "lazy":
            s7, e7, c7 = eng.lazy_spans(data_p, lengths_p, cap=cap7)
            o7 = torch.zeros_like(c7, dtype=torch.bool)
        else:
            s7, e7, c7, o7 = eng.greedy_spans(data_p, lengths_p, cap=cap7)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        s7, e7, c7, o7 = (x.cpu().numpy()[:B0] for x in (s7, e7, c7, o7))
        if c7.max() > cap7 or o7.any():
            fail(f"config 7 {policy}: more spans than cap {cap7}")
        got7 = [list(zip(s7[i, : c7[i]].tolist(), e7[i, : c7[i]].tolist())) for i in range(B0)]
        bad = [i for i in range(B0) if got7[i] != want7[i]]
        if bad:
            i = bad[0]
            fail(f"config 7 {policy}: {len(bad)} records differ from re.finditer, "
                 f"record {i}: {got7[i][:5]} != {want7[i][:5]}")
        spans7[policy] = got7
        print(f"phase 4: config 7 cat|dog {policy} spans (cap {cap7}), {B0} records x 1024 B: "
              f"{int(c7.sum())} spans, at most {int(c7.max())} per record, == re.finditer "
              f"(first call {call_ms:.1f} ms)")

    texts = sample(7, 2000, 256, b"abcx0123456789d",
                   [b"aaaa", b"ababab", b"abc", b"x12", b"cat", b"dog", b"acb", b"a.b"])
    n_api = 0
    for pattern, lazy_form in RE_SAFE.items():
        pat = rrx_compile(pattern, dev)
        if not isinstance(pat.engine.device_scanner, scan_swar.SwarScanner):
            fail(f"{pattern!r} should take the SWAR tier")
        for longest, form in ((True, pattern), (False, lazy_form)):
            rxp = re.compile(form.encode())
            got = pat.finditer_batch(texts, longest=longest)
            want = [[m.span() for m in rxp.finditer(t)] for t in texts]
            if got != want:
                i = next(i for i in range(len(texts)) if got[i] != want[i])
                fail(f"{pattern!r} finditer_batch(longest={longest}) != re {form!r} at "
                     f"text {i}: {got[i][:5]} != {want[i][:5]}")
            n_api += 1
        rxl = re.compile(lazy_form.encode())
        for t in texts[:50]:
            for fn, ref in ((pat.search, rxl.search), (pat.match, rxl.match)):
                a, b = fn(t), ref(t)
                if (a is None) != (b is None) or (a is not None and a.span() != b.span()):
                    fail(f"{pattern!r} {fn.__name__}({t!r}) = {a and a.span()} != re "
                         f"{lazy_form!r} {b and b.span()}")
    for pattern in ("cat|dog", "a.b"):
        rxp = re.compile(pattern.encode())
        if rrx_compile(pattern, dev).finditer_batch(texts) != [
                [m.span() for m in rxp.finditer(t)] for t in texts]:
            fail(f"{pattern!r} lazy finditer_batch != re")
        n_api += 1
    for pattern in ("a+", "a|ab"):
        if rrx_compile(pattern, dev).finditer_batch(texts) != rrx_compile(pattern, "cpu").finditer_batch(texts):
            fail(f"{pattern!r} lazy finditer_batch on the card != the plain version")
        n_api += 1
    # C1: a lazy span that ends at the EOS step, then the empty match at len
    # (every match of these ends at len, so re's spans are the lazy ones)
    c1_texts = [t[:40] for t in texts[:500]] + [b"a", b"ab", b"b", b"", b"xab"]
    for pattern in C1_SWAR:
        pat = rrx_compile(pattern, dev)
        if not isinstance(pat.engine.device_scanner, scan_swar.SwarScanner):
            fail(f"{pattern!r} should take the SWAR tier")
        rxp = re.compile(pattern.encode())
        got = pat.finditer_batch(c1_texts)
        want = [[m.span() for m in rxp.finditer(t)] for t in c1_texts]
        if got != want:
            i = next(i for i in range(len(c1_texts)) if got[i] != want[i])
            fail(f"C1 {pattern!r} lazy finditer_batch != re.finditer at {c1_texts[i]!r}: "
                 f"{got[i]} != {want[i]}")
        n_api += 1
    torch.cuda.synchronize()
    span_launches = launches()
    for name in SPAN_KERNELS:
        if span_launches[name] <= 0:
            fail(f"{name} was not launched on the span path")
    print(f"phase 4: span API on {len(texts)} records of <= 264 B: {n_api} finditer_batch "
          f"checks against re and the plain version, search/match on 50 texts x "
          f"{len(RE_SAFE)} patterns against re")
    print(f"span path launches: {span_launches}")

    # -- phase 5: the matmul-tier path (counts from here to its API run) ---
    reset_launches()
    keyed = {K7: K7_WORDS, K30: K30_WORDS}
    t0 = time.perf_counter()
    log_np = log_text(np, 8, R, L, K30_WORDS)
    log = torch.from_numpy(log_np).to(dev)
    log_len = torch.full((R,), L, dtype=torch.int32, device=dev)
    print(f"phase 5: 1 GiB log text, {R} records x {L} B, one of {len(K30_WORDS)} keywords in "
          f"every second record (numpy seed 8; built in {time.perf_counter() - t0:.1f}s)")
    n_slice = 16_384  # plain-version slice of the 1 GiB batch
    n_re = 3000
    nfa_engines = {}
    for pattern, words in keyed.items():
        eng_k = ScanEngine(compile_program(pattern), device=dev)
        sc_k = eng_k.device_scanner
        if type(sc_k).__name__ != "PallasScanner":
            fail(f"{pattern[:30]!r}... routed to {type(sc_k).__name__}")
        nfa_engines[pattern] = eng_k
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cnt_k, first_k, any_k = eng_k.match_stats(log, log_len, seeded=True)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t1) * 1e3
        want = scan_pallas.stats_plain(log[:n_slice], log_len[:n_slice], sc_k.nfa, seeded=True,
                                       lead=0, nullable=False)
        if not (torch.equal(cnt_k[:n_slice], want[0]) and torch.equal(first_k[:n_slice], want[1])):
            fail(f"{pattern[:30]!r}... 1 GiB stats != plain on the first {n_slice} records")
        rows = np.random.default_rng(9).choice(R, size=n_re, replace=False)
        got = np.stack([cnt_k.cpu().numpy()[rows], first_k.cpu().numpy()[rows]], axis=1)
        ref = np.array([key_stats(words, log_np[r].tobytes()) for r in rows])
        if not np.array_equal(got, ref):
            i = int(np.nonzero((got != ref).any(axis=1))[0][0])
            fail(f"{pattern[:30]!r}... record {rows[i]}: (cnt, first) {got[i]} != re {ref[i]}")
        if not torch.equal(any_k, cnt_k > 0):
            fail(f"{pattern[:30]!r}... any != cnt > 0")
        print(f"phase 5: {len(words)}-keyword alternation ({eng_k.prog.n_states} states, s_tile "
              f"{eng_k.prog.s_tile}) over 1 GiB: matches={int(cnt_k.sum().item())} "
              f"records_with_match={int(any_k.sum().item())}; == plain on {n_slice} records, == re "
              f"on {n_re} (first call {call_ms:.1f} ms)")

    B7 = data_p.shape[0]  # config 7's shape: 9,776 records x 1,024 B
    log10 = log[:B7].contiguous()
    len10 = log_len[:B7].contiguous()
    cap_k = 32
    for pattern, words in keyed.items():
        rxk = re.compile(pattern.encode())
        want_k = [[m.span() for m in rxk.finditer(log_np[i].tobytes())] for i in range(B7)]
        for policy in ("lazy", "greedy"):
            eng_k = nfa_engines[pattern]
            if policy == "lazy":
                sk, ek, ck = eng_k.lazy_spans(log10, len10, cap=cap_k)
                ok = torch.zeros_like(ck, dtype=torch.bool)
            else:
                sk, ek, ck, ok = eng_k.greedy_spans(log10, len10, cap=cap_k)
            sk, ek, ck, ok = (x.cpu().numpy() for x in (sk, ek, ck, ok))
            if ck.max() > cap_k or ok.any():
                fail(f"{pattern[:30]!r}... {policy}: more spans than cap {cap_k}")
            got_k = [list(zip(sk[i, : ck[i]].tolist(), ek[i, : ck[i]].tolist())) for i in range(B7)]
            bad = [i for i in range(B7) if got_k[i] != want_k[i]]
            if bad:
                i = bad[0]
                fail(f"{pattern[:30]!r}... {policy} spans: {len(bad)} records differ from "
                     f"re.finditer, record {i}: {got_k[i][:4]} != {want_k[i][:4]}")
            print(f"phase 5: {len(words)}-keyword {policy} spans (cap {cap_k}), {B7} records x "
                  f"{L} B: {int(ck.sum())} spans, at most {int(ck.max())} per record, == "
                  f"re.finditer")

    texts_k = []
    cuts = np.random.default_rng(10).integers(0, 257, size=2000)
    for i, row in enumerate(log_text(np, 10, 2000, 256, K30_WORDS)):
        if i % 5 == 0:
            t = K30_WORDS[i % len(K30_WORDS)].encode()  # whole-record keywords
        elif i % 11 == 0:
            t = b"POST /var/log/x_1.log HTTP/1.0" if i % 22 else b"GET / HTTP/1.1"
        elif i % 7 == 0:
            t = b"timeout " + row[: cuts[i]].tobytes()
        else:
            t = row[: cuts[i]].tobytes()
        texts_k.append(t)
    n_api_k = 0
    for pattern in (K7, K30, HTTP):
        pat = rrx_compile(pattern, dev)
        if type(pat.engine.device_scanner).__name__ != "PallasScanner":
            fail(f"{pattern[:30]!r}... should take the matmul tier")
        rxk = re.compile(pattern.encode())
        checks = {
            "search_batch": (pat.search_batch(texts_k).tolist(),
                             [rxk.search(t) is not None for t in texts_k]),
            "fullmatch_batch": (pat.fullmatch_batch(texts_k).tolist(),
                                [rxk.fullmatch(t) is not None for t in texts_k]),
        }
        if pattern in keyed:
            checks["count_batch"] = (pat.count_batch(texts_k).tolist(),
                                     [key_stats(keyed[pattern], t)[0] for t in texts_k])
            want_sp = [[m.span() for m in rxk.finditer(t)] for t in texts_k]
            for longest in (False, True):
                checks[f"finditer_batch(longest={longest})"] = (
                    pat.finditer_batch(texts_k, longest=longest), want_sp)
        for name, (got, want) in checks.items():
            if got != want:
                i = next(i for i in range(len(texts_k)) if got[i] != want[i])
                fail(f"{pattern[:30]!r}... {name} != re at text {i}: {got[i]} != {want[i]}")
            n_api_k += 1
        for t in texts_k[:60]:
            for fn, refn in ((pat.search, rxk.search), (pat.match, rxk.match)):
                a, b = fn(t), refn(t)
                if (a is None) != (b is None) or (a is not None and a.span() != b.span()):
                    fail(f"{pattern[:30]!r}... {fn.__name__}({t[:40]!r}) = {a and a.span()} != "
                         f"re {b and b.span()}")
    word_texts = sample(11, 2000, 64, b"abcdefgh",
                        [b"abeefgh", b"cdcdeeefgh", b"ababcdeeefghabeefgh"])
    # nullable greedy spans take one round per span, every position a start:
    # short texts keep the plain version's rounds few
    null_texts = [t[:48] for t in texts_k[:300]] + sample(12, 300, 40, b"catdogx",
                                                          [b"catdog", b"dogdogcat"])
    for pattern, longest in (("(ab|cd)+e{2,3}fgh", False), ("(ab|cd)+e{2,3}fgh", True),
                             ("(cat|dog)*", True), (K7 + "*", True)):
        pat = rrx_compile(pattern, dev)
        texts_p = word_texts if "fgh" in pattern else null_texts
        got = pat.finditer_batch(texts_p, longest=longest)
        if got != rrx_compile(pattern, "cpu").finditer_batch(texts_p, longest=longest):
            fail(f"{pattern[:30]!r} finditer_batch(longest={longest}) on the card != plain")
        n_api_k += 1
    # C1 on the matmul tier: [a-c]{0,40}$ (a 42-state tile)
    pat = rrx_compile(C1_NFA, dev)
    if type(pat.engine.device_scanner).__name__ != "PallasScanner":
        fail(f"{C1_NFA!r} should take the matmul tier")
    c1_texts_k = [t[:60] for t in texts_k[:500]] + [b"abc", b"a", b"xabc", b""]
    rxp = re.compile(C1_NFA.encode())
    if pat.finditer_batch(c1_texts_k) != [[m.span() for m in rxp.finditer(t)] for t in c1_texts_k]:
        fail(f"C1 {C1_NFA!r} lazy finditer_batch != re.finditer")
    n_api_k += 1
    torch.cuda.synchronize()
    nfa_launches = launches()
    for name in NFA_KERNELS:
        if nfa_launches[name] <= 0:
            fail(f"{name} was not launched on the matmul-tier path")
    print(f"phase 5: matmul-tier API on {len(texts_k)} records of <= 264 B: {n_api_k} batch "
          f"checks against re and the plain version (u32-word spans, nullable greedy spans), "
          f"search/match on 60 texts x 3 patterns against re")
    print(f"matmul-tier path launches: {nfa_launches}")

    # -- phase 6: the counting tier, the bitmaps and the seeded alias ------
    reset_launches()
    t6 = time.perf_counter()

    def a_runs(d: np.ndarray, ln: np.ndarray, m: int, n: int):
        """numpy run-length reference of the seeded a{m,n}: (count of match
        ends, first end or -1, whole record matches). A match ends after
        byte j iff the run of a's ending at j is at least max(m, 1) long."""
        live = (d == ord("a")) & (np.arange(d.shape[1])[None, :] < ln[:, None])
        run = np.zeros(d.shape[0], np.int64)
        ends = np.zeros(d.shape, bool)
        for j in range(d.shape[1]):
            run = np.where(live[:, j], run + 1, 0)
            ends[:, j] = run >= max(m, 1)
        cnt = ends.sum(axis=1)
        first = np.where(ends.any(axis=1), ends.argmax(axis=1) + 1, -1)
        full = (live.sum(axis=1) == ln) & (ln >= m) & ((ln <= n) if n else True)
        return cnt, first, full

    # config 4 at 10 MB: the config-1 corpus (bench.make_corpus(10_000_000,
    # 1024, seed=0)), unwindowed
    eng4 = ScanEngine(compile_program(CONFIG4), device=dev)
    sc4 = eng4.device_scanner
    if not isinstance(sc4, scan_pallas.CountScanner) or eng4.prog.tier != "multiblock":
        fail(f"config 4 routed to {type(sc4).__name__} on {eng4.prog.tier}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt4, first4, any4 = (x.cpu().numpy() for x in eng4.match_stats(data, lengths, seeded=True))
    call_ms = (time.perf_counter() - t0) * 1e3
    want = a_runs(data, lengths, 1, 300)
    if not (np.array_equal(cnt4, want[0]) and np.array_equal(first4, want[1])
            and np.array_equal(any4, want[0] > 0)):
        fail("config 4 (cnt, first, any) disagree with the numpy run-length count")
    # fullmatch needs records no longer than n = 300: a copy of the corpus
    # whose every fourth record is cut to 0-400 B and filled with a's
    data_f, len_f = data.copy(), lengths.copy()
    fr = np.arange(0, data.shape[0], 4)
    len_f[fr] = fr % 401
    data_f[fr] = np.where(np.arange(data.shape[1])[None, :] < len_f[fr, None], ord("a"), data_f[fr])
    full4 = eng4.fullmatch_flags(data_f, len_f)
    want_f = a_runs(data_f, len_f, 1, 300)[2]
    if want_f.all() or not want_f.any():
        fail("config 4 fullmatch batch should hold both matching and non-matching records")
    if not np.array_equal(full4, want_f):
        fail("config 4 fullmatch disagrees with the numpy run-length reference")
    has_a = (data == ord("a")).any(axis=1)
    st4 = np.where(has_a, (data == ord("a")).argmax(axis=1), -1).astype(np.int32)
    fe4 = eng4.first_end_from(data, lengths, st4).cpu().numpy()
    if not np.array_equal(fe4, np.where(has_a, st4 + 1, -1)):
        fail("config 4 lazy anchored ends from the first a != start + 1")
    print(f"phase 6: config 4 {CONFIG4} ({eng4.prog.n_states} states, {eng4.prog.tier}, "
          f"CountScanner k={sc4.k}), {data.shape[0]} records x 1024 B: matches={int(cnt4.sum())} "
          f"records_with_match={int(any4.sum())} fullmatch={int(full4.sum())} == numpy run-length "
          f"count (fullmatch on a copy with {fr.size} records of 0-400 a's); lazy rescans from the "
          f"first a == start + 1 (first call {call_ms:.1f} ms)")

    # config 4 at 1 GiB: random lowercase (numpy seed 14) with an a-run of
    # 1-400 bytes planted in every second record
    rng4 = np.random.default_rng(14)
    big4 = torch.from_numpy(rng4.integers(ord("a"), ord("z") + 1, size=(R, L), dtype=np.uint8)).to(dev)
    rows4 = torch.from_numpy(rng4.permutation(R)[: R // 2]).to(dev)
    run4 = torch.from_numpy(rng4.integers(1, 401, size=R // 2)).to(dev)
    col4 = (torch.from_numpy(rng4.random(R // 2)).to(dev) * (L - run4 + 1)).to(torch.int64)
    posL = torch.arange(L, device=dev)[None, :]
    for c in range(0, R // 2, 1 << 16):
        r_, s_, e_ = rows4[c : c + (1 << 16)], col4[c : c + (1 << 16)], (col4 + run4)[c : c + (1 << 16)]
        big4[r_] = torch.where((posL >= s_[:, None]) & (posL < e_[:, None]), ord("a"), big4[r_])
    # every eighth of the checked records is cut to 1-400 B of a's, so that
    # fullmatch (n = 300) is both true and false there
    len4 = big_len.clone()
    fr4 = torch.arange(0, n_slice, 8, device=dev)
    fl4 = torch.from_numpy(rng4.integers(1, 401, size=fr4.numel())).to(dev)
    big4[fr4] = torch.where(posL < fl4[:, None], ord("a"), big4[fr4])
    len4[fr4] = fl4.to(len4.dtype)
    cb4, fb4, ab4 = eng4.match_stats(big4, len4, seeded=True)
    fullb4 = eng4.fullmatch_flags(big4, len4)
    sub4 = big4[:n_slice].cpu().numpy()
    want = a_runs(sub4, len4[:n_slice].cpu().numpy(), 1, 300)
    if want[2].all() or not want[2].any():
        fail("config 4 1 GiB checked records should hold both full matches and non-matches")
    got = [x[:n_slice].cpu().numpy() for x in (cb4, fb4)]
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and np.array_equal(fullb4[:n_slice], want[2])):
        fail(f"config 4 1 GiB (cnt, first, full) != numpy on the first {n_slice} records")
    plain4 = scan_pallas.count_stats_plain(big4[:n_slice], len4[:n_slice], sc4.tables, seeded=True,
                                           lead=0, nullable=False)
    if not (torch.equal(cb4[:n_slice], plain4[0]) and torch.equal(fb4[:n_slice], plain4[1])):
        fail(f"config 4 1 GiB (cnt, first) != plain on the first {n_slice} records")
    print(f"phase 6: config 4 over {R} records x {L} B with planted a-runs of 1-400 B: "
          f"matches={int(cb4.sum().item())} records_with_match={int(ab4.sum().item())} "
          f"fullmatch={int(fullb4[:n_slice].sum())} of the first {n_slice}; == numpy and == plain "
          f"on the first {n_slice} records")

    # config 13: 1501 states on the sparse tier, its seeded scans through its
    # 6-state seeded alias (the SWAR tier), the rest on its container tier
    # (phase 11)
    t0 = time.perf_counter()
    eng13 = ScanEngine(compile_program(CONFIG13), device=dev)
    alias13 = eng13._seeded_alias()
    compile13_s = time.perf_counter() - t0
    if not isinstance(eng13.device_scanner, scan_sparse.SparseScanner) or alias13 is None:
        fail("config 13 should run its seeded scans through its alias, the rest on containers")
    swar0 = scan_swar.swar_stats.launches
    cnt13, first13, any13 = (x.cpu().numpy() for x in eng13.match_stats(data, lengths, seeded=True))
    ends13 = np.zeros(data.shape, bool)  # ends13[r, j]: abc or de ends after byte j
    ends13[:, 1:] |= (data[:, :-1] == ord("d")) & (data[:, 1:] == ord("e"))
    ends13[:, 2:] |= ((data[:, :-2] == ord("a")) & (data[:, 1:-1] == ord("b"))
                      & (data[:, 2:] == ord("c")))
    if not (np.array_equal(cnt13, ends13.sum(axis=1))
            and np.array_equal(first13, np.where(ends13.any(axis=1), ends13.argmax(axis=1) + 1, -1))):
        fail("config 13 (cnt, first) disagree with the numpy count of abc/de ends")
    c13, f13, a13 = eng13.match_stats(big, big_len, seeded=True)
    rows13 = np.random.default_rng(15).choice(R, size=3000, replace=False)
    big_rows = big[torch.from_numpy(rows13).to(dev)].cpu().numpy()
    rx13 = re.compile(rb"(?=(abc|de))")
    want13 = []
    for row in big_rows:
        e = [m.start() + len(m.group(1)) for m in rx13.finditer(row.tobytes())]
        want13.append((bool(e), min(e) if e else -1))
    got13 = list(zip(a13.cpu().numpy()[rows13].tolist(), f13.cpu().numpy()[rows13].tolist()))
    if got13 != want13:
        fail("config 13 1 GiB (search, first end) != re on 3,000 records")
    print(f"phase 6: config 13 {CONFIG13} ({eng13.prog.n_states} states, {eng13.prog.tier}; built in "
          f"{compile13_s:.1f}s) through its {alias13.prog.n_states}-state alias on "
          f"{type(alias13.device_scanner).__name__} ({scan_swar.swar_stats.launches - swar0} "
          f"rrx_swar_stats launches): 10 MB matches={int(cnt13.sum())} == numpy; 1 GiB "
          f"records_with_match={int(a13.sum().item())}, search and first end == re on 3,000 "
          f"records (fullmatch and greedy spans on its container tier: phase 11)")

    # the bitmaps: ends_batch and starts_batch against every substring re
    # fullmatches, on four tiers
    bm_texts = sample(16, 400, 40, b"abcdgotx",
                      [b"cat", b"dog", b"bird", b"error", b"timeout", b"aaaaa", b"catdogbird"])
    tiers = {"cat|dog": "SwarScanner", "(cat|dog|bird)+": "WordScanner", K7: "PallasScanner",
             CONFIG4: "CountScanner"}
    for pattern, want_sc in tiers.items():
        pat = rrx_compile(pattern, dev)
        if type(pat.engine.device_scanner).__name__ != want_sc:
            fail(f"{pattern[:30]!r} routed to {type(pat.engine.device_scanner).__name__}")
        rxf = re.compile(pattern.encode())
        want_e, want_s = [], []
        for t in bm_texts:
            pairs = [(a, b) for a in range(len(t) + 1) for b in range(a, len(t) + 1)
                     if rxf.fullmatch(t, a, b)]
            want_e.append(sorted({b for _, b in pairs}))
            want_s.append(sorted({a for a, _ in pairs}))
        if pat.ends_batch(bm_texts) != want_e or pat.starts_batch(bm_texts) != want_s:
            fail(f"{pattern[:30]!r} ends_batch/starts_batch != re")
    print(f"phase 6: ends_batch and starts_batch of {len(tiers)} programs (SWAR, u32-word, matmul, "
          f"counting) on {len(bm_texts)} records of <= 50 B == the substrings re fullmatches")

    # spans of counting programs: host rounds over starts_bitmap
    span_texts = sample(17, 600, 200, b"abcdx", [b"aaaa", b"a" * 40, b"abab", b"cdcd",
                                                 b"abcdab" * 8, b"a" * 320])
    n_rounds = 0
    for pattern, lazy_form in ((CONFIG4, "a{1,300}?"), ("(ab|cd){1,400}", "(ab|cd){1,400}?")):
        pat = rrx_compile(pattern, dev)
        for longest, form in ((True, pattern), (False, lazy_form)):
            rxp = re.compile(form.encode())
            got = pat.finditer_batch(span_texts, longest=longest)
            want = [[m.span() for m in rxp.finditer(t)] for t in span_texts]
            if got != want:
                i = next(i for i in range(len(span_texts)) if got[i] != want[i])
                fail(f"{pattern!r} finditer_batch(longest={longest}) != re {form!r} at text {i}: "
                     f"{got[i][:4]} != {want[i][:4]}")
            n_rounds = max(n_rounds, max(len(x) for x in got))
        for t in span_texts[:40]:
            a, b = pat.match(t), re.compile(lazy_form.encode()).match(t)
            if (a is None) != (b is None) or (a is not None and a.span() != b.span()):
                fail(f"{pattern!r} match({t[:30]!r}) = {a and a.span()} != re {b and b.span()}")
    torch.cuda.synchronize()
    count_launches = launches()
    for name in COUNT_KERNELS + ("rrx_nfa_flags",):
        if count_launches[name] <= 0:
            fail(f"{name} was not launched on the counting and bitmap path")
    print(f"phase 6: counting-program spans in host rounds (up to {n_rounds} rounds) on "
          f"{len(span_texts)} records of <= 520 B == re (greedy) and re's lazy quantifier (lazy); "
          f"match on 40 texts == re ({time.perf_counter() - t6:.1f}s for the phase)")
    print(f"counting and bitmap path launches: {count_launches}")

    # -- phase 8: the multi-pattern path (counts from here to its last run) -
    reset_launches()
    t8 = time.perf_counter()
    mp6 = MultiPattern(CONFIG6, dev)
    sc6 = mp6.engine.device_scanner
    if type(sc6).__name__ != "WordScanner" or mp6.P != 4:
        fail(f"config 6 routed to {type(sc6).__name__} with P = {mp6.P}")
    texts6 = [bytes(row) for row in data]  # config 6: bench.make_corpus(10_000_000, 1024, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt6 = mp6.count_batch(texts6)
    count_ms = (time.perf_counter() - t0) * 1e3
    hit6, grep6 = mp6.search_batch(texts6), mp6.grep(texts6)
    t0 = time.perf_counter()
    spans6 = mp6.finditer_batch(texts6)
    spans_ms = (time.perf_counter() - t0) * 1e3

    # config 6 at 1 GiB: random lowercase (torch seed 6) with cat/dog, digit
    # runs, err/error and abe/abcdcde planted (numpy seed 18), so that every
    # channel matches in some records and not in others
    gen6 = torch.Generator(device=dev)
    gen6.manual_seed(6)
    big6 = torch.randint(ord("a"), ord("z") + 1, (R, L), dtype=torch.uint8, device=dev,
                         generator=gen6)
    prng6 = np.random.default_rng(18)
    for word, frac in ((b"cat", 8), (b"dog", 8), (b"123", 8), (b"4567", 16), (b"err", 16),
                       (b"error", 16), (b"abe", 16), (b"abcdcde", 16)):
        rows = torch.from_numpy(prng6.integers(0, R, size=R // frac)).to(dev)
        cols = torch.from_numpy(prng6.integers(0, L - len(word) + 1, size=R // frac)).to(dev)
        for i, ch in enumerate(word):
            big6[rows, cols + i] = ch
    len6 = torch.full((R,), L, dtype=torch.int32, device=dev)
    c6, f6, a6 = (x.reshape(R, 4) for x in mp6.engine.match_stats(big6, len6, seeded=True))
    cap6 = 1 << max(int(c6.max().item()) - 1, 0).bit_length()
    mb6 = sc6.lazy_spans_mb(big6, len6.reshape(-1, max(mp6.program.G, 1)), cap=cap6)

    # K7 as seven patterns over phase 5's 1 GiB log text (matmul tier, P = 7)
    mp7 = MultiPattern(K7_WORDS, dev)
    sc7 = mp7.engine.device_scanner
    if type(sc7).__name__ != "PallasScanner" or mp7.P != 7:
        fail(f"K7 as 7 patterns routed to {type(sc7).__name__} with P = {mp7.P}")
    c7, f7, a7 = (x.reshape(R, 7) for x in mp7.engine.match_stats(log, log_len, seeded=True))
    # C1 per channel: `$` channels whose lazy span ends at the EOS step, then
    # the empty match at len (rrx_nfa_lazy_spans_mb), against re
    mpc1 = MultiPattern(C1_MP, dev)
    c1_texts_mp = c1_texts + [b"cat", b"xcatab"]
    for p_, (pattern, got) in enumerate(zip(C1_MP, mpc1.finditer_batch(c1_texts_mp))):
        rxp = re.compile(pattern.encode())
        if got != [[m.span() for m in rxp.finditer(t)] for t in c1_texts_mp]:
            fail(f"C1 MultiPattern channel {pattern!r}: lazy spans != re.finditer")
    torch.cuda.synchronize()
    mp_launches = launches()
    for name in MP_KERNELS:
        if mp_launches[name] <= 0:
            fail(f"{name} was not launched on the multi-pattern path")
    print(f"multi-pattern path launches: {mp_launches}")

    # config 6 at 10 MB against the single-pattern engines, numpy and re
    B6 = len(texts6)
    dig = (data >= ord("0")) & (data <= ord("9"))
    ends3 = np.zeros(data.shape, bool)
    ends3[:, 2:] = dig[:, :-2] & dig[:, 1:-1] & dig[:, 2:]
    if not (np.array_equal(cnt6[:, 0], want_cnt) and np.array_equal(cnt6[:, 1], ends3.sum(axis=1))):
        fail("config 6 counts of cat|dog / [0-9]{3} != numpy")
    if not (np.array_equal(hit6, cnt6 > 0) and np.array_equal(grep6, hit6)):
        fail("config 6 search_batch / grep != count_batch > 0")
    n_spans = []
    for p, (pat, lazy_form) in enumerate(zip(CONFIG6, CONFIG6_LAZY_RE)):
        single = Pattern(pat, dev)
        if not (np.array_equal(single.count_batch(texts6), cnt6[:, p])
                and np.array_equal(single.search_batch(texts6), hit6[:, p])):
            fail(f"config 6 {pat!r}: count/search != the single-pattern engine")
        if spans6[p] != single.finditer_batch(texts6):
            fail(f"config 6 {pat!r}: lazy spans != the single-pattern Pattern.finditer_batch")
        rxp = re.compile(lazy_form.encode())
        want = [[m.span() for m in rxp.finditer(t)] for t in texts6]
        if spans6[p] != want:
            i = next(i for i in range(B6) if spans6[p][i] != want[i])
            fail(f"config 6 {pat!r}: lazy spans != re {lazy_form!r} at record {i}: "
                 f"{spans6[p][i][:4]} != {want[i][:4]}")
        n_spans.append(sum(len(x) for x in spans6[p]))
    print(f"phase 8: config 6 {CONFIG6} ({mp6.program.n_states} states, s_tile "
          f"{mp6.program.s_tile}, {type(sc6).__name__}, P = 4) on {B6} records x 1024 B: matches "
          f"{cnt6.sum(axis=0).tolist()} records_with_match {hit6.sum(axis=0).tolist()}; count, "
          f"search and grep == the single-pattern engines and numpy (cat|dog, [0-9]{{3}}); lazy "
          f"spans {n_spans} == Pattern.finditer_batch and re {CONFIG6_LAZY_RE} (count_batch "
          f"{count_ms:.1f} ms, finditer_batch {spans_ms:.1f} ms, first calls with the packing)")

    # config 6 at 1 GiB against the single-pattern engines (every record) and
    # numpy (the first n_slice records)
    has6 = (c6 > 0).any(dim=0)
    lacks6 = (c6 == 0).any(dim=0)
    if not (bool(has6.all()) and bool(lacks6.all())):
        fail(f"config 6 1 GiB: every channel must match in some records and not in others "
             f"(some {has6.tolist()}, not all {lacks6.tolist()})")
    s_mb, e_mb, n_mb = mb6
    if int(n_mb.max()) > cap6:
        fail("config 6 1 GiB: lazy spans over the counts-sized cap")
    for p, pat in enumerate(CONFIG6):
        eng_p = ScanEngine(compile_program(pat), device=dev)
        cp, fp, _ = eng_p.match_stats(big6, len6, seeded=True)
        if not (torch.equal(cp, c6[:, p]) and torch.equal(fp, f6[:, p])):
            fail(f"config 6 1 GiB {pat!r}: (cnt, first) != the single-pattern engine")
        sp_, ep_, np_ = eng_p.lazy_spans(big6, len6, cap=cap6)
        if not (torch.equal(sp_, s_mb[:, p]) and torch.equal(ep_, e_mb[:, p])
                and torch.equal(np_, n_mb[:, p])):
            fail(f"config 6 1 GiB {pat!r}: lazy spans != the single-pattern engine's")
    sub6 = big6[:n_slice].cpu().numpy()
    d6 = (sub6 >= ord("0")) & (sub6 <= ord("9"))
    e6 = np.zeros(sub6.shape, bool)
    e6[:, 2:] = d6[:, :-2] & d6[:, 1:-1] & d6[:, 2:]
    k6 = np.zeros(sub6.shape, bool)
    for word in (b"cat", b"dog"):
        w = np.frombuffer(word, np.uint8)
        k6[:, 2:] |= (sub6[:, :-2] == w[0]) & (sub6[:, 1:-1] == w[1]) & (sub6[:, 2:] == w[2])
    got6 = c6[:n_slice].cpu().numpy()
    if not (np.array_equal(got6[:, 0], k6.sum(axis=1)) and np.array_equal(got6[:, 1], e6.sum(axis=1))):
        fail(f"config 6 1 GiB: cat|dog / [0-9]{{3}} counts != numpy on the first {n_slice} records")
    print(f"phase 8: config 6 over {R} records x {L} B (planted cat/dog, digit runs, err/error, "
          f"abe/abcdcde): matches {c6.sum(dim=0).tolist()} records_with_match "
          f"{(c6 > 0).sum(dim=0).tolist()}; (cnt, first) and lazy spans (cap {cap6}, "
          f"{n_mb.sum(dim=0).tolist()} spans, all 1 GiB) == the single-pattern engines on every "
          f"record; cat|dog and [0-9]{{3}} == numpy on the first {n_slice}")

    # K7 as seven patterns against the single-pattern engines and re
    rows7 = np.random.default_rng(9).choice(R, size=n_re, replace=False)
    c7_np, f7_np = c7.cpu().numpy(), f7.cpu().numpy()
    for k, word in enumerate(K7_WORDS):
        ck, fk, _ = ScanEngine(compile_program(word), device=dev).match_stats(log, log_len, seeded=True)
        if not (torch.equal(ck, c7[:, k]) and torch.equal(fk, f7[:, k])):
            fail(f"K7 as 7 patterns, {word!r}: (cnt, first) != the single-pattern engine")
        ref = np.array([key_stats([word], log_np[r].tobytes()) for r in rows7])
        if not (np.array_equal(c7_np[rows7, k], ref[:, 0]) and np.array_equal(f7_np[rows7, k], ref[:, 1])):
            fail(f"K7 as 7 patterns, {word!r}: (cnt, first) != re on {n_re} records")
    print(f"phase 8: K7 as 7 patterns ({mp7.program.n_states} states, s_tile {mp7.program.s_tile}, "
          f"{type(sc7).__name__}, P = 7) over the 1 GiB log text: matches "
          f"{c7.sum(dim=0).tolist()}; (cnt, first) == the single-pattern engines on every record "
          f"and == re on {n_re} ({time.perf_counter() - t8:.1f}s for the phase)")

    # -- phase 9: one long string (run before 7; counts from here to its last run)
    from roaringregex_tpu_torch.ops import longstring as LS
    from roaringregex_tpu_torch.utils.config import get_config

    reset_launches()
    t9 = time.perf_counter()
    NL = R * L  # 1 GiB: phase 3's and phase 5's batches are reused as one string each
    gen9 = torch.Generator(device=dev)
    gen9.manual_seed(9)
    long_pats = {p_: rrx_compile(p_, dev) for p_ in (CONFIG8, CONFIG9, CONFIG12, CONFIG14,
                                                     SPEC_FAIL, K30)}
    want_cls = {CONFIG8: "FastLongScanner", CONFIG9: "CountLongScanner",
                CONFIG12: "DotStarLongScanner", CONFIG14: "FastLongScanner",
                SPEC_FAIL: "FastLongScanner", K30: "FastLongScanner"}
    for p_, pat in long_pats.items():
        if type(pat.long).__name__ != want_cls[p_]:
            fail(f"{p_[:30]!r} long scanner {type(pat.long).__name__}, expected {want_cls[p_]}")
    first_ms = {}

    def e2e(name, fn, expect):
        """One checked call of a long-string entry point, timed once."""
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        first_ms[name] = (time.perf_counter() - t0_) * 1e3
        if got != expect:
            fail(f"long string {name}: {got} != {expect}")
        return got

    # config 8: phase 3's 1 GiB of lowercase with planted cat/dog, as one
    # string, against a numpy count (matches may span the old record edges)
    s8 = big.reshape(-1)
    a8 = s8.cpu().numpy()
    m8 = np.zeros(NL - 2, bool)
    for word in (b"cat", b"dog"):
        m8 |= (a8[:-2] == word[0]) & (a8[1:-1] == word[1]) & (a8[2:] == word[2])
    ends8 = np.flatnonzero(m8) + 3  # end positions
    del m8
    sc8 = long_pats[CONFIG8].long
    e2e("config 8 count_ends (SWAR windows)", lambda: sc8.count_ends(s8), len(ends8))
    e2e("config 8 count (matmul windows)", lambda: int(sc8._ov_impl(s8, NL, "count")), len(ends8))
    e2e("config 8 search", lambda: sc8.search(s8), True)
    e2e("config 8 fullmatch (summary + replay, unseeded)", lambda: sc8.fullmatch(s8), False)
    if not sc8.fullmatch(b"dog") or sc8.fullmatch(b"dogx"):
        fail("config 8 fullmatch of a short string")

    # config 9: lowercase without 'a' and a-runs of 1-400 B; every 'a' ends a
    # match of a{1,300}
    s9 = torch.randint(ord("b"), ord("z") + 1, (NL,), dtype=torch.uint8, device=dev, generator=gen9)
    starts9 = torch.randint(0, NL - 400, (NL // 4096,), device=dev, generator=gen9)
    lens9 = torch.randint(1, 401, (NL // 4096,), device=dev, generator=gen9)
    cover = torch.zeros(NL + 1, dtype=torch.int32, device=dev)
    cover.index_add_(0, starts9, torch.ones_like(starts9, dtype=torch.int32))
    cover.index_add_(0, starts9 + lens9, -torch.ones_like(starts9, dtype=torch.int32))
    s9[torch.cumsum(cover, 0)[:NL] > 0] = ord("a")
    del cover
    n_a = int(np.count_nonzero(s9.cpu().numpy() == ord("a")))
    sc9 = long_pats[CONFIG9].long
    e2e("config 9 count_ends", lambda: sc9.count_ends(s9), n_a)
    e2e("config 9 search", lambda: sc9.search(s9), True)
    e2e("config 9 fullmatch", lambda: sc9.fullmatch(s9), False)
    if not sc9.fullmatch(b"a" * 300) or sc9.fullmatch(b"a" * 301):
        fail("config 9 fullmatch of a-runs")

    # config 12: pure ASCII (n + 1 - the first cat/dog end), then with bytes
    # >= 0x80 planted: the segmented running OR (every segment between two
    # dead bytes counts from its first cat/dog end)
    sc12 = long_pats[CONFIG12].long
    e2e("config 12 count_ends (ASCII)", lambda: sc12.count_ends(s8), NL + 1 - int(ends8[0]))
    s12 = s8.clone()
    dead = np.sort(np.random.default_rng(12).choice(NL, size=2000, replace=False))
    s12[torch.from_numpy(dead).to(dev)] = torch.from_numpy(
        np.random.default_rng(13).integers(0x80, 0x100, size=dead.size).astype(np.uint8)).to(dev)
    keep = ~np.isin(ends8 - 1, dead) & ~np.isin(ends8 - 2, dead) & ~np.isin(ends8 - 3, dead)
    e12 = ends8[keep]
    bounds = np.concatenate([[0], dead + 1, [NL + 1]])  # segment k: positions [lo, hi)
    want12 = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        j = np.searchsorted(e12, lo)
        if j < e12.size and e12[j] < hi:
            want12 += int(hi - e12[j])
    e2e("config 12 count_ends (bytes >= 0x80: flags + running OR)",
        lambda: sc12.count_ends(s12), want12)
    e2e("config 12 search", lambda: sc12.search(s12), True)

    # config 14 and the speculative windows: (ab)*c ends at every 'c'; a
    # long abab run across window edges validates all the same (its seeded
    # state set depends on one byte); a(bb)*c over [d-z] text with planted
    # a b^k c (k even: a match) and a b-run of 6,000 fails validation and
    # takes summary + replay
    s14 = s8.clone()
    run = torch.tensor(list(b"ab" * 4000 + b"c"), dtype=torch.uint8, device=dev)
    s14[NL // 2 - 3000 : NL // 2 - 3000 + run.numel()] = run
    n_c = int(np.count_nonzero(s14.cpu().numpy() == ord("c")))
    sc14 = long_pats[CONFIG14].long
    _, ok14 = sc14._spec_impl(s14, NL, "count", get_config().spec_warmup)
    e2e("config 14 count_ends (speculative windows)", lambda: sc14.count_ends(s14), n_c)
    e2e("config 14 search", lambda: sc14.search(s14), True)
    e2e("config 14 fullmatch (summary + replay, unseeded)", lambda: sc14.fullmatch(s14), False)
    sf = torch.randint(ord("d"), ord("z") + 1, (NL,), dtype=torch.uint8, device=dev, generator=gen9)
    n_good = 0
    n_pl = NL // 200_000 - 2  # short plants every 200,000 bytes, then the long b-run
    for i, k in enumerate(np.random.default_rng(14).integers(0, 40, size=n_pl).tolist() + [6000]):
        at = i * 200_000 + 17
        sf[at] = ord("a")
        sf[at + 1 : at + 1 + k] = ord("b")
        sf[at + 1 + k] = ord("c")
        n_good += k % 2 == 0
    scf = long_pats[SPEC_FAIL].long
    _, okf = scf._spec_impl(sf, NL, "count", get_config().spec_warmup)
    if bool(okf):
        fail(f"{SPEC_FAIL!r}: the 6,000-byte b-run should fail speculative validation")
    e2e(f"{SPEC_FAIL} count_ends (summary + replay after failed validation)",
        lambda: scf.count_ends(sf), n_good)

    # K30 over phase 5's 1 GiB log text as one log file: the W = 8 overlapped
    # windows, against a count of keyword ends made with torch compares
    s30 = log.reshape(-1)
    ends30 = torch.zeros(NL + 1, dtype=torch.bool, device=dev)
    for word in K30_WORDS:
        w = word.encode()
        hit = torch.ones(NL - len(w) + 1, dtype=torch.bool, device=dev)
        for j, ch in enumerate(w):
            hit &= s30[j : NL - len(w) + 1 + j] == ch
        ends30[len(w):] |= hit
    n30 = int(ends30.sum())
    del ends30, hit
    sc30 = long_pats[K30].long
    if sc30.overlap is None or sc30.tables.s_tile != 256:
        fail("K30 should take the W = 8 overlapped windows")
    e2e("K30 count_ends (W = 8 overlapped windows)", lambda: sc30.count_ends(s30), n30)
    print(f"phase 9: one 1 GiB string per config on the card: config 8 {len(ends8)} ends, config 9 "
          f"{n_a}, config 12 {NL + 1 - int(ends8[0])} (ASCII) and {want12} (with 2,000 bytes >= "
          f"0x80), config 14 {n_c} (speculative verdict {bool(ok14)}), {SPEC_FAIL} {n_good} "
          f"(verdict {bool(okf)}, summary + replay), K30 {n30}: count_ends, search and fullmatch "
          f"== numpy / torch references; first-call times (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in first_ms.items()))

    # 10 MB: bitmaps and spans against re, the kernels against the plain
    # versions on the CPU
    n10m = 10_000_000
    t10 = bytes(a8[:n10m])
    cpu8 = rrx_compile(CONFIG8, "cpu").long
    rx8 = re.compile(b"(?=(cat|dog))")
    st8 = sorted({m.start() for m in rx8.finditer(t10)})
    en8 = sorted({m.start() + 3 for m in rx8.finditer(t10)})
    eb = sc8.ends_bitmap(t10)
    if np.flatnonzero(eb).tolist() != en8 or not np.array_equal(eb, cpu8.ends_bitmap(t10)):
        fail("config 8 ends_bitmap at 10 MB != re / the plain versions")
    sb8 = sc8.starts_bitmap(t10)
    if np.flatnonzero(sb8).tolist() != st8 or not np.array_equal(sb8, cpu8.starts_bitmap(t10)):
        fail("config 8 starts_bitmap at 10 MB != re / the plain versions")
    if long_pats[CONFIG8].finditer_long(t10) != [m.span() for m in re.finditer(b"cat|dog", t10)]:
        fail("config 8 finditer_long at 10 MB != re")
    t9b = s9[:n10m].cpu().numpy().tobytes()
    a_pos = np.flatnonzero(np.frombuffer(t9b, np.uint8) == ord("a"))
    if (np.flatnonzero(sc9.ends_bitmap(t9b)).tolist() != (a_pos + 1).tolist()
            or np.flatnonzero(sc9.starts_bitmap(t9b)).tolist() != a_pos.tolist()):
        fail("config 9 bitmaps at 10 MB != re")
    if long_pats[CONFIG9].finditer_long(t9b, longest=True) != [
            m.span() for m in re.finditer(b"a{1,300}", t9b)]:
        fail("config 9 greedy finditer_long at 10 MB != re")
    t14 = s14[NL // 2 - n10m // 2 : NL // 2 + n10m // 2].cpu().numpy().tobytes()
    if long_pats[CONFIG14].finditer_long(t14) != [m.span() for m in re.finditer(b"(ab)*c", t14)]:
        fail("config 14 finditer_long (cyclic route: the reversed program's ends) != re")
    wide = "(error|warning|critical|fatal|exception|timeout|refused)+x"
    pw = rrx_compile(wide, dev)
    if type(pw.long).__name__ != "LongScanner":
        fail(f"{wide!r} should take the torch-op LongScanner")
    body = (b"errorwarningtimeoutrefused" * (n10m // 26))[: n10m - 1]
    body = body[: len(body) - len(body) % 26]
    for txt in (body + b"x", body + b"y", body[:-1] + b"x"):
        want = re.fullmatch(wide.encode(), txt) is not None
        if pw.long.fullmatch(txt) != want:
            fail(f"LongScanner fullmatch at 10 MB != re ({want})")
    torch.cuda.synchronize()
    long_launches = launches()
    for name in LONG_KERNELS:
        if long_launches[name] <= 0:
            fail(f"{name} was not launched on the long-string path")
    print(f"phase 9: 10 MB: config 8 and 9 ends_bitmap / starts_bitmap == re and the plain "
          f"versions, finditer_long == re (config 8 lazy, config 9 greedy, config 14 on the cyclic "
          f"route), LongScanner fullmatch == re.fullmatch "
          f"({time.perf_counter() - t9:.1f}s for the phase)")
    print(f"long-string path launches: {long_launches}")

    # -- phase 10: the bitband path (run before 7; counts from here to its last run)
    reset_launches()
    t10 = time.perf_counter()
    rx10 = re.compile(CONFIG10.encode())

    def re_stats10(d: np.ndarray, ln: np.ndarray):
        """(count of match ends, first end) per record by Python re: every
        match of config 10 holds one x, at its start, so matches are unique
        per start, never overlap, and re.finditer's ends are all of them."""
        cnt = np.zeros(d.shape[0], np.int64)
        first = np.full(d.shape[0], -1, np.int64)
        for i in range(d.shape[0]):
            ends = [m.end() for m in rx10.finditer(d[i, : ln[i]].tobytes())]
            cnt[i] = len(ends)
            first[i] = ends[0] if ends else -1
        return cnt, first

    def bucket(B: int) -> int:
        """The prefilter's compaction bucket (B / 4 rows rounded up to 128)."""
        return min(B, max(128, -(-(B // 4) // 128) * 128))

    eng10 = ScanEngine(compile_program(CONFIG10), device=dev)
    sc10, pf10 = eng10.device_scanner, eng10._prefilter()
    if not isinstance(sc10, scan_bitband.BitbandScanner) or pf10 is None:
        fail(f"config 10 routed to {type(sc10).__name__} with prefilter {pf10}")
    set_config(base_cfg.with_(sparse_prefilter=False))  # RRX_SPARSE_PREFILTER=0
    raw10 = ScanEngine(compile_program(CONFIG10), device=dev)
    if raw10._prefilter() is not None:
        fail("config 10 with the prefilter off still has one")
    set_config(base_cfg)

    def run10(d_np: np.ndarray, l_np: np.ndarray, tag: str, raw: bool):
        """Config 10's match_stats on the card (the prefilter's path, no host
        sync allowed inside it) against re and, with ``raw``, against the
        unfiltered scan; returns (data, lengths on the card, candidates)."""
        d, ln = torch.from_numpy(d_np).to(dev), torch.from_numpy(l_np).to(dev)
        _, _, pre = eng10._alias_call(pf10, "match_stats", d, ln, seeded=True)
        n_cand = int(pre.reshape(-1)[: d.shape[0]].sum().item())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the call raises
        try:
            got = eng10.match_stats(d, ln, seeded=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cnt, first, anym = (x.cpu().numpy() for x in got)
        want = re_stats10(d_np, l_np)
        if not (np.array_equal(cnt, want[0]) and np.array_equal(first, want[1])
                and np.array_equal(anym, want[0] > 0)):
            bad = np.nonzero((cnt != want[0]) | (first != want[1]))[0][:5].tolist()
            fail(f"config 10 {tag}: (cnt, first, any) != re at records {bad}")
        if raw:
            for x, y in zip(got, raw10.match_stats(d, ln, seeded=True), strict=True):
                if not torch.equal(x, y):
                    fail(f"config 10 {tag}: the prefiltered scan != the unfiltered scan")
        print(f"phase 10: config 10 {tag}: {d.shape[0]} records x {d.shape[1]} B, {n_cand} "
              f"prefilter candidates, bucket {bucket(d.shape[0])} rows "
              f"({'compacted' if n_cand <= bucket(d.shape[0]) else 'full-batch pass'}): "
              f"matches={int(cnt.sum())} records_with_match={int(anym.sum())} == re"
              + (" == the unfiltered scan" if raw else "") + "; no host sync in the call")
        return d, ln, n_cand

    # 10 MB: bench.make_corpus's plant rule (12.5% of the records), then
    # densities under B / 16 and over the B / 4 bucket
    d10_np, l10_np = bench.make_corpus(10_000_000, 1024, seed=10, plant=(PLANT10,))
    g10, gl10, c10 = run10(d10_np, l10_np, "10 MB", raw=True)
    B10 = g10.shape[0]
    if not B10 // 16 <= c10 <= bucket(B10):
        fail(f"config 10 at 10 MB: {c10} candidates do not take the B / 4 bucket")
    for frac, seed in ((0.02, 11), (0.6, 12)):
        dd, ll = bench.make_corpus(10_000_000, 1024, seed=seed, plant=(PLANT10,), plant_frac=frac)
        _, _, cd = run10(dd, ll, f"10 MB, plants in {frac:.0%} of the records", raw=True)
        if (cd < B10 // 16) != (frac < 0.1) or (cd > bucket(B10)) != (frac > 0.1):
            fail(f"config 10 plant fraction {frac}: {cd} candidates miss the density's route")
    # 1 GiB: the same plant rule over 1,048,576 records
    t0 = time.perf_counter()
    b10_np, bl10_np = bench.make_corpus(1 << 30, 1024, seed=13, plant=(PLANT10,))
    gen10_s = time.perf_counter() - t0
    b10, bl10, cb10 = run10(b10_np, bl10_np, f"1 GiB (corpus built in {gen10_s:.1f}s)", raw=False)

    # lazy and longest spans through Pattern.finditer_batch at 10 MB, the
    # anchored rescan from each record's first match start, and the end and
    # start bitmaps against the plain versions (on the card) and re
    texts10 = [d10_np[i, : l10_np[i]].tobytes() for i in range(B10)]
    want_sp = [[m.span() for m in rx10.finditer(t)] for t in texts10]
    pat10 = rrx_compile(CONFIG10, dev)
    for longest in (False, True):
        if pat10.finditer_batch(texts10, longest=longest) != want_sp:
            fail(f"config 10 finditer_batch (longest={longest}) != re.finditer at 10 MB")
    st10 = np.array([sp[0][0] if sp else -1 for sp in want_sp], np.int32)
    fe10 = eng10.first_end_from(g10, gl10, st10, longest=True).cpu().numpy()
    if not np.array_equal(fe10, [sp[0][1] if sp else -1 for sp in want_sp]):
        fail("config 10 anchored (longest) ends from the first match start != re")
    fw = BB.flags_plain(g10, gl10, sc10.tables, seeded=True)
    hw = scan_bits.reverse_plain(g10, gl10, sc10.tables)
    fb = scan_bits.hit_bits(fw, g10.shape[1] + 2).cpu().numpy()
    hb = scan_bits.hit_bits(hw, g10.shape[1] + 2).cpu().numpy()
    ends_p = [sorted({min(t, n) for t in np.nonzero(fb[i])[0]}) for i, n in enumerate(l10_np)]
    starts_p = [sorted({max(t - 1, 0) for t in np.nonzero(hb[i])[0] if max(t - 1, 0) <= n})
                for i, n in enumerate(l10_np)]
    if pat10.ends_batch(texts10) != ends_p or ends_p != [[e for _, e in sp] for sp in want_sp]:
        fail("config 10 ends_batch != the plain flags or re at 10 MB")
    if pat10.starts_batch(texts10) != starts_p or starts_p != [[s for s, _ in sp] for sp in want_sp]:
        fail("config 10 starts_batch != the plain reverse hits or re at 10 MB")
    print(f"phase 10: config 10 at 10 MB: finditer_batch lazy and longest == re.finditer "
          f"({sum(map(len, want_sp))} spans), first_end_from (longest) == re, ends_batch and "
          f"starts_batch == the plain versions on the card == re")

    # the multiblock programs of the tier (and x(ab|c){400,}y) at 10 MB
    # through the Pattern API: lowercase records with a chain of the body
    # planted in every eighth (counts of copies m-1, m, m..n, n, n+1)
    for k, pattern in enumerate(BITBAND_MB):
        rngm = np.random.default_rng(100 + k)
        dm = rngm.integers(ord("a"), ord("z") + 1, size=(B10, 1024), dtype=np.uint8)
        lm = np.full(B10, 1024, np.int32)
        mm = re.search(r"\{(\d+),(\d*)\}", pattern)
        lo, hi = int(mm.group(1)), int(mm.group(2) or int(mm.group(1)) + 40)
        for i in rngm.permutation(B10)[: B10 // 8]:
            w = chain(pattern, int(rngm.choice([lo - 1, lo, int(rngm.integers(lo, hi + 1)), hi,
                                                hi + 1])), 1024)
            at = 0 if pattern.startswith("^") else int(rngm.integers(0, 1024 - len(w) + 1))
            dm[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
            if pattern.startswith("^") and i % 2:
                lm[i] = len(w)
        texts = [dm[i, : lm[i]].tobytes() for i in range(B10)]
        pat = rrx_compile(pattern, dev)
        if not isinstance(pat.engine.device_scanner, scan_bitband.BitbandScanner):
            fail(f"{pattern!r} routed to {type(pat.engine.device_scanner).__name__}")
        rx = re.compile(pattern.encode())
        rxl = re.compile(pattern.replace("+", "+?").replace("}", "}?").encode())
        if pat.search_batch(texts).tolist() != [rx.search(t) is not None for t in texts]:
            fail(f"{pattern!r}: search_batch != re at 10 MB")
        if pat.fullmatch_batch(texts).tolist() != [rx.fullmatch(t) is not None for t in texts]:
            fail(f"{pattern!r}: fullmatch_batch != re at 10 MB")
        for longest, r_ in ((False, rxl), (True, rx)):
            if pat.finditer_batch(texts, longest=longest) != [[m.span() for m in r_.finditer(t)]
                                                               for t in texts]:
                fail(f"{pattern!r}: finditer_batch (longest={longest}) != re at 10 MB")
        dmg, lmg = torch.from_numpy(dm).to(dev), torch.from_numpy(lm).to(dev)
        cnt_p = BB.stats_plain(dmg, lmg, pat.engine.device_scanner.tables, seeded=True,
                               nullable=False)[0][:, 0].cpu().numpy()
        if not np.array_equal(pat.count_batch(texts), cnt_p):
            fail(f"{pattern!r}: count_batch != the plain version at 10 MB")
        spec = pat.engine.device_scanner.bspec
        print(f"phase 10: {pattern!r} ({pat.n_states} states, {pat.tier}, W = {spec.W}, "
              f"{len(spec.diags)} diagonals, rank-1 {len(spec.rank1)}, gaps {spec.tri_gaps}) at "
              f"10 MB: search_batch, fullmatch_batch and finditer_batch lazy and longest == re, "
              f"count_batch == plain ({int(cnt_p.sum())} match ends)")
    torch.cuda.synchronize()
    bitband_launches = {name: launches()[name] for name in BITBAND_KERNELS}
    for name, n in bitband_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the bitband path")
    print(f"bitband path launches: {bitband_launches} "
          f"({time.perf_counter() - t10:.1f}s for the phase)")

    # -- phase 11: the container path (run before 7; counts from here to its last run)
    reset_launches()
    t11 = time.perf_counter()
    SP = scan_sparse
    # K120 over phase 5's log text (10 MB and 1 GiB): match_stats against the
    # plain version (10 MB; the first n_slice records of 1 GiB) and re
    eng120 = ScanEngine(compile_program(K120), device=dev)
    sc120 = eng120.device_scanner
    if not isinstance(sc120, SP.SparseScanner):
        fail(f"K120 routed to {type(sc120).__name__}")
    for shape, d, ln in (("10 MB", log10, len10), ("1 GiB", log, log_len)):
        cnt, first, anym = eng120.match_stats(d, ln, seeded=True)
        n = d.shape[0] if shape == "10 MB" else n_slice
        want = SP.sparse_stats_plain(d[:n], ln[:n], sc120.tables, seeded=True, nullable=False)
        if not (torch.equal(cnt[:n], want[0][:, 0]) and torch.equal(first[:n], want[1][:, 0])
                and torch.equal(anym, cnt > 0)):
            fail(f"K120 {shape} match_stats != the plain version on {n} records")
        rows = np.random.default_rng(16).choice(d.shape[0], size=n_re, replace=False)
        got = np.stack([cnt.cpu().numpy()[rows], first.cpu().numpy()[rows]], axis=1)
        ref = np.array([key_stats(K120_WORDS, log_np[r].tobytes()) for r in rows])
        if not np.array_equal(got, ref):
            fail(f"K120 {shape}: (cnt, first) != re on {n_re} records")
        print(f"phase 11: K120 ({eng120.prog.n_states} states, {eng120.prog.tier}, "
              f"{sc120.n_partial} partial blocks, {SP.table_form(sc120.tables)} table) over {shape} "
              f"of log text: matches={int(cnt.sum().item())} == plain on {n} records, == re on "
              f"{n_re}")
    # MultiPattern of 40 keywords: count_batch at 10 MB (the API) and the
    # engine's channel scan at 1 GiB, per-word counts against re
    mp40 = MultiPattern(SPARSE_SETS[1], dev)
    if not isinstance(mp40.engine.device_scanner, SP.SparseScanner):
        fail(f"MultiPattern of 40 routed to {type(mp40.engine.device_scanner).__name__}")
    rx40 = re.compile(b"(?=(" + b"|".join(w.encode() for w in SPARSE_SETS[1]) + b"))")
    widx = {w.encode(): i for i, w in enumerate(SPARSE_SETS[1])}

    def word_counts(rows):
        out = np.zeros((len(rows), 40), np.int64)
        for k, r in enumerate(rows):
            for m in rx40.finditer(log_np[r].tobytes()):
                out[k, widx[m.group(1)]] += 1
        return out

    texts10 = [log_np[i].tobytes() for i in range(B7)]
    cnt40 = mp40.count_batch(texts10)
    rows = np.random.default_rng(17).choice(B7, size=n_re, replace=False)
    if not np.array_equal(cnt40[rows], word_counts(rows)):
        fail("MultiPattern of 40 count_batch != re at 10 MB")
    c40, _, _ = mp40.engine.match_stats(log, log_len, seeded=True)
    c40 = c40.reshape(-1, 40)
    rows = np.random.default_rng(18).choice(R, size=n_re, replace=False)
    if not np.array_equal(c40.cpu().numpy()[rows], word_counts(rows)):
        fail("MultiPattern of 40 engine match_stats != re at 1 GiB")
    print(f"phase 11: MultiPattern of 40 keywords ({mp40.program.n_states} states, C = 40): "
          f"count_batch at 10 MB ({int(cnt40.sum())} matches) and the 1 GiB channel scan "
          f"({int(c40.sum().item())}) == re on {n_re} records each")
    # config 13's own tier: fullmatch on its make_corpus shape with every
    # fourth record cut to an abcde... chain (copies 2 j or 2 j + 1, in and
    # out of 1..300), at 10 MB (the API) and 1 GiB (the engine)
    tmpl = torch.from_numpy(np.frombuffer((b"abcde" * 205)[:1024], np.uint8).copy()).to(dev)

    def chains13(d: torch.Tensor, ln: torch.Tensor, seed: int):
        g = torch.Generator(device="cpu").manual_seed(seed)
        rows = torch.arange(0, d.shape[0], 4, device=dev)
        cut = torch.randint(0, 1025, (rows.numel(),), generator=g).to(dev, torch.int32)
        d[rows] = tmpl
        ln[rows] = cut
        return d, ln

    def full13(ln: np.ndarray, chained: np.ndarray) -> np.ndarray:
        """Whole-record matches of the chained records: len = 5 j or 5 j + 3,
        2 j (+ 1) copies of abc|de, 1..300 of them."""
        copies = 2 * (ln // 5) + (ln % 5 == 3)
        return chained & ((ln % 5 == 0) | (ln % 5 == 3)) & (copies >= 1) & (copies <= 300)

    pat13 = rrx_compile(CONFIG13, dev)
    d13_np, l13_np = bench.make_corpus(10_000_000, 1024, seed=13, plant=(b"abcde",))
    d13, l13 = chains13(torch.from_numpy(d13_np).to(dev), torch.from_numpy(l13_np).to(dev), 1)
    d13_np, l13_np = d13.cpu().numpy(), l13.cpu().numpy()
    texts13 = [d13_np[i, : l13_np[i]].tobytes() for i in range(d13_np.shape[0])]
    full_13 = pat13.fullmatch_batch(texts13)
    rx13f = re.compile(rb"(abc|de){1,300}")
    if full_13.tolist() != [rx13f.fullmatch(t) is not None for t in texts13]:
        fail("config 13 fullmatch_batch != re.fullmatch at 10 MB")
    chained = np.arange(d13_np.shape[0]) % 4 == 0
    if not (full_13.any() and np.array_equal(full_13, full13(l13_np, chained))):
        fail("config 13 fullmatch_batch != the chain count at 10 MB")
    b13, bl13 = chains13(big.clone(), big_len.clone(), 2)
    fb13 = eng13.fullmatch_flags(b13, bl13)
    if not np.array_equal(fb13, full13(bl13.cpu().numpy(), np.arange(b13.shape[0]) % 4 == 0)):
        fail("config 13 fullmatch_flags != the chain count at 1 GiB")
    # greedy spans in host rounds (each round one scan_xla rescan) on 2,000
    # records of <= 256 B against re
    rng13 = np.random.default_rng(19)
    alpha13 = np.frombuffer(b"abcdex", np.uint8)
    texts_g = [bytes(rng13.choice(alpha13, size=int(rng13.integers(0, 257)))) for _ in range(2000)]
    rx13 = re.compile(rb"(abc|de){1,300}")
    if pat13.finditer_batch(texts_g, longest=True) != [[m.span() for m in rx13.finditer(t)]
                                                        for t in texts_g]:
        fail("config 13 greedy finditer_batch != re on 2,000 records")
    print(f"phase 11: config 13 on its container tier ({eng13.device_scanner.n_partial} partial "
          f"blocks): fullmatch_batch at 10 MB ({int(full_13.sum())} whole-record matches) == re and "
          f"the chain count, fullmatch_flags at 1 GiB ({int(fb13.sum())}) == the chain count, "
          f"greedy finditer_batch on 2,000 records == re")
    # x(abc|de){1,300}y behind its prefilter, a plant in 12.5% of the
    # records (bench.make_corpus's rule), 10 MB and 1 GiB, against re
    eng_x = ScanEngine(compile_program(CONFIG13_X), device=dev)
    pf_x = eng_x._prefilter()
    if not isinstance(eng_x.device_scanner, SP.SparseScanner) or pf_x is None:
        fail(f"{CONFIG13_X} routed to {type(eng_x.device_scanner).__name__} with prefilter {pf_x}")
    rx_x = re.compile(CONFIG13_X.encode())
    x_runs = {}
    for shape, total, seed in (("10 MB", 10_000_000, 20), ("1 GiB", 1 << 30, 21)):
        t0 = time.perf_counter()
        dx_np, lx_np = bench.make_corpus(total, 1024, seed=seed, plant=(PLANT13X,))
        gen_s = time.perf_counter() - t0
        dx, lx = torch.from_numpy(dx_np).to(dev), torch.from_numpy(lx_np).to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the call raises
        try:
            cx, fx, ax = eng_x.match_stats(dx, lx, seeded=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rows = (np.arange(dx_np.shape[0]) if shape == "10 MB"
                else np.random.default_rng(22).choice(dx_np.shape[0], size=n_re, replace=False))
        want = np.array([[len(e := [m.end() for m in rx_x.finditer(dx_np[r].tobytes())]),
                          e[0] if e else -1] for r in rows])
        got = np.stack([cx.cpu().numpy()[rows], fx.cpu().numpy()[rows]], axis=1)
        if not np.array_equal(got, want):
            fail(f"{CONFIG13_X} {shape}: (cnt, first) != re")
        x_runs[shape] = (dx, lx)
        print(f"phase 11: {CONFIG13_X} {shape} ({dx_np.shape[0]} records, corpus built in "
              f"{gen_s:.1f}s): matches={int(cx.sum().item())} == re on {rows.size} records; no "
              f"host sync in the call")
    # the bitmaps and lazy spans of K120 (flags and reverse kernels) on the
    # phase-5 API batch against re
    pat120 = rrx_compile(K120, dev)
    texts_k = [log_np[i, :256].tobytes() for i in range(2000)]
    rxk = re.compile(K120.encode())
    rxk_all = re.compile(b"(?=(" + K120[1:-1].encode() + b"))")  # overlapping matches too
    spans_k = [[m.span() for m in rxk.finditer(t)] for t in texts_k]
    every = [[(m.start(), m.start() + len(m.group(1))) for m in rxk_all.finditer(t)]
             for t in texts_k]
    if pat120.ends_batch(texts_k) != [sorted({e for _, e in sp}) for sp in every]:
        fail("K120 ends_batch != re")
    if pat120.starts_batch(texts_k) != [sorted({s for s, _ in sp}) for sp in every]:
        fail("K120 starts_batch != re")
    if pat120.finditer_batch(texts_k) != spans_k:
        fail("K120 lazy finditer_batch != re")
    torch.cuda.synchronize()
    sparse_launches = {name: launches()[name] for name in SPARSE_KERNELS}
    for name, n in sparse_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the container path")
    print(f"phase 11: K120 ends_batch, starts_batch and lazy finditer_batch == re on 2,000 "
          f"records ({sum(map(len, spans_k))} spans)")
    print(f"container path launches: {sparse_launches} "
          f"({time.perf_counter() - t11:.1f}s for the phase)")

    # -- phase 12: the dense multiblock path (run before 7; counts from here to its last run)
    reset_launches()
    t12 = time.perf_counter()
    K60_WORDS = keywords(60)
    rx60 = re.compile(("(" + "|".join(K60_WORDS) + ")").encode())  # K60+'s lazy spans
    rx60p = re.compile(K60P.encode())
    rx300 = re.compile(CHAIN300.encode())
    eng60 = ScanEngine(compile_program(K60P), device=dev)
    eng300 = ScanEngine(compile_program(CHAIN300), device=dev)
    for pattern, eng_w in ((K60P, eng60), (CHAIN300, eng300)):
        sc_w = eng_w.device_scanner
        if type(sc_w).__name__ != "PallasScanner" or sc_w.nfa.s_tile <= scan_pallas.REG_S_TILE:
            fail(f"{pattern[:30]!r}... routed to {type(sc_w).__name__} (s_tile "
                 f"{eng_w.prog.s_tile})")

    def chain_plants(d: torch.Tensor, seed: int) -> torch.Tensor:
        """A copy of [R, 1024] records with an x(ab|c){k}y chain, k =
        295..340 (near misses below 300), planted in 12.5% of the records
        (64 chains from a numpy seed, written on the card)."""
        g = np.random.default_rng(seed)
        rows = g.permutation(d.shape[0])[: d.shape[0] // 8]
        which = g.integers(0, 64, size=rows.size)
        d = d.clone()
        for j in range(64):
            k = int(g.integers(295, 341))
            ch = b"x" + b"".join(b"ab" if g.random() < 0.5 else b"c" for _ in range(k)) + b"y"
            rj = torch.from_numpy(rows[which == j]).to(dev)
            off = torch.from_numpy(g.integers(0, d.shape[1] - len(ch) + 1, size=rj.numel())).to(dev)
            cols = off[:, None] + torch.arange(len(ch), device=dev)[None, :]
            d[rj[:, None], cols] = torch.from_numpy(np.frombuffer(ch, np.uint8).copy()).to(dev)
        return d

    t1 = time.perf_counter()
    chain10, chain1g = chain_plants(log10, 23), chain_plants(log, 24)
    torch.cuda.synchronize()
    print(f"phase 12: {CHAIN300} batches: phase 5's log text with a chain planted in 12.5% of the "
          f"records, 10 MB and 1 GiB (built on the card in {time.perf_counter() - t1:.1f}s)")

    def re_stats(pattern: str, text: bytes):
        """(count of distinct match ends, first end or -1) by Python's re:
        K60+'s ends are its keywords' ends (none is a prefix of another);
        CHAIN300's matches neither overlap nor share an end."""
        if pattern == K60P:
            return key_stats(K60_WORDS, text)
        ends = [m.end() for m in rx300.finditer(text)]
        return len(ends), ends[0] if ends else -1

    wide_runs = {}
    for pattern, eng_w, runs in ((K60P, eng60, (("10 MB", log10, len10), ("1 GiB", log, log_len))),
                                 (CHAIN300, eng300, (("10 MB", chain10, len10),
                                                     ("1 GiB", chain1g, log_len)))):
        tables = eng_w.device_scanner.nfa
        for shape, d, ln in runs:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cnt_w, first_w, any_w = eng_w.match_stats(d, ln, seeded=True)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t1) * 1e3
            n = min(d.shape[0], n_slice)
            want = scan_pallas.stats_plain(d[:n], ln[:n], tables, seeded=True, lead=0,
                                           nullable=False)
            if not (torch.equal(cnt_w[:n], want[0]) and torch.equal(first_w[:n], want[1])
                    and torch.equal(any_w, cnt_w > 0)):
                fail(f"{pattern[:30]!r}... {shape} match_stats != plain on the first {n} records")
            rows = np.random.default_rng(25).choice(d.shape[0], size=n_re, replace=False)
            host = d[torch.from_numpy(rows).to(dev)].cpu().numpy()
            got = np.stack([cnt_w.cpu().numpy()[rows], first_w.cpu().numpy()[rows]], axis=1)
            ref = np.array([re_stats(pattern, host[i].tobytes()) for i in range(n_re)])
            if not np.array_equal(got, ref):
                i = int(np.nonzero((got != ref).any(axis=1))[0][0])
                fail(f"{pattern[:30]!r}... {shape} record {rows[i]}: (cnt, first) {got[i]} != re "
                     f"{ref[i]}")
            wide_runs[pattern, shape] = (d, ln, cnt_w)
            print(f"phase 12: {pattern[:40]!r}... ({eng_w.prog.n_states} states, s_tile "
                  f"{eng_w.prog.s_tile}) over {shape}: matches={int(cnt_w.sum().item())} "
                  f"records_with_match={int(any_w.sum().item())}; == plain on {n} records, == re on "
                  f"{n_re} (first call {call_ms:.1f} ms)")
        # spans, the anchored rescan and both bitmaps at 10 MB against re
        d, ln, cnt_w = wide_runs[pattern, "10 MB"]
        host = d.cpu().numpy()
        cap_w = 1 << max(int(cnt_w.max()), 1).bit_length()
        rx_lazy, rx_greedy = (rx60, rx60p) if pattern == K60P else (rx300, rx300)
        lazy = eng_w.lazy_spans(d, ln, cap=cap_w)
        greedy = eng_w.greedy_spans(d, ln, cap=cap_w)
        if bool(greedy[3].any()) or int(lazy[2].max()) > cap_w:
            fail(f"{pattern[:30]!r}... spans over cap {cap_w}")
        n_sp = {}
        for policy, (sk, ek, ck), rx in (("lazy", lazy[:3], rx_lazy),
                                         ("greedy", greedy[:3], rx_greedy)):
            sk, ek, ck = (x.cpu().numpy() for x in (sk, ek, ck))
            bad = [i for i in range(d.shape[0])
                   if list(zip(sk[i, : ck[i]].tolist(), ek[i, : ck[i]].tolist()))
                   != [m.span() for m in rx.finditer(host[i].tobytes())]]
            if bad:
                fail(f"{pattern[:30]!r}... {policy} spans at 10 MB: {len(bad)} records differ from "
                     f"re.finditer, the first {bad[0]}")
            n_sp[policy] = int(ck.sum())
        starts0 = lazy[0][:, 0].contiguous()
        end0 = eng_w.first_end_from(d, ln, starts0, longest=True)
        if not torch.equal(end0, torch.where(starts0 >= 0, greedy[1][:, 0], -1)):
            fail(f"{pattern[:30]!r}... longest rescan from the first start != the first greedy span")
        rows = np.random.default_rng(26).choice(d.shape[0], size=n_re, replace=False)
        ends_bm = eng_w.ends_bitmap(d, ln, L)
        starts_bm = eng_w.starts_bitmap(d, ln, L)
        for i in rows:
            text = host[i].tobytes()
            if pattern == K60P:
                every = [(m.start(), m.start() + len(m.group(1)))
                         for m in re.finditer(b"(?=(" + "|".join(K60_WORDS).encode() + b"))", text)]
            else:
                every = [m.span() for m in rx300.finditer(text)]
            if (np.nonzero(ends_bm[i])[0].tolist() != sorted({e for _, e in every})
                    or np.nonzero(starts_bm[i])[0].tolist() != sorted({s_ for s_, _ in every})):
                fail(f"{pattern[:30]!r}... ends_bitmap / starts_bitmap != re at record {i}")
        print(f"phase 12: {pattern[:40]!r}... at 10 MB: lazy ({n_sp['lazy']}) and greedy "
              f"({n_sp['greedy']}) spans (cap {cap_w}) == re.finditer on every record; the longest "
              f"rescan from each first start == the first greedy span; ends_bitmap and "
              f"starts_bitmap == re on {n_re} records")
    # MultiPattern of K40+, cat|dog and [0-9]{3} (a dense multiblock union,
    # P = 3) on 10 MB of log text, digits and cat/dog planted: counts, and
    # lazy spans from one combined scan (rrx_nfa_wide_reverse_mb,
    # rrx_nfa_wide_lazy_spans_mb), against the single patterns on every
    # record and re on n_re records
    texts_w = [log_np[i, :1000].tobytes() + (b" cat 1234" if i % 5 == 0 else b"") for i in range(B7)]
    cnt_mp = mp_w.count_batch(texts_w)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    spans_mp = mp_w.finditer_batch(texts_w)
    mp_spans_s = time.perf_counter() - t1
    rx_mp = [re.compile(("(" + "|".join(keywords(40)) + ")").encode()), re.compile(b"cat|dog"),
             re.compile(b"[0-9]{3}")]
    rows_w = np.random.default_rng(27).choice(B7, size=n_re, replace=False)
    for p_i, pattern in enumerate(WIDE_MP):
        pat = rrx_compile(pattern, dev)
        if not np.array_equal(cnt_mp[:, p_i], pat.count_batch(texts_w)):
            fail(f"MultiPattern (dense multiblock union) count_batch != Pattern {pattern[:30]!r}")
        if spans_mp[p_i] != pat.finditer_batch(texts_w):
            fail(f"MultiPattern (dense multiblock union) lazy spans != Pattern {pattern[:30]!r}")
        for i in rows_w:
            if spans_mp[p_i][i] != [m.span() for m in rx_mp[p_i].finditer(texts_w[i])]:
                fail(f"MultiPattern lazy spans of {pattern[:30]!r} != re at record {i}")
    n_mp_spans = [sum(map(len, s_)) for s_ in spans_mp]
    print(f"phase 12: MultiPattern {['K40+'] + WIDE_MP[1:]} ({mp_w.program.n_states} states, s_tile "
          f"{mp_w.program.s_tile}) at 10 MB: count_batch ({cnt_mp.sum(axis=0).tolist()}) and lazy "
          f"finditer_batch ({n_mp_spans} spans, one combined scan, {mp_spans_s:.2f}s with the host "
          f"side) == the single patterns on every record, the spans == re on {n_re} records")

    # one long string on the wide window kernels: Pattern.long(K60) (412
    # states, s_tile 512, horizon 12) over phase 5's 1 GiB log text as one
    # string against a count of keyword ends made with torch compares, and at
    # 10 MB its bitmaps and finditer_long against re; x(ab|c){300,340}y
    # (s_tile 1024, horizon 682: windows of 5,472 steps) over the chain batch
    # as one string against re; K60's unseeded fullmatch on the torch-op
    # LongScanner, as in the JAX package
    pat_k60 = rrx_compile(K60, dev)
    lsc = pat_k60.long
    if type(lsc).__name__ != "FastLongScanner" or lsc.tables.s_tile != 512:
        fail(f"Pattern.long(K60) took {type(lsc).__name__}, not FastLongScanner at s_tile 512")
    s60 = log.reshape(-1)
    NLw = s60.numel()
    ends60 = torch.zeros(NLw + 1, dtype=torch.bool, device=dev)
    for word in K60_WORDS:
        w = word.encode()
        hit = torch.ones(NLw - len(w) + 1, dtype=torch.bool, device=dev)
        for j, ch in enumerate(w):
            hit &= s60[j : NLw - len(w) + 1 + j] == ch
        ends60[len(w):] |= hit
    n60 = int(ends60.sum())
    del ends60, hit
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_long = lsc.count_ends(s60)
    long_s = time.perf_counter() - t1
    if n_long != n60 or not lsc.search(s60):
        fail(f"Pattern.long(K60).count_ends over 1 GiB = {n_long} != torch compares {n60}")
    t10w = s60[:10_000_000].cpu().numpy().tobytes()
    every60 = [(m.start(), m.start() + len(m.group(1)))
               for m in re.finditer(b"(?=(" + "|".join(K60_WORDS).encode() + b"))", t10w)]
    if (np.flatnonzero(lsc.ends_bitmap(t10w)).tolist() != sorted({e for _, e in every60})
            or np.flatnonzero(lsc.starts_bitmap(t10w)).tolist() != sorted({s_ for s_, _ in every60})):
        fail("Pattern.long(K60) ends_bitmap / starts_bitmap at 10 MB != re")
    if pat_k60.finditer_long(t10w) != [m.span() for m in re.finditer(K60.encode(), t10w)]:
        fail("Pattern.long(K60) finditer_long at 10 MB != re")
    pat_c = rrx_compile(CHAIN340, dev)
    lsc_c = pat_c.long
    if type(lsc_c).__name__ != "FastLongScanner" or lsc_c.tables.s_tile != 1024:
        fail(f"Pattern.long({CHAIN340}) took {type(lsc_c).__name__}, not FastLongScanner at 1024")
    sch = chain1g.reshape(-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_ch = lsc_c.count_ends(sch)
    chain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    want_ch = sum(1 for _ in re.finditer(CHAIN340.encode(), sch.cpu().numpy().tobytes()))
    re_s = time.perf_counter() - t1
    if n_ch != want_ch or n_ch == 0 or not lsc_c.search(sch):
        fail(f"Pattern.long({CHAIN340}).count_ends over 1 GiB = {n_ch} != re {want_ch}")
    blob = log_np[:1024].tobytes()  # 1 MiB
    t1 = time.perf_counter()
    if lsc.fullmatch(blob) or not lsc.fullmatch(K60_WORDS[7].encode()):
        fail("Pattern.long(K60).fullmatch != re.fullmatch")
    full_s = time.perf_counter() - t1
    if type(lsc._portable).__name__ != "LongScanner":
        fail("K60's unseeded scans did not take the torch-op LongScanner")
    print(f"phase 12: Pattern.long(K60) on the wide window kernels ({lsc._ov_geom(NLw).nw} windows "
          f"of {lsc._ov_block(NLw)} + {lsc.overlap} steps): count_ends over 1 GiB {n_long} == "
          f"torch compares (first call {long_s * 1e3:.1f} ms), search; at 10 MB ends_bitmap, "
          f"starts_bitmap and finditer_long == re; {CHAIN340} count_ends over the 1 GiB chain "
          f"string {n_ch} == re (first call {chain_s * 1e3:.1f} ms; re {re_s:.1f}s); K60 fullmatch "
          f"on 1 MiB and one keyword through the torch-op LongScanner == re ({full_s:.1f}s)")
    torch.cuda.synchronize()
    wide_launches = {name: launches()[name]
                     for name in WIDE_KERNELS + WIDE_MB_KERNELS + LONG_WIDE_KERNELS}
    for name, n in wide_launches.items():
        # the summary and speculative modes, which alone run a carry pass,
        # take narrow tiles only (as in the JAX package): phase 2 holds
        # rrx_long_wide_carry
        if n <= 0 and name != "rrx_long_wide_carry":
            fail(f"{name} was not launched on the dense multiblock path")
    print(f"dense multiblock path launches: {wide_launches} "
          f"({time.perf_counter() - t12:.1f}s for the phase)")

    # -- phase 13: the packed and XLA backends (run before 7; counts from here to its last run)
    t13 = time.perf_counter()
    reset_launches()
    PK = scan_packed
    d1_np, l1_np = bench.make_corpus(10_000_000, 1024, seed=0)
    pad13 = -d1_np.shape[0] % 16  # whole rows of cat|dog's packing group (G = 16)
    d1_np, l1_np = np.pad(d1_np, ((0, pad13), (0, 0))), np.pad(l1_np, (0, pad13))
    log13 = log_text(np, 13, d1_np.shape[0], 1024, K30_WORDS)
    pk_runs = {}
    for pattern, words_k, d_np in (("cat|dog", ["cat", "dog"], d1_np), (K30, K30_WORDS, log13)):
        d_pk = torch.from_numpy(d_np).to(dev)
        l_pk = torch.from_numpy(l1_np).to(dev)
        p_def, p_pk = rrx_compile(pattern, dev), rrx_compile(pattern, dev, backend="packed")
        if p_pk.engine.backend != "packed" or p_pk.engine.device_scanner is not None:
            fail(f"{pattern[:30]!r} with backend='packed' routed to {p_pk.engine.backend}")
        got = p_pk.engine.match_stats(d_pk, l_pk, seeded=True)
        want = p_def.engine.match_stats(d_pk, l_pk, seeded=True)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{pattern[:30]!r} packed match_stats != the default route")
        cnt_np, first_np = got[0].cpu().numpy(), got[1].cpu().numpy()
        texts = [d_np[i, : l1_np[i]].tobytes() for i in range(d_np.shape[0])]
        ref = [key_stats(words_k, t) for t in texts]
        if (cnt_np.tolist() != [c for c, _ in ref] or first_np.tolist() != [f for _, f in ref]):
            fail(f"{pattern[:30]!r} packed match_stats != re")
        L13 = d_np.shape[1]
        bms = {}
        for what in ("ends_bitmap", "starts_bitmap"):
            bms[what] = getattr(p_pk.engine, what)(d_pk, l_pk, L13)
            if not np.array_equal(bms[what], getattr(p_def.engine, what)(d_pk, l_pk, L13)):
                fail(f"{pattern[:30]!r} packed {what} != the default route")
        rx = re.compile(b"(?=(" + b"|".join(w.encode() for w in words_k) + b"))")
        for i in range(0, d_np.shape[0], 7):
            t = texts[i]
            ms_ = [(m.start(), m.start() + len(m.group(1))) for m in rx.finditer(t)]
            if (set(np.nonzero(bms["ends_bitmap"][i])[0].tolist()) != {e for _, e in ms_}
                    or set(np.nonzero(bms["starts_bitmap"][i])[0].tolist())
                    != {s_ for s_, _ in ms_}):
                fail(f"{pattern[:30]!r} bitmaps != re at record {i}")
        rxs = re.compile("|".join(words_k).encode())
        want_sp = [[m.span() for m in rxs.finditer(t)] for t in texts]
        f0 = PK.first_end_from.launches
        t1 = time.perf_counter()
        got_sp = p_pk.finditer_batch(texts)
        pk_s = time.perf_counter() - t1
        n_rounds = PK.first_end_from.launches - f0
        if got_sp != want_sp or p_def.finditer_batch(texts) != want_sp:
            fail(f"{pattern[:30]!r} packed finditer_batch != the default route and re")
        if p_pk.finditer_batch(texts[:500], longest=True) != want_sp[:500]:
            fail(f"{pattern[:30]!r} packed greedy finditer_batch != re")
        pk_runs[pattern] = (d_pk, l_pk, p_def, p_pk)
        print(f"phase 13: {pattern[:30]!r} on the packed backend, 10 MB ({d_np.shape[0]} records): "
              f"match_stats (matches={int(cnt_np.sum())}), ends_bitmap, starts_bitmap == the "
              f"default route ({type(p_def.engine.device_scanner).__name__}) and re; "
              f"finditer_batch in {n_rounds} host rounds == re ({pk_s:.2f}s) [{card}]")

    # config 4 (a{1,300}, the counting tier) spans at 10 MB on the default
    # route: host rounds whose anchored rescans run rrx_stream_first_end
    pat4 = rrx_compile(CONFIG4, dev)
    if type(pat4.engine.device_scanner).__name__ != "CountScanner":
        fail(f"{CONFIG4} routed to {type(pat4.engine.device_scanner).__name__}")
    texts4 = [d1_np[i, : l1_np[i]].tobytes() for i in range(d1_np.shape[0])]
    rounds4 = {}
    for longest, form in ((False, "a{1,300}?"), (True, CONFIG4)):
        want_sp = [[m.span() for m in re.compile(form.encode()).finditer(t)] for t in texts4]
        f0 = PK.first_end_from.launches
        t1 = time.perf_counter()
        got_sp = pat4.finditer_batch(texts4, longest=longest)
        secs = time.perf_counter() - t1
        n_rounds = PK.first_end_from.launches - f0
        if got_sp != want_sp:
            fail(f"config 4 finditer_batch(longest={longest}) != re {form!r}")
        if n_rounds <= 0:
            fail("config 4's rescans did not run rrx_stream_first_end")
        rounds4[longest] = (n_rounds, secs)
        print(f"phase 13: config 4 {CONFIG4} finditer_batch(longest={longest}) on 10 MB "
              f"({len(texts4)} records): {sum(map(len, got_sp))} spans == re in {n_rounds} host "
              f"rounds on rrx_stream_first_end, {secs:.3f} s = {1e3 * secs / n_rounds:.2f} ms a "
              f"round [{card}]")

    # C3: container programs past the container kernels' caps on the XLA
    # backend, 1 MB (1024 records of 1024 B) with chains planted
    rng13 = np.random.default_rng(13)
    c3_np = rng13.choice(np.frombuffer(b"abcdexyz", np.uint8), size=(1024, 1024)).astype(np.uint8)
    c3_len = np.full(1024, 1024, np.int32)
    for i in range(0, 1024, 8):
        body = b"".join(rng13.choice([b"abc", b"de"], size=int(rng13.integers(1, 200))))
        w = (b"x" + body + b"y")[:1024]
        at = int(rng13.integers(0, 1024 - len(w) + 1))
        c3_np[i, at : at + len(w)] = np.frombuffer(w, np.uint8)
    c3_len[1:16:2] = 0
    for i in range(3, 24, 4):  # whole-record chains: fullmatch holds for one pattern
        chain = b"abcde" * int(rng13.integers(1, 100))
        chain = chain if i < 11 else b"x" + chain + b"y"
        c3_np[i, : len(chain)] = np.frombuffer(chain, np.uint8)
        c3_len[i] = len(chain)
    c3_texts = [c3_np[i, : c3_len[i]].tobytes() for i in range(1024)]
    c3_times = {}
    for pattern in C3_PATTERNS:
        t1 = time.perf_counter()
        p3 = rrx_compile(pattern, dev)
        build_s = time.perf_counter() - t1
        if p3.engine.backend != "xla" or p3.engine.device_scanner is not None:
            fail(f"{pattern!r} routed to {p3.engine.backend}")
        body = "(?:abc|de){1,420}"
        rx_g = re.compile(pattern.replace("(abc|de){1,420}", body).encode())
        rx_l = re.compile(pattern.replace("(abc|de){1,420}", body + "?").encode())
        rx_c = re.compile(b"abc|de" if pattern.startswith("(") else rx_g.pattern)
        times = {}
        t1 = time.perf_counter()
        cnt3 = p3.count_batch(c3_texts)
        times["count"] = time.perf_counter() - t1
        if cnt3.tolist() != [len(rx_c.findall(t)) for t in c3_texts]:
            fail(f"{pattern!r} count_batch != re")
        t1 = time.perf_counter()
        full3 = p3.fullmatch_batch(c3_texts)
        times["fullmatch"] = time.perf_counter() - t1
        want_full = [rx_g.fullmatch(t) is not None for t in c3_texts]
        if full3.tolist() != want_full or not any(want_full):
            fail(f"{pattern!r} fullmatch_batch != re ({sum(want_full)} whole-record matches)")
        for longest, rx in ((False, rx_l), (True, rx_g)):
            t1 = time.perf_counter()
            got_sp = p3.finditer_batch(c3_texts, longest=longest)
            times[f"spans longest={longest}"] = time.perf_counter() - t1
            if got_sp != [[m.span() for m in rx.finditer(t)] for t in c3_texts]:
                fail(f"{pattern!r} finditer_batch(longest={longest}) != re")
        c3_times[pattern] = times
        print(f"phase 13: C3 {pattern!r} ({p3.n_states} states, {p3.tier}) on the XLA backend "
              f"(compile {build_s:.2f}s), 1 MB: count ({int(cnt3.sum())} ends), fullmatch "
              f"({int(full3.sum())}), lazy and greedy spans == re; seconds "
              f"{ {k: round(v, 3) for k, v in times.items()} } [{card}]")

    # C2: Pattern.long of sparse-tier programs that no rewrite takes, on
    # LongScanner over the XLA tables (pass 1: S + 1 pseudo-records a block
    # through [., S] x [S, S] float32 products), 64 KiB strings against re
    c2_times = {}
    for pattern in (CONFIG13_X, CONFIG10):
        n2 = 1 << 16
        s2 = bytearray(rng13.choice(np.frombuffer(b"abcdexyz", np.uint8), size=n2).tobytes())
        for at in range(1000, n2 - 2000, 9000):
            # chains of copies on both sides of the bounds (1..300, 400..520)
            if pattern == CONFIG10:
                k = int(rng13.integers(395, 531))
                nab = int(rng13.integers(0, k + 1))
                w = b"x" + b"ab" * nab + b"c" * (k - nab) + b"y"
            else:
                w = b"x" + b"abcde" * int(rng13.integers(50, 161)) + b"y"
            s2[at : at + len(w)] = w
        s2 = bytes(s2)
        lp = rrx_compile(pattern, dev).long
        if type(lp).__name__ != "LongScanner":
            fail(f"Pattern.long({pattern!r}) took {type(lp).__name__}")
        rx = re.compile(pattern.replace("(", "(?:").encode())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_ends = lp.count_ends(s2)
        torch.cuda.synchronize()
        c2_times[pattern] = time.perf_counter() - t1
        want = len(rx.findall(s2))
        if n_ends != want or want == 0:
            fail(f"Pattern.long({pattern!r}).count_ends over 64 KiB = {n_ends} != re {want}")
        print(f"phase 13: C2 Pattern.long({pattern!r}) ({lp.tables['F'].shape[0]} states, "
              f"LongScanner, block {lp.block}): count_ends over 64 KiB = {n_ends} == re in "
              f"{c2_times[pattern]:.2f} s [{card}]")
    torch.cuda.synchronize()
    stream_launches = {name: launches()[name] for name in STREAM_KERNELS}
    for name, n in stream_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the packed backend's path")
    print(f"packed backend and rescan path launches: {stream_launches} "
          f"({time.perf_counter() - t13:.1f}s for the phase)")

    # -- phase 14: the slotted SWAR and the stream-fed container methods (run
    # before 7; counts from here to its last run)
    reset_launches()
    t14 = time.perf_counter()
    set_config(base_cfg.with_(swar_multi=True))  # RRX_SWAR_MULTI=1
    try:
        mp6s = MultiPattern(CONFIG6, dev)
    finally:
        set_config(base_cfg)
    sc6s = mp6s.engine.device_scanner
    if not isinstance(sc6s, scan_swar.SwarMultiScanner):
        fail(f"config 6 with RRX_SWAR_MULTI=1 routed to {type(sc6s).__name__}")
    t0 = time.perf_counter()
    cnt6s = mp6s.count_batch(texts6)
    count6s_ms = (time.perf_counter() - t0) * 1e3
    rx6 = [[re.compile(x) for x in xs] for xs in CONFIG6_ENDS_RE]
    want6s = np.array([[len({m.start() + len(m.group(1)) for rx in rxs for m in rx.finditer(t)})
                        for rxs in rx6] for t in texts6])
    if not np.array_equal(cnt6s, want6s):
        bad = np.nonzero((cnt6s != want6s).any(axis=1))[0][:5].tolist()
        fail(f"config 6 slotted count_batch != re at records {bad}")
    if not np.array_equal(cnt6s, cnt6):
        fail("config 6 slotted count_batch != the u32-word tier's (phase 8)")
    c6s, f6s, _ = (x.reshape(R, 4) for x in mp6s.engine.match_stats(big6, len6, seeded=True))
    if not (torch.equal(c6s, c6) and torch.equal(f6s, f6)):
        fail("config 6 1 GiB slotted (cnt, first) != the u32-word tier's (phase 8)")
    print(f"phase 14: config 6 {CONFIG6} with RRX_SWAR_MULTI=1 ({type(sc6s).__name__}, "
          f"{sc6s.tables.deltas.numel()} deltas): count_batch on {len(texts6)} records "
          f"({count6s_ms:.1f} ms, matches {cnt6s.sum(axis=0).tolist()}) == re and == the u32-word "
          f"tier; the 1 GiB engine match_stats == the u32-word tier's on every record")

    # the stream-fed container methods on the records of phases 10 and 11:
    # K120 (10 MB of log text) and config 13 on its container tier
    # (SparseScanner), config 10 (BitbandScanner, its container tables built
    # at the first stream call), each against the byte path's methods
    def stream_vs_bytes(sc, d, ln, tag):
        t_s = time.perf_counter()
        words = scan_packed.mask_stream_from_bytes(scan_packed.stream_tables(sc.prog, dev), d, ln)
        lg = ln.reshape(-1, 1)
        out = {}
        for seeded in (True, False):
            st = sc.match_stats(words, lg, seeded=seeded)
            by = sc.match_stats_b(d, lg, seeded=seeded)
            for label, x, y in zip(("cnt", "first", "any"), st, (by[0], by[1], by[4]), strict=True):
                if not torch.equal(x, y):
                    fail(f"{tag} match_stats(words, seeded={seeded}) {label} != match_stats_b")
            out[seeded] = int(st[0].sum().item())
            fl = sc.forward_flags(words, seeded=seeded)
            if not torch.equal(fl, sc.forward_flags_b(d, lg, seeded=seeded)):
                fail(f"{tag} forward_flags(words, seeded={seeded}) != forward_flags_b")
        hits = sc.reverse_hits(words)
        if not torch.equal(hits, sc.reverse_hits_b(d, lg)):
            fail(f"{tag} reverse_hits(words) != reverse_hits_b")
        torch.cuda.synchronize()
        print(f"phase 14: {tag} ({type(sc).__name__}, W = {words.shape[2]}, stream "
              f"{words.numel() * 4 / 2**30:.2f} GiB): match_stats seeded ({out[True]} ends) and "
              f"unseeded ({out[False]}), forward_flags seeded and unseeded, reverse_hits "
              f"({int(hits.sum().item())} hits) over the mask stream == the byte path's "
              f"({time.perf_counter() - t_s:.1f}s)")
        del words

    stream_vs_bytes(sc120, log10, len10, "K120 10 MB")
    stream_vs_bytes(eng13.device_scanner, d13, l13, "config 13 10 MB")
    if sc10._sparse is not None:
        fail("config 10's BitbandScanner built its container tables before a stream call")
    stream_vs_bytes(sc10, g10, gl10, "config 10 10 MB")
    torch.cuda.synchronize()
    new_launches = {name: launches()[name] for name in SWAR_MULTI_KERNELS + SPARSE_STREAM_KERNELS}
    for name, n in new_launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the slotted SWAR / stream-fed container path")
    print(f"slotted SWAR and stream-fed container path launches: {new_launches} "
          f"({time.perf_counter() - t14:.1f}s for the phase)")

    # -- phase 7: times ---------------------------------------------------
    # the plain versions' slice of a 1 GiB batch in phase 7: their one timed
    # run there and the kernels' outputs compared on it (the path phases
    # compare on n_slice records)
    n_slice7 = 4_096
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:
        """Print the seconds phase 7 spent since the last lap."""
        now = time.perf_counter()
        print(f"phase 7: {what} took {now - t_lap[0]:.1f}s")
        t_lap[0] = now

    def time_ms(fn, warm: int, runs: int, per_run: int = 1) -> float:
        """Median over ``runs`` of the CUDA-event time of ``per_run``
        back-to-back calls, divided by ``per_run``."""
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(per_run):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / per_run)
        return float(np.median(ts))

    def timed_once(fn):
        """(output, CUDA-event ms) of one call."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    props = torch.cuda.get_device_properties(0)
    max_threads = props.max_threads_per_multi_processor

    def kernel_bound(kind, ln, L, step_ops, *, cap=0, starts=None, end=None, greedy=None, P=1,
                     flags=0):
        """(bound_ms, bound_by) of one call, from this run's inputs: bytes
        read once and written once; integer operations = the steps the
        function needs x a floor of operations per step (``step_ops`` for
        the automaton step: 4 per delta of a (delta, table) form, 3 per
        word of a matmul-tier program's states (``state_words``, not the
        tile's); plus the per-step bookkeeping).
        Anchored rescans count the steps from each start to its end, greedy
        the steps of its spans."""
        ln = ln.to(torch.int64).clamp(0, L)
        R = ln.numel()
        nbytes = int(ln.sum())
        steps = nbytes + 2 * R
        hit_bytes = 4 * scan_bits.hit_words(L) * R
        if kind == "stats":
            return bound(nbytes + 4 * R, 13 * R, steps * (step_ops + 4))
        # P channels: the union accept test every step and, for each of this
        # run's ``flags`` (channel, step) flags, the channel's update
        if kind == "stats_mc":
            return bound(nbytes + 4 * R + 4 * P, 13 * R * P, steps * (step_ops + 2) + 4 * flags)
        # per step the reverse step, the first-position (union) test and the
        # hit word's bit; out: P hit-word planes; with ``flags`` (this run's
        # hit bits) 4 per (channel, firing step)
        if kind == "reverse_mb":
            return bound(nbytes + 4 * R, P * hit_bytes, steps * (step_ops + 3) + 4 * flags)
        # per step and channel: its hit bit and claim test, its seed gate;
        # with ``flags`` (this run's spans) 4 per (channel, emitting step)
        if kind == "lazy_spans_mb":
            return bound(nbytes + 4 * R + P * hit_bytes, (8 * cap + 4) * R * P,
                         steps * (step_ops + 4 + 2 * P) + 4 * flags)
        if kind in ("reverse", "flags"):
            return bound(nbytes + 4 * R, hit_bytes, steps * (step_ops + 2))
        if kind == "lazy_spans":
            return bound(nbytes + 4 * R + hit_bytes, 8 * R * cap + 4 * R, steps * (step_ops + 8))
        if kind == "anchor_end":
            st = starts.to(torch.int64)
            live = (st >= 0) & (st <= ln)
            span = torch.where(end >= 0, end.to(torch.int64) - st + 1, 1)
            rescan = int(torch.where(live, span, 0).sum())
            return bound(rescan + 8 * R, 4 * R, rescan * (step_ops + 2))
        s_g, e_g, c_g = (x.to(torch.int64) for x in greedy[:3])
        emitted = torch.arange(s_g.shape[1], device=s_g.device)[None, :] < c_g[:, None]
        rescan = int(torch.where(emitted, e_g - s_g + 1, 0).sum())
        return bound(rescan + 4 * R + hit_bytes, 8 * R * cap + 5 * R,
                     rescan * (step_ops + 2) + hit_bytes // 4)

    def occupancy(name, tables, rows):
        """Theoretical occupancy and grid fill; ``tables`` are a (delta,
        table) form, a matmul-tier tile or a counting plan."""
        if isinstance(tables, scan_pallas.NfaTables):
            size = tables.s_tile
        elif isinstance(tables, scan_pallas.CountTables):
            size = tables.k
        else:
            size = tables.deltas.numel()
        bps = ctypes.c_int(0)
        _build.check(lib.rrx_occupancy(_build.KERNELS.index(name), int(size),
                                       ctypes.byref(bps)), "rrx_occupancy")
        tpb = lib.rrx_threads_per_block()
        blocks = -(-rows // tpb)
        resident = min(blocks, bps.value * n_sm)
        return (f"theoretical {bps.value * tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * tpb / max_threads:.1f}%); grid {blocks} blocks of {tpb} "
                f"-> at most {100.0 * resident * tpb / (n_sm * max_threads):.1f}% of the card's "
                f"resident-thread slots filled")

    def occupancy_channels(kind, size, P_, rows):
        """Theoretical occupancy and grid fill of a P-channel kernel (``size``:
        the delta count of a word-tier table, else s_tile)."""
        idx = ("word", "nfa", "reverse_mb", "lazy_spans_mb").index(kind)
        bps = ctypes.c_int(0)
        _build.check(lib.rrx_occupancy_channels(idx, int(size), int(P_), ctypes.byref(bps)),
                     "rrx_occupancy_channels")
        tpb = lib.rrx_threads_per_block()
        blocks = -(-rows // tpb)
        resident = min(blocks, bps.value * n_sm)
        return (f"theoretical {bps.value * tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * tpb / max_threads:.1f}%); grid {blocks} blocks -> at most "
                f"{100.0 * resident * tpb / (n_sm * max_threads):.1f}% of the resident-thread slots")

    # kernel against plain at the shapes the API batches above gave it
    for pat, texts_a in api_batches:
        sc = pat.engine.device_scanner
        name = "rrx_swar_stats" if isinstance(sc, scan_swar.SwarScanner) else "rrx_word_stats"
        data_a, lengths_a, _, _ = pat._pack(texts_a)
        d = torch.from_numpy(data_a).to(dev)
        ln = torch.from_numpy(lengths_a).to(dev)
        for seeded in (True, False):
            kw = dict(seeded=seeded, lead=0, nullable=pat.program.nullable)
            compare(name, entries[name][0](d, ln, sc.tables, **kw),
                    scan_bits.stats_plain(d, ln, sc.tables, **kw),
                    f"{pat.pattern!r} API batch {tuple(d.shape)}")
    print("phase 7: kernel == plain on the phase-3 API batches, seeded and unseeded")

    # the config-1 headline at its own shape: the windowed batch
    sc = eng.device_scanner
    d10 = torch.from_numpy(data_p).to(dev)
    l10 = torch.from_numpy(lengths_p).to(dev)
    k, w, h = win
    wind, lnw, _ = sc.windows(d10, l10, k, w, h)
    kw = dict(seeded=True, lead=h, nullable=False)
    got = scan_swar.swar_stats(wind, lnw, sc.tables, **kw)
    compare("rrx_swar_stats", got, scan_bits.stats_plain(wind, lnw, sc.tables, **kw), "10 MB windows")
    n10 = int(lengths.sum())
    ms_k = time_ms(lambda: scan_swar.swar_stats(wind, lnw, sc.tables, **kw), warm=2, runs=7, per_run=20)
    ms_p = time_ms(lambda: scan_bits.stats_plain(wind, lnw, sc.tables, **kw), warm=0, runs=1)
    ms_e = time_ms(lambda: sc.match_stats_b(d10, l10.reshape(-1, G), seeded=True), warm=2, runs=7, per_run=20)
    print(f"phase 7: rrx_swar_stats config 1 windows [{wind.shape[0]} x {wind.shape[1]}]: "
          f"kernel {ms_k:.3f} ms = {n10 / ms_k / 1e6:.1f} GB/s, plain {ms_p:.3f} ms = "
          f"{n10 / ms_p / 1e6:.2f} GB/s; match_stats_b end to end {ms_e:.3f} ms = "
          f"{n10 / ms_e / 1e6:.1f} GB/s [{card}]")
    print(f"  occupancy rrx_swar_stats (10 MB windows): "
          f"{occupancy('rrx_swar_stats', sc.tables, wind.shape[0])}")

    kernels = []
    for name, pattern in (("rrx_swar_stats", "cat|dog"), ("rrx_word_stats", WORD_BENCH)):
        wrapper, spec_fn, tables_fn, _ = entries[name]
        prog = compile_program(pattern)
        tables = scan_bits.device_tables(*tables_fn(spec_fn(prog)), dev)
        kw = dict(seeded=True, lead=0, nullable=prog.nullable)
        got = wrapper(big, big_len, tables, **kw)
        want = scan_bits.stats_plain(big, big_len, tables, **kw)
        compare(name, got, want, f"{pattern!r} 1 GiB")
        if name == "rrx_swar_stats" and not torch.equal(got[0], bcnt):
            fail("1 GiB engine count != direct kernel count")
        ms = time_ms(lambda: wrapper(big, big_len, tables, **kw), warm=2, runs=7, per_run=5)
        plain_ms = time_ms(lambda: scan_bits.stats_plain(big, big_len, tables, **kw), warm=0, runs=1)
        print(f"phase 7: {name} {pattern!r} 1 GiB: kernel {ms:.3f} ms = {nbytes / ms / 1e6:.1f} GB/s, "
              f"plain {plain_ms:.3f} ms = {nbytes / plain_ms / 1e6:.2f} GB/s, outputs equal "
              f"[{card}]")
        bnd = kernel_bound("stats", big_len, L, 4 * tables.deltas.numel())
        print(f"  occupancy {name} (1 GiB): {occupancy(name, tables, R)}; registers "
              f"{regs_of('scan_stats_kernel')}; bound {bnd[0]:.4f} ms by {bnd[1]}")
        kernels.append({
            "name": name, "route": "cuda", "source": STATS_SOURCE, "replaces": REPLACES[name],
            "launches": stats_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "shape": f"1 GiB, {pattern}",
        })

    lap("the stats kernels")

    # the span kernels at config 7's shape (10 MB, unwindowed) and at 1 GiB
    tables = sc.tables
    span_ms = {}
    for shape, d, ln, nb, runs in (("config 7, 10 MB", d10, l10, n10, 7),
                                   ("1 GiB", big, big_len, nbytes, 3)):
        lazy0 = scan_swar.swar_lazy_spans(d, ln, tables, scan_swar.swar_reverse(d, ln, tables), cap7)
        starts = lazy0[0][:, 0].contiguous()  # first lazy start per record, -1 if none
        hits, _ = check_spans(tables, d, ln, shape, starts=starts, caps=(cap7,))
        if shape == "1 GiB":
            s1, e1, c1 = lazy0
            if int(c1.max()) > cap7 or not torch.equal(c1, bcnt):
                fail("1 GiB lazy span counts != match-end counts of cat|dog")
        calls = {
            "rrx_swar_reverse": (lambda: scan_swar.swar_reverse(d, ln, tables),
                                 lambda: scan_bits.reverse_plain(d, ln, tables)),
            "rrx_swar_lazy_spans": (lambda: scan_swar.swar_lazy_spans(d, ln, tables, hits, cap7),
                                    lambda: scan_bits.lazy_spans_plain(d, ln, tables, hits, cap7)),
            "rrx_swar_anchor_end": (
                lambda: scan_swar.swar_anchor_end(d, ln, tables, starts, longest=True),
                lambda: scan_bits.anchor_plain(d, ln, tables, starts, longest=True)),
            "rrx_swar_greedy_spans": (lambda: scan_swar.swar_greedy_spans(d, ln, tables, hits, cap7),
                                      lambda: scan_bits.greedy_spans_plain(d, ln, tables, hits, cap7)),
        }
        greedy0 = scan_swar.swar_greedy_spans(d, ln, tables, hits, cap7)
        end0 = scan_swar.swar_anchor_end(d, ln, tables, starts, longest=True)
        for name, (kern, plain) in calls.items():
            ms = time_ms(kern, warm=2, runs=7, per_run=5)
            plain_ms = time_ms(plain, warm=0, runs=1)
            bnd = kernel_bound(name.split("_", 2)[2], ln, d.shape[1], 4 * tables.deltas.numel(),
                               cap=cap7, starts=starts, end=end0, greedy=greedy0)
            span_ms[name, shape] = (ms, plain_ms, bnd)
            print(f"phase 7: {name} cat|dog {shape} [{d.shape[0]} x {d.shape[1]}]: kernel "
                  f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s, plain {plain_ms:.3f} ms = "
                  f"{nb / plain_ms / 1e6:.3f} GB/s [{card}]")
            print(f"  occupancy {name} ({shape}): {occupancy(name, tables, d.shape[0])}; "
                  f"registers {regs_of(name[4:] + '_kernel')}; bound {bnd[0]:.4f} ms by {bnd[1]}")
        for policy, fn in (("lazy_spans", lambda: eng.lazy_spans(d, ln, cap=cap7)),
                           ("greedy_spans", lambda: eng.greedy_spans(d, ln, cap=cap7))):
            ms = time_ms(fn, warm=2, runs=7, per_run=5)
            print(f"phase 7: ScanEngine.{policy} end to end (data on the card), {shape}: "
                  f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s [{card}]")
    for name in SPAN_KERNELS:
        ms, plain_ms, bnd = span_ms[name, "config 7, 10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": SPANS_SOURCE, "replaces": REPLACES[name],
            "launches": span_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "shape": "config 7, 10 MB, cat|dog",
        })

    lap("the SWAR span kernels")

    # the matmul-tier kernels at config 7's 10 MB shape and at 1 GiB, on the
    # phase-5 log text; plain versions on the whole 10 MB batch and on the
    # first n_slice7 records of the 1 GiB batch (kernel outputs compared there)
    P = scan_pallas
    nfa_ms = {}
    for pattern in keyed:
        eng_k = nfa_engines[pattern]
        tables = eng_k.device_scanner.nfa
        step_ops = 3 * state_words(eng_k.prog)
        tag = f"{eng_k.prog.n_states}-state"
        for shape, d, ln in (("10 MB", log10, len10), ("1 GiB", log, log_len)):
            hits = P.nfa_reverse(d, ln, tables)
            lazy0 = P.nfa_lazy_spans(d, ln, tables, hits, cap_k)
            starts = lazy0[0][:, 0].contiguous()
            greedy0 = P.nfa_greedy_spans(d, ln, tables, hits, cap_k, nullable=False)
            end0 = P.nfa_anchor_end(d, ln, tables, starts, longest=True)
            plain_t = {}  # 1 GiB: the compared plain run's time is the plain time
            if shape == "10 MB":
                check_nfa(tables, d, ln, f"{tag} 10 MB", nullable=False, lead=0, starts=starts,
                          caps=(cap_k,))
                pd, pl, ph, pst, n = d, ln, hits, starts, d.shape[0]
            else:
                n = n_slice7
                pd, pl, pst = d[:n].contiguous(), ln[:n].contiguous(), starts[:n].contiguous()
                ph, plain_t["rrx_nfa_reverse"] = timed_once(
                    lambda: scan_bits.reverse_plain(pd, pl, tables))
                kw = dict(seeded=True, lead=0, nullable=False)
                outs = {
                    "rrx_nfa_stats": (P.nfa_stats(d, ln, tables, **kw),
                                      lambda: P.stats_plain(pd, pl, tables, **kw)),
                    "rrx_nfa_reverse": ([hits[:, :n]], lambda: [ph]),
                    "rrx_nfa_anchor_end": ([end0], lambda: [scan_bits.anchor_plain(pd, pl, tables, pst, longest=True)]),
                    "rrx_nfa_lazy_spans": (lazy0, lambda: scan_bits.lazy_spans_plain(pd, pl, tables, ph, cap_k)),
                    "rrx_nfa_greedy_spans": (greedy0, lambda: scan_bits.greedy_spans_plain(
                        pd, pl, tables, ph, cap_k, nullable=False)),
                }
                for name, (got, plain_fn) in outs.items():
                    want, ms_p = timed_once(plain_fn)
                    plain_t.setdefault(name, ms_p)
                    got = [x[:, :n] if name == "rrx_nfa_reverse" else x[:n] for x in got]
                    compare(name, got, want, f"{tag} 1 GiB, first {n} records",
                            tuple(str(i) for i in range(len(want))))
            calls = {
                "rrx_nfa_stats": (lambda: P.nfa_stats(d, ln, tables, seeded=True),
                                  lambda: P.stats_plain(pd, pl, tables, seeded=True, lead=0,
                                                        nullable=False)),
                "rrx_nfa_reverse": (lambda: P.nfa_reverse(d, ln, tables),
                                    lambda: scan_bits.reverse_plain(pd, pl, tables)),
                "rrx_nfa_anchor_end": (
                    lambda: P.nfa_anchor_end(d, ln, tables, starts, longest=True),
                    lambda: scan_bits.anchor_plain(pd, pl, tables, pst, longest=True)),
                "rrx_nfa_lazy_spans": (lambda: P.nfa_lazy_spans(d, ln, tables, hits, cap_k),
                                       lambda: scan_bits.lazy_spans_plain(pd, pl, tables, ph, cap_k)),
                "rrx_nfa_greedy_spans": (
                    lambda: P.nfa_greedy_spans(d, ln, tables, hits, cap_k, nullable=False),
                    lambda: scan_bits.greedy_spans_plain(pd, pl, tables, ph, cap_k, nullable=False)),
            }
            nb = int(ln.to(torch.int64).sum())
            for name, (kern, plain) in calls.items():
                ms = time_ms(kern, warm=2, runs=7, per_run=5)
                plain_ms = plain_t[name] if name in plain_t else time_ms(plain, warm=0, runs=1)
                bnd = kernel_bound(name.split("_", 2)[2], ln, d.shape[1], step_ops, cap=cap_k,
                                   starts=starts, end=end0, greedy=greedy0)
                nfa_ms[name, pattern, shape] = (ms, plain_ms, bnd)
                print(f"phase 7: {name} {tag} {shape} [{d.shape[0]} x {d.shape[1]}]: kernel "
                      f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s, plain {plain_ms:.3f} ms on {n} "
                      f"records; bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]")
                print(f"  occupancy {name} ({shape}): {occupancy(name, tables, d.shape[0])}; "
                      f"registers {regs_of(name[4:] + '_kernel')}")
            for what, fn in (("match_stats", lambda: eng_k.match_stats(d, ln, seeded=True)),
                             ("lazy_spans", lambda: eng_k.lazy_spans(d, ln, cap=cap_k)),
                             ("greedy_spans", lambda: eng_k.greedy_spans(d, ln, cap=cap_k))):
                ms = time_ms(fn, warm=2, runs=7, per_run=5)
                print(f"phase 7: ScanEngine.{what} {tag} end to end (data on the card), {shape}: "
                      f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s [{card}]")
    for name in NFA_KERNELS:
        ms, plain_ms, bnd = nfa_ms[name, K30, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": NFA_SOURCE, "replaces": REPLACES[name],
            "launches": nfa_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "shape": f"config 7's 10 MB shape, {len(K30_WORDS)}-keyword log text",
        })

    # rrx_nfa_flags on the keyword log text (K30) at 10 MB and 1 GiB
    tables = nfa_engines[K30].device_scanner.nfa
    step_ops = 3 * state_words(nfa_engines[K30].prog)
    flags_ms = {}
    for shape, d, ln in (("10 MB", log10, len10), ("1 GiB", log, log_len)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        got = P.nfa_flags(d, ln, tables, seeded=True)
        # the plain version's one timed run is also the reference
        want, plain_ms = timed_once(lambda: P.flags_plain(pd, pl, tables, seeded=True))
        compare("rrx_nfa_flags", [got[:, :n]], [want], f"K30 {shape}, first {n} records",
                ("flags",))
        ms = time_ms(lambda: P.nfa_flags(d, ln, tables, seeded=True), warm=2, runs=7, per_run=5)
        bnd = kernel_bound("flags", ln, d.shape[1], step_ops)
        nb = int(ln.to(torch.int64).sum())
        flags_ms[shape] = (ms, plain_ms, bnd)
        print(f"phase 7: rrx_nfa_flags K30 {shape} [{d.shape[0]} x {d.shape[1]}]: kernel {ms:.4f} ms "
              f"= {nb / ms / 1e6:.1f} GB/s, plain {plain_ms:.3f} ms on {n} records; bound "
              f"{bnd[0]:.4f} ms by {bnd[1]} [{card}]")
        print(f"  occupancy rrx_nfa_flags ({shape}): {occupancy('rrx_nfa_flags', tables, d.shape[0])}; "
              f"registers {regs_of('nfa_flags_kernel')}")
    ms = time_ms(lambda: nfa_engines[K30].ends_bitmap(log10, len10, L), warm=1, runs=5)
    print(f"phase 7: ScanEngine.ends_bitmap K30 end to end (words path, bitmap to the host), 10 MB: "
          f"{ms:.3f} ms [{card}]")

    lap("the matmul-tier kernels")

    # the counting kernels on config 4 at 10 MB and 1 GiB
    ct4 = sc4.tables
    d10_4 = torch.from_numpy(data).to(dev)
    l10_4 = torch.from_numpy(lengths).to(dev)
    count_ms = {}
    for shape, d, ln in (("10 MB", d10_4, l10_4), ("1 GiB", big4, big_len)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        kw = dict(seeded=True, lead=0, nullable=False)
        calls = {
            "rrx_count_stats": (lambda: P.count_stats(d, ln, ct4, **kw),
                                lambda: P.count_stats_plain(pd, pl, ct4, **kw)),
            "rrx_count_flags": (lambda: P.count_flags(d, ln, ct4, seeded=True),
                                lambda: P.count_flags_plain(pd, pl, ct4, seeded=True)),
            "rrx_count_reverse": (lambda: P.count_reverse(d, ln, ct4),
                                  lambda: P.count_reverse_plain(pd, pl, ct4)),
        }
        nb = int(ln.to(torch.int64).sum())
        for name, (kern, plain) in calls.items():
            got, (want, plain_ms) = kern(), timed_once(plain)  # the timed plain run is the reference
            if name == "rrx_count_stats":
                compare(name, [x[:n] for x in got], want, f"config 4 {shape}, first {n} records")
            else:
                compare(name, [got[:, :n]], [want], f"config 4 {shape}, first {n} records", ("words",))
            ms = time_ms(kern, warm=2, runs=7, per_run=5)
            bnd = kernel_bound(name.split("_", 2)[2], ln, d.shape[1], COUNT_STEP_OPS)
            count_ms[name, shape] = (ms, plain_ms, bnd)
            print(f"phase 7: {name} config 4 {shape} [{d.shape[0]} x {d.shape[1]}]: kernel "
                  f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s, plain {plain_ms:.3f} ms on {n} records; "
                  f"bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]")
            print(f"  occupancy {name} ({shape}): {occupancy(name, ct4, d.shape[0])}; registers "
                  f"{regs_of(name[4:] + '_kernelILi1E')}")
        for what, fn in (("match_stats", lambda: eng4.match_stats(d, ln, seeded=True)),
                         ("ends_bitmap", lambda: eng4.ends_bitmap(d, ln, L)),
                         ("starts_bitmap", lambda: eng4.starts_bitmap(d, ln, L))):
            if what != "match_stats" and shape == "1 GiB":
                continue  # the host unpacks one bool per position: 10 MB only
            ms = time_ms(fn, warm=1, runs=5)
            print(f"phase 7: ScanEngine.{what} config 4 end to end (data on the card; bitmaps by the "
                  f"words path, to the host), {shape}: "
                  f"{ms:.3f} ms [{card}]")
    # where config 4's ends_bitmap goes at 10 MB: the clamped words on the
    # card (kernel + word clamp), the host's fetch and unpacking of them, and
    # in the same process the route of unpacked flags (scan_xla.ends_bitmap:
    # [B, L + 3] bools and a scatter), which the engine no longer takes
    lg4 = l10_4.reshape(-1, 1)

    def words_on_card():
        w, _ = sc4.flags_words_b(d10_4, lg4, seeded=True)
        return eng4._clamp_words(w.to(torch.int64) & 0xFFFFFFFF, l10_4, False)

    def unpacked_on_card():
        fl = sc4.forward_flags_b(d10_4, lg4, seeded=True)
        return scan_xla.ends_bitmap(fl, l10_4, L, False, seeded=True)

    if not np.array_equal(eng4._fetch_words_bitmap(words_on_card(), L), unpacked_on_card().cpu().numpy()):
        fail("config 4 ends_bitmap: the words path != scan_xla.ends_bitmap over the unpacked flags")
    words4 = words_on_card()
    ms_w = time_ms(words_on_card, warm=1, runs=5)
    ms_u = time_ms(unpacked_on_card, warm=1, runs=5)
    ms_f = time_ms(lambda: eng4._fetch_words_bitmap(words4, L), warm=1, runs=5)
    ms_e = time_ms(lambda: eng4.ends_bitmap(d10_4, l10_4, L), warm=1, runs=5)
    print(f"phase 7: config 4 ends_bitmap 10 MB, one process: whole call {ms_e:.3f} ms = words on the "
          f"card {ms_w:.3f} ms + host fetch and unpacking {ms_f:.3f} ms; unpacked-flags route on the "
          f"card (no fetch) {ms_u:.3f} ms [{card}]")
    for shape, d, ln in (("10 MB", torch.from_numpy(data).to(dev), torch.from_numpy(lengths).to(dev)),
                         ("1 GiB", big, big_len)):
        ms = time_ms(lambda: eng13.match_stats(d, ln, seeded=True), warm=1, runs=5)
        print(f"phase 7: ScanEngine.match_stats config 13 through its alias, {shape}: {ms:.3f} ms "
              f"[{card}]")

    # one anchored rescan (scan_packed.first_end_from on rrx_stream_first_end,
    # the mask stream built in the call) at the API's shape
    pat4 = rrx_compile(CONFIG4, dev)
    d_api, l_api, _, _ = pat4._pack(span_texts)
    bm_api = pat4.engine.starts_bitmap(d_api, l_api, d_api.shape[1])
    st_api = np.where(bm_api.any(axis=1), bm_api.argmax(axis=1), -1).astype(np.int32)
    ms = time_ms(lambda: pat4.engine.first_end_from(d_api, l_api, st_api, longest=True), warm=1, runs=5)
    print(f"phase 7: ScanEngine.first_end_from (longest; rrx_stream_first_end) of {CONFIG4} from "
          f"each record's first start, "
          f"[{d_api.shape[0]} x {d_api.shape[1]}]: {ms:.3f} ms [{card}]")

    lap("the counting kernels and the bitmaps")

    # the multi-pattern kernels: config 6 (P = 4) on the u32-word tier and its
    # span channels at 10 MB and 1 GiB, K7 as 7 patterns (P = 7) on the
    # matmul tier over the log text; plain versions on the whole 10 MB batch
    # and on the first n_slice7 records of the 1 GiB batches
    mp_ms = {}
    for shape, d, ln in (("10 MB", d10, l10), ("1 GiB", big6, len6)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        kw = dict(seeded=True, lead=0, nullable=False)
        tb6 = sc6.tables
        got = scan_word.word_stats(d, ln, tb6, **kw)
        compare("rrx_word_stats[P]", [x[:n] for x in got], scan_bits.stats_plain(pd, pl, tb6, **kw),
                f"config 6 {shape}, first {n} records")
        flags6 = int(got[0].to(torch.int64).sum())
        hits6 = P.nfa_reverse_mb(d, ln, sc6.nfa, sc6.span)
        ph6 = P.reverse_mb_plain(pd, pl, sc6.nfa, sc6.span)
        compare("rrx_nfa_reverse_mb", [hits6[:, :, :n]], [ph6], f"config 6 {shape}, first {n} records",
                ("hits",))
        lz = P.nfa_lazy_spans_mb(d, ln, sc6.nfa, sc6.span, hits6, cap_k)
        compare("rrx_nfa_lazy_spans_mb", [x[:n] for x in lz],
                P.lazy_spans_mb_plain(pd, pl, sc6.nfa, sc6.span, ph6, cap_k),
                f"config 6 {shape}, first {n} records", ("starts", "ends", "cnt"))
        d7, l7 = (log10, len10) if shape == "10 MB" else (log, log_len)
        n7 = d7.shape[0] if shape == "10 MB" else n_slice7
        pd7, pl7 = d7[:n7].contiguous(), l7[:n7].contiguous()
        got7 = P.nfa_stats(d7, l7, sc7.nfa, **kw)
        compare("rrx_nfa_stats[P]", [x[:n7] for x in got7], P.stats_plain(pd7, pl7, sc7.nfa, **kw),
                f"K7 x 7 {shape}, first {n7} records")
        flags7 = int(got7[0].to(torch.int64).sum())
        W6, W7 = 4 * tb6.deltas.numel(), 3 * state_words(mp7.engine.prog)
        calls = {
            "rrx_word_stats[P]": (lambda: scan_word.word_stats(d, ln, tb6, **kw),
                                  lambda: scan_bits.stats_plain(pd, pl, tb6, **kw),
                                  kernel_bound("stats_mc", ln, d.shape[1], W6, P=4, flags=flags6),
                                  d.shape[0], n, ("word", tb6.deltas.numel(), 4)),
            "rrx_nfa_stats[P]": (lambda: P.nfa_stats(d7, l7, sc7.nfa, **kw),
                                 lambda: P.stats_plain(pd7, pl7, sc7.nfa, **kw),
                                 kernel_bound("stats_mc", l7, d7.shape[1], W7, P=7, flags=flags7),
                                 d7.shape[0], n7, ("nfa", sc7.nfa.s_tile, 7)),
            "rrx_nfa_reverse_mb": (lambda: P.nfa_reverse_mb(d, ln, sc6.nfa, sc6.span),
                                   lambda: P.reverse_mb_plain(pd, pl, sc6.nfa, sc6.span),
                                   kernel_bound("reverse_mb", ln, d.shape[1], 3, P=4),
                                   d.shape[0], n, ("reverse_mb", sc6.nfa.s_tile, 4)),
            "rrx_nfa_lazy_spans_mb": (
                lambda: P.nfa_lazy_spans_mb(d, ln, sc6.nfa, sc6.span, hits6, cap_k),
                lambda: P.lazy_spans_mb_plain(pd, pl, sc6.nfa, sc6.span, ph6, cap_k),
                kernel_bound("lazy_spans_mb", ln, d.shape[1], 3, P=4, cap=cap_k),
                d.shape[0], n, ("lazy_spans_mb", sc6.nfa.s_tile, 4)),
        }
        for name, (kern, plain, bnd, rows_k, n_p, occ) in calls.items():
            ms = time_ms(kern, warm=2, runs=7, per_run=5)
            plain_ms = time_ms(plain, warm=0, runs=1)
            mp_ms[name, shape] = (ms, plain_ms, bnd)
            print(f"phase 7: {name} {shape} [{rows_k} x {L}]: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms on {n_p} records; bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]")
            print(f"  occupancy {name} ({shape}, P = {occ[2]}, channels in registers): "
                  f"{occupancy_channels(*occ, rows_k)}; at P = 16 (channels in global rows): "
                  f"{occupancy_channels(occ[0], occ[1], 16, rows_k)}; registers (template Li8E: "
                  f"channels in registers, Li0E: in global rows) "
                  f"{regs_of(('word_stats_mc', 'nfa_stats_mc', 'nfa_reverse_mb', 'nfa_lazy_spans_mb')[MP_KERNELS.index(name)])}")
        # MultiPattern's engine call against P single-pattern engine calls
        singles6 = [ScanEngine(compile_program(pat), device=dev) for pat in CONFIG6]
        ms_mp = time_ms(lambda: mp6.engine.match_stats(d, ln, seeded=True), warm=1, runs=5)
        ms_1 = time_ms(lambda: [e.match_stats(d, ln, seeded=True) for e in singles6], warm=1, runs=5)
        ms_sp = time_ms(lambda: sc6.lazy_spans_mb(d, ln.reshape(-1, max(mp6.program.G, 1)), cap=cap_k),
                        warm=1, runs=5)
        ms_s1 = time_ms(lambda: [e.lazy_spans(d, ln, cap=cap_k) for e in singles6], warm=1, runs=5)
        print(f"phase 7: config 6 {shape}, data on the card: MultiPattern engine match_stats "
              f"{ms_mp:.3f} ms vs {len(singles6)} single-pattern match_stats calls {ms_1:.3f} ms; "
              f"lazy_spans_mb (cap {cap_k}) {ms_sp:.3f} ms vs {len(singles6)} single-pattern "
              f"lazy_spans calls {ms_s1:.3f} ms [{card}]")
    singles7 = [ScanEngine(compile_program(w), device=dev) for w in K7_WORDS]
    ms_mp7 = time_ms(lambda: mp7.engine.match_stats(log, log_len, seeded=True), warm=1, runs=5)
    ms_17 = time_ms(lambda: [e.match_stats(log, log_len, seeded=True) for e in singles7], warm=1, runs=5)
    ms_k7 = time_ms(lambda: nfa_engines[K7].match_stats(log, log_len, seeded=True), warm=1, runs=5)
    print(f"phase 7: K7 1 GiB log text, data on the card: MultiPattern (7 channels) engine "
          f"match_stats {ms_mp7:.3f} ms vs 7 single-keyword match_stats calls {ms_17:.3f} ms vs one "
          f"K7 alternation {ms_k7:.3f} ms [{card}]")

    lap("the multi-pattern kernels")

    # the long-string window kernels at 1 GiB, in the geometry of the path
    # that launched them; plain versions on a 1 MiB string in the same
    # geometry (kernel == plain there too)
    long_ms = {}
    sc8_, sc14_, sc30_ = (long_pats[p_].long for p_ in (CONFIG8, CONFIG14, K30))
    small = 1 << 20

    def rev_geom(sc_, n):
        blk = sc_._ov_block(n)
        return P_.LongGeom(n, -(-(n + 2) // blk), blk, 0, blk + sc_.overlap)

    def warm_geom(n):
        blk, Ww = sc14_.block, get_config().spec_warmup
        return P_.LongGeom(n, -(-(n + 2) // blk), blk, Ww, Ww)

    def long_bound(kind, geom, W):
        """Bytes: the part of the string the windows cover, once, and the
        outputs once; operations: the windows' steps (overlaps included) x
        (3 per state word + 4)."""
        out = {"carry": 4 * W * geom.nw, "flags": 4 * geom.words, "count": 5 * geom.nw,
               "reverse": 4 * geom.words}[kind]
        read = min(geom.n, geom.nw // geom.rep * geom.T)
        return bound(read, out, geom.nw * geom.T * (3 * W + 4))

    long_calls = {  # name: (string, scanner, geometry at n, call of (data, geom), plain, work)
        "rrx_long_carry": (s14, sc14_, warm_geom,
                           lambda d, g: P_.long_carry(d, g, sc14_.tables, seeded=True),
                           lambda d, g: P_.long_carry_plain(d, g, sc14_.tables, seeded=True),
                           "carry", f"config 14 {CONFIG14} speculative warm-up"),
        "rrx_long_flags": (s8, sc8_, sc8_._ov_geom,
                           lambda d, g: P_.long_flags(d, g, sc8_.tables, seeded=True),
                           lambda d, g: P_.long_flags_plain(d, g, sc8_.tables, seeded=True),
                           "flags", f"config 8 {CONFIG8} overlapped windows"),
        "rrx_long_count": (s30, sc30_, sc30_._ov_geom,
                           lambda d, g: P_.long_count(d, g, sc30_.tables, seeded=True),
                           lambda d, g: P_.long_count_plain(d, g, sc30_.tables, seeded=True),
                           "count", "K30 (W = 8) overlapped windows"),
        "rrx_long_reverse": (s8, sc8_, lambda n: rev_geom(sc8_, n),
                             lambda d, g: P_.long_reverse(d, g, sc8_.tables),
                             lambda d, g: P_.long_reverse_plain(d, g, sc8_.tables),
                             "reverse", f"config 8 {CONFIG8} reverse windows"),
    }
    for name, (s_, sc_, geom_of, kern, plain, work, what) in long_calls.items():
        g1, gs = geom_of(NL), geom_of(small)
        d_small = s_[:small]
        got, want = kern(d_small, gs), plain(d_small, gs)
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        got, want = [x for x in got if x is not None], [x for x in want if x is not None]
        compare(name, got, want, f"{what}, 1 MiB", tuple(f"out{i}" for i in range(len(got))))
        ms = time_ms(lambda: kern(s_, g1), warm=1, runs=7)
        plain_ms = time_ms(lambda: plain(d_small, gs), warm=0, runs=1)
        tb, W = sc_.tables, state_words(sc_.prog)
        bnd = long_bound(work, g1, W)
        long_ms[name] = (ms, plain_ms, bnd, what)
        print(f"phase 7: {name} {what}, 1 GiB [{g1.nw} windows x {g1.T} steps, block {g1.block}, "
              f"{W} state words]: kernel {ms:.3f} ms = {NL / ms / 1e6:.1f} GB/s, plain {plain_ms:.1f} ms on "
              f"1 MiB; bound {bnd[0]:.4f} ms by {bnd[1]}; launches on the path "
              f"{long_launches[name]} [{card}]")
        print(f"  occupancy {name}: {occupancy(name, tb, g1.nw)}; registers "
              f"{regs_of(name.replace('rrx_', '') + '_kernel')}")
    # the other geometries of the path, timed once each
    g8c = sc8_._ov_geom(NL)
    ms_c8 = time_ms(lambda: P_.long_count(s8, g8c, sc8_.tables, seeded=True), warm=1, runs=5)
    S14 = long_pats[CONFIG14].program.n_states
    nb14 = -(-(NL + 2) // sc14_.block)
    vb = sc14_._basis_words().repeat(nb14, 1)
    gb = (torch.arange(nb14 * (S14 + 1), device=dev) % (S14 + 1)) == S14
    g1p = P_.LongGeom(NL, nb14 * (S14 + 1), sc14_.block, 0, sc14_.block, S14 + 1)
    ms_p1 = time_ms(lambda: P_.long_carry(s14, g1p, sc14_.tables, vb, gb, seeded=True), warm=1,
                    runs=5)
    print(f"phase 7: rrx_long_count config 8 (W = 1) overlapped windows 1 GiB: {ms_c8:.3f} ms; "
          f"rrx_long_carry summary pass 1 of config 14 ({S14 + 1} pseudo-records x {nb14} blocks "
          f"of {sc14_.block}): {ms_p1:.3f} ms [{card}]")
    # end to end: count_ends of each config with the string on the card
    e2e_ms = {}
    for label, p_, s_ in (("config 8", CONFIG8, s8), ("config 9", CONFIG9, s9),
                          ("config 12 ASCII", CONFIG12, s8), ("config 12 with bytes >= 0x80",
                                                              CONFIG12, s12),
                          ("config 14", CONFIG14, s14), (f"{SPEC_FAIL} (summary)", SPEC_FAIL, sf),
                          ("K30 log file", K30, s30)):
        sc_ = long_pats[p_].long
        e2e_ms[label] = time_ms(lambda: sc_.count_ends(s_), warm=1, runs=5)
    print("phase 7: long-string count_ends end to end, 1 GiB on the card (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in e2e_ms.items()) + f" [{card}]")

    lap("the long-string kernels")

    # the bitband kernels on config 10, every record scanned (the raw scan:
    # no prefilter), at 10 MB (plain versions on the whole batch) and at
    # 1 GiB (plain versions on the first n_slice7 records), with the bound of
    # PERF.md section 2: per step and record, Ws = ceil(n_states / 32)
    # words, 2 operations per word per diagonal (a funnel shift and an
    # AND-OR), 1 per word for the step's mask (one row, looked up by byte),
    # 2 + the nonzero words of its in-edge row per rank-1 column, 6 + 2 per
    # family per word of the triangle window, and the bookkeeping only on
    # the nonzero words of the rows it reads: the seed OR and the accept
    # test forward (the accept OR and the initial-state test in reverse: the
    # same rows); a rescan ORs its seed in once, so it charges the accept
    # test only
    spec10, tb10 = sc10.bspec, sc10.tables
    prog10 = eng10.prog
    Ws = -(-prog10.n_states // 32)
    nf10 = len(spec10.tri_gaps)

    def nz_words(states):
        return len(np.unique(np.asarray(states, dtype=np.int64) // 32))

    edges10 = prog10.nfa.get_edges()
    nz_seed = nz_words(np.flatnonzero(np.asarray(prog10.seed_row)[: prog10.n_states]))
    nz_acc = nz_words(np.flatnonzero(np.asarray(prog10.accept)[: prog10.n_states]))
    core10 = (2 * Ws * len(spec10.diags) + Ws
              + sum(2 + nz_words(edges10[edges10[:, 1] == 32 * w + b, 0]) for w, b in spec10.rank1)
              + ((6 + 2 * nf10) * (spec10.tri_win[1] - spec10.tri_win[0]) if nf10 else 0))
    step10 = core10 + nz_seed + nz_acc  # a seeded forward step
    rescan10 = core10 + nz_acc  # a step of an anchored rescan
    # the reverse register step: on a step whose u = R & mask is non-empty
    # the band step, the E row's OR and the vote on the initial-state row;
    # on a skipped step the row load and the vote
    skip10 = 1 + nz_seed
    busy10 = core10 + skip10
    print(f"phase 7: bitband bound of config 10: Ws = {Ws} words, {len(spec10.diags)} diagonals, "
          f"{len(spec10.rank1)} rank-1 columns, {nf10} families over "
          f"{spec10.tri_win[1] - spec10.tri_win[0]} window words, seed {nz_seed} and accept "
          f"{nz_acc} nonzero words: {step10} operations per scan step, {rescan10} per rescan step, "
          f"{busy10} per reverse step that runs the band step and {skip10} per skipped one")

    def bb_bound(kind, ln, L, *, C=1, starts=None, end=None, spans=None, cap=0, rows=None,
                 busy=None):
        """(bound_ms, bound_by) of one bitband call from this run's inputs:
        stats, flags and reverse scan every step of the records in ``rows``
        (all by default), the reverse with ``busy`` (reverse_busy's (busy
        steps, steps), scaled to these records) steps that run the band
        step and the rest skipped; the anchored rescan the steps from each
        start to its end (1 where it has none); the span rounds the steps of
        each emitted span, plus the hit words."""
        ln = ln.to(torch.int64).clamp(0, L)
        if rows is not None:
            ln = ln[:rows]
        R = ln.numel()
        nbytes = int(ln.sum())
        steps = nbytes + 2 * R
        hit_bytes = 4 * scan_bits.hit_words(L) * R
        if kind == "stats":
            return bound(nbytes + 4 * R, 13 * R * C, steps * step10)
        if kind == "flags":
            return bound(nbytes + 4 * R, hit_bytes * C, steps * step10)
        if kind == "reverse":
            n_busy = round(steps * busy[0] / busy[1])
            return bound(nbytes + 4 * R, hit_bytes, n_busy * busy10 + (steps - n_busy) * skip10)
        if kind == "anchor_end":
            st = starts.to(torch.int64)
            live = (st >= 0) & (st <= ln)
            rescan = int(torch.where(live, torch.where(end >= 0, end.to(torch.int64) - st + 1, 1),
                                     0).sum())
            return bound(rescan + 8 * R, 4 * R, rescan * rescan10)
        s_g, e_g, c_g = (x.to(torch.int64) for x in spans[:3])
        emitted = torch.arange(s_g.shape[1], device=s_g.device)[None, :] < c_g[:, None]
        rescan = int(torch.where(emitted, e_g - s_g + 1, 0).sum())
        return bound(rescan + 4 * R + hit_bytes, 8 * R * cap + 5 * R,
                     rescan * rescan10 + hit_bytes // 4)

    bb_tpb = lib.rrx_bitband_threads_per_block()

    def bb_occupancy(idx, rows):
        bps = ctypes.c_int(0)
        n_rows = tb10.tab_f.numel() // spec10.W if idx != 2 else tb10.tab_r.numel() // spec10.W
        _build.check(lib.rrx_bitband_occupancy(idx, spec10.W, n_rows, ctypes.byref(bps)),
                     "rrx_bitband_occupancy")
        blocks = -(-rows // (bb_tpb // 32))
        resident = min(blocks, bps.value * n_sm)
        return (f"theoretical {bps.value * bb_tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * bb_tpb / max_threads:.1f}%, one warp per record); grid "
                f"{blocks} blocks of {bb_tpb} -> at most "
                f"{100.0 * resident * bb_tpb / (n_sm * max_threads):.1f}% of the resident-thread "
                f"slots")

    def bb_cycles(ms, ln):
        """Warp-scheduler cycles a record-step: the time x the clock x 4
        schedulers an SM / the record-steps (len + 2 a record)."""
        return ms * 1e6 * CLOCK_GHZ * 4 * n_sm / int((ln.to(torch.int64).clamp(0, L) + 2).sum())

    # the register steps; the old step
    for kern in ("bb_stats_kernel", "bb_reverse_kernel", "bb_flags_kernel"):
        bb_spill = {n: b for n, b in spilled.items() if re.search(r"\d" + kern, n)}
        print(f"phase 7: {kern}: registers {regs_of(kern)}; spill bytes "
              f"{bb_spill or 'not reported'}")
    bb_ms = {}
    cap10 = 4
    for shape, d, ln in (("10 MB", g10, gl10), ("1 GiB", b10, bl10)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        busy_rev = reverse_busy(tb10, pd, pl)  # the census of the reverse's bound
        print(f"phase 7: config 10 {shape}, first {n} records: the reverse register step runs the "
              f"band step on {busy_rev[0]} of {busy_rev[1]} record-steps "
              f"({100 * busy_rev[0] / busy_rev[1]:.2f}%) and skips the rest")
        hits = BB.bitband_reverse(d, ln, tb10)
        st = first_starts(hits, ln)
        ends = BB.bitband_anchor_end(d, ln, tb10, st, longest=True)
        spans = BB.bitband_spans(d, ln, tb10, hits, cap10, longest=False)
        kw = dict(seeded=True, nullable=False)
        calls = {
            "rrx_bitband_stats": (lambda: BB.bitband_stats(d, ln, tb10, **kw),
                                  lambda: BB.stats_plain(pd, pl, tb10, **kw),
                                  bb_bound("stats", ln, L), 0),
            "rrx_bitband_flags": (lambda: BB.bitband_flags(d, ln, tb10, seeded=True),
                                  lambda: BB.flags_plain(pd, pl, tb10, seeded=True),
                                  bb_bound("flags", ln, L), 1),
            "rrx_bitband_reverse": (lambda: BB.bitband_reverse(d, ln, tb10),
                                    lambda: scan_bits.reverse_plain(pd, pl, tb10),
                                    bb_bound("reverse", ln, L, busy=busy_rev), 2),
            "rrx_bitband_anchor_end": (
                lambda: BB.bitband_anchor_end(d, ln, tb10, st, longest=True),
                lambda: scan_bits.anchor_plain(pd, pl, tb10, st[:n].contiguous(), longest=True),
                bb_bound("anchor_end", ln, L, starts=st, end=ends), 3),
            "rrx_bitband_spans": (
                lambda: BB.bitband_spans(d, ln, tb10, hits, cap10, longest=False),
                lambda: scan_bits.greedy_spans_plain(pd, pl, tb10, hits[:, :n].contiguous(), cap10,
                                                     longest=False),
                bb_bound("spans", ln, L, spans=spans, cap=cap10), 4),
        }
        for name, (kern, plain, bnd, idx) in calls.items():
            # the plain version's one timed run on the first n records is the
            # reference of the kernel's outputs there
            want, plain_ms = timed_once(plain)
            got = kern()
            if name in ("rrx_bitband_flags", "rrx_bitband_reverse"):
                got, want = [got[:, :n]], [want]
            elif name == "rrx_bitband_anchor_end":
                got, want = [got[:n]], [want]
            else:
                got = [x[:n] for x in got]
            compare(name, got, want, f"config 10 {shape}, first {n} records",
                    tuple(str(i) for i in range(len(want))))
            ms = time_ms(kern, warm=1, runs=7 if shape == "10 MB" else 3)
            bb_ms[name, shape] = (ms, plain_ms, bnd, n)
            print(f"phase 7: {name} config 10 {shape} [{d.shape[0]} x {L}], every record: kernel "
                  f"{ms:.3f} ms = {d.shape[0] * L / ms / 1e6:.2f} GB/s, plain {plain_ms:.1f} ms on "
                  f"{n} records; bound {bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.1f}% of "
                  f"it); {bb_cycles(ms, ln):.1f} scheduler cycles a record-step [{card}]")
            print(f"  occupancy {name} ({shape}): {bb_occupancy(idx, d.shape[0])}; registers "
                  f"{regs_of(('bb_stats_kernel', 'bb_flags_kernel', 'bb_reverse_kernel', 'bb_anchor_kernel', 'bb_spans_kernel')[idx])}")
        # config 10's match_stats end to end (data on the card), split into
        # the prefilter scan, the kernel on the compacted bucket, the
        # full-batch pass (its records return at once unless the candidates
        # overflow the bucket) and the compaction glue (the rest)
        B_ = d.shape[0]
        e2e = time_ms(lambda: eng10.match_stats(d, ln, seeded=True), warm=1, runs=5)
        pre_ms = time_ms(lambda: eng10._alias_call(pf10, "match_stats", d, ln, seeded=True),
                         warm=1, runs=5)
        _, _, pre = eng10._alias_call(pf10, "match_stats", d, ln, seeded=True)
        pre = pre.reshape(-1)[:B_]
        idx_c = torch.nonzero(pre).reshape(-1)[: bucket(B_)]
        bc = bucket(B_)
        d2 = torch.zeros((bc, L), dtype=torch.uint8, device=dev)
        l2 = torch.zeros(bc, dtype=torch.int32, device=dev)
        d2[: idx_c.numel()], l2[: idx_c.numel()] = d[idx_c], ln[idx_c]
        live_c = torch.tensor([idx_c.numel()], dtype=torch.int32, device=dev)
        live_0 = torch.zeros(1, dtype=torch.int32, device=dev)
        k_ms = time_ms(lambda: BB.bitband_stats(d2, l2, tb10, **kw, live=live_c), warm=1, runs=5)
        f_ms = time_ms(lambda: BB.bitband_stats(d, ln, tb10, **kw, live=live_0), warm=1, runs=5)
        kb = bb_bound("stats", l2, L, rows=idx_c.numel())
        # rrx_bitband_reverse on the bucket (the first pass of its spans and
        # starts), its hits against the plain version
        n_c = idx_c.numel()
        compare("rrx_bitband_reverse", [BB.bitband_reverse(d2, l2, tb10, live_c)[:, :n_c]],
                [scan_bits.reverse_plain(d2[:n_c], l2[:n_c], tb10)], f"config 10 {shape} bucket",
                ("hits",))
        busy_c = reverse_busy(tb10, d2[:n_c], l2[:n_c])
        r_ms = time_ms(lambda: BB.bitband_reverse(d2, l2, tb10, live_c), warm=1, runs=5)
        rb = bb_bound("reverse", l2, L, rows=n_c, busy=busy_c)
        bb_ms["rev bucket", shape] = (r_ms, rb, n_c, busy_c)
        print(f"  rrx_bitband_reverse on the bucket ({shape}, {n_c} candidates, band step on "
              f"{100 * busy_c[0] / busy_c[1]:.1f}% of the record-steps): {r_ms:.3f} ms, "
              f"{bb_cycles(r_ms, l2[:n_c]):.1f} scheduler cycles a record-step; bound "
              f"{rb[0]:.4f} ms by {rb[1]} ({100 * rb[0] / r_ms:.1f}% of it) [{card}]")
        print(f"  rrx_bitband_stats on the bucket ({shape}, {idx_c.numel()} candidates): "
              f"{bb_cycles(k_ms, l2[: idx_c.numel()]):.1f} scheduler cycles a record-step; "
              f"occupancy {bb_occupancy(0, idx_c.numel())} [{card}]")
        pb = bound(B_ * L + 4 * B_, 13 * B_, (B_ * L + 2 * B_) * 4 * pf10.device_scanner.tables.deltas.numel())
        bb_ms["e2e", shape] = (e2e, pre_ms, k_ms, f_ms, kb, pb, idx_c.numel())
        print(f"phase 7: ScanEngine.match_stats config 10 end to end, {shape} ({B_} records, "
              f"{idx_c.numel()} candidates, bucket {bc}): {e2e:.3f} ms = prefilter scan "
              f"({pf10.prog.n_states} states, {type(pf10.device_scanner).__name__}) {pre_ms:.3f} ms "
              f"+ rrx_bitband_stats on the bucket {k_ms:.3f} ms + the full-batch pass's launch "
              f"(every record returns) {f_ms:.3f} ms + compaction glue "
              f"{e2e - pre_ms - k_ms - f_ms:.3f} ms; bounds: kernel on the candidates "
              f"{kb[0]:.4f} ms by {kb[1]}, prefilter scan {pb[0]:.4f} ms by {pb[1]}; the raw "
              f"kernel on every record {bb_ms['rrx_bitband_stats', shape][0]:.3f} ms [{card}]")

    # the reverse register step's two regimes at 10 MB: every step running
    # the band step (runs of 300 c's each closed by a y, records ending in
    # their last y) and every step skipped (lowercase without y); then the
    # reverse's user paths end to end at 10 MB: ScanEngine.starts_bitmap
    # (the hit words, unpacked to one bit a position) and
    # Pattern.finditer_batch (the reverse, then the span rounds, with the
    # host's packing)
    B_r = g10.shape[0]
    regimes = {
        "every step busy": (torch.from_numpy(np.frombuffer((b"c" * 300 + b"y") * 4, np.uint8)[:L]
                                             .copy()).to(dev).expand(B_r, L).contiguous(),
                            torch.full((B_r,), 903, dtype=torch.int32, device=dev)),
        "every step skipped": (g10.clone(), gl10),
    }
    regimes["every step skipped"][0][regimes["every step skipped"][0] == ord("y")] = ord("z")
    for what, (dr, lr) in regimes.items():
        busy_r = reverse_busy(tb10, dr[:1024], lr[:1024])
        compare("rrx_bitband_reverse", [BB.bitband_reverse(dr[:1024], lr[:1024], tb10)],
                [scan_bits.reverse_plain(dr[:1024], lr[:1024], tb10)], f"config 10, {what}",
                ("hits",))
        r_ms = time_ms(lambda: BB.bitband_reverse(dr, lr, tb10), warm=1, runs=5)
        bb_ms["rev regime", what] = (r_ms, bb_cycles(r_ms, lr), busy_r)
        print(f"phase 7: rrx_bitband_reverse config 10 10 MB, {what} (band step on "
              f"{100 * busy_r[0] / busy_r[1]:.1f}% of the first 1,024 records' steps): "
              f"{r_ms:.3f} ms, {bb_cycles(r_ms, lr):.1f} scheduler cycles a record-step [{card}]")
    del regimes
    texts_r = [d10_np[i, : l10_np[i]].tobytes() for i in range(B_r)]
    for what, fn, runs, kern in (
            ("ScanEngine.ends_bitmap", lambda: eng10.ends_bitmap(g10, gl10, L), 3,
             "rrx_bitband_flags"),
            ("ScanEngine.starts_bitmap", lambda: eng10.starts_bitmap(g10, gl10, L), 3,
             "rrx_bitband_reverse"),
            ("Pattern.finditer_batch (lazy)", lambda: pat10.finditer_batch(texts_r), 1,
             "rrx_bitband_reverse")):
        e_ms = time_ms(fn, warm=1, runs=runs)
        bb_ms["rev e2e", what] = e_ms
        print(f"phase 7: {what} config 10 end to end, 10 MB ({B_r} records): {e_ms:.3f} ms "
              f"({kern} on every record {bb_ms[kern, '10 MB'][0]:.3f} ms) [{card}]")

    lap("the bitband kernels")

    # the container kernels on K120 over the phase-5 log text (every record
    # scanned), at 10 MB and 1 GiB, plain versions on the 10 MB batch and on
    # the first n_slice7 records of the 1 GiB one; bounds of PERF.md section
    # 2 from a census of this run's data (the plain stepper on the card:
    # live rows, live full blocks, nonzero output blocks per needed step)
    SP = scan_sparse
    tb120 = sc120.tables

    def sparse_census(tables, d, ln, *, seeded: bool, reverse: bool) -> int:
        """Operations of PERF.md section 2's floor for one container pass
        over records d (steps past EOS, and past an unseeded scan's empty
        state after step 1, are not needed). The reverse walks u = R &
        mask[sym] and ORs in the symbol's E row (the accept set's
        expansion): its census counts u's live work and E's nonzero
        words."""
        pt = tables.plain(dev)
        R, Lc = d.shape
        lnv = ln.to(torch.int64).clamp(0, Lc)
        nb = pt.M.shape[1] // 128
        rownz = (pt.pb.sum(dim=1 if reverse else 2) > 0)  # [np, 128]
        src = pt.pcol if reverse else pt.prow
        Uf = pt.U.T if reverse else pt.U  # [source, output]
        acc_w = 1 if reverse else int(
            (torch.from_numpy(tables.accs).any(dim=0).reshape(-1, 32).any(dim=1)).sum())
        if reverse:  # the nonzero words of each symbol's E row
            n_mask = len(tables.masks)
            e_rows = tables.walk_r[: n_mask * tables.W].reshape(n_mask, tables.W)
            e_nz = torch.zeros(scan_bits.N_SYMS, dtype=torch.int64, device=dev)
            has = torch.from_numpy(tables.sym_row >= 0).to(dev)
            e_nz[has] = (e_rows != 0).sum(dim=1).to(torch.int64)[
                torch.from_numpy(tables.sym_row[tables.sym_row >= 0]).to(dev)]
        v = pt.empty(R, dev)
        alive = torch.ones(R, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for t in (range(Lc + 1, -1, -1) if reverse else range(Lc + 2)):
            sym = scan_bits._sym(d, lnv, t)
            if reverse:
                x = v & pt.M[sym]
            else:
                x = v.clone()
                x[:, 0] |= seeded or t < 2
            xb = x.reshape(R, nb, 128)
            live_rows = (xb[:, src] & rownz[None]).sum(dim=(1, 2))
            live_u = (xb.any(dim=2).to(torch.float32) @ Uf).sum(dim=1).to(torch.int64)
            if reverse:
                y = pt.rev(v, sym)
                out_blocks = e_nz[sym]
            else:
                y = pt._expand(x, reverse) & pt.M[sym]
                out_blocks = 4 * y.reshape(R, nb, 128).any(dim=2).sum(dim=1)
            ops = 4 * live_rows + 4 * live_u + out_blocks + acc_w + 2
            total += torch.where(alive & (t <= lnv + 1), ops, 0).sum()
            v = y
            if not seeded and not reverse and t >= 1:
                alive &= y.any(dim=1)
        return int(total.item())

    census = {}

    def sp_bound(what, tables, d, ln, *, seeded=True, scale=1.0, C=1):
        """(bound_ms, bound_by) of one container call (``what``: stats,
        flags or reverse): census operations (scaled from a slice by
        ``scale``; stats and flags share one forward census) and the bytes
        moved."""
        R, Lc = d.shape
        rev = what == "reverse"
        key = (id(tables), id(d), seeded, rev)
        if key not in census:
            census[key] = sparse_census(tables, d, ln, seeded=seeded, reverse=rev)
        nbytes = (int(ln.to(torch.int64).clamp(0, Lc).sum()) + 4 * R) * scale
        out = 13 * R * C if what == "stats" else 4 * scan_bits.hit_words(Lc) * R * C
        return bound(nbytes, out * scale, census[key] * scale)

    sp_tpb = lib.rrx_sparse_threads_per_block()

    def sp_occupancy(idx, tables, rows):
        """Theoretical occupancy and grid of container kernel ``idx``
        (rrx_sparse_occupancy's index) on ``tables``, in its automatic form."""
        bps = ctypes.c_int(0)
        kind = ("walk", "walk", "walk_r", "stream", "stream", "stream_r")[idx]
        tab, meta, walk = SP._direction(tables, kind)
        form = SP.table_form(tables, kind)
        _build.check(lib.rrx_sparse_occupancy(idx, tab.numel(), meta.numel(),
                                              0 if walk is None else walk.numel(), tables.W,
                                              int(form == "global"), ctypes.byref(bps)),
                     "rrx_sparse_occupancy")
        blocks = min(-(-rows // (sp_tpb // 32)), bps.value * n_sm)
        return (f"theoretical {bps.value * sp_tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * sp_tpb / max_threads:.1f}%, one warp per record, "
                f"{form} table, {SP.smem_bytes(tables, kind, form == 'global')} bytes of shared "
                f"memory a block); grid {blocks} blocks of {sp_tpb}")

    def sched_cycles(ms, ln, L):
        """Warp-scheduler cycles a record-step: the time x the clock
        (CLOCK_GHZ) x 4 schedulers an SM / the record-steps (len + 2 a
        record: every step of a seeded scan)."""
        steps = int((ln.to(torch.int64).clamp(0, L) + 2).sum())
        return ms * 1e6 * CLOCK_GHZ * 4 * n_sm / steps

    sp_ms = {}
    sp_slices = {}  # the census slices (their census is cached by tensor id)
    for shape, d, ln in (("10 MB", log10, len10), ("1 GiB", log, log_len)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        sp_slices[shape] = (pd, pl)
        scale = float(ln.to(torch.int64).sum()) / float(pl.to(torch.int64).sum())
        kw = dict(seeded=True, nullable=False)
        calls = {
            "rrx_sparse_stats": (lambda: SP.sparse_stats(d, ln, tb120, **kw),
                                 lambda: SP.sparse_stats_plain(pd, pl, tb120, **kw), "stats", 0),
            "rrx_sparse_flags": (lambda: SP.sparse_flags(d, ln, tb120, seeded=True),
                                 lambda: SP.sparse_flags_plain(pd, pl, tb120, seeded=True),
                                 "flags", 1),
            "rrx_sparse_reverse": (lambda: SP.sparse_reverse(d, ln, tb120),
                                   lambda: SP.sparse_reverse_plain(pd, pl, tb120), "reverse", 2),
        }
        for name, (kern, plain, what, idx) in calls.items():
            # the plain version's one timed run on the first n records is the
            # reference of the kernel's outputs there
            want, plain_ms = timed_once(plain)
            got = kern()
            if what == "stats":
                got = [x[:n] for x in got]
            else:
                got, want = [got[:, :n]], [want]
            compare(name, got, want, f"K120 {shape}, first {n} records",
                    tuple(str(i) for i in range(len(want))))
            ms = time_ms(kern, warm=1, runs=7 if shape == "10 MB" else 3)
            bnd = sp_bound(what, tb120, pd, pl, scale=scale)
            sp_ms[name, shape] = (ms, plain_ms, bnd, n)
            print(f"phase 7: {name} K120 {shape} [{d.shape[0]} x {d.shape[1]}], every record: "
                  f"kernel {ms:.3f} ms = {d.shape[0] * d.shape[1] / ms / 1e6:.2f} GB/s, "
                  f"{sched_cycles(ms, ln, d.shape[1]):.1f} scheduler cycles a record-step, plain "
                  f"{plain_ms:.1f} ms on {n} records; bound {bnd[0]:.4f} ms by {bnd[1]} "
                  f"({100 * bnd[0] / ms:.2f}% of it) [{card}]")
            print(f"  occupancy {name} ({shape}): {sp_occupancy(idx, tb120, d.shape[0])}; "
                  f"registers {regs_of(('sp_stats_kernel', 'sp_flags_kernel', 'sp_reverse_kernel')[idx])}")

    # end to end (data on the card), split into the prefilter, the kernel
    # and the glue: K120 match_stats, MultiPattern of 40 count (the engine's
    # channel scan), config 13 fullmatch_flags (the bool copy to the host
    # included) and x(abc|de){1,300}y's prefiltered match_stats, at 10 MB;
    # at 1 GiB only the bucket's reverse against its plain version (the 1 GiB
    # end-to-end times are PERF.md's, and moved with no kernel since)
    tables40 = mp40.engine.device_scanner.tables
    tables13 = eng13.device_scanner.tables
    sc_x = eng_x.device_scanner
    e2e_sp = {}
    for shape in ("10 MB", "1 GiB"):
        d, ln = (log10, len10) if shape == "10 MB" else (log, log_len)
        dd13, ll13 = (d13, l13) if shape == "10 MB" else (b13, bl13)
        dx, lx = x_runs[shape]
        runs = 5
        timed = shape == "10 MB"
        rows_e = {
            "K120 match_stats": (lambda: eng120.match_stats(d, ln, seeded=True),
                                 lambda: SP.sparse_stats(d, ln, tb120, seeded=True, nullable=False)),
            "MultiPattern of 40 match_stats": (
                lambda: mp40.engine.match_stats(d, ln, seeded=True),
                lambda: SP.sparse_stats(d, ln, tables40, seeded=True, nullable=False)),
            "config 13 fullmatch_flags": (
                lambda: eng13.fullmatch_flags(dd13, ll13),
                lambda: SP.sparse_stats(dd13, ll13, tables13, seeded=False, nullable=False)),
        }
        for what, (e2e_fn, k_fn) in rows_e.items() if timed else ():
            e2e = time_ms(e2e_fn, warm=1, runs=runs)
            k_ms = time_ms(k_fn, warm=1, runs=runs)
            e2e_sp[what, shape] = (e2e, k_ms)
            print(f"phase 7: {what} end to end, {shape}: {e2e:.3f} ms = kernel {k_ms:.3f} ms + "
                  f"glue {e2e - k_ms:.3f} ms [{card}]")
        B_ = dx.shape[0]
        _, _, pre = eng_x._alias_call(pf_x, "match_stats", dx, lx, seeded=True)
        bc = bucket(B_)
        idx_c = torch.nonzero(pre.reshape(-1)[:B_]).reshape(-1)[:bc]
        d2 = torch.zeros((bc, dx.shape[1]), dtype=torch.uint8, device=dev)
        l2 = torch.zeros(bc, dtype=torch.int32, device=dev)
        d2[: idx_c.numel()], l2[: idx_c.numel()] = dx[idx_c], lx[idx_c]
        live_c = torch.tensor([idx_c.numel()], dtype=torch.int32, device=dev)
        live_0 = torch.zeros(1, dtype=torch.int32, device=dev)
        kw = dict(seeded=True, nullable=False)
        # rrx_sparse_reverse on the same bucket (the first pass of the
        # program's spans and starts), its hits against the plain version
        n_c = idx_c.numel()
        compare("rrx_sparse_reverse", [SP.sparse_reverse(d2, l2, sc_x.tables, live_c)[:, :n_c]],
                [SP.sparse_reverse_plain(d2[:n_c], l2[:n_c], sc_x.tables)],
                f"{CONFIG13_X} {shape} bucket", ("hits",))
        if not timed:
            continue
        e2e = time_ms(lambda: eng_x.match_stats(dx, lx, seeded=True), warm=1, runs=runs)
        pre_ms = time_ms(lambda: eng_x._alias_call(pf_x, "match_stats", dx, lx, seeded=True),
                         warm=1, runs=runs)
        k_ms = time_ms(lambda: SP.sparse_stats(d2, l2, sc_x.tables, **kw, live=live_c), warm=1,
                       runs=runs)
        f_ms = time_ms(lambda: SP.sparse_stats(dx, lx, sc_x.tables, **kw, live=live_0), warm=1,
                       runs=runs)
        e2e_sp["x prefiltered", shape] = (e2e, pre_ms, k_ms, f_ms, idx_c.numel())
        r_ms = time_ms(lambda: SP.sparse_reverse(d2, l2, sc_x.tables, live_c), warm=1, runs=runs)
        e2e_sp["x bucket reverse", shape] = (r_ms, k_ms, n_c)
        print(f"phase 7: rrx_sparse_reverse on {CONFIG13_X}'s bucket ({shape}, {n_c} candidates): "
              f"{r_ms:.3f} ms, {sched_cycles(r_ms, l2[:n_c], dx.shape[1]):.1f} scheduler cycles a "
              f"record-step (rrx_sparse_stats on it {k_ms:.3f} ms) [{card}]")
        print(f"phase 7: ScanEngine.match_stats {CONFIG13_X} end to end, {shape} ({B_} records, "
              f"{idx_c.numel()} candidates, bucket {bc}): {e2e:.3f} ms = prefilter scan "
              f"({pf_x.prog.n_states} states, {type(pf_x.device_scanner).__name__}) {pre_ms:.3f} ms "
              f"+ rrx_sparse_stats on the bucket {k_ms:.3f} ms + the full-batch pass's launch "
              f"{f_ms:.3f} ms + glue {e2e - pre_ms - k_ms - f_ms:.3f} ms [{card}]")

    # the reverse's user paths of K120 end to end at 10 MB:
    # ScanEngine.starts_bitmap (the hit words, unpacked to one bit a
    # position) and Pattern.finditer_batch (lazy: the reverse, then the
    # span rescans, with the host's packing)
    texts_k120 = [row[:n].tobytes() for row, n in zip(log10.cpu().numpy(), len10.cpu().numpy())]
    for what, fn, runs in (("ScanEngine.starts_bitmap",
                            lambda: eng120.starts_bitmap(log10, len10, log10.shape[1]), 3),
                           ("Pattern.finditer_batch (lazy)",
                            lambda: pat120.finditer_batch(texts_k120), 1)):
        e_ms = time_ms(fn, warm=1, runs=runs)
        e2e_sp["K120 rev e2e", what] = e_ms
        print(f"phase 7: {what} K120 end to end, 10 MB ({log10.shape[0]} records): {e_ms:.3f} ms "
              f"(rrx_sparse_reverse on every record {sp_ms['rrx_sparse_reverse', '10 MB'][0]:.3f} "
              f"ms) [{card}]")
    del texts_k120

    lap("the container kernels")

    # the stream-fed container kernels over the mask stream of K120 (10 MB
    # of log text and 128 MB, a 14 GiB stream) and of config 13 (its 10 MB
    # chain batch of phase 11), the stream's build timed apart; the bound is
    # the larger of the stream's bytes over the card's memory rate and the
    # container census of the same records (the byte kernels' operations);
    # beside each, the byte kernel (rows 23-25) on the same records
    # x[ab]{0,400}c's chain records (10 MB): [ab] runs with an x every ~256
    # bytes on average, so that a source block holds up to 128 live states
    prog_xab = compile_program(XAB)
    tables_xab = SP.device_sparse_tables(prog_xab, dev)
    gx = torch.Generator(device="cpu").manual_seed(23)
    ux = torch.rand((B7, 1024), generator=gx).to(dev)
    d_xab = torch.where(ux < 1 / 256, ord("x"), torch.where(ux < 1 / 128, ord("c"),
                        torch.where(ux < 0.5 + 1 / 256, ord("a"), ord("b")))).to(torch.uint8)
    l_xab = torch.full((B7,), 1024, dtype=torch.int32, device=dev)
    del ux
    sps_ms = {}
    runs_sps = (("K120", "10 MB", tb120, sc120.prog, log10, len10),
                ("config 13", "10 MB", tables13, eng13.prog, d13, l13),
                (XAB, "10 MB", tables_xab, prog_xab, d_xab, l_xab),
                ("K120", "128 MB", tb120, sc120.prog, log[: 1 << 17], log_len[: 1 << 17]))
    for tag, shape, tabs_c, prog_c, d, ln in runs_sps:
        stabs = scan_packed.stream_tables(prog_c, dev)
        timed = shape == "10 MB"  # 128 MB: compared only (PERF.md holds its times)
        ms_w = (time_ms(lambda: scan_packed.mask_stream_from_bytes(stabs, d, ln), warm=1, runs=3)
                if timed else None)
        words = scan_packed.mask_stream_from_bytes(stabs, d, ln)
        T, R_w, W_w = words.shape
        n = min(d.shape[0], 1024)
        pw, pd, pl = words[:, :n].contiguous(), d[:n].contiguous(), ln[:n].contiguous()
        # the census (cached with the byte kernels' bounds): K120's 10 MB batch
        # and the first n_slice7 records of the 1 GiB one (the 128 MB batch's
        # first records), config 13's batch
        if tag == "K120":
            cd, cl = sp_slices["1 GiB" if shape == "128 MB" else "10 MB"]
        else:
            cd, cl = d, ln
        scale = float(ln.to(torch.int64).sum()) / float(cl.to(torch.int64).sum())
        runs = 7 if shape == "10 MB" else 3
        calls = {
            "rrx_sparse_stream_stats": (
                lambda: SP.sparse_stream_stats(tabs_c, words, ln, seeded=True, nullable=False),
                lambda: SP.sparse_stream_stats_plain(tabs_c, pw, pl, seeded=True, nullable=False),
                lambda: SP.sparse_stats(d, ln, tabs_c, seeded=True, nullable=False),
                "stats", 3, 8 * R_w),
            "rrx_sparse_stream_flags": (
                lambda: SP.sparse_stream_flags(tabs_c, words, seeded=True),
                lambda: SP.sparse_stream_flags_plain(tabs_c, pw, seeded=True),
                lambda: SP.sparse_flags(d, ln, tabs_c, seeded=True), "flags", 4,
                4 * -(-T // 32) * R_w),
            "rrx_sparse_stream_reverse": (
                lambda: SP.sparse_stream_reverse(tabs_c, words),
                lambda: SP.sparse_stream_reverse_plain(tabs_c, pw),
                lambda: SP.sparse_reverse(d, ln, tabs_c), "reverse", 5, 4 * -(-T // 32) * R_w),
        }
        for name, (kern, plain, byte, what, idx, out_b) in calls.items():
            got, (want, plain_ms) = kern(), timed_once(plain)  # the timed plain run is the reference
            got = [x[:n] for x in got] if what == "stats" else [got[:, :n]]
            compare(name, got, want if what == "stats" else [want], f"{tag} {shape}, first {n}",
                    ("cnt", "first", "any") if what == "stats" else (what,))
            if not timed:
                continue
            ms = time_ms(kern, warm=1, runs=runs)
            byte_ms = time_ms(byte, warm=1, runs=runs)
            key = (id(tabs_c), id(cd), True, what == "reverse")
            if key not in census:
                census[key] = sparse_census(tabs_c, cd, cl, seeded=True, reverse=what == "reverse")
            bnd = bound(4.0 * T * R_w * W_w + 4 * R_w, out_b, census[key] * scale)
            sps_ms[name, tag, shape] = (ms, plain_ms, bnd, byte_ms, ms_w)
            print(f"phase 7: {name} {tag} {shape} [{T} steps x {R_w} records x W = {W_w}, stream "
                  f"{4 * T * R_w * W_w / 2**30:.2f} GiB]: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
                  f"on {n} records; bound {bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.2f}% of "
                  f"it); the byte kernel on the same records {byte_ms:.3f} ms; stream build "
                  f"{ms_w:.3f} ms [{card}]")
            print(f"  occupancy {name} ({tag} {shape}): "
                  f"{sp_occupancy(idx, tabs_c, R_w)}; registers "
                  f"{regs_of(('sp_stream_stats_kernel', 'sp_stream_flags_kernel', 'sp_stream_reverse_kernel')[idx - 3])}")
        del words, pw

    lap("the stream-fed container kernels")

    # the forward step of rrx_sparse_stats and _flags on three kinds of
    # records: K120's log text (a few live states a step), config 13's chain
    # batch and x[ab]{0,400}c's chain records (dense blocks): first the
    # sweep of walk_max (the live states up to which a source block is
    # walked state by state; -1: the block-parallel form everywhere, 128:
    # the walk everywhere) that set SP.WALK_MAX, then at WALK_MAX the time,
    # census bound, scheduler cycles a record-step, occupancy and registers,
    # beside the old step on the same records (rrx_sparse_stream_stats over
    # their mask stream, above)
    walk_runs = (("K120", tb120, log10, len10), ("config 13", tables13, d13, l13),
                 (XAB, tables_xab, d_xab, l_xab))
    sweep = {}
    for tag, tabs_c, d, ln in walk_runs:
        kw = dict(seeded=True, nullable=False)
        n = 256
        compare("rrx_sparse_stats", [x[:n] for x in SP.sparse_stats(d, ln, tabs_c, **kw)],
                SP.sparse_stats_plain(d[:n], ln[:n], tabs_c, **kw), f"{tag} 10 MB, first {n}")
        compare("rrx_sparse_flags", [SP.sparse_flags(d, ln, tabs_c, seeded=True)[:, :n]],
                [SP.sparse_flags_plain(d[:n], ln[:n], tabs_c, seeded=True)],
                f"{tag} 10 MB, first {n}", ("flags",))
        compare("rrx_sparse_reverse", [SP.sparse_reverse(d, ln, tabs_c)[:, :n]],
                [SP.sparse_reverse_plain(d[:n], ln[:n], tabs_c)], f"{tag} 10 MB, first {n}",
                ("hits",))
        for name, fn in (("rrx_sparse_stats", lambda wm: SP.sparse_stats(d, ln, tabs_c, **kw,
                                                                         walk_max=wm)),
                         ("rrx_sparse_reverse", lambda wm: SP.sparse_reverse(d, ln, tabs_c,
                                                                             walk_max=wm))):
            sw = sweep[name, tag] = {wm: time_ms(lambda: fn(wm), warm=1, runs=3)
                                     for wm in WALK_SWEEP}
            best = min(sw, key=sw.get)
            print(f"phase 7: walk_max sweep, {name} {tag} 10 MB [{d.shape[0]} x {d.shape[1]}] "
                  f"(ms): { {wm: round(t, 4) for wm, t in sw.items()} }; fastest {best}, WALK_MAX = "
                  f"{SP.WALK_MAX} at {sw[SP.WALK_MAX] / sw[best]:.3f}x it [{card}]")
    for name in ("rrx_sparse_stats", "rrx_sparse_reverse"):
        worst = {wm: max(sweep[name, t][wm] / min(sweep[name, t].values()) for t, *_ in walk_runs)
                 for wm in WALK_SWEEP}
        print(f"phase 7: walk_max sweep, {name}, the slowest of the three batches against its "
              f"fastest: { {wm: round(x, 3) for wm, x in worst.items()} }; the least "
              f"{min(worst, key=worst.get)}, WALK_MAX = {SP.WALK_MAX} [{card}]")
    walk_rows = {}
    for tag, tabs_c, d, ln in walk_runs:
        L = d.shape[1]
        for name, what, idx, fn in (
                ("rrx_sparse_stats", "stats", 0,
                 lambda: SP.sparse_stats(d, ln, tabs_c, seeded=True, nullable=False)),
                ("rrx_sparse_flags", "flags", 1,
                 lambda: SP.sparse_flags(d, ln, tabs_c, seeded=True)),
                ("rrx_sparse_reverse", "reverse", 2, lambda: SP.sparse_reverse(d, ln, tabs_c))):
            ms = time_ms(fn, warm=1, runs=7)
            # K120's census: the one of its 10 MB rows above (the same records)
            cd, cl = sp_slices["10 MB"] if tag == "K120" else (d, ln)
            bnd = sp_bound(what, tabs_c, cd, cl)
            old_ms = sps_ms[name.replace("sparse_", "sparse_stream_"), tag, "10 MB"][0]
            walk_rows[name, tag] = (ms, bnd, old_ms)
            print(f"phase 7: {name} {tag} 10 MB [{d.shape[0]} x {L}], the new step: {ms:.3f} ms, "
                  f"{sched_cycles(ms, ln, L):.1f} scheduler cycles a record-step; census bound "
                  f"{bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.2f}% of it); the old step "
                  f"(rrx_sparse_stream_{what} on the same records' stream) {old_ms:.3f} ms, "
                  f"{sched_cycles(old_ms, ln, L):.1f} cycles ({old_ms / ms:.2f}x) [{card}]")
            print(f"  occupancy {name} ({tag}): {sp_occupancy(idx, tabs_c, d.shape[0])}; registers "
                  f"{regs_of(('sp_stats_kernel', 'sp_flags_kernel', 'sp_reverse_kernel')[idx])}")

    lap("the container register steps and sweeps")

    # the slotted SWAR kernel on config 6 at 10 MB (phase 3's corpus) and
    # 1 GiB (phase 8's), plain version on the whole 10 MB batch and the first
    # n_slice7 records of 1 GiB; beside it the default route's P-channel
    # u32-word kernel (row 2) on the same data
    swm_ms = {}
    tbs = sc6s.tables
    n_d6 = tbs.deltas.numel()
    for shape, d, ln in (("10 MB", d10, l10), ("1 GiB", big6, len6)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        got = scan_swar.swar_multi_stats(d, ln, tbs, seeded=True)
        # the plain version's one timed run is also the reference
        want, plain_ms = timed_once(lambda: scan_swar.swar_multi_stats_plain(pd, pl, tbs,
                                                                             seeded=True))
        compare("rrx_swar_multi_stats", [x[:n] for x in got], want,
                f"config 6 {shape}, first {n} records")
        flags_s = int(got[0].to(torch.int64).sum())
        bnd = kernel_bound("stats_mc", ln, d.shape[1], 4 * n_d6, P=4, flags=flags_s)
        ms = time_ms(lambda: scan_swar.swar_multi_stats(d, ln, tbs, seeded=True), warm=2, runs=7,
                     per_run=5)
        word_ms = time_ms(lambda: scan_word.word_stats(d, ln, sc6.tables, seeded=True, lead=0,
                                                       nullable=False), warm=2, runs=7, per_run=5)
        swm_ms[shape] = (ms, plain_ms, bnd, word_ms)
        bps = ctypes.c_int(0)
        _build.check(lib.rrx_occupancy(21, int(n_d6), ctypes.byref(bps)), "rrx_occupancy")
        tpb = lib.rrx_threads_per_block()
        print(f"phase 7: rrx_swar_multi_stats config 6 {shape} [{d.shape[0]} x {d.shape[1]}], "
              f"{n_d6} slotted deltas: kernel {ms:.4f} ms = {d.numel() / ms / 1e6:.1f} GB/s, plain "
              f"{plain_ms:.3f} ms on {n} records; bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({100 * bnd[0] / ms:.2f}% of it); the default route's rrx_word_stats[P] on the same "
              f"data {word_ms:.4f} ms; occupancy {bps.value * tpb}/{max_threads} threads per SM, "
              f"grid {-(-d.shape[0] // tpb)} blocks of {tpb}; registers "
              f"{regs_of('swar_multi_stats_kernel')} [{card}]")

    lap("the slotted SWAR kernel")

    # the six wide kernels (dense multiblock tier) on phase 12's batches:
    # K60+ (s_tile 512, W = 16) over the log text and x(ab|c){300,}y
    # (s_tile 1024, W = 32) with its chains, at 10 MB and 1 GiB, every record
    # scanned; outputs against the plain version on the whole 10 MB batch and
    # on the first n_slice7 records of 1 GiB, whose time is taken once
    def occupancy_wide(name, tables, rows, index=None):
        """``index``: rrx_long_wide_occupancy's kernel index (4 and 5: count
        and reverse at 32 lanes a window) or rrx_nfa_wide_occupancy's (8
        and 9: flags and stats at 32 lanes a record), else the name's. Two
        windows or records a warp at 16 lanes each (W <= 16) halve the
        warps' work units."""
        bps = ctypes.c_int(0)
        if name in LONG_WIDE_KERNELS:
            idx = LONG_WIDE_KERNELS.index(name) if index is None else index
            _build.check(lib.rrx_long_wide_occupancy(idx, int(tables.s_tile), ctypes.byref(bps)),
                         "rrx_long_wide_occupancy")
        else:
            idx = (WIDE_KERNELS + WIDE_MB_KERNELS).index(name) if index is None else index
            _build.check(lib.rrx_nfa_wide_occupancy(idx, int(tables.s_tile), int(tables.P),
                                                    ctypes.byref(bps)),
                         "rrx_nfa_wide_occupancy")
            if tables.band_lanes == 16 and ((name == "rrx_nfa_wide_flags" and idx == 5) or (
                    name == "rrx_nfa_wide_stats" and idx == 0 and tables.P == 1)):
                rows = -(-rows // 2)
        tpb = lib.rrx_nfa_wide_threads_per_block()
        blocks = min(-(-rows // (tpb // 32)), bps.value * n_sm)
        return (f"theoretical {bps.value * tpb}/{max_threads} threads per SM "
                f"({100.0 * bps.value * tpb / max_threads:.1f}%); persistent grid {blocks} blocks "
                f"of {tpb // 32} warps ({100.0 * blocks / (bps.value * n_sm):.1f}% of the resident "
                f"blocks), {rows / (blocks * tpb // 32):.1f} records (windows) per warp")

    wide_ms = {}
    for pattern, eng_w in ((K60P, eng60), (CHAIN300, eng300)):
        tables = eng_w.device_scanner.nfa
        step_ops = 3 * state_words(eng_w.prog)
        tag = f"{eng_w.prog.n_states}-state {pattern[:12]}..."
        for shape in ("10 MB", "1 GiB"):
            d, ln, cnt_w = wide_runs[pattern, shape]
            cap_w = 1 << max(int(cnt_w.max()), 1).bit_length()
            hits = P.nfa_reverse(d, ln, tables)
            lazy0 = P.nfa_lazy_spans(d, ln, tables, hits, cap_w)
            starts = lazy0[0][:, 0].contiguous()
            greedy0 = P.nfa_greedy_spans(d, ln, tables, hits, cap_w, nullable=False)
            end0 = P.nfa_anchor_end(d, ln, tables, starts, longest=True)
            n = min(d.shape[0], n_slice7)
            pd, pl, pst = d[:n].contiguous(), ln[:n].contiguous(), starts[:n].contiguous()
            ph, ph_ms = timed_once(lambda: scan_bits.reverse_plain(pd, pl, tables))
            kw = dict(seeded=True, lead=0, nullable=False)
            calls = {
                "rrx_nfa_wide_stats": (lambda: P.nfa_stats(d, ln, tables, seeded=True),
                                       lambda: P.stats_plain(pd, pl, tables, **kw)),
                "rrx_nfa_wide_flags": (lambda: [P.nfa_flags(d, ln, tables, seeded=True)],
                                       lambda: [P.flags_plain(pd, pl, tables, seeded=True)]),
                "rrx_nfa_wide_reverse": (lambda: [hits], None),
                "rrx_nfa_wide_anchor_end": (
                    lambda: [P.nfa_anchor_end(d, ln, tables, starts, longest=True)],
                    lambda: [scan_bits.anchor_plain(pd, pl, tables, pst, longest=True)]),
                "rrx_nfa_wide_lazy_spans": (
                    lambda: P.nfa_lazy_spans(d, ln, tables, hits, cap_w),
                    lambda: scan_bits.lazy_spans_plain(pd, pl, tables, ph, cap_w)),
                "rrx_nfa_wide_greedy_spans": (
                    lambda: P.nfa_greedy_spans(d, ln, tables, hits, cap_w, nullable=False),
                    lambda: scan_bits.greedy_spans_plain(pd, pl, tables, ph, cap_w,
                                                         nullable=False)),
            }
            nb = int(ln.to(torch.int64).sum())
            for name, (kern, plain) in calls.items():
                got = kern()
                if plain is None:
                    want, plain_ms = [ph], ph_ms
                else:
                    want, plain_ms = timed_once(plain)
                cut = [x[:, :n] if name in ("rrx_nfa_wide_reverse", "rrx_nfa_wide_flags") else x[:n]
                       for x in got]
                compare(name, cut, want, f"{tag} {shape}, first {n} records",
                        tuple(str(i) for i in range(len(want))))
                if name == "rrx_nfa_wide_reverse":
                    kern = lambda: P.nfa_reverse(d, ln, tables)  # noqa: E731
                ms = time_ms(kern, warm=1, runs=3 if shape == "1 GiB" else 5)
                part = name[len("rrx_nfa_wide_"):]
                bnd = kernel_bound(part, ln, d.shape[1], step_ops, cap=cap_w, starts=starts,
                                   end=end0, greedy=greedy0)
                wide_ms[name, pattern, shape] = (ms, plain_ms, bnd)
                print(f"phase 7: {name} {tag} {shape} [{d.shape[0]} x {d.shape[1]}]: kernel "
                      f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s, plain {plain_ms:.3f} ms on {n} "
                      f"records; bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]")
                print(f"  occupancy {name} ({shape}): {occupancy_wide(name, tables, d.shape[0])}; "
                      f"registers {regs_of('wide_' + part + '_kernel')}")
            # the reverse's band step: scheduler cycles a record-step (the
            # time x 1.98 GHz x 528 warp schedulers / the record-steps), the
            # other split on the same records (the run fails if the default,
            # the diagonals kept, is the slower one) and, at 10 MB, the Wide walk
            # on the same records: rrx_stream_reverse over their mask stream
            # (built apart), its hit words against the band step's
            steps_w = int((ln.to(torch.int64).clamp(0, d.shape[1]) + 2).sum())

            def cyc(ms_):
                return ms_ * 1e6 * CLOCK_GHZ * 4 * n_sm / steps_w

            rev_ms = wide_ms["rrx_nfa_wide_reverse", pattern, shape][0]
            tb_o = other_split(tables, tables.rec_diags)
            compare("rrx_nfa_wide_reverse", [P.nfa_reverse(d, ln, tb_o)[:, :n]], [ph],
                    f"{tag} {shape} diagonals {tb_o.rec_diags}, first {n} records", ("hits",))
            line = (f"phase 7: rrx_nfa_wide_reverse {tag} {shape}, the band step: diagonals "
                    f"{tables.rec_diags} (the default) {rev_ms:.4f} ms = {cyc(rev_ms):.1f} "
                    f"scheduler cycles a record-step")
            if shape == "10 MB":  # the other split's 1 GiB time is PERF.md's
                o_ms = time_ms(lambda: P.nfa_reverse(d, ln, tb_o), warm=1, runs=5)
                wide_ms["rev split", pattern, shape] = (rev_ms, cyc(rev_ms), o_ms, cyc(o_ms))
                line += f", diagonals {tb_o.rec_diags} {o_ms:.4f} ms = {cyc(o_ms):.1f}"
                if rev_ms > o_ms:
                    fail(f"rrx_nfa_wide_reverse {tag} {shape}: the default split "
                         f"{tables.rec_diags} ({rev_ms:.4f} ms) is slower than {tb_o.rec_diags} "
                         f"({o_ms:.4f} ms)")
            if shape == "10 MB":
                tabs = PK.packed_tables(eng_w.prog, dev)
                words = PK.mask_stream_from_bytes(tabs, d, ln)
                if not torch.equal(PK.hit_words(tabs["nfa"], words), hits):
                    fail(f"{tag}: rrx_stream_reverse's hit words != rrx_nfa_wide_reverse's")
                s_ms = time_ms(lambda: PK.hit_words(tabs["nfa"], words), warm=1, runs=5)
                wide_ms["rev stream", pattern] = (s_ms, cyc(s_ms))
                line += (f"; the Wide walk on the same records (rrx_stream_reverse) {s_ms:.4f} ms "
                         f"= {cyc(s_ms):.1f}, the same hit words")
                del words
            rev_spill = {k_: b for k_, b in spilled.items()
                         if re.search(r"\dwide_reverse_kernel", k_)}
            print(f"{line}; spill bytes {rev_spill or 'not reported'} [{card}]")
            # the flags' band step the same way: cycles a record-step, the
            # other split and (K60+, W = 16) 32 lanes a record on the same
            # records, each against the default's flag words, at 10 MB the
            # Wide walk on the same records (rrx_stream_flags). The run fails
            # if the default split is the slower one at 1 GiB: at 10 MB a warp
            # takes ~2 records, and on the chain batch (a planted chain in one
            # record of 8) the order in which warps draw the heavy records
            # moved the same split's time by 20% between two runs, past the
            # splits' difference (1.5% at 128 MB)
            fl_ms = wide_ms["rrx_nfa_wide_flags", pattern, shape][0]
            fl_want = P.nfa_flags(d, ln, tables, seeded=True)
            line = (f"phase 7: rrx_nfa_wide_flags {tag} {shape}, the band step: diagonals "
                    f"{tables.fwd_diags} at {tables.band_lanes} lanes a record (the default) "
                    f"{fl_ms:.4f} ms = {cyc(fl_ms):.1f} scheduler cycles a record-step")
            forms = [("other split", other_split(tables, tables.fwd_diags))]
            if tables.band_lanes == 16:
                forms.append(("32 lanes", tables._replace(band_lanes=32)))
            for what, tb_f in forms:
                compare("rrx_nfa_wide_flags", [P.nfa_flags(d, ln, tb_f, seeded=True)], [fl_want],
                        f"{tag} {shape} {what}", ("flags",))
                if what == "32 lanes" and shape == "1 GiB":
                    continue  # its 1 GiB time is PERF.md's
                f_ms = time_ms(lambda: P.nfa_flags(d, ln, tb_f, seeded=True), warm=1,
                               runs=3 if shape == "1 GiB" else 5)
                wide_ms["flags " + what, pattern, shape] = (f_ms, cyc(f_ms))
                line += (f", diagonals {tb_f.fwd_diags} at {tb_f.band_lanes} lanes {f_ms:.4f} ms = "
                         f"{cyc(f_ms):.1f}")
                if what == "other split" and shape == "1 GiB" and fl_ms > f_ms:
                    fail(f"rrx_nfa_wide_flags {tag} {shape}: the default split {tables.fwd_diags} "
                         f"({fl_ms:.4f} ms) is slower than {tb_f.fwd_diags} ({f_ms:.4f} ms)")
            if shape == "10 MB":
                words = PK.mask_stream_from_bytes(tabs, d, ln)
                if not torch.equal(PK.flag_words(tabs["nfa"], words, seeded=True), fl_want):
                    fail(f"{tag}: rrx_stream_flags's flag words != rrx_nfa_wide_flags's")
                s_ms = time_ms(lambda: PK.flag_words(tabs["nfa"], words, seeded=True), warm=1,
                               runs=5)
                wide_ms["flags stream", pattern] = (s_ms, cyc(s_ms))
                line += (f"; the Wide walk on the same records (rrx_stream_flags) {s_ms:.4f} ms = "
                         f"{cyc(s_ms):.1f}, the same flag words")
                del words
            fl_spill = {k_: b for k_, b in spilled.items()
                        if re.search(r"\dwide_flags_kernel", k_)}
            occ32 = occupancy_wide("rrx_nfa_wide_flags", tables, d.shape[0], 8)
            print(f"{line}; occupancy at 32 lanes a record: {occ32}; spill bytes "
                  f"{fl_spill or 'not reported'} [{card}]")
            del fl_want
            # the stats' band step (the flags' step, walk and skip, with the
            # statistics in registers) the same way: cycles a record-step,
            # the other split and (K60+) 32 lanes a record on the same
            # records, each held to the default's statistics, and at 10 MB
            # the Wide walk on the same records (rrx_stream_stats over their
            # mask stream: the same cnt and first); the run fails if the
            # default split is the slower one at 1 GiB
            st_ms = wide_ms["rrx_nfa_wide_stats", pattern, shape][0]
            st_want = P.nfa_stats(d, ln, tables, seeded=True)
            line = (f"phase 7: rrx_nfa_wide_stats {tag} {shape}, the band step: diagonals "
                    f"{tables.fwd_diags} at {tables.band_lanes} lanes a record (the default) "
                    f"{st_ms:.4f} ms = {cyc(st_ms):.1f} scheduler cycles a record-step")
            forms = [("other split", other_split(tables, tables.fwd_diags))]
            if tables.band_lanes == 16:
                forms.append(("32 lanes", tables._replace(band_lanes=32)))
            for what, tb_s in forms:
                compare("rrx_nfa_wide_stats", P.nfa_stats(d, ln, tb_s, seeded=True), st_want,
                        f"{tag} {shape} {what}")
                s_ms = time_ms(lambda: P.nfa_stats(d, ln, tb_s, seeded=True), warm=1,
                               runs=3 if shape == "1 GiB" else 5)
                wide_ms["stats " + what, pattern, shape] = (s_ms, cyc(s_ms))
                line += (f", diagonals {tb_s.fwd_diags} at {tb_s.band_lanes} lanes {s_ms:.4f} ms = "
                         f"{cyc(s_ms):.1f}")
                if what == "other split" and shape == "1 GiB" and st_ms > s_ms:
                    fail(f"rrx_nfa_wide_stats {tag} {shape}: the default split {tables.fwd_diags} "
                         f"({st_ms:.4f} ms) is slower than {tb_s.fwd_diags} ({s_ms:.4f} ms)")
            if shape == "10 MB":
                words = PK.mask_stream_from_bytes(tabs, d, ln)
                got_s = PK.match_stats(tabs["nfa"], words, ln, seeded=True, nullable=False)
                if not (torch.equal(got_s[0], st_want[0]) and torch.equal(got_s[1], st_want[1])):
                    fail(f"{tag}: rrx_stream_stats's (cnt, first) != rrx_nfa_wide_stats's")
                s_ms = time_ms(lambda: PK.match_stats(tabs["nfa"], words, ln, seeded=True,
                                                      nullable=False), warm=1, runs=5)
                wide_ms["stats stream", pattern] = (s_ms, cyc(s_ms))
                line += (f"; the Wide walk on the same records (rrx_stream_stats) {s_ms:.4f} ms = "
                         f"{cyc(s_ms):.1f}, the same cnt and first")
                del words
            st_spill = {k_: b for k_, b in spilled.items()
                        if re.search(r"\dwide_stats_kernel", k_)}
            occ32 = occupancy_wide("rrx_nfa_wide_stats", tables, d.shape[0], 9)
            print(f"{line}; occupancy at 32 lanes a record: {occ32}; spill bytes "
                  f"{st_spill or 'not reported'} [{card}]")
            del st_want
            e2e = time_ms(lambda: eng_w.match_stats(d, ln, seeded=True), warm=1,
                          runs=3 if shape == "1 GiB" else 5)
            print(f"phase 7: ScanEngine.match_stats {tag} end to end (data on the card), {shape}: "
                  f"{e2e:.4f} ms = {nb / e2e / 1e6:.1f} GB/s (rrx_nfa_wide_stats "
                  f"{wide_ms['rrx_nfa_wide_stats', pattern, shape][0]:.4f} ms) [{card}]")
    # the reverse's user paths on x(ab|c){300,}y end to end at 10 MB:
    # ScanEngine.starts_bitmap (the hit words unpacked to one bit a position)
    # and Pattern.finditer_batch (the reverse, then the lazy span kernel)
    d, ln, _ = wide_runs[CHAIN300, "10 MB"]
    host, lnh = d.cpu().numpy(), ln.cpu().numpy()
    texts_c = [host[i, : lnh[i]].tobytes() for i in range(d.shape[0])]
    pat300 = rrx_compile(CHAIN300, dev)
    for what, fn, runs in (("ScanEngine.starts_bitmap",
                            lambda: eng300.starts_bitmap(d, ln, d.shape[1]), 3),
                           ("Pattern.finditer_batch (lazy)", lambda: pat300.finditer_batch(texts_c),
                            1)):
        e_ms = time_ms(fn, warm=1, runs=runs)
        wide_ms["rev e2e", what] = e_ms
        print(f"phase 7: {what} {CHAIN300} end to end, 10 MB ({d.shape[0]} records): {e_ms:.3f} ms "
              f"(rrx_nfa_wide_reverse on every record "
              f"{wide_ms['rrx_nfa_wide_reverse', CHAIN300, '10 MB'][0]:.4f} ms) [{card}]")
    del host, texts_c
    # the flags' user path end to end at 10 MB: ScanEngine.ends_bitmap (the
    # flag words unpacked to one bit a position) of K60+ and the chain
    for pattern, eng_w in ((K60P, eng60), (CHAIN300, eng300)):
        d, ln, _ = wide_runs[pattern, "10 MB"]
        e_ms = time_ms(lambda: eng_w.ends_bitmap(d, ln, d.shape[1]), warm=1, runs=3)
        wide_ms["flags e2e", pattern] = e_ms
        print(f"phase 7: ScanEngine.ends_bitmap {pattern[:20]!r}... end to end, 10 MB "
              f"({d.shape[0]} records): {e_ms:.3f} ms (rrx_nfa_wide_flags on every record "
              f"{wide_ms['rrx_nfa_wide_flags', pattern, '10 MB'][0]:.4f} ms) [{card}]")

    lap("the wide record kernels")

    # the wide multi-channel span kernels on the P = 3 union over phase 5's
    # log text at 10 MB and 1 GiB, every record (plain versions once, on the
    # 10 MB batch and on the first n_slice7 records of 1 GiB, outputs compared
    # there); the bound adds to the step (3 per state word of the union) the
    # union test each step and 4 per (channel, firing step)
    scw = mp_w.engine.device_scanner
    tbw, spw = scw.nfa, scw.span
    step_w = 3 * state_words(mp_w.program)
    pop8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64, device=dev)
    wide_mb_ms = {}
    for shape, d, ln in (("10 MB", log10, len10), ("1 GiB", log, log_len)):
        n = d.shape[0] if shape == "10 MB" else n_slice7
        pd, pl = d[:n].contiguous(), ln[:n].contiguous()
        hits = P.nfa_reverse_mb(d, ln, tbw, spw)
        ph, ph_ms = timed_once(lambda: P.reverse_mb_plain(pd, pl, tbw, spw))
        compare("rrx_nfa_wide_reverse_mb", [hits[:, :, :n]], [ph],
                f"P = 3 union {shape}, first {n} records", ("hits",))
        cap_u = 1 << max(int(P.nfa_stats(d, ln, tbw, seeded=True)[0].max()), 1).bit_length()
        lz = P.nfa_lazy_spans_mb(d, ln, tbw, spw, hits, cap_u)
        want, lz_ms = timed_once(lambda: P.lazy_spans_mb_plain(pd, pl, tbw, spw, ph, cap_u))
        compare("rrx_nfa_wide_lazy_spans_mb", [x[:n] for x in lz], want,
                f"P = 3 union {shape}, first {n} records, cap {cap_u}", ("starts", "ends", "cnt"))
        n_hit = int(pop8[hits.contiguous().view(torch.uint8).to(torch.int64)].sum())
        n_emit = int(lz[2].to(torch.int64).sum())
        # the union's stats (32 lanes a record, the channels tested where the
        # union fires), held to the plain version on the slice; the bound
        # counts this run's distinct channel ends as its (channel, step) flags
        st_u = P.nfa_stats(d, ln, tbw, seeded=True)
        want, st_ms = timed_once(lambda: P.stats_plain(pd, pl, tbw, seeded=True, lead=0,
                                                       nullable=False))
        compare("rrx_nfa_wide_stats", [x[:n] for x in st_u], want,
                f"P = 3 union {shape}, first {n} records")
        n_ends = int(st_u[0].to(torch.int64).sum())
        bnd_s = kernel_bound("stats_mc", ln, d.shape[1], step_w, P=3, flags=n_ends)
        calls = {
            "rrx_nfa_wide_reverse_mb": (lambda: P.nfa_reverse_mb(d, ln, tbw, spw), ph_ms,
                                        kernel_bound("reverse_mb", ln, d.shape[1], step_w, P=3,
                                                     flags=n_hit)),
            "rrx_nfa_wide_lazy_spans_mb": (
                lambda: P.nfa_lazy_spans_mb(d, ln, tbw, spw, hits, cap_u), lz_ms,
                kernel_bound("lazy_spans_mb", ln, d.shape[1], step_w, P=3, cap=cap_u,
                             flags=n_emit)),
        }
        nb = int(ln.to(torch.int64).sum())
        steps_u = int((ln.to(torch.int64).clamp(0, d.shape[1]) + 2).sum())
        for name, (kern, plain_ms, bnd) in calls.items():
            ms = time_ms(kern, warm=1, runs=3 if shape == "1 GiB" else 5)
            wide_mb_ms[name, shape] = (ms, plain_ms, bnd)
            kern_name = name[len("rrx_nfa_"):] + "_kernel"
            spill = {k_: b for k_, b in spilled.items() if re.search(r"\d" + kern_name, k_)}
            print(f"phase 7: {name} P = 3 union (s_tile {tbw.s_tile}) {shape} [{d.shape[0]} x "
                  f"{d.shape[1]}], {n_hit} hit bits, {n_emit} spans (cap {cap_u}): kernel "
                  f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s = "
                  f"{ms * 1e6 * CLOCK_GHZ * 4 * n_sm / steps_u:.1f} scheduler cycles a "
                  f"record-step, plain {plain_ms:.3f} ms on {n} records; bound {bnd[0]:.4f} ms by "
                  f"{bnd[1]} [{card}]")
            print(f"  occupancy {name} ({shape}): {occupancy_wide(name, tbw, d.shape[0])}; "
                  f"registers {regs_of(kern_name)}; spill bytes {spill or 'not reported'}")
        ms = time_ms(lambda: P.nfa_stats(d, ln, tbw, seeded=True), warm=1,
                     runs=3 if shape == "1 GiB" else 5)
        wide_mb_ms["stats", shape] = (ms, st_ms, bnd_s)
        st_spill = {k_: b for k_, b in spilled.items() if re.search(r"\dwide_stats_kernel", k_)}
        line = (f"phase 7: rrx_nfa_wide_stats P = 3 union (s_tile {tbw.s_tile}, 32 lanes a "
                f"record) {shape} [{d.shape[0]} x {d.shape[1]}], {n_ends} channel ends: kernel "
                f"{ms:.4f} ms = {nb / ms / 1e6:.1f} GB/s = "
                f"{ms * 1e6 * CLOCK_GHZ * 4 * n_sm / steps_u:.1f} scheduler cycles a record-step, "
                f"plain {st_ms:.3f} ms on {n} records; bound {bnd_s[0]:.4f} ms by {bnd_s[1]}")
        if shape == "10 MB":  # the Wide walk on the same records: the same cnt and first
            tabs_u = PK.stream_tables(mp_w.program, dev)
            words = PK.mask_stream_from_bytes(tabs_u, d, ln)
            got_s = PK.match_stats(tbw, words, ln, seeded=True, nullable=False)
            if not (torch.equal(got_s[0], st_u[0]) and torch.equal(got_s[1], st_u[1])):
                fail("P = 3 union: rrx_stream_stats's (cnt, first) != rrx_nfa_wide_stats's")
            s_ms = time_ms(lambda: PK.match_stats(tbw, words, ln, seeded=True, nullable=False),
                           warm=1, runs=5)
            wide_mb_ms["stats stream", shape] = s_ms
            line += (f"; the Wide walk on the same records (rrx_stream_stats) {s_ms:.4f} ms = "
                     f"{s_ms * 1e6 * CLOCK_GHZ * 4 * n_sm / steps_u:.1f}, the same cnt and first")
            del words
        print(f"{line} [{card}]")
        print(f"  occupancy rrx_nfa_wide_stats P = 3 ({shape}): "
              f"{occupancy_wide('rrx_nfa_wide_stats', tbw, d.shape[0])}; registers "
              f"{regs_of('wide_stats_kernel')}; spill bytes {st_spill or 'not reported'}")
        del st_u
        if shape == "10 MB":  # the band step's other split, the same hit words
            tb_o = other_split(tbw, tbw.rec_diags)
            compare("rrx_nfa_wide_reverse_mb", [P.nfa_reverse_mb(d, ln, tb_o, spw)], [hits],
                    f"P = 3 union {shape} diagonals {tb_o.rec_diags}", ("hits",))
            o_ms = time_ms(lambda: P.nfa_reverse_mb(d, ln, tb_o, spw), warm=1, runs=5)
            wide_mb_ms["other split", shape] = o_ms
            print(f"phase 7: rrx_nfa_wide_reverse_mb P = 3 union {shape}, diagonals "
                  f"{tb_o.rec_diags}: {o_ms:.4f} ms (the default {tbw.rec_diags}: "
                  f"{wide_mb_ms['rrx_nfa_wide_reverse_mb', shape][0]:.4f} ms) [{card}]")
            # lazy spans of the union end to end (MultiPattern.finditer_batch:
            # the reverse_mb pass, then the span pass and the host's lists)
            host, lnh = d.cpu().numpy(), ln.cpu().numpy()
            texts_u = [host[i, : lnh[i]].tobytes() for i in range(d.shape[0])]
            e_ms = time_ms(lambda: mp_w.finditer_batch(texts_u), warm=1, runs=1)
            wide_mb_ms["e2e"] = e_ms
            print(f"phase 7: MultiPattern.finditer_batch (lazy) of the P = 3 union end to end, "
                  f"{shape} ({d.shape[0]} records): {e_ms:.3f} ms (rrx_nfa_wide_reverse_mb "
                  f"{wide_mb_ms['rrx_nfa_wide_reverse_mb', shape][0]:.4f} ms) [{card}]")
            del host, texts_u
    del hits, lz

    lap("the wide multi-channel span kernels")

    # the wide long-string window kernels at 1 GiB in the geometry of
    # Pattern.long(K60) (phase 12's string; carry, off the main path, in the
    # count geometry), plain versions on 1 MiB in the same geometry (kernel
    # == plain there too); count_ends end to end for K60 and x(ab|c){300,340}y
    long_wide_ms = {}
    tb60, W60 = lsc.tables, state_words(lsc.prog)
    long_wide_calls = {
        "rrx_long_wide_carry": (lsc._ov_geom, lambda d, g: P_.long_carry(d, g, tb60, seeded=True),
                                lambda d, g: P_.long_carry_plain(d, g, tb60, seeded=True), "carry"),
        "rrx_long_wide_flags": (lsc._ov_geom, lambda d, g: P_.long_flags(d, g, tb60, seeded=True),
                                lambda d, g: P_.long_flags_plain(d, g, tb60, seeded=True), "flags"),
        "rrx_long_wide_count": (lsc._ov_geom, lambda d, g: P_.long_count(d, g, tb60, seeded=True),
                                lambda d, g: P_.long_count_plain(d, g, tb60, seeded=True), "count"),
        "rrx_long_wide_reverse": (lambda n: rev_geom(lsc, n),
                                  lambda d, g: P_.long_reverse(d, g, tb60),
                                  lambda d, g: P_.long_reverse_plain(d, g, tb60), "reverse"),
    }
    for name, (geom_of, kern, plain, work) in long_wide_calls.items():
        g1, gs = geom_of(NLw), geom_of(small)
        d_small = s60[:small]
        got, want = kern(d_small, gs), plain(d_small, gs)
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        got, want = [x for x in got if x is not None], [x for x in want if x is not None]
        compare(name, got, want, "K60, 1 MiB", tuple(f"out{i}" for i in range(len(got))))
        ms = time_ms(lambda: kern(s60, g1), warm=1, runs=5)
        plain_ms = time_ms(lambda: plain(d_small, gs), warm=0, runs=1)
        bnd = long_bound(work, g1, W60)
        long_wide_ms[name] = (ms, plain_ms, bnd)
        print(f"phase 7: {name} K60 overlapped windows, 1 GiB [{g1.nw} windows x {g1.T} steps, "
              f"block {g1.block}, {W60} state words]: kernel {ms:.3f} ms = {NLw / ms / 1e6:.1f} GB/s, "
              f"plain {plain_ms:.1f} ms on 1 MiB; bound {bnd[0]:.4f} ms by {bnd[1]}; launches on "
              f"the path {wide_launches[name]} [{card}]")
        band = name != "rrx_long_wide_carry"
        units = -(-g1.nw // (32 // tb60.band_lanes)) if band else g1.nw
        kname = name.replace("wide", "band") if band else name
        print(f"  occupancy {name}: {occupancy_wide(name, tb60, units)}; registers "
              f"{regs_of(kname[len('rrx_'):] + '_kernel')}")
    e2e_k60 = time_ms(lambda: lsc.count_ends(s60), warm=1, runs=5)
    e2e_ch = time_ms(lambda: lsc_c.count_ends(sch), warm=1, runs=5)
    gch = lsc_c._ov_geom(NLw)
    ms_ch = time_ms(lambda: P_.long_count(sch, gch, lsc_c.tables, seeded=True), warm=1, runs=5)
    print(f"phase 7: long-string count_ends end to end, 1 GiB on the card (ms): K60 {e2e_k60:.3f} "
          f"(rrx_long_wide_count {long_wide_ms['rrx_long_wide_count'][0]:.3f}), {CHAIN340} "
          f"{e2e_ch:.3f} (rrx_long_wide_count {ms_ch:.3f} on {gch.nw} windows x {gch.T} steps, "
          f"bound {long_bound('count', gch, state_words(lsc_c.prog))[0]:.4f}); PR 9's torch-op "
          f"LongScanner took ~1-2 s for K60 on 1 MiB [{card}]")
    # FastLongScanner.flags (the path of ends_bitmap and of search past the
    # count) end to end: rrx_long_wide_flags on the band step, then the flag
    # words unpacked to [n + 2] bools on the card
    fl_k60 = time_ms(lambda: lsc.flags(s60), warm=1, runs=5)
    fl_ch = time_ms(lambda: lsc_c.flags(sch), warm=1, runs=5)
    flk_ch = time_ms(lambda: P_.long_flags(sch, gch, lsc_c.tables, seeded=True), warm=1, runs=5)
    print(f"phase 7: long-string flags end to end, 1 GiB on the card (ms): K60 {fl_k60:.3f} "
          f"(rrx_long_wide_flags {long_wide_ms['rrx_long_wide_flags'][0]:.3f}), {CHAIN340} "
          f"{fl_ch:.3f} (rrx_long_wide_flags {flk_ch:.3f}, its count {ms_ch:.3f}) [{card}]")

    lap("the wide long-string kernels")

    # the band step's registers and spills (the run fails if a band kernel
    # spills) and its occupancy at 32 lanes a window; its A/B timings against
    # the Wide step and across splits are PERF.md's and moved with
    # no kernel since
    band_spill = {}
    for kern in ("long_band_flags_kernel", "long_band_count_kernel", "long_band_reverse_kernel",
                 "long_wide_carry_kernel"):
        band_spill[kern] = {n: b for n, b in spilled.items() if re.search(r"\d" + kern, n)}
        print(f"phase 7: {kern}: registers {regs_of(kern)}; spill bytes "
              f"{band_spill[kern] or 'not reported'}")
        if kern.startswith("long_band") and any(band_spill[kern].values()):
            fail(f"{kern} spills: {band_spill[kern]}")
    for name, idx in (("rrx_long_wide_count", 4), ("rrx_long_wide_reverse", 5)):
        print(f"  occupancy {name} at 32 lanes a window: "
              f"{occupancy_wide(name, tb60, lsc._ov_geom(NLw).nw, idx)}")

    # rows 7-10: the four stream kernels, every record, at 10 MB on cat|dog
    # (W = 1: the packed backend's batch of phase 13), K30 (W = 8) and config
    # 4's a{1,300} (W = 12), and at 1 GiB on cat|dog (its stream is 4 GiB: 4
    # Wt bytes a record-step; W >= 4 would pass 16 GiB); rescans from each
    # record's first match start, longest; plain versions once (10 MB: the
    # whole batch; 1 GiB: the first n_slice7 records), outputs compared there
    def stream_bound(kind, Wt, sw, T, R, *, starts=None, end=None):
        """(bound_ms, bound_by): the stream's 4 Wt bytes a record-step read
        once (the kernel's input), the outputs written once; 3 operations per
        word of the program's states a step, plus the bookkeeping (stats 4,
        flags and reverse 2, rescans 2). Rescans count the steps from each
        live start to its end (1 when none), as rows 19 and 37 do."""
        if kind == "first_end":
            st = starts.to(torch.int64)
            span = torch.where(end >= 0, end.to(torch.int64) - st + 1, 1)
            steps = int(torch.where(st >= 0, span, 0).sum())
            return bound(4 * Wt * steps + 12 * R, 4 * R, steps * (3 * sw + 2))
        if kind == "stats":
            return bound(4 * Wt * T * R + 4 * R, 12 * R, T * R * (3 * sw + 4))
        return bound(4 * Wt * T * R, 4 * (-(-T // 32)) * R, T * R * (3 * sw + 2))

    stream_ms = {}
    runs_s = [("cat|dog", "10 MB") + pk_runs["cat|dog"][:2], (K30, "10 MB") + pk_runs[K30][:2],
              (CONFIG4, "10 MB") + pk_runs["cat|dog"][:2], ("cat|dog", "1 GiB", big, big_len)]
    for pattern, shape, d, ln in runs_s:
        prog = compile_program(pattern)
        tabs = PK.packed_tables(prog, dev)
        nfa = tabs["nfa"]
        Wt, sw = tabs["Wt"], state_words(prog)
        ms_w = time_ms(lambda: PK.mask_stream_from_bytes(tabs, d, ln), warm=1, runs=3)
        words = PK.mask_stream_from_bytes(tabs, d, ln)
        T, R = words.shape[:2]
        n = R if shape == "10 MB" else n_slice7
        pw, pl = words[:, :n], ln[:n]
        hits = PK.reverse_hits(nfa, words)
        has = hits.any(dim=1)
        st = torch.where(has, (hits.to(torch.int8).argmax(dim=1) - 1).clamp(min=0), -1)
        st = st.to(torch.int32)
        end = PK.first_end_from(nfa, words, ln, st, longest=True)
        calls = {
            "rrx_stream_stats": (lambda: PK.match_stats(nfa, words, ln, seeded=True, nullable=False),
                                 lambda: PK.match_stats_plain(nfa, pw, pl, seeded=True,
                                                              nullable=False), "stats"),
            "rrx_stream_flags": (lambda: [PK.forward_flags(nfa, words, seeded=True)],
                                 lambda: [PK.forward_flags_plain(nfa, pw, seeded=True)], "flags"),
            "rrx_stream_reverse": (lambda: [PK.reverse_hits(nfa, words)],
                                   lambda: [PK.reverse_hits_plain(nfa, pw)], "reverse"),
            "rrx_stream_first_end": (
                lambda: [PK.first_end_from(nfa, words, ln, st, longest=True)],
                lambda: [PK.first_end_plain(nfa, pw, pl, st[:n], longest=True)], "first_end"),
        }
        for name, (kern, plain, kind) in calls.items():
            if kind == "first_end" and pattern != CONFIG4 and shape == "10 MB":
                continue  # the rescans' shape is config 4's
            got = kern()
            want, plain_ms = timed_once(plain)
            compare(name, [x[:n] for x in got], want, f"{pattern[:20]!r} {shape}, first {n} records",
                    tuple(str(i) for i in range(len(want))))
            # the kernel alone: flags and hits as the words it writes
            if kind == "flags":
                kern = lambda: PK.flag_words(nfa, words, seeded=True)  # noqa: E731
            elif kind == "reverse":
                kern = lambda: PK.hit_words(nfa, words)  # noqa: E731
            ms = time_ms(kern, warm=1, runs=3 if shape == "1 GiB" else 5)
            bnd = stream_bound(kind, Wt, sw, T, R, starts=st, end=end)
            stream_ms[name, pattern, shape] = (ms, plain_ms, bnd)
            bps, tpb = ctypes.c_int(0), ctypes.c_int(0)
            _build.check(lib.rrx_stream_occupancy(STREAM_KERNELS.index(name), int(prog.s_tile),
                                                  ctypes.byref(bps), ctypes.byref(tpb)),
                         "rrx_stream_occupancy")
            form = "wide_" if prog.s_tile > scan_pallas.REG_S_TILE else ""
            print(f"phase 7: {name} {pattern[:20]!r} (W = {Wt}) {shape} [{T} steps x {R} records, "
                  f"stream {4 * Wt * T * R / 2**20:.0f} MiB]: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
                  f"ms on {n} records; bound {bnd[0]:.4f} ms by {bnd[1]}; stream build "
                  f"{ms_w:.3f} ms; occupancy {bps.value * tpb.value}/{max_threads} threads per "
                  f"SM; registers {regs_of(form + name[len('rrx_'):] + '_kernel')} [{card}]")
        del words, hits

    lap("the band step's registers and the stream kernels")

    # the three backends end to end: match_stats (seeded) of 10 MB on the card
    for pattern in ("cat|dog", K30):
        d, ln, p_def, p_pk = pk_runs[pattern]
        p_x = rrx_compile(pattern, dev, backend="xla")
        e2e = {
            "default": time_ms(lambda: p_def.engine.match_stats(d, ln, seeded=True), warm=1, runs=5),
            "packed": time_ms(lambda: p_pk.engine.match_stats(d, ln, seeded=True), warm=1, runs=5),
            "xla": time_ms(lambda: p_x.engine.match_stats(d, ln, seeded=True), warm=1, runs=3),
        }
        if not all(torch.equal(a, b) for a, b in zip(p_x.engine.match_stats(d, ln, seeded=True),
                                                     p_def.engine.match_stats(d, ln, seeded=True))):
            fail(f"{pattern[:30]!r} xla match_stats != the default route")
        print(f"phase 7: match_stats end to end, {pattern[:30]!r} 10 MB (ms): default route "
              f"({type(p_def.engine.device_scanner).__name__}) {e2e['default']:.3f}, packed "
              f"(mask stream + rrx_stream_stats) {e2e['packed']:.3f}, xla (torch ops) "
              f"{e2e['xla']:.3f} [{card}]")
    print(f"phase 7: C3 on the XLA backend, 1 MB (s): "
          f"{ {p: {k: round(v, 3) for k, v in t.items()} for p, t in c3_times.items()} }; C2 "
          f"Pattern.long count_ends over 64 KiB (s): "
          f"{ {p: round(v, 2) for p, v in c2_times.items()} }; config 4 finditer_batch host rounds "
          f"(rounds, s): {rounds4} [{card}]")

    ms, plain_ms, bnd = flags_ms["10 MB"]
    kernels.append({
        "name": "rrx_nfa_flags", "route": "cuda", "source": NFA_SOURCE,
        "replaces": REPLACES["rrx_nfa_flags"], "launches": count_launches["rrx_nfa_flags"],
        "max_abs_err": max_err["rrx_nfa_flags"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "shape": f"config 7's 10 MB shape, {len(K30_WORDS)}-keyword log text",
    })
    for name in COUNT_KERNELS:
        ms, plain_ms, bnd = count_ms[name, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": COUNT_SOURCE, "replaces": REPLACES[name],
            "launches": count_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "shape": f"config 4, 10 MB, {CONFIG4}",
        })
    for name in MP_KERNELS:
        ms, plain_ms, bnd = mp_ms[name, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": STATS_SOURCE if name == "rrx_word_stats[P]" else NFA_SOURCE,
            "replaces": REPLACES[name], "launches": mp_launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None,
            "shape": ("10 MB, K7 as 7 patterns" if name == "rrx_nfa_stats[P]"
                      else "config 6, 10 MB, 4 patterns"),
        })
    for name in LONG_KERNELS:
        ms, plain_ms, bnd, what = long_ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": LONG_SOURCE, "replaces": REPLACES[name],
            "launches": long_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"1 GiB, {what} (plain: 1 MiB)",
        })
    for name in BITBAND_KERNELS:
        ms, plain_ms, bnd, n = bb_ms[name, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": BITBAND_SOURCE, "replaces": REPLACES[name],
            "launches": bitband_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"config 10 {CONFIG10}, 10 MB, every record (no prefilter)",
        })
    for name in SPARSE_KERNELS:
        ms, plain_ms, bnd, n = sp_ms[name, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": SPARSE_SOURCE, "replaces": REPLACES[name],
            "launches": sparse_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"K120 ({len(K120_WORDS)} keywords), 10 MB of log text, every record, "
                     f"walk_max {SP.WALK_MAX}",
        })
    for name in WIDE_KERNELS:
        ms, plain_ms, bnd = wide_ms[name, CHAIN300, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": NFA_WIDE_SOURCE, "replaces": REPLACES[name],
            "launches": wide_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"{CHAIN300} (s_tile 1024, W = 32), 10 MB of log text with chains planted",
        })
    for name in WIDE_MB_KERNELS:
        ms, plain_ms, bnd = wide_mb_ms[name, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": NFA_WIDE_SOURCE, "replaces": REPLACES[name],
            "launches": wide_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"MultiPattern {['K40+'] + WIDE_MP[1:]} (s_tile 384, P = 3), 10 MB of log text",
        })
    for name in LONG_WIDE_KERNELS:
        ms, plain_ms, bnd = long_wide_ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": LONG_WIDE_SOURCE, "replaces": REPLACES[name],
            "launches": wide_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": "1 GiB, K60 (s_tile 512, W = 16) overlapped windows (plain: 1 MiB)"
                     + ("; off the main path (the summary and speculative modes take narrow "
                        "tiles only), held in phase 2" if name == "rrx_long_wide_carry" else "")
                     + (f"; band step, diagonals {tb60.diags}, {tb60.band_lanes} lanes a window"
                        if name != "rrx_long_wide_carry" else ""),
        })
    for name in STREAM_KERNELS:
        pat_k = CONFIG4 if name == "rrx_stream_first_end" else "cat|dog"
        ms, plain_ms, bnd = stream_ms[name, pat_k, "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": STREAM_SOURCE, "replaces": REPLACES[name],
            "launches": stream_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": (f"config 4 {CONFIG4} (W = 12), 10 MB, longest rescans from each record's "
                      "first start" if pat_k == CONFIG4
                      else "cat|dog (W = 1), 10 MB (config 1's corpus), every record"),
        })
    ms, plain_ms, bnd, word_ms = swm_ms["10 MB"]
    kernels.append({
        "name": "rrx_swar_multi_stats", "route": "cuda", "source": STATS_SOURCE,
        "replaces": REPLACES["rrx_swar_multi_stats"],
        "launches": new_launches["rrx_swar_multi_stats"],
        "max_abs_err": max_err["rrx_swar_multi_stats"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "shape": f"config 6, 10 MB, 4 patterns, RRX_SWAR_MULTI=1 (rrx_word_stats[P] on the same "
                 f"data: {word_ms:.4f} ms)",
    })
    for name in SPARSE_STREAM_KERNELS:
        ms, plain_ms, bnd, byte_ms, ms_w = sps_ms[name, "K120", "10 MB"]
        kernels.append({
            "name": name, "route": "cuda", "source": SPARSE_SOURCE, "replaces": REPLACES[name],
            "launches": new_launches[name], "max_abs_err": max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": f"K120 mask stream of 10 MB of log text (plain: 1024 records; stream build "
                     f"{ms_w:.3f} ms, the byte kernel {byte_ms:.3f} ms)",
        })
    if len(kernels) != 51:
        fail(f"the kernels line lists {len(kernels)} kernels, not 51")
    lap("the backends and the rest of phase 7")
    print(f"chip_smoke.py: {time.perf_counter() - t_run:.1f}s from the card check to the result")

    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
