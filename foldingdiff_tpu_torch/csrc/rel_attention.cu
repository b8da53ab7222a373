// Fused BERT self-attention with HF `relative_key` position scores, for Hopper.
//
// Replaces the Pallas TPU kernels foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel_v2 (HAS_REL = true) and _attn_kernel_v2 (HAS_REL = false),
// entry fused_attention_v2. For every batch item b, head h and query row l it
// computes
//
//   s[j]   = (q[l] . k[j] + q[l] . E[l - j + M - 1]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with bias (B, L) the additive key mask (0 or -10000, never -inf) and E the
// raw (2M-1, D) distance-embedding table, L <= M. The relative term is added
// before the scale, as in HF BERT. q, k and v are (B, H, L, D) float32 views
// in any layout whose last dimension has stride 1 and whose rows start on 16
// bytes: the denoiser passes the (B, L, H, D) projections as they are. out is
// written as a contiguous (B, L, H, D) buffer, the layout the output
// projection reads.
//
// Eleven instances, one per matmul precision of the model (the caller picks
// one by `instance`; ops/attention.py maps the model's mode onto it), each
// computing the products that the JAX model's einsums compute in that mode:
//   0 FMA   (IEEE float32, "highest"): rel_attention_kernel, float32 FMA on
//           the CUDA cores;
//   1 TF32  ("high", and "default" under a caller's TF32):
//           rel_attention_tf32_kernel, q.k, q.E and p.v on TF32 tensor cores
//           (mma.sync m16n8k8), each operand rounded to TF32 by
//           cvt.rna.tf32.f32 (to nearest, ties away from zero), float32 sums;
//   2 bf16  ("BF16_BF16_F32"): rel_attention_bf16_kernel, operands rounded
//           to bf16 values (to nearest even): q, k, v and E, and P before
//           p.v. Each product is the exact product of two bf16 values and
//           the sums are float32, as JAX's preset defines. P is normalised
//           before it is rounded, as the einsum's operand is the softmax's
//           output. In the resident design the products run on the bf16
//           tensor cores (mma.sync m16n8k16, attention_half, with the 16-bit
//           instances below), the relative term float32; in the chunked
//           design on the TF32 ones, which hold bf16's 8 significant bits.
//   3-6     ("TF32_TF32_F32_X3", "BF16_BF16_F32_X3", "_X6", "_X9"):
//           rel_attention_{tf32x3,bf16x3,bf16x6,bf16x9}_kernel, the
//           multi-pass presets (device.cuh's Arith): every operand of q.k,
//           q.E and p.v split into two or three TF32 or bf16 parts, the
//           listed products of parts summed in float32, the smallest first
//           per k-step: bf16 parts on the bf16 tensor cores (m16n8k16), TF32
//           parts on the TF32 ones. P is split after it is normalised, as
//           the single-rounding instances round it.
//   7 f64   ("F64_F64_F64"): rel_attention_f64_kernel, every product in
//           float64, each dot's output rounded to float32: on the FP64
//           tensor cores (mma.sync m16n8k16 f64, DMMA) in the resident
//           design (attention_f64, below), and past it float64 FMA on the
//           CUDA cores (device.cuh's f64 design, which v1 shares);
//   8-10    ("F16_F16_F32", "F16_F16_F16", "BF16_BF16_BF16"):
//           rel_attention_{f16,f16f16,bf16bf16}_kernel, operands rounded to
//           f16 values (f16, f16f16) or bf16 values (bf16bf16); f16f16 and
//           bf16bf16 then round each dot's output once to f16 or bf16
//           (device.cuh's output): q.k and q.E each before their sum (their
//           accumulators apart), p.v before it is stored. The sums stay
//           float32, which is how the port reads those presets
//           (precision.py). All three run on 16-bit operands, on the f16 or
//           bf16 tensor cores (mma.sync m16n8k16, attention_half), in the
//           resident design, f16 as bf16 does, with no output rounding and
//           its relative term in float32; the chunked design runs them on
//           the bf16 body's TF32 tensor cores.
// Softmax is float32 in every instance, in exp2 units with the scale folded
// in.
//
// What bounds it, per flagship call (B = 64, H = 12, L = 128, D = 32): 3 L^2 D
// multiply-adds per (b, h) pair (q.k, q.E and p.v), 2.42 GFLOP in all, and
// 50.4 MB of q, k, v and out to move. FMA: 36.1 us at the H100's 67 TFLOP/s
// float32 rate outside the tensor cores against 15.0 us of bytes at 3.35
// TB/s, so operations bound it. TF32: 4.9 us at 495 TFLOP/s, so the bytes
// bound it, at 15.0 us. The multi-pass instances run 3, 6 or 9 times
// the products: TF32x3 14.7 us at 495 TFLOP/s, bf16x3 7.3, bf16x6 14.7 and
// bf16x9 22.0 us at bf16's 989, so the bytes bound all but bf16x9
// (operations). f64: 36.1 us at the H100's 67 TFLOP/s float64 peak, its
// FP64 tensor cores', which the resident f64 body runs on (operations; the
// float64 FMA design past it peaks at half of it); bf16's and the 16-bit
// instances' products 2.4 us at 989 TFLOP/s, so the bytes bound them.
//
// FMA design: register tiles on the CUDA cores. The SM serves one
// shared-memory wavefront (32 lanes x 4 bytes) per clock against four
// warp-wide FMAs, so a thread must do about four FMAs per float it reads from
// shared memory (a first design of one thread per query row read three per
// FMA and ran at 19% of the bound, 0.1894 ms on an H100 80GB HBM3 at 700 W).
// A unit of 64 threads owns one head and a tile of 64 query rows and walks
// the keys in chunks of 64:
//   - Scores. Thread (rg, kg) of the unit owns rows rg + 8 i and keys kg + 8 jj
//     (i, jj < 8). Both step by 8, so l - j = rg - kg + 8 (i - jj) takes 15
//     values: the 64 scores need 8 q rows, 8 k rows and 15 table rows, read
//     as 16-byte vectors, for 128 FMAs per 4 dimensions (31 floats read).
//     The 8 lanes of a quarter-warp share rg and take consecutive kg, so
//     they read consecutive K and table rows, padded to D + 4 floats (4 mod
//     32) onto distinct banks, and one q vector as a broadcast.
//   - Softmax, online over chunks: row maxima and sums across the 8 lanes of
//     a row by xor-shuffles. Probabilities go to shared memory transposed
//     (key-major); the running maxima, denominators and each chunk's rescale
//     factors live in shared memory too, which keeps the thread under the
//     168 registers that three blocks per SM leave it. The d loop and the
//     staging loops are not unrolled, for the same reason: unrolled, ptxas
//     spills.
//   - p . v. Thread (rgp, dg) owns D / 4 consecutive rows x 4 dimensions
//     (8 x 4 at D = 32) and reads per key its rows' probabilities and one V
//     vector: 12 floats for 32 FMAs.
// A block holds two units, two heads of one batch item and one row tile,
// which share the staged table window and bias of every chunk. One head per
// block was 47% slower at B = 64, L = 64 and no faster at the sampler's small
// chunk (scripts/rel_attention_variants.py). Per chunk, K, V, the bias and
// the 127 table rows are filled with 16-byte cp.async (4-byte for the bias);
// V has its own copy group, waited for only before p . v. The probabilities
// overwrite K and the window once the scores are made, so shared memory
// stays 73 KB at D = 32, three blocks (12 warps) per SM. Measured at the
// flagship shape: 0.0787 ms, 46% of its 36.1 us bound (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py phase 2).
//
// Tensor-core design (TF32), resident: L <= 128 at D <= 32, every shipped
// configuration. bf16 ran it too, its operands rounded to bf16 values in
// the stage, until the 16-bit-plane body below took it. A block of eight warps serves work items, each KEYS query
// rows and keys of one (b, h) pair at 64 < L <= 128 (KEYS = 128, a warp per
// 16 rows) or of two pairs at L <= 64 (KEYS = 64, four warps each); the
// blocks are persistent (at most two per SM) and walk the items.
//   - An item's q, k and v rows and its bias are copied into a stage with
//     16-byte cp.async by all 256 threads, consecutive threads on consecutive
//     16 bytes of a row, rows padded to D + 4 floats so that every fragment
//     load falls on distinct banks: a pair's K and V are staged once, not
//     once per 64-row tile and 64-key chunk. Each staged operand is then
//     rounded once in place (cvt.rna.tf32.f32, or to bf16), so no fragment
//     load converts, and K and E fragments come by ldmatrix.x4 (two k-steps
//     a load).
//   - The distance table is resident: the 2 KEYS rows that the windows reach
//     (offsets l - j from 1 - KEYS to KEYS) are staged and rounded once per
//     block, for all its items.
//   - The relative term is one more product: QE = Q . E_win^T per window of
//     keys (16 at KEYS = 128, 64 at KEYS = 64) over the table rows the
//     warp's 16 rows reach in it, into the warp's slice of shared memory,
//     read back skewed, rel[r, c] = QE[r, r - c + window - 1], as the first
//     value of each score accumulator: the Toeplitz structure that
//     _skew_rows builds with static rolls on the TPU.
//   - A warp holds its 16 x KEYS scores in registers (64 floats a lane at
//     KEYS = 128) and takes each row's exact maximum and sum, as the TPU
//     kernel does: no online rescale, and P normalised before it is rounded
//     for p . v in one pass over the keys.
//   - p . v from the score accumulators as they are. The accumulator of an
//     m16n8 tile holds columns 2t and 2t + 1 of rows g and g + 8, where the
//     A fragment of m16n8k8 wants columns t and t + 4: the products are
//     summed over the keys, so the k-step takes its 8 keys in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) for P and V alike, and each lane reads V rows
//     2t and 2t + 1. No shuffle, no trip through shared memory.
// What bounds it: latency, not bytes or the tensor cores (the bytes' floor
// is 15.0 us at the flagship shape, the TF32 products' 4.9 us, so mma.sync
// and not wgmma, whose TF32 takes only K-major operands and would need V
// transposed). One block of eight warps per SM ran 23-37% slower than two
// (16 warps, 128 registers a thread: the scores and fragments need them); at
// D = 32 the table (36.9 KB), the QE slices (20.5 KB, the reason for 16-key
// windows; 32 or 64 fit only one block and ran 15% slower) and one stage
// (55.8 KB) make 113 KB a block. A __syncwarp between n-tiles keeps ptxas from issuing
// every fragment load of the unrolled loops first, which spilled. At
// KEYS = 64 an item holds half the work for the same bytes, so one block
// per SM with a ring of three stages and 64-key windows ran faster. A first
// design that filled a ring from one producer warp lost to the chunked
// design by 2x: per-row bulk copies (the TMA unit) serialised at ~17 us an
// item, and one warp's cp.async could not keep the ring full. Measured at
// the flagship shape: TF32 0.0456 ms, 33% of its bound, and bf16 on it
// 0.0462, against the chunked design's 0.0500 and 0.0931 in the same run
// (NVIDIA H100 80GB HBM3, 700 W; scripts/kernel_times_two_trees.py, and the
// variants in scripts/rel_attention_variants.py). bf16 on this body read
// 0.0464 / 0.0313 ms at 64 x 128 with / without relative scores, 0.0162 /
// 0.0123 at 64 x 64, 0.0075 / 0.0056 at 15 x 64, where attention_half read
// 0.0357 / 0.0256, 0.0141 / 0.0112, 0.0065 / 0.0053 in turns with it
// (NVIDIA H100 80GB HBM3, 700.00 W; scripts/rel_attention_variants.py
// bf16-tf32-body).
//
// Multi-pass instances, resident (attention_parts): each operand split once
// (device.cuh's split4, products), one block of eight warps per SM (255
// registers, the scores and parts need them):
//   - the table's parts once per block, K's and V's once per item, into
//     planes in shared memory (bf16 rows D + 8 values apart, TF32 rows
//     D + 4 words: ldmatrix's rows on distinct banks), so that each warp
//     loads its B fragments as split, K and the table by ldmatrix, V by
//     ldmatrix.trans for bf16 (scalar loads for TF32);
//   - q's parts into registers once per item from the float32 stage, P's
//     per 16 keys from two n-tiles' accumulators (an m16n8k16 A fragment as
//     they are: no key order, no shuffle);
//   - bf16 parts on m16n8k16, TF32 parts on m16n8k8; each product over a
//     group of n-tiles (group_of: as many as kGroupWords = 24 registers of
//     B parts hold) whose accumulators interleave, per k-step the table's
//     products smallest first; QE by windows of 64 keys for bf16 parts at
//     KEYS = 128 (fewer table rows per key: 16-key windows ran 9-10%
//     slower at 64 x 128, scripts/rel_attention_variants.py).
// At KEYS = 128 and D = 32 shared memory holds the table's parts (61,440
// bytes at x6 and x9), K's and V's (61,440), the 64-key QE slices (45,056),
// the bias and one float32 stage (55,808): 224,256 of the 232,448 bytes a
// block may have. The stage is
// released once split, so the next item's copies land while this item
// computes (a second stage, which fits without relative scores, ran no
// faster). Measured at the flagship shape with relative scores (NVIDIA
// H100 80GB HBM3, 700 W, in turns with the earlier form, which split every
// fragment at each TF32 mma: scripts/kernel_times_two_trees.py): tf32x3
// 0.0863 -> 0.0708 ms, bf16x3 0.1091 -> 0.0474, bf16x6 0.1729 -> 0.0631,
// bf16x9 0.2311 -> 0.0751. TF32x3 at L <= 64 runs the TF32 instance's
// body instead (attention: one block per SM, a ring of three
// float32 stages), since planes of parts ran 5-11% slower there without
// relative scores, their 32-bit words doubling the shared-memory traffic
// of bf16's. It splits once all the same (kSplitAtLoad): q's parts into
// registers once per item, each K, table and V fragment as it is loaded
// from the float32 stage (ldmatrix for K and the table, scalar loads of
// V's rows 2t, 2t + 1, 8 + 2t, 9 + 2t per 16 keys), P's per 16 keys, the
// products of groups of n-tiles interleaved (group_of, as many as
// kX3GroupWords = 48 registers of B parts hold: five QE n-tiles, four
// score n-tiles, the four of p.v). Its sums are those of the form that
// split at each mma. Measured in turns (scripts/rel_attention_variants.py,
// NVIDIA H100 80GB HBM3, 700 W; ms at 64 x 64 rel / rel-off, 15 x 64 rel /
// rel-off): split at each mma 0.0216 / 0.0139 / 0.0091 / 0.0064 and
// 0.0213 / 0.0139 / 0.0089 / 0.0063; split at the load, groups of 24 words
// (two n-tiles) 0.0193 / 0.0135 / 0.0084 / 0.0062 and 0.0189 / 0.0136 /
// 0.0083 / 0.0062; of 32 words 0.0190 / 0.0135 / 0.0082 / 0.0061; of 48
// 0.0185 / 0.0136 / 0.0080 / 0.0062 (kept); of 80 0.0192 / 0.0139 / 0.0083
// / 0.0063. The chunked design below runs the
// multi-pass instances as a loop over the products (device.cuh's mma<A>):
// unrolled there, at 168 registers (255 at D = 64), ptxas spilled.
// The TF32 parts are rounded by integer operations (device.cuh's
// round_part): with cvt.rna the resident tf32x3 instance spilled 12 bytes.
//
// 16-bit instances, resident (attention_half; bf16, f16, f16f16 and
// bf16bf16 at L <= 128, D <= 32): 16-bit operands. They ran the body above
// (the float32 stage rounded in place, products on m16n8k8 of 32-bit words;
// f16f16 and bf16bf16 at one block per SM: at two blocks' 128 registers the
// rounded q.k and the relative term held apart spilled), f16f16 and
// bf16bf16 0.0512 / 0.0562 ms at the flagship shape with relative scores. The bytes bound
// them (15.0 us; the products 2.4 us at 989 TFLOP/s); what held them was
// the latency of each item's copy, rounding pass and products at eight
// warps per SM.
//   - q, K, V and the table are rounded to f16 or bf16 once, as they leave
//     the float32 stage (the table once per block), into planes of rows
//     D + 8 values apart, and the stage is released to the next item's
//     copies; K and the table come by ldmatrix (x4: both chunks of D = 32
//     at once), V by ldmatrix.trans (two output n-tiles a load);
//   - every product is one m16n8k16 on the f16 or bf16 tensor cores with a
//     float32 accumulator (device.cuh's mma16): half the mma instructions
//     and half the shared-memory bytes of the TF32 body's fragments;
//   - q.k and q.E each from a zero accumulator, rounded on its own: QE by
//     windows of 32 keys into the warp's slice as 16-bit values (each is
//     rounded to A's type anyway: half the slice, so that two blocks fit),
//     read back skewed and added to the rounded q.k of the window's keys;
//     P normalised, then packed to 16 bits (32 registers at KEYS = 128, not
//     64), the A fragments of p.v as they lie;
//   - two blocks of eight warps per SM at KEYS = 128, where 768 items of
//     the flagship shape make 2.9 rounds of 264 blocks (128 registers: QE's
//     and the window's products one n-tile at a time with relative scores;
//     two to four at a time spilled 16-24 bytes in three of the forms tried
//     and ran no faster in the others); one at
//     KEYS = 64, where 384 items of two pairs over 264 blocks left a second
//     round two thirds empty.
// Measured at the flagship shape in turns with the body above (NVIDIA H100
// 80GB HBM3, 700 W; scripts/kernel_times_two_trees.py): f16f16 0.0512 ->
// 0.0346 ms and bf16bf16 0.0562 -> 0.0349 with relative scores, 0.0313 ->
// 0.0251 and 0.0329 -> 0.0255 without (bf16 or f16 SDPA 0.0248-0.0249:
// the 50.4 MB of float32 q, k, v and out at 2.0 TB/s, against SDPA's 16-bit
// inputs). The variants in turns (scripts/rel_attention_variants.py; ms of
// f16f16 / bf16bf16 at 64 x 128 rel, rel-off; 64 x 64 rel, rel-off; 15 x 64
// rel, rel-off): this form 0.0339 / 0.0347, 0.0252 / 0.0254; 0.0138 /
// 0.0138, 0.0113 / 0.0116; 0.0063 / 0.0063, 0.0050 / 0.0051. One block per
// SM at KEYS = 128 0.0404 / 0.0405, 0.0277 / 0.0277; a ring of two stages
// there (one block) 0.0420 / 0.0425, 0.0275 / 0.0277; 16-key QE windows
// 0.0356 / 0.0366, 64-key (one block) 0.0394 / 0.0398; items of 64 query
// rows (blocks of four warps, K and V of a pair staged for each half) 0.0464
// / 0.0470, 0.0289 / 0.0293; 0.0139 / 0.0140, 0.0109 / 0.0111; 0.0069 /
// 0.0071, 0.0048 / 0.0049. At KEYS = 64: two blocks per SM 0.0146 /
// 0.0148, 0.0124 / 0.0125; rings of two or three stages 0.0144 / 0.0145,
// 0.0107 / 0.0113 and 0.0151 / 0.0152, 0.0109 / 0.0112; 16-key windows
// 0.0142 / 0.0143. Groups of two score n-tiles instead of four, and of two
// QE n-tiles at KEYS = 128, ran within 1%. The rings of stages and the
// 64-row items were not kept, and their code is gone. A body of its own,
// not attention_parts with one part: the roundings need q.k from a zero
// accumulator and the rounded QE added after it (attention_parts seeds
// each score accumulator with the relative term), its 16-bit QE slices and
// packed P are what fit two blocks, and f16 operands there would give
// device.cuh's split4, p_chunk and products, which v1 shares, a second
// 16-bit type. The chunked design keeps these instances past L = 128 and
// at D = 64, on the TF32 tensor cores.
//   f16 and bf16 run this body without the roundings (output<A> is the
// float32 sum) and keep their relative term in float32: rounding QE to f16
// or bf16, which F16_F16_F32 and BF16_BF16_F32 do not do, would fail their
// gate (a tenth of the plain version's distance from float32). So their QE
// slices hold float32 values, by 16-key windows at KEYS = 128 (rows
// kWarpWin + 8 = 40 floats apart), and each score accumulator is seeded
// with its relative term, as
// attention_parts seeds them: QE window by window into the slice, read back
// skewed into the scores, then q.k onto them by groups of four n-tiles, each
// group scaled and biased before the next (the bias of all 128 keys loaded
// at once held 32 registers, and the kernel spilled 8-24 bytes at 128). Two
// blocks fit at KEYS = 128 with the stage's rows unpadded: 111,616 bytes a
// block at D = 32, where a padded stage needs 117,760, 4,096 more than two
// blocks have. f16 measured at the flagship shape against the body above
// in turns (NVIDIA H100 80GB HBM3, 700 W; scripts/rel_attention_variants.py;
// ms at 64 x 128 rel, rel-off; 64 x 64 rel, rel-off; 15 x 64 rel, rel-off):
// this form 0.0352, 0.0249; 0.0138, 0.0111; 0.0063, 0.0051; the body above
// 0.0449, 0.0287; 0.0153, 0.0114; 0.0071, 0.0054 (f16f16 in the same run
// 0.0342, 0.0254; 0.0136, 0.0111; 0.0064, 0.0052). Tried: 32-key windows
// in rows of 48 floats (kWarpWin: what fits two blocks), rows 1 and 2 of
// every four swapped so that the skewed reads fall two to a bank, 0.0352,
// 0.0247; 0.0143, 0.0111 (rows of 80 at KEYS = 64); in order, four to a
// bank, 0.0387; 0.0151; one block per SM at KEYS = 128 (32-key windows, a
// padded stage) 0.0397, 0.0271; q.k one or two n-tiles at a time 0.0356,
// 0.0351 (rel, 64 x 128); each window's QE added after q.k's own sum, as
// f16f16 adds its rounded QE, spilled 24 bytes (0.0397 with 32-key windows),
// and so did the seeded form that scaled the scores after all of q.k. The
// swapped rows were not kept (no faster at 64 x 128, slower at 64 x 64),
// and their code is gone. bf16 runs the same form on bf16 planes and bf16
// mma (kF32Rel, m16n8k16 BF16; 128 registers, no spill, at D = 16 and 32):
// 0.0357, 0.0256; 0.0141, 0.0112; 0.0065, 0.0053 against the body above's
// 0.0464, 0.0313; 0.0162, 0.0123; 0.0075, 0.0056, and f16's 0.0358,
// 0.0255; 0.0141, 0.0112; 0.0064, 0.0053 in the same run (NVIDIA H100 80GB
// HBM3, 700.00 W; scripts/rel_attention_variants.py bf16-tf32-body).
//
// The f64 instance, resident (attention_f64; L <= 128 at D <= 32): the
// products on the FP64 tensor cores, mma.sync m16n8k16 with float64
// operands and accumulators (device.cuh's dmma), where the float64 FMA
// design read one 8-byte shared-memory operand per FMA (its pace: ~9.7 GB
// of shared-memory reads per flagship call with relative scores). One block
// of eight warps per SM walks the work items above:
//   - the table is widened to float64 once per block, K once per item into
//     rows D + 2 doubles apart, V transposed (a row per dimension of a
//     pair, KEYS + 8 doubles apart), so that no fragment load converts and
//     the 16-byte fragment loads of a quarter-warp fall on distinct banks;
//     q's chunks into registers once per item; one float32 stage, which the
//     next item's copies fill once it is widened;
//   - a chunk of 16 values of the contracted dimension is one m16n8k16:
//     lane t takes values 4t .. 4t + 3 of it (of D: one 16-byte vector of
//     q, K or the table; of p.v's keys the four its score accumulators hold,
//     2t, 2t + 1 of two n-tiles, so P is the A operand as it lies);
//   - q.k and q.E each from a zero float64 accumulator, rounded to float32
//     on its own (QE by 32-key windows into the warp's float32 slice, read
//     back skewed), then summed in float32: no accumulator is seeded with
//     the relative term, since one float64 sum of both is another rounding;
//     scale, bias and the exact row statistics in float32; P normalised,
//     widened exactly, p.v in float64, rounded to float32 once at the store.
// At KEYS = 128, D = 32 shared memory holds the table (69,632 bytes), K and
// V (69,632), the QE slices (28,672), the bias and the stage (56,320):
// 224,256 bytes; registers 227 (189 without relative scores), no spill.
// Measured at the flagship shape against the float64 FMA design in turns
// (NVIDIA H100 80GB HBM3, 700 W; scripts/kernel_times_two_trees.py): 0.4341
// -> 0.0693 ms with relative scores, 0.3011 -> 0.0462 without. The
// variants in turns (scripts/rel_attention_variants.py; ms with / without
// relative scores): m16n8k16 0.0697 / 0.0462, m16n8k8 0.0728 / 0.0465,
// m16n8k4 0.0793 / 0.0492; 16-key QE windows 0.0766 / 0.0457; K, V and the
// table held as float32 and widened at each fragment load 0.0729 / 0.0456
// (0.0157 against 0.0164 ms without relative scores at 64 x 64, its planes
// half the size). The m16n8k8, m16n8k4 and float32-plane forms were not
// kept, and their code is gone. A 64-key window does not fit beside the
// stage.
//
// Chunked tensor-core design, for L > 128 and at D = 64 (no shipped
// configuration): a
// block of four warps owns 64 query rows of one (b, h), a warp 16 of them,
// and walks the keys in chunks of 64, staging K, V, the bias and the 128
// table rows its rows reach per chunk with 16-byte cp.async; the relative
// term by an 80-row window per chunk as above; TF32 softmax online over
// chunks; bf16 and the multi-pass instances with a first pass over the keys
// that finds each row's maximum and sum, so that P is normalised before it
// is rounded or split. Its grid is B x H x ceil(L / 64) blocks.
//
// Rows, keys and table rows outside the tensors are zero-filled in shared
// memory, keys past L are scored -inf, and nothing is stored for rows past L
// or heads past H.
//
// Plain C interface for ctypes; the kernel launches on the caller's stream,
// on the given device, allocates nothing and does not synchronise. The
// return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device.cuh"
#include "launch.cuh"

namespace {

using namespace attn;

constexpr int kTile = 64;    // query rows per tile, and keys per chunk
constexpr int kUnit = 64;    // threads per head: 8 row groups x 8 key groups
constexpr int kHeads = 2;    // heads per block, one unit each
constexpr int kMicro = 8;    // rows (and keys) of a thread's score tile, 8 apart
constexpr int kWindow = 2 * kTile - 1;  // table rows a (tile, chunk) pair reads
constexpr int kPStride = kTile + 4;     // key-major probabilities, padded
constexpr float kLog2e = 1.4426950408889634f;

// Offsets (floats) into dynamic shared memory.
template <int D, bool HAS_REL>
struct Smem {
  static constexpr int kRow = D + 4;                     // padded q, K and table rows
  static constexpr int kQ = 0;                           // kHeads x kTile x kRow
  static constexpr int kV = kQ + kHeads * kTile * kRow;  // kHeads x kTile x D
  static constexpr int kBias = kV + kHeads * kTile * D;  // kTile
  static constexpr int kScale = kBias + kTile;           // kHeads x kTile: a chunk's rescale factors
  static constexpr int kMax = kScale + kHeads * kTile;   // kHeads x kTile: running row maxima
  static constexpr int kSum = kMax + kHeads * kTile;     // kHeads x kTile: softmax denominators
  static constexpr int kK = kSum + kHeads * kTile;       // kHeads x kTile x kRow, then P
  static constexpr int kE = kK + kHeads * kTile * kRow;  // kWindow x kRow, HAS_REL only
  static constexpr int kKE = kHeads * kTile * kRow + (HAS_REL ? kWindow * kRow : 0);
  static constexpr int kP = kHeads * kTile * kPStride;   // kHeads x kTile keys x kPStride
  static constexpr int kFloats = kK + (kKE > kP ? kKE : kP);
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* table;
  float* out;
  long long sb, sh, sl;  // batch, head and row strides of q, k and v, in floats
  int H, L, M, n_tiles, n_groups;
  int n_pairs, n_items;  // the resident tensor-core design's (b, h) pairs and work items
  float scale2;  // D^-1/2 * log2(e)
};

// Copies rows [r0, r0 + kTile) of one of q, k, v (`src`) for the block's kHeads
// heads into `dst` (rows `row` floats apart); rows past L and heads past H
// are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int row, const float* src, long long sb,
                                           long long sh, long long sl, int H, int L, int b,
                                           int h0, int r0) {
  constexpr int kVec = D / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int i = threadIdx.x; i < kHeads * kTile * kVec; i += kHeads * kUnit) {
    const int u = i / (kTile * kVec);
    const int r = (i / kVec) % kTile;
    const int c = i % kVec;
    const int h = h0 + u, l = r0 + r;
    float* d = dst + (u * kTile + r) * row + 4 * c;
    if (h < H && l < L) {
      cp_async16(d, src + b * sb + h * sh + l * sl + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = zero;
    }
  }
}

template <int D, bool HAS_REL>
__global__ void __launch_bounds__(kHeads * kUnit, D <= 32 ? 6 / kHeads : 1)
rel_attention_kernel(const Args a) {
  using S = Smem<D, HAS_REL>;
  constexpr int kRow = S::kRow;
  constexpr int kVec = D / 4;            // float4 pieces of a D-vector
  constexpr int kRowsPV = kVec;          // rows of a thread's output tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tile = blockIdx.x % a.n_tiles;
  const int group = (blockIdx.x / a.n_tiles) % a.n_groups;
  const int b = blockIdx.x / (a.n_tiles * a.n_groups);
  const int l0 = tile * kTile, h0 = group * kHeads;
  const int u = threadIdx.x / kUnit, tu = threadIdx.x % kUnit;
  const int rg = tu / kMicro, kg = tu % kMicro;    // score layout
  const int rgp = tu / kVec, dg = tu % kVec;       // p . v layout

  const float* qs = smem + S::kQ + u * kTile * kRow;
  const float* ks = smem + S::kK + u * kTile * kRow;
  const float* es = smem + S::kE;
  const float* vs = smem + S::kV + u * kTile * D;
  const float* bs = smem + S::kBias;
  float* ps = smem + S::kK + u * kTile * kPStride;  // over K and the window
  float* scale_s = smem + S::kScale + u * kTile;
  float* max_s = smem + S::kMax + u * kTile;
  float* sum_s = smem + S::kSum + u * kTile;

  float4 o[kRowsPV];
#pragma unroll
  for (int r = 0; r < kRowsPV; ++r) o[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < kHeads * kTile; i += kHeads * kUnit) {
    smem[S::kMax + i] = -INFINITY;
    smem[S::kSum + i] = 0.0f;
  }

  const int n_chunks = (a.L + kTile - 1) / kTile;
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * kTile;
    __syncthreads();  // the last chunk's reads of P, V and the rescale are done
    if (c == 0) {
      stage_rows<D>(smem + S::kQ, kRow, a.q, a.sb, a.sh, a.sl, a.H, a.L, b, h0, l0);
    }
    stage_rows<D>(smem + S::kK, kRow, a.k, a.sb, a.sh, a.sl, a.H, a.L, b, h0, j0);
    if (HAS_REL) {
      // window row x holds table row x - (kTile - 1) + l0 - j0 + M - 1
      const int e0 = l0 - j0 - (kTile - 1) + a.M - 1;
#pragma unroll 1
      for (int i = threadIdx.x; i < kWindow * kVec; i += kHeads * kUnit) {
        const int x = i / kVec, cc = i % kVec;
        const int e = e0 + x;
        float* d = smem + S::kE + x * kRow + 4 * cc;
        if (e >= 0 && e < 2 * a.M - 1) {
          cp_async16(d, a.table + static_cast<long long>(e) * D + 4 * cc);
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      float* d = smem + S::kBias + threadIdx.x;
      if (j < a.L) {
        cp_async4(d, a.bias + static_cast<long long>(b) * a.L + j);
      } else {
        *d = 0.0f;
      }
    }
    cp_async_commit();
    // V is waited for only before p . v: its copy overlaps the scores.
    stage_rows<D>(smem + S::kV, D, a.v, a.sb, a.sh, a.sl, a.H, a.L, b, h0, j0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // Scores of rows rg + 8 i x keys kg + 8 jj: q.k, then q.E along the 15 diagonals.
    float s[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) s[i][jj] = 0.0f;
    }
    // Not unrolled: unrolled, the loads of later steps are hoisted and registers spill.
#pragma unroll 1
    for (int d4 = 0; d4 < kVec; ++d4) {
      float4 qv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + kMicro * i) * kRow + 4 * d4);
      }
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (kg + kMicro * jj) * kRow + 4 * d4);
#pragma unroll
        for (int i = 0; i < kMicro; ++i) s[i][jj] = dot4(qv[i], kv, s[i][jj]);
      }
      if (HAS_REL) {
#pragma unroll
        for (int delta = -(kMicro - 1); delta < kMicro; ++delta) {  // delta = i - jj
          const int x = kTile - 1 + rg - kg + kMicro * delta;
          const float4 ev = *reinterpret_cast<const float4*>(es + x * kRow + 4 * d4);
#pragma unroll
          for (int i = 0; i < kMicro; ++i) {
            const int jj = i - delta;
            if (jj >= 0 && jj < kMicro) s[i][jj] = dot4(qv[i], ev, s[i][jj]);
          }
        }
      }
    }
    __syncthreads();  // K and the window are read: P overwrites them

    float bias2[kMicro];
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      const int j = kg + kMicro * jj;
      bias2[jj] = j0 + j < a.L ? bs[j] * kLog2e : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int row = rg + kMicro * i;
      const float m_old = max_s[row];  // read by the row's 8 lanes before lane 0 writes it
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        s[i][jj] = fmaf(s[i][jj], a.scale2, bias2[jj]);  // -inf past L
        m = fmaxf(m, s[i][jj]);
      }
      // the row's 64 keys lie on the 8 lanes kg = 0..7 of one quarter-warp
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      const float m_new = fmaxf(m_old, m);  // finite: chunk c has a key below L
      const float rescale = exp2f(m_old - m_new);  // 0 on the first chunk
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj) {
        const float p = exp2f(s[i][jj] - m_new);
        sum += p;
        ps[(kg + kMicro * jj) * kPStride + row] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (kg == 0) {
        max_s[row] = m_new;
        scale_s[row] = rescale;
        sum_s[row] = fmaf(sum_s[row], rescale, sum);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // p . v for rows rgp * kRowsPV + r, dimensions 4 dg .. 4 dg + 3.
#pragma unroll
    for (int r = 0; r < kRowsPV; r += 4) {
      const float4 f = *reinterpret_cast<const float4*>(scale_s + rgp * kRowsPV + r);
      const float fr[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        o[r + t].x *= fr[t];
        o[r + t].y *= fr[t];
        o[r + t].z *= fr[t];
        o[r + t].w *= fr[t];
      }
    }
    const int n_keys = min(kTile, a.L - j0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + 4 * dg);
      const float* pj = ps + j * kPStride + rgp * kRowsPV;
#pragma unroll
      for (int r = 0; r < kRowsPV; r += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pj + r);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          o[r + t].x = fmaf(pr[t], vv.x, o[r + t].x);
          o[r + t].y = fmaf(pr[t], vv.y, o[r + t].y);
          o[r + t].z = fmaf(pr[t], vv.z, o[r + t].z);
          o[r + t].w = fmaf(pr[t], vv.w, o[r + t].w);
        }
      }
    }
  }

  // The denominators were written before the last chunk's p . v began.
  const int h = h0 + u;
  if (h >= a.H) return;
#pragma unroll
  for (int r = 0; r < kRowsPV; ++r) {
    const int l = l0 + rgp * kRowsPV + r;
    if (l >= a.L) break;
    const float inv = 1.0f / sum_s[rgp * kRowsPV + r];
    float* dst = a.out + ((static_cast<long long>(b) * a.L + l) * a.H + h) * D + 4 * dg;
    *reinterpret_cast<float4*>(dst) = make_float4(o[r].x * inv, o[r].y * inv, o[r].z * inv, o[r].w * inv);
  }
}

template <int D, bool HAS_REL>
cudaError_t launch(Args a, int B, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const size_t smem = sizeof(float) * Smem<D, HAS_REL>::kFloats;
  const cudaError_t err = attn::opt_in_smem(
      reinterpret_cast<const void*>(&rel_attention_kernel<D, HAS_REL>), granted, device, smem);
  if (err != cudaSuccess) return err;
  a.n_groups = (a.H + kHeads - 1) / kHeads;
  const long long blocks = static_cast<long long>(B) * a.n_groups * a.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rel_attention_kernel<D, HAS_REL><<<static_cast<unsigned>(blocks), kHeads * kUnit, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- The chunked tensor-core design (L > 128 or D = 64) -------------------

namespace tc {

constexpr int kWarps = 4;                // warps per block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;       // query rows per block
constexpr int kKeys = 64;                // keys per chunk: 8 n-tiles of 8
constexpr int kWin = kRows + kKeys;      // table rows staged per chunk (127 reached)
constexpr int kWarpWin = 16 + kKeys;     // table rows a warp's QE spans (79 reached): 10 n-tiles
constexpr int kQEStride = kWarpWin + 8;  // 88 floats (24 mod 32): the float2 stores of QE fall on distinct banks

// Offsets (floats) into dynamic shared memory; every row D + 4 floats (4 mod 32).
template <int D, bool HAS_REL>
struct Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kQ = 0;                           // kRows x kRow
  static constexpr int kK = kQ + kRows * kRow;           // kKeys x kRow
  static constexpr int kV = kK + kKeys * kRow;           // kKeys x kRow
  static constexpr int kBias = kV + kKeys * kRow;        // kKeys
  static constexpr int kE = kBias + kKeys;               // kWin x kRow, HAS_REL only
  static constexpr int kQE = kE + (HAS_REL ? kWin * kRow : 0);  // kWarps x 16 x kQEStride, HAS_REL only
  static constexpr int kFloats = kQE + (HAS_REL ? kWarps * 16 * kQEStride : 0);
};

// Copies rows [r0, r0 + rows) of one head of q, k or v (`src` at the head's
// first float) into `dst`, rows D + 4 floats apart; rows past L are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long sl, int L, int r0,
                                           int rows) {
  constexpr int kVec = D / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    float* d = dst + r * (D + 4) + 4 * c;
    if (r0 + r < L) {
      cp_async16(d, src + (r0 + r) * sl + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <int D, bool HAS_REL, Arith A>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, HAS_REL>;
  constexpr int kRow = S::kRow;
  constexpr int kDT = D / 8;  // k-steps of q.k and q.E, n-tiles of p.v
  constexpr int kNT = kKeys / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tile = blockIdx.x % a.n_tiles;
  const int h = (blockIdx.x / a.n_tiles) % a.H;
  const int b = blockIdx.x / (a.n_tiles * a.H);
  const int l0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lw = l0 + 16 * warp;  // the warp's first query row
  const bool live = lw < a.L;     // warp-uniform: a warp wholly past L only stages
  const long long head = b * a.sb + h * a.sh;

  const float* qs = smem + S::kQ;
  const float* ks = smem + S::kK;
  const float* vs = smem + S::kV;
  const float* bs = smem + S::kBias;
  float* qe = smem + S::kQE + warp * 16 * kQEStride;

  uint32_t qf[kDT][4];  // the warp's q rows as A fragments (held values)
  float o[kDT][4];      // its output rows, as p.v's accumulators
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};

  const int n_chunks = (a.L + kKeys - 1) / kKeys;
  // every instance but TF32 rounds or splits the normalised P: with several
  // chunks, pass 0 finds each row's maximum and sum first
  constexpr bool kNormalised = A != Arith::TF32;
  const bool stats_pass = kNormalised && n_chunks > 1;
  for (int pass = stats_pass ? 0 : 1; pass < 2; ++pass) {
    for (int c = 0; c < n_chunks; ++c) {
      const int j0 = c * kKeys;
      const bool first = c == 0 && (pass == 0 || !stats_pass);
      __syncthreads();  // the last chunk's reads of K, V and the window are done
      if (first) stage_rows<D>(smem + S::kQ, a.q + head, a.sl, a.L, l0, kRows);
      stage_rows<D>(smem + S::kK, a.k + head, a.sl, a.L, j0, kKeys);
      if (HAS_REL) {
        // window row x holds table row x - (kKeys - 1) + l0 - j0 + M - 1
        const int e0 = l0 - j0 - (kKeys - 1) + a.M - 1;
#pragma unroll 1
        for (int i = threadIdx.x; i < kWin * (D / 4); i += kThreads) {
          const int x = i / (D / 4), cc = i % (D / 4);
          const int e = e0 + x;
          float* d = smem + S::kE + x * kRow + 4 * cc;
          if (e >= 0 && e < 2 * a.M - 1) {
            cp_async16(d, a.table + static_cast<long long>(e) * D + 4 * cc);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
      if (threadIdx.x < kKeys) {
        const int j = j0 + threadIdx.x;
        float* d = smem + S::kBias + threadIdx.x;
        if (j < a.L) {
          cp_async4(d, a.bias + static_cast<long long>(b) * a.L + j);
        } else {
          *d = 0.0f;
        }
      }
      cp_async_commit();
      // V is waited for only before p . v: its copy overlaps the scores
      if (pass == 1) stage_rows<D>(smem + S::kV, a.v + head, a.sl, a.L, j0, kKeys);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      float s[kNT][4];
      if (live) {
        if (first) {
#pragma unroll
          for (int kk = 0; kk < kDT; ++kk) {
            const float* q0 = qs + (16 * warp + g) * kRow + 8 * kk + t;
            qf[kk][0] = held<A>(q0[0]);
            qf[kk][1] = held<A>(q0[8 * kRow]);
            qf[kk][2] = held<A>(q0[4]);
            qf[kk][3] = held<A>(q0[8 * kRow + 4]);
          }
        }
        if (HAS_REL) {
          // QE = Q . E_win^T over window rows 16 warp + [0, 80), into the warp's slice
          const float* ew = smem + S::kE + (16 * warp) * kRow;
#pragma unroll
          for (int n = 0; n < kWarpWin / 8; ++n) {
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kk = 0; kk < kDT; ++kk) {
              const float* e = ew + (8 * n + g) * kRow + 8 * kk + t;
              mma<A>(acc, qf[kk], held<A>(e[0]), held<A>(e[4]));
            }
            float* d = qe + g * kQEStride + 8 * n + 2 * t;
            *reinterpret_cast<float2*>(d) = make_float2(output<A>(acc[0]), output<A>(acc[1]));
            *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(output<A>(acc[2]), output<A>(acc[3]));
          }
          __syncwarp();
        }
        // S = rel + Q . K^T (under kRoundsOutput Q . K^T rounded first, then
        // rel added); then scale and bias, in log2 units
        const auto rel = [&](int n, int i) {
          const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
          return HAS_REL ? qe[r * kQEStride + r - col + kKeys - 1] : 0.0f;
        };
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = kRoundsOutput<A> ? 0.0f : rel(n, i);
#pragma unroll
          for (int kk = 0; kk < kDT; ++kk) {
            const float* k0 = ks + (8 * n + g) * kRow + 8 * kk + t;
            mma<A>(s[n], qf[kk], held<A>(k0[0]), held<A>(k0[4]));
          }
          if constexpr (kRoundsOutput<A>) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = output<A>(s[n][i]) + rel(n, i);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t + e;
            const float bias2 = j0 + col < a.L ? bs[col] * kLog2e : -INFINITY;
            s[n][e] = fmaf(s[n][e], a.scale2, bias2);
            s[n][2 + e] = fmaf(s[n][2 + e], a.scale2, bias2);
          }
        }

        float rescale[2];
        if (!kNormalised) {
          fold(s, m, l, rescale);  // online: P unnormalised, the output rescaled
#pragma unroll
          for (int n = 0; n < kDT; ++n) {
            o[n][0] *= rescale[0];
            o[n][1] *= rescale[0];
            o[n][2] *= rescale[1];
            o[n][3] *= rescale[1];
          }
        } else if (pass == 0 || !stats_pass) {
          fold(s, m, l, rescale);  // the stats pass; or the only chunk, which holds every key
        } else {
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = exp2f(s[n][i] - m[i / 2]);
          }
        }
        if (kNormalised && pass == 1) {
          if (c == 0) {
            inv[0] = 1.0f / quad_sum(l[0]);
            inv[1] = 1.0f / quad_sum(l[1]);
          }
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] *= inv[i / 2];
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      if (live && pass == 1) {
        // p . v: key n-tile n as one k-step, its keys in the order 2t, 2t + 1
        // (lane t's a0/a1 and a2/a3 columns) for P and V alike
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint32_t pa[4] = {held<A>(s[n][0]), held<A>(s[n][2]), held<A>(s[n][1]), held<A>(s[n][3])};
          const float* v0 = vs + (8 * n + 2 * t) * kRow + g;
#pragma unroll
          for (int dn = 0; dn < kDT; ++dn) {
            mma<A>(o[dn], pa, held<A>(v0[8 * dn]), held<A>(v0[kRow + 8 * dn]));
          }
        }
      }
    }
  }

  if (!live) return;
  if (!kNormalised) {
    inv[0] = 1.0f / quad_sum(l[0]);
    inv[1] = 1.0f / quad_sum(l[1]);
  } else {
    inv[0] = inv[1] = 1.0f;  // P was normalised
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lw + g + 8 * i;
    if (row >= a.L) continue;
    float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) {
      *reinterpret_cast<float2*>(dst + 8 * dn) =
          make_float2(output<A>(o[dn][2 * i] * inv[i]), output<A>(o[dn][2 * i + 1] * inv[i]));
    }
  }
}

}  // namespace tc

// ---- The resident tensor-core design (L <= 128; the note at the top) -------

namespace rs {

constexpr int kWarps = 8;                  // warps per block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;         // rows of each of q, k and v in a stage
constexpr int kMaxL = kRows;               // the longest sequence: one pair fills a stage
constexpr int kWindowLong = 16;            // keys per QE window at KEYS = 128 (two blocks per SM)
constexpr int kWindowShort = 64;           // and at KEYS = 64 (one block per SM)
constexpr int kStagesLong = 1;             // the ring's depth at KEYS = 128: two blocks per SM
constexpr int kStagesShort = 3;            // and at KEYS = 64, or with TF32x3's parts: one block per SM
constexpr int kWindowParts = 64;           // keys per QE window of the bf16 multi-pass instances at KEYS = 128
constexpr bool kTableResident = true;      // the table staged once per block, else once per item
constexpr int kSmemBytes = 232448;         // the most shared memory a block may have
constexpr int kSmemPerSM = 233472;         // an SM's shared memory; each block also takes 1 KB of it

// Offsets (floats) into dynamic shared memory of the TF32 instance and
// TF32x3 at L <= 64 (ONE_BLOCK: one block per SM, kOneBlock);
// every row D + 4 floats (4 mod 32).
template <int D, bool HAS_REL, int KEYS, bool ONE_BLOCK>
struct Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kWindow = KEYS == kMaxL ? kWindowLong : kWindowShort;  // keys per QE window
  static constexpr int kWarpWin = 16 + kWindow;  // table rows a warp's window spans (kWarpWin - 1 reached)
  static constexpr int kQEStride = kWarpWin + 8;  // 40 or 88 floats (8 or 24 mod 32): the float2 stores of QE
                                                  // fall on distinct banks
  static constexpr int kTable = 0;                                      // 2 KEYS x kRow, HAS_REL only
  static constexpr int kQE = kTable + (HAS_REL ? 2 * KEYS * kRow : 0);  // kWarps x 16 x kQEStride, HAS_REL only
  static constexpr int kRing = kQE + (HAS_REL ? kWarps * 16 * kQEStride : 0);
  static constexpr int kOperands = 3 * kRows * kRow;                    // Q, K and V, kRows x kRow each
  static constexpr int kStage = kOperands + kRows;                      // then the bias, KEYS per pair
  static constexpr int kFit = (kSmemBytes / 4 - kRing) / kStage;        // stages that fit
  static constexpr int kMaxStages = KEYS == kMaxL && !ONE_BLOCK ? kStagesLong : kStagesShort;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kFloats = kRing + kStages * kStage;
  // blocks per SM: two where they fit, at D = 32 (at D = 16 ptxas spilled at
  // their 128 registers), and one for TF32x3's parts
  static constexpr int kBlocks = !ONE_BLOCK && D == 32 && 2 * (4 * kFloats + 1024) <= kSmemPerSM ? 2 : 1;
  static_assert(kStages >= 1, "a stage must fit");
};

// Issues the copies of the table rows that the warps' QE windows reach:
// shared row x holds offset l - j = x - KEYS + 1, table row x - KEYS + M,
// zeros outside the table.
template <int D, int KEYS>
__device__ __forceinline__ void stage_table(float* dst, const Args& a) {
  constexpr int kVec = D / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * KEYS * kVec; i += kThreads) {
    const int x = i / kVec, c = i % kVec;
    const int e = x - KEYS + a.M;
    float* d = dst + x * (D + 4) + 4 * c;
    if (e >= 0 && e < 2 * a.M - 1) {
      cp_async16(d, a.table + static_cast<long long>(e) * D + 4 * c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Issues the copies of an item's q, k and v rows into a stage: rows [0, L)
// of the item's pair p at rows p * KEYS of each tensor's block, ROW floats
// apart, 16 bytes a thread, consecutive threads on consecutive pieces of a
// row; and the pair's bias at p * KEYS of the bias block.
template <int D, int KEYS, int ROW = D + 4>
__device__ __forceinline__ void stage_item(float* st, const Args& a, int item) {
  constexpr int kVec = D / 4;
#pragma unroll
  for (int p = 0; p < kRows / KEYS; ++p) {
    const int pair = item * (kRows / KEYS) + p;
    if (pair >= a.n_pairs) break;
    const long long head = (pair / a.H) * a.sb + (pair % a.H) * a.sh;
#pragma unroll 1
    for (int i = threadIdx.x; i < a.L * kVec; i += kThreads) {
      const int l = i / kVec, c = i % kVec;
      const long long src = head + l * a.sl + 4 * c;
      float* d = st + (p * KEYS + l) * ROW + 4 * c;
      cp_async16(d, a.q + src);
      cp_async16(d + kRows * ROW, a.k + src);
      cp_async16(d + 2 * kRows * ROW, a.v + src);
    }
    const float* bias = a.bias + static_cast<long long>(pair / a.H) * a.L;
#pragma unroll 1
    for (int j = threadIdx.x; j < a.L; j += kThreads) cp_async4(st + 3 * kRows * ROW + p * KEYS + j, bias + j);
  }
}

// Rounds n floats of shared memory (a multiple of 4, 16-byte aligned) in
// place to the operands the tensor cores read: each staged value once,
// rather than at every fragment load.
template <Arith A>
__device__ __forceinline__ void round_operands(float* p, int n) {
  const auto r = [](float x) { return __uint_as_float(operand_of<A>(x)); };
#pragma unroll 4
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    float4 x = reinterpret_cast<float4*>(p)[i];
    x = make_float4(r(x.x), r(x.y), r(x.z), r(x.w));
    reinterpret_cast<float4*>(p)[i] = x;
  }
}

// The B fragments of two k-steps (2 kk2, 2 kk2 + 1) of an n-tile whose 8 rows
// of D + 4 floats start at `rows`: r = {b0, b1} of the first, then of the second.
template <int D>
__device__ __forceinline__ void b_fragments(uint32_t (&r)[4], const float* rows, int kk2) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, rows + (lane % 8) * (D + 4) + 16 * kk2 + 4 * (lane / 8));
}

// TF32x3's B chunk kk2 (every part) of an n-tile whose 8 rows of D + 4
// floats start at `rows`: b_fragments' words split as loaded.
template <Arith A, int D>
__device__ __forceinline__ void split_rows(uint32_t (&b)[kParts<A>][4], const float* rows, int kk2) {
  uint32_t w[4];
  b_fragments<D>(w, rows, kk2);
  split4<A>(b, __uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]), __uint_as_float(w[3]));
}

// One block per SM (255 registers) for a multi-pass instance (TF32x3 at
// L <= 64 is the one that runs this body). The instances that round each
// dot's output ran here at one block per SM too (at two blocks' 128
// registers the rounded q.k and the relative term held apart spilled at
// KEYS = 128); they run attention_half, whose 16-bit operands fit two.
template <Arith A>
constexpr bool kOneBlock = kParts<A> > 1;

// The n-tiles of n whose products interleave in a group (device.cuh's
// products): the largest divisor of n whose B chunks of every part fit
// `words` registers (kGroupWords in the planes of parts, kX3GroupWords in
// TF32x3's split at the load), and at least 2.
constexpr int kGroupWords = 24;
constexpr int kX3GroupWords = 48;
template <Arith A>
__host__ __device__ constexpr int group_of(int n, int words = kGroupWords) {
  int g = 2;
  for (int d = 3; d <= n; ++d) {
    if (n % d == 0 && d * kParts<A> * 2 * kSteps<A> <= words) g = d;
  }
  return g;
}

// TF32x3 at L <= 64 (attention): each fragment of K, the table and V split
// into its parts once, as it is loaded from the float32 stage, q's parts once
// per item, the products of groups of n-tiles interleaved (device.cuh's
// products); else every operand split at each mma (device.cuh's mma_split).
template <Arith A>
constexpr bool kSplitAtLoad = kParts<A> > 1;

// KEYS (64 or 128, at least L): the keys of a pair, and its rows in a stage.
// Shared memory holds the TF32 instance's operands rounded, what
// a fragment load reads; TF32x3's float32 values, split as loaded
// (kSplitAtLoad) where planes of parts (kSplitOnce) lost.
template <int D, bool HAS_REL, Arith A, int KEYS>
__device__ __forceinline__ void attention(const Args& a) {
  constexpr bool kSplit = kParts<A> > 1;
  using S = Smem<D, HAS_REL, KEYS, kOneBlock<A>>;
  constexpr int kRow = S::kRow;
  constexpr int kStages = S::kStages;
  constexpr int kDT = D / 8;                // k-steps of q.k and q.E, n-tiles of p.v
  constexpr int kNT = KEYS / 8;             // key n-tiles of a row's scores
  constexpr int kPairs = kRows / KEYS;      // pairs per item
  constexpr int kWpp = KEYS / 16;           // warps per pair
  constexpr int kWindow = S::kWindow, kWarpWin = S::kWarpWin, kQEStride = S::kQEStride;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ring = smem + S::kRing;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;

  // K and V rows [L, KEYS) of every slot enter the mma: zeros, which no copy
  // overwrites
  const int pad = KEYS - a.L;
#pragma unroll 1
  for (int i = threadIdx.x; i < kStages * 2 * kPairs * pad * D; i += kThreads) {
    int r = i / D;
    const int l = a.L + r % pad;
    r /= pad;
    const int p = r % kPairs;
    r /= kPairs;
    ring[(r / 2) * S::kStage + ((1 + r % 2) * kRows + p * KEYS + l) * kRow + i % D] = 0.0f;
  }
  // the table (with the first item), then the ring's first kStages - 1 items, a copy group each
  float* table = smem + S::kTable;
  if (HAS_REL && kTableResident) stage_table<D, KEYS>(table, a);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    const int item = blockIdx.x + j * gridDim.x;
    if (item < a.n_items) stage_item<D, KEYS>(ring + j * S::kStage, a, item);
    cp_async_commit();
  }

  const int slot = warp / kWpp, lw = 16 * (warp % kWpp);  // the warp's pair slot and first row in it
  float* qe = smem + S::kQE + warp * 16 * kQEStride;
  int it = 0;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x, ++it) {
    const int stage = it % kStages;
    float* st = ring + stage * S::kStage;
    __syncthreads();  // every warp is done with the last item: its stage (refilled now) and the table
    const int ahead = item + (kStages - 1) * gridDim.x;
    if (ahead < a.n_items) stage_item<D, KEYS>(ring + (it + kStages - 1) % kStages * S::kStage, a, ahead);
    if (HAS_REL && !kTableResident) stage_table<D, KEYS>(table, a);
    cp_async_commit();
    if (HAS_REL && !kTableResident) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<kStages - 1>();  // this item's copies have landed (the later kStages - 1 may not)
    }
    __syncthreads();
    if constexpr (!kSplit) {
      round_operands<A>(st, S::kOperands);
      if (HAS_REL && (it == 0 || !kTableResident)) round_operands<A>(table, 2 * KEYS * kRow);
      __syncthreads();
    }

    const int pair = item * kPairs + slot;
    if (pair >= a.n_pairs || lw >= a.L) continue;  // warp-uniform: nothing to compute
    const int b = pair / a.H, h = pair % a.H;
    const float* qs = st + slot * KEYS * kRow;
    const float* ks = qs + kRows * kRow;
    const float* vs = qs + 2 * kRows * kRow;
    const float* bs = st + S::kOperands + slot * KEYS;
    float o[kDT][4];  // the warp's output rows, as p.v's accumulators
    {
      uint32_t qf[kDT][4];  // the warp's q rows as A fragments (held values)
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        const float* q0 = qs + (lw + g) * kRow + 8 * kk + t;
        qf[kk][0] = __float_as_uint(q0[0]);
        qf[kk][1] = __float_as_uint(q0[8 * kRow]);
        qf[kk][2] = __float_as_uint(q0[4]);
        qf[kk][3] = __float_as_uint(q0[8 * kRow + 4]);
      }
      uint32_t qa[kSplitAtLoad<A> ? kDT / 2 : 1][kParts<A>][4 * kSteps<A>];  // TF32x3: qf's parts
      if constexpr (kSplitAtLoad<A>) split_fragments<A, kDT / 2>(qa, qf);
      float s[kNT][4];  // the warp's 16 x KEYS scores, then P
#pragma unroll
      for (int c = 0; c < KEYS / kWindow; ++c) {
        if (HAS_REL) {
          // QE = Q . E_win^T over the kWarpWin resident table rows that the
          // warp's rows reach in keys [kWindow c, kWindow (c + 1)), into the
          // warp's slice
          const float* ew = table + (lw - kWindow * c - kWindow + KEYS) * kRow;
          if constexpr (kSplitAtLoad<A>) {
            // TF32x3: groups of n-tiles, each B fragment split as loaded
            constexpr int kG = group_of<A>(kWarpWin / 8, kX3GroupWords);
#pragma unroll
            for (int n0 = 0; n0 < kWarpWin / 8; n0 += kG) {
              float acc[kG][4] = {};
              products<A, kG, kDT / 2>(acc, HeldChunks<A, kDT / 2>{qa},
                                       [&](int kc, int n, uint32_t (&b)[kParts<A>][4]) {
                                         split_rows<A, D>(b, ew + 8 * (n0 + n) * kRow, kc);
                                       });
#pragma unroll
              for (int n = 0; n < kG; ++n) {
                float* d = qe + g * kQEStride + 8 * (n0 + n) + 2 * t;
                *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
                *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(acc[n][2], acc[n][3]);
              }
              __syncwarp();  // group by group; QE written before it is read
            }
          } else {
#pragma unroll
            for (int n = 0; n < kWarpWin / 8; ++n) {
              float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int kk2 = 0; kk2 < kDT / 2; ++kk2) {
                uint32_t e[4];
                b_fragments<D>(e, ew + 8 * n * kRow, kk2);
                mma_split<A>(acc, qf[2 * kk2], e[0], e[1]);
                mma_split<A>(acc, qf[2 * kk2 + 1], e[2], e[3]);
              }
              float* d = qe + g * kQEStride + 8 * n + 2 * t;
              *reinterpret_cast<float2*>(d) = make_float2(output<A>(acc[0]), output<A>(acc[1]));
              *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(output<A>(acc[2]), output<A>(acc[3]));
              __syncwarp();  // n-tile by n-tile (see below); QE written before it is read
            }
          }
        }
        // S = rel + Q . K^T (under kRoundsOutput Q . K^T rounded first, then
        // rel added); then scale and bias, in log2 units
        const auto rel = [&](int n, int i) {
          const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
          return HAS_REL ? qe[r * kQEStride + r - col + kWindow - 1] : 0.0f;
        };
        if constexpr (kSplitAtLoad<A>) {
          // TF32x3: groups of n-tiles from their relative term, each B
          // fragment of K split as loaded
          constexpr int kG = group_of<A>(kWindow / 8, kX3GroupWords);
#pragma unroll
          for (int n0 = 0; n0 < kWindow / 8; n0 += kG) {
            const int nt0 = kWindow / 8 * c + n0;
#pragma unroll
            for (int n = 0; n < kG; ++n) {
#pragma unroll
              for (int i = 0; i < 4; ++i) s[nt0 + n][i] = rel(n0 + n, i);
            }
            products<A, kG, kDT / 2>(&s[nt0], HeldChunks<A, kDT / 2>{qa},
                                     [&](int kc, int n, uint32_t (&b)[kParts<A>][4]) {
                                       split_rows<A, D>(b, ks + 8 * (nt0 + n) * kRow, kc);
                                     });
#pragma unroll
            for (int n = 0; n < kG; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * (nt0 + n) + 2 * t + e;
                const float bias2 = col < a.L ? bs[col] * kLog2e : -INFINITY;
                s[nt0 + n][e] = fmaf(s[nt0 + n][e], a.scale2, bias2);
                s[nt0 + n][2 + e] = fmaf(s[nt0 + n][2 + e], a.scale2, bias2);
              }
            }
            __syncwarp();  // group by group; the window is read before the next one overwrites it
          }
        } else {
#pragma unroll
          for (int n = 0; n < kWindow / 8; ++n) {
            const int nt = kWindow / 8 * c + n;
#pragma unroll
            for (int i = 0; i < 4; ++i) s[nt][i] = kRoundsOutput<A> ? 0.0f : rel(n, i);
#pragma unroll
            for (int kk2 = 0; kk2 < kDT / 2; ++kk2) {
              uint32_t k[4];
              b_fragments<D>(k, ks + 8 * nt * kRow, kk2);
              mma_split<A>(s[nt], qf[2 * kk2], k[0], k[1]);
              mma_split<A>(s[nt], qf[2 * kk2 + 1], k[2], k[3]);
            }
            if constexpr (kRoundsOutput<A>) {
#pragma unroll
              for (int i = 0; i < 4; ++i) s[nt][i] = output<A>(s[nt][i]) + rel(n, i);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * nt + 2 * t + e;
              const float bias2 = col < a.L ? bs[col] * kLog2e : -INFINITY;
              s[nt][e] = fmaf(s[nt][e], a.scale2, bias2);
              s[nt][2 + e] = fmaf(s[nt][2 + e], a.scale2, bias2);
            }
            // n-tile by n-tile: shared loads do not cross __syncwarp, so ptxas
            // does not issue every fragment load of the unrolled loops first
            // (it spilled at 128 registers; a fence every two or four n-tiles
            // ran 5% slower); and the window is read before the next one
            // overwrites it
            __syncwarp();
          }
        }
      }

      // Softmax over the whole row at once: exact maxima and sums
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = exp2f(s[n][i] - mx[i / 2]);
          sum[i / 2] += s[n][i];
        }
      }
      // P normalised, then rounded or split as p.v's operand: JAX's einsum
      // takes the softmax's output as its operand
      const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= inv[i / 2];
      }

      // p . v: key n-tile n as one k-step, its keys in the order 2t, 2t + 1
      // (lane t's a0/a1 and a2/a3 columns) for P and V alike
#pragma unroll
      for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
      if constexpr (kSplitAtLoad<A>) {
        // TF32x3 by 16 keys: P's parts from two n-tiles' accumulators
        // (p_chunk), V's rows 2t, 2t + 1, 8 + 2t, 9 + 2t of them split as
        // loaded, the kDT accumulators' products interleaved
#pragma unroll
        for (int kc = 0; kc < KEYS / 16; ++kc) {
          uint32_t pa[1][kParts<A>][4 * kSteps<A>];
          p_chunk<A>(pa, s[2 * kc], s[2 * kc + 1]);
          const float* v0 = vs + (16 * kc + 2 * t) * kRow + g;
          products<A, kDT, 1>(o, HeldChunks<A, 1>{pa}, [&](int, int dn, uint32_t (&b)[kParts<A>][4]) {
            const float* w = v0 + 8 * dn;
            split4<A>(b, w[0], w[kRow], w[8 * kRow], w[9 * kRow]);
          });
          __syncwarp();  // 16 keys by 16
        }
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint32_t pa[4] = {held<A>(s[n][0]), held<A>(s[n][2]), held<A>(s[n][1]), held<A>(s[n][3])};
          const float* v0 = vs + (8 * n + 2 * t) * kRow + g;
#pragma unroll
          for (int dn = 0; dn < kDT; ++dn) {
            mma_split<A>(o[dn], pa, __float_as_uint(v0[8 * dn]), __float_as_uint(v0[kRow + 8 * dn]));
          }
          __syncwarp();  // n-tile by n-tile
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lw + g + 8 * i;
      if (row >= a.L) continue;
      float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(output<A>(o[dn][2 * i]), output<A>(o[dn][2 * i + 1]));
      }
    }
  }
}

// ---- The resident design's multi-pass instances: planes of parts ----------

// The multi-pass instances that split each operand once into planes of
// parts (attention_parts): all but TF32x3 at L <= 64, whose planes ran
// 5-10% slower there without relative scores (PERF.md §6) than splitting at
// each mma; it runs attention, split at the load (kSplitAtLoad).
template <Arith A, int KEYS>
constexpr bool kSplitOnce = kParts<A> > 1 && !(A == Arith::TF32x3 && KEYS < kMaxL);

// Shared memory of a multi-pass instance (byte offsets): the parts of the
// resident table, K and V as planes of rows (bf16 parts D + 8 values apart,
// TF32 parts D + 4 words: ldmatrix's eight rows fall on distinct banks), the
// QE slices, the bias of the item in use, and one float32 stage of q, k, v
// and the bias, which the next item's copies fill while this item computes
// (a second stage, where it fits, ran no faster).
template <int D, bool HAS_REL, Arith A, int KEYS>
struct PartsSmem {
  static constexpr int kWindow = KEYS == kMaxL ? (kBF16Parts<A> ? kWindowParts : kWindowLong) : kWindowShort;
  static constexpr int kWarpWin = 16 + kWindow;   // table rows a warp's window spans (kWarpWin - 1 reached)
  static constexpr int kQEStride = kWarpWin + 8;  // floats (8 or 24 mod 32), as Smem's
  static constexpr int kRowBytes = kBF16Parts<A> ? 2 * (D + 8) : 4 * (D + 4);  // a plane's row
  static constexpr int kTablePlane = 2 * KEYS * kRowBytes;
  static constexpr int kPlane = kRows * kRowBytes;                              // K's or V's
  static constexpr int kTable = 0;                                              // HAS_REL only
  static constexpr int kK = kTable + (HAS_REL ? kParts<A> * kTablePlane : 0);
  static constexpr int kV = kK + kParts<A> * kPlane;
  static constexpr int kQE = kV + kParts<A> * kPlane;                         // HAS_REL only
  static constexpr int kBias = kQE + (HAS_REL ? 4 * kWarps * 16 * kQEStride : 0);  // kRows floats
  static constexpr int kStage = kBias + 4 * kRows;                              // stage_item's layout
  static constexpr int kBytes = kStage + 4 * (3 * kRows * (D + 4) + kRows);
  static_assert(kBytes <= kSmemBytes && kStage % 16 == 0, "one block of planes and a stage");
};

// Splits the four floats u of row r, columns 4 c4 .. 4 c4 + 3, into the
// kParts planes at dst (plane_bytes apart, rows ROW bytes apart).
template <Arith A, int ROW>
__device__ __forceinline__ void split_into(char* dst, int plane_bytes, int r, int c4, float4 u) {
  uint32_t w[kParts<A>][2 * kSteps<A>];
  split4<A>(w, u.x, u.y, u.z, u.w);
#pragma unroll
  for (int i = 0; i < kParts<A>; ++i) {
    char* d = dst + i * plane_bytes + r * ROW;
    if constexpr (kBF16Parts<A>) {
      *reinterpret_cast<uint2*>(d + 8 * c4) = make_uint2(w[i][0], w[i][1]);
    } else {
      *reinterpret_cast<uint4*>(d + 16 * c4) = make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
    }
  }
}

// M (2 or 4) consecutive 8 x 8 b16 matrices of the 8 plane rows at `rows`
// (ROW bytes apart), by ldmatrix: lane (g, t) receives word t of row g of
// matrix m in r[m]. From a chunk's first matrix, they are its B chunk: bf16
// b0, b1 (columns 2t, 2t + 1 and 8 + 2t, 9 + 2t); TF32 b0, b1 of each k-step.
template <int M, int ROW>
__device__ __forceinline__ void load_rows(uint32_t (&r)[M], const char* rows) {
  const int lane = threadIdx.x % 32;
  const char* row = rows + (lane % 8) * ROW + 16 * (lane / 8 % M);
  if constexpr (M == 2) {
    ldmatrix_x2<false>(r, row);
  } else {
    static_assert(M == 4, "a chunk is 2 (bf16) or 4 (TF32) matrices");
    ldmatrix_x4(r, reinterpret_cast<const float*>(row));
  }
}

// c[n] += Q . B[n]^T for the G n-tiles whose 8 plane rows start at row0 + 8 n
// of the planes at `planes` (plane_bytes apart): each B chunk of every part
// loaded as it was split, once.
template <int D, Arith A, int G, int ROW>
__device__ __forceinline__ void plane_products(float (*c)[4], const uint32_t (&qa)[D / 16][kParts<A>][4 * kSteps<A>],
                                               const char* planes, int plane_bytes, int row0) {
  products<A, G, D / 16>(c, HeldChunks<A, D / 16>{qa}, [&](int kc, int n, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
#pragma unroll
    for (int i = 0; i < kParts<A>; ++i) {
      load_rows<2 * kSteps<A>, ROW>(b[i], planes + i * plane_bytes + (row0 + 8 * n) * ROW + 32 * kSteps<A> * kc);
    }
  });
  // group by group: shared loads do not cross __syncwarp, so ptxas does not
  // issue the next groups' fragment loads first (unfenced, it spilled)
  __syncwarp();
}

// The multi-pass instances (TF32x3, bf16x3, bf16x6, bf16x9) of the resident
// design, split once (device.cuh's split4, products): the table's parts once
// per block, K's and V's once per item, into planes; the warp's q rows into
// registers once per item; P's once per 16 keys. Every product runs over
// groups of n-tiles whose accumulators interleave.
template <int D, bool HAS_REL, Arith A, int KEYS>
__device__ __forceinline__ void attention_parts(const Args& a) {
  using S = PartsSmem<D, HAS_REL, A, KEYS>;
  constexpr int kP = kParts<A>, kSt = kSteps<A>, kKC = D / 16, kRow = S::kRowBytes;
  constexpr int kNT = KEYS / 8;              // key n-tiles of a row's scores
  constexpr int kDT = D / 8;                 // n-tiles of p.v
  constexpr int kPairs = kRows / KEYS;       // pairs per item
  constexpr int kWpp = KEYS / 16;            // warps per pair
  constexpr int kWindow = S::kWindow, kQEStride = S::kQEStride;
  constexpr int kQET = S::kWarpWin / 8;      // QE n-tiles per window
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* stage = reinterpret_cast<float*>(smem + S::kStage);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;

  // K and V rows [L, KEYS) of every slot enter the mma: zeros in the stage,
  // which no copy overwrites, split to zeros
  const int pad = KEYS - a.L;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * kPairs * pad * D; i += kThreads) {
    int r = i / D;
    const int l = a.L + r % pad;
    r /= pad;
    stage[((1 + r / kPairs) * kRows + (r % kPairs) * KEYS + l) * (D + 4) + i % D] = 0.0f;
  }
  if (blockIdx.x < a.n_items) stage_item<D, KEYS>(stage, a, blockIdx.x);
  cp_async_commit();
  if (HAS_REL) {
    // the table's parts, once per block: plane row x holds offset l - j =
    // x - KEYS + 1, table row x - KEYS + M, zeros outside the table
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * KEYS * (D / 4); i += kThreads) {
      const int x = i / (D / 4), c4 = i % (D / 4), e = x - KEYS + a.M;
      const float4 u = e >= 0 && e < 2 * a.M - 1
                           ? __ldg(reinterpret_cast<const float4*>(a.table + static_cast<long long>(e) * D) + c4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      split_into<A, kRow>(smem + S::kTable, S::kTablePlane, x, c4, u);
    }
  }

  const int slot = warp / kWpp, lw = 16 * (warp % kWpp);  // the warp's pair slot and first row in it
  float* qe = reinterpret_cast<float*>(smem + S::kQE) + warp * 16 * kQEStride;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // the item's copies have landed; every warp is done with the last item's planes
    // K's and V's parts, once per item
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * kRows * (D / 4); i += kThreads) {
      const int v = i / (kRows * (D / 4)), r = i / (D / 4) % kRows, c4 = i % (D / 4);
      const float4 u = *reinterpret_cast<const float4*>(stage + ((1 + v) * kRows + r) * (D + 4) + 4 * c4);
      split_into<A, kRow>(smem + (v ? S::kV : S::kK), S::kPlane, r, c4, u);
    }
    for (int j = threadIdx.x; j < kRows; j += kThreads) bias_s[j] = stage[3 * kRows * (D + 4) + j];
    const int pair = item * kPairs + slot;
    const bool work = pair < a.n_pairs && lw < a.L;  // warp-uniform
    // the warp's q rows as A chunks of parts, once per item: k = 2t, 2t + 1,
    // 2t + 8, 2t + 9 of chunk kc (bf16) or t, t + 4 of each k-step (TF32)
    uint32_t qa[kKC][kP][4 * kSt];
    if (work) {
      const float* q0 = stage + (slot * KEYS + lw + g) * (D + 4);
      const float* q1 = q0 + 8 * (D + 4);
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t lo[kP][2 * kSt], hi[kP][2 * kSt];
        const int c = 16 * kc;
        if constexpr (kBF16Parts<A>) {
          split4<A>(lo, q0[c + 2 * t], q0[c + 2 * t + 1], q1[c + 2 * t], q1[c + 2 * t + 1]);
          split4<A>(hi, q0[c + 8 + 2 * t], q0[c + 9 + 2 * t], q1[c + 8 + 2 * t], q1[c + 9 + 2 * t]);
        } else {
          split4<A>(lo, q0[c + t], q1[c + t], q0[c + t + 4], q1[c + t + 4]);
          split4<A>(hi, q0[c + 8 + t], q1[c + 8 + t], q0[c + 12 + t], q1[c + 12 + t]);
        }
#pragma unroll
        for (int i = 0; i < kP; ++i) {
#pragma unroll
          for (int w = 0; w < 2 * kSt; ++w) qa[kc][i][w] = lo[i][w], qa[kc][i][2 * kSt + w] = hi[i][w];
        }
      }
    }
    __syncthreads();  // the planes are written and the stage is read: the next item's copies may land
    if (item + gridDim.x < a.n_items) stage_item<D, KEYS>(stage, a, item + gridDim.x);
    cp_async_commit();
    if (!work) continue;
    const int b = pair / a.H, h = pair % a.H;
    const char* kplanes = smem + S::kK + slot * KEYS * kRow;
    const char* vplanes = smem + S::kV + slot * KEYS * kRow;
    const float* bs = bias_s + slot * KEYS;

    float s[kNT][4];  // the warp's 16 x KEYS scores, then P
    if (HAS_REL) {
#pragma unroll
      for (int c = 0; c < KEYS / kWindow; ++c) {
        // QE = Q . E_win^T over the kWarpWin table rows that the warp's rows
        // reach in keys [kWindow c, kWindow (c + 1)), into the warp's slice
        const int row0 = lw - kWindow * c - kWindow + KEYS;
        constexpr int kG = group_of<A>(kQET);
#pragma unroll
        for (int n0 = 0; n0 < kQET; n0 += kG) {
          float acc[kG][4];
#pragma unroll
          for (int n = 0; n < kG; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
          plane_products<D, A, kG, kRow>(acc, qa, smem + S::kTable, S::kTablePlane, row0 + 8 * n0);
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            float* d = qe + g * kQEStride + 8 * (n0 + n) + 2 * t;
            *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
            *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(acc[n][2], acc[n][3]);
          }
        }
        __syncwarp();  // QE written before it is read
        // rel[r, col] = QE[r, r - col + kWindow - 1]: the first value of each score accumulator
#pragma unroll
        for (int n = 0; n < kWindow / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
            s[kWindow / 8 * c + n][i] = qe[r * kQEStride + r - col + kWindow - 1];
          }
        }
        __syncwarp();  // the window is read before the next one overwrites it
      }
    } else {
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
    }
    // S = rel + Q . K^T, then scale and bias, in log2 units
    constexpr int kG = group_of<A>(kNT);
#pragma unroll
    for (int n0 = 0; n0 < kNT; n0 += kG) plane_products<D, A, kG, kRow>(&s[n0], qa, kplanes, S::kPlane, 8 * n0);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        const float bias2 = col < a.L ? bs[col] * kLog2e : -INFINITY;
        s[n][e] = fmaf(s[n][e], a.scale2, bias2);
        s[n][2 + e] = fmaf(s[n][2 + e], a.scale2, bias2);
      }
    }

    // Softmax over the whole row at once: exact maxima and sums
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i / 2]);
        sum[i / 2] += s[n][i];
      }
    }
    // P normalised, then split as p.v's operand: JAX's einsum takes the
    // softmax's output as its operand
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= inv[i / 2];
    }

    // p . v by 16 keys: P's parts from two n-tiles' accumulators (p_chunk),
    // V's B chunks of every part and output n-tile as split, the kDT
    // accumulators' products interleaved
    float o[kDT][4];
#pragma unroll
    for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KEYS / 16; ++kc) {
      uint32_t pa[1][kP][4 * kSt];
      p_chunk<A>(pa, s[2 * kc], s[2 * kc + 1]);
      products<A, kDT, 1>(o, HeldChunks<A, 1>{pa}, [&](int, int dn, uint32_t (&vb)[kP][2 * kSt]) {
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const char* plane = vplanes + i * S::kPlane;
          if constexpr (kBF16Parts<A>) {
            // keys 16 kc + 8 (m & 1) + lane % 8 of output columns 8 dn ..,
            // transposed: b0, b1 of n-tile dn
            const int lane = threadIdx.x % 32;
            ldmatrix_x2<true>(vb[i], plane + (16 * kc + 8 * (lane / 8 % 2) + lane % 8) * kRow + 16 * dn);
          } else {
            // rows 2t, 2t + 1, 8 + 2t, 9 + 2t of the 16 keys, column 8 dn + g
            const uint32_t* w = reinterpret_cast<const uint32_t*>(plane) + (16 * kc + 2 * t) * (D + 4) + 8 * dn + g;
            vb[i][0] = w[0], vb[i][1] = w[D + 4], vb[i][2] = w[8 * (D + 4)], vb[i][3] = w[9 * (D + 4)];
          }
        }
      });
      __syncwarp();  // 16 keys by 16 (see plane_products)
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lw + g + 8 * i;
      if (row >= a.L) continue;
      float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
      }
    }
  }
}

// ---- The resident design's 16-bit instances: 16-bit planes ----------------

// The 16-bit instances (bf16, f16, f16f16, bf16bf16) run attention_half in
// the resident design (the note at the top); bf16 and f16, which round no
// dot's output, keep their relative term in float32 (kF32Rel).
template <Arith A>
constexpr bool kHalfBody = kRoundsOutput<A> || A == Arith::F16 || A == Arith::BF16;
template <Arith A>
constexpr bool kF32Rel = !kRoundsOutput<A>;

constexpr int kHalfBlocksLong = 2;     // blocks per SM at KEYS = 128 (128 registers a thread)
constexpr int kHalfBlocksShort = 1;    // and at KEYS = 64
constexpr int kHalfWindowLong = 32;    // keys per QE window at KEYS = 128
constexpr int kHalfWindowShort = 64;   // and at KEYS = 64
constexpr int kHalfWindowF32 = 16;     // and f16's at KEYS = 128 (float32 QE slices)
constexpr int kHalfGroup = 4;          // the most n-tiles whose mma interleave
constexpr int kHalfGroupLongRel = 1;   // and in QE and the scores with relative scores at KEYS = 128

// The largest divisor of n up to `most`: the n-tiles of n whose mma
// interleave (their accumulators live at once).
__host__ __device__ constexpr int group_upto(int n, int most) {
  int best = 1;
  for (int d = 2; d <= most && d <= n; ++d) best = n % d == 0 ? d : best;
  return best;
}

// Shared memory of attention_half (byte offsets): 16-bit planes of the
// resident table (HAS_REL), K and V of the item (rows D + 8 values apart:
// ldmatrix's eight rows fall on distinct banks), the warps' QE slices, the
// bias of the item in use, and one float32 stage (stage_item's layout, rows
// kSRow floats apart), which the next item's copies fill while this one
// computes. The QE slices hold 16-bit values where each QE is rounded to A's
// type, else (F32_REL) float32 values, by 16-key windows at KEYS = 128, and
// the stage's rows are then not padded: two blocks' shared memory at
// KEYS = 128 (111,616 bytes a block at D = 32).
template <int D, bool HAS_REL, int KEYS, bool F32_REL>
struct HalfSmem {
  static constexpr bool kF32QE = HAS_REL && F32_REL;
  static constexpr int kWindow =  // keys per QE window
      KEYS != kMaxL ? kHalfWindowShort : kF32QE ? kHalfWindowF32 : kHalfWindowLong;
  static constexpr int kWarpWin = 16 + kWindow;   // table rows a warp's window spans (kWarpWin - 1 reached)
  static constexpr int kQEStride = kWarpWin + 8;  // values (16-bit: 28 or 44 words; float32: 40 or 88): the
                                                  // 4- or 8-byte stores of QE fall on distinct banks
  static constexpr int kSRow = kF32QE ? D : D + 4;  // a stage's row (floats)
  static constexpr int kRowBytes = 2 * (D + 8);   // a plane's row
  static constexpr int kTable = 0;                                             // 2 KEYS rows, HAS_REL only
  static constexpr int kK = kTable + (HAS_REL ? 2 * KEYS * kRowBytes : 0);
  static constexpr int kV = kK + kRows * kRowBytes;
  static constexpr int kQE = kV + kRows * kRowBytes;                           // HAS_REL only
  static constexpr int kBias = kQE + (HAS_REL ? (kF32QE ? 4 : 2) * kWarps * 16 * kQEStride : 0);  // kRows floats
  static constexpr int kStage = kBias + 4 * kRows;
  static constexpr int kBytes = kStage + 4 * (3 * kRows * kSRow + kRows);
  static constexpr int kBlocks = KEYS == kMaxL ? kHalfBlocksLong : kHalfBlocksShort;  // per SM
  // n-tiles whose mma interleave in QE and in the scores
  static constexpr int kGroupRel = KEYS == kMaxL ? kHalfGroupLongRel : kHalfGroup;
  static_assert(kBlocks * (kBytes + 1024) <= kSmemPerSM && kStage % 16 == 0, "kBlocks blocks of planes and a stage");
};

// c[n] += Q . B[n]^T over D for G n-tiles whose 8 plane rows (ROW bytes
// apart) start at rows + 8 n ROW: qa the warp's q rows as A chunks of 16
// values; each n-tile's B chunks by one ldmatrix (x4 at D = 32: both
// chunks); the G accumulators' mma interleave.
template <int D, Arith A, int G, int ROW>
__device__ __forceinline__ void half_products(float (*c)[4], const uint32_t (&qa)[D / 16][4], const char* rows) {
  static_assert(D == 16 || D == 32, "the resident design's head sizes");
  const int lane = threadIdx.x % 32;
  uint32_t b[G][D / 8];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    const char* row = rows + (8 * n + lane % 8) * ROW + 16 * (lane / 8 % (D / 8));
    if constexpr (D == 32) {
      ldmatrix_x4(b[n], reinterpret_cast<const float*>(row));
    } else {
      ldmatrix_x2<false>(b[n], row);
    }
  }
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int n = 0; n < G; ++n) mma16<A>(c[n], qa[kc], b[n][2 * kc], b[n][2 * kc + 1]);
  }
}

// A score in log2 units: x scaled, plus key col's bias (-inf past L).
__device__ __forceinline__ float scored(float x, const Args& a, const float* bs, int col) {
  const float bias2 = col < a.L ? bs[col] * kLog2e : -INFINITY;
  return fmaf(x, a.scale2, bias2);
}

// The 16-bit instances (bf16, f16, f16f16, bf16bf16) of the resident
// design: the table rounded to A's type once per block, K and V once per
// item, into planes; the warp's q rows into registers once per item; every
// product one m16n8k16 on the f16 or bf16 tensor cores. f16f16 and
// bf16bf16: q.k and q.E each from a zero accumulator, rounded to A's type
// on its own, then summed in float32; bf16 and f16: q.k onto score
// accumulators seeded with the float32 QE (their slices hold float32
// values). Scale, bias and the exact row
// statistics in float32; P normalised, then rounded; p.v's output as the
// instance leaves it (device.cuh's output) at the store.
template <int D, bool HAS_REL, Arith A, int KEYS>
__device__ __forceinline__ void attention_half(const Args& a) {
  using S = HalfSmem<D, HAS_REL, KEYS, kF32Rel<A>>;
  constexpr int kRow = S::kRowBytes, kSRow = S::kSRow;  // a plane's row (bytes) and a stage's (floats)
  constexpr int kNT = KEYS / 8;                      // key n-tiles of a row's scores
  constexpr int kDT = D / 8;                         // n-tiles of p.v
  constexpr int kKC = D / 16;                        // chunks of q.k and q.E
  constexpr int kPairs = kRows / KEYS;               // pairs per item
  constexpr int kWpp = KEYS / 16;                    // warps per pair
  constexpr int kWindow = S::kWindow, kQEStride = S::kQEStride;
  constexpr int kQET = S::kWarpWin / 8;              // QE n-tiles per window
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* stage = reinterpret_cast<float*>(smem + S::kStage);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // K and V rows [L, KEYS) of every slot enter the mma: zeros in the stage,
  // which no copy overwrites, rounded to zeros
  const int pad = KEYS - a.L;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * kPairs * pad * D; i += kThreads) {
    int r = i / D;
    const int l = a.L + r % pad;
    r /= pad;
    stage[((1 + r / kPairs) * kRows + (r % kPairs) * KEYS + l) * kSRow + i % D] = 0.0f;
  }
  if (blockIdx.x < a.n_items) stage_item<D, KEYS, kSRow>(stage, a, blockIdx.x);
  cp_async_commit();
  if (HAS_REL) {
    // the table, once per block: plane row x holds offset l - j =
    // x - KEYS + 1, table row x - KEYS + M, zeros outside the table
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * KEYS * (D / 4); i += kThreads) {
      const int x = i / (D / 4), c4 = i % (D / 4), e = x - KEYS + a.M;
      const float4 u = e >= 0 && e < 2 * a.M - 1
                           ? __ldg(reinterpret_cast<const float4*>(a.table + static_cast<long long>(e) * D) + c4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<uint2*>(smem + S::kTable + x * kRow + 8 * c4) =
          make_uint2(pack16<A>(u.x, u.y), pack16<A>(u.z, u.w));
    }
  }

  const int slot = warp / kWpp, lw = 16 * (warp % kWpp);  // the warp's pair slot and first row in it
  uint32_t* qe_w = reinterpret_cast<uint32_t*>(smem + S::kQE) + warp * 8 * kQEStride;  // the warp's QE slice
  const unsigned short* qe = reinterpret_cast<const unsigned short*>(qe_w);
  float* qe_f = reinterpret_cast<float*>(smem + S::kQE) + warp * 16 * kQEStride;  // the same, F32_REL
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // the item's copies have landed; every warp is done with the last item's planes
    // K's and V's planes, once per item
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * kRows * (D / 4); i += kThreads) {
      const int v = i / (kRows * (D / 4)), r = i / (D / 4) % kRows, c4 = i % (D / 4);
      const float4 u = *reinterpret_cast<const float4*>(stage + ((1 + v) * kRows + r) * kSRow + 4 * c4);
      *reinterpret_cast<uint2*>(smem + (v ? S::kV : S::kK) + r * kRow + 8 * c4) =
          make_uint2(pack16<A>(u.x, u.y), pack16<A>(u.z, u.w));
    }
    for (int j = threadIdx.x; j < kRows; j += kThreads) bias_s[j] = stage[3 * kRows * kSRow + j];
    const int pair = item * kPairs + slot;
    const bool work = pair < a.n_pairs && lw < a.L;  // warp-uniform
    // the warp's q rows as A chunks, once per item: rows g, g + 8, columns
    // 2t, 2t + 1 and 2t + 8, 2t + 9 of chunk kc
    uint32_t qa[kKC][4];
    if (work) {
      const float* q0 = stage + (slot * KEYS + lw + g) * kSRow + 2 * t;
      const float* q1 = q0 + 8 * kSRow;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const float2 x0 = *reinterpret_cast<const float2*>(q0 + 16 * kc);
        const float2 x1 = *reinterpret_cast<const float2*>(q1 + 16 * kc);
        const float2 y0 = *reinterpret_cast<const float2*>(q0 + 16 * kc + 8);
        const float2 y1 = *reinterpret_cast<const float2*>(q1 + 16 * kc + 8);
        qa[kc][0] = pack16<A>(x0.x, x0.y);
        qa[kc][1] = pack16<A>(x1.x, x1.y);
        qa[kc][2] = pack16<A>(y0.x, y0.y);
        qa[kc][3] = pack16<A>(y1.x, y1.y);
      }
    }
    __syncthreads();  // the planes are written and the stage is read: the next item's copies may land
    if (item + gridDim.x < a.n_items) stage_item<D, KEYS, kSRow>(stage, a, item + gridDim.x);
    cp_async_commit();
    if (!work) continue;
    const int b = pair / a.H, h = pair % a.H;
    const char* kp = smem + S::kK + slot * KEYS * kRow;
    const char* vp = smem + S::kV + slot * KEYS * kRow;
    const float* bs = bias_s + slot * KEYS;

    float s[kNT][4];  // the warp's 16 x KEYS scores
    if constexpr (S::kF32QE) {
      // S = rel + Q . K^T in float32 (bf16, f16: no dot's output rounded),
      // each score accumulator seeded with its relative term, then scale
      // and bias, in log2 units
#pragma unroll
      for (int c = 0; c < KEYS / kWindow; ++c) {
        // QE = Q . E_win^T over the kWarpWin table rows that the warp's rows
        // reach in keys [kWindow c, kWindow (c + 1)), into the warp's slice
        const char* ew = smem + S::kTable + (lw - kWindow * c - kWindow + KEYS) * kRow;
        constexpr int kGQ = group_upto(kQET, S::kGroupRel);
#pragma unroll
        for (int n0 = 0; n0 < kQET; n0 += kGQ) {
          float acc[kGQ][4] = {};
          half_products<D, A, kGQ, kRow>(acc, qa, ew + 8 * n0 * kRow);
#pragma unroll
          for (int n = 0; n < kGQ; ++n) {
            float* d = qe_f + g * kQEStride + 8 * (n0 + n) + 2 * t;
            *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
            *reinterpret_cast<float2*>(d + 8 * kQEStride) = make_float2(acc[n][2], acc[n][3]);
          }
          __syncwarp();  // group by group: ptxas does not issue the next groups' loads first
        }
        // rel[r, col] = QE[r, r - col + kWindow - 1], the window's scores' first values
#pragma unroll
        for (int n = 0; n < kWindow / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
            s[kWindow / 8 * c + n][i] = qe_f[r * kQEStride + r - col + kWindow - 1];
          }
        }
        __syncwarp();  // the window is read before the next one overwrites it
      }
      constexpr int kGK = group_upto(kNT, kHalfGroup);
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kGK) {
        half_products<D, A, kGK, kRow>(&s[n0], qa, kp + 8 * n0 * kRow);
#pragma unroll
        for (int n = n0; n < n0 + kGK; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = scored(s[n][i], a, bs, 8 * n + 2 * t + i % 2);
        }
        // group by group: ptxas does not issue the next groups' loads first, the
        // bias's either (all of them at once held 32 registers and spilled)
        __syncwarp();
      }
    } else if constexpr (HAS_REL) {
      // S = round(Q . K^T) + round(Q . E) in float32, then scale and bias, in log2 units
#pragma unroll
      for (int c = 0; c < KEYS / kWindow; ++c) {
        // QE = Q . E_win^T over the kWarpWin table rows that the warp's rows
        // reach in keys [kWindow c, kWindow (c + 1)), each rounded to A's
        // type, into the warp's slice
        const char* ew = smem + S::kTable + (lw - kWindow * c - kWindow + KEYS) * kRow;
        constexpr int kGQ = group_upto(kQET, S::kGroupRel);
#pragma unroll
        for (int n0 = 0; n0 < kQET; n0 += kGQ) {
          float acc[kGQ][4] = {};
          half_products<D, A, kGQ, kRow>(acc, qa, ew + 8 * n0 * kRow);
#pragma unroll
          for (int n = 0; n < kGQ; ++n) {
            uint32_t* d = qe_w + (g * kQEStride + 8 * (n0 + n) + 2 * t) / 2;
            d[0] = pack16<A>(acc[n][0], acc[n][1]);
            d[4 * kQEStride] = pack16<A>(acc[n][2], acc[n][3]);
          }
          __syncwarp();  // group by group: ptxas does not issue the next groups' loads first
        }
        // the window's scores: q.k rounded, then rel[r, col] = QE[r, r - col + kWindow - 1] added
        constexpr int kGK = group_upto(kWindow / 8, S::kGroupRel);
#pragma unroll
        for (int n0 = 0; n0 < kWindow / 8; n0 += kGK) {
          float acc[kGK][4] = {};
          half_products<D, A, kGK, kRow>(acc, qa, kp + 8 * (kWindow / 8 * c + n0) * kRow);
#pragma unroll
          for (int n = 0; n < kGK; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = g + 8 * (i / 2), col = 8 * (n0 + n) + 2 * t + i % 2, nt = kWindow / 8 * c + n0 + n;
              const float rel = unpack16<A>(qe[r * kQEStride + r - col + kWindow - 1]);
              s[nt][i] = scored(output<A>(acc[n][i]) + rel, a, bs, 8 * nt + 2 * t + i % 2);
            }
          }
          __syncwarp();  // group by group; the window is read before the next one overwrites it
        }
      }
    } else {
      constexpr int kGK = group_upto(kNT, kHalfGroup);
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kGK) {
        float acc[kGK][4] = {};
        half_products<D, A, kGK, kRow>(acc, qa, kp + 8 * n0 * kRow);
#pragma unroll
        for (int n = 0; n < kGK; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n0 + n][i] = scored(output<A>(acc[n][i]), a, bs, 8 * (n0 + n) + 2 * t + i % 2);
        }
        __syncwarp();  // group by group
      }
    }

    // Softmax over the whole row at once: exact maxima and sums
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i / 2]);
        sum[i / 2] += s[n][i];
      }
    }
    // P normalised, then rounded to A's type as p.v's operand (JAX's einsum
    // takes the softmax's output as its operand): rows g and g + 8 of n-tile
    // n at keys 2t, 2t + 1, an m16n8k16 A fragment's words as they lie
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
    uint32_t pp[kNT][2];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      pp[n][0] = pack16<A>(s[n][0] * inv[0], s[n][1] * inv[0]);
      pp[n][1] = pack16<A>(s[n][2] * inv[1], s[n][3] * inv[1]);
    }

    // p . v by 16 keys: V's B fragments of two output n-tiles by one
    // ldmatrix.x4.trans (keys 16 kc + 8 (m & 1) + lane % 8 of columns
    // 8 (dn + m / 2) ..), the kDT accumulators' mma interleaved
    float o[kDT][4] = {};
    const char* vrow = vp + (8 * (lane / 8 % 2) + lane % 8) * kRow + 16 * (lane / 16);
#pragma unroll
    for (int kc = 0; kc < KEYS / 16; ++kc) {
      const uint32_t pa[4] = {pp[2 * kc][0], pp[2 * kc][1], pp[2 * kc + 1][0], pp[2 * kc + 1][1]};
#pragma unroll
      for (int dn = 0; dn < kDT; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + 16 * kc * kRow + 16 * dn);
        mma16<A>(o[dn], pa, vb[0], vb[1]);
        mma16<A>(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lw + g + 8 * i;
      if (row >= a.L) continue;
      float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(output<A>(o[dn][2 * i]), output<A>(o[dn][2 * i + 1]));
      }
    }
  }
}

// ---- The resident design's f64 instance: float64 products on DMMA -----------

constexpr int kWindowF64 = 32;  // keys per QE window at KEYS = 128
constexpr int kGroupF64 = 4;    // the most n-tiles whose mma interleave (their accumulators live at once)

// Shared memory of the f64 instance (byte offsets): the resident table, K
// and V of the item as planes of doubles, the QE slices, the bias of the
// item in use, and one float32 stage (stage_item's layout) that the next
// item's copies fill while this item computes. K's and the table's rows are
// kRowK values apart, so that the 16-byte loads of a quarter-warp (rows g,
// g + 1, values 16 c + 4t ..) fall on distinct banks; V is transposed, a row
// per dimension per pair, kRowV = KEYS + 8 values apart, so that its
// 2-value loads (keys 16 kc + 2t ..) of rows g .. do too.
template <int D, bool HAS_REL, int KEYS>
struct F64Smem {
  static constexpr int kWindow = KEYS == kMaxL ? kWindowF64 : kWindowShort;
  static constexpr int kWarpWin = 16 + kWindow;   // table rows a warp's window spans (kWarpWin - 1 reached)
  static constexpr int kQEStride = kWarpWin + 8;  // floats (8 or 24 mod 32), as Smem's
  static constexpr int kRowK = D + 2;
  static constexpr int kRowV = KEYS + 8;
  static constexpr int kTable = 0;                                               // HAS_REL only
  static constexpr int kK = kTable + (HAS_REL ? 8 * 2 * KEYS * kRowK : 0);
  static constexpr int kV = kK + 8 * kRows * kRowK;
  static constexpr int kQE = kV + 8 * (kRows / KEYS) * D * kRowV;                // HAS_REL only
  static constexpr int kBias = kQE + (HAS_REL ? 4 * kWarps * 16 * kQEStride : 0);  // kRows floats
  static constexpr int kStage = kBias + 4 * kRows;
  static constexpr int kBytes = kStage + 4 * (3 * kRows * (D + 4) + kRows);
  static_assert(kBytes <= kSmemBytes && kK % 16 == 0 && kV % 16 == 0 && kQE % 16 == 0 && kStage % 16 == 0,
                "one block of planes and a stage");
};

// c[n] += Q . B[n]^T over D for G n-tiles: qa q's chunks (rows g, g + 8,
// values 16 kc + 4t ..), B's rows the plane rows rows + (8 n + g) ROW; the G
// accumulators' mma interleave.
template <int D, int G, int ROW>
__device__ __forceinline__ void dmma_rows(double (*c)[4], const double (&qa)[D / 16][2][4], const double* rows) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    double b[G][4];
#pragma unroll
    for (int n = 0; n < G; ++n) f64::load4(b[n], rows + (8 * n + g) * ROW + 16 * kc + 4 * t);
#pragma unroll
    for (int n = 0; n < G; ++n) f64::dmma_chunk(c[n], qa[kc][0], qa[kc][1], b[n]);
  }
}

// The f64 instance (F64_F64_F64) of the resident design, on the FP64 tensor
// cores: q.k and q.E each a float64 product rounded to float32 on its own,
// then summed in float32 (no accumulator is seeded with the relative term:
// one float64 sum of both would be another rounding); scale, bias and
// softmax in float32 over the whole row at once; P normalised, widened
// exactly, and p.v in float64, rounded to float32 once at the store. The
// table is widened once per block, K and V once per item, q into registers
// once per item (the note at the top).
template <int D, bool HAS_REL, int KEYS>
__device__ __forceinline__ void attention_f64(const Args& a) {
  using S = F64Smem<D, HAS_REL, KEYS>;
  constexpr int kRowK = S::kRowK, kRowV = S::kRowV;
  constexpr int kNT = KEYS / 8;              // key n-tiles of a row's scores
  constexpr int kDT = D / 8;                 // n-tiles of p.v
  constexpr int kKC = D / 16;                // chunks of q.k and q.E
  constexpr int kPairs = kRows / KEYS;       // pairs per item
  constexpr int kWpp = KEYS / 16;            // warps per pair
  constexpr int kWindow = S::kWindow, kQEStride = S::kQEStride;
  constexpr int kQET = S::kWarpWin / 8;      // QE n-tiles per window
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  double* table = reinterpret_cast<double*>(smem + S::kTable);
  double* kplane = reinterpret_cast<double*>(smem + S::kK);
  double* vplane = reinterpret_cast<double*>(smem + S::kV);
  float* stage = reinterpret_cast<float*>(smem + S::kStage);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;

  // K and V rows [L, KEYS) of every slot enter the mma: zeros in the stage,
  // which no copy overwrites, widened to zeros
  const int pad = KEYS - a.L;
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * kPairs * pad * D; i += kThreads) {
    int r = i / D;
    const int l = a.L + r % pad;
    r /= pad;
    stage[((1 + r / kPairs) * kRows + (r % kPairs) * KEYS + l) * (D + 4) + i % D] = 0.0f;
  }
  if (blockIdx.x < a.n_items) stage_item<D, KEYS>(stage, a, blockIdx.x);
  cp_async_commit();
  if (HAS_REL) {
    // the table, once per block: row x holds offset l - j = x - KEYS + 1,
    // table row x - KEYS + M, zeros outside the table
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * KEYS * (D / 4); i += kThreads) {
      const int x = i / (D / 4), c4 = i % (D / 4), e = x - KEYS + a.M;
      const float4 u = e >= 0 && e < 2 * a.M - 1
                           ? __ldg(reinterpret_cast<const float4*>(a.table + static_cast<long long>(e) * D) + c4)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      f64::store4(table + x * kRowK + 4 * c4, u);
    }
  }

  const int slot = warp / kWpp, lw = 16 * (warp % kWpp);  // the warp's pair slot and first row in it
  float* qe = reinterpret_cast<float*>(smem + S::kQE) + warp * 16 * kQEStride;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // the item's copies have landed; every warp is done with the last item's planes
    // K as rows, once per item
#pragma unroll 1
    for (int i = threadIdx.x; i < kRows * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      f64::store4(kplane + r * kRowK + 4 * c4, *reinterpret_cast<const float4*>(stage + (kRows + r) * (D + 4) + 4 * c4));
    }
    // V transposed, once per item: consecutive threads on consecutive keys
#pragma unroll 1
    for (int i = threadIdx.x; i < kRows * (D / 4); i += kThreads) {
      const int r = i % kRows, c4 = i / kRows;
      const float4 u = *reinterpret_cast<const float4*>(stage + (2 * kRows + r) * (D + 4) + 4 * c4);
      double* d = vplane + ((r / KEYS) * D + 4 * c4) * kRowV + r % KEYS;
      d[0] = u.x, d[kRowV] = u.y, d[2 * kRowV] = u.z, d[3 * kRowV] = u.w;
    }
    for (int j = threadIdx.x; j < kRows; j += kThreads) bias_s[j] = stage[3 * kRows * (D + 4) + j];
    const int pair = item * kPairs + slot;
    const bool work = pair < a.n_pairs && lw < a.L;  // warp-uniform
    // the warp's q rows g and g + 8 as float64 A chunks, once per item
    double qa[kKC][2][4];
    if (work) {
      const float* q0 = stage + (slot * KEYS + lw + g) * (D + 4) + 4 * t;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        f64::load4(qa[kc][0], q0 + 16 * kc);
        f64::load4(qa[kc][1], q0 + 8 * (D + 4) + 16 * kc);
      }
    }
    __syncthreads();  // the planes are written and the stage is read: the next item's copies may land
    if (item + gridDim.x < a.n_items) stage_item<D, KEYS>(stage, a, item + gridDim.x);
    cp_async_commit();
    if (!work) continue;
    const int b = pair / a.H, h = pair % a.H;
    const double* ks = kplane + slot * KEYS * kRowK;
    const double* vt = vplane + slot * D * kRowV;
    const float* bs = bias_s + slot * KEYS;

    float s[kNT][4];  // the warp's 16 x KEYS scores, then P
    if (HAS_REL) {
#pragma unroll
      for (int c = 0; c < KEYS / kWindow; ++c) {
        // QE = Q . E_win^T over the kWarpWin table rows that the warp's rows
        // reach in keys [kWindow c, kWindow (c + 1)), each rounded to float32,
        // into the warp's slice
        const double* ew = table + (lw - kWindow * c - kWindow + KEYS) * kRowK;
        constexpr int kG = group_upto(kQET, kGroupF64);
#pragma unroll
        for (int n0 = 0; n0 < kQET; n0 += kG) {
          double acc[kG][4] = {};
          dmma_rows<D, kG, kRowK>(acc, qa, ew + 8 * n0 * kRowK);
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            float* d = qe + g * kQEStride + 8 * (n0 + n) + 2 * t;
            *reinterpret_cast<float2*>(d) = make_float2(static_cast<float>(acc[n][0]), static_cast<float>(acc[n][1]));
            *reinterpret_cast<float2*>(d + 8 * kQEStride) =
                make_float2(static_cast<float>(acc[n][2]), static_cast<float>(acc[n][3]));
          }
          __syncwarp();  // group by group: ptxas does not issue the next groups' loads first
        }
        // rel[r, col] = QE[r, r - col + kWindow - 1]
#pragma unroll
        for (int n = 0; n < kWindow / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = g + 8 * (i / 2), col = 8 * n + 2 * t + i % 2;
            s[kWindow / 8 * c + n][i] = qe[r * kQEStride + r - col + kWindow - 1];
          }
        }
        __syncwarp();  // the window is read before the next one overwrites it
      }
    }
    // S = round(Q . K^T) + rel in float32, then scale and bias, in log2 units
    constexpr int kG = group_upto(kNT, kGroupF64);
#pragma unroll
    for (int n0 = 0; n0 < kNT; n0 += kG) {
      double acc[kG][4] = {};
      dmma_rows<D, kG, kRowK>(acc, qa, ks + 8 * n0 * kRowK);
#pragma unroll
      for (int n = 0; n < kG; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * (n0 + n) + 2 * t + i % 2;
          const float x = HAS_REL ? static_cast<float>(acc[n][i]) + s[n0 + n][i] : static_cast<float>(acc[n][i]);
          s[n0 + n][i] = col < a.L ? fmaf(x, a.scale2, bs[col] * kLog2e) : -INFINITY;
        }
      }
      __syncwarp();  // group by group
    }

    // Softmax over the whole row at once: exact maxima and sums
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i / 2]);
        sum[i / 2] += s[n][i];
      }
    }
    // P normalised in float32, then widened exactly: the einsum's operand is
    // the softmax's output
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= inv[i / 2];
    }

    // p . v by 16 keys: P of rows g and g + 8 at keys 2t, 2t + 1 of n-tiles
    // 2 kc and 2 kc + 1 as they lie, V^T's rows 8 dn + g at the same keys;
    // the kDT accumulators' mma interleave
    double o[kDT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KEYS / 16; ++kc) {
      const float p0[4] = {s[2 * kc][0], s[2 * kc][1], s[2 * kc + 1][0], s[2 * kc + 1][1]};
      const float p8[4] = {s[2 * kc][2], s[2 * kc][3], s[2 * kc + 1][2], s[2 * kc + 1][3]};
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        double bv[4];
        const double* vr = vt + (8 * dn + g) * kRowV + 16 * kc + 2 * t;
        f64::load2(bv, vr);
        f64::load2(bv + 2, vr + 8);
        f64::dmma_chunk(o[dn], p0, p8, bv);
      }
      __syncwarp();  // 16 keys by 16
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lw + g + 8 * i;
      if (row >= a.L) continue;
      float* dst = a.out + ((static_cast<long long>(b) * a.L + row) * a.H + h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        *reinterpret_cast<float2*>(dst + 8 * dn) =
            make_float2(static_cast<float>(o[dn][2 * i]), static_cast<float>(o[dn][2 * i + 1]));
      }
    }
  }
}

}  // namespace rs

// KEYS 64 or 128: the resident design for L <= KEYS, one block of eight
// warps per SM (two at D = 32 for TF32, and at KEYS = 128 for the 16-bit
// instances); KEYS 0: the chunked one, three
// blocks of four warps per SM (two at D = 64).
template <int KEYS>
constexpr int kTcThreads = KEYS ? rs::kThreads : tc::kThreads;
template <int D, bool HAS_REL, int KEYS, Arith A>
constexpr int tc_blocks() {
  if constexpr (!KEYS) {
    return D <= 32 ? 3 : 2;
  } else if constexpr (rs::kHalfBody<A>) {
    return rs::HalfSmem<D, HAS_REL, KEYS, rs::kF32Rel<A>>::kBlocks;
  } else if constexpr (rs::kSplitOnce<A, KEYS>) {
    return 1;
  } else {
    return rs::Smem<D, HAS_REL, KEYS, rs::kOneBlock<A>>::kBlocks;
  }
}
template <int D, bool HAS_REL, int KEYS, Arith A>
constexpr int kTcBlocks = tc_blocks<D, HAS_REL, KEYS, A>();

template <int D, bool HAS_REL, Arith A, int KEYS>
__device__ __forceinline__ void tc_attention(const Args& a) {
  if constexpr (KEYS > 0 && rs::kHalfBody<A>) {
    rs::attention_half<D, HAS_REL, A, KEYS>(a);
  } else if constexpr (KEYS > 0 && rs::kSplitOnce<A, KEYS>) {
    rs::attention_parts<D, HAS_REL, A, KEYS>(a);
  } else if constexpr (KEYS > 0) {
    rs::attention<D, HAS_REL, A, KEYS>(a);
  } else {
    tc::attention<D, HAS_REL, A>(a);
  }
}

// One __global__ function per arithmetic, named as ops/attention.py's
// CudaLibrary.kernel_name names the instance.
template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::TF32>)
rel_attention_tf32_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::TF32, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::BF16>)
rel_attention_bf16_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::BF16, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::TF32x3>)
rel_attention_tf32x3_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::TF32x3, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::BF16x3>)
rel_attention_bf16x3_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::BF16x3, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::BF16x6>)
rel_attention_bf16x6_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::BF16x6, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::BF16x9>)
rel_attention_bf16x9_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::BF16x9, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::F16>)
rel_attention_f16_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::F16, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::F16F16>)
rel_attention_f16f16_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::F16F16, KEYS>(a);
}

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(kTcThreads<KEYS>, kTcBlocks<D, HAS_REL, KEYS, Arith::BF16BF16>)
rel_attention_bf16bf16_kernel(const Args a) {
  tc_attention<D, HAS_REL, Arith::BF16BF16, KEYS>(a);
}

// The f64 instance: at KEYS 64 or 128 the resident design on the FP64
// tensor cores (rs::attention_f64, one block of eight warps per SM); at
// KEYS 0 (L > 128 or D = 64, no shipped configuration) device.cuh's float64
// FMA design, the relative term from the table
template <int KEYS>
using F64Args = std::conditional_t<KEYS == 0, f64::Args, Args>;

template <int D, bool HAS_REL, int KEYS>
__global__ void __launch_bounds__(KEYS ? rs::kThreads : f64::kThreads, KEYS ? 1 : f64::kBlocks<D>)
rel_attention_f64_kernel(const F64Args<KEYS> a) {
  if constexpr (KEYS > 0) {
    rs::attention_f64<D, HAS_REL, KEYS>(a);
  } else {
    f64::attention<D, HAS_REL, true>(a);
  }
}

template <Arith A, int D, bool HAS_REL, int KEYS>
constexpr auto tc_kernel() {
  if constexpr (A == Arith::TF32) {
    return &rel_attention_tf32_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::BF16) {
    return &rel_attention_bf16_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::TF32x3) {
    return &rel_attention_tf32x3_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::BF16x3) {
    return &rel_attention_bf16x3_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::BF16x6) {
    return &rel_attention_bf16x6_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::BF16x9) {
    return &rel_attention_bf16x9_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::F16) {
    return &rel_attention_f16_kernel<D, HAS_REL, KEYS>;
  } else if constexpr (A == Arith::F16F16) {
    return &rel_attention_f16f16_kernel<D, HAS_REL, KEYS>;
  } else {
    static_assert(A == Arith::BF16BF16, "a tensor-core arithmetic");
    return &rel_attention_bf16bf16_kernel<D, HAS_REL, KEYS>;
  }
}

template <int D, bool HAS_REL, Arith A, int KEYS>
cudaError_t launch_resident(Args a, int B, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = tc_kernel<A, D, HAS_REL, KEYS>();
  size_t smem = 0;
  if constexpr (rs::kHalfBody<A>) {
    smem = rs::HalfSmem<D, HAS_REL, KEYS, rs::kF32Rel<A>>::kBytes;
  } else if constexpr (rs::kSplitOnce<A, KEYS>) {
    smem = rs::PartsSmem<D, HAS_REL, A, KEYS>::kBytes;
  } else {
    smem = sizeof(float) * rs::Smem<D, HAS_REL, KEYS, rs::kOneBlock<A>>::kFloats;
  }
  cudaError_t err = attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = attn::sm_count(device, &sms)) != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(B) * a.H;
  if (pairs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.n_pairs = static_cast<int>(pairs);
  a.n_items = (a.n_pairs + rs::kRows / KEYS - 1) / (rs::kRows / KEYS);
  const int slots = sms * kTcBlocks<D, HAS_REL, KEYS, A>;  // persistent: every block resident at once
  const int blocks = a.n_items < slots ? a.n_items : slots;
  kernel<<<blocks, rs::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool HAS_REL, Arith A>
cudaError_t launch_tc(Args a, int B, int device, cudaStream_t stream) {
  // the resident design up to L = 128 at D <= 32; the chunked one for longer
  // sequences and at D = 64 (no shipped configuration; ptxas spilled there)
  if constexpr (D <= 32) {
    if (a.L <= rs::kMaxL) {
      return a.L <= rs::kMaxL / 2 ? launch_resident<D, HAS_REL, A, rs::kMaxL / 2>(a, B, device, stream)
                                  : launch_resident<D, HAS_REL, A, rs::kMaxL>(a, B, device, stream);
    }
  }
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = tc_kernel<A, D, HAS_REL, 0>();
  const size_t smem = sizeof(float) * tc::Smem<D, HAS_REL>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  a.n_tiles = (a.L + tc::kRows - 1) / tc::kRows;
  const long long blocks = static_cast<long long>(B) * a.H * a.n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The f64 instance's resident design: persistent blocks, one per SM.
template <int D, bool HAS_REL, int KEYS>
cudaError_t launch_f64_resident(Args a, int B, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = &rel_attention_f64_kernel<D, HAS_REL, KEYS>;
  const size_t smem = rs::F64Smem<D, HAS_REL, KEYS>::kBytes;
  cudaError_t err = attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = attn::sm_count(device, &sms)) != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(B) * a.H;
  if (pairs > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.n_pairs = static_cast<int>(pairs);
  a.n_items = (a.n_pairs + rs::kRows / KEYS - 1) / (rs::kRows / KEYS);
  const int blocks = a.n_items < sms ? a.n_items : sms;
  kernel<<<blocks, rs::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The f64 instance over (B, H, L, D) views: out is the (B, L, H, D) buffer.
// The resident design up to L = 128 at D <= 32; the float64 FMA design
// beyond.
template <int D, bool HAS_REL>
cudaError_t launch_f64(const Args& a, int B, int device, cudaStream_t stream) {
  if constexpr (D <= 32) {
    if (a.L <= rs::kMaxL) {
      return a.L <= rs::kMaxL / 2 ? launch_f64_resident<D, HAS_REL, rs::kMaxL / 2>(a, B, device, stream)
                                  : launch_f64_resident<D, HAS_REL, rs::kMaxL>(a, B, device, stream);
    }
  }
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const size_t smem = sizeof(double) * f64::Smem<D, HAS_REL>::kDoubles;
  const cudaError_t err = attn::opt_in_smem(reinterpret_cast<const void*>(&rel_attention_f64_kernel<D, HAS_REL, 0>),
                                            granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long bh = static_cast<long long>(B) * a.H;
  const f64::Args f{a.q, a.k, a.v, a.bias, a.table, a.out, a.sb, a.sh, a.sl,
                    static_cast<long long>(a.L) * a.H * D, D, static_cast<long long>(a.H) * D,
                    a.H, a.L, a.M, bh, (a.L + f64::kRows - 1) / f64::kRows, a.scale2};
  const long long blocks = f.n_tiles * ((bh + f64::kPairs - 1) / f64::kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rel_attention_f64_kernel<D, HAS_REL, 0><<<static_cast<unsigned>(blocks), f64::kThreads, smem, stream>>>(f);
  return cudaGetLastError();
}

// instance: 0 FMA, 1 TF32, 2 bf16, 3 TF32x3, 4 bf16x3, 5 bf16x6, 6 bf16x9,
// 7 f64, 8 f16, 9 f16f16, 10 bf16bf16 (see the note at the top)
template <int D, bool HAS_REL>
cudaError_t dispatch_instance(const Args& a, int B, int instance, int device, cudaStream_t stream) {
  switch (instance) {
    case 0: if constexpr (kBuiltInstance<0>) return launch<D, HAS_REL>(a, B, device, stream); break;
    case 1: if constexpr (kBuiltInstance<1>) return launch_tc<D, HAS_REL, Arith::TF32>(a, B, device, stream); break;
    case 2: if constexpr (kBuiltInstance<2>) return launch_tc<D, HAS_REL, Arith::BF16>(a, B, device, stream); break;
    case 3: if constexpr (kBuiltInstance<3>) return launch_tc<D, HAS_REL, Arith::TF32x3>(a, B, device, stream); break;
    case 4: if constexpr (kBuiltInstance<4>) return launch_tc<D, HAS_REL, Arith::BF16x3>(a, B, device, stream); break;
    case 5: if constexpr (kBuiltInstance<5>) return launch_tc<D, HAS_REL, Arith::BF16x6>(a, B, device, stream); break;
    case 6: if constexpr (kBuiltInstance<6>) return launch_tc<D, HAS_REL, Arith::BF16x9>(a, B, device, stream); break;
    case 7: if constexpr (kBuiltInstance<7>) return launch_f64<D, HAS_REL>(a, B, device, stream); break;
    case 8: if constexpr (kBuiltInstance<8>) return launch_tc<D, HAS_REL, Arith::F16>(a, B, device, stream); break;
    case 9: if constexpr (kBuiltInstance<9>) return launch_tc<D, HAS_REL, Arith::F16F16>(a, B, device, stream); break;
    case 10: if constexpr (kBuiltInstance<10>) return launch_tc<D, HAS_REL, Arith::BF16BF16>(a, B, device, stream); break;
    default: break;
  }
  return cudaErrorInvalidValue;  // not an instance of this library's part (launch.cuh)
}

template <int D>
cudaError_t dispatch_rel(const Args& a, int B, int has_rel, int instance, int device, cudaStream_t stream) {
  if constexpr (!kBuiltHeadDim<D>) {
    return cudaErrorInvalidValue;  // not a head size of this library's part (launch.cuh)
  } else {
    return has_rel ? dispatch_instance<D, true>(a, B, instance, device, stream)
                   : dispatch_instance<D, false>(a, B, instance, device, stream);
  }
}

}  // namespace

// q, k, v: (B, H, L, D) float32 views that share the (batch, head, row)
// strides sb, sh, sl in floats (the last dimension has stride 1), every row
// 16-byte aligned. out: a contiguous (B, L, H, D) buffer. table:
// the contiguous (2M - 1, D) distance table, 16-byte aligned, or null when
// has_rel is 0. `instance` picks the arithmetic: 0 FMA, 1 TF32, 2 bf16, 3-6
// the multi-pass presets TF32x3, bf16x3, bf16x6, bf16x9, 7 f64, 8-10 the
// 16-bit presets f16, f16f16, bf16bf16.
// `device` is the index of the device that holds the tensors and `stream`.
extern "C" int rel_attention_forward(const float* q, const float* k, const float* v,
                                     const float* bias, const float* table, float* out,
                                     long long sb, long long sh, long long sl, int B, int H, int L,
                                     int D, int M, int has_rel, int instance, int device,
                                     void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.table = table;
  a.out = out;
  a.sb = sb;
  a.sh = sh;
  a.sl = sl;
  a.H = H;
  a.L = L;
  a.M = M;
  a.n_tiles = (L + kTile - 1) / kTile;
  a.scale2 = kLog2e / sqrtf(static_cast<float>(D));
  return attn::on_device(device, [&] {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
      case 16: return dispatch_rel<16>(a, B, has_rel, instance, device, s);
      case 32: return dispatch_rel<32>(a, B, has_rel, instance, device, s);
      case 64: return dispatch_rel<64>(a, B, has_rel, instance, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
