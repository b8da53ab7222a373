// Fused BERT self-attention over a gathered relative-position tensor, for Hopper.
//
// Replaces the Pallas TPU kernel foldingdiff_tpu/ops/pallas_attention.py:
// _attn_rel_kernel with _one_head_t, entry fused_attention. For every (b, h)
// pair and query row l it computes
//
//   s[j]   = (q[l] . k[j] + q[l] . e_lr[l, j]) * D^-1/2 + bias[b, j]
//   out[l] = softmax_j(s) . v
//
// with q, k, v (B, H, L, D) float32 views in any layout whose last dimension
// has stride 1 and whose rows start on 16 bytes (the denoiser passes the
// (B, L, H, D) projections as they are), out written as a contiguous
// (B, L, H, D) buffer (the layout the output projection reads), bias (B, L)
// the additive key mask (0 or -10000) and e_lr any (L, L, D) float32 tensor,
// contiguous: it is gathered from the caller's position ids, so nothing here
// assumes it is Toeplitz. The relative term is added before the scale, as in
// HF BERT. Without relative scores (_attn_kernel) the entry launches the v2
// kernel's rel-off instance of the same mode (csrc/rel_attention.cu), which
// computes the same function: this source has no rel-off instance.
//
// Eleven instances, one per matmul precision of the model (the caller picks
// one by `instance`; ops/attention.py maps the model's mode onto it), each
// computing the products that the JAX model's einsums compute in that mode:
//   0 FMA   (IEEE float32, "highest"): gathered_attention_kernel, float32 FMA
//           on the CUDA cores;
//   1 TF32  ("high", and "default" under a caller's TF32):
//           gathered_attention_tf32_kernel, q.k, q.e_lr and p.v on TF32
//           tensor cores (mma.sync m16n8k8), each operand rounded to TF32 by
//           cvt.rna.tf32.f32 (to nearest, ties away from zero), float32 sums;
//   2 bf16  ("BF16_BF16_F32"): gathered_attention_bf16_kernel, operands
//           rounded to bf16 values (to nearest even): q, k, v and e_lr, and P
//           before p.v. Each product is the exact product of two bf16 values
//           and the sums are float32, as JAX's preset defines. P is
//           normalised before it is rounded, as the einsum's operand is the
//           softmax's output. In the resident design the products run on the
//           bf16 tensor cores (mma.sync m16n8k16, attention_half, below), the
//           relative term float32; in the chunked design on the TF32 ones,
//           which hold bf16's 8 significant bits.
//   3-6     ("TF32_TF32_F32_X3", "BF16_BF16_F32_X3", "_X6", "_X9"):
//           gathered_attention_{tf32x3,bf16x3,bf16x6,bf16x9}_kernel, the
//           multi-pass presets (device.cuh's Arith): every operand split
//           into two or three TF32 or bf16 parts, the listed products of
//           parts (3, 6 or 9 times TF32's) summed in float32; P split after
//           it is normalised. TF32x3, bf16x6 and bf16x9 run the resident
//           design (below) at L <= 128 and D <= 32, each operand split
//           once, their row statistics exact over every key in one pass
//           (bf16 parts on bf16 mma, m16n8k16); bf16x3 runs the chunked
//           body, split once, on bf16 mma, a first pass over the keys
//           finding each row's maximum and sum, and so do bf16x6 and bf16x9
//           beyond, and TF32x3 there split at each TF32 mma (device.cuh's
//           mma_split).
//   7 f64   ("F64_F64_F64"): gathered_attention_f64_kernel, every product in
//           float64, each dot's output rounded to float32: on the FP64
//           tensor cores (mma.sync m16n8k16 f64, DMMA) in the resident
//           design (attention_f64, below), and past it float64 FMA on the
//           CUDA cores (device.cuh's f64 design, which v2 shares);
//   8-10    ("F16_F16_F32", "F16_F16_F16", "BF16_BF16_BF16"):
//           gathered_attention_{f16,f16f16,bf16bf16}_kernel, operands rounded
//           to f16 values (f16, f16f16) or bf16 values (bf16bf16); f16f16 and
//           bf16bf16 then round each dot's output once to f16 or bf16
//           (device.cuh's output): q.k and q.e_lr each before their sum, p.v
//           before it is stored. The sums stay float32, which is how the port
//           reads those presets (precision.py). bf16bf16 runs bf16's
//           attention_half in the resident design; f16 and f16f16 run the
//           TF32 body there on f16 values in 32-bit words (m16n8k8), and all
//           three the chunked design's TF32 tensor cores beyond.
// Softmax is float32 in every instance, in exp2 units with the scale folded
// in.
//
// The first design (one block per (b, h) pair and tile of query rows, e_lr
// streamed from global memory by every thread) was bound by L2 traffic: e_lr
// does not depend on b or h, yet each of the 768 pairs of a flagship call
// (B = 64, H = 12, L = 128, D = 32) read all 2 MiB of it, 1.61 GB per call at
// ~4.0 TB/s: 0.4048 ms against 0.3175 ms for the plain PyTorch version on an
// H100 80GB HBM3 at 700 W, with the FMAs at 9% of the float32 CUDA-core peak.
//
// FMA design: a block owns a tile of R = 16 query rows and a group of P = 8
// consecutive (b, h) pairs (a group may span batch items), 128 threads. The
// block walks the keys in chunks of Jc = 128 / D (4 at D = 32) and stages,
// per chunk, e_lr[l0:l0+R, j0:j0+Jc, :] once for all P pairs, the P pairs' K
// and V rows of the chunk and their bias entries: two stages in dynamic
// shared memory, filled with 16-byte cp.async (4-byte for the bias), so the
// next chunk's loads overlap this chunk's FMAs.
//
// A 16-byte shared load is served a quarter-warp (8 lanes) per wavefront, so
// what a thread reads from shared memory per FMA sets the pace, however many
// lanes share a word. One (row, pair) output per thread reads K, e_lr and V
// once per FMA (3 D floats per key for 3 D FMAs). Here a quad of 4 threads
// owns 2 rows x 2 pairs, each lane a quarter of D of all four: per key a lane
// reads 6 D / 4 floats for the same 3 D FMAs, and the quad sums its partial
// scores with 2 xor-shuffles per output, which leave the same bits in every
// lane. Each lane keeps its slices of q and of the four output rows in
// registers and runs the online softmax of all four (in exp2 units), rescaled
// once per chunk. The two quads of an 8-lane phase share their rows and take
// pairs one apart; staged rows are Jc * D + 16 floats apart (16 mod 32), so
// their K and V reads fill the 32 banks and their e_lr reads coincide. Keys
// past L, rows past L and pairs past B * H are zero-filled in shared memory,
// keys past L are scored -inf, and nothing is written for the rest. The mask is
// the additive -10000, never -inf, so padded query rows still produce output.
//
// Per stage: (R + 2P) * (Jc * D + 16) + P * Jc floats, 18,560 bytes at D = 32,
// 37,120 double-buffered. ptxas puts the D = 32 instances at 165-168
// registers; __launch_bounds__ asks for three blocks (12 warps) per SM, which
// the register file then holds without spills. A cap of 128 registers (four
// blocks) spilled and ran slower, and so did R = 32 or Jc * D = 256. Shared
// memory does not grow with L, so no length is refused for it.
//
// What bounds the FMA instance, per flagship call: 2.42 GFLOP of FMAs (3 L^2 D
// per pair: q.k, q.e and p.v), 36 us at the 67 TFLOP/s float32 peak;
// shared-memory reads of 6 D / 4 floats per (thread, key) plus 8 shuffles, 56
// wavefronts per warp and key, 22 M wavefronts, ~95 us at one wavefront per
// clock per SM (132 SMs, 1.755 GHz); L2 reads of ceil(BH / P) * L^2 * D * 4 =
// 201 MB of e_lr (8x less than before), ceil(L / R) * BH * L * D * 8 = 201 MB
// of K and V and 25 MB of q and out, 428 MB in all; device memory sees ~52 MB
// (e_lr once, q, k, v, out). It stays float32 FMA for IEEE parity, which on
// tensor cores would need the 3xTF32 split (three products per term).
//
// Tensor-core designs. The products cost 4.9 us per flagship call at the 495
// TFLOP/s TF32 rate. The relative term is not a product over query rows:
// rel[n, l, j] = q[n, l] . e_lr[l, j] takes another e_lr row block for every
// row l. It is one over pairs at a fixed row: (pairs x D) . (D x keys). So a
// block of 16 warps (512 threads) owns P = 16 pairs and R = 16 query rows:
// warp w computes the relative term of row l0 + w for the 16 pairs (the
// m16n8k8 tile's 16 rows, keys its columns), reading e_lr's B fragments
// from L2, and then pair n0 + w's scores, softmax and p . v for the 16 rows,
// as the v2 kernel's tensor-core warps do. K, V and the bias of a pair are
// read by its warp alone, straight from L2 into fragments: nothing of them
// is shared within the block, so nothing of them is staged. Per flagship
// call a block of P pairs and R rows reads e_lr once per (block, row) and K
// and V once per (block, pair): 768 x 128 x (16 KB / P + 32 KB / R), 302 MB
// at P = R = 16 (100 MB e_lr, 201 MB K and V), and 25 MB of q and out.
//
// Resident tensor-core design (TF32, bf16, TF32x3, bf16x6, bf16x9 and the
// 16-bit instances at L <= 128 and D <= 32, every shipped configuration;
// bf16 and bf16bf16 on 16-bit operands, attention_half, described after
// it): one pass over the
// keys. A warp takes each of its pair's rows' exact maximum and sum over
// every key and normalises P before it is rounded, as v2's resident design
// does, so that no instance reads e_lr and K a second time for the row
// statistics (the chunked body's bf16 pass over the keys cost 0.1198
// against TF32's 0.0778 ms, its e_lr and K bytes 527 MB against 327 MB).
// Per work item (16 pairs, 16 rows):
//   - The relative term first, every key at once: warp w's row of e_lr
//     (keys x D, from L2, kRelGroup = 4 n-tiles of loads in flight)
//     against the 16 pairs' q rows, into the store rel[pair][row][key] in
//     shared memory (rows KEYS + 8 floats apart, pairs 16 (KEYS + 8) + 8:
//     8 mod 32, so that the float2 stores of the row-warp and the float2
//     loads of the pair-warp fall on distinct banks); one barrier, then
//     every pair-warp reads its 16 rows of it. Two barriers per item, where
//     the chunked body takes one per 32 keys.
//   - The scores of 64 keys at a time (kChunkNT = 8 n-tiles, 32 registers
//     a lane) are held in registers; at KEYS = 128 the first chunk is
//     parked in the store, each lane over the relative term it has just
//     read, and read back for the row sums and for p . v (its
//     exponentials taken again there, with the same bits). Every score in
//     registers (64 a lane at KEYS = 128) spilled at 128 registers a thread.
//   - Persistent blocks (one per SM) walk the items; each block stages its
//     next item's q tile and the bias rows of its pairs with cp.async into
//     a second stage while this item computes, so no block starts on an
//     exposed wait (the bias read from L2 at its use was hoisted by ptxas
//     for every key at once, and spilled).
//   - K and V are read from L2 in groups of kLoadGroup = 4 n-tiles, plain
//     loads fenced by __syncwarp between groups, their row stride hidden
//     from the optimiser (opaque) and the chunks a loop, not unrolled, so
//     that ptxas neither hoists every load nor holds every row's offset
//     and predicate across the item loop (either spilled).
//   - Clusters of C blocks (measured, not kept): the C blocks of a cluster
//     owned C groups of 16 pairs at the same rows, each row's e_lr read by
//     C warps of one block (in L1 after the first) and its relative term
//     stored into all C blocks' stores (distributed shared memory), which
//     divided e_lr's L2 bytes by C; q's A fragments for it came from L2.
// At KEYS = 128, D = 32 shared memory holds the store (139,776 bytes) and
// two stages of a q tile and 16 bias rows (83,968).
// L2 bytes per flagship call (B = 64, H = 12, L = 128, D = 32): e_lr
// ceil(BH / 16) L^2 D 4 = 100.7 MB, K and V ceil(L / 16) BH L D 8 =
// 201.3 MB, q and out 25.2 MB: 327 MB (the clusters of C blocks read e_lr's
// 100.7 MB / C and q's 12.6 MB again: 289 MB at C = 2, 264 MB at C = 4).
// Measured at the flagship shape with e_lr on the projections' views
// (scripts/gathered_attention_variants.py, NVIDIA H100 80GB HBM3, 700 W,
// the variants in turns; TF32 / bf16 / f16 / f16f16 / bf16bf16 ms):
//   final (C = 1, load groups of 4, 64-key chunks, 327 MB)
//                        0.0679 / 0.0682 / 0.0645 / 0.0644 / 0.0705
//   cluster-2 (289 MB)   0.0753 / 0.0756 / 0.0748 / 0.0741 / 0.0788
//   cluster-4 (264 MB)   0.1020 / 0.1034 / 0.1015 / 0.1010 / 0.1091
//   load groups of 1     0.0835 / 0.0870 / 0.0824 / 0.0831 / 0.0904
//   load groups of 2     0.0689 / 0.0720 / 0.0678 / 0.0681 / 0.0746
//   e_lr groups of 8     0.0676 / 0.0693 / 0.0650 / 0.0652 / 0.0706
//   32-key chunks        0.0661 / 0.0687 / 0.0656 / 0.0651 / 0.0712
// against the chunked body's 0.0779 / 0.1201 / 0.0995 / 0.0999 / 0.1316
// (scripts/kernel_times_two_trees.py, in turns). Fewer L2 bytes did not buy
// time: the clusters' two cluster-wide barriers per item and their stores
// into other blocks' shared memory cost more than the e_lr reads they save
// (and at 128 registers they spilled). 327 MB in 0.0679 ms is 4.8 TB/s of
// L2 reads, where the chunked body read 327 MB (TF32) in 0.0779 ms, 4.2:
// what bounds the design now is not measured (no profiler reads stalls on
// the card's machine). The 64-key and 32-key chunks ran within 2% of each
// other, e_lr groups of 8 the same.
// Integer rounding of TF32 operands (device.cuh's round_part) instead of
// cvt.rna ran 0.0657 against 0.0662 ms, within the runs' spread: not kept.
//
// The bf16 instances on 16-bit operands, resident (attention_half; bf16 and
// bf16bf16 at L <= 128 and D <= 32): the design above with each operand
// rounded to bf16 once and every product one m16n8k16 on the bf16 tensor
// cores (device.cuh's mma16), where the TF32 body held bf16 values in
// 32-bit words and rounded each B value at two m16n8k8 per 16 values:
//   - q's rows packed into A fragments once per item from the staged tile
//     (the row-warp's 16 pairs, then the pair-warp's 16 rows: 8 registers at
//     D = 32 against the TF32 body's 16); e_lr's, K's and V's B values
//     packed as they are loaded from L2, two conversions per float4. Each
//     value enters one mma per item (it serves the tile's 16 pairs or rows)
//     and no warp reads another's rows, so 16-bit planes of them in shared
//     memory would add a store, a barrier and an ldmatrix and save no
//     rounding; nor do they fit: the store and two stages take 223,744 of
//     the 232,448 bytes a block may have (16 keys of K per warp, 20,480
//     bytes at D = 32, already do not);
//   - P per 16 keys from two n-tiles' accumulators, an m16n8k16 A fragment
//     as they lie (no key order), V's rows 2t, 2t + 1, 8 + 2t, 9 + 2t of the
//     16 keys its B values, each output n-tile's columns as tc::VCols has
//     them;
//   - bf16 seeds each score accumulator with its float32 relative term.
//     Rounded to bf16 in the store (the variant half-bf16-rel-rounded) it
//     fails bf16's gate on the card, 0.537-0.574 of the plain version's
//     distance from float32 against 0.1, as v2's did: the relative term
//     stays float32. bf16bf16 takes q.e_lr and q.k each from zero, rounds
//     each to bf16 on its own, then sums them in float32;
//   - the item stays 16 pairs x 16 rows. 32 rows would halve K's and V's
//     201 MB per flagship call (327 -> 226 MB), but the exact row statistics
//     need every key's score before P is rounded, and an item's float32
//     relative terms, or its parked scores, would then take 16 x 32 x 128 x
//     4 = 262,144 bytes, past what a block has.
// 128 registers at KEYS = 128 (118-120 at KEYS = 64, 96-111 at D = 16), no
// spill. Measured in turns (scripts/gathered_attention_variants.py, NVIDIA
// H100 80GB HBM3, 700.00 W; ms of bf16 / bf16bf16 with e_lr at 64 x 128,
// 64 x 64, 15 x 64; the load groups and chunks were this body's own
// constants then, and lost to the body above's, which it now shares, so
// chunk-32, load-group-2 and rel-group-8 run on both bodies):
//   this form               0.0626 / 0.0631, 0.0224 / 0.0228, 0.0112 / 0.0112
//   the TF32 body           0.0682 / 0.0704, 0.0261 / 0.0277, 0.0131 / 0.0145
//   32-key score chunks     0.0647 / 0.0641, 0.0233 / 0.0237, 0.0121 / 0.0121
//   every score in registers 0.0708 / 0.0807 at 64 x 128 (36 and 104 bytes
//                           spilled; at KEYS = 64 it is this form)
//   K groups of 2 n-tiles   0.0640 / 0.0653, 0.0221 / 0.0231, 0.0111 / 0.0119
//   V groups of 2           0.0651 / 0.0657, 0.0234 / 0.0235, 0.0117 / 0.0118
//   e_lr groups of 8        0.0633 / 0.0641, 0.0226 / 0.0236, 0.0114 / 0.0119
// and in a later run (this form 0.0635 / 0.0638, 0.0234 / 0.0236, 0.0115 /
// 0.0119) each phase's first load group issued before the wait ahead of
// it (e_lr's before the stage's, K's before the store's barrier, V's
// before the softmax), alone or together: every one spilled at 128
// registers (20-276 bytes), and the best, K's and V's, read 0.0642 /
// 0.0625, 0.0216 / 0.0220, 0.0112 / 0.0117; all three 0.0753 / 0.0762.
// Their code is gone.
// What bounds it, from two probes in the same run (the variants probe-*, at
// 64 x 128; TF32 body on TF32 / this form on bf16 / on bf16bf16): as is
// 0.0676 / 0.0626 / 0.0631 ms; every product dropped, the loads kept
// 0.0620 / 0.0631 / 0.0629; e_lr's, K's and V's L2 bytes dropped, the
// products kept (every warp reading the same few rows) 0.0562 / 0.0499 /
// 0.0516. The products and roundings cost the TF32 body 8%, which this form
// saved; they cost this form nothing. The L2 bytes cost 20%, and at 64 x 64
// and 15 x 64 nothing (0.0212 / 0.0208 and 0.0116 / 0.0111 without them).
// What remains is not bytes or tensor cores: one block of 16 warps per SM
// takes each item's phases (e_lr's loads, a barrier, K's, the softmax, V's)
// one after another, every fragment load touching 8 rows of 128 bytes for
// 512 bytes (4 lanes per key row), and at 15 x 64 the call's 48 items run
// on 48 of the 132 SMs, one item each: 0.0112 ms is one item's latency.
//
// The f64 instance, resident (attention_f64; L <= 128 at D <= 32): the
// design above with its products on the FP64 tensor cores, mma.sync
// m16n8k16 with float64 operands and accumulators (device.cuh's dmma), a
// chunk of 16 values of the contracted dimension per mma, lane t taking
// values 4t .. 4t + 3 of it (as v2's attention_f64 does):
//   - the relative term, over pairs at a fixed row, each rounded to
//     float32 into the store; q's chunks widened once per item, e_lr's B
//     values as they are loaded from L2 (kF64RelGroup = 4 n-tiles in
//     flight): each serves the tile's 16 pairs, 4 widenings per lane per
//     2,048-FMA mma, and no warp reads another's row, so staging it in
//     float64 (no room: the store and two stages take 223,744 bytes) would
//     add a shared-memory round trip and save no widening;
//   - each pair-warp's q.k from a zero float64 accumulator, rounded to
//     float32, plus the stored relative term in float32; K and V widened as
//     loaded (kF64KGroup, kF64VGroup = 2 n-tiles in flight); exact row
//     statistics; P normalised, widened exactly, p.v in float64 into the
//     output columns tc::VCols permutes, rounded to float32 once;
//   - 32 keys of scores at a time in registers (kF64ChunkNT), the rest
//     parked in the store: q's float64 chunks (32 registers at D = 32) and
//     p.v's accumulators (32) leave no room for 64 (72-112 bytes spilled).
// Measured with e_lr against the float64 FMA design in turns (NVIDIA H100
// 80GB HBM3, 700 W; scripts/kernel_times_two_trees.py): 0.4272 -> 0.0776 ms
// at the flagship shape, 0.1089 -> 0.0272 at 64 x 64, 0.0380 -> 0.0139 at
// 15 x 64. The variants in turns (scripts/gathered_attention_variants.py;
// ms at 64 x 128 / 64 x 64 / 15 x 64): this form 0.0773 / 0.0265 / 0.0136;
// m16n8k8 0.0770 / 0.0270 / 0.0140; m16n8k4 0.0780 / 0.0283 / 0.0143;
// 64-key chunks 0.0772 / 0.0310 / 0.0153 (spilled); e_lr groups of 2
// 0.0789 / 0.0269 / 0.0138; K groups of 4 0.0764 / 0.0266 / 0.0135 (8
// bytes spilled at KEYS = 64); V groups of 4 0.0753 / 0.0271 / 0.0139 (52
// bytes spilled). The m16n8k8 and m16n8k4 forms were not kept, and their
// code is gone (device.cuh's dmma_chunk is m16n8k16). At 0.0776 ms the
// 1.2 G float64 FMA of a call run at 47% of the FP64 tensor cores' peak.
//
// The TF32x3 instance, resident (L <= 128 at D <= 32): the design above
// with each dot's three products of TF32 parts, per k-step a1.b0, a0.b1,
// a0.b0 into one float32 accumulator (device.cuh's products), where the
// chunked body below made two passes over the keys (the first for each
// row's maximum and sum, then q.k and q.e_lr again: 15 products of parts
// per key and dimension against 9, e_lr and K read from L2 twice):
//   - each operand split once (kSplitOnce): q's parts once per item into
//     registers (the row-warp's 16 pairs, then the pair-warp's 16 rows: 32
//     registers at D = 32), e_lr's, K's and V's chunks of 16 values as
//     they are loaded from L2 (each enters the mma of one group), P's per
//     16 keys from two n-tiles' accumulators (device.cuh's p_chunk); the
//     products of a group of n-tiles interleave;
//   - e_lr loaded and multiplied by groups of four n-tiles, K and V by
//     two, the scores held 64 keys at a time at KEYS = 128 (the first
//     chunk parked in the store) and 32 at KEYS = 64;
//   - K and V read from L2 at the views' row stride, as the other resident
//     instances read them: staging K's rows in shared memory does not fit
//     (the store and two stages take 223,744 of the 232,448 bytes a block
//     may have at KEYS = 128, D = 32; 16 K rows per warp, double-buffered,
//     would take 65,536 more).
// Its sums are the chunked body's but for the row statistics (taken over
// every key at once, P = exp2(s - max) times the sum's reciprocal), and
// interleaving n-tiles changes no accumulator's order. Measured in turns
// (scripts/gathered_attention_variants.py, NVIDIA H100 80GB HBM3, 700 W;
// ms at 64 x 128 / 64 x 64 / 15 x 64 with e_lr): the chunked body 0.1273
// / 0.0462 / 0.0237; this design split once, 32-key chunks, groups of
// two: 0.0783 / 0.0264 / 0.0139, again 0.0781 / 0.0264 / 0.0139; split at
// each mma instead (its 12 words of parts made at every mma) 0.0780 /
// 0.0273 / 0.0144; 64-key chunks 0.0758 / 0.0270 / 0.0141 and 0.0760 /
// 0.0271 / 0.0139; e_lr's groups of four 0.0763 / 0.0260 / 0.0138; both
// 0.0750 / 0.0271 / 0.0140 (128 registers, no spill): kept, 64-key chunks
// at KEYS = 128 only; K's groups of four 0.0775 / 0.0266 / 0.0141 (with
// 64-key chunks 4 bytes spilled at KEYS = 64), e_lr's and K's 0.0759 /
// 0.0276 / 0.0144 (48 bytes spilled with 64-key chunks); V's groups of four
// 0.0765 / 0.0263 / 0.0138. At 64 x 128 it runs within 11% of the TF32
// instance's one product (0.0679).
//
// The bf16x6 and bf16x9 instances, resident (L <= 128 at D <= 32): the
// same body with bf16 parts, each product of parts one m16n8k16 on the
// bf16 tensor cores (6 or 9 per 16 values of the contracted dimension,
// against TF32x3's 6 m16n8k8), where the chunked body below took its
// first pass over the keys (e_lr and K read twice: 527 MB per flagship
// call against 327):
//   - q's three parts once per item from the held fragments (device.cuh's
//     split_fragments: columns 16c + 4t, + 1 as k = 2t, 2t + 1 and + 2,
//     + 3 as k = 2t + 8, 2t + 9, the order split4 gives B's chunks; 24
//     registers at D = 32), e_lr's, K's and V's split as loaded, P's after
//     it is normalised (p_chunk);
//   - TF32x3's groups and chunks (e_lr by four n-tiles, K and V by two,
//     the scores 64 keys at a time at KEYS = 128 and 32 at KEYS = 64), but
//     V by four at KEYS = 128 (kBPVGroup); 128 registers at most, no spill
//     (bf16x9 at KEYS = 128, D = 32: 128; bf16x6 125).
// Measured in turns (scripts/gathered_attention_variants.py, NVIDIA H100
// 80GB HBM3, 700.00 W; ms of bf16x6 / bf16x9 at 64 x 128, 64 x 64, 15 x 64
// with e_lr, two runs):
//   this form            0.0781 / 0.0880, 0.0279 / 0.0321, 0.0148 / 0.0169
//   the chunked body     0.1404 / 0.1629, 0.0510 / 0.0589, 0.0259 / 0.0301
//   V groups of 2 at KEYS = 128 (TF32x3's) 0.0791 / 0.0897 and 0.0789 /
//                        0.0891 at 64 x 128
//   V groups of 4 at KEYS = 64  0.0289 / 0.0324, 0.0149 / 0.0169 and
//                        0.0285 / 0.0323, 0.0150 / 0.0170
//   K groups of 4        0.0811 / 0.0884, 0.0279 / 0.0332, 0.0147 / 0.0173
//                        (first run 0.0799 / 0.0887 against 0.0791 / 0.0897)
//   32-key chunks at KEYS = 128  0.0803 / 0.0924
//   64-key chunks at KEYS = 64   0.0301 / 0.0328, 0.0160 / 0.0173 (bf16x9
//                        8 bytes spilled)
//   e_lr groups of 2     0.0807 / 0.0908, 0.0283 / 0.0331, 0.0149 / 0.0174
// (the first run's alternatives against V groups of 2 everywhere). Against
// the chunked body's 0.1419 / 0.1645 ms at 64 x 128 (scripts/
// kernel_times_two_trees.py, in turns with the parent), 0.0791 / 0.0888:
// a factor of 0.54-0.58 at the three shapes, as TF32x3's 0.58.
//
// Chunked tensor-core design (bf16x3, and the others at L > 128 or D = 64):
// the block above walks the keys in chunks of 32 (16 at D = 64):
//   - The relative term. Warp w computes row l0 + w for the 16 pairs: C =
//     Q_l . E_l^T, E_l's B fragments read from L2 (each e_lr element once
//     per block, for 16 pairs: 100 MB per flagship call). It stores C
//     transposed into one of two (pair, row, key) buffers in shared memory
//     (rows Jc + 8 floats apart, pairs 16 (Jc + 8) + 8: the float2 stores
//     and loads fall on 32 distinct banks), one chunk ahead, so a chunk
//     needs one barrier.
//   - Then warp w takes pair n0 + w's 16 rows: scores start from the
//     buffer's rel values, S += Q . K^T, then scale and bias in one FMA, keys
//     past L scored -inf; the softmax online over chunks (TF32), or with a
//     first pass over the keys that finds each row's maximum and sum, so
//     that P is normalised before it is rounded or split; p . v from the
//     score accumulators as they are, each k-step's keys in the order
//     (0, 2, 4, 6, 1, 3, 5, 7) for P and V alike (the accumulator holds
//     columns 2t, 2t + 1 where the A fragment wants t, t + 4).
//   - Both A operands come from the block's 16 x 16 x D q tile, staged once
//     in shared memory (rows with their 16-float halves swapped on odd rows,
//     pairs 16 mod 32 floats apart: conflict-free either way) and loaded per
//     chunk, so that no q register lives across the loop: 512 threads have
//     128 registers each, and ptxas hoists every independent L2 load it can.
//   - The products sum over d, so each k-step may take any 8 of D's columns
//     as long as A and B agree: k-step 2c + h takes 16c + 4t + 2h (k = t) and
//     16c + 4t + 2h + 1 (k = t + 4), so that every lane reads its q, K and
//     e_lr columns as float4s; p . v's output columns are permuted the same
//     way, so that V is read and out written as float4s.
//   - K and V are read at the row stride of the caller's views (the
//     projections' (B, L, H, D) layout): a lane's rows of a
//     group of n-tiles then need an address each, where rows D floats apart
//     sat at fixed offsets from one. For bf16x9 the stride is hidden from
//     the optimiser (kHideKStride, kHideVStride; it spilled otherwise), for
//     TF32x3 K's. bf16x3 on the views ran 3.5% slower at 64 x 128 than
//     the earlier form on contiguous rows D apart (0.1144 against 0.1105
//     ms, scripts/kernel_times_two_trees.py, NVIDIA H100 80GB HBM3, 700 W),
//     the other multi-pass instances within 0.9% or faster. None of K's
//     addresses as a chunk base and a 32-bit lane offset, as 64-bit
//     products or through __ldg, or V's four row pointers taken once per
//     chunk, won that back (the variants k-lane-offset, k-wide, k-ldg,
//     v-rows: bf16x3 0.1157, 0.1144, 0.1133, 0.1139 against this form's
//     0.1137 ms, in turns on the same card).
// Measured at the flagship shape (scripts/gathered_attention_variants.py,
// NVIDIA H100 80GB HBM3, 700 W, in turns with the FMA instance's 0.1364 ms):
// TF32 0.0773 ms; bf16 0.1237 (two passes).
// What the design went through, in that script's runs:
//   - K, V and e_lr staged per chunk of 8 keys through a cp.async ring, two
//     barriers per chunk: 0.1078 ms. Its time tracked the chunks, not the
//     bytes: 32 rows per block (45% fewer L2 bytes) ran slower, a fourth
//     stage changed nothing, 16-key chunks ran 13% faster. A warp's chunk
//     was a 16 x 8 tile whose staging, barriers, fold and rescale cost
//     several hundred instructions for 8 mma.
//   - e_lr read from L2 and the relative term one chunk ahead (one barrier):
//     0.1063, 0.0820 with 16-key chunks.
//   - K and V read by each warp from L2, 32-key chunks: 0.0760, but ptxas
//     spilled at D = 32 and D = 64 with q's fragments in registers; loading
//     q from L2 per k-step instead was 30-45% slower and spilled more; 64-key
//     chunks and 32 rows per block spilled. The staged q tile removed every
//     spill at the same speed.
//
// Multi-pass design of the chunked body (bf16x3 everywhere, bf16x6 and
// bf16x9 past the resident design): the chunked body above, its operands
// split once (device.cuh's split4, products):
//   - q's parts in planes of bf16 values in shared memory, split once per
//     block from global memory (rows 24 words apart at D = 32, pairs 8 mod
//     32: the 8-byte fragment loads of either operand fall on distinct
//     banks), loaded per chunk of 16 columns as products asks for them;
//   - K, V and e_lr split in registers as each fragment is loaded from L2
//     (plain loads and a __syncwarp per group: hoisted __ldg loads of every
//     group spilled at 128 registers); P split per 16 keys from two n-tiles'
//     score accumulators, which are exactly an m16n8k16 A fragment, V's
//     rows 2t, 2t + 1, 8 + 2t, 9 + 2t its B;
//   - every product on the bf16 tensor cores (mma.sync m16n8k16), the
//     products of kGroupMax = 4 n-tiles (at D <= 32) interleaved, each
//     k-step taking the table's products smallest first.
// Measured at the flagship shape with relative scores (NVIDIA H100 80GB
// HBM3, 700 W, in turns with the earlier form, which split every fragment
// at each TF32 mma: scripts/kernel_times_two_trees.py,
// scripts/gathered_attention_variants.py): bf16x3 0.1695 -> 0.1109 ms,
// bf16x6 0.7646 -> 0.1412, bf16x9 1.0276 -> 0.1620. Against groups of four,
// the bf16 instances ran -1 to +6% with groups of two and 4-13% slower with
// one n-tile at a time (no interleaving). TF32x3 split once (two TF32
// parts, m16n8k8) ran 1-6% slower in this body than that earlier form
// (device.cuh's mma_split), which it keeps past the resident design.
//
// Rows, keys and pairs outside the tensors read as zeros (zero-filled in
// shared memory, or not loaded), keys past L are scored -inf, and nothing is
// stored for rows past L or pairs past B * H.
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

constexpr float kLog2e = 1.4426950408889634f;

// What every instance's kernel reads: q, k and v as (B, H, L, D) views with
// the strides below, out the contiguous (B, L, H, D) buffer, e_lr the
// contiguous (L, L, D) tensor.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  const float* e_lr;
  float* out;
  long long sb, sh;  // batch and head strides of q, k and v, in floats
  int sl;            // and their row stride: L sl < 2^31, so row offsets are 32-bit
  int H, L;
  long long BH;
  int n_tiles;   // tiles of 16 query rows
  int n_items;   // the resident design's work items
  float scale2;  // D^-1/2 * log2(e)
};

// The offset (floats) of (b, h) pair n = b H + h in q, k and v (B H < 2^31:
// 32-bit division).
__device__ __forceinline__ long long head_of(const Args& a, int n) {
  return static_cast<long long>(n / a.H) * a.sb + static_cast<long long>(n % a.H) * a.sh;
}

// A row stride hidden from the optimiser: an offset computed from it is
// computed where it is used, not once for every row of every n-tile of the
// unrolled loops and held in registers across them (where they spilled).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Row l of pair n in the (B, L, H, D) output buffer.
template <int D>
__device__ __forceinline__ float* out_row(const Args& a, int n, int l) {
  return a.out + (static_cast<long long>(n / a.H) * a.L + l) * a.H * D + (n % a.H) * D;
}

// The offsets (floats) of pair n = b H + h, from one division: in q, k and
// v, and in the (B, L, H, D) output (its row 0; row l is l H D further).
struct PairOffsets {
  long long head, out;
};

template <int D>
__device__ __forceinline__ PairOffsets pair_offsets(const Args& a, int n) {
  const int b = n / a.H, h = n - b * a.H;
  return {b * a.sb + h * a.sh, static_cast<long long>(b) * a.L * a.H * D + h * D};
}

constexpr int kRows = 16;                  // R: query rows per block
constexpr int kPairs = 8;                  // P: (b, h) pairs per block
constexpr int kThreads = kRows * kPairs;   // a quad of 4 threads owns 2 rows x 2 pairs
constexpr int kChunkFloats = 128;          // Jc * D: one staged row of a chunk
constexpr int kStride = kChunkFloats + 16;  // padded row, 16 mod 32 floats

// Offsets (floats) in one stage: e_lr rows from 0, then K, V, bias.
template <int D>
struct Stage {
  static constexpr int kKeys = kChunkFloats / D;  // Jc
  static constexpr int kK = kRows * kStride;
  static constexpr int kV = kK + kPairs * kStride;
  static constexpr int kBias = kV + kPairs * kStride;
  static constexpr int kFloats = kBias + kPairs * kKeys;  // multiple of 4
};

__device__ __forceinline__ void axpy4(float p, const float4 x, float4& y) {
  y.x = fmaf(p, x.x, y.x);
  y.y = fmaf(p, x.y, y.y);
  y.z = fmaf(p, x.z, y.z);
  y.w = fmaf(p, x.w, y.w);
}

// What this thread stages in every chunk: piece it of stage_chunk's K and V
// loop is pair (threadIdx.x + it kThreads) / (Jc D / 4), and its bias entry
// (threadIdx.x < P Jc) pair threadIdx.x / Jc, the same in every chunk, whose
// offsets in k and v and in the bias (or -1 past B H) are computed once: a
// division per chunk cost the FMA instance 3-6% at L = 64.
constexpr int kKVPieces = kPairs * (kChunkFloats / 4) / kThreads;
struct ChunkOffsets {
  long long kv[kKVPieces];
  long long bias;
};

template <int D>
__device__ __forceinline__ ChunkOffsets chunk_offsets(const Args& a, int n0) {
  ChunkOffsets o;
#pragma unroll
  for (int it = 0; it < kKVPieces; ++it) {
    const int n = n0 + (threadIdx.x + it * kThreads) / (kChunkFloats / 4);
    o.kv[it] = n < a.BH ? head_of(a, n) : -1;
  }
  const int n = n0 + threadIdx.x / Stage<D>::kKeys;
  o.bias = threadIdx.x < kPairs * Stage<D>::kKeys && n < a.BH ? static_cast<long long>(n / a.H) * a.L : -1;
  return o;
}

// Issues the copies of the chunk of keys [j0, j0 + Jc) into `st`: e_lr rows
// l0.. of the tile, K and V rows (of the pairs whose offsets kv_heads gave)
// and bias entries of pairs n0... What lies outside the tensors is
// zero-filled with plain stores.
template <int D>
__device__ __forceinline__ void stage_chunk(float* st, const Args& a, const ChunkOffsets& off, int l0, int j0) {
  using S = Stage<D>;
  constexpr int kVec = kChunkFloats / 4;  // float4 per staged row
  static_assert(kRows * kVec % kThreads == 0 && kPairs * kVec % kThreads == 0, "even staging");
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t = threadIdx.x;
#pragma unroll
  for (int it = 0; it < kRows * kVec / kThreads; ++it) {
    const int i = t + it * kThreads;
    const int r = i / kVec, c = i % kVec;
    float* dst = st + r * kStride + 4 * c;
    const int l = l0 + r, j = j0 + (4 * c) / D;
    if (l < a.L && j < a.L) {
      cp_async16(dst, a.e_lr + (static_cast<size_t>(l) * a.L + j0) * D + 4 * c);
    } else {
      *reinterpret_cast<float4*>(dst) = zero;
    }
  }
#pragma unroll
  for (int it = 0; it < kKVPieces; ++it) {
    const int i = t + it * kThreads;
    const int p = i / kVec, c = i % kVec;
    const int j = j0 + (4 * c) / D;
    float* kd = st + S::kK + p * kStride + 4 * c;
    float* vd = st + S::kV + p * kStride + 4 * c;
    if (off.kv[it] >= 0 && j < a.L) {
      const long long at = off.kv[it] + j * a.sl + (4 * c) % D;
      cp_async16(kd, a.k + at);
      cp_async16(vd, a.v + at);
    } else {
      *reinterpret_cast<float4*>(kd) = zero;
      *reinterpret_cast<float4*>(vd) = zero;
    }
  }
  if (t < kPairs * S::kKeys) {
    const int jj = t % S::kKeys;
    float* dst = st + S::kBias + t;
    if (off.bias >= 0 && j0 + jj < a.L) {
      cp_async4(dst, a.bias + off.bias + j0 + jj);
    } else {
      *dst = 0.0f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 3 : 1) gathered_attention_kernel(const Args a) {
  using S = Stage<D>;
  constexpr int Jc = S::kKeys;
  constexpr int kSlice = D / 16;  // float4 pieces of a D-vector per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // Quad layout: lane tq of quad `quad` holds the float4 pieces tq, tq + 4, ...
  // of each D-vector of the quad's 4 outputs (rows r0, r0 + 1) x (pairs pa, pb).
  // The two quads of an 8-lane phase share their rows and take pairs one
  // apart, so their K and V loads land kStride = 16 mod 32 floats apart.
  const int tq = threadIdx.x & 3;
  const int quad = threadIdx.x >> 2;
  const int r0 = 2 * (quad >> 2);
  const int pa = (quad & 1) + ((quad >> 1) & 1) * 4;  // 0, 1, 4, 5
  const int pb = pa + 2;
  const int l0 = (blockIdx.x % a.n_tiles) * kRows;
  const int n0 = (blockIdx.x / a.n_tiles) * kPairs;
  const ChunkOffsets offsets = chunk_offsets<D>(a, n0);
  // the offsets of pairs pa and pb in q and in out, one division each
  const PairOffsets pair[2] = {pair_offsets<D>(a, n0 + pa), pair_offsets<D>(a, n0 + pb)};

  // output o = 2 * row + pair: (r0, pa), (r0, pb), (r0 + 1, pa), (r0 + 1, pb)
  float4 qr[4][kSlice];
  float4 acc[4][kSlice];
  float row_max[4], denom[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int l = l0 + r0 + (o >> 1);
    const int n = n0 + ((o & 1) ? pb : pa);
    const bool live = l < a.L && n < a.BH;
    const float* src = a.q + (live ? pair[o & 1].head + l * a.sl : 0);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      qr[o][i] = live ? __ldg(reinterpret_cast<const float4*>(src) + tq + 4 * i)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[o][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    row_max[o] = -INFINITY;
    denom[o] = 0.0f;
  }

  const int n_chunks = (a.L + Jc - 1) / Jc;
  stage_chunk<D>(smem, a, offsets, l0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk<D>(smem + ((c + 1) & 1) * S::kFloats, a, offsets, l0, (c + 1) * Jc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* st = smem + (c & 1) * S::kFloats;
    const float4* e0 = reinterpret_cast<const float4*>(st + r0 * kStride);
    const float4* e1 = reinterpret_cast<const float4*>(st + (r0 + 1) * kStride);
    const float4* ka = reinterpret_cast<const float4*>(st + S::kK + pa * kStride);
    const float4* kb = reinterpret_cast<const float4*>(st + S::kK + pb * kStride);
    const float4* va = reinterpret_cast<const float4*>(st + S::kV + pa * kStride);
    const float4* vb = reinterpret_cast<const float4*>(st + S::kV + pb * kStride);
    const float* bias_a = st + S::kBias + pa * Jc;
    const float* bias_b = st + S::kBias + pb * Jc;
    const int valid = min(Jc, a.L - c * Jc);

    float s[4][Jc];
#pragma unroll
    for (int jj = 0; jj < Jc; ++jj) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const int x = jj * (D / 4) + tq + 4 * i;
        const float4 kxa = ka[x], kxb = kb[x];
        part[0] = dot4(qr[0][i], kxa, part[0]);
        part[1] = dot4(qr[1][i], kxb, part[1]);
        part[2] = dot4(qr[2][i], kxa, part[2]);
        part[3] = dot4(qr[3][i], kxb, part[3]);
        const float4 ex0 = e0[x], ex1 = e1[x];
        part[0] = dot4(qr[0][i], ex0, part[0]);
        part[1] = dot4(qr[1][i], ex0, part[1]);
        part[2] = dot4(qr[2][i], ex1, part[2]);
        part[3] = dot4(qr[3][i], ex1, part[3]);
      }
      const float ba = bias_a[jj] * kLog2e, bb = bias_b[jj] * kLog2e;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        // sum over the quad: every lane ends with the same bits
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 1);
        part[o] += __shfl_xor_sync(0xffffffffu, part[o], 2);
        s[o][jj] = jj < valid ? fmaf(part[o], a.scale2, (o & 1) ? bb : ba) : -INFINITY;
      }
    }

    // fold the chunk into the running maxima and sums
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      float m = row_max[o];
#pragma unroll
      for (int jj = 0; jj < Jc; ++jj) m = fmaxf(m, s[o][jj]);
      const float c_old = exp2f(row_max[o] - m);  // 0 on the first chunk
      row_max[o] = m;
      denom[o] *= c_old;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        acc[o][i].x *= c_old;
        acc[o][i].y *= c_old;
        acc[o][i].z *= c_old;
        acc[o][i].w *= c_old;
      }
    }
#pragma unroll
    for (int jj = 0; jj < Jc; ++jj) {
      float p[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        p[o] = exp2f(s[o][jj] - row_max[o]);
        denom[o] += p[o];
      }
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const int x = jj * (D / 4) + tq + 4 * i;
        const float4 vxa = va[x], vxb = vb[x];
        axpy4(p[0], vxa, acc[0][i]);
        axpy4(p[1], vxb, acc[1][i]);
        axpy4(p[2], vxa, acc[2][i]);
        axpy4(p[3], vxb, acc[3][i]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int l = l0 + r0 + (o >> 1);
    const int n = n0 + ((o & 1) ? pb : pa);
    if (l >= a.L || n >= a.BH) continue;
    const float inv = 1.0f / denom[o];
    float4* dst = reinterpret_cast<float4*>(a.out + pair[o & 1].out + static_cast<long long>(l) * a.H * D);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const float4 x = acc[o][i];
      dst[tq + 4 * i] = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
    }
  }
}

template <int D>
cudaError_t launch(Args a, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = &gathered_attention_kernel<D>;
  const size_t smem = 2 * sizeof(float) * Stage<D>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = a.n_tiles * ((a.BH + kPairs - 1) / kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- The chunked tensor-core design (bf16x3; the others at L > 128 or
// D = 64) ---------------------------------------------------------------------

namespace tc {

constexpr int kPairs = 16;   // (b, h) pairs per block: the M of the relative term's products
constexpr int kRows = 16;    // query rows per block: the M of q.k and p.v
constexpr int kWarps = 16;   // warp w: row l0 + w of the relative term, then pair n0 + w's rows
constexpr int kThreads = 32 * kWarps;
static_assert(kWarps == kPairs && kWarps == kRows, "one pair and one query row per warp");

// Floats between two pairs' rows in the staged q tile (16 mod 32).
template <int D>
constexpr int kQPair = kRows * D + 16;

// A multi-pass instance of bf16 parts splits each operand once (the note at
// the top). TF32x3, whose split-once form ran 1-6% slower in this body than
// splitting at each mma (device.cuh's mma_split; PERF.md §6), keeps that
// here, past the resident design.
template <Arith A, int D>
constexpr bool kSplitOnce = kParts<A> > 1 && kBF16Parts<A>;
// n-tiles whose products interleave (device.cuh's products) in the relative
// term and q.k, at most
constexpr int kGroupMax = 4;

// Whether the row stride of K and e_lr (product, product_once) and of V
// (p . v) is hidden from the optimiser (opaque): for bf16x9, whose groups'
// row offsets, held across the loop, spilled otherwise (4-6% slower
// without), and K's for TF32x3 (1-4% faster with it); bf16x3 and bf16x6
// ran 5-9% slower with it (PERF.md §6).
template <Arith A>
constexpr bool kHideKStride = A == Arith::BF16x9 || A == Arith::TF32x3;
template <Arith A>
constexpr bool kHideVStride = A == Arith::BF16x9;

// q's bf16 planes (kSplitOnce): a part's rows of D bf16 values, 32-bit words
// apart by kQRowWords (8 or 24 mod 32) and pairs by kQPairWords (8 mod 32),
// so that the 8-byte fragment loads of a half-warp, rows g of a pair or
// pairs g of a row, fall on distinct banks
template <int D>
constexpr int kQRowWords = D / 2 + ((D / 2) % 16 == 0 ? 8 : 0);
template <int D>
constexpr int kQPairWords = kRows * kQRowWords<D> + 8;

// The chunk of keys, and the offsets (floats) into dynamic shared memory:
// two buffers of the relative term's (pair, row, key) values, then the
// block's q tile, 16 pairs x 16 rows (kSplitOnce: a plane of q per part, as
// above).
template <int D, Arith A>
struct Smem {
  static constexpr int kKeys = D <= 32 ? 32 : 16;  // keys per chunk
  static constexpr int kRelRow = kKeys % 16 == 0 ? kKeys + 8 : kKeys;  // 8 mod 16
  static constexpr int kRelPair = kRows * kRelRow + 8;                 // 8 mod 32
  static constexpr int kRelBuf = kPairs * kRelPair;
  static constexpr int kQ = 2 * kRelBuf;
  static constexpr int kQPlane = kPairs * kQPairWords<D>;
  static constexpr int kFloats = kQ + (kSplitOnce<A, D> ? kParts<A> * kQPlane : kPairs * kQPair<D>);
};

// Columns 16c + 4t .. 16c + 4t + 3 of row `row` of the (rows, D) matrix at
// `base` in global memory, rows `stride` floats apart; zero for a row past
// `rows`.
template <int D>
__device__ __forceinline__ float4 columns(const float* base, int stride, int rows, int row, int c, int t) {
  return row < rows ? __ldg(reinterpret_cast<const float4*>(base + row * stride + 16 * c + 4 * t))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Staged q rows are D floats; odd rows have their 16-float halves swapped
// (D >= 32), and pairs are 16 mod 32 floats apart, so that the float4
// fragment loads of an 8-lane phase, rows g and g + 1 of a pair or pairs g
// and g + 1 of a row, fall on 32 distinct banks.
template <int D>
__device__ __forceinline__ int q_offset(int pair, int row, int f) {
  return pair * kQPair<D> + row * D + 4 * (f ^ (D >= 32 ? 4 * (row & 1) : 0));
}

// The A fragments (held values, device.cuh's held) of a 16-row operand whose
// rows g and g + 8 hold the float4 pieces u(c) and w(c) (columns 16c + 4t ..
// 16c + 4t + 3). The products sum over d, so a k-step may take any 8
// columns that A and B share: k-step 2c + h takes columns 16c + 4t + 2h
// (k = t) and 16c + 4t + 2h + 1 (k = t + 4), and each lane reads its columns
// as float4s.
template <Arith A>
__device__ __forceinline__ void a_fragments(uint32_t (&f0)[4], uint32_t (&f1)[4], const float4 u, const float4 w) {
  f0[0] = held<A>(u.x);
  f0[1] = held<A>(w.x);
  f0[2] = held<A>(u.y);
  f0[3] = held<A>(w.y);
  f1[0] = held<A>(u.z);
  f1[1] = held<A>(w.z);
  f1[2] = held<A>(u.w);
  f1[3] = held<A>(w.w);
}

// The A fragments of a 16-row operand of the staged q tile `qs` whose rows
// g and g + 8 are (pair p0, row r0) and (p1, r1).
template <int D, Arith A>
__device__ __forceinline__ void q_fragments(uint32_t (&f)[D / 8][4], const float* qs, int p0, int r0, int p1,
                                            int r1, int t) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 u = *reinterpret_cast<const float4*>(qs + q_offset<D>(p0, r0, 4 * c + t));
    const float4 w = *reinterpret_cast<const float4*>(qs + q_offset<D>(p1, r1, 4 * c + t));
    a_fragments<A>(f[2 * c], f[2 * c + 1], u, w);
  }
}

// c += A . B^T over D, this lane's B row row `row` of the (rows, D) matrix at
// `base` (rows `stride` floats apart; k-steps as in a_fragments).
template <int D, Arith A>
__device__ __forceinline__ void product(float (&c)[4], const uint32_t (&a)[D / 8][4], const float* base,
                                        int stride, int rows, int row, int t) {
  float4 y[D / 16];
  const int st = kHideKStride<A> ? opaque(stride) : stride;
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) y[cc] = columns<D>(base, st, rows, row, cc, t);
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) {
    mma_split<A>(c, a[2 * cc], held<A>(y[cc].x), held<A>(y[cc].y));
    mma_split<A>(c, a[2 * cc + 1], held<A>(y[cc].z), held<A>(y[cc].w));
  }
}

// kSplitOnce: A's chunk kc (every part, into w) of q's 16-row operand
// whose rows g and g + 8 are (pair p0, row r0) and (p1, r1), loaded from the
// planes at `qp` as products asks for it. Chunk kc takes columns
// 16 kc + 4t .. 16 kc + 4t + 3 as q_fragments does: k = 2t, 2t + 1 are
// columns 16 kc + 4t, + 1 and k = 2t + 8, 2t + 9 columns 16 kc + 4t + 2, + 3.
template <int D, Arith A>
struct QChunks {
  const float* qp;
  int p0, r0, p1, r1, t;
  __device__ __forceinline__ void operator()(int kc, uint32_t (&w)[kParts<A>][4]) const {
#pragma unroll
    for (int i = 0; i < kParts<A>; ++i) {
      const uint32_t* x = reinterpret_cast<const uint32_t*>(qp + i * Smem<D, A>::kQPlane) + 8 * kc + 2 * t;
      const uint2 u = *reinterpret_cast<const uint2*>(x + p0 * kQPairWords<D> + r0 * kQRowWords<D>);
      const uint2 v = *reinterpret_cast<const uint2*>(x + p1 * kQPairWords<D> + r1 * kQRowWords<D>);
      w[i][0] = u.x, w[i][1] = v.x, w[i][2] = u.y, w[i][3] = v.y;
    }
  }
};

// kSplitOnce: c[n] += A . B^T over D for G n-tiles, the lane's B row of
// n-tile n row j0 + 8 n + g of the (rows, D) matrix at `base` in global
// memory (rows `stride` floats apart), each B chunk split once as it is
// loaded (columns as QChunks).
template <int D, Arith A, int G>
__device__ __forceinline__ void product_once(float (*c)[4], const QChunks<D, A>& a, const float* base,
                                             int stride, int rows, int j0, int g, int t) {
  products<A, G, D / 16>(c, a, [&](int kc, int n, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
    // a plain load, not __ldg's: the compiler does not hoist it past the
    // fence below (hoisted, every group's loads spilled at 128 registers)
    const int row = j0 + 8 * n + g, st = kHideKStride<A> ? opaque(stride) : stride;
    const float4 y = row < rows ? *reinterpret_cast<const float4*>(base + row * st + 16 * kc + 4 * t)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    split4<A>(b, y.x, y.y, y.z, y.w);
  });
  __syncwarp();  // group by group
}

// V's columns as p . v's n-tiles take them: n-tile dn's column g is
// 8W (dn / W) + W g + dn % W, W = min(4, D / 8), so that each lane reads W
// consecutive columns of a key's row, and writes W consecutive columns of out.
template <int D>
struct VCols {
  static constexpr int kW = D / 8 < 4 ? D / 8 : 4;
  static constexpr int kBlocks = D / (8 * kW);
};

// W consecutive floats of global memory at p, or zeros where `live` is false;
// a plain load (PLAIN), which ptxas does not hoist past a __syncwarp, or
// __ldg's.
template <int W, bool PLAIN = false>
__device__ __forceinline__ void load_cols(float (&x)[W], const float* p, bool live) {
  if constexpr (W == 4) {
    const float4 u = !live ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                     : PLAIN ? *reinterpret_cast<const float4*>(p) : __ldg(reinterpret_cast<const float4*>(p));
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else {
    const float2 u = !live ? make_float2(0.0f, 0.0f)
                     : PLAIN ? *reinterpret_cast<const float2*>(p) : __ldg(reinterpret_cast<const float2*>(p));
    x[0] = u.x, x[1] = u.y;
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// Stores p . v's accumulators o of rows l0 + g and l0 + g + 8 of pair n
// (o[W hb + dd][2 i + e] is row l0 + g + 8 i, column 8W hb + W (2t + e) + dd),
// each scaled by inv[i] and rounded as the instance's output; nothing for a
// row past L.
template <int D, Arith A>
__device__ __forceinline__ void store_rows(const Args& a, int n, int l0, const float (&o)[D / 8][4],
                                           const float (&inv)[2], int g, int t) {
  using V = VCols<D>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = l0 + g + 8 * i;
    if (row >= a.L) continue;
    float* dst = out_row<D>(a, n, row);
#pragma unroll
    for (int hb = 0; hb < V::kBlocks; ++hb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[V::kW];
#pragma unroll
        for (int dd = 0; dd < V::kW; ++dd) x[dd] = output<A>(o[V::kW * hb + dd][2 * i + e] * inv[i]);
        store_cols(dst + 8 * V::kW * hb + V::kW * (2 * t + e), x);
      }
    }
  }
}

template <int D, Arith A>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, A>;
  constexpr bool kOnce = kSplitOnce<A, D>;
  constexpr int kGroup = kGroupMax < S::kKeys / 8 ? kGroupMax : S::kKeys / 8;
  using V = VCols<D>;
  constexpr int kKS = D / 8;           // k-steps of q.k and the relative term, n-tiles of p.v
  constexpr int kNT = S::kKeys / 8;    // key n-tiles per chunk
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int l0 = (blockIdx.x % a.n_tiles) * kRows;
  const int n0 = (blockIdx.x / a.n_tiles) * kPairs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The warp's pair; past B * H its q, K and V read as zeros and nothing is stored
  const int n = n0 + warp;
  const bool live = n < a.BH;
  const int keys = live ? a.L : 0;  // K and V rows the warp reads
  const long long head = live ? head_of(a, n) : 0;
  const float* kp = a.k + head;
  const float* vp = a.v + head;
  const float* bias = a.bias + static_cast<long long>(live ? n / a.H : 0) * a.L;
  const int lr = l0 + warp;  // the warp's row of the relative term
  const int rel_keys = lr < a.L ? a.L : 0;
  const float* e_row = a.e_lr + static_cast<size_t>(rel_keys ? lr : 0) * a.L * D;  // e_lr[lr]: (L, D)

  // The block's q tile, rows l0.. of pairs n0.., staged once: q.k's A
  // operand is pair `warp`'s 16 rows, the relative term's row `warp` of the
  // 16 pairs, both loaded per chunk, so that no q register lives across the
  // loop (512 threads have 128 registers each)
  float* qs = smem + S::kQ;
#pragma unroll 1
  for (int i = threadIdx.x; i < kPairs * kRows * (D / 4); i += kThreads) {
    const int p = i / (kRows * (D / 4)), r = i / (D / 4) % kRows, f = i % (D / 4);
    const bool in = n0 + p < a.BH && l0 + r < a.L;
    const float* src = a.q + (in ? head_of(a, n0 + p) + (l0 + r) * a.sl + 4 * f : 0);
    if constexpr (kOnce) {  // q's parts, split once for the block
      const float4 u = in ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      uint32_t w[kParts<A>][2];
      split4<A>(w, u.x, u.y, u.z, u.w);
#pragma unroll
      for (int j = 0; j < kParts<A>; ++j) {
        *reinterpret_cast<uint2*>(qs + j * S::kQPlane + p * kQPairWords<D> + r * kQRowWords<D> + 2 * f) =
            make_uint2(w[j][0], w[j][1]);
      }
    } else if (in) {
      cp_async16(qs + q_offset<D>(p, r, f), src);
    } else {
      *reinterpret_cast<float4*>(qs + q_offset<D>(p, r, f)) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[kKS][4];  // p.v's accumulators: rows g, g + 8, columns as VCols orders them
#pragma unroll
  for (int dn = 0; dn < kKS; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};

  const int n_chunks = (a.L + S::kKeys - 1) / S::kKeys;
  // every instance but TF32 rounds or splits the normalised P: with several
  // chunks, pass 0 finds each row's maximum and sum first; item i is chunk
  // i % n_chunks of pass first_pass + i / n_chunks
  constexpr bool kNormalised = A != Arith::TF32;
  const bool stats_pass = kNormalised && n_chunks > 1;
  const int first_pass = stats_pass ? 0 : 1;
  const int n_items = (2 - first_pass) * n_chunks;
  // Row lr of item i's relative term for the block's 16 pairs, into rel
  // buffer i % 2 as [pair][row][key]: the pairs are the m16n8k8 tile's rows,
  // the chunk's keys its columns. Past the last item it computes chunk 0
  // again, which nothing reads.
  auto relative_term = [&](int i) {
    const int j0 = (i % n_chunks) * S::kKeys;
    float* buf = smem + (i & 1) * S::kRelBuf;
    if constexpr (kOnce) {
      const QChunks<D, A> qa{qs, g, warp, g + 8, warp, t};  // row `warp` of the 16 pairs
#pragma unroll
      for (int nt = 0; nt < kNT; nt += kGroup) {
        float acc[kGroup][4];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
        product_once<D, A, kGroup>(acc, qa, e_row, D, rel_keys, j0 + 8 * nt, g, t);
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          float* d = buf + g * S::kRelPair + warp * S::kRelRow + 8 * (nt + n) + 2 * t;
          *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(acc[n][2], acc[n][3]);
        }
      }
    } else {
      uint32_t qr[kKS][4];
      q_fragments<D, A>(qr, qs, g, warp, g + 8, warp, t);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        product<D, A>(acc, qr, e_row, D, rel_keys, j0 + 8 * nt + g, t);
        float* d = buf + g * S::kRelPair + warp * S::kRelRow + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(d) = make_float2(output<A>(acc[0]), output<A>(acc[1]));
        *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(output<A>(acc[2]), output<A>(acc[3]));
      }
    }
  };

  relative_term(0);
#pragma unroll 1
  for (int it = 0; it < n_items; ++it) {
    const int pass = first_pass + it / n_chunks, c = it % n_chunks, j0 = c * S::kKeys;
    const float* rel = smem + (it & 1) * S::kRelBuf;
    // item it's relative term is in rel buffer it % 2; every warp is done
    // with the other buffer, which the next item's relative term fills,
    // interleaved by the compiler with this item's work below
    __syncthreads();
    relative_term(it + 1);

    // S = rel + Q . K^T; then scale and bias, in log2 units
    auto scale_bias = [&](float (&sn)[4], int nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 8 * nt + 2 * t + e;
        const float bias2 = col < a.L ? __ldg(bias + col) * kLog2e : -INFINITY;
        sn[e] = fmaf(sn[e], a.scale2, bias2);
        sn[2 + e] = fmaf(sn[2 + e], a.scale2, bias2);
      }
    };
    uint32_t qf[kOnce ? 1 : kKS][4];
    if constexpr (!kOnce) q_fragments<D, A>(qf, qs, warp, g, warp, g + 8, t);
    const QChunks<D, A> qa{qs, warp, g, warp, g + 8, t};  // kOnce: pair `warp`'s 16 rows
    // n-tile nt's relative term: the first value of its score accumulators,
    // or, under kRoundsOutput, added once Q . K^T is rounded
    auto rel_of = [&](float (&r)[4], int nt) {
      const float* p = rel + warp * S::kRelPair + g * S::kRelRow + 8 * nt + 2 * t;
      const float2 r0 = *reinterpret_cast<const float2*>(p);
      const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * S::kRelRow);
      r[0] = r0.x, r[1] = r0.y, r[2] = r1.x, r[3] = r1.y;
    };
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (!kRoundsOutput<A>) {
        rel_of(s[nt], nt);
      } else {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      }
      if constexpr (kOnce) {
        // a group's products once its n-tiles' rel values are in
        if (nt % kGroup == kGroup - 1) {
          const int n0 = nt - kGroup + 1;
          product_once<D, A, kGroup>(&s[n0], qa, kp, a.sl, keys, j0 + 8 * n0, g, t);
#pragma unroll
          for (int n = 0; n < kGroup; ++n) scale_bias(s[n0 + n], n0 + n);
        }
      } else {
        product<D, A>(s[nt], qf, kp, a.sl, keys, j0 + 8 * nt + g, t);
        if constexpr (kRoundsOutput<A>) {
          float r[4];
          rel_of(r, nt);
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nt][i] = output<A>(s[nt][i]) + r[i];
        }
        scale_bias(s[nt], nt);
      }
    }

    float rescale[2];
    if (!kNormalised) {
      fold(s, m, l, rescale);  // online: P unnormalised, the output rescaled
#pragma unroll
      for (int dn = 0; dn < kKS; ++dn) {
        o[dn][0] *= rescale[0];
        o[dn][1] *= rescale[0];
        o[dn][2] *= rescale[1];
        o[dn][3] *= rescale[1];
      }
    } else if (pass == 0 || !stats_pass) {
      fold(s, m, l, rescale);  // the stats pass; or the only chunk, which holds every key
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = exp2f(s[nt][i] - m[i / 2]);
      }
    }
    if (kNormalised && pass == 1) {
      if (c == 0) {
        inv[0] = 1.0f / quad_sum(l[0]);
        inv[1] = 1.0f / quad_sum(l[1]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] *= inv[i / 2];
      }
    }

    if (pass == 1) {
      if constexpr (kOnce) {
        // p . v by 16 keys: P's parts from two n-tiles' accumulators (p_chunk),
        // V's rows 2t, 2t + 1, 8 + 2t, 9 + 2t of them split once as loaded;
        // the products of each block of W output n-tiles interleave
#pragma unroll
        for (int kc = 0; kc < kNT / 2; ++kc) {
          uint32_t pa[1][kParts<A>][4 * kSteps<A>];
          p_chunk<A>(pa, s[2 * kc], s[2 * kc + 1]);
          const int key = j0 + 16 * kc + 2 * t, sl = kHideVStride<A> ? opaque(a.sl) : a.sl;
          const float* v0 = vp + key * sl + V::kW * g;
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            float x[4][V::kW];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int dr = (r & 1) + 8 * (r >> 1);  // key, key + 1, key + 8, key + 9
              load_cols(x[r], v0 + dr * sl + 8 * V::kW * hb, key + dr < keys);
            }
            products<A, V::kW, 1>(&o[V::kW * hb], HeldChunks<A, 1>{pa},
                                  [&](int, int dd, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
                                    split4<A>(b, x[0][dd], x[1][dd], x[2][dd], x[3][dd]);
                                  });
            __syncwarp();  // block by block
          }
        }
      } else {
        // p . v: key n-tile nt as one k-step, its keys in the order 2t, 2t + 1
        // (lane t's a0/a1 and a2/a3 columns) for P and V alike
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t pa[4] = {held<A>(s[nt][0]), held<A>(s[nt][2]), held<A>(s[nt][1]), held<A>(s[nt][3])};
          const int key = j0 + 8 * nt + 2 * t, sl = kHideVStride<A> ? opaque(a.sl) : a.sl;
          const float* v0 = vp + key * sl + V::kW * g;
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            float x0[V::kW], x1[V::kW];
            load_cols(x0, v0 + 8 * V::kW * hb, key < keys);
            load_cols(x1, v0 + sl + 8 * V::kW * hb, key + 1 < keys);
#pragma unroll
            for (int dd = 0; dd < V::kW; ++dd) {
              mma_split<A>(o[V::kW * hb + dd], pa, held<A>(x0[dd]), held<A>(x1[dd]));
            }
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
  store_rows<D, A>(a, n, l0, o, inv, g, t);
}

}  // namespace tc

// ---- The resident tensor-core design (TF32, bf16, the multi-pass instances
// but bf16x3, and the 16-bit ones at L <= 128 and D <= 32; the note at the
// top) -------------------------------------------------------------------------

namespace rs {

constexpr int kWarps = 16;                 // warp w: row w of the relative term, then pair w's rows
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 16;                 // pairs per block and item: the M of the relative term's products
constexpr int kRows = 16;                  // query rows per item: the M of q.k and p.v
constexpr int kMaxL = 128;                 // the longest sequence: every key's scores in registers
constexpr int kRelGroup = 4;               // e_lr n-tiles whose loads are in flight at once, per warp
constexpr int kLoadGroup = 4;              // K or V n-tiles whose loads are in flight at once, per warp
constexpr int kChunkNT = 8;                // n-tiles (of 8 keys) whose scores a warp holds in registers
// The multi-pass instances' (TF32x3, bf16x6, bf16x9; the note at the top):
// their operands split once (kSplitOnce; else at each mma, device.cuh's
// mma_split), their scores held 64 keys at a time at KEYS = 128 and 32 at
// KEYS = 64, e_lr loaded and multiplied by groups of four n-tiles, K and V
// of two (q's and P's parts take the registers), but V by four in the
// bf16-part instances at KEYS = 128
template <Arith A>
constexpr bool kSplitOnce = kParts<A> > 1;
constexpr int kMPChunkNT = 8;              // at KEYS = 128
constexpr int kMPChunkNTShort = 4;         // at KEYS = 64
constexpr int kMPRelGroup = 4;
constexpr int kMPKGroup = 2;
constexpr int kMPVGroup = 2;               // even: p.v takes 16 keys a chunk
constexpr int kBPVGroup = 4;               // bf16x6's and bf16x9's at KEYS = 128
template <Arith A, int KEYS>
constexpr int kChunkNTOf = kParts<A> == 1 ? kChunkNT : KEYS == kMaxL ? kMPChunkNT : kMPChunkNTShort;
template <Arith A>
constexpr int kRelGroupOf = kParts<A> > 1 ? kMPRelGroup : kRelGroup;
template <Arith A>
constexpr int kKGroupOf = kParts<A> > 1 ? kMPKGroup : kLoadGroup;
template <Arith A, int KEYS>
constexpr int kVGroupOf = kParts<A> == 1 ? kLoadGroup : kBF16Parts<A> && KEYS == kMaxL ? kBPVGroup : kMPVGroup;

// Offsets (floats) into dynamic shared memory: the relative term's store
// rel[pair][row][key] (rows KEYS + 8 floats apart, pairs 16 (KEYS + 8) + 8,
// both 8 mod 32), then two stages, the item's and the next one's, each a q
// tile and the 16 pairs' bias rows (KEYS floats apart; read as staged: a
// bias read from L2 at its use was hoisted by ptxas for every key at once,
// and spilled).
template <int D, int KEYS>
struct Smem {
  static constexpr int kRelRow = KEYS + 8;
  static constexpr int kRelPair = kRows * kRelRow + 8;
  static constexpr int kQTile = kPairs * tc::kQPair<D>;
  static constexpr int kBias = kQTile;                 // in a stage
  static constexpr int kStage = kQTile + kPairs * KEYS;
  static constexpr int kStages = kPairs * kRelPair;
  static constexpr int kFloats = kStages + 2 * kStage;
  static_assert(4 * kFloats <= 232448, "the store and two stages fit a block");
};

// The first of the 16 pairs of item `item`.
__device__ __forceinline__ int first_pair(const Args& a, int item) {
  return (item / a.n_tiles) * kPairs;
}

// Issues the copies of a stage of the block's pairs in `item`: the q tile
// (rows l0.. of its 16 pairs, tc::q_offset's layout; zeros past L and
// B * H) and each pair's bias row (keys below L, of pairs below B * H: no
// other entry is read).
template <int D, int KEYS>
__device__ __forceinline__ void stage_item(float* st, const Args& a, int item) {
  const int l0 = (item % a.n_tiles) * kRows;
  const int n0 = first_pair(a, item);
#pragma unroll 1
  for (int i = threadIdx.x; i < kPairs * kRows * (D / 4); i += kThreads) {
    const int p = i / (kRows * (D / 4)), r = i / (D / 4) % kRows, f = i % (D / 4);
    float* dst = st + tc::q_offset<D>(p, r, f);
    if (n0 + p < a.BH && l0 + r < a.L) {
      cp_async16(dst, a.q + head_of(a, n0 + p) + (l0 + r) * a.sl + 4 * f);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < kPairs * a.L; i += kThreads) {
    const int p = i / a.L, j = i % a.L;
    if (n0 + p < a.BH) {
      cp_async4(st + Smem<D, KEYS>::kBias + p * KEYS + j, a.bias + static_cast<long long>((n0 + p) / a.H) * a.L + j);
    }
  }
}

template <int D, Arith A, int KEYS>
__device__ __forceinline__ void attention(const Args& a) {
  using S = Smem<D, KEYS>;
  using V = tc::VCols<D>;
  constexpr int kKS = D / 8;    // k-steps of q.k and q.e_lr, n-tiles of p.v
  constexpr int kKC = D / 16;   // chunks of q.k and q.e_lr of the multi-pass parts (device.cuh's kSteps)
  constexpr int kNT = KEYS / 8;  // key n-tiles of a row's scores
  constexpr int kCNT = kChunkNTOf<A, KEYS>, kRG = kRelGroupOf<A>, kKG = kKGroupOf<A>, kVG = kVGroupOf<A, KEYS>;
  constexpr int kChunks = kNT / kCNT;  // chunks of keys whose scores a warp holds at once
  static_assert(kNT % kRG == 0 && kCNT % kKG == 0 && kCNT % kVG == 0 && kVG % 2 == 0 && kNT % kCNT == 0,
                "whole groups");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stages = smem + S::kStages;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int first = blockIdx.x, stride = gridDim.x;  // the block's first item, and the blocks

  if (first < a.n_items) stage_item<D, KEYS>(stages, a, first);
  cp_async_commit();
  int it = 0;
#pragma unroll 1
  for (int item = first; item < a.n_items; item += stride, ++it) {
    const float* qs = stages + (it & 1) * S::kStage;  // the item's q tile, then its bias rows
    cp_async_wait<0>();
    // the item's stage has landed; every warp is done with the last item's
    // store and stage, which the next copies now refill
    __syncthreads();
    if (item + stride < a.n_items) {
      stage_item<D, KEYS>(stages + ((it + 1) & 1) * S::kStage, a, item + stride);
    }
    cp_async_commit();
    const int l0 = (item % a.n_tiles) * kRows;

    // The relative term of row lr = l0 + warp for 16 pairs, every key below
    // L at once: Q_lr . e_lr[lr]^T, the pairs the m16n8k8 tile's rows, keys
    // its columns
    const int lr = l0 + warp;
    if (lr < a.L) {
      uint32_t qr[kKS][4];  // rows g and g + 8: pairs g and g + 8 at row lr
      tc::q_fragments<D, A>(qr, qs, g, warp, g + 8, warp, t);
      const float* e_row = a.e_lr + static_cast<size_t>(lr) * a.L * D;
      float* dst = smem + g * S::kRelPair + warp * S::kRelRow + 2 * t;
      const int n_used = (a.L + 7) / 8;  // key n-tiles that reach a key below L
      uint32_t qa[kSplitOnce<A> ? kKC : 1][kParts<A>][4 * kSteps<A>];  // multi-pass: qr's parts
      if constexpr (kSplitOnce<A>) split_fragments<A, kKC>(qa, qr);
#pragma unroll 1
      for (int nt0 = 0; nt0 < n_used; nt0 += kRG) {
        float4 y[kRG][D / 16];
#pragma unroll
        for (int n = 0; n < kRG; ++n) {
#pragma unroll
          for (int cc = 0; cc < D / 16; ++cc) y[n][cc] = tc::columns<D>(e_row, D, a.L, 8 * (nt0 + n) + g, cc, t);
        }
        if constexpr (kSplitOnce<A>) {
          // multi-pass: each chunk of e_lr split as loaded, the group's products
          // interleaved (device.cuh's products)
          float acc[kRG][4] = {};
          products<A, kRG, kKC>(acc, HeldChunks<A, kKC>{qa},
                                [&](int kc, int n, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
                                  split4<A>(b, y[n][kc].x, y[n][kc].y, y[n][kc].z, y[n][kc].w);
                                });
#pragma unroll
          for (int n = 0; n < kRG; ++n) {
            float* d = dst + 8 * (nt0 + n);
            *reinterpret_cast<float2*>(d) = make_float2(acc[n][0], acc[n][1]);
            *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(acc[n][2], acc[n][3]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < kRG; ++n) {
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int cc = 0; cc < D / 16; ++cc) {
              mma_split<A>(acc, qr[2 * cc], held<A>(y[n][cc].x), held<A>(y[n][cc].y));
              mma_split<A>(acc, qr[2 * cc + 1], held<A>(y[n][cc].z), held<A>(y[n][cc].w));
            }
            float* d = dst + 8 * (nt0 + n);
            *reinterpret_cast<float2*>(d) = make_float2(output<A>(acc[0]), output<A>(acc[1]));
            *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(output<A>(acc[2]), output<A>(acc[3]));
          }
        }
      }
    }
    __syncthreads();  // every relative term of the item is in the store

    const int n = first_pair(a, item) + warp;  // the warp's pair
    if (n >= a.BH) continue;  // warp-uniform: nothing to compute
    const long long head = head_of(a, n);
    const float* kp = a.k + head;
    const float* vp = a.v + head;
    const float* bias = qs + S::kBias + warp * KEYS;  // the pair's, staged

    // This lane's slots of the store: rows g and g + 8 of the warp's pair,
    // n-tile nt's columns 2t and 2t + 1 at rp + 8 nt and rp + 8 kRelRow +
    // 8 nt, read (the relative term) and rewritten (parked scores) by this
    // lane alone
    float* rp = smem + warp * S::kRelPair + g * S::kRelRow + 2 * t;
    const auto load2 = [&](float (&r)[4], int nt) {
      const float2 r0 = *reinterpret_cast<const float2*>(rp + 8 * nt);
      const float2 r1 = *reinterpret_cast<const float2*>(rp + 8 * S::kRelRow + 8 * nt);
      r[0] = r0.x, r[1] = r0.y, r[2] = r1.x, r[3] = r1.y;
    };
    uint32_t qf[kKS][4];  // pair `warp`'s rows g and g + 8
    tc::q_fragments<D, A>(qf, qs, warp, g, warp, g + 8, t);
    uint32_t qa[kSplitOnce<A> ? kKC : 1][kParts<A>][4 * kSteps<A>];  // multi-pass: qf's parts, once per item
    if constexpr (kSplitOnce<A>) split_fragments<A, kKC>(qa, qf);

    // S = rel + Q . K^T (under kRoundsOutput Q . K^T rounded first, then rel
    // added); then scale and bias, in log2 units; keys past L -inf. The
    // scores of one chunk of kCNT n-tiles (64 keys; the multi-pass
    // instances' 32 at KEYS = 64) at a time are held in registers; the
    // chunks before the last are parked in the store, over their relative
    // term (held for every key, 64 score registers spilled at 128 a thread)
    float s[kCNT][4];
    float mx[2] = {-INFINITY, -INFINITY};
    // a loop, not unrolled: unrolled over the chunks, ptxas held every
    // chunk's invariants (columns, predicates) across the item loop and
    // spilled
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int n0 = 0; n0 < kCNT; n0 += kKG) {
        float4 y[kKG][D / 16];
        const int sl = opaque(a.sl);
#pragma unroll
        for (int n = 0; n < kKG; ++n) {
          const int row = 8 * (kCNT * c + n0 + n) + g;
#pragma unroll
          for (int cc = 0; cc < D / 16; ++cc) {
            // plain loads, which ptxas does not hoist past the fence below
            y[n][cc] = row < a.L ? *reinterpret_cast<const float4*>(kp + row * sl + 16 * cc + 4 * t)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
        if constexpr (kSplitOnce<A>) {
          // multi-pass: the group's accumulators start at their relative term and
          // take q.k's products of parts, each chunk of K split as loaded,
          // the group's products interleaved
#pragma unroll
          for (int n = 0; n < kKG; ++n) load2(s[n0 + n], kCNT * c + n0 + n);
          products<A, kKG, kKC>(&s[n0], HeldChunks<A, kKC>{qa},
                                [&](int kc, int n, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
                                  split4<A>(b, y[n][kc].x, y[n][kc].y, y[n][kc].z, y[n][kc].w);
                                });
        }
#pragma unroll
        for (int n = 0; n < kKG; ++n) {
          const int nt = kCNT * c + n0 + n;
          float* sn = s[n0 + n];
          float r[4];
          if constexpr (!kSplitOnce<A>) {
            load2(r, nt);
#pragma unroll
            for (int i = 0; i < 4; ++i) sn[i] = kRoundsOutput<A> ? 0.0f : r[i];
#pragma unroll
            for (int cc = 0; cc < D / 16; ++cc) {
              mma_split<A>(s[n0 + n], qf[2 * cc], held<A>(y[n][cc].x), held<A>(y[n][cc].y));
              mma_split<A>(s[n0 + n], qf[2 * cc + 1], held<A>(y[n][cc].z), held<A>(y[n][cc].w));
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kRoundsOutput<A>) sn[i] = output<A>(sn[i]) + r[i];
            const int col = 8 * nt + 2 * t + i % 2;
            // the store's columns past L hold no relative term: scored -inf outright
            sn[i] = col < a.L ? fmaf(sn[i], a.scale2, bias[col] * kLog2e) : -INFINITY;
          }
          mx[0] = fmaxf(mx[0], fmaxf(sn[0], sn[1]));
          mx[1] = fmaxf(mx[1], fmaxf(sn[2], sn[3]));
          if (c + 1 < kChunks) {  // parked
            *reinterpret_cast<float2*>(rp + 8 * nt) = make_float2(sn[0], sn[1]);
            *reinterpret_cast<float2*>(rp + 8 * S::kRelRow + 8 * nt) = make_float2(sn[2], sn[3]);
          }
        }
        __syncwarp();  // group by group
      }
    }

    // Softmax over the whole row: exact maxima and sums (the parked chunks'
    // exponentials taken again where P is made, with the same bits); P
    // normalised, then rounded as p.v's operand (JAX's einsum takes the
    // softmax's output as its operand)
    constexpr int kParked = kNT - kCNT;  // n-tiles of the parked chunks
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kCNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i / 2]);
        sum[i / 2] += s[n][i];
      }
    }
#pragma unroll 4
    for (int nt = 0; nt < kParked; ++nt) {
      float r[4];
      load2(r, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i / 2] += exp2f(r[i] - mx[i / 2]);
    }
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};

    // p . v: key n-tile nt as one k-step, its keys in the order 2t, 2t + 1
    // (lane t's a0/a1 and a2/a3 columns) for P and V alike; V's rows past L
    // read as zeros (P is 0 there). The parked chunks' P from the store, in
    // a loop over their groups of n-tiles, the last chunk's from registers.
    float o[kKS][4];
#pragma unroll
    for (int dn = 0; dn < kKS; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
    // p.v over the group of kVG n-tiles from nt0, P of its n-tile n by p_of(n, p)
    const auto pv_group = [&](int nt0, auto p_of) {
      float x[kVG][2][V::kBlocks][V::kW];
      const int sl = opaque(a.sl);
#pragma unroll
      for (int n = 0; n < kVG; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * (nt0 + n) + 2 * t + e;
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            tc::load_cols<V::kW, true>(x[n][e][hb], vp + key * sl + V::kW * g + 8 * V::kW * hb, key < a.L);
          }
        }
      }
      if constexpr (kSplitOnce<A>) {
        // multi-pass: P's parts once per 16 keys (two n-tiles' accumulators,
        // device.cuh's p_chunk), V's split as loaded, the products of the
        // output n-tiles interleaved
#pragma unroll
        for (int m = 0; m < kVG / 2; ++m) {
          float p0[4], p1[4];
          p_of(2 * m, p0);
          p_of(2 * m + 1, p1);
          uint32_t pa[1][kParts<A>][4 * kSteps<A>];
          p_chunk<A>(pa, p0, p1);
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            products<A, V::kW, 1>(&o[V::kW * hb], HeldChunks<A, 1>{pa},
                                  [&](int, int dd, uint32_t (&b)[kParts<A>][2 * kSteps<A>]) {
                                    split4<A>(b, x[2 * m][0][hb][dd], x[2 * m][1][hb][dd], x[2 * m + 1][0][hb][dd],
                                              x[2 * m + 1][1][hb][dd]);
                                  });
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < kVG; ++n) {
          float p[4];
          p_of(n, p);
          const uint32_t pa[4] = {held<A>(p[0]), held<A>(p[2]), held<A>(p[1]), held<A>(p[3])};
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
#pragma unroll
            for (int dd = 0; dd < V::kW; ++dd) {
              mma_split<A>(o[V::kW * hb + dd], pa, held<A>(x[n][0][hb][dd]), held<A>(x[n][1][hb][dd]));
            }
          }
        }
      }
      __syncwarp();  // group by group
    };
#pragma unroll 1
    for (int nt0 = 0; nt0 < kParked; nt0 += kVG) {
      pv_group(nt0, [&](int n, float (&p)[4]) {
        load2(p, nt0 + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = exp2f(p[i] - mx[i / 2]) * inv[i / 2];
      });
    }
#pragma unroll
    for (int n0 = 0; n0 < kCNT; n0 += kVG) {
      pv_group(kParked + n0, [&](int n, float (&p)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = s[n0 + n][i] * inv[i / 2];
      });
    }
    const float one[2] = {1.0f, 1.0f};  // P was normalised
    tc::store_rows<D, A>(a, n, l0, o, one, g, t);
  }
}

// ---- The resident design's bf16 instances: 16-bit operands on m16n8k16 ------

// The bf16 and bf16bf16 instances run attention_half in the resident design
// (the note at the top), with the body above's load groups and score
// chunks; the others keep the body above.
template <Arith A>
constexpr bool kHalfBody = A == Arith::BF16 || A == Arith::BF16BF16;

// The A fragments, as A's 16-bit pairs, of a 16-row operand of the staged q
// tile whose rows g and g + 8 are (pair p0, row r0) and (p1, r1): chunk c
// (one m16n8k16) takes columns 16 c + 4t .. 16 c + 4t + 3, the first two as
// k = 2t, 2t + 1 and the last two as k = 2t + 8, 2t + 9, as b_pair's B
// fragments take them (the products sum over d: any order that A and B
// share), so that every lane reads its columns as float4s.
template <int D, Arith A>
__device__ __forceinline__ void q_pairs(uint32_t (&f)[D / 16][4], const float* qs, int p0, int r0, int p1, int r1,
                                        int t) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 u = *reinterpret_cast<const float4*>(qs + tc::q_offset<D>(p0, r0, 4 * c + t));
    const float4 w = *reinterpret_cast<const float4*>(qs + tc::q_offset<D>(p1, r1, 4 * c + t));
    f[c][0] = pack16<A>(u.x, u.y);
    f[c][1] = pack16<A>(w.x, w.y);
    f[c][2] = pack16<A>(u.z, u.w);
    f[c][3] = pack16<A>(w.z, w.w);
  }
}

// c += A . B^T over one chunk of 16 values, this lane's B values y (columns
// 16 c + 4t .. 16 c + 4t + 3 of its row), each rounded to A's type here.
template <Arith A>
__device__ __forceinline__ void mma_chunk(float (&c)[4], const uint32_t (&a)[4], const float4 y) {
  mma16<A>(c, a, pack16<A>(y.x, y.y), pack16<A>(y.z, y.w));
}

// The bf16 instances (BF16, BF16BF16) of the resident design on 16-bit
// operands: every product one m16n8k16 on the bf16 tensor cores, each
// operand rounded to bf16 once: q's rows into A fragments once per item
// (the row-warp's 16 pairs, then the pair-warp's 16 rows), e_lr's, K's and
// V's B values as they are loaded from L2 (each enters one mma per item:
// the value serves the tile's 16 pairs or rows), P per 16 keys from two
// n-tiles' accumulators, an m16n8k16 A fragment as they lie. BF16: the
// relative term float32 in the store, each score accumulator seeded with
// it; BF16BF16: q.e_lr and q.k each from a zero accumulator, each rounded
// to bf16 on its own, then summed in float32, and p.v's output rounded at
// the store. Scale, bias and the exact row statistics in float32, as the
// body above takes them.
template <int D, Arith A, int KEYS>
__device__ __forceinline__ void attention_half(const Args& a) {
  using S = Smem<D, KEYS>;
  using V = tc::VCols<D>;
  constexpr int kKC = D / 16;    // chunks of q.k and q.e_lr: one m16n8k16 each
  constexpr int kDT = D / 8;     // n-tiles of p.v
  constexpr int kNT = KEYS / 8;  // key n-tiles of a row's scores
  constexpr int kCNT = kChunkNT;
  constexpr int kChunks = kNT / kCNT;  // chunks of keys whose scores a warp holds at once
  static_assert(kNT % kRelGroup == 0 && kCNT % kLoadGroup == 0 && kLoadGroup % 2 == 0 && kNT % kCNT == 0,
                "whole groups");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stages = smem + S::kStages;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int first = blockIdx.x, stride = gridDim.x;  // the block's first item, and the blocks

  if (first < a.n_items) stage_item<D, KEYS>(stages, a, first);
  cp_async_commit();
  int it = 0;
#pragma unroll 1
  for (int item = first; item < a.n_items; item += stride, ++it) {
    const float* qs = stages + (it & 1) * S::kStage;  // the item's q tile, then its bias rows
    cp_async_wait<0>();
    // the item's stage has landed; every warp is done with the last item's
    // store and stage, which the next copies now refill
    __syncthreads();
    if (item + stride < a.n_items) {
      stage_item<D, KEYS>(stages + ((it + 1) & 1) * S::kStage, a, item + stride);
    }
    cp_async_commit();
    const int l0 = (item % a.n_tiles) * kRows;

    // The relative term of row lr = l0 + warp for 16 pairs, every key below
    // L at once: Q_lr . e_lr[lr]^T, the pairs the m16n8k16 tile's rows, keys
    // its columns; rounded to bf16 (BF16BF16) or not (BF16) into the store
    const int lr = l0 + warp;
    if (lr < a.L) {
      uint32_t qr[kKC][4];  // rows g and g + 8: pairs g and g + 8 at row lr
      q_pairs<D, A>(qr, qs, g, warp, g + 8, warp, t);
      const float* e_row = a.e_lr + static_cast<size_t>(lr) * a.L * D;
      float* dst = smem + g * S::kRelPair + warp * S::kRelRow + 2 * t;
      const int n_used = (a.L + 7) / 8;  // key n-tiles that reach a key below L
#pragma unroll 1
      for (int nt0 = 0; nt0 < n_used; nt0 += kRelGroup) {
        float4 y[kRelGroup][kKC];
#pragma unroll
        for (int n = 0; n < kRelGroup; ++n) {
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) y[n][cc] = tc::columns<D>(e_row, D, a.L, 8 * (nt0 + n) + g, cc, t);
        }
#pragma unroll
        for (int n = 0; n < kRelGroup; ++n) {
          float qe[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) mma_chunk<A>(qe, qr[cc], y[n][cc]);
          float* d = dst + 8 * (nt0 + n);
          *reinterpret_cast<float2*>(d) = make_float2(output<A>(qe[0]), output<A>(qe[1]));
          *reinterpret_cast<float2*>(d + 8 * S::kRelPair) = make_float2(output<A>(qe[2]), output<A>(qe[3]));
        }
      }
    }
    __syncthreads();  // every relative term of the item is in the store

    const int n = first_pair(a, item) + warp;  // the warp's pair
    if (n >= a.BH) continue;  // warp-uniform: nothing to compute
    const long long head = head_of(a, n);
    const float* kp = a.k + head;
    const float* vp = a.v + head;
    const float* bias = qs + S::kBias + warp * KEYS;  // the pair's, staged

    // This lane's slots of the store, as in the body above
    float* rp = smem + warp * S::kRelPair + g * S::kRelRow + 2 * t;
    const auto load2 = [&](float (&r)[4], int nt) {
      const float2 r0 = *reinterpret_cast<const float2*>(rp + 8 * nt);
      const float2 r1 = *reinterpret_cast<const float2*>(rp + 8 * S::kRelRow + 8 * nt);
      r[0] = r0.x, r[1] = r0.y, r[2] = r1.x, r[3] = r1.y;
    };
    uint32_t qf[kKC][4];  // pair `warp`'s rows g and g + 8
    q_pairs<D, A>(qf, qs, warp, g, warp, g + 8, t);

    // S = rel + Q . K^T (BF16BF16: Q . K^T from zero, rounded, then rel
    // added); then scale and bias, in log2 units; keys past L -inf. The
    // scores of one chunk of kCNT n-tiles at a time in registers, the
    // chunks before the last parked in the store over their relative term
    float s[kCNT][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int n0 = 0; n0 < kCNT; n0 += kLoadGroup) {
        float4 y[kLoadGroup][kKC];
        const int sl = opaque(a.sl);
#pragma unroll
        for (int n = 0; n < kLoadGroup; ++n) {
          const int row = 8 * (kCNT * c + n0 + n) + g;
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) {
            // plain loads, which ptxas does not hoist past the fence below
            y[n][cc] = row < a.L ? *reinterpret_cast<const float4*>(kp + row * sl + 16 * cc + 4 * t)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
#pragma unroll
        for (int n = 0; n < kLoadGroup; ++n) {
          const int nt = kCNT * c + n0 + n;
          float* sn = s[n0 + n];
          float r[4];
          load2(r, nt);
#pragma unroll
          for (int i = 0; i < 4; ++i) sn[i] = kRoundsOutput<A> ? 0.0f : r[i];
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) mma_chunk<A>(s[n0 + n], qf[cc], y[n][cc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kRoundsOutput<A>) sn[i] = output<A>(sn[i]) + r[i];
            const int col = 8 * nt + 2 * t + i % 2;
            // the store's columns past L hold no relative term: scored -inf outright
            sn[i] = col < a.L ? fmaf(sn[i], a.scale2, bias[col] * kLog2e) : -INFINITY;
          }
          mx[0] = fmaxf(mx[0], fmaxf(sn[0], sn[1]));
          mx[1] = fmaxf(mx[1], fmaxf(sn[2], sn[3]));
          if (c + 1 < kChunks) {  // parked
            *reinterpret_cast<float2*>(rp + 8 * nt) = make_float2(sn[0], sn[1]);
            *reinterpret_cast<float2*>(rp + 8 * S::kRelRow + 8 * nt) = make_float2(sn[2], sn[3]);
          }
        }
        __syncwarp();  // group by group
      }
    }

    // Softmax over the whole row: exact maxima and sums (the parked chunks'
    // exponentials taken again where P is made, with the same bits); P
    // normalised, then rounded as p.v's operand
    constexpr int kParked = kNT - kCNT;  // n-tiles of the parked chunks
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kCNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - mx[i / 2]);
        sum[i / 2] += s[n][i];
      }
    }
#pragma unroll 4
    for (int nt = 0; nt < kParked; ++nt) {
      float r[4];
      load2(r, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i / 2] += exp2f(r[i] - mx[i / 2]);
    }
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};

    // p . v by 16 keys: P of n-tiles 2m and 2m + 1 (rows g, g + 8, keys 2t,
    // 2t + 1 of each: the A fragment's words as they lie), V's rows 2t,
    // 2t + 1 and 8 + 2t, 9 + 2t of the 16 keys its B values (rows past L
    // read as zeros, P is 0 there), each output n-tile's columns as
    // tc::VCols permutes them. The parked chunks' P from the store, the
    // last chunk's from registers.
    float o[kDT][4];
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
    // p.v over the group of kLoadGroup n-tiles from nt0, P of its n-tile n by p_of(n, p)
    const auto pv_group = [&](int nt0, auto p_of) {
      float x[kLoadGroup][2][V::kBlocks][V::kW];
      const int sl = opaque(a.sl);
#pragma unroll
      for (int n = 0; n < kLoadGroup; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * (nt0 + n) + 2 * t + e;
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            tc::load_cols<V::kW, true>(x[n][e][hb], vp + key * sl + V::kW * g + 8 * V::kW * hb, key < a.L);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kLoadGroup / 2; ++m) {
        float p0[4], p1[4];
        p_of(2 * m, p0);
        p_of(2 * m + 1, p1);
        const uint32_t pa[4] = {pack16<A>(p0[0], p0[1]), pack16<A>(p0[2], p0[3]), pack16<A>(p1[0], p1[1]),
                                pack16<A>(p1[2], p1[3])};
#pragma unroll
        for (int hb = 0; hb < V::kBlocks; ++hb) {
#pragma unroll
          for (int dd = 0; dd < V::kW; ++dd) {
            mma16<A>(o[V::kW * hb + dd], pa, pack16<A>(x[2 * m][0][hb][dd], x[2 * m][1][hb][dd]),
                     pack16<A>(x[2 * m + 1][0][hb][dd], x[2 * m + 1][1][hb][dd]));
          }
        }
      }
      __syncwarp();  // group by group
    };
#pragma unroll 1
    for (int nt0 = 0; nt0 < kParked; nt0 += kLoadGroup) {
      pv_group(nt0, [&](int n, float (&p)[4]) {
        load2(p, nt0 + n);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = exp2f(p[i] - mx[i / 2]) * inv[i / 2];
      });
    }
#pragma unroll
    for (int n0 = 0; n0 < kCNT; n0 += kLoadGroup) {
      pv_group(kParked + n0, [&](int n, float (&p)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = s[n0 + n][i] * inv[i / 2];
      });
    }
    const float one[2] = {1.0f, 1.0f};  // P was normalised
    tc::store_rows<D, A>(a, n, l0, o, one, g, t);
  }
}

// ---- The resident design's f64 instance: float64 products on DMMA -----------

constexpr int kF64RelGroup = 4;   // e_lr n-tiles whose loads are in flight at once, per warp
constexpr int kF64KGroup = 2;     // K n-tiles whose loads are in flight at once
constexpr int kF64VGroup = 2;     // V n-tiles whose loads are in flight at once (even: p.v takes 16 keys)
constexpr int kF64ChunkNT = 4;    // n-tiles (of 8 keys) whose scores a warp holds in registers

// Values 16 c + 4t .. 16 c + 4t + 3 of row (pair p, row r) of the staged q
// tile (tc::q_offset's layout), widened.
template <int D>
__device__ __forceinline__ void q_chunk(double (&x)[4], const float* qs, int p, int r, int c, int t) {
  f64::widen(x, *reinterpret_cast<const float4*>(qs + tc::q_offset<D>(p, r, 4 * c + t)));
}

// The f64 instance (F64_F64_F64) of the resident design, on the FP64 tensor
// cores: the relative term as float64 products over pairs at a fixed row,
// rounded to float32 into the store; then each pair-warp's q.k in float64,
// rounded to float32, plus the stored relative term in float32; exact row
// statistics; P normalised, widened exactly, and p.v in float64, rounded to
// float32 once at the store. e_lr, K and V are widened as their fragments
// are loaded from L2 (each value enters one mma: a B value serves the 16
// rows or pairs of the tile), q's chunks once per item from the staged tile.
template <int D, int KEYS>
__device__ __forceinline__ void attention_f64(const Args& a) {
  using S = Smem<D, KEYS>;
  using V = tc::VCols<D>;
  constexpr int kKC = D / 16;    // chunks of q.k and q.e_lr
  constexpr int kKS = D / 8;     // n-tiles of p.v
  constexpr int kNT = KEYS / 8;  // key n-tiles of a row's scores
  constexpr int kChunks = kNT / kF64ChunkNT;
  static_assert(kNT % kF64RelGroup == 0 && kF64ChunkNT % kF64KGroup == 0 && kF64ChunkNT % kF64VGroup == 0 &&
                    kF64VGroup % 2 == 0 && kNT % kF64ChunkNT == 0, "whole groups");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* stages = smem + S::kStages;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int first = blockIdx.x, stride = gridDim.x;  // the block's first item, and the blocks

  if (first < a.n_items) stage_item<D, KEYS>(stages, a, first);
  cp_async_commit();
  int it = 0;
#pragma unroll 1
  for (int item = first; item < a.n_items; item += stride, ++it) {
    const float* qs = stages + (it & 1) * S::kStage;  // the item's q tile, then its bias rows
    cp_async_wait<0>();
    // the item's stage has landed; every warp is done with the last item's
    // store and stage, which the next copies now refill
    __syncthreads();
    if (item + stride < a.n_items) {
      stage_item<D, KEYS>(stages + ((it + 1) & 1) * S::kStage, a, item + stride);
    }
    cp_async_commit();
    const int l0 = (item % a.n_tiles) * kRows;

    // The relative term of row lr = l0 + warp for 16 pairs, every key below
    // L at once: Q_lr . e_lr[lr]^T in float64, the pairs the tile's rows,
    // keys its columns, each rounded to float32
    const int lr = l0 + warp;
    if (lr < a.L) {
      double qr[kKC][2][4];  // pairs g and g + 8 at row lr
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        q_chunk<D>(qr[c][0], qs, g, warp, c, t);
        q_chunk<D>(qr[c][1], qs, g + 8, warp, c, t);
      }
      const float* e_row = a.e_lr + static_cast<size_t>(lr) * a.L * D;
      float* dst = smem + g * S::kRelPair + warp * S::kRelRow + 2 * t;
      const int n_used = (a.L + 7) / 8;  // key n-tiles that reach a key below L
#pragma unroll 1
      for (int nt0 = 0; nt0 < n_used; nt0 += kF64RelGroup) {
        float4 y[kF64RelGroup][kKC];
#pragma unroll
        for (int n = 0; n < kF64RelGroup; ++n) {
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) y[n][cc] = tc::columns<D>(e_row, D, a.L, 8 * (nt0 + n) + g, cc, t);
        }
        double acc[kF64RelGroup][4] = {};
#pragma unroll
        for (int cc = 0; cc < kKC; ++cc) {
#pragma unroll
          for (int n = 0; n < kF64RelGroup; ++n) {
            double b[4];
            f64::widen(b, y[n][cc]);
            f64::dmma_chunk(acc[n], qr[cc][0], qr[cc][1], b);
          }
        }
#pragma unroll
        for (int n = 0; n < kF64RelGroup; ++n) {
          float* d = dst + 8 * (nt0 + n);
          *reinterpret_cast<float2*>(d) = make_float2(static_cast<float>(acc[n][0]), static_cast<float>(acc[n][1]));
          *reinterpret_cast<float2*>(d + 8 * S::kRelPair) =
              make_float2(static_cast<float>(acc[n][2]), static_cast<float>(acc[n][3]));
        }
      }
    }
    __syncthreads();  // every relative term of the item is in the store

    const int n = first_pair(a, item) + warp;  // the warp's pair
    if (n >= a.BH) continue;  // warp-uniform: nothing to compute
    const long long head = head_of(a, n);
    const float* kp = a.k + head;
    const float* vp = a.v + head;
    const float* bias = qs + S::kBias + warp * KEYS;  // the pair's, staged

    // This lane's slots of the store (rows g and g + 8, n-tile nt's columns
    // 2t and 2t + 1), read (the relative term) and rewritten (parked
    // scores) by this lane alone, as in attention
    float* rp = smem + warp * S::kRelPair + g * S::kRelRow + 2 * t;
    const auto load2 = [&](float (&r)[4], int nt) {
      const float2 r0 = *reinterpret_cast<const float2*>(rp + 8 * nt);
      const float2 r1 = *reinterpret_cast<const float2*>(rp + 8 * S::kRelRow + 8 * nt);
      r[0] = r0.x, r[1] = r0.y, r[2] = r1.x, r[3] = r1.y;
    };
    double qf[kKC][2][4];  // pair `warp`'s rows g and g + 8
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      q_chunk<D>(qf[c][0], qs, warp, g, c, t);
      q_chunk<D>(qf[c][1], qs, warp, g + 8, c, t);
    }

    // S = round(Q . K^T) + rel in float32, then scale and bias, in log2
    // units; keys past L -inf. kF64ChunkNT n-tiles of scores at a time in
    // registers, the chunks before the last parked in the store
    float s[kF64ChunkNT][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int n0 = 0; n0 < kF64ChunkNT; n0 += kF64KGroup) {
        float4 y[kF64KGroup][kKC];
        const int sl = opaque(a.sl);
#pragma unroll
        for (int n = 0; n < kF64KGroup; ++n) {
          const int row = 8 * (kF64ChunkNT * c + n0 + n) + g;
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) {
            // plain loads, which ptxas does not hoist past the fence below
            y[n][cc] = row < a.L ? *reinterpret_cast<const float4*>(kp + row * sl + 16 * cc + 4 * t)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
        double acc[kF64KGroup][4] = {};
#pragma unroll
        for (int cc = 0; cc < kKC; ++cc) {
#pragma unroll
          for (int n = 0; n < kF64KGroup; ++n) {
            double b[4];
            f64::widen(b, y[n][cc]);
            f64::dmma_chunk(acc[n], qf[cc][0], qf[cc][1], b);
          }
        }
#pragma unroll
        for (int n = 0; n < kF64KGroup; ++n) {
          const int nt = kF64ChunkNT * c + n0 + n;
          float* sn = s[n0 + n];
          float r[4];
          load2(r, nt);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * nt + 2 * t + i % 2;
            // the store's columns past L hold no relative term: scored -inf outright
            sn[i] = col < a.L ? fmaf(static_cast<float>(acc[n][i]) + r[i], a.scale2, bias[col] * kLog2e) : -INFINITY;
          }
          mx[0] = fmaxf(mx[0], fmaxf(sn[0], sn[1]));
          mx[1] = fmaxf(mx[1], fmaxf(sn[2], sn[3]));
          if (c + 1 < kChunks) {  // parked
            *reinterpret_cast<float2*>(rp + 8 * nt) = make_float2(sn[0], sn[1]);
            *reinterpret_cast<float2*>(rp + 8 * S::kRelRow + 8 * nt) = make_float2(sn[2], sn[3]);
          }
        }
        __syncwarp();  // group by group
      }
    }

    // Softmax over the whole row: exact maxima and sums (the parked chunks'
    // exponentials taken again where P is made, with the same bits); P
    // normalised in float32, then widened exactly
    constexpr int kParked = kNT - kF64ChunkNT;  // n-tiles of the parked chunks
    mx[0] = quad_max(mx[0]);  // finite: key 0 is below L
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kF64ChunkNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp2f(s[nt][i] - mx[i / 2]);
        sum[i / 2] += s[nt][i];
      }
    }
#pragma unroll 4
    for (int nt = 0; nt < kParked; ++nt) {
      float r[4];
      load2(r, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i / 2] += exp2f(r[i] - mx[i / 2]);
    }
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};

    // p . v by 16 keys: P of rows g and g + 8 at keys 2t, 2t + 1 of two
    // n-tiles as they lie, V's rows at the same keys (their columns as
    // tc::VCols permutes them, read as W-float vectors); V's rows past L
    // read as zeros (P is 0 there). The parked chunks' P from the store,
    // the last chunk's from registers
    double o[kKS][4] = {};
    // p.v over the kF64VGroup n-tiles from nt0, P of its n-tile n by p_of(n, p)
    const auto pv_group = [&](int nt0, auto p_of) {
      float x[kF64VGroup][2][V::kBlocks][V::kW];
      const int sl = opaque(a.sl);
#pragma unroll
      for (int n = 0; n < kF64VGroup; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * (nt0 + n) + 2 * t + e;
#pragma unroll
          for (int hb = 0; hb < V::kBlocks; ++hb) {
            tc::load_cols<V::kW, true>(x[n][e][hb], vp + key * sl + V::kW * g + 8 * V::kW * hb, key < a.L);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kF64VGroup / 2; ++m) {
        float pa[4], pb[4];
        p_of(2 * m, pa);
        p_of(2 * m + 1, pb);
        const float p0[4] = {pa[0], pa[1], pb[0], pb[1]}, p8[4] = {pa[2], pa[3], pb[2], pb[3]};
#pragma unroll
        for (int hb = 0; hb < V::kBlocks; ++hb) {
#pragma unroll
          for (int dd = 0; dd < V::kW; ++dd) {
            const double bv[4] = {x[2 * m][0][hb][dd], x[2 * m][1][hb][dd], x[2 * m + 1][0][hb][dd],
                                  x[2 * m + 1][1][hb][dd]};
            f64::dmma_chunk(o[V::kW * hb + dd], p0, p8, bv);
          }
        }
      }
      __syncwarp();  // group by group
    };
#pragma unroll 1
    for (int nt0 = 0; nt0 < kParked; nt0 += kF64VGroup) {
      pv_group(nt0, [&](int nn, float (&p)[4]) {
        load2(p, nt0 + nn);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = exp2f(p[i] - mx[i / 2]) * inv[i / 2];
      });
    }
#pragma unroll
    for (int n0 = 0; n0 < kF64ChunkNT; n0 += kF64VGroup) {
      pv_group(kParked + n0, [&](int nn, float (&p)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = s[n0 + nn][i] * inv[i / 2];
      });
    }
    float o32[kKS][4];  // rounded to float32 once
#pragma unroll
    for (int dn = 0; dn < kKS; ++dn) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o32[dn][i] = static_cast<float>(o[dn][i]);
    }
    const float one[2] = {1.0f, 1.0f};  // P was normalised
    tc::store_rows<D, Arith::F64>(a, n, l0, o32, one, g, t);
  }
}

}  // namespace rs

// KEYS 64 or 128: the resident design for L <= KEYS; KEYS 0: the chunked one.
template <int D, Arith A, int KEYS>
__device__ __forceinline__ void tc_attention(const Args& a) {
  if constexpr (KEYS > 0 && rs::kHalfBody<A>) {
    rs::attention_half<D, A, KEYS>(a);
  } else if constexpr (KEYS > 0) {
    rs::attention<D, A, KEYS>(a);
  } else {
    tc::attention<D, A>(a);
  }
}

static_assert(rs::kThreads == tc::kThreads, "both designs run blocks of 16 warps");

// One __global__ function per arithmetic, named as ops/attention.py's
// CudaLibrary.kernel_name names the instance.
template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_tf32_kernel(const Args a) {
  tc_attention<D, Arith::TF32, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16_kernel(const Args a) {
  tc_attention<D, Arith::BF16, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_tf32x3_kernel(const Args a) {
  tc_attention<D, Arith::TF32x3, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16x3_kernel(const Args a) {
  tc_attention<D, Arith::BF16x3, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16x6_kernel(const Args a) {
  tc_attention<D, Arith::BF16x6, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16x9_kernel(const Args a) {
  tc_attention<D, Arith::BF16x9, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_f16_kernel(const Args a) {
  tc_attention<D, Arith::F16, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_f16f16_kernel(const Args a) {
  tc_attention<D, Arith::F16F16, KEYS>(a);
}

template <int D, int KEYS>
__global__ void __launch_bounds__(tc::kThreads, 1) gathered_attention_bf16bf16_kernel(const Args a) {
  tc_attention<D, Arith::BF16BF16, KEYS>(a);
}

// The f64 instance: at KEYS 64 or 128 the resident design on the FP64
// tensor cores (rs::attention_f64, one block of 16 warps per SM); at KEYS 0
// (L > 128 or D = 64, no shipped configuration) device.cuh's float64 FMA
// design, the relative term from e_lr
template <int KEYS>
using F64Args = std::conditional_t<KEYS == 0, f64::Args, Args>;

template <int D, int KEYS>
__global__ void __launch_bounds__(KEYS ? rs::kThreads : f64::kThreads, KEYS ? 1 : f64::kBlocks<D>)
gathered_attention_f64_kernel(const F64Args<KEYS> a) {
  if constexpr (KEYS > 0) {
    rs::attention_f64<D, KEYS>(a);
  } else {
    f64::attention<D, true, false>(a);
  }
}

template <Arith A, int D, int KEYS>
constexpr auto tc_kernel() {
  if constexpr (A == Arith::TF32) {
    return &gathered_attention_tf32_kernel<D, KEYS>;
  } else if constexpr (A == Arith::BF16) {
    return &gathered_attention_bf16_kernel<D, KEYS>;
  } else if constexpr (A == Arith::TF32x3) {
    return &gathered_attention_tf32x3_kernel<D, KEYS>;
  } else if constexpr (A == Arith::BF16x3) {
    return &gathered_attention_bf16x3_kernel<D, KEYS>;
  } else if constexpr (A == Arith::BF16x6) {
    return &gathered_attention_bf16x6_kernel<D, KEYS>;
  } else if constexpr (A == Arith::BF16x9) {
    return &gathered_attention_bf16x9_kernel<D, KEYS>;
  } else if constexpr (A == Arith::F16) {
    return &gathered_attention_f16_kernel<D, KEYS>;
  } else if constexpr (A == Arith::F16F16) {
    return &gathered_attention_f16f16_kernel<D, KEYS>;
  } else {
    static_assert(A == Arith::BF16BF16, "a tensor-core arithmetic");
    return &gathered_attention_bf16bf16_kernel<D, KEYS>;
  }
}

// The resident design: persistent blocks, one per SM, walking
// ceil(BH / 16) x n_tiles items.
template <int D, Arith A, int KEYS>
cudaError_t launch_resident(Args a, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = tc_kernel<A, D, KEYS>();
  const size_t smem = sizeof(float) * rs::Smem<D, KEYS>::kFloats;
  cudaError_t err = attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long items = (a.BH + rs::kPairs - 1) / rs::kPairs * a.n_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.n_items = static_cast<int>(items);
  int sms = 0;
  if ((err = attn::sm_count(device, &sms)) != cudaSuccess) return err;
  const int blocks = a.n_items < sms ? a.n_items : sms;
  kernel<<<blocks, rs::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instances that run the resident design up to L = 128 at D <= 32: the
// single-rounding ones, TF32x3, bf16x6 and bf16x9
template <Arith A>
constexpr bool kResident = kParts<A> == 1 || A == Arith::TF32x3 || A == Arith::BF16x6 || A == Arith::BF16x9;

template <int D, Arith A>
cudaError_t launch_tc(Args a, int device, cudaStream_t stream) {
  // the resident design where it runs; the chunked one for bf16x3, longer
  // sequences and D = 64 (no shipped configuration)
  if constexpr (D <= 32 && kResident<A>) {
    if (a.L <= rs::kMaxL) {
      return a.L <= rs::kMaxL / 2 ? launch_resident<D, A, rs::kMaxL / 2>(a, device, stream)
                                  : launch_resident<D, A, rs::kMaxL>(a, device, stream);
    }
  }
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = tc_kernel<A, D, 0>();
  const size_t smem = sizeof(float) * tc::Smem<D, A>::kFloats;
  const cudaError_t err =
      attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = a.n_tiles * ((a.BH + tc::kPairs - 1) / tc::kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), tc::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The f64 instance's resident design: persistent blocks, one per SM,
// walking ceil(BH / 16) x n_tiles items.
template <int D, int KEYS>
cudaError_t launch_f64_resident(Args a, int device, cudaStream_t stream) {
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const auto kernel = &gathered_attention_f64_kernel<D, KEYS>;
  const size_t smem = sizeof(float) * rs::Smem<D, KEYS>::kFloats;
  cudaError_t err = attn::opt_in_smem(reinterpret_cast<const void*>(kernel), granted, device, smem);
  if (err != cudaSuccess) return err;
  const long long items = (a.BH + rs::kPairs - 1) / rs::kPairs * a.n_tiles;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  a.n_items = static_cast<int>(items);
  int sms = 0;
  if ((err = attn::sm_count(device, &sms)) != cudaSuccess) return err;
  const int blocks = a.n_items < sms ? a.n_items : sms;
  kernel<<<blocks, rs::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The f64 instance over (B, H, L, D) views: out is the (B, L, H, D) buffer.
// The resident design up to L = 128 at D <= 32; the float64 FMA design
// beyond.
template <int D>
cudaError_t launch_f64(const Args& a, int device, cudaStream_t stream) {
  if constexpr (D <= 32) {
    if (a.L <= rs::kMaxL) {
      return a.L <= rs::kMaxL / 2 ? launch_f64_resident<D, rs::kMaxL / 2>(a, device, stream)
                                  : launch_f64_resident<D, rs::kMaxL>(a, device, stream);
    }
  }
  static std::atomic<size_t> granted[attn::kMaxDevices];
  const size_t smem = sizeof(double) * f64::Smem<D, false>::kDoubles;
  const cudaError_t err = attn::opt_in_smem(
      reinterpret_cast<const void*>(&gathered_attention_f64_kernel<D, 0>), granted, device, smem);
  if (err != cudaSuccess) return err;
  const f64::Args f{a.q, a.k, a.v, a.bias, a.e_lr, a.out, a.sb, a.sh, static_cast<long long>(a.sl),
                    static_cast<long long>(a.L) * a.H * D, D, static_cast<long long>(a.H) * D,
                    a.H, a.L, 0, a.BH, (a.L + f64::kRows - 1) / f64::kRows, a.scale2};
  const long long blocks = f.n_tiles * ((a.BH + f64::kPairs - 1) / f64::kPairs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gathered_attention_f64_kernel<D, 0><<<static_cast<unsigned>(blocks), f64::kThreads, smem, stream>>>(f);
  return cudaGetLastError();
}

// instance: 0 FMA, 1 TF32, 2 bf16, 3 TF32x3, 4 bf16x3, 5 bf16x6, 6 bf16x9,
// 7 f64, 8 f16, 9 f16f16, 10 bf16bf16 (see the note at the top)
template <int D>
cudaError_t dispatch_instance(const Args& a, int instance, int device, cudaStream_t s) {
  if constexpr (!kBuiltHeadDim<D>) {
    return cudaErrorInvalidValue;  // not a head size of this library's part (launch.cuh)
  } else {
    switch (instance) {
      case 0: if constexpr (kBuiltInstance<0>) return launch<D>(a, device, s); break;
      case 1: if constexpr (kBuiltInstance<1>) return launch_tc<D, Arith::TF32>(a, device, s); break;
      case 2: if constexpr (kBuiltInstance<2>) return launch_tc<D, Arith::BF16>(a, device, s); break;
      case 3: if constexpr (kBuiltInstance<3>) return launch_tc<D, Arith::TF32x3>(a, device, s); break;
      case 4: if constexpr (kBuiltInstance<4>) return launch_tc<D, Arith::BF16x3>(a, device, s); break;
      case 5: if constexpr (kBuiltInstance<5>) return launch_tc<D, Arith::BF16x6>(a, device, s); break;
      case 6: if constexpr (kBuiltInstance<6>) return launch_tc<D, Arith::BF16x9>(a, device, s); break;
      case 7: if constexpr (kBuiltInstance<7>) return launch_f64<D>(a, device, s); break;
      case 8: if constexpr (kBuiltInstance<8>) return launch_tc<D, Arith::F16>(a, device, s); break;
      case 9: if constexpr (kBuiltInstance<9>) return launch_tc<D, Arith::F16F16>(a, device, s); break;
      case 10: if constexpr (kBuiltInstance<10>) return launch_tc<D, Arith::BF16BF16>(a, device, s); break;
      default: break;
    }
    return cudaErrorInvalidValue;  // not an instance of this library's part (launch.cuh)
  }
}

}  // namespace

// q, k, v: (B, H, L, D) float32 views that share the (batch, head, row)
// strides sb, sh, sl in floats (the last dimension has stride 1), every row
// 16-byte aligned. out: a contiguous (B, L, H, D) buffer. e_lr: the
// contiguous (L, L, D) tensor, 16-byte aligned. `instance` picks the
// arithmetic: 0 FMA, 1 TF32, 2 bf16, 3-6 the multi-pass presets TF32x3,
// bf16x3, bf16x6, bf16x9, 7 f64, 8-10 the 16-bit presets f16, f16f16,
// bf16bf16. `device` is the index of the device that holds the tensors and
// `stream`.
extern "C" int gathered_attention_forward(const float* q, const float* k, const float* v,
                                          const float* bias, const float* e_lr, float* out,
                                          long long sb, long long sh, long long sl, int B, int H, int L,
                                          int D, int instance, int device, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.e_lr = e_lr;
  a.out = out;
  a.sb = sb;
  a.sh = sh;
  a.sl = static_cast<int>(sl);
  a.H = H;
  a.L = L;
  a.BH = static_cast<long long>(B) * H;
  a.n_tiles = (L + kRows - 1) / kRows;
  a.scale2 = kLog2e / sqrtf(static_cast<float>(D));
  return attn::on_device(device, [&] {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
      case 16: return dispatch_instance<16>(a, instance, device, s);
      case 32: return dispatch_instance<32>(a, instance, device, s);
      case 64: return dispatch_instance<64>(a, instance, device, s);
      default: return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* gathered_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
