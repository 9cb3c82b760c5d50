// Walk-step and selection kernels for Hopper (sm_90a): one random-walk
// transition per walker over a flat CSR graph (rejection, alias, flat-bias
// ITS, window-bias ITS), and ITS selection of K of P candidates with
// bipartite region search (a warp an instance for K <= 32 and P <= 4096,
// and for any other K and P each row split over many blocks).
//
// Each kernel computes what a Pallas TPU kernel of src/repro/kernels/
// computes, bit for bit, and is held against its plain PyTorch version in
// repro_torch/kernels/ref.py.  The TPU kernels DMA two max_seg-aligned
// blocks around each row and gather ids through an f32 one-hot reduction;
// both are TPU artifacts.  Here every walk kernel reads its walker's row
// [start, start + min(deg, cap)) directly and gathers the int32 id directly,
// which equals the reference for every id (the TPU kernels only below 2^24).
//
// What bounds them: bytes of random gathers, and for the three step kernels
// the counted hash as well.  A walker's row sits at a data-dependent offset
// in arrays far larger than L2, so each draw costs a few 32-byte sectors of
// device memory; the f32 arithmetic is a handful of operations per gathered
// word.  The designs therefore keep gathers to the minimum each method needs
// (rejection: one bias word per round and one id, stopping at the first
// acceptance; alias: two table words and one id; ITS: the row once), and
// launch enough walkers to keep many gathers in flight.  The step kernels
// (reject_step, alias_step, walk_step) each serve every cohort of their
// method in one launch and hash their walkers' counted uniforms themselves:
// threefry2x32 is about 75 32-bit integer operations per uniform, so a
// rejection round costs about 150 integer operations beside its one bias
// word, and the hash is of the same order as the gathers: both count in
// the bound.  The exception is its_select, which reads whole dense rows: it
// is bound by those bytes, and stages them into shared memory
// asynchronously so that the next rows load while the current one is
// scanned.
//
// Bit hazards: the build passes -fmad=false, and the products and
// differences that must round on their own use __fmul_rn / __fsub_rn /
// __fadd_rn, so no multiply-add contracts into an FMA.  Float to int is
// truncation, as XLA's astype(int32).
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kScanBlock = 16;  // XLA-CPU's scan block width
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLadder = 4;    // repro_torch/kernels/walk_step.py:MAX_LADDER
constexpr int kRejectIters = 8;  // repro_torch/kernels/ref.py:REJECT_ITERS

// -- counted RNG ----------------------------------------------------------------

struct Key {
  uint32_t k0, k1;
};

// The keys a step kernel hashes under, key j of walker i: one set for every
// walker of the launch (a single walk: ValueKeys, by value, derived on the
// host), or one set a row of a batch of R rows of `width` walkers
// (TableKeys: a device table of R x N keys from derive_keys_kernel, as
// jax.vmap over the rows gives them), or one set a depth for a batch of
// queue entries that each carry their depth and instance (EntryKeys: the
// sharded drain, whose batches mix depths).  Walker i of a row hashes at its
// index within the row, i - row * width, under its row's keys; entry i
// hashes at its instance under its depth's keys.  The rejection rounds are
// N = 2 * kRejectIters keys: round t's slot uniform under key 2t, its accept
// uniform under key 2t + 1 (fold_in(fold_in(step key, 2), j)).
template <int N>
struct ValueKeys {
  Key k[N];
  __device__ __forceinline__ int row(int) const { return 0; }
  __device__ __forceinline__ unsigned long long counter(int i, int) const { return i; }
  __device__ __forceinline__ Key key(int j, int) const { return k[j]; }
};

template <int N>
struct TableKeys {
  const uint2* tab;  // (R, N) keys, (k0, k1) words
  int width;
  __device__ __forceinline__ int row(int i) const { return i / width; }
  __device__ __forceinline__ unsigned long long counter(int i, int r) const {
    return (unsigned long long)(i - r * width);
  }
  __device__ __forceinline__ Key key(int j, int r) const {
    const uint2 w = __ldg(tab + (size_t)r * N + j);
    return Key{w.x, w.y};
  }
};

template <int N>
struct EntryKeys {
  const uint2* tab;    // (S, N) keys: row d holds depth d's keys
  const int* depth;    // (W,) each entry's depth: its row of tab
  const int* inst;     // (W,) each entry's instance: its counter
  __device__ __forceinline__ int row(int i) const { return max(__ldg(depth + i), 0); }
  __device__ __forceinline__ unsigned long long counter(int i, int) const {
    return (unsigned long long)max(__ldg(inst + i), 0);
  }
  __device__ __forceinline__ Key key(int j, int r) const {
    const uint2 w = __ldg(tab + (size_t)r * N + j);
    return Key{w.x, w.y};
  }
};

// One step's degree ladder (repro_torch/kernels/walk_step.py::_ladder):
// nseg increasing segments, whether degrees above the last take the tail
// (else the last bucket absorbs them), and the bit mask of the cohorts this
// launch serves (bit nseg: the tail).
struct Ladder {
  int nseg, tail, serve;
  int segs[kMaxLadder];
};

// The ladder from the wrapper's host array (nseg, tail, serve, segs...).
Ladder make_ladder(const int* ladder) {
  Ladder L;
  L.nseg = ladder[0];
  L.tail = ladder[1];
  L.serve = ladder[2];
  for (int j = 0; j < kMaxLadder; ++j) L.segs[j] = ladder[3 + j];
  return L;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

// threefry2x32 (20 rounds, the key schedule k0, k1, k0 ^ k1 ^ 0x1BD11BDA
// with the round count added to the second word) of the counter words
// (c0, c1).  counted_uniform below is jax.random.uniform's f32 at counter i
// under key: the hash of (i >> 32, i & 0xffffffff), the two output words
// XORed, 23 of the bits as a mantissa in [1, 2), minus 1.  The plain
// version is repro_torch/kernels/threefry.py (uniform_at).  About 75
// integer operations: 2 + 20 x 3 + 5 x 2 adds, rotations and XORs, and the
// XOR, shift and OR of the bits.
__device__ __forceinline__ uint2 threefry2x32(Key key, uint32_t c0, uint32_t c1) {
  const uint32_t k0 = key.k0, k1 = key.k1, k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float counted_uniform(Key key, unsigned long long i) {
  const uint2 x = threefry2x32(key, (uint32_t)(i >> 32), (uint32_t)i);
  const uint32_t bits = x.x ^ x.y;
  return __fsub_rn(__int_as_float((int)((bits >> 9) | 0x3f800000u)), 1.0f);
}

// jax.random.fold_in(key, data): the hash of the counter (0, data).
__device__ __forceinline__ Key fold_in(Key key, uint32_t data) {
  const uint2 x = threefry2x32(key, 0u, data);
  return Key{x.x, x.y};
}

// The walker's cohort on the ladder (repro_torch/kernels/ref.py::
// walker_cohorts) for deg > 0: the first bucket with deg <= its segment,
// else the tail (nseg) or, without one, the last bucket.  Sets cap to the
// cohort's segment, INT_MAX for the tail.  Unrolled, so the ladder stays in
// the kernel's parameters.
__device__ __forceinline__ int cohort_of(const Ladder& L, int deg, int& cap) {
  int k = -1;
  cap = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < kMaxLadder; ++j) {
    if (k < 0 && j < L.nseg && deg <= L.segs[j]) {
      k = j;
      cap = L.segs[j];
    }
  }
  if (k < 0) {
    k = L.tail ? L.nseg : L.nseg - 1;
#pragma unroll
    for (int j = 0; j < kMaxLadder; ++j)
      if (!L.tail && j == L.nseg - 1) cap = L.segs[j];
  }
  return k;
}

// Replaces reject_step_pallas (src/repro/kernels/walk_step.py:267, body
// _reject_step_kernel :96) and the draws around it: the rejection budget of
// src/repro/core/select.py::rejection_randoms and the cohort split of
// walk_step_adaptive.
// One thread per walker over the whole batch, one launch a step for every
// cohort planned as rejection (the tail included).  The thread reads its
// vertex, row and envelope, finds its cohort, and runs up to kRejectIters
// rounds: each hashes the slot uniform, gathers one bias word, and hashes
// the accept uniform while that gather is in flight; the first acceptance
// ends the loop, so a near-uniform row costs about one round and two
// hashes, where the tensor budget hashed all 16.  Counter: the walker's
// index i in the step's batch, in its row under a key table, or its instance
// under its depth's keys (Keys).
// Writes only the walkers it serves.
template <class Keys>
__global__ void reject_step_kernel(const int* __restrict__ cur,
                                   const int* __restrict__ indptr,
                                   const int* __restrict__ indices,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ row_max,
                                   int* __restrict__ out, int w, Ladder L, Keys keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int row = keys.row(i);
  const unsigned long long ctr = keys.counter(i, row);
  const int c = cur[i];
  if (c < 0) return;
  const int start = indptr[c];
  const int deg = indptr[c + 1] - start;
  if (deg <= 0) return;  // no cohort
  int cap;
  const int k = cohort_of(L, deg, cap);
  if (!((L.serve >> k) & 1)) return;
  const float rm = row_max[c];
  if (rm <= 0.0f) {
    out[i] = -1;
    return;
  }
  const int deg_eff = min(deg, cap);
  const float degf = (float)deg_eff;
  const int hi = deg_eff - 1;
  int chosen = -1;
  int last = 0;
  float last_b = 0.0f;
#pragma unroll
  for (int t = 0; t < kRejectIters; ++t) {
    const int slot = min((int)__fmul_rn(counted_uniform(keys.key(2 * t, row), ctr), degf), hi);
    const float b = __ldg(bias + start + slot);
    if (__fmul_rn(counted_uniform(keys.key(2 * t + 1, row), ctr), rm) < b) {
      chosen = slot;
      break;
    }
    last = slot;
    last_b = b;
  }
  if (chosen < 0 && last_b > 0.0f) chosen = last;
  out[i] = chosen < 0 ? -1 : indices[start + chosen];
}

// Replaces alias_step_pallas (src/repro/kernels/alias_select.py:66, body
// _alias_step_kernel :29) and the draws and cohort split around it in
// walk_step_adaptive: the O(1) alias step, one launch a step for every
// cohort planned as alias (the tail included).  One thread per walker over
// the whole batch: it reads its vertex and row offsets, hashes its bucket
// uniform (key 0 of Keys, at the walker's counter) while that gather is in
// flight, finds its cohort, and draws: slot and coin from one uniform, the
// prob and alias words at start + slot, one id.  A tail walker (the row
// uncapped) hashes again under key 1; they are a few thousand of a million
// walkers.
// Bound by bytes: the walker's vertex, two row offsets, two table words and
// the id, with the hash's 75 integer operations beside them.  Once walkers
// sit at scattered vertices each read is its own 32-byte sector, four a
// walker against about 22 bytes of distinct words, and those sectors set
// the pace.  An (E, 2) table of prob bits and alias, one sector where the
// two arrays are two, is not kept: on an H100 80GB HBM3 at 700 W
// (chip_smoke.py) it took 30 % off a walk's last step but 10 % off its
// first, where neighbouring walkers read neighbouring rows, and it had to
// save 15 % at both to pay for its memory and second path.  Writes only
// the walkers it serves: -1 for a zero-total row (alias < 0).
template <class Keys>
__global__ void alias_step_kernel(const int* __restrict__ cur, const int* __restrict__ indptr,
                                  const int* __restrict__ indices,
                                  const float* __restrict__ prob,
                                  const int* __restrict__ alias, int* __restrict__ out, int w,
                                  Ladder L, Keys keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int c = cur[i];
  if (c < 0) return;
  const int start = __ldg(indptr + c);
  const int end = __ldg(indptr + c + 1);
  const int row = keys.row(i);
  const unsigned long long ctr = keys.counter(i, row);
  float r = counted_uniform(keys.key(0, row), ctr);  // depends on i only: overlaps the gather
  const int deg = end - start;
  if (deg <= 0) return;  // no cohort
  int cap;
  const int k = cohort_of(L, deg, cap);
  if (!((L.serve >> k) & 1)) return;
  if (k == L.nseg) r = counted_uniform(keys.key(1, row), ctr);  // the tail: cap is INT_MAX
  const int deg_eff = min(deg, cap);
  const int hi = deg_eff - 1;
  const float u = __fmul_rn(r, (float)deg_eff);
  const int slot = min((int)u, hi);
  const float frac = __fsub_rn(u, (float)slot);
  const int pos = start + slot;
  const float p = __ldg(prob + pos);
  const int a = __ldg(alias + pos);
  if (a < 0) {  // zero-total row
    out[i] = -1;
    return;
  }
  int chosen = frac < p ? slot : a;
  chosen = min(max(chosen, 0), hi);
  out[i] = __ldg(indices + start + chosen);
}

// Window block b of one walker's row in registers: row columns
// [16b - local, 16b - local + 16), zero outside [0, deg).
__device__ __forceinline__ void window_block(const float* __restrict__ row, int b, int local,
                                             int deg, float* v) {
  const int c0 = b * kScanBlock - local;
#pragma unroll
  for (int j = 0; j < kScanBlock; ++j) {
    const int c = c0 + j;
    v[j] = c >= 0 && c < deg ? __ldg(row + c) : 0.0f;
  }
}

// window_block from a window whose origin row - local is 16-float aligned
// (the flat CSR under a segment of whole 128-lane tiles: the origin
// start - local is a multiple of seg).  A block that lies inside the array
// (room: the floats from the origin to the array's end) is four 16-byte
// loads, a quarter of the scalar loads' instructions.  The columns outside
// [0, deg) are zeroed after the loads.
__device__ __forceinline__ void window_block_vec(const float* __restrict__ row, int b, int local,
                                                 int deg, int room, float* v) {
  const int c0 = b * kScanBlock - local;
  if ((b + 1) * kScanBlock > room) {
    window_block(row, b, local, deg, v);
    return;
  }
  const float4* q = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
  for (int j = 0; j < kScanBlock / 4; ++j) {
    const float4 f = __ldg(q + j);
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < kScanBlock; ++j) v[j] = c0 + j >= 0 && c0 + j < deg ? v[j] : 0.0f;
}

template <bool kVec>
__device__ __forceinline__ void load_block(const float* __restrict__ row, int b, int local,
                                           int deg, int room, float* v) {
  if (kVec) {
    window_block_vec(row, b, local, deg, room, v);
  } else {
    window_block(row, b, local, deg, v);
  }
}

// One pass of the compact scan over a walker's row.  The row's deg values
// sit at offsets [local, local + deg) of a 2*seg window of zeros, and only
// the 16-blocks it touches are scanned: the zeros around the row add exactly
// (0 + x = x), so every prefix and the total equal XLA-CPU's scan of the
// whole window (kernels/ref.py::padded_cumsum).  The rule is
// kernels/ref.py::compact_window_scan, held bit-equal to the full-window
// scan by tests/test_torch_scan.py.  Each window block is summed in order
// (ps), then closed into the sum of its group's block totals (gs) and, at
// the group's end (16 blocks from the window origin), into the sum of the
// closed groups' totals (top); bprev is the scanned total before the block.
// The next block's loads are issued before the current block is summed.
// kCount = false returns the total: the scan's value at position 2*seg - 1,
// the top level's last value, which for several groups is not the last row
// prefix.  kCount = true sets cnt to the count of row prefixes <= target.
// kVec loads blocks by window_block_vec (room as there).
template <bool kCount, bool kVec>
__device__ __forceinline__ float window_pass(const float* __restrict__ row, int deg, int local,
                                             int nb, float target, int& cnt, int room = 0) {
  const int b0 = local / kScanBlock, b1 = (local + deg - 1) / kScanBlock;
  float gs = 0.0f, top = 0.0f, bprev = 0.0f, ps = 0.0f, last_bprev = 0.0f;
  float v[kScanBlock], nv[kScanBlock];
  int n = 0;
  load_block<kVec>(row, b0, local, deg, room, v);
  for (int b = b0; b <= b1; ++b) {
    if (b < b1) load_block<kVec>(row, b + 1, local, deg, room, nv);
    const int c0 = b * kScanBlock - local;
    ps = v[0];
    if (kCount) n += c0 >= 0 && __fadd_rn(ps, bprev) <= target ? 1 : 0;
#pragma unroll
    for (int j = 1; j < kScanBlock; ++j) {
      ps = __fadd_rn(ps, v[j]);
      if (kCount) n += c0 + j >= 0 && c0 + j < deg && __fadd_rn(ps, bprev) <= target ? 1 : 0;
    }
    last_bprev = bprev;
    gs = __fadd_rn(gs, ps);
    bprev = __fadd_rn(gs, top);
    if ((b & (kScanBlock - 1)) == kScanBlock - 1) {  // the group closes
      top = __fadd_rn(top, gs);
      gs = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j) v[j] = nv[j];
  }
  cnt = n;
  return b1 == nb - 1 ? __fadd_rn(ps, last_bprev) : __fadd_rn(gs, top);
}

// Replaces walk_step_window_pallas (src/repro/kernels/walk_step.py:211, body
// _walk_step_window_kernel :61): the ITS step with a per-walker bias that the
// transition program's window hook (node2vec) computed.  The TPU kernel takes
// that bias as a (W, 2*seg) operand re-aligned to its block window, an
// artifact of its BlockSpec alignment; this kernel takes the hook's compact
// row-aligned (W, seg) rows (column j is edge start + j, j < deg <= seg).
// Bound by bytes: deg bias words and one id gather per walker, plus the
// walker's start, degree, uniform and output.  node2vec's (0,128] cohort
// has rows of about 14 entries, so a warp per walker over the 2*seg window
// would spend most of its work on zeros.  Instead one thread per walker, 32
// walkers a warp, does work in proportion to its row: two passes by window
// block (window_pass: the total, then the count of
// prefixes <= r * total; the second hits L1 or L2), closing a block once per
// block, not testing for it at every entry.  What remains is the spread of
// row lengths within a warp: its time follows its longest row.
__global__ void walk_step_window_kernel(const int* __restrict__ starts,
                                        const int* __restrict__ degs,
                                        const int* __restrict__ indices,
                                        const float* __restrict__ bias_rows,
                                        const float* __restrict__ rand,
                                        int* __restrict__ out, int w, int seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int deg = min(degs[i], seg);
  if (deg <= 0) {
    out[i] = -1;
    return;
  }
  const int start = starts[i];
  const int local = start % seg;
  const int nb = 2 * seg / kScanBlock;
  const float* row = bias_rows + (size_t)i * seg;
  int cnt = 0;
  const float total = window_pass<false, false>(row, deg, local, nb, 0.0f, cnt);
  if (total <= 1e-12f) {
    out[i] = -1;
    return;
  }
  window_pass<true, false>(row, deg, local, nb, __fmul_rn(rand[i], total), cnt);
  out[i] = indices[start + min(cnt, deg - 1)];
}

// The most 16-blocks a row of at most 512 entries touches in its window.
constexpr int kMaxRowBlocks = 512 / kScanBlock + 1;

// Replaces walk_step_pallas (src/repro/kernels/walk_step.py:158, body
// _walk_step_kernel :29) with the wrapper around it that draws its uniform
// (src/repro/kernels/ops.py:38 walk_step) and the cohort split of
// walk_step_adaptive: the flat-bias ITS step, one launch a step for every
// bucket planned as ITS.  walk_step_window_kernel's design with the CSR as
// the row: one thread per walker, window_pass over the walker's bias row
// [start, start + min(deg, seg)) at offset local = start % seg of its 2*seg
// window (seg: the cohort's segment, so the window origin is part of the
// bits), work in proportion to the row and not to the window.  A warp's
// time follows its longest row, and once walkers sit where the walk took
// them, rows of 1 to 33 blocks mix in every warp.  So the block first
// sorts its walkers by the number of window blocks their rows touch (a
// counting sort in shared memory), and thread t scans the t-th shortest
// row: each warp then holds rows of about one length.  The window origin
// start - local is a multiple of seg, so with a 16-byte aligned bias (kVec)
// each window block is four 16-byte loads.  The uniform is hashed at the
// walker's own counter (Keys), only for a row with mass.  Bound by bytes (the
// row once, the id, the walker's vertex and row offsets) and the hash.
template <bool kVec, class Keys>
__global__ void __launch_bounds__(kThreads) walk_step_kernel(
    const int* __restrict__ cur, const int* __restrict__ indptr,
    const int* __restrict__ indices, const float* __restrict__ bias, int* __restrict__ out,
    int w, int n_bias, Ladder L, Keys keys) {
  constexpr int kBins = kMaxRowBlocks + 1;  // 0 blocks: a walker not served here
  __shared__ int s_bin[kBins];
  __shared__ int s_order[kThreads], s_start[kThreads], s_deg[kThreads], s_seg[kThreads];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  // this thread's walker, when one of its cohorts is served here
  int start = 0, d = 0, seg = 0;
  if (i < w) {
    const int c = cur[i];
    if (c >= 0) {
      start = indptr[c];
      const int deg = indptr[c + 1] - start;
      if (deg > 0) {  // else no cohort
        const int k = cohort_of(L, deg, seg);
        if (k < L.nseg && ((L.serve >> k) & 1)) d = min(deg, seg);  // the ITS tail is the chunked scan
      }
    }
  }
  const int local = d > 0 ? start % seg : 0;
  const int nblk = d > 0 ? (local + d - 1) / kScanBlock - local / kScanBlock + 1 : 0;
  s_start[t] = start;
  s_deg[t] = d;
  s_seg[t] = seg;
  if (t < kBins) s_bin[t] = 0;
  __syncthreads();
  const int rank = atomicAdd(&s_bin[nblk], 1);
  __syncthreads();
  if (t < 32) {  // exclusive scan of the bin counts: bins t and 32 + t
    const int c0 = s_bin[t], c1 = 32 + t < kBins ? s_bin[32 + t] : 0;
    int x0 = c0, x1 = c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y0 = __shfl_up_sync(kFull, x0, o), y1 = __shfl_up_sync(kFull, x1, o);
      if (t >= o) {
        x0 += y0;
        x1 += y1;
      }
    }
    const int lo_total = __shfl_sync(kFull, x0, 31);
    s_bin[t] = x0 - c0;
    if (32 + t < kBins) s_bin[32 + t] = lo_total + x1 - c1;
  }
  __syncthreads();
  s_order[s_bin[nblk] + rank] = t;
  __syncthreads();
  const int src = s_order[t];  // the walker this thread scans
  const int rd = s_deg[src];
  if (rd <= 0) return;
  const int rstart = s_start[src], rseg = s_seg[src];
  const int rlocal = rstart % rseg;
  const int nb = 2 * rseg / kScanBlock;
  const int room = n_bias - (rstart - rlocal);
  const int ri = blockIdx.x * kThreads + src;
  const float* row = bias + rstart;
  int cnt = 0;
  const float total = window_pass<false, kVec>(row, rd, rlocal, nb, 0.0f, cnt, room);
  if (total <= 1e-12f) {
    out[ri] = -1;
    return;
  }
  const int krow = keys.row(ri);
  const float r = counted_uniform(keys.key(0, krow), keys.counter(ri, krow));
  window_pass<true, kVec>(row, rd, rlocal, nb, __fmul_rn(r, total), cnt, room);
  out[ri] = indices[rstart + min(cnt, rd - 1)];
}

// The device hash alone, for its tests: out[k][j] = the uniform of
// counters[j] under keys[k] (K x 2 words).
__global__ void hash_uniform_kernel(const uint32_t* __restrict__ keys,
                                    const long long* __restrict__ counters,
                                    float* __restrict__ out, int nkeys, int n) {
  const long long total = (long long)nkeys * n;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < total;
       j += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(j / n);
    out[j] = counted_uniform(Key{keys[2 * k], keys[2 * k + 1]},
                             (unsigned long long)counters[j % n]);
  }
}

// The paths of the keys derive_keys_kernel derives: n paths of fold_in data,
// path p of depth[p] words (repro_torch/kernels/threefry.py: MAX_KEY_PATHS,
// MAX_KEY_DEPTH).
constexpr int kMaxKeyPaths = 16;
constexpr int kMaxKeyDepth = 8;
struct KeyPaths {
  int n;
  int depth[kMaxKeyPaths];
  uint32_t data[kMaxKeyPaths][kMaxKeyDepth];
};

// The per-row keys of a batch of R rows, for the step kernels' key tables
// and the draws made in tensor code: out[r][p] = the fold_ins of path p
// applied to row r's key in turn (jax.random.fold_in, the hash of the
// counter (0, data)).  No TPU kernel computes this: it replaces the key
// derivation that jax.vmap runs per row of random_walk_segments
// (src/repro/core/engine.py:501) outside any Pallas kernel.  One thread a
// (row, path); a step derives at most 16 keys of at most 8 fold_ins a row,
// so a launch is R x 16 threads and a few hundred integer operations each:
// bound by the launch, not by bytes or operations.
__global__ void derive_keys_kernel(const uint2* __restrict__ base, uint2* __restrict__ out,
                                   int rows, KeyPaths paths) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * paths.n) return;
  const int r = i / paths.n, p = i - r * paths.n;
  const uint2 b = base[r];
  Key k{b.x, b.y};
  for (int d = 0; d < paths.depth[p]; ++d) k = fold_in(k, paths.data[p][d]);
  out[i] = make_uint2(k.k0, k.k1);
}

// -- its_select ---------------------------------------------------------------

constexpr int kSelectWarps = 10;  // warps per block, at most
constexpr int kRing = 2;         // staged instances per warp: the current one and the next
constexpr int kTree = 5;         // levels of a cooperative search round: 31 lanes, 31 nodes

// Word offset of row element q in a staged buffer.  The 16-byte chunk
// c = q / 4 lands at c ^ ((c / 8) % 4): within each 16-block (4 chunks) the
// chunks are permuted by bits 1-2 of the block index, so when lane l reads
// chunk k of block l + 32m (a 16-byte read, served 8 lanes a phase) the 8
// lanes of a phase hit 8 distinct 4-bank groups: no bank conflict.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 12); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// Issue the copies of one instance into a ring slot, split over the warp's
// lanes: the bias row, swizzled (16-byte copies when the row is 16-byte
// aligned, P % 4 == 0, else 4-byte copies into the same layout), then round
// 0's K uniforms at slot[ppad, ppad + K).  Completion is the lane's commit
// group.
__device__ __forceinline__ void stage(float* slot, int ppad, const float* row, const float* r0,
                                      int p, int k, bool vec, int lane) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(slot);
  if (vec) {
    for (int c = lane; c < (p >> 2); c += 32) cp_async16(base + 4u * swz(4 * c), row + 4 * c);
  } else {
    for (int q = lane; q < p; q += 32) cp_async4(base + 4u * swz(q), row + q);
  }
  if (lane < k) cp_async4(base + 4u * (ppad + lane), r0 + lane);
}

// Block b of a staged row as 16 registers, max(x, 0), zero past P.
__device__ __forceinline__ void load_block(const float* buf, int b, int p, float* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(buf + swz(b * kScanBlock + 4 * k));
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
  if ((b + 1) * kScanBlock <= p) {
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j) v[j] = fmaxf(v[j], 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j)
      v[j] = b * kScanBlock + j < p ? fmaxf(v[j], 0.0f) : 0.0f;
  }
}

// Block b's 16 prefixes, stored in order.  The swizzle permutes the chunks
// only within a block, so the block's 64 bytes are the same either way, and
// a lane overwrites only its own block.  The searches then read entry q at q.
__device__ __forceinline__ void store_block(float* buf, int b, const float* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(buf + b * kScanBlock + 4 * k) =
        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// Scan a staged row of P <= 512 * NM values (NM 16-blocks a lane) in
// registers, associated exactly as kernels/ref.py::padded_cumsum, and write
// the prefixes back in place, in order (store_block): divided by the total
// when kDivide, else as they are.  Also writes pos[b], the bits of block b's
// positive entries, each block's first and last prefix into sm and pm (the
// inputs of warp_envelope), sets steps when a block starts below the end
// of the block before (before the divide, which keeps order, so no step
// is missed), and sets total = max(prefix at P - 1, 1e-12); returns
// the count of positive entries.  Lane l owns 16-blocks l + 32m.  Level 1: each block summed in
// order.  Level 2: the block totals in groups of 16 blocks (lanes 0-15 and
// 16-31 of one m), each lane folding its group's lower totals in order,
// pulled with __shfl_sync.  Level 3: the group totals (at most 16, so one
// sequential fold, which every lane runs).  Each level is zero-padded to
// whole 16-blocks, as XLA pads it.  Then each block adds the scanned total of
// the block before it (block 0 adds nothing).  For P = 1024: 64 blocks, 4
// groups, a 4-wide top fold.  Up to NM = 2 the in-block sums stay in
// registers (one read of the row); above, the blocks are read again.
template <int NM, bool kDivide>
__device__ __forceinline__ int scan_row(float* buf, unsigned short* pos, int p, int lane,
                                        float& total, float* pm, float* sm, bool& steps) {
  constexpr bool kRegs = NM <= 2;
  const int nb = (p + kScanBlock - 1) / kScanBlock;
  float t[NM];
  float s[kRegs ? NM : 1][kScanBlock];
  float v[kScanBlock];
  int npos = 0;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    t[m] = 0.0f;
    const int b = lane + 32 * m;
    if (b < nb) {
      load_block(buf, b, p, v);
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < kScanBlock; ++j) bits |= (v[j] > 0.0f ? 1u : 0u) << j;
      pos[b] = (unsigned short)bits;
      npos += __popc(bits);
      float acc = v[0];
      if constexpr (kRegs) s[m][0] = acc;
#pragma unroll
      for (int j = 1; j < kScanBlock; ++j) {
        acc = __fadd_rn(acc, v[j]);
        if constexpr (kRegs) s[m][j] = acc;
      }
      t[m] = acc;
    }
  }
  // levels 2 and 3: bsum[m] is the scanned block total of block lane + 32m
  float bsum[NM];
  float top = 0.0f;
  const int half = lane & 16, j = lane & 15;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    float gs = 0.0f;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float y = __shfl_sync(kFull, t[m], half + x);
      if (x == 0) gs = y;
      else if (x <= j) gs = __fadd_rn(gs, y);
    }
    const float te = __shfl_sync(kFull, gs, 15), to = __shfl_sync(kFull, gs, 31);
    const float before_even = top;  // groups < 2m
    top = m == 0 ? te : __fadd_rn(top, te);
    const float before_odd = top;   // groups < 2m + 1
    top = __fadd_rn(top, to);
    bsum[m] = lane < 16 ? (m == 0 ? gs : __fadd_rn(gs, before_even)) : __fadd_rn(gs, before_odd);
  }
  // element prefixes: the in-block sums plus the scanned total before the
  // block, held by the lane below (lane 0: by lane 31 of the previous m)
  const int lb = (p - 1) / kScanBlock, lj = (p - 1) % kScanBlock;
  float carry = 0.0f, tv = 0.0f, carry_last = 0.0f;
  bool step = false;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const float up = __shfl_up_sync(kFull, bsum[m], 1);
    const float bprev = lane == 0 ? carry : up;
    carry = __shfl_sync(kFull, bsum[m], 31);
    const int b = lane + 32 * m;
    float first = INFINITY, last = -INFINITY;
    if (b < nb) {
      if constexpr (kRegs) {
#pragma unroll
        for (int x = 0; x < kScanBlock; ++x) s[m][x] = b == 0 ? s[m][x] : __fadd_rn(s[m][x], bprev);
        if (b == lb) {
#pragma unroll
          for (int x = 0; x < kScanBlock; ++x) tv = x == lj ? s[m][x] : tv;
        }
        first = s[m][0];
        last = b == lb ? tv : s[m][kScanBlock - 1];
      } else {
        load_block(buf, b, p, v);
#pragma unroll
        for (int x = 1; x < kScanBlock; ++x) v[x] = __fadd_rn(v[x - 1], v[x]);
#pragma unroll
        for (int x = 0; x < kScanBlock; ++x) v[x] = b == 0 ? v[x] : __fadd_rn(v[x], bprev);
        if (b == lb) {
#pragma unroll
          for (int x = 0; x < kScanBlock; ++x) tv = x == lj ? v[x] : tv;
        }
        first = v[0];
        last = b == lb ? tv : v[kScanBlock - 1];
        store_block(buf, b, v);
      }
      sm[b] = first;  // the envelope's inputs (warp_envelope)
      pm[b] = last;
    }
    // a step: the block starts below the end of the block before
    const float up_last = __shfl_up_sync(kFull, last, 1);
    step = step || (b > 0 && (lane == 0 ? carry_last : up_last) > first);
    carry_last = __shfl_sync(kFull, last, 31);
  }
  steps = __any_sync(kFull, step);
  total = fmaxf(__shfl_sync(kFull, tv, lb % 32), 1e-12f);
  if (kRegs || kDivide) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int b = lane + 32 * m;
      if (b < nb) {
        if constexpr (kRegs) {
#pragma unroll
          for (int x = 0; x < kScanBlock; ++x) v[x] = s[m][x];
        } else {
#pragma unroll
          for (int x = 0; x < kScanBlock; ++x) v[x] = buf[b * kScanBlock + x];  // the stored prefixes
        }
        if (kDivide) {
#pragma unroll
          for (int x = 0; x < kScanBlock; ++x) v[x] = __fdiv_rn(v[x], total);
        }
        store_block(buf, b, v);
      }
    }
  }
  return __reduce_add_sync(kFull, npos);
}

// The upper bound of r in the CTPS, by the whole warp, visiting exactly the
// entries that the binary search lo = 0, hi = P, mid = (lo + hi) / 2 visits,
// so the result is that search's, which exact_count turns into the count
// of entries <= r.  Each round, lane l evaluates node l + 1 of the next kTree
// levels of the search tree (heap order: a node's children are 2n and
// 2n + 1, right when the test holds), and the path is read off the ballot.
// The sums are undivided: x -> RN(x / total) is nondecreasing for total > 0,
// so dividing only the entries a lane tests (with the same __fdiv_rn)
// compares the same values as a search over the fully divided CTPS.
// For P = 1024: 11 levels in 3 rounds of one divide per lane.
__device__ __forceinline__ int coop_upper_bound(const float* sums, int p, float r, float total,
                                                int lane) {
  const int node = lane + 1;  // lane 31 evaluates nothing
  const int depth = 31 - __clz(node);
  int lo = 0, hi = p;
  while (lo < hi) {
    int a = lo, b = hi;
    for (int d = depth - 1; d >= 0; --d) {
      const int mid = (a + b) >> 1;
      if ((node >> d) & 1) a = mid + 1;
      else b = mid;
    }
    const bool test = lane < 31 && a < b && __fdiv_rn(sums[(a + b) >> 1], total) <= r;
    const unsigned bits = __ballot_sync(kFull, test);
    int n = 1;
#pragma unroll
    for (int l = 0; l < kTree; ++l) {
      if (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int bit = (bits >> (n - 1)) & 1;
        if (bit) lo = mid + 1;
        else hi = mid;
        n = 2 * n + bit;
      }
    }
  }
  return lo;
}

// The upper bound of r in ctps[0, p), one lane's binary search over the
// divided CTPS (exact_count turns it into the count of entries <= r).
__device__ __forceinline__ int upper_bound(const float* ctps, int p, float r) {
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ctps[mid] <= r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The CTPS is not always nondecreasing: past 256 entries XLA's association
// can leave the first entry of a 16-block a few ulps below the last entry of
// the block before (s1 + (s2 + x) against (s1 + s2) + x), most often where a
// block starts with zero biases.  The reference takes the count of entries
// <= r, which a binary search gives only where no such step lies on either
// side of r.  Each 16-block is nondecreasing (its in-block sums plus one
// prefix), so the count follows from the blocks' envelope: pm[b], the
// largest last entry of blocks 0..b, and sm[b], the smallest first entry of
// blocks b..nb-1, both nondecreasing.  Entries are read divided by total
// (div: __fdiv_rn, which keeps order, so pm and sm may hold the undivided
// sums) or as they are.
__device__ __forceinline__ float ctps_at(const float* a, long long q, float total, bool div) {
  return div ? __fdiv_rn(a[q], total) : a[q];
}

__device__ __forceinline__ long long upper_bound_at(const float* a, long long lo, long long hi,
                                                    float r, float total, bool div) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ctps_at(a, mid, total, div) <= r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The count of entries of s[0, p) that are <= r where the envelope
// straddles r: every block but the straddled ones is settled by pm and sm,
// which are counted one by one.  Out of line: it runs only where a step of
// the CTPS lies beside r, and keeps its registers out of the callers'.
__device__ __noinline__ int count_straddled(const float* s, const float* pm, const float* sm,
                                            long long p, float r, float total, bool div) {
  const long long nb = (p + kScanBlock - 1) / kScanBlock;
  const long long a = upper_bound_at(pm, 0, nb, r, total, div);  // blocks [0, a): all <= r
  const long long b = upper_bound_at(sm, 0, nb, r, total, div);  // blocks [b, nb): all > r
  long long c = min(a * kScanBlock, p);
  for (long long x = a; x < b; ++x) {
    const long long lo = x * kScanBlock;
    c += upper_bound_at(s, lo, min(lo + kScanBlock, p), r, total, div) - lo;
  }
  return (int)c;
}

// The count of entries of s[0, p) that are <= r, from u, the upper bound a
// binary search found: the search tested s[u - 1] <= r < s[u], and each
// block is nondecreasing, so u is the count when the blocks before u - 1's
// are all <= r and those after u's all > r (two reads of the envelope).
__device__ __forceinline__ int exact_count(int u, const float* s, const float* pm,
                                           const float* sm, int p, float r, float total,
                                           bool div) {
  const int nb = (p + kScanBlock - 1) / kScanBlock;
  const int ba = (u - 1) / kScanBlock, bb = u / kScanBlock;
  if ((u == 0 || ba == 0 || ctps_at(pm, ba - 1, total, div) <= r) &&
      (u == p || bb + 1 >= nb || ctps_at(sm, bb + 1, total, div) > r))
    return u;
  return count_straddled(s, pm, sm, p, r, total, div);
}

// The envelope of one row (see exact_count), by a warp, in place: pm[b]
// and sm[b] hold block b's last and first prefix (scan_row), and become the
// running maximum from block 0 and the running minimum from block nb - 1,
// divided by total when the prefixes are.  Lane l takes blocks l + 32m.
template <int NM>
__device__ __forceinline__ void warp_envelope(float* pm, float* sm, int nb, int lane, float total,
                                              bool divide) {
  float hi = -INFINITY, lo = INFINITY;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int b = lane + 32 * m;
    float x = b < nb ? pm[b] : -INFINITY;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = fmaxf(x, y);
    }
    x = fmaxf(x, hi);
    hi = __shfl_sync(kFull, x, 31);
    if (b < nb) pm[b] = divide ? __fdiv_rn(x, total) : x;
  }
#pragma unroll
  for (int m = NM - 1; m >= 0; --m) {
    const int b = lane + 32 * m;
    float x = b < nb ? sm[b] : INFINITY;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_down_sync(kFull, x, d);
      if (lane + d < 32) x = fminf(x, y);
    }
    x = fminf(x, lo);
    lo = __shfl_sync(kFull, x, 0);
    if (b < nb) sm[b] = divide ? __fdiv_rn(x, total) : x;
  }
}

__device__ __forceinline__ bool positive(const unsigned short* pos, int q) {
  return (pos[q >> 4] >> (q & 15)) & 1;
}

// Replaces its_select_pallas (src/repro/kernels/its_select.py:113, body
// _its_select_kernel :30): K of P candidates without replacement, ITS with
// bipartite region search, the paper's warp-centric SELECT.  One warp per
// instance, one lane per draw (K <= 32).
// Bound by bytes: each instance reads its P bias words once and its draws'
// uniforms, and the opaque walk's rows are 4 KB each.  What keeps it from
// that bound is latency: few bytes in flight, a serial scan, divides of all
// P prefixes of which a K = 1 draw reads about 11, a global re-read of the
// chosen bias.  So:
// - Persistent warps loop over instances; each stages its instances (the row
//   and round 0's uniforms) into a ring of kRing shared-memory slots with
//   cp.async, one instance ahead, so the next row loads while the current
//   one is scanned.  A deeper ring leaves fewer warps an SM and measured
//   slower; 20 warps an SM keep enough rows in flight.  Rows that are not
//   16-byte aligned (P % 4 != 0) take 4-byte copies into the same layout.
// - The scan runs in registers with the reference's association (scan_row),
//   reading blocks conflict-free through the swizzled layout (swz), writes
//   the prefixes back in order for the searches, and keeps the positive
//   entries as a bit each, so the "has mass" test of a candidate is one
//   shared-memory read.
// - Every search is a binary search, which is the count of entries <= r
//   on a row whose CTPS never steps down.  scan_row tells such rows apart
//   (rows of at most 256 entries always are); on the others the row's
//   block envelope (warp_envelope, from the blocks' first and last prefixes
//   that scan_row stores) makes each search exact (exact_count: two
//   shared-memory reads when no step lies beside r).
// - K = 1 (the walks' use): one search per round, run by the whole
//   warp (coop_upper_bound), dividing only the entries it tests, and no map
//   (nothing can be taken before the only draw wins).
// - K > 1: each lane searches for its own draw (upper_bound); the prefixes
//   are divided once, in registers (rounds of K lanes and region searches
//   read them many times), and the next round's uniform loads during the
//   current round.  Selected candidates are a per-warp byte map, written
//   only by the winning lane of a round (distinct bytes, no atomics).
//   Collisions within a round resolve "lowest lane wins" with
//   __match_any_sync, the reference's K x K priority rule; atomics would
//   pick a winner by timing.  K > 1 runs well above its byte bound (about
//   3.6 rounds an instance at K = 8, each a dependent binary search per
//   pending draw, two when its region is taken); chip_smoke.py times it
//   with all its rounds and with the first alone to part the two costs.
// - The region search rounds each step on its own: r2 = r1 * (1 - delta),
//   the shift r2 + delta, then the clip to [0, f32(1 - 1e-12)] = [0, 1].
// - (iters, searches) per instance are counted as the reference counts them.
template <int NM>
__global__ void __launch_bounds__(kSelectWarps * 32, NM <= 2 ? 2 : 1)
    its_select_kernel(const float* __restrict__ biases,
                                  const float* __restrict__ rands,
                                  int* __restrict__ out, int* __restrict__ stats,
                                  int n, int p, int iters, int k, int stride, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = gridDim.x * warps;
  const int first = blockIdx.x * warps + warp;
  const int ppad = (p + kScanBlock - 1) / kScanBlock * kScanBlock;
  const int slot_floats = ppad + 32;
  unsigned char* mine = smem + (size_t)warp * stride;
  float* ring = reinterpret_cast<float*>(mine);
  unsigned short* pos = reinterpret_cast<unsigned short*>(mine + (size_t)kRing * slot_floats * 4);
  unsigned char* taken = mine + (size_t)kRing * slot_floats * 4 + (ppad / 8 + 15) / 16 * 16;
  float* pm = reinterpret_cast<float*>(taken + (k > 1 ? ppad : 0));
  float* sm = pm + ppad / kScanBlock;

  for (int s = 0; s < kRing - 1; ++s) {
    const long long i = first + (long long)s * nwarps;
    if (i < n)
      stage(ring + s * slot_floats, ppad, biases + i * p, rands + i * iters * k, p, k, vec != 0,
            lane);
    cp_async_commit();
  }
  for (int it = 0;; ++it) {
    const long long i = first + (long long)it * nwarps;
    if (i >= n) break;  // the whole warp leaves together
    const long long ahead = i + (long long)(kRing - 1) * nwarps;
    if (ahead < n)
      stage(ring + ((it + kRing - 1) % kRing) * slot_floats, ppad, biases + ahead * p,
            rands + ahead * iters * k, p, k, vec != 0, lane);
    cp_async_commit();
    cp_async_wait_ring();  // this instance's copies have landed
    __syncwarp();
    float* sums = ring + (it % kRing) * slot_floats;
    const float* r0 = sums + ppad;
    float total;
    int res = -1, rounds = 0, searches = 0;
    if (k == 1) {
      bool steps;
      const int navail = scan_row<NM, false>(sums, pos, p, lane, total, pm, sm, steps);
      __syncwarp();
      if (steps) {
        warp_envelope<NM>(pm, sm, ppad / kScanBlock, lane, total, false);
        __syncwarp();
      }
      if (navail > 0) {
        for (int t = 0; t < iters; ++t) {
          ++rounds;  // one pending draw, one search, nothing taken
          const float r1 = t == 0 ? r0[0] : __ldg(rands + i * iters + t);
          const int u = coop_upper_bound(sums, p, r1, total, lane);
          const int idx = min(steps ? exact_count(u, sums, pm, sm, p, r1, total, true) : u, p - 1);
          if (positive(pos, idx)) {
            res = idx;
            break;
          }
        }
      }
      searches = rounds;
    } else {
      bool steps;
      const int navail = scan_row<NM, true>(sums, pos, p, lane, total, pm, sm, steps);
      for (int x = lane; x < ppad / 16; x += 32)
        reinterpret_cast<uint4*>(taken)[x] = make_uint4(0, 0, 0, 0);
      __syncwarp();
      if (steps) {
        warp_envelope<NM>(pm, sm, ppad / kScanBlock, lane, total, true);
        __syncwarp();
      }
      const int want = min(navail, k);
      bool done = lane >= want;  // lanes >= k are never pending
      float r1 = lane < k ? r0[lane] : 0.0f;
      for (int t = 0; t < iters; ++t) {
        const unsigned pending = __ballot_sync(kFull, !done);
        if (pending == 0u) break;  // no draw pending: later rounds change nothing
        ++rounds;
        const float rnext =
            !done && t + 1 < iters ? __ldg(rands + (i * iters + t + 1) * k + lane) : 0.0f;
        int cand = 0;
        bool hit1 = false, ok = false;
        if (!done) {
          const int u1 = upper_bound(sums, p, r1);
          const int idx1 =
              min(steps ? exact_count(u1, sums, pm, sm, p, r1, 1.0f, false) : u1, p - 1);
          hit1 = taken[idx1] != 0;
          cand = idx1;
          bool blocked = false;
          if (hit1) {  // region search past the taken region
            const float lo = idx1 > 0 ? sums[idx1 - 1] : 0.0f;
            const float delta = __fsub_rn(sums[idx1], lo);
            float r2 = __fmul_rn(r1, __fsub_rn(1.0f, delta));
            r2 = r2 < lo ? r2 : __fadd_rn(r2, delta);
            r2 = fminf(fmaxf(r2, 0.0f), 1.0f);
            const int u2 = upper_bound(sums, p, r2);
            cand = min(steps ? exact_count(u2, sums, pm, sm, p, r2, 1.0f, false) : u2, p - 1);
            blocked = taken[cand] != 0;
          }
          ok = !blocked && positive(pos, cand);
        }
        searches += __popc(pending) + __popc(__ballot_sync(kFull, hit1));
        const unsigned same = __match_any_sync(kFull, ok ? cand : -1 - lane);
        const bool win = ok && __ffs(same) - 1 == lane;
        __syncwarp();  // every read of the byte map precedes this round's writes
        if (win) {
          res = cand;
          taken[cand] = 1;
        }
        done = done || win;
        r1 = rnext;
        __syncwarp();
      }
    }
    if (lane < k) out[i * k + lane] = res;
    if (lane == 0) {
      stats[2 * i] = rounds;
      stats[2 * i + 1] = searches;
    }
    __syncwarp();  // the slot is restaged only after every lane is done with it
  }
}

template <int NM>
cudaError_t its_select_run(const float* biases, const float* rands, int* out, int* stats, int n,
                           int p, int iters, int k, cudaStream_t stream) {
  // per warp: kRing slots of round16(P) floats and 32 uniforms, the bits of
  // the positive entries, for K > 1 the byte map of taken candidates, and
  // the row's block envelope (two floats a 16-block, exact_count); as
  // many warps a block (up to kSelectWarps) as fit two blocks' slots in an
  // SM's shared memory.  The grid is as many blocks as the occupancy query
  // (which counts registers as well) lets stay resident.
  const int ppad = (p + kScanBlock - 1) / kScanBlock * kScanBlock;
  const int stride = kRing * (ppad + 32) * 4 + (ppad / 8 + 15) / 16 * 16 + (k > 1 ? ppad : 0) +
                     (2 * (ppad / kScanBlock) * 4 + 15) / 16 * 16;  // 16-byte aligned slots
  const int warps = std::max(1, std::min(kSelectWarps, (100 * 1024) / stride));
  const int smem = stride * warps;
  cudaError_t e = cudaFuncSetAttribute(its_select_kernel<NM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, its_select_kernel<NM>,
                                                         32 * warps, smem)) != cudaSuccess)
    return e;
  const long long need = ((long long)n + warps - 1) / warps;
  const int blocks = (int)std::min(need, (long long)sms * std::max(per_sm, 1));
  const int vec = p % 4 == 0 && (uintptr_t)biases % 16 == 0;
  its_select_kernel<NM><<<blocks, 32 * warps, smem, stream>>>(biases, rands, out, stats, n, p,
                                                             iters, k, stride, vec);
  return cudaGetLastError();
}

// -- its_select, wide rows ------------------------------------------------------
//
// Replaces its_select_pallas (src/repro/kernels/its_select.py:113) for the
// shapes its_select_kernel does not take: K > 32 draws or rows of P > 4096
// candidates (traversal sampling's per-vertex pools of max_degree
// candidates, layer sampling's and MDRW's pooled rows of frontier_size x
// max_degree).  The same function, bit for bit: CTPS cumsum(max(b, 0)) /
// max(total, 1e-12) with XLA's association (ref.py::padded_cumsum), ITERS
// rounds of K uniforms, a bipartite region search on a collision, the count
// of CTPS entries <= r, the lowest draw index winning a candidate, and the
// (iters, searches) counters.
//
// Bound by bytes: the rows are read once (a launch of layer sampling is 163
// rows of 821,376 entries, 535 MB); a search reads a few words.  A launch
// holds few long rows, so each row is split over many blocks, and the rows
// are read once: what later phases need is kept a word or two a 16-block.
//
// Why the split is exact.  padded_cumsum is a fixed tree: level 0 is the
// row, level l + 1 the totals of level l's 16-blocks (each level zero-padded
// to whole blocks), the top level (at most 16 wide) is scanned in order, and
// a node's prefix is its in-block sum plus the scanned value of the node
// before its block one level up, T_l[q] = s_l[q] + T_{l+1}[q/16 - 1]: the
// right-nested s1 + (s2 + (s3 + ...)) of XLA's recursion.  Any schedule that
// adds the same nodes in the same nesting with __fadd_rn gives the same
// bits.  A chunk of kChunk = 16^3 entries aligned at a multiple of 4096
// holds whole nodes of levels 0-2 and is one node of level 3.  So every
// value the tree adds into chunk c from outside is one of three entries of
// a small table a row (P / 4096 chunks: 201 at layer's P): T3[c - 1] (level
// 3 scanned), T2[16c - 1] = tot[c - 1] + T3[c - 2] (the previous chunk's
// last level-2 node) and T1[256c - 1] = e1[c - 1] + (e2[c - 1] + T3[c - 2])
// (its last level-1 node), where tot, e1 and e2 are the previous chunk's
// total, its last level-1 and its second-to-last level-2 in-block sums.
// ref.py::chunked_cumsum mirrors the split on the CPU, and
// tests/test_torch_wide_scan.py holds it bit-equal to padded_cumsum and
// jnp.cumsum.  An entry of 16-block x is then its in-block sum plus one
// value a block, bpre[x] (none for the row's first block).
//
// Four launches:
// A. its_select_chunk_kernel, a block of 256 threads a (row, chunk): each
//    warp loads 512 entries, 16 bytes a lane, neighbouring lanes on
//    neighbouring addresses; takes each 16-block's in-block sums in
//    registers (four lanes a block, the running sum handed on by shuffles,
//    in order), levels 1 and 2 in shared memory; writes a block's first
//    entry, total and level-1 in-block sum, the chunk's level-2 sums and
//    its count of positive entries.  The only pass over the rows.
// B. its_select_prefix_kernel, a warp a row: scans the chunk totals by
//    padded_cumsum's rule and writes each chunk's three prefixes.
// C. its_select_envelope_kernel, A's grid, a thread a 16-block: bpre, the
//    block's first entry (its undivided CTPS value), and the chunk's runs of
//    the envelope (see exact_count: the running maximum of the blocks' last
//    entries from the chunk's first block, the running minimum of their
//    first entries to its last) and its extremes.
// D. its_select_rounds_kernel, a block a row (a warp for K <= 32; draw j on
//    thread j mod the block's threads): loads its tables, scans
//    the chunks' extremes (block_envelope), so that pm(b) and sm(b) are a
//    chunk's run joined with the chunks before or after it (WideRow), and
//    runs the rounds.  A search narrows on a table of every G-th block's
//    first entry (shared memory, at most 1,024 entries: G = 64 at layer's
//    P, 8 at P = 102,784), then to one 16-block on the blocks' first entries
//    (C's, 33 MB at layer's launch, mostly in L2), and counts inside it from
//    its 16 biases reloaded and bpre, added as A and C add them.  The
//    CTPS is S / total, S the undivided sums and total = max(S[P - 1],
//    1e-12), divided (__fdiv_rn) where a search tests an entry (the table
//    once, as D copies it): x -> RN(x / total) is nondecreasing, so the
//    comparisons and the envelope are those of the divided CTPS.
//    exact_count makes a search the count of entries <= r.  The candidates
//    taken in earlier rounds are a hash set of at most K entries in shared
//    memory (device memory past kSetSmemBytes).  A draw claims its
//    candidate by inserting it with atomicCAS and lowering the entry's value
//    to its index with atomicMin, so the lowest draw index wins whatever the
//    order the atomics land in; the winner marks the entry taken.
//
// Scratch (wide_layout): seven words a 16-block and a few a chunk, about
// 0.44 x the rows' bytes.

constexpr int kChunk = kScanBlock * kScanBlock * kScanBlock;  // entries of a level-3 node
constexpr int kChunkBlocks = kChunk / kScanBlock;             // its 16-blocks
constexpr int kChunkThreads = 256;                            // 8 warps of 512 entries
constexpr int kPrefixWarps = 4;                               // rows a block of B
constexpr int kRoundsThreads = 512;                           // D's largest block
constexpr int kMaxLevels = 9;                // block-total levels of a scan: 16^8 > 2^31
constexpr int kFirstTableWords = 1024;       // D's table of block first entries, at most
constexpr long long kExtSmemBytes = 32 * 1024;     // D's chunk extremes in shared memory up to this
constexpr long long kSetSmemBytes = 96 * 1024;     // D's taken set in shared memory up to this
constexpr int kUnclaimed = 0x7fffffff;       // a set entry's value: no claim yet
constexpr int kTaken = -1;                   // ... taken in an earlier round

// The levels of the blocked scan of a w-wide array (kernels/ref.py::
// padded_cumsum): level 0 is the array itself; level l + 1 holds the totals
// of level l's 16-blocks, ceil(w_l / 16) of them, until a level is at most
// 16 wide, which is scanned in order.  Levels 1.. follow the array one after
// the other: off[l] is level l's offset after it.
struct ScanLevels {
  int n;          // levels above the array
  long long len;  // words of levels 1..n
  long long w[kMaxLevels + 1], off[kMaxLevels + 1];
};

__host__ __device__ inline ScanLevels scan_levels(long long p) {
  ScanLevels L;
  L.n = 0;
  L.len = 0;
  L.w[0] = p;
  L.off[0] = 0;
  while (L.w[L.n] > kScanBlock) {
    const long long w = (L.w[L.n] + kScanBlock - 1) / kScanBlock;
    ++L.n;
    L.w[L.n] = w;
    L.off[L.n] = L.len;
    L.len += w;
  }
  return L;
}

// padded_cumsum of a[0, w) in place, by one warp, with the levels above it
// in a[w, w + scan_levels(w).len): each level's 16-blocks summed in order
// (a lane a block; totals to the next level), the top level by lane 0, then
// from the top down each level adds the scanned value before its block.
__device__ void warp_padded_cumsum(float* a, long long w, int lane) {
  const ScanLevels S = scan_levels(w);
  auto level = [&](int l) { return l == 0 ? a : a + w + S.off[l]; };
  for (int l = 0; l < S.n; ++l) {
    float* lev = level(l);
    float* up = level(l + 1);
    const long long wl = S.w[l];
    for (long long b = lane; b < (wl + kScanBlock - 1) / kScanBlock; b += 32) {
      float acc = 0.0f;
      for (int x = 0; x < kScanBlock; ++x) {
        const long long q = b * kScanBlock + x;
        const float v = q < wl ? lev[q] : 0.0f;
        acc = x == 0 ? v : __fadd_rn(acc, v);
        if (q < wl) lev[q] = acc;
      }
      up[b] = acc;
    }
    __syncwarp();
  }
  if (lane == 0) {
    float* top = level(S.n);
    for (long long q = 1; q < S.w[S.n]; ++q) top[q] = __fadd_rn(top[q - 1], top[q]);
  }
  __syncwarp();
  for (int l = S.n - 1; l >= 0; --l) {
    float* lev = level(l);
    const float* up = level(l + 1);
    for (long long q = lane; q < S.w[l]; q += 32)
      if (q >= kScanBlock) lev[q] = __fadd_rn(lev[q], up[q / kScanBlock - 1]);
    __syncwarp();
  }
}

// Where the wide kernels' arrays lie in the scratch for n rows of P and K
// draws, in 32-bit words.  The wrapper asks its size of
// its_select_wide_scratch_words and allocates it; the launch lays it out
// again from the same (n, P, K).  Block arrays hold nbp words a row, 256 a
// chunk; chunk arrays w3.
struct WideLayout {
  long long w3;   // chunks a row
  long long nbp;  // block words a row: kChunkBlocks a chunk
  long long lev;  // B's words a row: the chunk totals' scan and its upper levels
  long long set;  // words a row of D's set in device memory (0: in shared memory)
  int slots;      // hash slots of the set: a power of two >= 2K
  int gshift;     // D's table holds every (1 << gshift)-th block's first entry
  float *bx0, *btot, *s1;       // A, a block: first entry, total, level-1 in-block sum
  float* s2;                    // A, a chunk: its 16 level-2 in-block sums (16 words)
  int* npos;                    // A, a chunk: positive entries
  float *pre1, *pre2, *pre3;    // B, a chunk: T1[256c - 1], T2[16c - 1], T3[c - 1]
  float *bpre, *bfirst;         // C, a block: the value added to its in-block sums, first entry
  float *pml, *sml;             // C, a block: the envelope's runs inside its chunk
  float *cmax, *cmin;           // C, a chunk: largest last entry, smallest first entry
  float* work;                  // B's scan, lev words a row
  int* setmem;                  // D's set (keys, values, a draw's slot), set words a row
  long long words;
};

inline WideLayout wide_layout(float* base, long long n, long long p, long long k) {
  WideLayout L;
  L.w3 = (p + kChunk - 1) / kChunk;
  L.nbp = L.w3 * kChunkBlocks;
  L.lev = L.w3 + scan_levels(L.w3).len;
  const long long nb = (p + kScanBlock - 1) / kScanBlock;
  L.gshift = 0;
  while (((nb - 1) >> L.gshift) + 1 > kFirstTableWords) ++L.gshift;
  L.slots = 2;
  while (L.slots < 2 * k) L.slots *= 2;
  const long long set_words = 2LL * L.slots + k;
  L.set = 4 * set_words <= kSetSmemBytes ? 0 : set_words;
  long long at = 0;
  auto take = [&](long long words) {
    float* q = base ? base + at : nullptr;
    at += words;
    return q;
  };
  float** blocks[] = {&L.bx0, &L.btot, &L.s1, &L.bpre, &L.bfirst, &L.pml, &L.sml};
  for (float** b : blocks) *b = take(n * L.nbp);
  L.s2 = take(n * L.w3 * kScanBlock);
  float** chunks[] = {&L.pre1, &L.pre2, &L.pre3, &L.cmax, &L.cmin};
  for (float** c : chunks) *c = take(n * L.w3);
  L.npos = reinterpret_cast<int*>(take(n * L.w3));
  L.work = take(n * L.lev);
  L.setmem = reinterpret_cast<int*>(take(n * L.set));
  L.words = at;
  return L;
}

// A on chunk c of row i.  Lane `lane` of warp `warp` holds the entries
// base + 128m + 4lane + e, base = c * kChunk + 512 warp (m, e < 4): float4 m
// of 16-block jb = 32 warp + 8m + lane / 4 of the chunk, quarter lane % 4.
template <bool kVec>
__global__ void __launch_bounds__(kChunkThreads) its_select_chunk_kernel(
    const float* __restrict__ biases, WideLayout L, int p) {
  constexpr int kPad = kChunkBlocks + kChunkBlocks / kScanBlock;  // 17 words a level-1 block
  __shared__ float s_tot[kPad], s_s1[kPad], s_x0[kChunkBlocks], s_l2[kScanBlock];
  __shared__ int s_npos;
  const long long i = blockIdx.x / L.w3;
  const int c = (int)(blockIdx.x % L.w3);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* row = biases + i * p;
  const long long base = (long long)c * kChunk + 512 * warp;
  if (tid == 0) s_npos = 0;
  float v[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const long long q = base + 128 * m + 4 * lane;
    if constexpr (kVec) {  // P % 4 == 0: a float4 lies wholly inside or past the row
      const float4 x = q < p ? __ldg(reinterpret_cast<const float4*>(row + q))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[m][0] = x.x;
      v[m][1] = x.y;
      v[m][2] = x.z;
      v[m][3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[m][e] = q + e < p ? __ldg(row + q + e) : 0.0f;
    }
  }
  int npos = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[m][e] = fmaxf(v[m][e], 0.0f);
      npos += v[m][e] > 0.0f;
    }
  }
  // level 0: the in-block sums, quarter by quarter in order
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int jb = 32 * warp + 8 * m + (lane >> 2);
    float run = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float carry = __shfl_up_sync(kFull, run, 1);
      if ((lane & 3) == s) {
        float acc = s == 0 ? v[m][0] : __fadd_rn(carry, v[m][0]);
#pragma unroll
        for (int e = 1; e < 4; ++e) acc = __fadd_rn(acc, v[m][e]);
        run = acc;
      }
    }
    if ((lane & 3) == 0) s_x0[jb] = v[m][0];
    if ((lane & 3) == 3) s_tot[jb + (jb >> 4)] = run;
  }
  npos = __reduce_add_sync(kFull, npos);
  __syncthreads();
  if (lane == 0) atomicAdd(&s_npos, npos);
  // levels 1 and 2: 16 lanes a level-1 block each, then lane 0 level 2
  if (warp == 0) {
    if (lane < kScanBlock) {
      const float* b = s_tot + (kScanBlock + 1) * lane;
      float* s = s_s1 + (kScanBlock + 1) * lane;
      float acc = b[0];
      s[0] = acc;
      for (int x = 1; x < kScanBlock; ++x) {
        acc = __fadd_rn(acc, b[x]);
        s[x] = acc;
      }
      s_l2[lane] = acc;
    }
    __syncwarp();
    if (lane == 0) {
      float acc = s_l2[0];
      for (int x = 1; x < kScanBlock; ++x) {
        acc = __fadd_rn(acc, s_l2[x]);
        s_l2[x] = acc;
      }
    }
  }
  __syncthreads();
  const long long at = i * L.nbp + (long long)c * kChunkBlocks + tid;  // block tid
  L.bx0[at] = s_x0[tid];
  L.btot[at] = s_tot[tid + (tid >> 4)];
  L.s1[at] = s_s1[tid + (tid >> 4)];
  const long long t = i * L.w3 + c;
  if (tid < kScanBlock) L.s2[t * kScanBlock + tid] = s_l2[tid];
  if (tid == 0) L.npos[t] = s_npos;
}

// B: row i's chunk totals scanned (T3) and each chunk's three prefixes.
__global__ void __launch_bounds__(kPrefixWarps * 32) its_select_prefix_kernel(WideLayout L,
                                                                              int n) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kPrefixWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const long long w3 = L.w3;
  const float* s2 = L.s2 + i * w3 * kScanBlock;  // a chunk's total is its s2[15]
  const float* s1 = L.s1 + i * L.nbp;            // its e1 s1[255], its e2 s2[14]
  float* t3 = L.work + i * L.lev;
  for (long long c = lane; c < w3; c += 32) t3[c] = s2[c * kScanBlock + kScanBlock - 1];
  __syncwarp();
  warp_padded_cumsum(t3, w3, lane);
  for (long long c = lane; c < w3; c += 32) {
    float p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;  // chunk 0 adds nothing
    if (c >= 1) {
      const float tot = s2[(c - 1) * kScanBlock + kScanBlock - 1];
      const float e2 = s2[(c - 1) * kScanBlock + kScanBlock - 2];
      const float e1 = s1[c * kChunkBlocks - 1];
      p3 = t3[c - 1];
      p2 = c >= 2 ? __fadd_rn(tot, t3[c - 2]) : tot;
      p1 = __fadd_rn(e1, c >= 2 ? __fadd_rn(e2, t3[c - 2]) : e2);
    }
    L.pre1[i * w3 + c] = p1;
    L.pre2[i * w3 + c] = p2;
    L.pre3[i * w3 + c] = p3;
  }
}

// C on chunk c of row i: thread tid takes 16-block tid of the chunk.
__global__ void __launch_bounds__(kChunkThreads) its_select_envelope_kernel(WideLayout L,
                                                                            int p) {
  __shared__ float s_warp[2][kChunkThreads / 32];
  const long long i = blockIdx.x / L.w3;
  const int c = (int)(blockIdx.x % L.w3);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t = i * L.w3 + c;
  const long long at = i * L.nbp + (long long)c * kChunkBlocks + tid;
  // the value the tree adds to the block's in-block sums (none to the row's first block)
  float b = L.pre1[t];
  bool add = c > 0;
  if (tid > 0) {
    const int im = (tid - 1) >> 4;
    b = L.s1[at - 1];
    if (im == 0) {
      if (c > 0) b = __fadd_rn(b, L.pre2[t]);
    } else {
      const float e2 = L.s2[t * kScanBlock + im - 1];
      b = __fadd_rn(b, c > 0 ? __fadd_rn(e2, L.pre3[t]) : e2);
    }
    add = true;
  }
  L.bpre[at] = add ? b : 0.0f;
  // its first and last entries (a block past the row: neutral); its last
  // real entry's in-block sum is its total, the zeros after it add nothing
  const bool live = (long long)c * kChunk + (long long)kScanBlock * tid < p;
  const float x0 = L.bx0[at], tot = L.btot[at];
  float lo = live ? (add ? __fadd_rn(x0, b) : x0) : INFINITY;
  float hi = live ? (add ? __fadd_rn(tot, b) : tot) : -INFINITY;
  L.bfirst[at] = lo;
  // the chunk's runs
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float h = __shfl_up_sync(kFull, hi, d), l = __shfl_down_sync(kFull, lo, d);
    if (lane >= d) hi = fmaxf(hi, h);
    if (lane + d < 32) lo = fminf(lo, l);
  }
  if (lane == 31) s_warp[0][warp] = hi;
  if (lane == 0) s_warp[1][warp] = lo;
  __syncthreads();
  for (int w = 0; w < warp; ++w) hi = fmaxf(hi, s_warp[0][w]);
  for (int w = warp + 1; w < kChunkThreads / 32; ++w) lo = fminf(lo, s_warp[1][w]);
  L.pml[at] = hi;
  L.sml[at] = lo;
  if (tid == kChunkThreads - 1) L.cmax[t] = hi;
  if (tid == 0) L.cmin[t] = lo;
}

// The envelope of one row (see exact_count), by a block, in place: pm[b]
// holds block b's last entry and sm[b] its first on entry, the running
// maximum from block 0 and the running minimum from block nb - 1 on exit.
// Each thread takes a run of consecutive blocks: it reduces its run (loads
// independent of each other), the runs' extremes are scanned across the
// block (shuffles within a warp, sh, 64 floats of shared memory, across
// warps), and each thread rewrites its run.
__device__ void block_envelope(long long nb, float* __restrict__ pm, float* __restrict__ sm,
                               float* sh) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const long long run = (nb + bd - 1) / bd;
  const long long b0 = min(tid * run, nb), b1 = min(b0 + run, nb);
  float hi = -INFINITY, lo = INFINITY;
  for (long long b = b0; b < b1; ++b) {
    hi = fmaxf(hi, pm[b]);
    lo = fminf(lo, sm[b]);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float h = __shfl_up_sync(kFull, hi, d), l = __shfl_down_sync(kFull, lo, d);
    if (lane >= d) hi = fmaxf(hi, h);
    if (lane + d < 32) lo = fminf(lo, l);
  }
  if (lane == 31) sh[warp] = hi;
  if (lane == 0) sh[32 + warp] = lo;
  __syncthreads();
  float before = __shfl_up_sync(kFull, hi, 1), after = __shfl_down_sync(kFull, lo, 1);
  if (lane == 0) before = -INFINITY;
  if (lane == 31) after = INFINITY;
  for (int w = 0; w < warp; ++w) before = fmaxf(before, sh[w]);
  for (int w = warp + 1; w < bd / 32; ++w) after = fminf(after, sh[32 + w]);
  for (long long b = b0; b < b1; ++b) {
    before = fmaxf(before, pm[b]);
    pm[b] = before;
  }
  for (long long b = b1 - 1; b >= b0; --b) {
    after = fminf(after, sm[b]);
    sm[b] = after;
  }
  __syncthreads();
}

// One row as D reads it: the biases, C's block arrays, a table of every
// G-th block's first entry divided by the total (G = 1 << gshift, at most
// kFirstTableWords entries, in shared memory) and the chunks' running
// extremes (shared memory, or device memory for very long rows).
struct WideRow {
  const float *bias, *bpre, *bfirst, *btot, *pml, *sml;
  const float *tab, *cpm, *csm;
  long long w3, nb;
  int p, gshift;
  bool vec;  // the row's 16-blocks load as float4s
  float total;

  // pm(b) and sm(b) of exact_count: a chunk's run joined with the running
  // extremes of the chunks before it (cpm, inclusive) or after it (csm)
  __device__ __forceinline__ float pm(long long b) const {
    const long long c = b / kChunkBlocks;
    return c > 0 ? fmaxf(pml[b], cpm[c - 1]) : pml[b];
  }
  __device__ __forceinline__ float sm(long long b) const {
    const long long c = b / kChunkBlocks;
    return c + 1 < w3 ? fminf(sml[b], csm[c + 1]) : sml[b];
  }
  __device__ __forceinline__ float ctps(float s) const { return __fdiv_rn(s, total); }

  // The undivided CTPS of 16-block x, s[e] at entry 16x + e, and its
  // biases, raw[e] (entries past the row: zeros), from its biases and
  // bpre[x], added as A and C add them.
  __device__ __forceinline__ void block(long long x, float (&s)[kScanBlock],
                                        float (&raw)[kScanBlock]) const {
    const long long q0 = x * kScanBlock;
    if (vec) {
#pragma unroll
      for (int e = 0; e < kScanBlock; e += 4) {
        const float4 v = q0 + e < p ? __ldg(reinterpret_cast<const float4*>(bias + q0 + e))
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        raw[e] = v.x;
        raw[e + 1] = v.y;
        raw[e + 2] = v.z;
        raw[e + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kScanBlock; ++e) raw[e] = q0 + e < p ? __ldg(bias + q0 + e) : 0.0f;
    }
    const float b = x > 0 ? __ldg(bpre + x) : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < kScanBlock; ++e) {
      const float v = fmaxf(raw[e], 0.0f);
      acc = e == 0 ? v : __fadd_rn(acc, v);
      s[e] = x > 0 ? __fadd_rn(acc, b) : acc;
    }
  }

  // the undivided CTPS at entry q
  __device__ __forceinline__ float at(long long q) const {
    float s[kScanBlock], raw[kScanBlock];
    block(q / kScanBlock, s, raw);
    return pick(s, q % kScanBlock);
  }

  static __device__ __forceinline__ float pick(const float (&s)[kScanBlock], long long e) {
    float v = s[0];
#pragma unroll
    for (int x = 1; x < kScanBlock; ++x)
      if (x == e) v = s[x];
    return v;
  }
};

// count_straddled on the split envelope.  A straddled block whose first
// entry (bfirst) is > r counts nothing, one whose last (btot + bpre, as C
// adds it) is <= r counts whole, and only a block that holds r is loaded:
// in a run of zero biases every block is flat, and the run costs three
// words a block.
__device__ __noinline__ int wide_count_straddled(const WideRow R, float r) {
  const long long p = R.p, nb = R.nb;
  long long lo = 0, hi = nb;  // blocks [0, a): all <= r
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (R.ctps(R.pm(mid)) <= r) lo = mid + 1;
    else hi = mid;
  }
  const long long a = lo;
  lo = 0;
  hi = nb;  // blocks [b, nb): all > r
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (R.ctps(R.sm(mid)) <= r) lo = mid + 1;
    else hi = mid;
  }
  long long c = min(a * kScanBlock, p);
  for (long long x = a; x < lo; ++x) {
    if (R.ctps(__ldg(R.bfirst + x)) > r) continue;
    const float last = x > 0 ? __fadd_rn(__ldg(R.btot + x), __ldg(R.bpre + x)) : __ldg(R.btot);
    if (R.ctps(last) <= r) {
      c += min(p - x * kScanBlock, (long long)kScanBlock);
      continue;
    }
    float s[kScanBlock], raw[kScanBlock];
    R.block(x, s, raw);
#pragma unroll
    for (int e = 0; e < kScanBlock; ++e) c += x * kScanBlock + e < p && R.ctps(s[e]) <= r;
  }
  return (int)c;
}

// What a search found: the region idx (the count of CTPS entries <= r,
// clipped to P - 1), whether its candidate has mass, and the block x it
// ended in with that block's undivided CTPS s and biases raw, which the
// region search and the mass test reuse.
struct Found {
  int idx;
  bool mass;
  long long x;
  float s[kScanBlock], raw[kScanBlock];
};

// The region of r.  The binary search keeps lo == 0 or s[lo - 1] <= r, and
// hi == P or s[hi] > r, whatever entries it tests: the table's entries
// (shared memory) until [lo, hi) holds no table block's start, the blocks'
// first entries (C's, a few MB a launch, which L2 keeps) until it holds no
// block start, so it lies in one 16-block x, which is nondecreasing: its
// count of entries <= r ends the search.  Block x's entries, biases and
// the four envelope words exact_count may read (pm of blocks x - 2 and
// x - 1, sm of x + 1 and x + 2) are loaded together, so a search costs
// log2(G) dependent reads of L2 and one of device memory when no step of
// the CTPS lies beside r.
__device__ __forceinline__ void wide_search(const WideRow& R, float r, Found& f) {
  const int p = R.p;
  const long long nb = R.nb;
  int lo = 0, hi = p;
  const int span = kScanBlock << R.gshift;  // entries a table step
  for (int jlo = 0, jhi = (p + span - 1) / span; jlo < jhi;) {
    const int j = (jlo + jhi) >> 1;
    if (R.tab[j] <= r) {
      lo = j * span + 1;
      jlo = j + 1;
    } else {
      hi = j * span;
      jhi = j;
    }
  }
  for (int xlo = (lo + kScanBlock - 1) / kScanBlock, xhi = (hi + kScanBlock - 1) / kScanBlock;
       xlo < xhi;) {
    const int x = (xlo + xhi) >> 1;
    if (R.ctps(__ldg(R.bfirst + x)) <= r) {
      lo = x * kScanBlock + 1;
      xlo = x + 1;
    } else {
      hi = x * kScanBlock;
      xhi = x;
    }
  }
  // u lies in [16x, 16x + 16]: exact_count reads pm(ba - 1), ba - 1 in
  // {x - 2, x - 1}, and sm(bb + 1), bb + 1 in {x + 1, x + 2}
  const long long x = lo / kScanBlock;
  const float pm2 = x >= 2 ? R.pm(x - 2) : -INFINITY, pm1 = x >= 1 ? R.pm(x - 1) : -INFINITY;
  const float sm1 = x + 1 < nb ? R.sm(x + 1) : INFINITY, sm2 = x + 2 < nb ? R.sm(x + 2) : INFINITY;
  R.block(min(x, nb - 1), f.s, f.raw);
  f.x = min(x, nb - 1);
  int u = lo;
#pragma unroll
  for (int e = 0; e < kScanBlock; ++e) {
    const long long q = x * kScanBlock + e;
    u += q >= lo && q < hi && R.ctps(f.s[e]) <= r;
  }
  const int ba = (u - 1) / kScanBlock, bb = u / kScanBlock;
  const bool settled =
      (u == 0 || ba == 0 || R.ctps(ba - 1 == x - 2 ? pm2 : pm1) <= r) &&
      (u == p || bb + 1 >= nb || R.ctps(bb + 1 == x + 1 ? sm1 : sm2) > r);
  f.idx = min(settled ? u : wide_count_straddled(R, r), p - 1);
  f.mass = f.idx / kScanBlock == f.x ? WideRow::pick(f.raw, f.idx % kScanBlock) > 0.0f
                                     : __ldg(R.bias + f.idx) > 0.0f;
}

// D's set of candidates: open addressing over `slots` keys (-1 free) and
// values (kUnclaimed, the lowest claiming draw, or kTaken).
__device__ __forceinline__ unsigned set_slot(int c, int slots) {
  unsigned x = (unsigned)c;
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x & (unsigned)(slots - 1);
}

// Whether candidate c was taken in an earlier round (claims of this round,
// landing meanwhile, are not kTaken).
__device__ __forceinline__ bool set_taken(const int* keys, const int* vals, int slots, int c) {
  const volatile int* vk = keys;
  const volatile int* vv = vals;
  for (unsigned x = set_slot(c, slots);; x = (x + 1) & (unsigned)(slots - 1)) {
    const int key = vk[x];
    if (key == c) return vv[x] == kTaken;
    if (key < 0) return false;
  }
}

// Draw j claims candidate c; returns c's slot.  At most K keys are ever
// inserted (each claimed candidate gets a winner), so a free slot is found.
__device__ __forceinline__ int set_claim(int* keys, int* vals, int slots, int c, int j) {
  for (unsigned x = set_slot(c, slots);; x = (x + 1) & (unsigned)(slots - 1)) {
    const int key = atomicCAS(keys + x, -1, c);
    if (key < 0 || key == c) {
      atomicMin(vals + x, j);
      return (int)x;
    }
  }
}

// D: a block a row; see above.  Dynamic shared memory holds the table of
// block first entries, the chunks' running extremes (when ext_smem) and then
// the set (when L.set == 0).
__global__ void __launch_bounds__(kRoundsThreads) its_select_rounds_kernel(
    const float* __restrict__ biases, const float* __restrict__ rands, int* __restrict__ out,
    int* __restrict__ stats, WideLayout L, int p, int iters, int k, int vec, int ext_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_env[64];
  __shared__ int s_npos, s_searches;
  const long long i = blockIdx.x;
  const int tid = threadIdx.x, bd = blockDim.x;
  const long long w3 = L.w3, nb = (p + kScanBlock - 1) / kScanBlock;
  const long long nt = (nb + (1LL << L.gshift) - 1) >> L.gshift;
  const float* bfirst = L.bfirst + i * L.nbp;
  float* cpm = L.cmax + i * w3;
  float* csm = L.cmin + i * w3;
  WideRow R{biases + i * p, L.bpre + i * L.nbp, bfirst, L.btot + i * L.nbp, L.pml + i * L.nbp,
            L.sml + i * L.nbp, nullptr, cpm, csm, w3, nb, p, L.gshift, vec != 0, 1.0f};
  R.total = fmaxf(R.at(p - 1), 1e-12f);
  // the table, divided by the total as it is copied
  float* tab = reinterpret_cast<float*>(smem);
  for (long long j0 = tid; j0 < nt; j0 += 8 * bd) {  // eight loads in flight a thread
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long j = j0 + (long long)u * bd;
      v[u] = j < nt ? __ldg(bfirst + (j << L.gshift)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + (long long)u * bd < nt) tab[j0 + (long long)u * bd] = R.ctps(v[u]);
  }
  R.tab = tab;
  unsigned char* at = smem + (4 * nt + 15) / 16 * 16;
  if (ext_smem) {
    float* ext = reinterpret_cast<float*>(at);
    for (long long c = tid; c < w3; c += bd) {
      ext[c] = cpm[c];
      ext[w3 + c] = csm[c];
    }
    cpm = ext;
    csm = ext + w3;
    R.cpm = cpm;
    R.csm = csm;
    at += (8 * w3 + 15) / 16 * 16;
  }
  const int slots = L.slots;
  int* keys = L.set ? L.setmem + i * L.set : reinterpret_cast<int*>(at);
  int* vals = keys + slots;
  int* slot_of = vals + slots;  // the slot each draw claimed this round, or -1
  for (int x = tid; x < slots; x += bd) {
    keys[x] = -1;
    vals[x] = kUnclaimed;
  }
  for (int j = tid; j < k; j += bd) out[i * k + j] = -1;
  if (tid == 0) {
    s_npos = 0;
    s_searches = 0;
  }
  __syncthreads();
  int np = 0;
  for (long long c = tid; c < w3; c += bd) np += L.npos[i * w3 + c];
  atomicAdd(&s_npos, np);
  block_envelope(w3, cpm, csm, s_env);  // ends with a barrier
  const int want = min(s_npos, k);
  int rounds = 0, searches = 0;
  Found f;
  for (int t = 0; t < iters; ++t) {
    bool pending = false;
    for (int j = tid; j < want; j += bd) pending = pending || out[i * k + j] < 0;
    if (!__syncthreads_or(pending)) break;  // later rounds change nothing
    ++rounds;
    for (int j = tid; j < want; j += bd) {
      int slot = -1;
      if (out[i * k + j] < 0) {
        const float r1 = __ldg(rands + (i * iters + t) * k + j);
        wide_search(R, r1, f);
        const int idx1 = f.idx;
        const bool hit1 = set_taken(keys, vals, slots, idx1);
        searches += 1 + hit1;
        if (hit1) {  // region search past the taken region
          // S[idx1 - 1] and S[idx1], from the search's block where they lie in it
          const long long e1 = idx1 - f.x * kScanBlock;
          const float s1 = e1 >= 0 && e1 < kScanBlock ? WideRow::pick(f.s, e1) : R.at(idx1);
          const float s0 = idx1 == 0                   ? 0.0f
                           : e1 >= 1 && e1 <= kScanBlock ? WideRow::pick(f.s, e1 - 1)
                                                         : R.at(idx1 - 1);
          const float lo = idx1 > 0 ? R.ctps(s0) : 0.0f;
          const float delta = __fsub_rn(R.ctps(s1), lo);
          float r2 = __fmul_rn(r1, __fsub_rn(1.0f, delta));
          r2 = r2 < lo ? r2 : __fadd_rn(r2, delta);
          r2 = fminf(fmaxf(r2, 0.0f), 1.0f);
          wide_search(R, r2, f);
        }
        if (f.mass && !(hit1 && set_taken(keys, vals, slots, f.idx)))
          slot = set_claim(keys, vals, slots, f.idx, j);
      }
      slot_of[j] = slot;
    }
    __syncthreads();  // every claim of the round has landed
    for (int j = tid; j < want; j += bd) {
      const int x = slot_of[j];
      if (x >= 0 && reinterpret_cast<volatile int*>(vals)[x] == j) {  // the lowest claiming draw
        out[i * k + j] = keys[x];
        vals[x] = kTaken;
      }
    }
    __syncthreads();  // the winners are taken before the next round's tests
  }
  atomicAdd(&s_searches, searches);
  __syncthreads();
  if (tid == 0) {
    stats[2 * i] = rounds;
    stats[2 * i + 1] = s_searches;
  }
}

// The step kernels' key source: the host's words by value (key_table null),
// a device table of nkeys keys a row for rows of `width` walkers, or (with
// entry_depth and entry_inst) a table of nkeys keys a depth for entries.
template <int N>
ValueKeys<N> value_keys(const unsigned* words) {
  ValueKeys<N> keys;
  for (int j = 0; j < N; ++j) keys.k[j] = Key{words[2 * j], words[2 * j + 1]};
  return keys;
}

template <class Keys>
void walk_step_run(const void* cur, const void* indptr, const void* indices, const void* bias,
                   void* out, int w, int n_bias, const Ladder& L, Keys keys, cudaStream_t st) {
  const int blocks = (w + kThreads - 1) / kThreads;
  if ((uintptr_t)bias % 16 == 0) {
    walk_step_kernel<true, Keys><<<blocks, kThreads, 0, st>>>(
        (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)bias, (int*)out,
        w, n_bias, L, keys);
  } else {
    walk_step_kernel<false, Keys><<<blocks, kThreads, 0, st>>>(
        (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)bias, (int*)out,
        w, n_bias, L, keys);
  }
}

}  // namespace

extern "C" {

int reject_step_launch(const void* cur, const void* indptr, const void* indices,
                       const void* bias, const void* row_max, void* out, int w,
                       const int* ladder, const unsigned* key_words, const void* key_table,
                       int width, const void* entry_depth, const void* entry_inst,
                       void* stream) {
  if (w > 0) {
    constexpr int N = 2 * kRejectIters;
    const int blocks = (w + kThreads - 1) / kThreads;
    cudaStream_t st = (cudaStream_t)stream;
    const Ladder L = make_ladder(ladder);
    const uint2* tab = (const uint2*)key_table;
    if (entry_depth) {
      reject_step_kernel<EntryKeys<N>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)bias,
          (const float*)row_max, (int*)out, w, L,
          EntryKeys<N>{tab, (const int*)entry_depth, (const int*)entry_inst});
    } else if (key_table) {
      reject_step_kernel<TableKeys<N>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)bias,
          (const float*)row_max, (int*)out, w, L, TableKeys<N>{tab, width});
    } else {
      reject_step_kernel<ValueKeys<N>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)bias,
          (const float*)row_max, (int*)out, w, L, value_keys<N>(key_words));
    }
  }
  return (int)cudaGetLastError();
}

int alias_step_launch(const void* cur, const void* indptr, const void* indices,
                      const void* prob, const void* alias, void* out, int w, const int* ladder,
                      const unsigned* key_words, const void* key_table, int width,
                      const void* entry_depth, const void* entry_inst, void* stream) {
  if (w > 0) {
    const int blocks = (w + kThreads - 1) / kThreads;
    cudaStream_t st = (cudaStream_t)stream;
    const Ladder L = make_ladder(ladder);
    const uint2* tab = (const uint2*)key_table;
    if (entry_depth) {
      alias_step_kernel<EntryKeys<2>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)prob,
          (const int*)alias, (int*)out, w, L,
          EntryKeys<2>{tab, (const int*)entry_depth, (const int*)entry_inst});
    } else if (key_table) {
      alias_step_kernel<TableKeys<2>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)prob,
          (const int*)alias, (int*)out, w, L, TableKeys<2>{tab, width});
    } else {
      alias_step_kernel<ValueKeys<2>><<<blocks, kThreads, 0, st>>>(
          (const int*)cur, (const int*)indptr, (const int*)indices, (const float*)prob,
          (const int*)alias, (int*)out, w, L, value_keys<2>(key_words));
    }
  }
  return (int)cudaGetLastError();
}

int walk_step_launch(const void* cur, const void* indptr, const void* indices,
                     const void* bias, void* out, int w, int n_bias, const int* ladder,
                     const unsigned* key_words, const void* key_table, int width,
                     const void* entry_depth, const void* entry_inst, void* stream) {
  if (w > 0) {
    const Ladder L = make_ladder(ladder);
    cudaStream_t st = (cudaStream_t)stream;
    const uint2* tab = (const uint2*)key_table;
    if (entry_depth) {
      walk_step_run(cur, indptr, indices, bias, out, w, n_bias, L,
                    EntryKeys<1>{tab, (const int*)entry_depth, (const int*)entry_inst}, st);
    } else if (key_table) {
      walk_step_run(cur, indptr, indices, bias, out, w, n_bias, L, TableKeys<1>{tab, width}, st);
    } else {
      walk_step_run(cur, indptr, indices, bias, out, w, n_bias, L, value_keys<1>(key_words), st);
    }
  }
  return (int)cudaGetLastError();
}

int walk_step_window_launch(const void* starts, const void* degs, const void* indices,
                            const void* bias_rows, const void* rand, void* out, int w, int seg,
                            void* stream) {
  if (w > 0) {
    walk_step_window_kernel<<<(w + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)indices, (const float*)bias_rows,
        (const float*)rand, (int*)out, w, seg);
  }
  return (int)cudaGetLastError();
}

int its_select_launch(const void* biases, const void* rands, void* out, void* stats, int n,
                      int p, int iters, int k, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int nb = (p + kScanBlock - 1) / kScanBlock;
  const float* b = (const float*)biases;
  const float* r = (const float*)rands;
  cudaStream_t st = (cudaStream_t)stream;
  if (nb <= 32) return (int)its_select_run<1>(b, r, (int*)out, (int*)stats, n, p, iters, k, st);
  if (nb <= 64) return (int)its_select_run<2>(b, r, (int*)out, (int*)stats, n, p, iters, k, st);
  // P > 1024: the in-block sums no longer fit in registers, and one build
  // (its b < nb guards) serves every P up to 4096
  return (int)its_select_run<8>(b, r, (int*)out, (int*)stats, n, p, iters, k, st);
}

// Rows the warp-per-instance kernel does not take (K > 32 or P > 4096), or
// any rows when the caller asks for this path: the phases A-D of the wide
// kernels, one launch each, over a scratch of
// its_select_wide_scratch_words(n, p, k) 32-bit words.
int its_select_wide_launch(const void* biases, const void* rands, void* out, void* stats,
                           void* scratch, int n, int p, int iters, int k, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const WideLayout L = wide_layout((float*)scratch, n, p, k);
  const float* b = (const float*)biases;
  const bool vec = p % 4 == 0 && (uintptr_t)b % 16 == 0;
  const long long chunks = (long long)n * L.w3;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  // A: the chunks' in-block sums
  if (vec) its_select_chunk_kernel<true><<<(int)chunks, kChunkThreads, 0, st>>>(b, L, p);
  else its_select_chunk_kernel<false><<<(int)chunks, kChunkThreads, 0, st>>>(b, L, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // B: the rows' prefix tables
  its_select_prefix_kernel<<<(n + kPrefixWarps - 1) / kPrefixWarps, kPrefixWarps * 32, 0, st>>>(
      L, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // C: each 16-block's prefix and the envelope
  its_select_envelope_kernel<<<(int)chunks, kChunkThreads, 0, st>>>(L, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // D: the rounds
  const long long nb = (p + kScanBlock - 1) / kScanBlock;
  const long long nt = ((nb - 1) >> L.gshift) + 1;
  const bool ext_smem = 8 * L.w3 <= kExtSmemBytes;
  const long long smem = (4 * nt + 15) / 16 * 16 + (ext_smem ? (8 * L.w3 + 15) / 16 * 16 : 0) +
                         (L.set ? 0 : 4 * (2LL * L.slots + k));
  if ((e = cudaFuncSetAttribute(its_select_rounds_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)e;
  const int threads = std::min(kRoundsThreads, (k + 31) / 32 * 32);
  its_select_rounds_kernel<<<n, threads, (int)smem, st>>>(
      b, (const float*)rands, (int*)out, (int*)stats, L, p, iters, k, vec, ext_smem);
  return (int)cudaGetLastError();
}

long long its_select_wide_scratch_words(int n, int p, int k) {
  return wide_layout(nullptr, n, p, k).words;
}

int hash_uniform_launch(const void* keys, const void* counters, void* out, int nkeys, int n,
                        void* stream) {
  const long long total = (long long)nkeys * n;
  if (total > 0) {
    const int blocks = (int)std::min<long long>((total + kThreads - 1) / kThreads, 1 << 16);
    hash_uniform_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)keys, (const long long*)counters, (float*)out, nkeys, n);
  }
  return (int)cudaGetLastError();
}

int derive_keys_launch(const void* base, void* out, int rows, int n, const int* depth,
                       const unsigned* data, void* stream) {
  if (n < 1 || n > kMaxKeyPaths) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    KeyPaths paths;
    paths.n = n;
    for (int p = 0; p < kMaxKeyPaths; ++p) {
      paths.depth[p] = p < n ? depth[p] : 0;
      if (paths.depth[p] < 0 || paths.depth[p] > kMaxKeyDepth) return (int)cudaErrorInvalidValue;
      for (int d = 0; d < kMaxKeyDepth; ++d)
        paths.data[p][d] = p < n ? data[p * kMaxKeyDepth + d] : 0u;
    }
    const int total = rows * n;
    derive_keys_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint2*)base, (uint2*)out, rows, paths);
  }
  return (int)cudaGetLastError();
}

const char* walk_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
