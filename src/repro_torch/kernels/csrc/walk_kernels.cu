// Walk-step and selection kernels for Hopper (sm_90a): one random-walk
// transition per walker over a flat CSR graph (rejection, alias, flat-bias
// ITS, window-bias ITS), and ITS selection of K of P candidates with
// bipartite region search.
//
// Each kernel computes what a Pallas TPU kernel of src/repro/kernels/
// computes, bit for bit, and is held against its plain PyTorch version in
// repro_torch/kernels/ref.py.  The TPU kernels DMA two max_seg-aligned
// blocks around each row and gather ids through an f32 one-hot reduction;
// both are TPU artifacts.  Here every walk kernel reads its walker's row
// [start, start + min(deg, cap)) directly and gathers the int32 id directly,
// which equals the reference for every id (the TPU kernels only below 2^24).
//
// What bounds them: bytes of random gathers.  A walker's row sits at a
// data-dependent offset in arrays far larger than L2, so each draw costs a
// few 32-byte sectors of device memory; the arithmetic is a handful of f32
// operations per gathered word.  The designs therefore keep gathers to the
// minimum each method needs (rejection: one bias word per round and one id,
// stopping at the first acceptance; alias: two table words and one id;
// ITS: the row once, coalesced across a warp), and launch enough walkers to
// keep many gathers in flight.
//
// Bit hazards: the build passes -fmad=false, and the products and
// differences that must round on their own use __fmul_rn / __fsub_rn /
// __fadd_rn, so no multiply-add contracts into an FMA.  Float to int is
// truncation, as XLA's astype(int32).
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() as an int; the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWindow = 1024;           // 2 * max_seg for max_seg <= 512
constexpr int kScanBlock = 16;             // XLA-CPU's scan block width
constexpr int kMaxBlocks = kMaxWindow / kScanBlock;

// Replaces reject_step_pallas (src/repro/kernels/walk_step.py:267, body
// _reject_step_kernel :96).  One thread per walker: up to `iters` rounds,
// each one 8-byte read of the walker's own random pair and one 4-byte bias
// gather; the first acceptance ends the loop, so a near-uniform row costs
// about one round.  rej is (W, iters, 2), read as contiguous f32.
__global__ void reject_step_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ degs,
                                   const int* __restrict__ indices,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ row_max,
                                   const float* __restrict__ rej,
                                   int* __restrict__ out, int w, int iters, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int deg = degs[i];
  const float rm = row_max[i];
  if (deg <= 0 || rm <= 0.0f) {
    out[i] = -1;
    return;
  }
  const int start = starts[i];
  const int deg_eff = min(deg, cap);
  const float degf = (float)deg_eff;
  const int hi = deg_eff - 1;
  const float2* r = reinterpret_cast<const float2*>(rej + (size_t)i * 2 * iters);
  int chosen = -1;
  int last = 0;
  float last_b = 0.0f;
  for (int t = 0; t < iters; ++t) {
    const float2 rt = r[t];
    const int slot = min((int)__fmul_rn(rt.x, degf), hi);
    const float b = bias[start + slot];
    if (__fmul_rn(rt.y, rm) < b) {
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
// _alias_step_kernel :29).  One thread per walker: one uniform splits into
// slot and coin, then two table gathers at the same position and one id
// gather.  No scan and no loop: three dependent random reads per walker.
__global__ void alias_step_kernel(const int* __restrict__ starts,
                                  const int* __restrict__ degs,
                                  const int* __restrict__ indices,
                                  const float* __restrict__ prob,
                                  const int* __restrict__ alias,
                                  const float* __restrict__ rand,
                                  int* __restrict__ out, int w, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const int deg = degs[i];
  if (deg <= 0) {
    out[i] = -1;
    return;
  }
  const int start = starts[i];
  const int deg_eff = min(deg, cap);
  const int hi = deg_eff - 1;
  const float u = __fmul_rn(rand[i], (float)deg_eff);
  const int slot = min((int)u, hi);
  const float frac = __fsub_rn(u, (float)slot);
  const int pos = start + slot;
  const int a = alias[pos];
  if (a < 0) {  // zero-total row
    out[i] = -1;
    return;
  }
  int chosen = frac < prob[pos] ? slot : a;
  chosen = min(max(chosen, 0), hi);
  out[i] = indices[start + chosen];
}

// Sequential inclusive scan of n values in place (n <= 16).
__device__ __forceinline__ float seq_scan(float* v, int n) {
  float s = v[0];
  for (int j = 1; j < n; ++j) {
    s = __fadd_rn(s, v[j]);
    v[j] = s;
  }
  return s;
}

// In-place inclusive scan of win[0, n) by one warp, associated exactly as
// XLA-CPU's f32 cumsum (repro_torch/kernels/ref.py::padded_cumsum):
// sequential 16-wide blocks (lane b owns blocks b, b + 32, ...), the block
// totals scanned by the same rule one level up, then each block's exclusive
// prefix added to its in-block sums.  Each level is zero-padded to whole
// blocks: the caller zero-fills win[n, round16(n)); tot has room for
// round16(round16(n) / 16) floats and grp for 16, so n <= 4096.
__device__ void warp_scan(float* win, float* tot, float* grp, int n, int lane) {
  const int nb = (n + kScanBlock - 1) / kScanBlock;
  for (int b = lane; b < nb; b += 32) tot[b] = seq_scan(win + b * kScanBlock, kScanBlock);
  __syncwarp();
  if (nb <= kScanBlock) {
    if (lane == 0) seq_scan(tot, nb);
  } else {
    const int ng = (nb + kScanBlock - 1) / kScanBlock;
    for (int b = nb + lane; b < ng * kScanBlock; b += 32) tot[b] = 0.0f;
    __syncwarp();
    for (int g = lane; g < ng; g += 32) grp[g] = seq_scan(tot + g * kScanBlock, kScanBlock);
    __syncwarp();
    if (lane == 0) seq_scan(grp, ng);
    __syncwarp();
    for (int b = lane + kScanBlock; b < nb; b += 32)
      tot[b] = __fadd_rn(tot[b], grp[b / kScanBlock - 1]);
  }
  __syncwarp();
  for (int p = lane + kScanBlock; p < n; p += 32)
    win[p] = __fadd_rn(win[p], tot[p / kScanBlock - 1]);
  __syncwarp();
}

// The ITS pick shared by walk_step_kernel and walk_step_window_kernel, on a
// filled 2*seg window from the block origin blk0 = start / seg * seg (the
// row at [local, row_end), zeros elsewhere, which take part in the scan as
// in the reference).  The pick is the count of masked prefixes
// <= r * total, with total the scan's last element, summed by a warp
// reduction; lane 0 writes the neighbor id.
__device__ void window_pick(float* win, float* tot, float* grp, int n, int local, int row_end,
                            int deg, int blk0, float r, const int* __restrict__ indices,
                            int* out, int lane) {
  warp_scan(win, tot, grp, n, lane);
  const float total = win[n - 1];
  const float target = __fmul_rn(r, total);
  int cnt = 0;
  for (int p = lane; p < n; p += 32)
    cnt += (p >= local && p < row_end && win[p] <= target) ? 1 : 0;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) {
    const int pick = min(local + cnt, local + max(deg - 1, 0));
    *out = total <= 1e-12f ? -1 : indices[blk0 + pick];
  }
}

// Replaces walk_step_pallas (src/repro/kernels/walk_step.py:158, body
// _walk_step_kernel :29).  One warp per walker.  The window is the 2*seg
// positions from the block origin; the row is read once, coalesced across
// the warp, into shared memory, and window_pick scans it with the
// reference's association, so the pick equals the reference bit for bit.
__global__ void walk_step_kernel(const int* __restrict__ starts,
                                 const int* __restrict__ degs,
                                 const int* __restrict__ indices,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ rand,
                                 int* __restrict__ out, int w, int seg) {
  __shared__ float win_all[kWarpsPerBlock][kMaxWindow];
  __shared__ float tot_all[kWarpsPerBlock][kMaxBlocks];
  __shared__ float grp_all[kWarpsPerBlock][kScanBlock];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= w) return;  // the whole warp leaves together
  const int deg = degs[i];
  if (deg <= 0) {
    if (lane == 0) out[i] = -1;
    return;
  }
  float* win = win_all[warp];
  const int start = starts[i];
  const int local = start % seg;
  const int blk0 = start - local;
  const int n = 2 * seg;
  const int row_end = min(local + deg, n);
  for (int p = lane; p < n; p += 32)
    win[p] = (p >= local && p < row_end) ? bias[blk0 + p] : 0.0f;
  __syncwarp();
  window_pick(win, tot_all[warp], grp_all[warp], n, local, row_end, deg, blk0, rand[i],
              indices, out + i, lane);
}

// Replaces walk_step_window_pallas (src/repro/kernels/walk_step.py:211, body
// _walk_step_window_kernel :61): the ITS step of walk_step_kernel, with the
// bias computed per walker by the transition program's window hook
// (node2vec) instead of read from a flat array.  The TPU kernel takes that
// bias as a (W, 2*seg) operand re-aligned to its block window, which exists
// only for the TPU's BlockSpec alignment; this kernel takes the hook's
// compact row-aligned (W, seg) rows and places column j at window offset
// local + j, writing zeros elsewhere — the same values at the same
// positions, so the same bits, and no (W, 2*seg) tensor per cohort.
// Bound by bytes: each walker reads its deg bias words (contiguous, one
// coalesced pass) and gathers one id; the scan stays in shared memory.
__global__ void walk_step_window_kernel(const int* __restrict__ starts,
                                        const int* __restrict__ degs,
                                        const int* __restrict__ indices,
                                        const float* __restrict__ bias_rows,
                                        const float* __restrict__ rand,
                                        int* __restrict__ out, int w, int seg) {
  __shared__ float win_all[kWarpsPerBlock][kMaxWindow];
  __shared__ float tot_all[kWarpsPerBlock][kMaxBlocks];
  __shared__ float grp_all[kWarpsPerBlock][kScanBlock];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= w) return;
  const int deg = degs[i];
  if (deg <= 0) {
    if (lane == 0) out[i] = -1;
    return;
  }
  float* win = win_all[warp];
  const float* row = bias_rows + (size_t)i * seg;
  const int start = starts[i];
  const int local = start % seg;
  const int blk0 = start - local;
  const int n = 2 * seg;
  const int row_end = min(local + deg, n);
  for (int p = lane; p < n; p += 32)
    win[p] = (p >= local && p < row_end) ? row[p - local] : 0.0f;
  __syncwarp();
  window_pick(win, tot_all[warp], grp_all[warp], n, local, row_end, deg, blk0, rand[i],
              indices, out + i, lane);
}

// Count of ctps[0, p) entries <= r: the upper bound of r, since the CTPS is
// nondecreasing (a scan of non-negative values, divided by one total).
__device__ __forceinline__ int upper_bound(const float* ctps, int p, float r) {
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ctps[mid] <= r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Replaces its_select_pallas (src/repro/kernels/its_select.py:113, body
// _its_select_kernel :30): K of P candidates without replacement, ITS with
// bipartite region search, the paper's warp-centric SELECT.  One warp per
// instance, one lane per draw (K <= 32).
// - The CTPS lives in shared memory: the row's max(b, 0), scanned from
//   position 0 with the reference's association (warp_scan), divided by
//   max(total, 1e-12) with __fdiv_rn.
// - The TPU kernel's search is a lane-parallel compare-count over P; the
//   CTPS is monotone, so a binary search (upper bound of r) gives the same
//   count in O(log P) per lane.
// - Selected candidates are a shared-memory byte map, written only by the
//   winning lane of a round (distinct bytes, no atomics).  Collisions within
//   a round resolve "lowest lane wins" with __match_any_sync, the reference's
//   K x K priority rule; atomics would pick a winner by timing.
// - The region search rounds each step on its own: r2 = r1 * (1 - delta),
//   the shift r2 + delta, then the clip to [0, f32(1 - 1e-12)] = [0, 1].
// - (iters, searches) per instance are counted as the reference counts them.
// Bound by bytes: each instance reads its P bias words once (coalesced) and
// its ITERS*K uniforms; the scan and searches stay in shared memory.
__global__ void its_select_kernel(const float* __restrict__ biases,
                                  const float* __restrict__ rands,
                                  int* __restrict__ out, int* __restrict__ stats,
                                  int n, int p, int iters, int k, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;
  const int ppad = (p + kScanBlock - 1) / kScanBlock * kScanBlock;
  const int nb = ppad / kScanBlock;
  float* ctps = reinterpret_cast<float*>(smem + (size_t)warp * stride);
  float* tot = ctps + ppad;
  float* grp = tot + (nb + kScanBlock - 1) / kScanBlock * kScanBlock;
  unsigned char* taken = reinterpret_cast<unsigned char*>(grp + kScanBlock);
  const float* row = biases + (size_t)i * p;

  int navail = 0;
  for (int q = lane; q < ppad; q += 32) {
    const float b = q < p ? fmaxf(row[q], 0.0f) : 0.0f;
    ctps[q] = b;
    navail += b > 0.0f ? 1 : 0;
    if (q < p) taken[q] = 0;
  }
  navail = __reduce_add_sync(0xffffffffu, navail);
  __syncwarp();
  warp_scan(ctps, tot, grp, p, lane);
  const float total = fmaxf(ctps[p - 1], 1e-12f);
  __syncwarp();
  for (int q = lane; q < p; q += 32) ctps[q] = __fdiv_rn(ctps[q], total);
  __syncwarp();

  const int want = min(navail, k);
  bool done = lane >= want;  // lanes >= k are never pending
  int res = -1, rounds = 0, searches = 0;
  for (int t = 0; t < iters; ++t) {
    const unsigned pending = __ballot_sync(0xffffffffu, !done);
    if (pending == 0u) break;  // no draw pending: later rounds change nothing
    ++rounds;
    const float r1 = lane < k ? rands[((size_t)i * iters + t) * k + lane] : 0.0f;
    const int idx1 = min(upper_bound(ctps, p, r1), p - 1);
    const bool hit1 = taken[idx1] != 0;
    searches += __popc(pending) + __popc(__ballot_sync(0xffffffffu, !done && hit1));
    const float lo = idx1 > 0 ? ctps[idx1 - 1] : 0.0f;
    const float delta = __fsub_rn(ctps[idx1], lo);
    float r2 = __fmul_rn(r1, __fsub_rn(1.0f, delta));
    r2 = r2 < lo ? r2 : __fadd_rn(r2, delta);
    r2 = fminf(fmaxf(r2, 0.0f), 1.0f);
    const int idx2 = min(upper_bound(ctps, p, r2), p - 1);
    const bool hit2 = taken[idx2] != 0;
    const int cand = hit1 ? idx2 : idx1;
    const bool ok = !done && !(hit1 ? hit2 : hit1) && row[cand] > 0.0f;
    const unsigned same = __match_any_sync(0xffffffffu, ok ? cand : -1 - lane);
    const bool win = ok && __ffs(same) - 1 == lane;
    __syncwarp();  // every read of the byte map precedes this round's writes
    if (win) {
      res = cand;
      taken[cand] = 1;
    }
    done = done || win;
    __syncwarp();
  }
  if (lane < k) out[(size_t)i * k + lane] = res;
  if (lane == 0) {
    stats[2 * (size_t)i] = rounds;
    stats[2 * (size_t)i + 1] = searches;
  }
}

}  // namespace

extern "C" {

int reject_step_launch(const void* starts, const void* degs, const void* indices,
                       const void* bias, const void* row_max, const void* rej, void* out,
                       int w, int iters, int cap, void* stream) {
  if (w > 0) {
    reject_step_kernel<<<(w + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)indices, (const float*)bias,
        (const float*)row_max, (const float*)rej, (int*)out, w, iters, cap);
  }
  return (int)cudaGetLastError();
}

int alias_step_launch(const void* starts, const void* degs, const void* indices,
                      const void* prob, const void* alias, const void* rand, void* out,
                      int w, int cap, void* stream) {
  if (w > 0) {
    alias_step_kernel<<<(w + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)indices, (const float*)prob,
        (const int*)alias, (const float*)rand, (int*)out, w, cap);
  }
  return (int)cudaGetLastError();
}

int walk_step_launch(const void* starts, const void* degs, const void* indices,
                     const void* bias, const void* rand, void* out, int w, int seg,
                     void* stream) {
  if (w > 0) {
    const int blocks = (w + kWarpsPerBlock - 1) / kWarpsPerBlock;
    walk_step_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)indices, (const float*)bias,
        (const float*)rand, (int*)out, w, seg);
  }
  return (int)cudaGetLastError();
}

int walk_step_window_launch(const void* starts, const void* degs, const void* indices,
                            const void* bias_rows, const void* rand, void* out, int w, int seg,
                            void* stream) {
  if (w > 0) {
    const int blocks = (w + kWarpsPerBlock - 1) / kWarpsPerBlock;
    walk_step_window_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)indices, (const float*)bias_rows,
        (const float*)rand, (int*)out, w, seg);
  }
  return (int)cudaGetLastError();
}

int its_select_launch(const void* biases, const void* rands, void* out, void* stats, int n,
                      int p, int iters, int k, void* stream) {
  if (n > 0) {
    // per warp: the padded CTPS, the block totals, the group totals, the
    // byte map of taken candidates
    const int ppad = (p + kScanBlock - 1) / kScanBlock * kScanBlock;
    const int tsz = (ppad / kScanBlock + kScanBlock - 1) / kScanBlock * kScanBlock;
    const int stride = (ppad + tsz + kScanBlock) * 4 + (p + 15) / 16 * 16;
    const int smem = stride * kWarpsPerBlock;
    const cudaError_t e = cudaFuncSetAttribute(
        its_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    its_select_kernel<<<blocks, 32 * kWarpsPerBlock, smem, (cudaStream_t)stream>>>(
        (const float*)biases, (const float*)rands, (int*)out, (int*)stats, n, p, iters, k,
        stride);
  }
  return (int)cudaGetLastError();
}

const char* walk_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
