// Walk-step kernels for Hopper (sm_90a): one random-walk transition per
// walker over a flat CSR graph, three selection methods.
//
// Each kernel computes what a Pallas TPU kernel of src/repro/kernels/
// computes, bit for bit, and is held against its plain PyTorch version in
// repro_torch/kernels/ref.py.  The TPU kernels DMA two max_seg-aligned
// blocks around each row and gather ids through an f32 one-hot reduction;
// both are TPU artifacts.  Here every kernel reads its walker's row
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
constexpr int kMaxGroups = kMaxBlocks / kScanBlock;

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

// Replaces walk_step_pallas (src/repro/kernels/walk_step.py:158, body
// _walk_step_kernel :29).  One warp per walker.  The window is the 2*seg
// positions from the block origin blk0 = start / seg * seg; positions outside
// the row are zeros that take part in the scan, exactly as in the reference.
// The row is read once, coalesced across the warp, into shared memory; the
// scan reproduces XLA-CPU's f32 cumsum association (sequential 16-wide
// blocks, block totals scanned by the same rule, exclusive block prefixes
// added after), so the pick equals the reference bit for bit.  The pick is
// the count of masked prefixes <= r * total, with total the scan's last
// element, summed by a warp reduction.
__global__ void walk_step_kernel(const int* __restrict__ starts,
                                 const int* __restrict__ degs,
                                 const int* __restrict__ indices,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ rand,
                                 int* __restrict__ out, int w, int seg) {
  __shared__ float win_all[kWarpsPerBlock][kMaxWindow];
  __shared__ float tot_all[kWarpsPerBlock][kMaxBlocks];
  __shared__ float grp_all[kWarpsPerBlock][kMaxGroups];
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
  float* tot = tot_all[warp];
  float* grp = grp_all[warp];
  const int start = starts[i];
  const int local = start % seg;
  const int blk0 = start - local;
  const int n = 2 * seg;
  const int nb = n / kScanBlock;
  const int row_end = min(local + deg, n);

  for (int p = lane; p < n; p += 32)
    win[p] = (p >= local && p < row_end) ? bias[blk0 + p] : 0.0f;
  __syncwarp();
  // level 1: in-block sums; lane b owns blocks b, b + 32, ...
  for (int b = lane; b < nb; b += 32) tot[b] = seq_scan(win + b * kScanBlock, kScanBlock);
  __syncwarp();
  // level 2: scan of the block totals by the same rule
  if (nb <= kScanBlock) {
    if (lane == 0) seq_scan(tot, nb);
  } else {
    const int ng = nb / kScanBlock;
    for (int g = lane; g < ng; g += 32) grp[g] = seq_scan(tot + g * kScanBlock, kScanBlock);
    __syncwarp();
    if (lane == 0) seq_scan(grp, ng);
    __syncwarp();
    for (int b = lane + kScanBlock; b < nb; b += 32)
      tot[b] = __fadd_rn(tot[b], grp[b / kScanBlock - 1]);
  }
  __syncwarp();
  // exclusive block prefixes
  for (int p = lane + kScanBlock; p < n; p += 32)
    win[p] = __fadd_rn(win[p], tot[p / kScanBlock - 1]);
  __syncwarp();

  const float total = win[n - 1];
  const float target = __fmul_rn(rand[i], total);
  int cnt = 0;
  for (int p = lane; p < n; p += 32)
    cnt += (p >= local && p < row_end && win[p] <= target) ? 1 : 0;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) {
    const int pick = min(local + cnt, local + max(deg - 1, 0));
    out[i] = total <= 1e-12f ? -1 : indices[blk0 + pick];
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

const char* walk_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
