// Masked row-min of max-min water-filling for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/waterfill/kernel.py::_rowmin_kernel
// (launched by masked_rowmin_pallas). One water-filling round of flowSim
// needs, per flow f of scenario b, its bottleneck fair share
//
//     out[b, f] = min over l with a[b, f, l] > 0 of share[b, l]
//
// or INF = 3.4e38 when the flow crosses no link. flowSim on the card
// (repro_torch.core.flowsim_fast) launches it once per round, 32 rounds per
// event.
//
// What bounds it: at the main path's size (F = 2000 flows, L = 80-128
// links) a launch reads 0.6-1 MB of incidence and does F·L compares, so
// the bytes bound it (~0.2-0.3 us at 3.35 TB/s), and in practice the
// launch latency does. Design: a simple, correct kernel. A block serves
// WARPS rows of one scenario b (blockIdx.y) and stages share[b] (L floats)
// in shared memory; each warp owns one flow row, its lanes stride over L
// on consecutive addresses (coalesced), keep fminf of the masked shares and
// reduce with __shfl_xor_sync. Ragged F and L are masked, nothing is
// padded. A min is exact and NaN-free inputs have one min whatever the
// order, so the result equals the plain PyTorch version bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;              // flow rows per block
constexpr float INF = 3.4e38f;        // the plain version's INF, to the bit
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;  // a Hopper block's dynamic maximum

__global__ void __launch_bounds__(WARPS * 32)
masked_rowmin_kernel(const float* __restrict__ a,
                     const float* __restrict__ share,
                     float* __restrict__ out, int F, int L) {
  extern __shared__ float s[];
  const int b = blockIdx.y;
  const float* sb = share + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) s[l] = sb[l];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (f >= F) return;                 // after the only barrier
  const float* row = a + ((size_t)b * F + f) * L;
  float m = INF;
  for (int l = lane; l < L; l += 32) {
    m = fminf(m, row[l] > 0.0f ? s[l] : INF);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) out[(size_t)b * F + f] = m;
}

}  // namespace

// a: (B, F, L), share: (B, L), out: (B, F); all fp32, contiguous, on the
// device of `stream`. Returns the cudaError_t of the launch (0 = launched).
extern "C" int masked_rowmin_forward(const float* a, const float* share,
                                     float* out, int B, int F, int L,
                                     cudaStream_t stream) {
  if (B <= 0 || F <= 0 || L < 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)L * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_rowmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((F + WARPS - 1) / WARPS, B);
  masked_rowmin_kernel<<<grid, WARPS * 32, smem, stream>>>(a, share, out, F,
                                                           L);
  return (int)cudaGetLastError();
}
