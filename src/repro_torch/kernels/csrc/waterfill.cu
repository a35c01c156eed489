// Water-filling kernels of flowSim for Hopper (sm_90a), fp32.
//
// 1. waterfill_event_kernel: one flowSim event's whole max-min
//    water-filling, up to 32 rounds, for B scenarios in one launch.
//
// Replaces the TPU kernel src/repro/kernels/waterfill/kernel.py::
// _rowmin_kernel (the per-flow masked row-min of one round), and fuses the
// XLA half of the round loop around it, src/repro/core/flowsim_fast.py::
// _waterfill_masked: per round, the link sums (unfrozen flows per link,
// rate in use by frozen flows), each link's fair share, the masked row-min,
// theta (the least share of an unfrozen flow), the tie test and the freeze,
// until every flow is frozen or 32 rounds have run.
//
// What bounds it: the issue of dependent block-wide phases. An event moves
// ~60-100 KB and does a few hundred thousand operations at 2000 flows
// (bound ~0.02 us); but its rounds depend on each other, and a round is
// three phases separated by barriers (link sums; per-flow row-min and
// theta's reduction; the freeze), each a few hundred instructions per warp
// that one SM's four schedulers issue in turn (tools/kernel_variants.py
// event_clocks times the phases). The TPU design paid one launch per round
// plus ~20 XLA ops around it (~670 launches per event on the card).
//
// Design: one block per scenario (gridDim.x = B, 1024 threads) holds the
// whole event on chip, so a round costs three __syncthreads and no launch:
// the incidence as lists (per flow its <= K links and the places of its
// entries in the links' lists; per link its entries, CSR), and the flow
// state, one float per flow (its rate, the sign bit marking it unfrozen),
// kept twice: per flow, and per entry of the lists, so that a link's sums
// read its own entries in order rather than gather the flows' states. The
// block leaves the loop when no flow is left unfrozen: a block-uniform,
// exact decision, since such a round changes nothing (the reference's
// while_loop stops there too). Two placements, each compiled on its own
// (SMEM): at 2000 flows every array fits in shared memory (~105 KB), so
// loads and stores are shared ones; past ~4k flows they do not, and the
// kernel reads the lists from its inputs, keeps the rates in its output,
// and the shares and per-entry state in a scratch the wrapper allocates
// (L2-resident at such sizes). waterfill/layout.py's plan chooses; a null
// scratch means the first.
//
// Exactness: per link a group of LINK_LANES lanes sums its list, lanes
// striding over it, then a fixed __shfl_xor_sync tree within the group (8
// lanes: one pass of 128 groups covers the main path's 80-128 links, and a
// busy link's chain stays short): the count of unfrozen flows in int32 (exact)
// and the rate in use in float64 (exact while the rates on one link span
// less than ~2^18 at ~2000 addends), rounded once to float32. The plain
// version takes the same sums exactly in another order, so the two agree
// bitwise; the tie test `f_share <= theta * (1 + 1e-9)` is, in float32, an
// equality test, and reproduced as such. A min is exact in any order.
//
// 2. masked_rowmin_kernel: the standalone row-min over a dense incidence,
//    the counterpart of the JAX package's dispatch.masked_rowmin; off the
//    main path since the event kernel. Both kernels fold a link's share
//    into a flow's min with masked_min().
//
//     out[b, f] = min over l with a[b, f, l] > 0 of share[b, l]
//
// or INF = 3.4e38 when the flow crosses no link. A block serves WARPS rows
// of one scenario b (blockIdx.y) and stages share[b] in shared memory;
// each warp owns one flow row, its lanes stride over L (coalesced) and
// reduce with __shfl_xor_sync. Bound by its launch (~0.2 us of bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INF = 3.4e38f;        // the plain version's INF, to the bit
constexpr float BIG = 1e30f;          // a link with no unfrozen flow
// 1 + 1e-9 rounds to 1 in float32: the reference's tie test is equality
constexpr float TIE = (float)(1.0 + 1e-9);
constexpr int WARPS = 8;              // row-min: flow rows per block
constexpr int EVENT_THREADS = 1024;   // event: threads per scenario
constexpr int LINK_LANES = 8;         // event: lanes that sum one link
constexpr int UNROLL = 4;             // event: a lane's list entries per step
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;  // a Hopper block's dynamic maximum
constexpr unsigned FULL = 0xffffffffu;

// one link's share folded into a flow's running min (INF is the identity)
__device__ __forceinline__ float masked_min(float m, bool on, float share) {
  return on ? fminf(m, share) : m;
}

// ---------------------------------------------------------------- row-min

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
  for (int l = lane; l < L; l += 32) m = masked_min(m, row[l] > 0.0f, s[l]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fminf(m, __shfl_xor_sync(FULL, m, off));
  }
  if (lane == 0) out[(size_t)b * F + f] = m;
}

// ---------------------------------------------------------- event kernel

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// n elements of T at `at`, which moves on by their bytes, 16-byte aligned
template <class T>
__device__ inline T* carve(uint8_t*& at, size_t n) {
  T* p = reinterpret_cast<T*>(at);
  at += align16(n * sizeof(T));
  return p;
}

// Bytes per scenario of each placement, as the kernel carves them (and
// waterfill/layout.py's plan counts them): in shared memory link_ptr, cap,
// share, rate, entry, flow_links, fshare, flow_entries; in the scratch
// share, entry, fshare.
inline size_t smem_bytes(int N, int L, int K, int nnz) {
  return align16(4 * ((size_t)L + 1)) + 2 * align16(4 * (size_t)L) +
         2 * align16(4 * (size_t)N) + align16(4 * (size_t)nnz) +
         2 * align16(4 * (size_t)N * K);
}

inline size_t scratch_bytes(int N, int L, int nnz) {
  return align16(4 * (size_t)L) + align16(4 * (size_t)nnz) +
         align16(4 * (size_t)N);
}

struct EventArgs {
  const int* flow_links;       // (B, N, K), -1 padded
  const int* flow_entries;     // (B, N, K): their places in the CSR lists
  const int* link_ptr;         // (B, L + 1)
  const float* cap;            // (B, L)
  const uint8_t* active;       // (B, N), torch.bool
  float* rates;                // (B, N) out
  int* rounds;                 // (B,) out
  uint8_t* capped;             // (B,) out, torch.bool
  uint8_t* scratch;            // (B, scratch_stride), null with SMEM
  size_t scratch_stride;
  int N, L, K, nnz, max_rounds;
};

template <class T>
__device__ inline T* stage(uint8_t*& at, const T* src, size_t n) {
  T* dst = carve<T>(at, n);
  for (size_t j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
  return dst;
}

// A flow's state is one float: its rate once frozen (>= +0), -0.0 while
// unfrozen (the sign bit marks it).
__device__ __forceinline__ bool unfrozen(float state) {
  return __float_as_uint(state) >> 31;
}

// Every thread gets the min of lo and the sum of n over the block: a warp
// tree each, one slot per warp, then each warp reads the slots a lane each
// and reduces them again. The slots are free again once the caller has
// passed its next __syncthreads.
__device__ inline void block_reduce(float& lo, int& n, float* min_slots,
                                    int* count_slots) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
  }
  n = __reduce_add_sync(FULL, n);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    min_slots[threadIdx.x >> 5] = lo;
    count_slots[threadIdx.x >> 5] = n;
  }
  __syncthreads();
  const bool has = lane < (int)(blockDim.x >> 5);
  lo = has ? min_slots[lane] : INFINITY;
  n = __reduce_add_sync(FULL, has ? count_slots[lane] : 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
  }
}

// The flow state lives twice: per flow (rate) and per entry of the CSR
// lists (entry: entry j of link l holds the state of the flow it names), so
// that a link's sums read its entries in order instead of gathering the
// flows' states. A flow's freeze writes both (its K entries through
// flow_entries).
template <bool SMEM>
__global__ void __launch_bounds__(EVENT_THREADS)
waterfill_event_kernel(const EventArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int count_slots[EVENT_THREADS / 32];
  __shared__ float min_slots[EVENT_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  // a link's group of lanes, and the lane's place in it
  const int group = tid / LINK_LANES, sub = tid % LINK_LANES;
  const int groups = T / LINK_LANES;
  const int N = p.N, L = p.L, K = p.K;
  const uint8_t* active = p.active + (size_t)b * N;
  float* out = p.rates + (size_t)b * N;
  const int *link_ptr, *flow_links, *flow_entries;
  const float* cap;
  float *share, *rate, *entry, *fshare;
  if constexpr (SMEM) {
    uint8_t* at = smem;
    link_ptr = stage(at, p.link_ptr + (size_t)b * (L + 1), (size_t)L + 1);
    cap = stage(at, p.cap + (size_t)b * L, (size_t)L);
    share = carve<float>(at, L);
    rate = carve<float>(at, N);
    entry = carve<float>(at, p.nnz);
    flow_links = stage(at, p.flow_links + (size_t)b * N * K, (size_t)N * K);
    fshare = carve<float>(at, N);
    flow_entries = stage(at, p.flow_entries + (size_t)b * N * K,
                         (size_t)N * K);
  } else {
    uint8_t* at = p.scratch + b * p.scratch_stride;
    link_ptr = p.link_ptr + (size_t)b * (L + 1);
    cap = p.cap + (size_t)b * L;
    share = carve<float>(at, L);
    rate = out;
    entry = carve<float>(at, p.nnz);
    flow_links = p.flow_links + (size_t)b * N * K;
    fshare = carve<float>(at, N);
    flow_entries = p.flow_entries + (size_t)b * N * K;
  }
  __syncthreads();                      // flow_entries staged

  // the inactive flows frozen at rate 0, the active ones unfrozen
  for (int f = tid; f < N; f += T) {
    const float v = active[f] ? -0.0f : 0.0f;
    rate[f] = v;
    for (int k = 0; k < K; ++k) {
      const int j = flow_entries[f * K + k];
      if (j >= 0) entry[j] = v;
    }
  }
  __syncthreads();

  // Each pass sums over the state S, computes the bottleneck shares,
  // theta and the count of unfrozen flows of S, and, while S has one and
  // fewer than max_rounds rounds have run, freezes (round `rounds`).
  int rounds = 0, left;
  for (;;) {
    // (a) per link, a group of LINK_LANES lanes: unfrozen count and rate
    // in use (float64, fixed order), then the link's share. A lane reads
    // entries j, j + LINK_LANES, ... UNROLL at a time (independent loads),
    // and adds them in list order. Every lane of a warp runs the same
    // passes, so the shuffles see the whole warp.
    for (int base = 0; base < L; base += groups) {
      const int l = base + group;
      int n = 0;
      double used = 0.0;
      if (l < L) {
        const int end = link_ptr[l + 1];
        for (int j = link_ptr[l] + sub; j < end; j += UNROLL * LINK_LANES) {
          float v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int ju = j + u * LINK_LANES;
            v[u] = ju < end ? entry[ju] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (unfrozen(v[u])) ++n;
            else used += (double)v[u];
          }
        }
      }
#pragma unroll
      for (int off = LINK_LANES / 2; off > 0; off >>= 1) {
        n += __shfl_xor_sync(FULL, n, off);
        used += __shfl_xor_sync(FULL, used, off);
      }
      if (sub == 0 && l < L) {
        const float avail = fmaxf(cap[l] - (float)used, 0.0f);
        share[l] = n > 0 ? avail / (float)n : BIG;
      }
    }
    __syncthreads();
    // (c) per unfrozen flow: its bottleneck share; (d) theta, the least
    // of them (a frozen flow counts as BIG, as in the reference), and the
    // count of unfrozen flows
    float theta = INFINITY;
    left = 0;
    for (int f = tid; f < N; f += T) {
      float m = BIG;
      if (unfrozen(rate[f])) {
        m = INF;
        for (int k = 0; k < K; ++k) {
          const int l = flow_links[f * K + k];
          m = masked_min(m, l >= 0, l >= 0 ? share[l] : INF);
        }
        fshare[f] = m;
        ++left;
      }
      theta = fminf(theta, m);
    }
    block_reduce(theta, left, min_slots, count_slots);
    if (left == 0 || rounds == p.max_rounds) break;
    ++rounds;
    // (e) freeze the flows at theta, in both copies
    for (int f = tid; f < N; f += T) {
      if (!unfrozen(rate[f])) continue;
      const float fs = fshare[f];
      if (fs <= theta * TIE) {
        rate[f] = fs;
        for (int k = 0; k < K; ++k) {
          const int j = flow_entries[f * K + k];
          if (j >= 0) entry[j] = fs;
        }
      }
    }
    __syncthreads();
  }
  // an unfrozen flow's rate is 0
  for (int f = tid; f < N; f += T) {
    const float v = rate[f];
    out[f] = active[f] && !unfrozen(v) ? v : 0.0f;
  }
  if (tid == 0) {
    p.rounds[b] = rounds;
    p.capped[b] = left > 0;
  }
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

// One flowSim event's water-filling for B scenarios. flow_links and
// flow_entries (B, N, K), link_ptr (B, L + 1) int32; cap (B, L) fp32; active
// (B, N) bool; rates (B, N) fp32, rounds (B,) int32, capped (B,) bool out;
// all contiguous, on the device of `stream`. nnz is the largest list length
// of the batch. A null scratch runs the shared-memory placement; else
// scratch is (B, scratch_stride) bytes for the device-memory one. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int waterfill_event_forward(
    const int* flow_links, const int* flow_entries, const int* link_ptr,
    const float* cap, const uint8_t* active, float* rates, int* rounds,
    uint8_t* capped, uint8_t* scratch, long long scratch_stride, int B,
    int N, int L, int K, int nnz, int max_rounds, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || L < 0 || K < 0 || nnz < 0 || max_rounds < 0 ||
      scratch_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool in_smem = scratch == nullptr;
  const size_t smem = in_smem ? smem_bytes(N, L, K, nnz) : 0;
  if (smem > (size_t)SMEM_MAX - sizeof(int) * 2 * EVENT_THREADS / 32 ||
      (!in_smem && scratch_bytes(N, L, nnz) > (size_t)scratch_stride)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = in_smem ? waterfill_event_kernel<true>
                        : waterfill_event_kernel<false>;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  EventArgs p;
  p.flow_links = flow_links;
  p.flow_entries = flow_entries;
  p.link_ptr = link_ptr;
  p.cap = cap;
  p.active = active;
  p.rates = rates;
  p.rounds = rounds;
  p.capped = capped;
  p.scratch = scratch;
  p.scratch_stride = (size_t)scratch_stride;
  p.N = N;
  p.L = L;
  p.K = K;
  p.nnz = nnz;
  p.max_rounds = max_rounds;
  kernel<<<B, EVENT_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
