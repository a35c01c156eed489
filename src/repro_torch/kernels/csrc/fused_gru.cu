// Fused GRU cell pair for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_gru/kernel.py::_gru_kernel
// (launched by gru_cell_pallas). One launch advances both cells of one m4
// stage — the flow GRU and the link GRU, as repro_torch.kernels.dispatch.
// gru_cell_pair pairs them — blockIdx.z selecting the cell:
//
//     gi = x @ Wi + bi,  gh = h @ Wh + bh          (gate order r, z, n)
//     r = sigmoid(ir + hr),  z = sigmoid(iz + hz),  n = tanh(in + r * hn)
//     h' = (1 - z) * n + z * h
//
// What bounds it: at m4's full width (H = 400, 64 flow rows and 128 link
// rows per scenario, x of width 13/11 or 309) a launch is ~0.2-0.3 GFLOP
// over 4-7 MB of weights, so the fp32 FMA rate bounds it, not the bytes.
// Design: each block owns TR rows and TJ hidden columns j and computes the
// six dot products of columns j, H+j and 2H+j, so the gates fuse in
// registers and only h' is written. The depth (Din of x, then H of h) is
// walked in chunks of KC: the block stages the chunk's rows of x or h and
// the chunk's weight columns j, H+j, 2H+j in shared memory, and loads the
// next chunk into registers while it computes the current one, so the
// latency of the L2-resident weights overlaps the FMAs. Ragged edges
// (rows, H, the depth) are masked in the kernel; nothing is padded.
// Arithmetic is plain fp32 FMA (no TF32), so the result matches the plain
// PyTorch cell to ~1e-6.
#include <cuda_runtime.h>

namespace {

constexpr int TJ = 32;          // hidden columns per block: one per lane
constexpr int RG = 8;           // row groups per block: one per warp
constexpr int RPT = 2;          // rows per thread
constexpr int TR = RG * RPT;    // rows per block
constexpr int KC = 32;          // depth of one staged chunk
constexpr int NT = TJ * RG;     // threads per block
constexpr int A_PER = TR * KC / NT;        // staged x/h values per thread
constexpr int W_PER = KC * 3 * TJ / NT;    // staged weights per thread

struct Cell {
  const float* x;    // (rows, din)
  const float* h;    // (rows, H)
  const float* wi;   // (din, 3H)
  const float* wh;   // (H, 3H)
  const float* bi;   // (3H)
  const float* bh;   // (3H)
  float* out;        // (rows, H)
  int rows;
  int din;
};

struct Pair {
  Cell cell[2];      // 0 = flow GRU, 1 = link GRU
  int H;
};

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Registers of one chunk: A_PER values of x or h, W_PER weights.
struct Chunk {
  float a[A_PER];
  float w[W_PER];
};

// Chunk c of the depth: c < nx walks x/Wi, the rest h/Wh.
__device__ __forceinline__ void load_chunk(const Cell& c, int H, int nx,
                                           int chunk, int row0, int j0,
                                           Chunk& r) {
  const bool in_x = chunk < nx;
  const float* a = in_x ? c.x : c.h;
  const float* w = in_x ? c.wi : c.wh;
  const int depth = in_x ? c.din : H;
  const int k0 = (in_x ? chunk : chunk - nx) * KC;
  const int tid = threadIdx.y * TJ + threadIdx.x;
#pragma unroll
  for (int q = 0; q < A_PER; ++q) {
    const int idx = tid + q * NT, rr = idx / KC, k = idx % KC;
    const int gr = row0 + rr, gk = k0 + k;
    r.a[q] = (gr < c.rows && gk < depth) ? a[(size_t)gr * depth + gk] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < W_PER; ++q) {
    const int idx = tid + q * NT, k = idx / (3 * TJ), rem = idx % (3 * TJ);
    const int g = rem / TJ, t = rem % TJ;
    const int gk = k0 + k, j = j0 + t;
    r.w[q] = (gk < depth && j < H)
                 ? __ldg(w + (size_t)gk * 3 * H + (size_t)g * H + j)
                 : 0.0f;
  }
}

__device__ __forceinline__ void store_chunk(const Chunk& r,
                                            float (*a_s)[TR],
                                            float (*w_s)[3 * TJ]) {
  const int tid = threadIdx.y * TJ + threadIdx.x;
#pragma unroll
  for (int q = 0; q < A_PER; ++q) {
    const int idx = tid + q * NT;
    a_s[idx % KC][idx / KC] = r.a[q];
  }
#pragma unroll
  for (int q = 0; q < W_PER; ++q) {
    const int idx = tid + q * NT;
    w_s[idx / (3 * TJ)][idx % (3 * TJ)] = r.w[q];
  }
}

// acc[i][g] += sum over the chunk's k of a[row i, k] * w[k, column g]
__device__ __forceinline__ void fma_chunk(const float (*a_s)[TR],
                                          const float (*w_s)[3 * TJ],
                                          float (&acc)[RPT][3]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float w0 = w_s[k][tx], w1 = w_s[k][TJ + tx];
    const float w2 = w_s[k][2 * TJ + tx];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float v = a_s[k][ty * RPT + i];
      acc[i][0] = fmaf(v, w0, acc[i][0]);
      acc[i][1] = fmaf(v, w1, acc[i][1]);
      acc[i][2] = fmaf(v, w2, acc[i][2]);
    }
  }
}

// two blocks per SM: at full width a stage is ~156 blocks, one wave on
// the 132 SMs only if two fit on an SM (<= 128 registers a thread)
__global__ void __launch_bounds__(NT, 2)
gru_pair_kernel(Pair p) {
  const Cell c = blockIdx.z == 0 ? p.cell[0] : p.cell[1];
  const int H = p.H;
  const int row0 = blockIdx.y * TR;
  if (row0 >= c.rows) return;            // uniform over the block
  const int j0 = blockIdx.x * TJ;
  const int tx = threadIdx.x, ty = threadIdx.y;

  __shared__ float a_s[KC][TR];          // chunk of x or h, transposed
  __shared__ float w_s[KC][3 * TJ];      // chunk of columns j, H+j, 2H+j
  float gi[RPT][3], gh[RPT][3];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < 3; ++g) gi[i][g] = gh[i][g] = 0.0f;

  const int nx = (c.din + KC - 1) / KC;
  const int nchunks = nx + (H + KC - 1) / KC;
  Chunk reg;
  load_chunk(c, H, nx, 0, row0, j0, reg);
  store_chunk(reg, a_s, w_s);
  __syncthreads();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks) load_chunk(c, H, nx, chunk + 1, row0, j0, reg);
    if (chunk < nx) {                    // uniform over the block
      fma_chunk(a_s, w_s, gi);
    } else {
      fma_chunk(a_s, w_s, gh);
    }
    __syncthreads();
    if (chunk + 1 < nchunks) {
      store_chunk(reg, a_s, w_s);
      __syncthreads();
    }
  }

  const int j = j0 + tx;
  if (j >= H) return;
  const float bir = c.bi[j], biz = c.bi[H + j], bin = c.bi[2 * H + j];
  const float bhr = c.bh[j], bhz = c.bh[H + j], bhn = c.bh[2 * H + j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + ty * RPT + i;
    if (row >= c.rows) continue;
    const float r = sigmoid_f((gi[i][0] + bir) + (gh[i][0] + bhr));
    const float z = sigmoid_f((gi[i][1] + biz) + (gh[i][1] + bhz));
    const float n = tanhf((gi[i][2] + bin) + r * (gh[i][2] + bhn));
    const float hv = c.h[(size_t)row * H + j];
    c.out[(size_t)row * H + j] = (1.0f - z) * n + z * hv;
  }
}

}  // namespace

// Advance both cells of one stage; pointers are device pointers, all
// float32 and contiguous. Returns the launch's cudaError_t (0 = launched).
extern "C" int gru_pair_forward(
    const float* x0, const float* h0, const float* wi0, const float* wh0,
    const float* bi0, const float* bh0, float* out0, int rows0, int din0,
    const float* x1, const float* h1, const float* wi1, const float* wh1,
    const float* bi1, const float* bh1, float* out1, int rows1, int din1,
    int H, void* stream) {
  const int rows = rows0 > rows1 ? rows0 : rows1;
  if (rows == 0 || H == 0) return 0;
  Pair p;
  p.cell[0] = Cell{x0, h0, wi0, wh0, bi0, bh0, out0, rows0, din0};
  p.cell[1] = Cell{x1, h1, wi1, wh1, bi1, bh1, out1, rows1, din1};
  p.H = H;
  const dim3 grid((H + TJ - 1) / TJ, (rows + TR - 1) / TR, 2);
  const dim3 block(TJ, RG);
  gru_pair_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
