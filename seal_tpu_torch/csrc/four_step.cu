// The four-step stage kernel: one stage of the four-step NTT, as butterflies.
//
// Replaces seal_tpu/ops/pallas_mxu_ntt.py:_stage_kernel (launched by
// _run_stage through the staged branch of pallas_ntt_forward /
// pallas_ntt_inverse).  Same function: for every (poly, limb) row,
//
//     out[m, t] = (sum_kappa B[m, kappa] * x[kappa, t]) mod q   (then * T[m, t] mod q)
//
// with B the limb's (M, M) matrix and T an optional Shoup twiddle, output in
// [0, q).  The plain version, seal_tpu_torch/ops/four_step.py:stage_plain,
// computes the dense product.  Each of the four matrices is a butterfly
// transform (ntt_tables.py): W the M-point negacyclic NTT and F the M-point
// cyclic NTT, in bit-reversed output order, and Winv, Finv their inverses
// with the scale folded into the last stage.  So this kernel runs, for each
// column, the Harvey butterflies of that transform over the limb's Shoup root
// table (ntt_passes.cuh): Cooley-Tukey forward, Gentleman-Sande inverse.
// Every output is reduced to [0, q), so the butterflies give the dense
// product's residues bit for bit.
//
// Strides fold the JAX package's transposes between stages into the
// indexing: element (kappa, t) of a row is read at kappa*sx_k + t*sx_t and
// element (m, t) written at m*so_m + t*so_t; the twiddle is read at the
// output's position.  The input may be lazy (below 4q): the forward
// butterflies take it as it is, the inverse reduces it to [0, 2q) as it
// loads.  A transform is two launches and nothing else.
//
// What bounds it on an H100: the data, ~1 MB per 65536-coefficient row in
// and out (a few MB a call on the main path, about 1-5 us at 3.35 TB/s);
// M/2 log2(M) butterflies per column are fewer 32-bit operations than that
// takes.  The design: one block holds G columns of one row in shared memory
// (G = 8, 36 KB at M = 512, where the input walks the columns fastest, so
// that each warp reads 64-byte segments; fewer, down to 64 threads a block,
// where each column is contiguous, so that small launches still spread over
// the SMs) and the limb's root table (16 M bytes), runs three stages per
// barrier in registers, and stores through the output strides with the
// twiddle fused.  TMA bulk loads and a persistent grid are later work.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ntt_passes.cuh"

using seal_tpu_torch::column_stride;
using seal_tpu_torch::guard;
using seal_tpu_torch::pad8;
using seal_tpu_torch::shoup_lazy;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSmCount = 132;

// grid: rows * ncols / G blocks; block b serves row b / (ncols / G), columns
// [t0, t0 + G).  Row r uses limb r % k.  roots: (k, 2, M), operands then
// Shoup quotients.
template <bool kInverse>
__global__ void __launch_bounds__(kMaxThreads) four_step_stage_kernel(
    const uint64_t* __restrict__ x, const uint64_t* __restrict__ roots,
    const uint64_t* __restrict__ tw_op, const uint64_t* __restrict__ tw_qt,
    const uint64_t* __restrict__ qv, uint64_t* __restrict__ out, int k, int n, int log_m,
    int ncols, int log_g, int sx_k, int sx_t, int so_m, int so_t) {
    extern __shared__ uint64_t smem[];
    const int M = 1 << log_m;
    const int G = 1 << log_g;
    const int cs = column_stride(log_m);
    uint64_t* r_op = smem;
    uint64_t* r_qt = smem + M;
    uint64_t* data = smem + 2 * M;

    const int blocks_per_row = ncols >> log_g;
    const int row = blockIdx.x / blocks_per_row;
    const int t0 = (blockIdx.x - row * blocks_per_row) << log_g;
    const int limb = row % k;
    const uint64_t q = qv[limb];
    const uint64_t two_q = q << 1;
    const uint64_t* rt = roots + static_cast<size_t>(limb) * 2 * M;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        r_op[i] = rt[i];
        r_qt[i] = rt[M + i];
    }

    // Neighbouring threads take neighbouring addresses of the axis that is
    // contiguous in memory.
    const uint64_t* xr = x + static_cast<size_t>(row) * n;
    const bool k_fast = sx_k == 1;
    for (int idx = threadIdx.x; idx < (G << log_m); idx += blockDim.x) {
        const int kap = k_fast ? (idx & (M - 1)) : (idx >> log_g);
        const int j = k_fast ? (idx >> log_m) : (idx & (G - 1));
        uint64_t v = xr[kap * sx_k + (t0 + j) * sx_t];
        if (kInverse) v = guard(v, two_q);
        data[j * cs + pad8(kap)] = v;
    }
    __syncthreads();

    if (kInverse) seal_tpu_torch::gs_stages(data, cs, G, log_m, true, r_op, r_qt, q);
    else seal_tpu_torch::ct_stages(data, cs, G, log_m, r_op, r_qt, q);

    uint64_t* orow = out + static_cast<size_t>(row) * n;
    const size_t tw_row = static_cast<size_t>(limb) * n;
    const bool m_fast = so_m == 1;
    for (int idx = threadIdx.x; idx < (G << log_m); idx += blockDim.x) {
        const int m = m_fast ? (idx & (M - 1)) : (idx >> log_g);
        const int j = m_fast ? (idx >> log_m) : (idx & (G - 1));
        uint64_t o = data[j * cs + pad8(m)];
        o = kInverse ? guard(o, q) : guard(guard(o, two_q), q);
        const int pos = m * so_m + (t0 + j) * so_t;
        if (tw_op != nullptr) o = guard(shoup_lazy(o, tw_op[tw_row + pos], tw_qt[tw_row + pos], q), q);
        orow[pos] = o;
    }
}

int log2_int(int v) { return 31 - __builtin_clz(v); }

// Columns per block: 8 where a side walks the columns fastest (64-byte
// segments); else as many as make 128 threads, halved while the launch has
// fewer blocks than SMs and a block keeps 64 threads.
int columns_per_block(int rows, int log_m, int ncols, bool t_fast) {
    int g = t_fast ? 8 : std::max(1, 1024 >> log_m);
    g = std::min(g, ncols);
    if (!t_fast)
        while (g > 1 && (g << log_m) > 512 && static_cast<long>(rows) * (ncols / g) < kSmCount) g >>= 1;
    return g;
}

}  // namespace

// x, out: (rows, n); roots: (k, 2, M); tw_op, tw_qt: (k, n) or null; q: (k,).
// M and ncols are powers of two, M * ncols == n.  Row r uses limb r % k.
// Returns the CUDA error code.
extern "C" int seal_four_step_stage(const void* x, const void* roots, const void* tw_op,
                                    const void* tw_qt, const void* q, void* out, int rows, int k,
                                    int n, int M, int ncols, int inverse, int sx_k, int sx_t,
                                    int so_m, int so_t, void* stream) {
    static int allowed[2][64] = {};
    const int log_m = log2_int(M);
    const int g = columns_per_block(rows, log_m, ncols, sx_k != 1 || so_m != 1);
    const int log_g = log2_int(g);
    const int threads = std::min(kMaxThreads, std::max(32, (g << log_m) / 8));
    const int smem = static_cast<int>(sizeof(uint64_t)) * (2 * M + g * column_stride(log_m));
    auto kernel = inverse ? &four_step_stage_kernel<true> : &four_step_stage_kernel<false>;
    cudaError_t err = seal_tpu_torch::allow_shared_memory(kernel, smem, allowed[inverse ? 1 : 0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = rows * (ncols >> log_g);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(roots),
        static_cast<const uint64_t*>(tw_op), static_cast<const uint64_t*>(tw_qt),
        static_cast<const uint64_t*>(q), static_cast<uint64_t*>(out), k, n, log_m, ncols, log_g,
        sx_k, sx_t, so_m, so_t);
    return static_cast<int>(cudaGetLastError());
}
