// Kernel A: full negacyclic NTT (forward or inverse) of (poly, limb) rows,
// each row spread over a thread block cluster.
//
// Replaces seal_tpu/ops/pallas_mxu_ntt.py:_fused_kernel (launched by
// _run_fused through pallas_ntt_forward / pallas_ntt_inverse).  Same
// function: forward from [0, 4q), inverse from [0, 2q) with 1/n (and the
// table's inv_scale) folded into the last stage, output reduced to [0, q) in
// the bit-reversed Harvey order.  The TPU kernel reached exactness through
// 7-bit int8 digit planes on its matrix unit, which has no 64-bit integer
// multiply; Hopper has __umul64hi, so this kernel runs the Harvey
// butterflies of the plain version (ops/ntt.py) on native u64.
//
// What bounds it on an H100: one row is 8n bytes read and 8n written, and
// log2(n) stages of n/2 butterflies; at N=8192 the main path's calls move
// 0.3-1.6 MB, well under a microsecond at 3.35 TB/s.  What held the first
// design back was parallelism: one block per row put 2-8 blocks on 132 SMs,
// each walking 13 stages with a barrier between them and reading every
// twiddle from L2.
//
// What the design does about it: a row of n = C * L elements is spread over
// a cluster of C blocks (C = 8 from n = 64 up), block c holding the
// contiguous chunk [c L, (c+1) L) in its shared memory, so a row fits up to
// n = 32768 (32 KB of data a block, plus its 64 KB of roots).  The forward
// transform's first log2(C) stages pair elements of different chunks: one
// column pass runs them, each thread reading the C elements of one offset
// from device memory, doing the butterflies in registers and writing each
// result into the shared memory of the block that owns it, through
// distributed shared memory (ntt_cluster.cuh, shared with kernel B); one
// cluster barrier follows.  The remaining
// log2(L) stages are local and run three per __syncthreads() in registers
// (ntt_passes.cuh), with the block's roots staged in shared memory once.  The
// inverse mirrors it: local stages first, then the cross-chunk column pass,
// which reads the C chunks through distributed shared memory, folds 1/n and
// the last root into its last stage and stores to device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ntt_cluster.cuh"

namespace cg = cooperative_groups;
using seal_tpu_torch::column_stride;
using seal_tpu_torch::guard;
using seal_tpu_torch::pad8;
using seal_tpu_torch::share_of;
using seal_tpu_torch::shoup_lazy;

namespace {

constexpr int kMaxThreads = 512;

// grid: rows * C blocks in clusters of C; cluster r transforms row r with
// limb r % k.  op, qt: the (k, n) forward table (slot 2^s + block).
template <int LOG_C>
__global__ void __launch_bounds__(kMaxThreads) ntt_forward_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out, const uint64_t* __restrict__ op,
    const uint64_t* __restrict__ qt, const uint64_t* __restrict__ qv, int k, int log_n) {
    constexpr int C = 1 << LOG_C;
    extern __shared__ uint64_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.block_rank());
    const int row = blockIdx.x >> LOG_C;
    const int log_l = log_n - LOG_C;
    const int L = 1 << log_l;
    const int limb = row % k;
    const uint64_t q = qv[limb];
    const uint64_t two_q = q << 1;
    const uint64_t* rop = op + (static_cast<size_t>(limb) << log_n);
    const uint64_t* rqt = qt + (static_cast<size_t>(limb) << log_n);
    uint64_t* t_op = smem;
    uint64_t* t_qt = smem + L;
    uint64_t* data = smem + 2 * L;

    // Every block of the cluster must have started before any writes into
    // its shared memory: arrive now, wait just before the first remote write.
    seal_tpu_torch::cluster_arrive();
    seal_tpu_torch::stage_local_forward_roots(t_op, t_qt, rop, rqt, c, LOG_C, L);
    uint64_t w_op[C], w_qt[C];               // slots 1 .. C-1: the cross stages' roots
#pragma unroll
    for (int i = 1; i < C; ++i) {
        w_op[i] = rop[i];
        w_qt[i] = rqt[i];
    }
    seal_tpu_torch::cluster_wait();

    const uint64_t* xr = x + (static_cast<size_t>(row) << log_n);
    seal_tpu_torch::cross_forward_pass<LOG_C>(data, log_l, [&](int idx) { return xr[idx]; }, w_op, w_qt, q);
    cluster.sync();

    seal_tpu_torch::ct_stages(data, column_stride(log_l), 1, log_l, t_op, t_qt, q);
    uint64_t* dst = out + (static_cast<size_t>(row) << log_n) + (c << log_l);
    for (int i = threadIdx.x; i < L; i += blockDim.x) dst[i] = guard(guard(data[pad8(i)], two_q), q);
}

// op, qt: the (k, n) inverse table (stage s reads slot 1 + n - n/2^s +
// block); invn, last: 1/n and the last root over n, per limb.
template <int LOG_C>
__global__ void __launch_bounds__(kMaxThreads) ntt_inverse_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out, const uint64_t* __restrict__ op,
    const uint64_t* __restrict__ qt, const uint64_t* __restrict__ invn,
    const uint64_t* __restrict__ invn_qt, const uint64_t* __restrict__ last,
    const uint64_t* __restrict__ last_qt, const uint64_t* __restrict__ qv, int k, int log_n) {
    constexpr int C = 1 << LOG_C;
    extern __shared__ uint64_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.block_rank());
    const int row = blockIdx.x >> LOG_C;
    const int log_l = log_n - LOG_C;
    const int L = 1 << log_l;
    const int n = 1 << log_n;
    const int limb = row % k;
    const uint64_t q = qv[limb];
    const uint64_t two_q = q << 1;
    const uint64_t* rop = op + (static_cast<size_t>(limb) << log_n);
    const uint64_t* rqt = qt + (static_cast<size_t>(limb) << log_n);
    uint64_t* t_op = smem;
    uint64_t* t_qt = smem + L;
    uint64_t* data = smem + 2 * L;

    // Local stage s (L / 2^(s+1) blocks of the chunk) reads global slots
    // 1 + n - n/2^s + c L/2^(s+1) + j, kept at 1 + L - L/2^s + j.
    for (int ls = 1 + threadIdx.x; ls < L; ls += blockDim.x) {
        const int s = log_l - (32 - __clz(L - ls));     // L - ls + 1 lies in (L/2^(s+1), L/2^s]
        const int j = ls - (1 + L - (L >> s));
        const int g = 1 + n - (n >> s) + c * (L >> (s + 1)) + j;
        t_op[ls] = rop[g];
        t_qt[ls] = rqt[g];
    }
    const uint64_t* src = x + (static_cast<size_t>(row) << log_n) + (c << log_l);
    for (int i = threadIdx.x; i < L; i += blockDim.x) data[pad8(i)] = guard(src[i], two_q);
    __syncthreads();

    seal_tpu_torch::gs_stages(data, column_stride(log_l), 1, log_l, false, t_op, t_qt, q);
    cluster.sync();

    // The cross stages: global stage log_l + j pairs chunks differing in bit
    // j; its block of chunk e is e >> (j + 1).  The last one folds 1/n.
    uint64_t w_op[C], w_qt[C];
#pragma unroll
    for (int j = 0; j < LOG_C - 1; ++j) {
        const int offset = 1 + n - (n >> (log_l + j));
#pragma unroll
        for (int b = 0; b < (C >> (j + 1)); ++b) {
            w_op[(C >> j) - (C >> (j + 1)) + b] = rop[offset + b];
            w_qt[(C >> j) - (C >> (j + 1)) + b] = rqt[offset + b];
        }
    }
    const uint64_t f_op = invn[limb], f_qt = invn_qt[limb], l_op = last[limb], l_qt = last_qt[limb];
    int lo, hi;
    share_of(c, L, LOG_C, &lo, &hi);
    uint64_t* dst = out + (static_cast<size_t>(row) << log_n);
    for (int o = lo + threadIdx.x; o < hi; o += blockDim.x) {
        uint64_t v[C];
#pragma unroll
        for (int e = 0; e < C; ++e) v[e] = cluster.map_shared_rank(data, e)[pad8(o)];
#pragma unroll
        for (int j = 0; j < LOG_C; ++j) {
            const int half = 1 << j;
#pragma unroll
            for (int e = 0; e < C; ++e) {
                if (e & half) continue;
                const uint64_t x0 = v[e];
                const uint64_t x1 = v[e | half];
                if (j == LOG_C - 1) {
                    const uint64_t u = guard(x0, two_q);
                    v[e] = shoup_lazy(guard(u + x1, two_q), f_op, f_qt, q);
                    v[e | half] = shoup_lazy(u + two_q - x1, l_op, l_qt, q);
                } else {
                    const int slot = (C >> j) - (C >> (j + 1)) + (e >> (j + 1));
                    v[e] = guard(x0 + x1, two_q);
                    v[e | half] = shoup_lazy(x0 + two_q - x1, w_op[slot], w_qt[slot], q);
                }
            }
        }
#pragma unroll
        for (int e = 0; e < C; ++e) dst[(e << log_l) + o] = guard(v[e], q);
    }
    cluster.sync();      // no block leaves while the others read its chunk
}

// Blocks per row: 8 from n = 64 up, fewer below, so a chunk has at least
// as many elements as the cluster has blocks.
int log_cluster(int log_n) { return std::min(3, log_n / 2); }

int threads_for(int log_l) { return std::min(kMaxThreads, std::max(32, (1 << log_l) / 8)); }

int smem_for(int log_l) {
    return static_cast<int>(sizeof(uint64_t)) * (2 * (1 << log_l) + column_stride(log_l));
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int (&allowed)[64], int rows, int log_n, void* stream, Args... args) {
    const int log_c = log_cluster(log_n);
    const int log_l = log_n - log_c;
    const int smem = smem_for(log_l);
    cudaError_t err = seal_tpu_torch::allow_shared_memory(kernel, smem, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(rows << log_c);
    config.blockDim = dim3(threads_for(log_l));
    config.dynamicSmemBytes = smem;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << log_c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows = product of the leading axes times k; row r uses limb r % k;
// 2 <= log_n <= 15.
extern "C" int seal_ntt_forward(const void* x, void* out, const void* op, const void* qt,
                                const void* q, int rows, int k, int log_n, void* stream) {
    static int allowed[3][64] = {};
    const int log_c = log_cluster(log_n);
    auto args = [&](auto kernel, int (&al)[64]) {
        return launch(kernel, al, rows, log_n, stream, static_cast<const uint64_t*>(x),
                      static_cast<uint64_t*>(out), static_cast<const uint64_t*>(op),
                      static_cast<const uint64_t*>(qt), static_cast<const uint64_t*>(q), k, log_n);
    };
    if (log_c == 3) return args(ntt_forward_kernel<3>, allowed[2]);
    if (log_c == 2) return args(ntt_forward_kernel<2>, allowed[1]);
    return args(ntt_forward_kernel<1>, allowed[0]);
}

extern "C" int seal_ntt_inverse(const void* x, void* out, const void* op, const void* qt,
                                const void* invn, const void* invn_qt, const void* last,
                                const void* last_qt, const void* q, int rows, int k, int log_n,
                                void* stream) {
    static int allowed[3][64] = {};
    const int log_c = log_cluster(log_n);
    auto args = [&](auto kernel, int (&al)[64]) {
        return launch(kernel, al, rows, log_n, stream, static_cast<const uint64_t*>(x),
                      static_cast<uint64_t*>(out), static_cast<const uint64_t*>(op),
                      static_cast<const uint64_t*>(qt), static_cast<const uint64_t*>(invn),
                      static_cast<const uint64_t*>(invn_qt), static_cast<const uint64_t*>(last),
                      static_cast<const uint64_t*>(last_qt), static_cast<const uint64_t*>(q), k,
                      log_n);
    };
    if (log_c == 3) return args(ntt_inverse_kernel<3>, allowed[2]);
    if (log_c == 2) return args(ntt_inverse_kernel<2>, allowed[1]);
    return args(ntt_inverse_kernel<1>, allowed[0]);
}
