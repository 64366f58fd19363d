// The four-step stage kernel: one modular matrix stage of the four-step NTT.
//
// Replaces seal_tpu/ops/pallas_mxu_ntt.py:_stage_kernel (launched by
// _run_stage through the staged branch of pallas_ntt_forward /
// pallas_ntt_inverse).  Same function: for every (poly, limb) row,
//
//     out[m, t] = (sum_kappa B[m, kappa] * x[kappa, t]) mod q   (then * T[m, t] mod q)
//
// with B the limb's (M, K) matrix (W, F, Finv or Winv) and T an optional
// Shoup twiddle, output in [0, q).  The plain version is
// seal_tpu_torch/ops/four_step.py:stage_plain.  The TPU kernel reached
// exactness with 7-bit int8 digit planes on its matrix unit; Hopper
// multiplies 64-bit integers, so each product here is a native 64x64 -> 128
// multiply, summed in u128 and Barrett-reduced every 64 products (64 (q-1)^2
// + q < 2^128 for q < 2^61).  Any exact chunking gives the same residue.
//
// Strides fold the JAX package's transposes between stages into the
// indexing: element (kappa, t) of a row is read at kappa*sx_k + t*sx_t and
// element (m, t) written at m*so_m + t*so_t; the twiddle is read at the
// output's position.  The input may be lazy (below 4q) and is reduced to
// [0, q) as it is loaded.  So a transform is two launches and nothing else.
//
// What bounds it on an H100: the function (one M-point transform per
// column) needs M/2 log2(M) butterflies per column and one pass over the
// data: at N=65536 a few MB and ~10^8 integer operations per call, a few
// microseconds.  This kernel does the dense product instead, M*K
// multiply-adds per column (about 40x the butterflies' arithmetic at M=512)
// on the integer pipes, which have no 64-bit multiplier: each u64 product is
// several 32-bit multiplies.  It is compute bound by design.
//
// What the design does about it: a 64 x 64 output tile per block, the B and
// x tiles staged in shared memory (32-deep chunks), each thread keeping a
// 4 x 4 block of u128 sums in registers.  Butterflies of the M-point
// sub-transform in shared memory, or the TPU's own digit planes on int8
// wgmma (1,979 TOP/s), are the later ways to make it fast.
#include <cuda_runtime.h>

#include <cstdint>

typedef unsigned __int128 u128;

namespace {

constexpr int kTileM = 64;
constexpr int kTileT = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWindow = 64;     // products summed between reductions

__device__ __forceinline__ uint64_t guard(uint64_t x, uint64_t bound) {
    return x >= bound ? x - bound : x;
}

// The reference's barrett_reduce_128 (uintarithsmallmod.h:167-205).
__device__ __forceinline__ uint64_t barrett_reduce_128(u128 z, uint64_t q, uint64_t ratio_lo,
                                                       uint64_t ratio_hi) {
    const uint64_t z0 = static_cast<uint64_t>(z);
    const uint64_t z1 = static_cast<uint64_t>(z >> 64);
    const uint64_t carry = __umul64hi(z0, ratio_lo);
    const u128 p = static_cast<u128>(z0) * ratio_hi;
    const uint64_t p_lo = static_cast<uint64_t>(p);
    const uint64_t tmp1 = p_lo + carry;
    const uint64_t tmp3 = static_cast<uint64_t>(p >> 64) + (tmp1 < p_lo);
    const u128 p2 = static_cast<u128>(z1) * ratio_lo;
    const uint64_t p2_lo = static_cast<uint64_t>(p2);
    const uint64_t carry2 = static_cast<uint64_t>(p2 >> 64) + (tmp1 + p2_lo < tmp1);
    const uint64_t quot = z1 * ratio_hi + tmp3 + carry2;
    return guard(z0 - quot * q, q);
}

// grid: (ceil(ncols / 64), ceil(M / 64), rows); row r uses limb r % k.
__global__ void __launch_bounds__(kThreads) four_step_stage_kernel(
    const uint64_t* __restrict__ x, const uint64_t* __restrict__ b,
    const uint64_t* __restrict__ tw_op, const uint64_t* __restrict__ tw_qt,
    const uint64_t* __restrict__ qv, const uint64_t* __restrict__ ratio_lo,
    const uint64_t* __restrict__ ratio_hi, uint64_t* __restrict__ out, int k, int n, int M, int K,
    int ncols, int sx_k, int sx_t, int so_m, int so_t) {
    __shared__ uint64_t bs[kTileM][kTileK + 1];
    __shared__ uint64_t xs[kTileK][kTileT + 1];

    const int row = blockIdx.z;
    const int limb = row % k;
    const int m0 = blockIdx.y * kTileM;
    const int t0 = blockIdx.x * kTileT;
    const uint64_t q = qv[limb];
    const uint64_t two_q = q << 1;
    const uint64_t r_lo = ratio_lo[limb];
    const uint64_t r_hi = ratio_hi[limb];
    const uint64_t* xr = x + static_cast<size_t>(row) * n;
    const uint64_t* br = b + static_cast<size_t>(limb) * M * K;

    // Neighbouring threads own neighbouring outputs along the axis that is
    // contiguous in the output, so the stores coalesce.
    const int a = threadIdx.x & 15;
    const int c = threadIdx.x >> 4;
    const bool m_fast = so_m == 1;
    const int mi = m_fast ? a : c;
    const int ti = m_fast ? c : a;

    u128 acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    int summed = 0;
    for (int k0 = 0; k0 < K; k0 += kTileK) {
        for (int idx = threadIdx.x; idx < kTileM * kTileK; idx += kThreads) {
            const int mm = idx / kTileK;
            const int kk = idx % kTileK;
            const int gm = m0 + mm;
            const int gk = k0 + kk;
            bs[mm][kk] = (gm < M && gk < K) ? br[static_cast<size_t>(gm) * K + gk] : 0;
        }
        for (int idx = threadIdx.x; idx < kTileK * kTileT; idx += kThreads) {
            // walk the axis that is contiguous in memory fastest
            const int kk = sx_k == 1 ? idx % kTileK : idx / kTileT;
            const int tt = sx_k == 1 ? idx / kTileK : idx % kTileT;
            const int gk = k0 + kk;
            const int gt = t0 + tt;
            uint64_t v = 0;
            if (gk < K && gt < ncols)
                v = guard(guard(xr[static_cast<size_t>(gk) * sx_k + static_cast<size_t>(gt) * sx_t], two_q), q);
            xs[kk][tt] = v;
        }
        __syncthreads();
        if (summed + kTileK > kWindow) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = barrett_reduce_128(acc[i][j], q, r_lo, r_hi);
            summed = 0;
        }
#pragma unroll 4
        for (int kk = 0; kk < kTileK; ++kk) {
            uint64_t bv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) bv[i] = bs[mi + 16 * i][kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = xs[kk][ti + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += static_cast<u128>(bv[i]) * xv[j];
        }
        summed += kTileK;
        __syncthreads();  // the next chunk overwrites the tiles
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gm = m0 + mi + 16 * i;
            const int gt = t0 + ti + 16 * j;
            if (gm >= M || gt >= ncols) continue;
            const size_t pos = static_cast<size_t>(gm) * so_m + static_cast<size_t>(gt) * so_t;
            uint64_t o = barrett_reduce_128(acc[i][j], q, r_lo, r_hi);
            if (tw_op != nullptr) {
                const size_t tp = static_cast<size_t>(limb) * n + pos;
                o = guard(o * tw_op[tp] - __umul64hi(o, tw_qt[tp]) * q, q);
            }
            out[static_cast<size_t>(row) * n + pos] = o;
        }
    }
}

}  // namespace

// x, out: (rows, n); b: (k, M, K); tw_op, tw_qt: (k, n) or null; q, ratio_lo,
// ratio_hi: (k,).  Row r uses limb r % k.  Returns the CUDA error code.
extern "C" int seal_four_step_stage(const void* x, const void* b, const void* tw_op,
                                    const void* tw_qt, const void* q, const void* ratio_lo,
                                    const void* ratio_hi, void* out, int rows, int k, int n, int M,
                                    int K, int ncols, int sx_k, int sx_t, int so_m, int so_t,
                                    void* stream) {
    const dim3 grid((ncols + kTileT - 1) / kTileT, (M + kTileM - 1) / kTileM, rows);
    four_step_stage_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(b),
        static_cast<const uint64_t*>(tw_op), static_cast<const uint64_t*>(tw_qt),
        static_cast<const uint64_t*>(q), static_cast<const uint64_t*>(ratio_lo),
        static_cast<const uint64_t*>(ratio_hi), static_cast<uint64_t*>(out), k, n, M, K, ncols,
        sx_k, sx_t, so_m, so_t);
    return static_cast<int>(cudaGetLastError());
}
