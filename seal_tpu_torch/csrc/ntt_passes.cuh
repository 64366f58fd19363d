// Butterfly passes over columns held in shared memory, several stages per
// __syncthreads().
//
// Shared by kernels A (ntt.cu) and B (switch_key.cu) and the four-step stage
// kernel (four_step.cu).
// A column is an M = 2^log_m point transform; element i sits at
// a[pad8(i)] (one padding word per 8 spreads the strided accesses of the
// later passes over the banks), and column c of a block at a + c * cs.  A
// pass runs up to three stages: each thread loads a group of up to 8
// elements that those stages pair only among themselves, runs the
// butterflies in registers and writes the group back.  So an M-point
// transform takes ceil(log2(M) / 3) barriers instead of log2(M).
//
// The arithmetic is that of the plain version (ops/ntt.py), on the primitives
// of ntt_device.cuh: Harvey butterflies with Shoup twiddles,
// [0, 4q) through the forward stages and [0, 2q) through the inverse.  Root
// tables are laid out as ntt_tables.py describes: forward stage s (2^s
// blocks) reads slot 2^s + block; inverse stage s (M / 2^(s+1) blocks) reads
// slot 1 + M - M / 2^s + block.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_device.cuh"

namespace seal_tpu_torch {

__device__ __forceinline__ int pad8(int i) { return i + (i >> 3); }

// Words between two columns of 2^log_m elements: odd, so that neighbouring
// columns start in different banks.
__host__ __device__ inline int column_stride(int log_m) {
    return (1 << log_m) + ((1 << log_m) >> 3) + 1;
}

// Cooley-Tukey stages s0 .. s0+P-1 on the group whose elements sit at
// base + (e << shift), e < 2^P; stage s0 + j pairs elements whose e differ
// in bit P-1-j.
template <int P>
__device__ __forceinline__ void ct_pass(uint64_t* a, int base, int shift, int log_m, int s0,
                                        const uint64_t* op, const uint64_t* qt, uint64_t q,
                                        uint64_t two_q) {
    uint64_t v[1 << P];
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) v[e] = a[pad8(base + (e << shift))];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int s = s0 + j;
        const int half = 1 << (P - 1 - j);
#pragma unroll
        for (int e = 0; e < (1 << P); ++e) {
            if (e & half) continue;
            const int slot = (1 << s) + ((base + (e << shift)) >> (log_m - s));
            const uint64_t u = guard(v[e], two_q);
            const uint64_t t = shoup_lazy(v[e | half], op[slot], qt[slot], q);
            v[e] = u + t;
            v[e | half] = u + two_q - t;
        }
    }
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) a[pad8(base + (e << shift))] = v[e];
}

// Gentleman-Sande stages s0 .. s0+P-1 on the group at base + (e << s0);
// stage s0 + j pairs elements whose e differ in bit j.  With fold_last, the
// transform's last stage multiplies the sum by slot 0 and the difference by
// slot M - 1 (its root, scaled).
template <int P>
__device__ __forceinline__ void gs_pass(uint64_t* a, int base, int log_m, int s0, bool fold_last,
                                        const uint64_t* op, const uint64_t* qt, uint64_t q,
                                        uint64_t two_q) {
    const int m_size = 1 << log_m;
    uint64_t v[1 << P];
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) v[e] = a[pad8(base + (e << s0))];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int s = s0 + j;
        const int half = 1 << j;
        const int offset = 1 + m_size - (m_size >> s);
        const bool last = fold_last && s == log_m - 1;
#pragma unroll
        for (int e = 0; e < (1 << P); ++e) {
            if (e & half) continue;
            const int slot = offset + ((base + (e << s0)) >> (s + 1));
            const uint64_t x0 = v[e];
            const uint64_t x1 = v[e | half];
            if (last) {
                const uint64_t u = guard(x0, two_q);
                v[e] = shoup_lazy(guard(u + x1, two_q), op[0], qt[0], q);
                v[e | half] = shoup_lazy(u + two_q - x1, op[slot], qt[slot], q);
            } else {
                v[e] = guard(x0 + x1, two_q);
                v[e | half] = shoup_lazy(x0 + two_q - x1, op[slot], qt[slot], q);
            }
        }
    }
#pragma unroll
    for (int e = 0; e < (1 << P); ++e) a[pad8(base + (e << s0))] = v[e];
}

// Every forward stage of ncol columns of 2^log_m elements, in place, [0, 4q)
// -> [0, 4q), natural input to bit-reversed output.  Called by every thread
// of the block after a barrier that follows the last write to the columns;
// ends with __syncthreads().
__device__ inline void ct_stages(uint64_t* a, int cs, int ncol, int log_m, const uint64_t* op,
                                 const uint64_t* qt, uint64_t q) {
    const uint64_t two_q = q << 1;
    for (int s0 = 0; s0 < log_m; s0 += 3) {
        const int p = min(3, log_m - s0);
        const int shift = log_m - s0 - p;        // lowest index bit the pass pairs on
        const int per_col = 1 << (log_m - p);
        for (int g = threadIdx.x; g < ncol * per_col; g += blockDim.x) {
            const int gi = g & (per_col - 1);
            const int base = ((gi >> shift) << (shift + p)) | (gi & ((1 << shift) - 1));
            uint64_t* col = a + (g >> (log_m - p)) * cs;
            if (p == 3) ct_pass<3>(col, base, shift, log_m, s0, op, qt, q, two_q);
            else if (p == 2) ct_pass<2>(col, base, shift, log_m, s0, op, qt, q, two_q);
            else ct_pass<1>(col, base, shift, log_m, s0, op, qt, q, two_q);
        }
        __syncthreads();
    }
}

// Every inverse stage of ncol columns, in place, [0, 2q) -> [0, 2q),
// bit-reversed input to natural output; the same calling convention.
__device__ inline void gs_stages(uint64_t* a, int cs, int ncol, int log_m, bool fold_last,
                                 const uint64_t* op, const uint64_t* qt, uint64_t q) {
    const uint64_t two_q = q << 1;
    for (int s0 = 0; s0 < log_m; s0 += 3) {
        const int p = min(3, log_m - s0);
        const int per_col = 1 << (log_m - p);
        for (int g = threadIdx.x; g < ncol * per_col; g += blockDim.x) {
            const int gi = g & (per_col - 1);
            const int base = ((gi >> s0) << (s0 + p)) | (gi & ((1 << s0) - 1));
            uint64_t* col = a + (g >> (log_m - p)) * cs;
            if (p == 3) gs_pass<3>(col, base, log_m, s0, fold_last, op, qt, q, two_q);
            else if (p == 2) gs_pass<2>(col, base, log_m, s0, fold_last, op, qt, q, two_q);
            else gs_pass<1>(col, base, log_m, s0, fold_last, op, qt, q, two_q);
        }
        __syncthreads();
    }
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` where the
// device's current limit for it is lower; `allowed` remembers the limit per
// device, so the attribute is set once per kernel, size and device, not on
// every launch.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, int bytes, int (&allowed)[64]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= 64 || bytes <= allowed[dev]) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) allowed[dev] = bytes;
    return err;
}

}  // namespace seal_tpu_torch
