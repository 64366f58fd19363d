// Negacyclic NTT stage loops on one row held in shared memory.
//
// The row functions serve kernel B (switch_key.cu); kernel A and the stage
// kernel run the passes of ntt_passes.cuh, built on the Shoup product and
// the guard defined here.  The arithmetic
// is that of the plain PyTorch version (seal_tpu_torch/ops/ntt.py): Harvey
// butterflies with Shoup twiddles, lazy ranges [0, 4q) forward and [0, 2q)
// inverse, the inverse's last stage fusing 1/n.  Values are u64 below 2^62,
// so every sum here stays far from 2^64; the Shoup product
// x*w - floor(x*wq / 2^64)*q is taken mod 2^64 and lies in [0, 2q).
//
// Calling convention: every thread of the block calls the function after a
// __syncthreads() that follows the last write to the row; the function ends
// with a __syncthreads(), so the caller may read the row at once.
#pragma once

#include <cstdint>

namespace seal_tpu_torch {

__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w, uint64_t wq, uint64_t q) {
    return x * w - __umul64hi(x, wq) * q;
}

__device__ __forceinline__ uint64_t guard(uint64_t x, uint64_t bound) {
    return x >= bound ? x - bound : x;
}

// In place, [0, 4q) -> [0, 4q), bit-reversed output order.  `op`/`qt` are
// the limb's forward table row: stage s (m = 2^s blocks) reads slots [m, 2m).
__device__ void ntt_forward_row(uint64_t* a, int log_n, const uint64_t* __restrict__ op,
                                const uint64_t* __restrict__ qt, uint64_t q) {
    const int half = 1 << (log_n - 1);
    const uint64_t two_q = q << 1;
    for (int s = 0; s < log_n; ++s) {
        const int log_gap = log_n - s - 1;
        const int m = 1 << s;
        for (int b = threadIdx.x; b < half; b += blockDim.x) {
            const int blk = b >> log_gap;
            const int i0 = (blk << (log_gap + 1)) + (b & ((1 << log_gap) - 1));
            const int i1 = i0 + (1 << log_gap);
            const uint64_t u = guard(a[i0], two_q);
            const uint64_t v = shoup_lazy(a[i1], op[m + blk], qt[m + blk], q);
            a[i0] = u + v;
            a[i1] = u + two_q - v;
        }
        __syncthreads();
    }
}

// In place, [0, 2q) -> [0, 2q).  `op`/`qt` are the limb's inverse table row:
// stage s (m = n / 2^(s+1) blocks) reads slots [offset, offset + m), offset
// counting up from 1.  The last stage (m == 1) multiplies the sum by 1/n
// (`invn`) and the difference by the last root over n (`last`).
__device__ void ntt_inverse_row(uint64_t* a, int log_n, const uint64_t* __restrict__ op,
                                const uint64_t* __restrict__ qt, uint64_t invn, uint64_t invn_qt,
                                uint64_t last, uint64_t last_qt, uint64_t q) {
    const int n = 1 << log_n;
    const int half = n >> 1;
    const uint64_t two_q = q << 1;
    int offset = 1;
    for (int s = 0; s < log_n; ++s) {
        const int m = n >> (s + 1);
        for (int b = threadIdx.x; b < half; b += blockDim.x) {
            const int blk = b >> s;
            const int i0 = (blk << (s + 1)) + (b & ((1 << s) - 1));
            const int i1 = i0 + (1 << s);
            const uint64_t x0 = a[i0];
            const uint64_t x1 = a[i1];
            if (m > 1) {
                a[i0] = guard(x0 + x1, two_q);
                a[i1] = shoup_lazy(x0 + two_q - x1, op[offset + blk], qt[offset + blk], q);
            } else {
                const uint64_t u = guard(x0, two_q);
                a[i0] = shoup_lazy(guard(u + x1, two_q), invn, invn_qt, q);
                a[i1] = shoup_lazy(u + two_q - x1, last, last_qt, q);
            }
        }
        offset += m;
        __syncthreads();
    }
}

}  // namespace seal_tpu_torch
