// The two primitives of every butterfly in the kernels (ntt_passes.cuh).
//
// The arithmetic is that of the plain PyTorch version
// (seal_tpu_torch/ops/ntt.py): Harvey butterflies with Shoup twiddles, lazy
// ranges [0, 4q) forward and [0, 2q) inverse.  Values are u64 below 2^62, so
// every sum stays far from 2^64; the Shoup product x*w - floor(x*wq /
// 2^64)*q is taken mod 2^64 and lies in [0, 2q).
#pragma once

#include <cstdint>

namespace seal_tpu_torch {

__device__ __forceinline__ uint64_t shoup_lazy(uint64_t x, uint64_t w, uint64_t wq, uint64_t q) {
    return x * w - __umul64hi(x, wq) * q;
}

__device__ __forceinline__ uint64_t guard(uint64_t x, uint64_t bound) {
    return x >= bound ? x - bound : x;
}

}  // namespace seal_tpu_torch
