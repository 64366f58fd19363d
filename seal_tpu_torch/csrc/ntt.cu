// Kernel A: full negacyclic NTT (forward or inverse) of (poly, limb) rows.
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
// log2(n) stages of n/2 butterflies, each three 64-bit multiplies (one
// high, two low: about a dozen 32-bit integer instructions).  At N=8192 that
// is ~1.3 MB moved for the main path's largest call against ~10^7 integer
// operations, so the integer pipes, not memory, are the roof; with only
// rows = polys x limbs blocks (4 to 8 on the main path) on 132 SMs the
// kernel is in practice latency bound: each block walks 13 stages with a
// __syncthreads() between them.
//
// What the design does about it: one thread block per row keeps the whole
// row in shared memory (64 KB at N=8192, 128 KB at N=16384, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize), so the stages never touch
// device memory; twiddles are read from the (k, n) Shoup tables, which stay
// in L2.  Filling the card (several rows per SM, warp-level stages, int8
// wgmma digit planes) is later work.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ntt_device.cuh"

using seal_tpu_torch::guard;

extern __shared__ uint64_t row_smem[];

namespace {

__global__ void __launch_bounds__(1024) ntt_forward_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                                   const uint64_t* __restrict__ op, const uint64_t* __restrict__ qt,
                                   const uint64_t* __restrict__ qv, int k, int log_n) {
    const int n = 1 << log_n;
    const int limb = blockIdx.x % k;
    const uint64_t q = qv[limb];
    const uint64_t* src = x + static_cast<size_t>(blockIdx.x) * n;
    uint64_t* dst = out + static_cast<size_t>(blockIdx.x) * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) row_smem[c] = src[c];
    __syncthreads();
    seal_tpu_torch::ntt_forward_row(row_smem, log_n, op + static_cast<size_t>(limb) * n,
                                    qt + static_cast<size_t>(limb) * n, q);
    const uint64_t two_q = q << 1;
    for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = guard(guard(row_smem[c], two_q), q);
}

__global__ void __launch_bounds__(1024) ntt_inverse_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                                   const uint64_t* __restrict__ op, const uint64_t* __restrict__ qt,
                                   const uint64_t* __restrict__ invn, const uint64_t* __restrict__ invn_qt,
                                   const uint64_t* __restrict__ last, const uint64_t* __restrict__ last_qt,
                                   const uint64_t* __restrict__ qv, int k, int log_n) {
    const int n = 1 << log_n;
    const int limb = blockIdx.x % k;
    const uint64_t q = qv[limb];
    const uint64_t* src = x + static_cast<size_t>(blockIdx.x) * n;
    uint64_t* dst = out + static_cast<size_t>(blockIdx.x) * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) row_smem[c] = src[c];
    __syncthreads();
    seal_tpu_torch::ntt_inverse_row(row_smem, log_n, op + static_cast<size_t>(limb) * n,
                                    qt + static_cast<size_t>(limb) * n, invn[limb], invn_qt[limb],
                                    last[limb], last_qt[limb], q);
    for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = guard(row_smem[c], q);
}

int threads_for(int log_n) { return std::min(1024, std::max(32, 1 << (log_n - 1))); }

}  // namespace

// rows = product of the leading axes times k; row r uses limb r % k.
extern "C" int seal_ntt_forward(const void* x, void* out, const void* op, const void* qt,
                                const void* q, int rows, int k, int log_n, void* stream) {
    const int smem = static_cast<int>(sizeof(uint64_t)) << log_n;
    cudaError_t err = cudaFuncSetAttribute(ntt_forward_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_forward_kernel<<<rows, threads_for(log_n), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
        static_cast<const uint64_t*>(op), static_cast<const uint64_t*>(qt),
        static_cast<const uint64_t*>(q), k, log_n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int seal_ntt_inverse(const void* x, void* out, const void* op, const void* qt,
                                const void* invn, const void* invn_qt, const void* last,
                                const void* last_qt, const void* q, int rows, int k, int log_n,
                                void* stream) {
    const int smem = static_cast<int>(sizeof(uint64_t)) << log_n;
    cudaError_t err = cudaFuncSetAttribute(ntt_inverse_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt_inverse_kernel<<<rows, threads_for(log_n), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
        static_cast<const uint64_t*>(op), static_cast<const uint64_t*>(qt),
        static_cast<const uint64_t*>(invn), static_cast<const uint64_t*>(invn_qt),
        static_cast<const uint64_t*>(last), static_cast<const uint64_t*>(last_qt),
        static_cast<const uint64_t*>(q), k, log_n);
    return static_cast<int>(cudaGetLastError());
}
