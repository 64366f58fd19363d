// Kernel B: fused key-switch contraction (decompose + forward NTT + key
// product + u128 accumulation + Barrett).
//
// Replaces seal_tpu/ops/pallas_switch_key.py:_sk_kernel (launched by
// switch_key_contract).  Same contract: for each output limb i and
// decomposition limb j, reduce t_c[j] mod q_i where need_reduce[j, i], run
// the forward NTT mod q_i (at i == j with an NTT-form target, take t_n[j]
// instead), multiply by both key components 64x64 -> 128 and accumulate over
// j in u128, Barrett-reducing the sum every 64 summands when D > 64, then
// one final Barrett: out (2, Rn, n) in [0, q_i).  Key rows beyond D are not
// read (the key may carry more decomposition rows than the level has limbs).
//
// Two axes the TPU kernel did not have.  A batch of B ciphertexts sharing one
// key runs in one launch, grid axis y over them, the way vmap adds a grid
// axis to _sk_kernel.  And a rank of a mesh that holds decomposition rows
// [j0, j0 + D) contracts only those (parallel/batch.py adds the ranks'
// partial sums mod q_i): row j is decomposition row j0 + j, so the i == j
// fast path compares i with j0 + j.
//
// The TPU walked j in order on one core and carried the u128 sum in VMEM
// scratch between grid steps.  Blocks on the card run in no order, so the
// loop over j lives inside the block: one block per output limb i.
//
// What bounds it on an H100: per output limb, D rows of t_c (8n bytes each)
// and 2D key rows are read and 2 rows written; the D NTTs are
// D log2(n) n/2 butterflies.  At the main path's D=4, Rn=5, N=8192 that is
// ~3 MB of key and data against ~10^7 integer operations: integer work
// rather than bytes is the roof, and with only Rn = 5 blocks on 132 SMs the
// kernel is latency bound in practice.
//
// What the design does about it: the row being transformed lives in shared
// memory and the NTT stages never touch device memory; the u128
// accumulators are per-thread arrays (PER coefficients of each of the two
// outputs), so the (D, Rn, n) transform never reaches device memory.  At
// N=8192 the 16 accumulators of a thread need 64 registers, the block's
// 1024 threads allow 64 each: the compiler spills part of them to local
// memory, which stays in L1/L2 (the build log shows the spill count).
// Spreading the work over more SMs (splitting j or the coefficients across
// blocks) is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_device.cuh"

using seal_tpu_torch::guard;
typedef unsigned __int128 u128;

extern __shared__ uint64_t row_smem[];

namespace {

constexpr int kAccWindow = 64;  // lazy u128 summands between Barrett guards

__device__ __forceinline__ uint64_t barrett_reduce_64(uint64_t x, uint64_t q, uint64_t ratio_hi) {
    return guard(x - __umul64hi(x, ratio_hi) * q, q);
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

// Block (i, b) = output limb i of ciphertext b; blockDim.x * PER == n;
// thread t owns coefficients t + r * blockDim.x, r < PER.
template <int PER>
__global__ void __launch_bounds__(1024) switch_key_kernel(const uint64_t* __restrict__ t_c, const uint64_t* __restrict__ t_n,
                                  const uint64_t* __restrict__ key, const uint8_t* __restrict__ need_reduce,
                                  const uint64_t* __restrict__ op, const uint64_t* __restrict__ qt,
                                  const uint64_t* __restrict__ qv, const uint64_t* __restrict__ ratio_lo,
                                  const uint64_t* __restrict__ ratio_hi, uint64_t* __restrict__ out,
                                  int D, int key_rows, int Rn, int log_n, int j0) {
    const int n = 1 << log_n;
    const int i = blockIdx.x;
    const size_t b = blockIdx.y;
    t_c += b * D * n;
    if (t_n != nullptr) t_n += b * D * n;
    out += b * 2 * Rn * n;
    const uint64_t q = qv[i];
    const uint64_t r_lo = ratio_lo[i];
    const uint64_t r_hi = ratio_hi[i];
    const uint64_t two_q = q << 1;
    u128 acc0[PER];
    u128 acc1[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) acc0[r] = acc1[r] = 0;

    for (int j = 0; j < D; ++j) {
        if (t_n != nullptr && i == j0 + j) {
            for (int r = 0; r < PER; ++r) {
                const int c = threadIdx.x + r * blockDim.x;
                row_smem[c] = t_n[static_cast<size_t>(j) * n + c];
            }
            __syncthreads();
        } else {
            const bool reduce = need_reduce[j * Rn + i] != 0;
            for (int r = 0; r < PER; ++r) {
                const int c = threadIdx.x + r * blockDim.x;
                const uint64_t x = t_c[static_cast<size_t>(j) * n + c];
                row_smem[c] = reduce ? barrett_reduce_64(x, q, r_hi) : x;
            }
            __syncthreads();
            seal_tpu_torch::ntt_forward_row(row_smem, log_n, op + static_cast<size_t>(i) * n,
                                            qt + static_cast<size_t>(i) * n, q);
        }
        const uint64_t* k0 = key + (static_cast<size_t>(j) * Rn + i) * n;
        const uint64_t* k1 = key + (static_cast<size_t>(key_rows + j) * Rn + i) * n;
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int c = threadIdx.x + r * blockDim.x;
            const uint64_t x = guard(guard(row_smem[c], two_q), q);
            acc0[r] += static_cast<u128>(x) * k0[c];
            acc1[r] += static_cast<u128>(x) * k1[c];
        }
        if (D > kAccWindow && j % kAccWindow == kAccWindow - 1 && j != D - 1) {
#pragma unroll
            for (int r = 0; r < PER; ++r) {
                acc0[r] = barrett_reduce_128(acc0[r], q, r_lo, r_hi);
                acc1[r] = barrett_reduce_128(acc1[r], q, r_lo, r_hi);
            }
        }
        __syncthreads();  // the next j overwrites the row
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) {
        const int c = threadIdx.x + r * blockDim.x;
        out[static_cast<size_t>(i) * n + c] = barrett_reduce_128(acc0[r], q, r_lo, r_hi);
        out[(static_cast<size_t>(Rn) + i) * n + c] = barrett_reduce_128(acc1[r], q, r_lo, r_hi);
    }
}

template <int PER>
int launch(const void* t_c, const void* t_n, const void* key, const void* need_reduce,
           const void* op, const void* qt, const void* q, const void* ratio_lo,
           const void* ratio_hi, void* out, int B, int D, int key_rows, int Rn, int log_n, int j0,
           cudaStream_t stream) {
    const int smem = static_cast<int>(sizeof(uint64_t)) << log_n;
    cudaError_t err = cudaFuncSetAttribute(switch_key_kernel<PER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    switch_key_kernel<PER><<<dim3(Rn, B), (1 << log_n) / PER, smem, stream>>>(
        static_cast<const uint64_t*>(t_c), static_cast<const uint64_t*>(t_n),
        static_cast<const uint64_t*>(key), static_cast<const uint8_t*>(need_reduce),
        static_cast<const uint64_t*>(op), static_cast<const uint64_t*>(qt),
        static_cast<const uint64_t*>(q), static_cast<const uint64_t*>(ratio_lo),
        static_cast<const uint64_t*>(ratio_hi), static_cast<uint64_t*>(out), D, key_rows, Rn, log_n, j0);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_c, t_n: (B, D, n), decomposition rows [j0, j0 + D); key: two components
// of D rows of (Rn, n) each, row j of component c at key + (c * key_rows + j)
// * Rn * n (key_rows >= D); need_reduce: (D, Rn) bytes of those rows; op, qt:
// (Rn, n); q, ratio_lo, ratio_hi: (Rn,); out: (B, 2, Rn, n).  t_n may be null
// (no diagonal substitution).  8 <= n <= 16384, 1 <= B <= 65535.
extern "C" int seal_switch_key_contract(const void* t_c, const void* t_n, const void* key,
                                        const void* need_reduce, const void* op, const void* qt,
                                        const void* q, const void* ratio_lo, const void* ratio_hi,
                                        void* out, int B, int D, int key_rows, int Rn, int log_n,
                                        int j0, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (log_n <= 13)
        return launch<8>(t_c, t_n, key, need_reduce, op, qt, q, ratio_lo, ratio_hi, out, B, D,
                         key_rows, Rn, log_n, j0, s);
    return launch<16>(t_c, t_n, key, need_reduce, op, qt, q, ratio_lo, ratio_hi, out, B, D,
                      key_rows, Rn, log_n, j0, s);
}
