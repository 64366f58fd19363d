// Kernel B: fused key-switch contraction (decompose + forward NTT + key
// product + u128 accumulation + Barrett), each output row on a thread block
// cluster.
//
// Replaces seal_tpu/ops/pallas_switch_key.py:_sk_kernel (launched by
// switch_key_contract).  Same contract: for each output limb i and
// decomposition limb j, reduce t_c[j] mod q_i where need_reduce[j, i], run
// the forward NTT mod q_i (at i == j with an NTT-form target, take t_n[j]
// instead), multiply by both key components 64x64 -> 128 and accumulate over
// j in u128, Barrett-reducing the sum every 64 summands when D > 64, then
// one final Barrett: out (2, Rn, n) in [0, q_i).  Key rows beyond D are not
// read (the key may carry more decomposition rows than the level has limbs).
// Two axes the TPU kernel did not have: a batch of B ciphertexts sharing one
// key runs in one launch, the way vmap adds a grid axis to _sk_kernel; and a
// rank of a mesh that holds decomposition rows [j0, j0 + D) contracts only
// those (parallel/batch.py adds the ranks' partial sums mod q_i), so the
// i == j fast path compares i with j0 + j.
//
// What bounds it on an H100: per (ciphertext, output limb), D rows of t_c
// and 2D key rows are read and 2 rows written, and D NTTs of n log2(n) / 2
// butterflies run.  The key dominates the bytes (2 D Rn n words: 126 MB at
// N=32768, D=15, Rn=16, more than the 50 MB L2, about 38 us at 3.35 TB/s);
// at the main path's N=8192, D=4, Rn=5 everything is ~3 MB and the kernel is
// bound by latency: the D rows are walked one after another, each a chain of
// loads, barriers and butterflies.  At N=32768 the butterflies' 64-bit
// multiplies come first, and a block of 512 threads at 128 registers fills
// an SM: the card holds 15 clusters of 8 at once, so a request's 16 output
// limbs run in two waves.
//
// What the design does about it.  The TPU walked j in order on one core and
// carried the u128 sum in VMEM between grid steps; blocks on the card run in
// no order, so the j loop lives inside a cluster of C blocks (C = 8 from
// n = 64 up) that owns one (ciphertext b, output limb i), b fastest in the
// grid so that the B clusters of one limb run side by side and share its key
// rows through L2.  Block c holds the chunk [c L, (c+1) L) of the row being
// transformed (L = n / C), so a row fits up to n = 32768 and the main path
// runs on 40 blocks instead of 5.  Per row j: the cross-chunk column pass
// (ntt_cluster.cuh, shared with kernel A) loads row j of t_c, Barrett-reduces
// it mod q_i where need_reduce says so (the decompose, fused into the load),
// runs the first log2(C) stages and writes into the owners' shared memory
// through distributed shared memory; one cluster barrier; the local stages
// three per __syncthreads() (ntt_passes.cuh:ct_stages) over limb i's roots,
// staged in shared memory once for all D rows; then each thread multiplies
// its PER coefficients by the two key rows' matching chunk and adds the
// products to its u128 accumulators, which never leave registers.  On the
// diagonal the block reads its chunk of t_n instead and runs no NTT.  A
// split cluster barrier (arrive after a row's last read of the chunk, wait
// before the next row's remote writes) keeps a block from overwriting a
// chunk that another still reads.  The (D, Rn, n) decomposition never
// reaches device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "ntt_cluster.cuh"

namespace cg = cooperative_groups;
using seal_tpu_torch::column_stride;
using seal_tpu_torch::guard;
using seal_tpu_torch::pad8;
typedef unsigned __int128 u128;

namespace {

constexpr int kAccWindow = 64;  // lazy u128 summands between Barrett guards
constexpr int kMaxThreads = 512;

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

// grid: Rn * B clusters of C blocks, cluster i * B + b on (output limb i,
// ciphertext b); thread t of block c owns coefficients c L + t + r T,
// r < PER, of the row (T = blockDim.x, T * PER >= L).  Shared memory: the
// local stages' roots (2 L words), the cross stages' roots (2 C), the chunk.
// GUARD: D > 64, the sums are Barrett-reduced every 64 rows.  Only those
// instantiations carry the reduction: unrolled over a thread's 2 PER sums it
// costs registers that the common case (every chain up to 64 limbs) keeps.
template <int LOG_C, int PER, bool GUARD>
__global__ void __launch_bounds__(kMaxThreads) switch_key_kernel(
    const uint64_t* __restrict__ t_c, const uint64_t* __restrict__ t_n, const uint64_t* __restrict__ key,
    const uint8_t* __restrict__ need_reduce, const uint64_t* __restrict__ op, const uint64_t* __restrict__ qt,
    const uint64_t* __restrict__ qv, const uint64_t* __restrict__ ratio_lo, const uint64_t* __restrict__ ratio_hi,
    uint64_t* __restrict__ out, int B, int D, int key_rows, int Rn, int log_n, int j0) {
    constexpr int C = 1 << LOG_C;
    extern __shared__ uint64_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.block_rank());
    const int cid = blockIdx.x >> LOG_C;
    const int i = cid / B;
    const int b = cid - i * B;
    const int log_l = log_n - LOG_C;
    const int L = 1 << log_l;
    const size_t n = static_cast<size_t>(1) << log_n;
    const size_t base = static_cast<size_t>(c) << log_l;     // the chunk's first coefficient
    const uint64_t q = qv[i];
    const uint64_t two_q = q << 1;
    const uint64_t r_lo = ratio_lo[i];
    const uint64_t r_hi = ratio_hi[i];
    uint64_t* t_op = smem;
    uint64_t* t_qt = smem + L;
    uint64_t* w_op = smem + 2 * L;
    uint64_t* w_qt = w_op + C;
    uint64_t* data = w_qt + C;

    // Every block of the cluster must have started before any writes into
    // its shared memory: arrive now, wait just before the first remote write.
    seal_tpu_torch::cluster_arrive();
    const uint64_t* rop = op + i * n;
    const uint64_t* rqt = qt + i * n;
    seal_tpu_torch::stage_local_forward_roots(t_op, t_qt, rop, rqt, c, LOG_C, L);
    if (threadIdx.x >= 1 && threadIdx.x < C) {
        w_op[threadIdx.x] = rop[threadIdx.x];
        w_qt[threadIdx.x] = rqt[threadIdx.x];
    }
    __syncthreads();

    u128 acc0[PER];
    u128 acc1[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) acc0[r] = acc1[r] = 0;
    t_c += b * D * n;
    if (t_n != nullptr) t_n += b * D * n;

    for (int j = 0; j < D; ++j) {
        seal_tpu_torch::cluster_wait();     // every block has read its chunk of row j - 1
        const uint64_t* k0 = key + (static_cast<size_t>(j) * Rn + i) * n + base;
        const uint64_t* k1 = key + (static_cast<size_t>(key_rows + j) * Rn + i) * n + base;
        const bool diagonal = t_n != nullptr && i == j0 + j;
        const uint64_t* row = diagonal ? t_n + j * n + base : data;
        if (!diagonal) {
            const uint64_t* src = t_c + j * n;
            const bool reduce = need_reduce[j * Rn + i] != 0;
            seal_tpu_torch::cross_forward_pass<LOG_C>(
                data, log_l,
                [&](int idx) {
                    const uint64_t x = src[idx];
                    return reduce ? barrett_reduce_64(x, q, r_hi) : x;
                },
                w_op, w_qt, q);
            cluster.sync();
            seal_tpu_torch::ct_stages(data, column_stride(log_l), 1, log_l, t_op, t_qt, q);
        }
#pragma unroll
        for (int r = 0; r < PER; ++r) {
            const int idx = threadIdx.x + r * blockDim.x;
            if (idx < L) {
                const uint64_t x = guard(guard(row[diagonal ? idx : pad8(idx)], two_q), q);
                acc0[r] += static_cast<u128>(x) * k0[idx];
                acc1[r] += static_cast<u128>(x) * k1[idx];
            }
        }
        if (GUARD && j % kAccWindow == kAccWindow - 1 && j != D - 1) {
#pragma unroll
            for (int r = 0; r < PER; ++r) {
                acc0[r] = barrett_reduce_128(acc0[r], q, r_lo, r_hi);
                acc1[r] = barrett_reduce_128(acc1[r], q, r_lo, r_hi);
            }
        }
        if (j + 1 < D) seal_tpu_torch::cluster_arrive();
    }
    uint64_t* o0 = out + (static_cast<size_t>(b) * 2 * Rn + i) * n + base;
    uint64_t* o1 = o0 + Rn * n;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
        const int idx = threadIdx.x + r * blockDim.x;
        if (idx < L) {
            o0[idx] = barrett_reduce_128(acc0[r], q, r_lo, r_hi);
            o1[idx] = barrett_reduce_128(acc1[r], q, r_lo, r_hi);
        }
    }
}

// Blocks per row: 8 from n = 64 up, fewer below, as kernel A's.
int log_cluster(int log_n) { return std::min(3, log_n / 2); }

template <int LOG_C, int PER, bool GUARD>
int launch(int (&allowed)[64], int B, int D, int Rn, int log_n, void* stream, const void* t_c, const void* t_n,
           const void* key, const void* need_reduce, const void* op, const void* qt, const void* q,
           const void* ratio_lo, const void* ratio_hi, void* out, int key_rows, int j0) {
    const int log_l = log_n - LOG_C;
    const int smem = static_cast<int>(sizeof(uint64_t)) * (2 * (1 << log_l) + 2 * (1 << LOG_C) + column_stride(log_l));
    auto kernel = switch_key_kernel<LOG_C, PER, GUARD>;
    cudaError_t err = seal_tpu_torch::allow_shared_memory(kernel, smem, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(Rn) * static_cast<unsigned>(B) << LOG_C);
    config.blockDim = dim3(std::max(32, (1 << log_l) / PER));
    config.dynamicSmemBytes = smem;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << LOG_C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, static_cast<const uint64_t*>(t_c), static_cast<const uint64_t*>(t_n),
                             static_cast<const uint64_t*>(key), static_cast<const uint8_t*>(need_reduce),
                             static_cast<const uint64_t*>(op), static_cast<const uint64_t*>(qt),
                             static_cast<const uint64_t*>(q), static_cast<const uint64_t*>(ratio_lo),
                             static_cast<const uint64_t*>(ratio_hi), static_cast<uint64_t*>(out), B, D, key_rows,
                             Rn, log_n, j0);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_c, t_n: (B, D, n), decomposition rows [j0, j0 + D); key: two components
// of D rows of (Rn, n) each, row j of component c at key + (c * key_rows + j)
// * Rn * n (key_rows >= D); need_reduce: (D, Rn) bytes of those rows; op, qt:
// (Rn, n); q, ratio_lo, ratio_hi: (Rn,); out: (B, 2, Rn, n).  t_n may be null
// (no diagonal substitution).  8 <= n <= 32768, 1 <= B <= 65535.  A thread
// owns 4 coefficients (8 u128 sums) up to n = 16384 (at most 512 threads a
// block) and 8 at n = 32768 (512 threads for a chunk of 4096: the 16 sums
// fill half of the 128 registers a thread may have).
extern "C" int seal_switch_key_contract(const void* t_c, const void* t_n, const void* key,
                                        const void* need_reduce, const void* op, const void* qt,
                                        const void* q, const void* ratio_lo, const void* ratio_hi,
                                        void* out, int B, int D, int key_rows, int Rn, int log_n,
                                        int j0, void* stream) {
    static int allowed[8][64] = {};
    const int slot = (log_cluster(log_n) - 1 + (log_n > 14)) * 2 + (D > kAccWindow);
#define SK_LAUNCH(LOG_C, PER, GUARD)                                                                              \
    launch<LOG_C, PER, GUARD>(allowed[slot], B, D, Rn, log_n, stream, t_c, t_n, key, need_reduce, op, qt, q,     \
                              ratio_lo, ratio_hi, out, key_rows, j0)
    switch (slot) {
        case 0: return SK_LAUNCH(1, 4, false);
        case 1: return SK_LAUNCH(1, 4, true);
        case 2: return SK_LAUNCH(2, 4, false);
        case 3: return SK_LAUNCH(2, 4, true);
        case 4: return SK_LAUNCH(3, 4, false);
        case 5: return SK_LAUNCH(3, 4, true);
        case 6: return SK_LAUNCH(3, 8, false);
        default: return SK_LAUNCH(3, 8, true);
    }
#undef SK_LAUNCH
}
