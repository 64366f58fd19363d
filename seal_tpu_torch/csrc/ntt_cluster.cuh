// The forward NTT of a row spread over a thread block cluster: the pieces
// that kernel A (ntt.cu) and kernel B (switch_key.cu) share.
//
// A row of n = C * L elements lives in the shared memory of a cluster of
// C = 2^LOG_C blocks, block c holding the contiguous chunk [c L, (c+1) L)
// at data[pad8(i)].  The first LOG_C stages pair elements of different
// chunks: cross_forward_pass runs them as one column pass, each thread
// loading the C elements of one offset, doing the butterflies in registers
// and writing each result into the shared memory of the block that owns it,
// through distributed shared memory.  A cluster barrier must follow before
// the owners read their chunks; the remaining log2(L) stages are then local
// (ntt_passes.cuh:ct_stages over the roots that stage_local_forward_roots
// staged in shared memory).
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "ntt_passes.cuh"

namespace seal_tpu_torch {

// The cross-chunk offsets [lo, hi) that block c of a cluster of 2^log_c runs.
__device__ __forceinline__ void share_of(int c, int L, int log_c, int* lo, int* hi) {
    const int share = (L + (1 << log_c) - 1) >> log_c;
    *lo = c * share;
    *hi = min(L, *lo + share);
}

// Block c's roots for its local forward stages, from the limb's (n,) forward
// table row (rop, rqt): local stage s of chunk c is global stage s + LOG_C;
// its blocks c 2^s .. (c+1) 2^s - 1 read global slots (C + c) 2^s + j, kept
// at t_op[2^s + j].  Slot 0 is not written.
__device__ inline void stage_local_forward_roots(uint64_t* t_op, uint64_t* t_qt, const uint64_t* rop,
                                                 const uint64_t* rqt, int c, int log_c, int L) {
    for (int ls = 1 + threadIdx.x; ls < L; ls += blockDim.x) {
        const int s = 31 - __clz(ls);
        const int g = (((1 << log_c) + c) << s) + (ls - (1 << s));
        t_op[ls] = rop[g];
        t_qt[ls] = rqt[g];
    }
}

// The first LOG_C forward stages of the cluster's row, [0, 4q) -> [0, 4q).
// load(idx) gives row element idx (< n) in [0, 4q); w_op, w_qt hold the
// cross stages' roots at slots 1 .. C-1 (the table's slots); the results go
// to `data` in the shared memory of their owners.  Called by every thread
// of every block of the cluster, after a cluster barrier that follows the
// owners' last read of `data`.
template <int LOG_C, typename Load>
__device__ __forceinline__ void cross_forward_pass(uint64_t* data, int log_l, Load load, const uint64_t* w_op,
                                                   const uint64_t* w_qt, uint64_t q) {
    constexpr int C = 1 << LOG_C;
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    const uint64_t two_q = q << 1;
    uint64_t* chunk[C];
#pragma unroll
    for (int e = 0; e < C; ++e) chunk[e] = cluster.map_shared_rank(data, e);
    int lo, hi;
    share_of(static_cast<int>(cluster.block_rank()), 1 << log_l, LOG_C, &lo, &hi);
    for (int o = lo + threadIdx.x; o < hi; o += blockDim.x) {
        uint64_t v[C];
#pragma unroll
        for (int e = 0; e < C; ++e) v[e] = load((e << log_l) + o);
#pragma unroll
        for (int s = 0; s < LOG_C; ++s) {
            const int half = 1 << (LOG_C - 1 - s);
#pragma unroll
            for (int e = 0; e < C; ++e) {
                if (e & half) continue;
                const int slot = (1 << s) + (e >> (LOG_C - s));
                const uint64_t u = guard(v[e], two_q);
                const uint64_t t = shoup_lazy(v[e | half], w_op[slot], w_qt[slot], q);
                v[e] = u + t;
                v[e | half] = u + two_q - t;
            }
        }
#pragma unroll
        for (int e = 0; e < C; ++e) chunk[e][pad8(o)] = v[e];
    }
}

// Split cluster barrier: arrive (release) early, wait (acquire) late, so a
// block's work between the two overlaps the others' arrival.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

}  // namespace seal_tpu_torch
