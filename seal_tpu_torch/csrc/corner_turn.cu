// The corner turn of the distributed four-step NTT: every rank sends block j
// of its data to rank j.
//
// Replaces seal_tpu/parallel/remote_ntt.py:_a2a_kernel (launched by
// remote_corner_turn), the TPU prototype that starts one remote DMA per
// peer.  Same contract: source rank m holds (k, P, r, c) and block j,
// src[:, j], lands in rank j's (k, r, P, c) output at [:, :, m].  The plain
// version is the same permutation in PyTorch
// (seal_tpu_torch/parallel/remote_ntt.py:corner_turn_plain).
//
// On a TPU each chip pushes its blocks over ICI with asynchronous copies and
// semaphores.  Here a thread block of the source's card stores straight
// through the destination's device pointer: local memory when the ranks
// share a card, a peer card's memory over NVLink when they do not (the
// wrapper enables peer access first and orders the cards' streams with
// events).  One launch covers every source rank that lives on one card, with
// grid axis y over them.
//
// What bounds it on an H100: it moves each element once, so it is bytes:
// k*P*r*c*8 bytes read and as many written per source rank, over 3.35 TB/s
// within a card (or NVLink's 450 GB/s each way across cards).  It does no
// arithmetic.
//
// What the design does about it: a grid-stride loop over the source's rows
// of c contiguous elements, consecutive threads on consecutive 16-byte
// pairs of a row, so loads and stores coalesce along c; rows whose width or
// addresses do not allow 16-byte access take the 8-byte loop.  Indices are
// 32-bit: with 64-bit ones the divisions that split a flat index into (k, j,
// r, c) cost more than the copy.  Strides are
// parameters, so the inverse transform's transposed views need no copy.  The
// source and destination pointers travel in the launch's parameter block
// (the card's constant memory): a launch needs no host-to-device copy.
// TMA bulk copies, and overlapping the copy with stage B's epilogue, are
// later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

struct CornerTurnArgs {
    const uint64_t* src[kMaxRanks];  // source s of this launch
    int src_rank[kMaxRanks];         // its rank m
    uint64_t* dst[kMaxRanks];        // destination rank j's (k, r, P, c) view
};

// grid: (blocks, sources of this launch).  Strides in elements; c is
// contiguous in source and destination.  kVec: two elements per access.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) corner_turn_kernel(
    const __grid_constant__ CornerTurnArgs args, int k, int P, int r, int c, long long s_k, long long s_j,
    long long s_r, long long d_k, long long d_r, long long d_m) {
    const uint64_t* src = args.src[blockIdx.y];
    const unsigned m = args.src_rank[blockIdx.y];
    // 32-bit index arithmetic: a 64-bit division is a long emulated sequence
    // (the wrapper keeps k * P * r * c below 2^31).
    const unsigned width = kVec ? c / 2 : c;
    const unsigned total = static_cast<unsigned>(k) * P * r * width;
    for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
        const unsigned col = e % width;
        unsigned row = e / width;
        const unsigned rr = row % r;
        row /= r;
        const unsigned j = row % P;
        const unsigned kk = row / P;
        const uint64_t* from = src + kk * s_k + j * s_j + rr * s_r;
        uint64_t* to = args.dst[j] + kk * d_k + rr * d_r + m * d_m;
        if (kVec) {
            reinterpret_cast<ulonglong2*>(to)[col] = reinterpret_cast<const ulonglong2*>(from)[col];
        } else {
            to[col] = from[col];
        }
    }
}

}  // namespace

// One launch on `stream` (of the sources' card): sources src[s] of ranks
// src_rank[s], s < n_src, each a (k, P, r, c) view with strides (s_k, s_j,
// s_r, 1); destinations dst[j], j < P, each a (k, r, P, c) view with strides
// (d_k, d_r, d_m, 1).  vec != 0 asks for 16-byte accesses (the wrapper checks
// that c, the strides and the pointers allow them).  Returns the CUDA error
// code, or -1 for more ranks than the parameter block holds or 2^31
// elements or more per source.
extern "C" int seal_corner_turn(const void* const* src, const int* src_rank, int n_src,
                                void* const* dst, int k, int P, int r, int c, long long s_k,
                                long long s_j, long long s_r, long long d_k, long long d_r,
                                long long d_m, int vec, void* stream) {
    if (P > kMaxRanks || n_src > kMaxRanks || n_src < 1) return -1;
    CornerTurnArgs args;
    for (int s = 0; s < n_src; ++s) {
        args.src[s] = static_cast<const uint64_t*>(src[s]);
        args.src_rank[s] = src_rank[s];
    }
    for (int j = 0; j < P; ++j) args.dst[j] = static_cast<uint64_t*>(dst[j]);
    const long long total = static_cast<long long>(k) * P * r * (vec ? c / 2 : c);
    if (static_cast<long long>(k) * P * r * c >= (1LL << 31)) return -1;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) return 0;
    const dim3 grid(static_cast<unsigned>(blocks), n_src);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec)
        corner_turn_kernel<true><<<grid, kThreads, 0, s>>>(args, k, P, r, c, s_k, s_j, s_r, d_k, d_r, d_m);
    else
        corner_turn_kernel<false><<<grid, kThreads, 0, s>>>(args, k, P, r, c, s_k, s_j, s_r, d_k, d_r, d_m);
    return static_cast<int>(cudaGetLastError());
}

// Let `device` read and write `peer`'s memory.  Returns 0 when it can (also
// when it already could), -2 when the pair has no peer path, else the CUDA
// error code.  Restores the calling thread's current device.
extern "C" int seal_enable_peer_access(int device, int peer) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!can) return -2;
    int prev = 0;
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear the error this call recorded
        err = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(prev);
    return static_cast<int>(err != cudaSuccess ? err : back);
}
