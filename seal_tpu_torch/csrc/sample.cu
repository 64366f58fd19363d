// Kernel D: the RLWE samplers over the BLAKE2xb stream words, two entry points.
//
// Replaces no Pallas kernel: it is the card's counterpart of the jnp code of
// seal_tpu/ops/blake2_dev.py that keygen and symmetric encryption run on the
// device there.  The plain versions are in seal_tpu_torch/ops/blake2_dev.py.
//
// (i) seal_sample_uniform_bulk, the bulk pass of sample_poly_uniform
//     (util/rlwe.cpp:104-135; blake2_dev.py:uniform_from_seed_words): word
//     j * n + c of stream s goes to (s, j, c) reduced mod q_j by Barrett
//     (floor(2^128 / q_j) >> 64 and one conditional subtraction, as
//     ops/u64.py:barrett_reduce_64), and the words >= max_multiple(q_j),
//     compared unsigned, are counted per (stream, limb).  Plain version:
//     uniform_bulk_plain.  A rejected word's reduced value is written too and
//     later overwritten: the host reads the counts back once, and only a limb
//     with a rejection runs the plain fix-up (the sequential redraws from the
//     stream's continuation, rare for moduli just below a power of two).
// (ii) seal_sample_cbd_lifted, sample_poly_cbd (util/rlwe.cpp:66-103) with
//     the lift to residues fused (blake2_dev.py:cbd_noise_from_words then
//     lift_signed): 6 bytes per coefficient from skip_bytes into stream s,
//     bytes 2 and 5 masked with 0x1F, v = popcount(first 3) - popcount(last
//     3), written to every limb i as v or q_i - |v|.  Plain version:
//     cbd_lifted_plain.
//
// What bounds them on an H100: bytes.  (i) reads and writes 8 bytes per
// coefficient and limb for about 14 32-bit operations (a compare, a 64-bit
// high and low product, two subtractions); (ii) reads 6 bytes per
// coefficient and writes 8 per coefficient and limb.
//
// What the design does about it: one thread per output coefficient, so
// consecutive threads read and write consecutive words; (i) counts with one
// warp ballot and at most one atomic per warp (none where nothing was
// rejected); (ii) computes the noise once and stores it to all k limbs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// grid (ceil(n / kThreads), k, S)
__global__ void __launch_bounds__(kThreads) uniform_bulk_kernel(const uint64_t* __restrict__ words, long long W,
                                                                const uint64_t* __restrict__ q,
                                                                const uint64_t* __restrict__ max_multiple,
                                                                const uint64_t* __restrict__ ratio_hi,
                                                                uint64_t* __restrict__ vals, int* __restrict__ counts,
                                                                int k, int n) {
    const int j = blockIdx.y;
    const long long s = blockIdx.z;
    const int c = blockIdx.x * kThreads + threadIdx.x;
    bool bad = false;
    if (c < n) {
        const uint64_t qj = q[j];
        const uint64_t w = words[s * W + static_cast<long long>(j) * n + c];
        bad = w >= max_multiple[j];
        uint64_t r = w - __umul64hi(w, ratio_hi[j]) * qj;
        if (r >= qj) r -= qj;
        vals[(s * k + j) * n + c] = r;
    }
    // every thread of the warp reaches the ballot (the grid's last block is cut at n)
    const unsigned rejected = __ballot_sync(0xFFFFFFFFu, bad);
    if ((threadIdx.x & 31) == 0 && rejected != 0) atomicAdd(&counts[s * k + j], __popc(rejected));
}

// grid (ceil(n / kThreads), S)
__global__ void __launch_bounds__(kThreads) cbd_lifted_kernel(const uint64_t* __restrict__ words, long long W,
                                                              long long skip_bytes, const uint64_t* __restrict__ q,
                                                              uint64_t* __restrict__ out, int k, int n) {
    const long long s = blockIdx.y;
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= n) return;
    const unsigned char* b = reinterpret_cast<const unsigned char*>(words + s * W) + skip_bytes + 6LL * c;
    const int pos = __popc(b[0]) + __popc(b[1]) + __popc(b[2] & 0x1F);
    const int neg = __popc(b[3]) + __popc(b[4]) + __popc(b[5] & 0x1F);
    const int v = pos - neg;
    uint64_t* o = out + s * k * n + c;
    for (int i = 0; i < k; ++i) {
        o[static_cast<long long>(i) * n] = v < 0 ? q[i] - static_cast<uint64_t>(-v) : static_cast<uint64_t>(v);
    }
}

}  // namespace

// (i) words: S streams of W u64; q, max_multiple, ratio_hi: k u64 each;
// vals: S x k x n u64; counts: S x k int32, zeroed by the caller.  Returns
// the CUDA error code, or -1 for a grid beyond the card's limits.
extern "C" int seal_sample_uniform_bulk(const void* words, long long W, const void* q, const void* max_multiple,
                                        const void* ratio_hi, void* vals, void* counts, int S, int k, int n,
                                        void* stream) {
    if (S <= 0 || k <= 0 || n <= 0) return 0;
    if (S > 65535 || k > 65535) return -1;
    const dim3 grid((n + kThreads - 1) / kThreads, k, S);
    uniform_bulk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(words), W, static_cast<const uint64_t*>(q),
        static_cast<const uint64_t*>(max_multiple), static_cast<const uint64_t*>(ratio_hi),
        static_cast<uint64_t*>(vals), static_cast<int*>(counts), k, n);
    return static_cast<int>(cudaGetLastError());
}

// (ii) words: S streams of W u64 holding at least skip_bytes + 6 n bytes; q:
// k u64; out: S x k x n u64.  Returns the CUDA error code, or -1 for a grid
// beyond the card's limits.
extern "C" int seal_sample_cbd_lifted(const void* words, long long W, long long skip_bytes, const void* q,
                                      void* out, int S, int k, int n, void* stream) {
    if (S <= 0 || k <= 0 || n <= 0) return 0;
    if (S > 65535) return -1;
    const dim3 grid((n + kThreads - 1) / kThreads, S);
    cbd_lifted_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(words), W, skip_bytes, static_cast<const uint64_t*>(q),
        static_cast<uint64_t*>(out), k, n);
    return static_cast<int>(cudaGetLastError());
}
