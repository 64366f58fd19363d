// Kernel C: the BLAKE2xb counter-mode stream of S seeds, as u64 words.
//
// Replaces no Pallas kernel: it is the card's counterpart of the jnp
// function seal_tpu/ops/blake2_dev.py:expand_stream_words, which the JAX
// package runs on the device for keygen and symmetric encryption.  The
// plain version is seal_tpu_torch/ops/blake2_dev.py:expand_stream_words_plain;
// the output is byte-identical to Blake2xbPRNG(seed).generate(8 * nwords)
// (seal_tpu_torch/random/prng.py, csrc/blake2.c).
//
// Per seed: one key-block compression (the seed as the key, t = 128); per
// 4 KiB buffer b, a root compression with m[0] = b (t = 136, final); per
// buffer, 64 output-node compressions of the root (t = 64, final), node j
// with node_offset = j in h[1].  Words are node-major, 8 a node, 512 a
// buffer, little-endian.
//
// What bounds it on an H100: operations.  A compression is 12 rounds of 8
// G steps, each 6 u64 adds, 4 xors and 4 rotations: about 2,500 32-bit
// operations (an add or xor is two, a rotation two funnel shifts, the
// rotation by 32 a register swap) for 64 bytes of output, against 64 bytes
// written: some 40 operations a byte, far above the card's ~20 operations
// per byte of HBM bandwidth at the 67 TOP/s rate the bound uses.
//
// What the design does about it: every compression runs in registers, the
// 12 rounds fully unrolled with the message schedule as literal indices (so
// m stays in registers and the zero half of a node's message folds away),
// and every thread does useful work.  Two kernels on the caller's stream:
// the root pass, one thread per (seed, buffer), computes the key block and
// the root (the key block again in every buffer's thread: 1/65 of the
// work) into a small scratch array; the node pass, one thread per (seed,
// buffer, node), reads its root and writes its 8 words.  A single kernel
// whose first warp computes the roots while the others wait would issue
// 2 compressions in one warp per 8 warps' worth of nodes (25% more issue
// slots); the split costs a second launch instead.  Stores are 8 bytes a
// thread at a 64-byte stride (L2 merges them); staging them through shared
// memory for 16-byte coalesced stores is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRootThreads = 128;
constexpr int kNodeThreads = 256;
constexpr long long kWordsPerBuffer = 512;
constexpr int kBufferBytes = 4096;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int c) { return (x >> c) | (x << (64 - c)); }

#define SEAL_B2_G(a, b, c, d, x, y)        \
    do {                                   \
        v[a] = v[a] + v[b] + (x);          \
        v[d] = rotr64(v[d] ^ v[a], 32);    \
        v[c] = v[c] + v[d];                \
        v[b] = rotr64(v[b] ^ v[c], 24);    \
        v[a] = v[a] + v[b] + (y);          \
        v[d] = rotr64(v[d] ^ v[a], 16);    \
        v[c] = v[c] + v[d];                \
        v[b] = rotr64(v[b] ^ v[c], 63);    \
    } while (0)

#define SEAL_B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    do {                                                                                    \
        SEAL_B2_G(0, 4, 8, 12, m[s0], m[s1]);                                               \
        SEAL_B2_G(1, 5, 9, 13, m[s2], m[s3]);                                               \
        SEAL_B2_G(2, 6, 10, 14, m[s4], m[s5]);                                              \
        SEAL_B2_G(3, 7, 11, 15, m[s6], m[s7]);                                              \
        SEAL_B2_G(0, 5, 10, 15, m[s8], m[s9]);                                              \
        SEAL_B2_G(1, 6, 11, 12, m[s10], m[s11]);                                            \
        SEAL_B2_G(2, 7, 8, 13, m[s12], m[s13]);                                             \
        SEAL_B2_G(3, 4, 9, 14, m[s14], m[s15]);                                             \
    } while (0)

// BLAKE2b's F(h, m, t = (t0, 0), last), in place on h (RFC 7693 §3.2;
// csrc/blake2.c:b2b_compress).
__device__ __forceinline__ void compress(uint64_t h[8], const uint64_t m[16], uint64_t t0, bool last) {
    const uint64_t iv[8] = {0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
                            0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
                            0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};
    uint64_t v[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        v[i] = h[i];
        v[i + 8] = iv[i];
    }
    v[12] ^= t0;
    if (last) v[14] = ~v[14];
    SEAL_B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    SEAL_B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
    SEAL_B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
    SEAL_B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
    SEAL_B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
    SEAL_B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
    SEAL_B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
    SEAL_B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
    SEAL_B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
    SEAL_B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
    SEAL_B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
    SEAL_B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

#undef SEAL_B2_ROUND
#undef SEAL_B2_G

// The parameter blocks' first words, XORed into the IV (csrc/blake2.c:176-207).
// Root: digest 64, key 64, fanout 1, depth 1; xof_length 4096 in word 1.
__device__ __forceinline__ void root_param_h0(uint64_t h[8]) {
    const uint64_t iv[8] = {0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
                            0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
                            0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = iv[i];
    h[0] ^= 64ULL | (64ULL << 8) | (1ULL << 16) | (1ULL << 24);
    h[1] ^= static_cast<uint64_t>(kBufferBytes) << 32;
}

// Output node j: digest 64, leaf 64, node_offset j, xof_length 4096, inner 64.
__device__ __forceinline__ void node_param_h0(uint64_t h[8], unsigned j) {
    const uint64_t iv[8] = {0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
                            0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
                            0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = iv[i];
    h[0] ^= 64ULL | (64ULL << 32);
    h[1] ^= (static_cast<uint64_t>(kBufferBytes) << 32) | j;
    h[2] ^= 64ULL << 8;
}

// One thread per (seed s, buffer b), pair p = s * nbuf + b: the key block of
// seed s, then the buffer's root, into roots[p * 8 ...].
__global__ void __launch_bounds__(kRootThreads) blake2xb_root_kernel(const uint64_t* __restrict__ seeds,
                                                                     uint64_t* __restrict__ roots, long long nbuf,
                                                                     long long pairs) {
    const long long p = static_cast<long long>(blockIdx.x) * kRootThreads + threadIdx.x;
    if (p >= pairs) return;
    const long long s = p / nbuf;
    const uint64_t b = static_cast<uint64_t>(p - s * nbuf);
    uint64_t h[8];
    root_param_h0(h);
    uint64_t m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        m[i] = seeds[s * 8 + i];
        m[i + 8] = 0;
    }
    compress(h, m, 128, false);  // the key block
    m[0] = b;
#pragma unroll
    for (int i = 1; i < 16; ++i) m[i] = 0;
    compress(h, m, 136, true);   // the root: the 8-byte counter, final
#pragma unroll
    for (int i = 0; i < 8; ++i) roots[p * 8 + i] = h[i];
}

// One thread per (pair p, node j): the node's 8 words into out[s, b * 512 +
// j * 8 ...], cut at nwords.
__global__ void __launch_bounds__(kNodeThreads) blake2xb_node_kernel(const uint64_t* __restrict__ roots,
                                                                     uint64_t* __restrict__ out, long long nbuf,
                                                                     long long nwords, long long nodes) {
    const long long g = static_cast<long long>(blockIdx.x) * kNodeThreads + threadIdx.x;
    if (g >= nodes) return;
    const long long p = g >> 6;
    const unsigned j = static_cast<unsigned>(g & 63);
    const long long s = p / nbuf;
    const long long first = (p - s * nbuf) * kWordsPerBuffer + j * 8;
    if (first >= nwords) return;
    uint64_t m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        m[i] = roots[p * 8 + i];
        m[i + 8] = 0;
    }
    uint64_t h[8];
    node_param_h0(h, j);
    compress(h, m, 64, true);
    uint64_t* row = out + s * nwords + first;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (first + i < nwords) row[i] = h[i];  // constant indices keep h in registers
    }
}

}  // namespace

// The stream of S seeds (seeds: S x 8 u64) into out (S x nwords u64), with
// roots (S x ceil(nwords / 512) x 8 u64) as scratch, on `stream`.  Returns
// the CUDA error code, or -1 for a grid beyond the card's limits.
extern "C" int seal_blake2xb_expand(const void* seeds, void* roots, void* out, int S, long long nwords,
                                    void* stream) {
    if (S <= 0 || nwords <= 0) return 0;
    const long long nbuf = (nwords + kWordsPerBuffer - 1) / kWordsPerBuffer;
    const long long pairs = static_cast<long long>(S) * nbuf;
    const long long nodes = pairs * 64;
    const long long root_blocks = (pairs + kRootThreads - 1) / kRootThreads;
    const long long node_blocks = (nodes + kNodeThreads - 1) / kNodeThreads;
    if (node_blocks >= (1LL << 31)) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    blake2xb_root_kernel<<<static_cast<unsigned>(root_blocks), kRootThreads, 0, st>>>(
        static_cast<const uint64_t*>(seeds), static_cast<uint64_t*>(roots), nbuf, pairs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    blake2xb_node_kernel<<<static_cast<unsigned>(node_blocks), kNodeThreads, 0, st>>>(
        static_cast<const uint64_t*>(roots), static_cast<uint64_t*>(out), nbuf, nwords, nodes);
    return static_cast<int>(cudaGetLastError());
}
