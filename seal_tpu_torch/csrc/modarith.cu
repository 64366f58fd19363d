// Kernel E: the modular functions of ops/u64.py, one launch per call.
//
// Replaces no Pallas kernel: on the TPU, XLA fused this elementwise
// arithmetic (seal_tpu/ops/u64.py under jit).  Eager PyTorch cannot fuse it,
// and the plain versions in seal_tpu_torch/ops/u64.py build each 64x64 ->
// 128-bit product from 32x16-bit partial products, some hundred to six
// hundred launches a call, each reading and writing a call-sized tensor.
// Here the same functions run with native uint64_t, __umul64hi and
// unsigned __int128, one launch each:
//
//   add_mod(x, y, q)                      sub_mod(x, y, q)
//   neg_mod(x, q)                         barrett_reduce_64(x, q, ratio_hi)
//   barrett_reduce_128(lo, hi, q, ratio_lo, ratio_hi)
//   mul_mod(x, y, q, ratio_lo, ratio_hi)
//   mul_mod_shoup(x, y, y_quot, q)        mul_mod_shoup_lazy(x, y, y_quot, q)
//
// Every result equals the plain version's bit for bit on any int64 input,
// not only on reduced ones: the port feeds lazy sums (x + c - y) and
// full-width Shoup multiplicands.  So each function keeps the plain
// version's own comparison (signed in add_mod and sub_mod, unsigned in the
// Barrett and Shoup guards) and its wraparound (sums taken in uint64_t).
//
// What bounds it on an H100: bytes.  A handful of 64-bit multiplies per 16
// to 32 bytes moved; each operand is read once and the output written once.
//
// What the design does about it: the wrapper (ops/cuda_modarith.py) hands
// each operand over as a pointer and its element strides over the broadcast
// shape, collapsed to at most kMaxDims axes, stride 0 on a broadcast axis;
// the last axis is a row, contiguous (stride 1) or broadcast (stride 0) in
// every operand.  A thread takes two neighbouring elements of a row: a
// 16-byte load per full operand where every such operand is 16-byte aligned
// (VEC), and one load of a per-row constant (a per-limb modulus or ratio)
// for both.  The grid's x walks a row, its y the rows, so a (8, 2, 15,
// 32768) call with (15, 1) constants runs 64 x 240 blocks of 256 threads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef unsigned __int128 u128;

constexpr int kMaxOperands = 5;
constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

enum Op : int {
    kAddMod = 0,
    kSubMod = 1,
    kNegMod = 2,
    kBarrett64 = 3,
    kBarrett128 = 4,
    kMulMod = 5,
    kMulModShoup = 6,
    kMulModShoupLazy = 7,
};

// Operands of each op, in the order of the wrapper's arguments.
__host__ __device__ constexpr int operands(int op) {
    return op == kNegMod ? 2 : op <= kBarrett64 ? 3 : op <= kMulMod ? 5 : 4;
}

// The collapsed layout, right-aligned: axis kMaxDims - 1 is the row; outer
// axes the layout does not use have size 1.
struct Layout {
    const uint64_t* ptr[kMaxOperands];
    long long stride[kMaxOperands][kMaxDims];
    long long shape[kMaxDims];
};

__device__ __forceinline__ uint64_t guard(uint64_t x, uint64_t q) {
    return x >= q ? x - q : x;
}

// The reference's barrett_reduce_128 (uintarithsmallmod.h:167-205), as
// ops/u64.py:barrett_reduce_128 takes it step for step.
__device__ __forceinline__ uint64_t barrett_128(uint64_t z0, uint64_t z1, uint64_t q, uint64_t ratio_lo,
                                                uint64_t ratio_hi) {
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

template <int OP>
__device__ __forceinline__ uint64_t apply(const uint64_t* v) {
    if constexpr (OP == kAddMod) {
        const uint64_t s = v[0] + v[1];
        return static_cast<long long>(s) >= static_cast<long long>(v[2]) ? s - v[2] : s;
    } else if constexpr (OP == kSubMod) {
        const uint64_t d = v[0] - v[1];
        return static_cast<long long>(d) < 0 ? d + v[2] : d;
    } else if constexpr (OP == kNegMod) {
        return v[0] != 0 ? v[1] - v[0] : v[0];
    } else if constexpr (OP == kBarrett64) {
        return guard(v[0] - __umul64hi(v[0], v[2]) * v[1], v[1]);
    } else if constexpr (OP == kBarrett128) {
        return barrett_128(v[0], v[1], v[2], v[3], v[4]);
    } else if constexpr (OP == kMulMod) {
        const u128 z = static_cast<u128>(v[0]) * v[1];
        return barrett_128(static_cast<uint64_t>(z), static_cast<uint64_t>(z >> 64), v[2], v[3], v[4]);
    } else {
        const uint64_t r = v[1] * v[0] - __umul64hi(v[0], v[2]) * v[3];
        return OP == kMulModShoup ? guard(r, v[3]) : r;
    }
}

// grid (ceil(L / (2 kThreads)), min(rows, kMaxGridY)); rows beyond the
// grid's y are taken in steps of gridDim.y.
template <int OP, bool VEC>
__global__ void __launch_bounds__(kThreads) modarith_kernel(const Layout a, uint64_t* __restrict__ out,
                                                            unsigned rows) {
    constexpr int N = operands(OP);
    constexpr int R = kMaxDims - 1;
    const long long L = a.shape[R];
    const long long c = 2 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
    if (c >= L) return;
    const bool second = c + 1 < L;
    for (unsigned r = blockIdx.y; r < rows; r += gridDim.y) {
        long long off[N];
#pragma unroll
        for (int k = 0; k < N; ++k) off[k] = c * a.stride[k][R];
        // the row's index on each outer axis (32-bit: the wrapper keeps rows below 2^31)
        unsigned rest = r;
#pragma unroll
        for (int d = R - 1; d >= 0; --d) {
            const unsigned size = static_cast<unsigned>(a.shape[d]);
            if (size == 1) continue;
            const unsigned i = rest % size;
            rest /= size;
#pragma unroll
            for (int k = 0; k < N; ++k) off[k] += static_cast<long long>(i) * a.stride[k][d];
        }
        uint64_t v0[N], v1[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const uint64_t* p = a.ptr[k] + off[k];
            if (a.stride[k][R] == 0) {
                v0[k] = v1[k] = __ldg(p);
            } else if (VEC) {
                const ulonglong2 w = __ldg(reinterpret_cast<const ulonglong2*>(p));
                v0[k] = w.x;
                v1[k] = w.y;
            } else {
                v0[k] = __ldg(p);
                v1[k] = second ? __ldg(p + 1) : 0;
            }
        }
        uint64_t* o = out + static_cast<long long>(r) * L + c;
        if (VEC) {
            *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(apply<OP>(v0), apply<OP>(v1));
        } else {
            o[0] = apply<OP>(v0);
            if (second) o[1] = apply<OP>(v1);
        }
    }
}

template <int OP>
int launch(const Layout& a, uint64_t* out, unsigned rows, bool vec, cudaStream_t stream) {
    const long long L = a.shape[kMaxDims - 1];
    const dim3 grid(static_cast<unsigned>((L + 2 * kThreads - 1) / (2 * kThreads)),
                    rows < kMaxGridY ? rows : kMaxGridY);
    if (vec) {
        modarith_kernel<OP, true><<<grid, kThreads, 0, stream>>>(a, out, rows);
    } else {
        modarith_kernel<OP, false><<<grid, kThreads, 0, stream>>>(a, out, rows);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: an Op; layout: ndim, the ndim axis sizes (the row last), then for
// each of the op's operands its pointer and its ndim element strides (0 on
// a broadcast axis, 0 or 1 on the row); out: the contiguous (int64) result
// of that shape.  Returns the CUDA error code, or -1 for a layout the
// kernel does not take.
extern "C" int seal_modarith(int op, const long long* layout, void* out, void* stream) {
    if (op < 0 || op > kMulModShoupLazy) return -1;
    const int nops = operands(op);
    const int ndim = static_cast<int>(layout[0]);
    if (ndim < 1 || ndim > kMaxDims) return -1;
    Layout a{};
    const int pad = kMaxDims - ndim;
    long long rows = 1;
    for (int d = 0; d < kMaxDims; ++d) {
        a.shape[d] = d < pad ? 1 : layout[1 + d - pad];
        if (a.shape[d] < 1) return -1;
        if (d < kMaxDims - 1) rows *= a.shape[d];
    }
    const long long L = a.shape[kMaxDims - 1];
    if (rows > 0x7FFFFFFFLL || (L + 2 * kThreads - 1) / (2 * kThreads) > 0x7FFFFFFFLL) return -1;
    // VEC: two elements a load and a store, where every row starts 16-byte aligned
    bool vec = L % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int k = 0; k < nops; ++k) {
        const long long* e = layout + 1 + ndim + k * (1 + ndim);
        a.ptr[k] = reinterpret_cast<const uint64_t*>(static_cast<uintptr_t>(e[0]));
        for (int d = 0; d < kMaxDims; ++d) a.stride[k][d] = d < pad ? 0 : e[1 + d - pad];
        const long long inner = a.stride[k][kMaxDims - 1];
        if (inner != 0 && inner != 1) return -1;
        if (inner == 1) {
            vec = vec && reinterpret_cast<uintptr_t>(a.ptr[k]) % 16 == 0;
            for (int d = 0; d < kMaxDims - 1; ++d) vec = vec && a.stride[k][d] % 2 == 0;
        }
    }
    uint64_t* o = static_cast<uint64_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned r = static_cast<unsigned>(rows);
    switch (op) {
        case kAddMod: return launch<kAddMod>(a, o, r, vec, s);
        case kSubMod: return launch<kSubMod>(a, o, r, vec, s);
        case kNegMod: return launch<kNegMod>(a, o, r, vec, s);
        case kBarrett64: return launch<kBarrett64>(a, o, r, vec, s);
        case kBarrett128: return launch<kBarrett128>(a, o, r, vec, s);
        case kMulMod: return launch<kMulMod>(a, o, r, vec, s);
        case kMulModShoup: return launch<kMulModShoup>(a, o, r, vec, s);
        default: return launch<kMulModShoupLazy>(a, o, r, vec, s);
    }
}
