/* Single-modulus negacyclic NTT/iNTT on the host (Harvey lazy butterflies,
 * Shoup multiplication), for the BatchEncoder's mod-t transforms
 * (batchencoder.cpp:110-148): host data in and out, where a device launch
 * would be a round trip and nothing else.  A copy of the JAX package's
 * seal_tpu/native/ntt_mod.c, with the same butterflies as the port's plain
 * NTT (ops/ntt.py).
 *
 * Table layout as ntt_tables.host_c_ntt_tables gives it:
 *   forward stage s (m = 1<<s) uses w_op[m + i] for butterfly block i;
 *   inverse stage s (m = n>>(s+1)) uses w_op[offset + i], offset starting
 *   at 1 and advancing by m per stage; the final inverse stage fuses
 *   n^{-1} (invn) and the scaled last root (last).
 * All *_qt values are Shoup quotients floor(op << 64 / q).
 *
 * Built with cc at first use by host_c.py into seal_tpu_torch/build/.
 */

#include <stddef.h>
#include <stdint.h>

typedef unsigned __int128 u128;

static inline uint64_t mulhi64(uint64_t a, uint64_t b)
{
    return (uint64_t)(((u128)a * b) >> 64);
}

/* x * op mod q in [0, 2q) given the Shoup pair (op, qt); x arbitrary u64 */
static inline uint64_t shoup_lazy(uint64_t x, uint64_t op, uint64_t qt, uint64_t q)
{
    return x * op - mulhi64(x, qt) * q;
}

static inline uint64_t guard2q(uint64_t x, uint64_t two_q)
{
    return x >= two_q ? x - two_q : x;
}

/* In-place forward negacyclic NTT; input [0, 4q), output [0, q). */
void seal_ntt_mod_fwd(uint64_t *a, size_t n, uint64_t q,
                      const uint64_t *w_op, const uint64_t *w_qt)
{
    uint64_t two_q = q << 1;
    size_t m, gap, i, j;
    for (m = 1, gap = n >> 1; gap >= 1; m <<= 1, gap >>= 1) {
        for (i = 0; i < m; i++) {
            uint64_t op = w_op[m + i], qt = w_qt[m + i];
            uint64_t *x0 = a + 2 * i * gap;
            uint64_t *x1 = x0 + gap;
            for (j = 0; j < gap; j++) {
                uint64_t u = guard2q(x0[j], two_q);
                uint64_t v = shoup_lazy(x1[j], op, qt, q);
                x0[j] = u + v;            /* < 4q */
                x1[j] = u + two_q - v;    /* < 4q */
            }
        }
    }
    for (j = 0; j < n; j++) {
        uint64_t x = guard2q(a[j], two_q);
        a[j] = x >= q ? x - q : x;
    }
}

/* In-place inverse negacyclic NTT with 1/n fused; input [0, 2q), output
 * [0, q). */
void seal_ntt_mod_inv(uint64_t *a, size_t n, uint64_t q,
                      const uint64_t *w_op, const uint64_t *w_qt,
                      uint64_t invn_op, uint64_t invn_qt,
                      uint64_t last_op, uint64_t last_qt)
{
    uint64_t two_q = q << 1;
    size_t m, gap, i, j, offset = 1;
    for (m = n >> 1, gap = 1; m > 1; m >>= 1, gap <<= 1) {
        for (i = 0; i < m; i++) {
            uint64_t op = w_op[offset + i], qt = w_qt[offset + i];
            uint64_t *x0 = a + 2 * i * gap;
            uint64_t *x1 = x0 + gap;
            for (j = 0; j < gap; j++) {
                uint64_t u = x0[j], v = x1[j];
                x0[j] = guard2q(u + v, two_q);
                x1[j] = shoup_lazy(u + two_q - v, op, qt, q);
            }
        }
        offset += m;
    }
    /* last stage: fuse n^{-1} (x0 path) and last root * n^{-1} (x1 path) */
    {
        uint64_t *x0 = a;
        uint64_t *x1 = a + (n >> 1);
        for (j = 0; j < (n >> 1); j++) {
            uint64_t u = guard2q(x0[j], two_q);
            uint64_t v = x1[j];
            x0[j] = shoup_lazy(guard2q(u + v, two_q), invn_op, invn_qt, q);
            x1[j] = shoup_lazy(u + two_q - v, last_op, last_qt, q);
        }
    }
    for (j = 0; j < n; j++) {
        uint64_t x = a[j];
        a[j] = x >= q ? x - q : x;
    }
}
