/* BLAKE2b and BLAKE2xb, implemented from RFC 7693 and the BLAKE2X spec
 * (https://www.blake2.net/blake2x.pdf): the port's copy of the JAX
 * package's host component (seal_tpu/native/blake2.c), which the port does
 * not import or build.  It serves the counter-mode XOF PRNG of
 * seal_tpu_torch/random/prng.py, byte-compatible with the reference's
 * vendored blake2xb.  (BLAKE2xb's output nodes have depth 0, which
 * hashlib.blake2b's parameters do not allow, so the XOF cannot be built
 * from hashlib.)
 *
 * Built at first use by seal_tpu_torch/random/prng.py:
 *   cc -O2 -shared -fPIC -o seal_tpu_torch/build/libblake2-<hash>.so blake2.c
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

typedef struct {
    uint64_t h[8];
    uint64_t t[2];
    uint8_t buf[128];
    size_t buflen;
} b2b_state;

/* Parameter block, fully general so BLAKE2X node parameters are expressible. */
typedef struct {
    uint8_t digest_length;
    uint8_t key_length;
    uint8_t fanout;
    uint8_t depth;
    uint32_t leaf_length;
    uint32_t node_offset;
    uint32_t xof_length;
    uint8_t node_depth;
    uint8_t inner_length;
} b2b_param;

static inline uint64_t rotr64(uint64_t x, unsigned c) { return (x >> c) | (x << (64 - c)); }

static inline uint64_t load64(const uint8_t *p)
{
    uint64_t v;
    memcpy(&v, p, 8); /* little-endian hosts only (x86-64/aarch64) */
    return v;
}

static void b2b_compress(b2b_state *S, const uint8_t block[128], int last)
{
    uint64_t m[16], v[16];
    int i, r;
    for (i = 0; i < 16; i++) m[i] = load64(block + 8 * i);
    for (i = 0; i < 8; i++) v[i] = S->h[i];
    for (i = 0; i < 8; i++) v[i + 8] = IV[i];
    v[12] ^= S->t[0];
    v[13] ^= S->t[1];
    if (last) v[14] = ~v[14];

#define G(a, b, c, d, x, y)                                                   \
    do {                                                                      \
        v[a] = v[a] + v[b] + (x);                                             \
        v[d] = rotr64(v[d] ^ v[a], 32);                                       \
        v[c] = v[c] + v[d];                                                   \
        v[b] = rotr64(v[b] ^ v[c], 24);                                       \
        v[a] = v[a] + v[b] + (y);                                             \
        v[d] = rotr64(v[d] ^ v[a], 16);                                       \
        v[c] = v[c] + v[d];                                                   \
        v[b] = rotr64(v[b] ^ v[c], 63);                                       \
    } while (0)

    for (r = 0; r < 12; r++) {
        const uint8_t *s = SIGMA[r];
        G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
#undef G
    for (i = 0; i < 8; i++) S->h[i] ^= v[i] ^ v[i + 8];
}

static void b2b_init_param(b2b_state *S, const b2b_param *P)
{
    uint8_t pb[64];
    int i;
    memset(pb, 0, sizeof(pb));
    pb[0] = P->digest_length;
    pb[1] = P->key_length;
    pb[2] = P->fanout;
    pb[3] = P->depth;
    memcpy(pb + 4, &P->leaf_length, 4);
    memcpy(pb + 8, &P->node_offset, 4);
    memcpy(pb + 12, &P->xof_length, 4);
    pb[16] = P->node_depth;
    pb[17] = P->inner_length;
    /* salt/personal zero */
    memset(S, 0, sizeof(*S));
    for (i = 0; i < 8; i++) S->h[i] = IV[i] ^ load64(pb + 8 * i);
}

static void b2b_update(b2b_state *S, const uint8_t *in, size_t inlen)
{
    while (inlen > 0) {
        if (S->buflen == 128) {
            S->t[0] += 128;
            if (S->t[0] < 128) S->t[1]++;
            b2b_compress(S, S->buf, 0);
            S->buflen = 0;
        }
        size_t take = 128 - S->buflen;
        if (take > inlen) take = inlen;
        memcpy(S->buf + S->buflen, in, take);
        S->buflen += take;
        in += take;
        inlen -= take;
    }
}

static void b2b_final(b2b_state *S, uint8_t *out, size_t outlen)
{
    uint8_t buffer[64];
    size_t i;
    S->t[0] += S->buflen;
    if (S->t[0] < S->buflen) S->t[1]++;
    memset(S->buf + S->buflen, 0, 128 - S->buflen);
    b2b_compress(S, S->buf, 1);
    for (i = 0; i < 8; i++) memcpy(buffer + 8 * i, &S->h[i], 8);
    memcpy(out, buffer, outlen);
}

static void b2b_keyed_start(b2b_state *S, const b2b_param *P, const uint8_t *key, size_t keylen)
{
    b2b_init_param(S, P);
    if (keylen > 0) {
        uint8_t block[128];
        memset(block, 0, sizeof(block));
        memcpy(block, key, keylen);
        b2b_update(S, block, 128);
    }
}

void seal_blake2b(uint8_t *out, size_t outlen, const uint8_t *in, size_t inlen,
                  const uint8_t *key, size_t keylen)
{
    b2b_param P = {0};
    b2b_state S;
    P.digest_length = (uint8_t)outlen;
    P.key_length = (uint8_t)keylen;
    P.fanout = 1;
    P.depth = 1;
    b2b_keyed_start(&S, &P, key, keylen);
    b2b_update(&S, in, inlen);
    b2b_final(&S, out, outlen);
}

void seal_blake2xb(uint8_t *out, size_t outlen, const uint8_t *in, size_t inlen,
                   const uint8_t *key, size_t keylen)
{
    b2b_param P = {0};
    b2b_state S;
    uint8_t root[64];
    uint32_t i = 0;

    /* Root hash: regular (keyed) blake2b-512 with xof_length set. */
    P.digest_length = 64;
    P.key_length = (uint8_t)keylen;
    P.fanout = 1;
    P.depth = 1;
    P.xof_length = (uint32_t)outlen;
    b2b_keyed_start(&S, &P, key, keylen);
    b2b_update(&S, in, inlen);
    b2b_final(&S, root, 64);

    /* Output expansion nodes. */
    P.key_length = 0;
    P.fanout = 0;
    P.depth = 0;
    P.leaf_length = 64;
    P.inner_length = 64;
    P.node_depth = 0;
    while (outlen > 0) {
        size_t block = outlen < 64 ? outlen : 64;
        P.digest_length = (uint8_t)block;
        P.node_offset = i++;
        b2b_init_param(&S, &P);
        b2b_update(&S, root, 64);
        b2b_final(&S, out, block);
        out += block;
        outlen -= block;
    }
}

/* Counter-mode PRNG fill: out[0:4096] = blake2xb(counter), counter++, ...
 * exactly the reference's Blake2xbPRNG::refill_buffer loop. */
void seal_blake2xb_fill(uint8_t *out, size_t outlen, uint64_t counter, const uint8_t *seed64)
{
    while (outlen > 0) {
        size_t block = outlen < 4096 ? outlen : 4096;
        uint8_t buf[4096];
        seal_blake2xb(buf, 4096, (const uint8_t *)&counter, 8, seed64, 64);
        memcpy(out, buf, block);
        counter++;
        out += block;
        outlen -= block;
    }
}
