/* Chained KV-block hashing in C: blake2b (RFC 7693) over
 * (parent_hash, salt, tokens) per block, digest truncated to 64 bits.
 *
 * Native counterpart of dynamo_tpu_torch/tokens.py compute_seq_hash_chain —
 * the hash chain is computed on the request hot path by the KV-aware
 * router, the sequence tracker, and the radix indexer (every scheduled
 * prompt, plus every completed block during generation), and the
 * reference keeps the equivalent in its Rust tokens crate
 * (lib/tokens/src/lib.rs:221). Digests are REQUIRED to be bit-identical
 * to Python's hashlib.blake2b(digest_size=8): same IV, same parameter
 * block (digest_length=8, fanout=1, depth=1), same little-endian
 * truncation (tests/test_torch_native_blockhash.py holds them to hashlib).
 *
 * Build: cc -O3 -shared -fPIC blockhash.c -o libblockhash.so
 * (dynamo_tpu_torch/native/__init__.py does this on first use, into
 * build/native/, and falls back to the pure-Python path without one.)
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
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

#define ROTR64(x, n) (((x) >> (n)) | ((x) << (64 - (n))))

#define G(v, a, b, c, d, x, y)              \
    do {                                    \
        v[a] = v[a] + v[b] + (x);           \
        v[d] = ROTR64(v[d] ^ v[a], 32);     \
        v[c] = v[c] + v[d];                 \
        v[b] = ROTR64(v[b] ^ v[c], 24);     \
        v[a] = v[a] + v[b] + (y);           \
        v[d] = ROTR64(v[d] ^ v[a], 16);     \
        v[c] = v[c] + v[d];                 \
        v[b] = ROTR64(v[b] ^ v[c], 63);     \
    } while (0)

static void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                     int last) {
    uint64_t v[16], m[16];
    int i;
    memcpy(m, block, 128); /* little-endian host assumed (x86/arm64) */
    for (i = 0; i < 8; i++) v[i] = h[i];
    for (i = 0; i < 8; i++) v[i + 8] = IV[i];
    v[12] ^= t;      /* t0: low counter word (messages here are < 2^64) */
    if (last) v[14] = ~v[14];
    for (i = 0; i < 12; i++) {
        const uint8_t *s = SIGMA[i];
        G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* blake2b with digest_size=8, no key; digest returned as the
 * little-endian u64 of the first 8 output bytes (what struct.unpack
 * "<Q" of hashlib's digest gives). */
static uint64_t blake2b8(const uint8_t *msg, size_t len) {
    uint64_t h[8];
    uint8_t block[128];
    size_t off = 0;
    memcpy(h, IV, sizeof(h));
    h[0] ^= 0x01010000ULL ^ 8ULL; /* digest_length=8, fanout=1, depth=1 */
    while (len - off > 128) {
        compress(h, msg + off, (uint64_t)(off + 128), 0);
        off += 128;
    }
    memset(block, 0, sizeof(block));
    memcpy(block, msg + off, len - off);
    compress(h, block, (uint64_t)len, 1);
    return h[0];
}

/* One block hash: H(parent_le_u64 || salt_le_u64 || tokens_le_u32[n]). */
uint64_t block_hash(uint64_t parent, uint64_t salt, const uint32_t *tokens,
                    size_t n_tokens) {
    uint8_t buf[16 + 4 * 1024];
    size_t len = 16 + 4 * n_tokens;
    if (n_tokens > 1024) return 0; /* caller guards; avoid overflow */
    memcpy(buf, &parent, 8);
    memcpy(buf + 8, &salt, 8);
    memcpy(buf + 16, tokens, 4 * n_tokens);
    return blake2b8(buf, len);
}

/* Full chain over complete blocks; returns the number of hashes written. */
size_t hash_chain(uint64_t salt, const uint32_t *tokens, size_t n_tokens,
                  size_t block_size, uint64_t *out) {
    size_t nb, i;
    uint64_t parent = 0;
    if (block_size == 0 || block_size > 1024) return 0;
    nb = n_tokens / block_size;
    for (i = 0; i < nb; i++) {
        parent = block_hash(parent, salt, tokens + i * block_size, block_size);
        out[i] = parent;
    }
    return nb;
}
