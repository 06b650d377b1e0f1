/* Native host-side limb codec for pairing_tpu.
 *
 * The TPU framework's host boundary moves batches of BN254 field elements
 * as 21x13-bit int32 limb vectors (the device representation).  The
 * reference framework's host runtime is native Rust (arkworks bigints,
 * plonky2 witness IO); this module is the TPU framework's native-runtime
 * equivalent for the hot host paths:
 *
 *   - packing canonical limb vectors into 32-byte little-endian integers
 *     (witness serialization, oracle cross-checks, streamed exports);
 *   - unpacking 32-byte integers into limb vectors (input loading);
 *   - full canonicalization (Montgomery exit + mod-p reduction) of
 *     settled device limbs on the host, via base-2^13 REDC -- so
 *     Montgomery-domain rows (witness traces) can be checked without a
 *     device round-trip or per-element Python bigint math.
 *
 * Pure C99 + 64-bit integer arithmetic; built once per machine by
 * pairing_tpu.native (gcc/g++ -O3 -shared) and loaded through ctypes.
 * Constants (p, N' mod 2^13) are injected by the Python side from
 * fields.fp so there is exactly one source of truth.
 */

#include <stdint.h>
#include <string.h>

#define NLIMBS 21
#define RADIX_BITS 13
#define MASK 0x1fffu
#define WIDE (2 * NLIMBS + 2)

static uint64_t P_D[NLIMBS];   /* p as 13-bit digits */
static uint64_t NP0;           /* -p^-1 mod 2^13 */

/* in: p digits (21 x int32), np0 = N' mod 2^13 */
void lc_init(const int32_t *p_digits, int32_t np0) {
    for (int i = 0; i < NLIMBS; i++) P_D[i] = (uint64_t)p_digits[i];
    NP0 = (uint64_t)np0 & MASK;
}

/* REDC base 2^13: t (WIDE 64-bit positions, value < R*p with
 * R = 2^(13*21)) -> out digits of t*R^-1 mod p, canonical (< p). */
static void lc_redc(uint64_t *t, uint32_t *out) {
    for (int i = 0; i < NLIMBS; i++) {
        uint64_t m = (t[i] * NP0) & MASK;
        for (int j = 0; j < NLIMBS; j++) t[i + j] += m * P_D[j];
        t[i + 1] += t[i] >> RADIX_BITS;  /* low digit now == 0 mod 2^13 */
        t[i] = 0;
    }
    uint64_t d[NLIMBS + 2];
    uint64_t carry = 0;
    for (int k = 0; k < NLIMBS + 2; k++) {
        uint64_t v = (NLIMBS + k < WIDE ? t[NLIMBS + k] : 0) + carry;
        d[k] = v & MASK;
        carry = v >> RADIX_BITS;
    }
    /* Complete reduction: conditional subtract p until < p.  Inputs up
     * to 32*R*p (covers lc_canon_one's from_mont=0 path on settled limbs
     * as large as ~2^18: value < 32*R, times R1 < p) leave the REDC
     * quotient below 33p, so 40 rounds is a strict upper bound; the loop
     * breaks as soon as d < p. */
    for (int rep = 0; rep < 40; rep++) {
        int ge = 0; /* d >= p ? */
        if (d[NLIMBS] | d[NLIMBS + 1]) {
            ge = 1;
        } else {
            for (int k = NLIMBS - 1; k >= 0; k--) {
                if (d[k] != P_D[k]) { ge = d[k] > P_D[k]; break; }
                if (k == 0) ge = 1; /* equal == p -> subtract */
            }
        }
        if (!ge) break;
        int64_t borrow = 0;
        for (int k = 0; k < NLIMBS; k++) {
            int64_t v = (int64_t)d[k] - (int64_t)P_D[k] - borrow;
            borrow = v < 0;
            d[k] = (uint64_t)(v + (borrow ? (1 << RADIX_BITS) : 0)) & MASK;
        }
        /* fold the borrow out of the top: d[21..] absorb it */
        if (borrow) {
            for (int k = NLIMBS; k < NLIMBS + 2; k++) {
                if (d[k]) { d[k] -= 1; break; }
                d[k] = MASK;
            }
        }
    }
    for (int k = 0; k < NLIMBS; k++) out[k] = (uint32_t)d[k];
}

/* plain mod-p of a small multiple: value < 64p fits the same REDC trick
 * by multiplying with R mod p?  Simpler: repeated conditional subtract of
 * shifted p is overkill -- for canonicalizing NON-Montgomery settled
 * limbs we Montgomery-multiply by R^2 * R^-1 = R ... which needs R2
 * digits.  Injected at init time instead: */
static uint64_t R2_D[NLIMBS]; /* R^2 mod p digits (for mont entry) */
static uint64_t R1_D[NLIMBS]; /* R mod p digits (for plain mod-p) */

void lc_init_consts(const int32_t *r2_digits, const int32_t *r1_digits) {
    for (int i = 0; i < NLIMBS; i++) {
        R2_D[i] = (uint64_t)r2_digits[i];
        R1_D[i] = (uint64_t)r1_digits[i];
    }
}

/* t <- a * b (schoolbook, digits fit 64-bit trivially) */
static void lc_mul_wide(const uint64_t *a, const uint64_t *b, uint64_t *t) {
    memset(t, 0, WIDE * sizeof(uint64_t));
    for (int i = 0; i < NLIMBS; i++)
        for (int j = 0; j < NLIMBS; j++)
            t[i + j] += a[i] * b[j];
}

/* Canonicalize one settled limb vector (int32 digits, each <= ~2^18,
 * i.e. value < 32*R — the lc_redc reduction loop's proven budget).
 * from_mont: input is x*R mod p (device Montgomery domain) -> output x.
 * else:      input is a redundant plain value                -> x mod p.
 */
static void lc_canon_one(const int32_t *in, int from_mont, uint32_t *out) {
    uint64_t t[WIDE];
    if (from_mont) {
        memset(t, 0, sizeof(t));
        for (int i = 0; i < NLIMBS; i++) t[i] = (uint64_t)(uint32_t)in[i];
        lc_redc(t, out); /* x*R * R^-1 = x mod p */
    } else {
        /* (x * (R mod p)) * R^-1 = x mod p */
        uint64_t a[NLIMBS];
        for (int i = 0; i < NLIMBS; i++) a[i] = (uint64_t)(uint32_t)in[i];
        lc_mul_wide(a, R1_D, t);
        lc_redc(t, out);
    }
}

/* Batch canonicalize: limbs [n, NLIMBS] int32 -> out [n, NLIMBS] int32. */
void lc_canon(const int32_t *limbs, int64_t n, int from_mont, int32_t *out) {
    for (int64_t e = 0; e < n; e++) {
        uint32_t o[NLIMBS];
        lc_canon_one(limbs + e * NLIMBS, from_mont, o);
        for (int k = 0; k < NLIMBS; k++) out[e * NLIMBS + k] = (int32_t)o[k];
    }
}

/* Pack canonical digits into 32-byte little-endian integers. */
void lc_pack(const int32_t *limbs, int64_t n, uint8_t *out) {
    for (int64_t e = 0; e < n; e++) {
        const int32_t *d = limbs + e * NLIMBS;
        uint8_t *o = out + e * 32;
        memset(o, 0, 32);
        for (int k = 0; k < NLIMBS; k++) {
            uint64_t v = (uint64_t)(uint32_t)d[k];
            int bit = k * RADIX_BITS;
            int byte = bit >> 3, off = bit & 7;
            /* 13 bits + up to 7 bit offset = 20 bits -> 3 bytes */
            uint32_t chunk = (uint32_t)(v << off);
            for (int b = 0; b < 3 && byte + b < 32; b++)
                o[byte + b] |= (uint8_t)(chunk >> (8 * b));
        }
    }
}

/* Unpack 32-byte little-endian integers (< 2^254) into 13-bit digits. */
void lc_unpack(const uint8_t *in, int64_t n, int32_t *out) {
    for (int64_t e = 0; e < n; e++) {
        const uint8_t *s = in + e * 32;
        int32_t *d = out + e * NLIMBS;
        for (int k = 0; k < NLIMBS; k++) {
            int bit = k * RADIX_BITS;
            int byte = bit >> 3, off = bit & 7;
            uint32_t v = 0;
            for (int b = 0; b < 3; b++)
                if (byte + b < 32) v |= (uint32_t)s[byte + b] << (8 * b);
            d[k] = (int32_t)((v >> off) & MASK);
        }
    }
}

/* Canonicalize + pack in one pass (the streamed-export hot path). */
void lc_canon_pack(const int32_t *limbs, int64_t n, int from_mont,
                   uint8_t *out) {
    for (int64_t e = 0; e < n; e++) {
        uint32_t o[NLIMBS];
        int32_t oi[NLIMBS];
        lc_canon_one(limbs + e * NLIMBS, from_mont, o);
        for (int k = 0; k < NLIMBS; k++) oi[k] = (int32_t)o[k];
        lc_pack(oi, 1, out + e * 32);
    }
}

/* Unpack + Montgomery-enter in one pass (input loading hot path):
 * bytes (value x < p) -> digits of x*R mod p, canonical. */
void lc_unpack_mont(const uint8_t *in, int64_t n, int32_t *out) {
    for (int64_t e = 0; e < n; e++) {
        int32_t d[NLIMBS];
        lc_unpack(in + e * 32, 1, d);
        uint64_t a[NLIMBS], t[WIDE];
        for (int i = 0; i < NLIMBS; i++) a[i] = (uint64_t)(uint32_t)d[i];
        lc_mul_wide(a, R2_D, t); /* x * R^2 * R^-1 = x*R mod p */
        uint32_t o[NLIMBS];
        lc_redc(t, o);
        for (int k = 0; k < NLIMBS; k++) out[e * NLIMBS + k] = (int32_t)o[k];
    }
}
