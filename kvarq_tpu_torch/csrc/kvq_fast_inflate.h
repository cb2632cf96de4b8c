// Fast whole-input gzip/DEFLATE decoder for the single-member-gz hot
// path (csrc/reader.cpp ring producer).  Single-member DEFLATE is
// inherently serial, so its throughput ceiling is one core's inflate
// rate; zlib's streaming inflate (~280 MB/s) was the measured wall for
// typical `.fastq.gz` inputs (docs/performance.md "Compressed input").
// This decoder trades zlib's arbitrary-increment streaming for the
// assumption that the WHOLE compressed input is addressable (the reader
// mmaps regular files anyway), which unlocks the classic fast-inflate
// structure -- the same well-known design points libdeflate/igzip
// document, implemented from scratch:
//
//  - 64-bit bit buffer refilled with one unaligned 8-byte load and a
//    branchless `cnt |= 56` commit; one refill covers a worst-case
//    symbol chain (15-bit litlen + 5 extra + 15-bit dist + 13 extra =
//    48 bits <= 56).
//  - One-lookup Huffman decode: root-10 (litlen) / root-8 (dist)
//    first-level tables with chained subtables for longer codes; an
//    entry packs symbol and total bit length so the common path is
//    load -> shift -> done.
//  - Match copies in 8/16-byte overlapping chunks; short periods are
//    seeded then doubled with non-overlapping memcpys; dist==1 is a
//    memset (quality-line runs make it common in FastQ).
//  - slice-by-8 CRC32 over each produced span (sequential, cache-hot).
//
// Streaming OUT is still supported at symbol granularity: decode_some()
// fills the caller's buffer and suspends between symbols (tables and
// bit cursor live in the Decoder), so the ring producer's bounded-queue
// memory model is unchanged.  Suspension on INPUT cannot happen -- by
// construction the input is complete; hitting its end mid-stream is a
// truncated file, which ends the stream silently with the bytes decoded
// so far, exactly like the zlib ring loop's Z_BUF_ERROR-at-EOF path.
// Multi-member concatenation and error message strings mirror the zlib
// path (reader.cpp ring_zlib_main; reference workhorse.c:841-866); with
// stop_at_member a call returns at each member's end, where the reader's
// member pool may take over (reader.cpp serve_members).

#ifndef KVQ_FAST_INFLATE_H
#define KVQ_FAST_INFLATE_H

#include <cstdint>
#include <cstring>

#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <immintrin.h>
#define KVQ_FI_CLMUL 1
#endif

namespace kvq_fast {

// ---- CRC32 (gzip polynomial), slice-by-8 --------------------------------

inline const uint32_t* crc8_table() {
    static const uint32_t* tbl = [] {
        static uint32_t t[8][256];
        for (uint32_t n = 0; n < 256; n++) {
            uint32_t c = n;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[0][n] = c;
        }
        for (int s = 1; s < 8; s++)
            for (uint32_t n = 0; n < 256; n++)
                t[s][n] = t[s - 1][n] >> 8 ^ t[0][t[s - 1][n] & 0xFF];
        return &t[0][0];
    }();
    return tbl;
}

inline uint32_t crc32_slice8(uint32_t crc, const uint8_t* p, size_t n) {
    const uint32_t* t = crc8_table();
    while (n && ((uintptr_t)p & 7)) {
        crc = t[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
        n--;
    }
    while (n >= 8) {
        uint64_t x;
        std::memcpy(&x, p, 8);
        x ^= crc;
        crc = t[7 * 256 + ((x >> 0) & 0xFF)]
            ^ t[6 * 256 + ((x >> 8) & 0xFF)]
            ^ t[5 * 256 + ((x >> 16) & 0xFF)]
            ^ t[4 * 256 + ((x >> 24) & 0xFF)]
            ^ t[3 * 256 + ((x >> 32) & 0xFF)]
            ^ t[2 * 256 + ((x >> 40) & 0xFF)]
            ^ t[1 * 256 + ((x >> 48) & 0xFF)]
            ^ t[0 * 256 + ((x >> 56) & 0xFF)];
        p += 8;
        n -= 8;
    }
    while (n--) crc = t[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return crc;
}

#ifdef KVQ_FI_CLMUL
// carry-less-multiplication CRC32 folding (the standard technique from
// Intel's "Fast CRC Computation Using PCLMULQDQ" applied to the
// reflected gzip polynomial; the folding constants are the published
// ones for 0xEDB88320).  Verified bit-identical to the table version by
// tools/fast_inflate_test.cpp's randomized crc cross-check; ~20x the
// slice-by-8 throughput, which was 1.9 cycles/byte of pure serial
// dependency chain.
inline uint32_t crc32_clmul(uint32_t crc, const uint8_t* buf, size_t len) {
    const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596ll, 0x0154442bd4ll);
    const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009ell, 0x01751997d0ll);
    const __m128i k5 = _mm_set_epi64x(0, 0x0163cd6124ll);
    const __m128i poly = _mm_set_epi64x(0x01f7011641ll, 0x01db710641ll);
    const __m128i lo32 = _mm_setr_epi32(-1, 0, -1, 0);

    __m128i x1 = _mm_loadu_si128((const __m128i*)buf);
    __m128i x2 = _mm_loadu_si128((const __m128i*)(buf + 16));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(buf + 32));
    __m128i x4 = _mm_loadu_si128((const __m128i*)(buf + 48));
    x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)crc));
    buf += 64;
    len -= 64;

    while (len >= 64) {
        __m128i y1 = _mm_clmulepi64_si128(x1, k1k2, 0x00);
        __m128i y2 = _mm_clmulepi64_si128(x2, k1k2, 0x00);
        __m128i y3 = _mm_clmulepi64_si128(x3, k1k2, 0x00);
        __m128i y4 = _mm_clmulepi64_si128(x4, k1k2, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
        x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
        x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
        x4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, y1),
                           _mm_loadu_si128((const __m128i*)buf));
        x2 = _mm_xor_si128(_mm_xor_si128(x2, y2),
                           _mm_loadu_si128((const __m128i*)(buf + 16)));
        x3 = _mm_xor_si128(_mm_xor_si128(x3, y3),
                           _mm_loadu_si128((const __m128i*)(buf + 32)));
        x4 = _mm_xor_si128(_mm_xor_si128(x4, y4),
                           _mm_loadu_si128((const __m128i*)(buf + 48)));
        buf += 64;
        len -= 64;
    }

    // fold the four lanes into one
    __m128i y;
    y = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x2 = _mm_xor_si128(_mm_xor_si128(x2, y), x1);
    y = _mm_clmulepi64_si128(x2, k3k4, 0x00);
    x2 = _mm_clmulepi64_si128(x2, k3k4, 0x11);
    x3 = _mm_xor_si128(_mm_xor_si128(x3, y), x2);
    y = _mm_clmulepi64_si128(x3, k3k4, 0x00);
    x3 = _mm_clmulepi64_si128(x3, k3k4, 0x11);
    x4 = _mm_xor_si128(_mm_xor_si128(x4, y), x3);
    x1 = x4;

    while (len >= 16) {
        y = _mm_clmulepi64_si128(x1, k3k4, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, y),
                           _mm_loadu_si128((const __m128i*)buf));
        buf += 16;
        len -= 16;
    }

    // 128 -> 64 bits
    y = _mm_clmulepi64_si128(x1, k3k4, 0x10);
    x1 = _mm_srli_si128(x1, 8);
    x1 = _mm_xor_si128(x1, y);
    // 64 -> 32 bits
    y = _mm_srli_si128(x1, 4);
    x1 = _mm_and_si128(x1, lo32);
    x1 = _mm_clmulepi64_si128(x1, k5, 0x00);
    x1 = _mm_xor_si128(x1, y);
    // Barrett reduction
    y = _mm_and_si128(x1, lo32);
    y = _mm_clmulepi64_si128(y, poly, 0x10);
    y = _mm_and_si128(y, lo32);
    y = _mm_clmulepi64_si128(y, poly, 0x00);
    x1 = _mm_xor_si128(x1, y);
    crc = (uint32_t)_mm_extract_epi32(x1, 1);

    if (len) crc = crc32_slice8(crc, buf, len);
    return crc;
}
#endif

inline uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
#ifdef KVQ_FI_CLMUL
    if (n >= 64) return crc32_clmul(crc, p, n);
#endif
    return crc32_slice8(crc, p, n);
}

// ---- Huffman decode tables ----------------------------------------------
//
// Entry layout (u32); bits [5:0] = total bits to consume (0 = invalid
// pattern), kind flags in [15:12]:
//   0x8000 subtable pointer: [31:16] offset, [12:8] index bits
//   0x4000 FUSED length/dist: [31:16] fully-resolved value (the extra
//          bits were part of the table index -- one lookup, one shift)
//   0x2000 two-step length/dist: [31:16] base, [12:8] extra-bit count,
//          [5:0] = code bits only
//   0x1000 end-of-block
//   none   literal / plain symbol: [31:16] value
// Fusing the extra bits into the slot (for codes where code+extra bits
// fit the indexed width) is what makes the common length/distance
// decode a single load+shift.

static const uint16_t LEN_BASE[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
    51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEN_EXTRA[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 4, 5, 5, 5, 5, 0};
static const uint32_t DIST_BASE[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
    385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
static const uint8_t DIST_EXTRA[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
    10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t CLEN_ORDER[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

constexpr int LIT_ROOT = 10;
constexpr int DIST_ROOT = 8;
// worst-case subtable space: every >root code gets a 2^(15-root) slot
// group, one group per distinct root prefix (<= #symbols)
constexpr int LIT_TABLE_SIZE = (1 << LIT_ROOT) + 288 * (1 << (15 - LIT_ROOT));
constexpr int DIST_TABLE_SIZE = (1 << DIST_ROOT) + 32 * (1 << (15 - DIST_ROOT));

enum TableKind { KIND_CL, KIND_LITLEN, KIND_DIST };

// next value of a `len`-bit code in bit-reversed (LSB-first) order
inline uint32_t rev_next(uint32_t code, int len) {
    uint32_t bit = 1u << (len - 1);
    while (code & bit) {
        code ^= bit;
        bit >>= 1;
        if (!bit) return 0;        // wrapped (last code)
    }
    return code | bit;
}

// base/extra for a symbol under its table kind; returns false for
// symbols with no extra-bit semantics (literals, EOB, cl symbols)
inline bool sym_base_extra(TableKind kind, uint32_t sym, uint32_t* base,
                           uint32_t* extra) {
    if (kind == KIND_LITLEN && sym > 256) {
        *base = LEN_BASE[sym - 257];
        *extra = LEN_EXTRA[sym - 257];
        return true;
    }
    if (kind == KIND_DIST) {
        *base = DIST_BASE[sym];
        *extra = DIST_EXTRA[sym];
        return true;
    }
    return false;
}

// build a decode table from canonical code lengths; returns 0 ok,
// -1 over-subscribed.  Incomplete codes leave unassigned patterns as 0
// entries that error at use (zlib semantics: incomplete sets are only
// fatal when a missing pattern is actually encountered).
inline int build_table(uint32_t* table, int table_cap, int root,
                       const uint8_t* lens, int nsyms, TableKind kind) {
    int count[16] = {0};
    for (int i = 0; i < nsyms; i++) count[lens[i]]++;
    // only the primary table is cleared up front (invalid = 0 entries);
    // subtables are cleared at allocation -- dynamic blocks arrive every
    // ~dozens of KB in level-1 streams, so clearing the worst-case
    // subtable region every block costs real decode time
    std::memset(table, 0, ((size_t)1 << root) * sizeof(uint32_t));
    if (count[0] == nsyms) return 0;   // no codes at all (unused table)
    int left = 1;
    for (int l = 1; l <= 15; l++) {
        left <<= 1;
        left -= count[l];
        if (left < 0) return -1;       // over-subscribed
    }
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
    uint16_t sorted[288];
    for (int i = 0; i < nsyms; i++)
        if (lens[i]) sorted[offs[lens[i]]++] = (uint16_t)i;

    uint32_t code = 0;
    int used = 1 << root;
    uint32_t sub_prefix = 0xFFFFFFFFu;
    int cur_sub = 0, cur_subbits = 0;
    int idx_sym = 0;
    for (int len = 1; len <= 15; len++) {
        for (int c = 0; c < count[len]; c++, idx_sym++) {
            uint32_t sym = sorted[idx_sym];
            // RFC-reserved symbols (litlen 286/287, dist 30/31 in the
            // fixed code) participate in the canonical code but are
            // invalid at use: leave their patterns as 0 entries (the
            // tables are pre-cleared), advancing the code as usual
            if ((kind == KIND_LITLEN && sym >= 286)
                    || (kind == KIND_DIST && sym >= 30)) {
                code = rev_next(code, len);
                continue;
            }
            uint32_t base = 0, extra = 0;
            bool has_extra = sym_base_extra(kind, sym, &base, &extra);
            // non-fused entry for this symbol
            uint32_t plain;
            if (has_extra)
                plain = (base << 16) | 0x2000u | (extra << 8)
                      | (uint32_t)len;
            else if (kind == KIND_LITLEN && sym == 256)
                plain = 0x1000u | (uint32_t)len;
            else
                plain = (sym << 16) | (uint32_t)len;

            if (len <= root) {
                bool fuse = has_extra && len + (int)extra <= root;
                for (int idx = (int)code; idx < (1 << root);
                     idx += 1 << len) {
                    if (fuse) {
                        uint32_t ev = ((uint32_t)idx >> len)
                                    & ((1u << extra) - 1);
                        table[idx] = ((base + ev) << 16) | 0x4000u
                                   | (uint32_t)(len + (int)extra);
                    } else {
                        table[idx] = plain;
                    }
                }
            } else {
                uint32_t prefix = code & ((1u << root) - 1);
                if (prefix != sub_prefix) {
                    cur_subbits = 15 - root;
                    cur_sub = used;
                    used += 1 << cur_subbits;
                    if (used > table_cap) return -1;  // cannot happen
                    std::memset(table + cur_sub, 0,
                                ((size_t)1 << cur_subbits)
                                * sizeof(uint32_t));
                    table[prefix] = ((uint32_t)cur_sub << 16) | 0x8000u
                                  | ((uint32_t)cur_subbits << 8);
                    sub_prefix = prefix;
                }
                bool fuse = has_extra && len + (int)extra <= 15;
                for (int idx = (int)(code >> root);
                     idx < (1 << cur_subbits);
                     idx += 1 << (len - root)) {
                    if (fuse) {
                        uint32_t ev = ((uint32_t)idx >> (len - root))
                                    & ((1u << extra) - 1);
                        table[cur_sub + idx] =
                            ((base + ev) << 16) | 0x4000u
                            | (uint32_t)(len + (int)extra);
                    } else {
                        table[cur_sub + idx] = plain;
                    }
                }
            }
            code = rev_next(code, len);
        }
    }
    return 0;
}

// ---- decoder ------------------------------------------------------------

enum Phase {
    PH_HEADER,       // at a member boundary: gzip header expected
    PH_BLOCK,        // between blocks: 3-bit block header expected
    PH_HUF,          // inside a Huffman block (tables are live)
    PH_STORED,       // inside a stored block (stored_left remaining)
    PH_TRAILER,      // CRC32 + ISIZE expected
    PH_DONE,         // all members decoded, input exhausted
    PH_TRUNC,        // input ended mid-stream (silent end, zlib parity)
    PH_ERR
};

struct Decoder {
    const uint8_t* in = nullptr;
    size_t in_size = 0;

    // bit cursor: logical position = (p - in)*8 - cnt
    const uint8_t* p = nullptr;
    uint64_t buf = 0;
    int cnt = 0;

    Phase phase = PH_HEADER;
    const char* msg = nullptr;
    int last = 0;                 // current block is the final one
    uint32_t stored_left = 0;

    uint64_t member_out = 0;      // bytes produced in the current member
    uint32_t crc = 0xFFFFFFFFu;
    // return at the end of each member (phase PH_HEADER, the cursor on
    // the next member's first byte) instead of decoding on into the next
    bool stop_at_member = false;

    uint32_t lit_table[LIT_TABLE_SIZE];
    uint32_t dist_table[DIST_TABLE_SIZE];

    void init(const uint8_t* data, size_t size) {
        in = data;
        in_size = size;
        p = data;
        buf = 0;
        cnt = 0;
        phase = PH_HEADER;
        msg = nullptr;
        member_out = 0;
        crc = 0xFFFFFFFFu;
    }

    size_t byte_pos() const { return (size_t)(p - in) - (size_t)(cnt >> 3); }

    // go on at byte `off`, where a member starts: a member's window starts
    // empty, so nothing decoded before it is needed
    void restart_at(size_t off) {
        p = in + off;
        buf = 0;
        cnt = 0;
        phase = PH_HEADER;
        msg = nullptr;
    }
};

inline const uint8_t* in_end(const Decoder* d) { return d->in + d->in_size; }

// branchless when >=8 bytes remain; careful tail otherwise
inline void refill(Decoder* d) {
    if (d->p + 8 <= in_end(d)) {
        uint64_t x;
        std::memcpy(&x, d->p, 8);
        d->buf |= x << d->cnt;
        d->p += (63 - d->cnt) >> 3;
        d->cnt |= 56;
    } else {
        while (d->cnt <= 56 && d->p < in_end(d)) {
            d->buf |= (uint64_t)(*d->p++) << d->cnt;
            d->cnt += 8;
        }
    }
}

inline int fail(Decoder* d, const char* msg) {
    d->phase = PH_ERR;
    d->msg = msg;
    return -1;
}

// re-anchor the byte cursor at the current (byte-aligned) bit position
inline void byte_sync(Decoder* d) {
    int drop = d->cnt & 7;
    d->buf >>= drop;
    d->cnt -= drop;
    d->p -= d->cnt >> 3;
    d->buf = 0;
    d->cnt = 0;
}

// parse a gzip member header starting at the byte cursor; 1 ok,
// 0 truncated, -1 error
inline int parse_header(Decoder* d) {
    const uint8_t* q = d->p;
    const uint8_t* end = in_end(d);
    if (end - q < 10) return 0;
    if (q[0] != 0x1F || q[1] != 0x8B)
        return fail(d, "incorrect header check");
    if (q[2] != 8) return fail(d, "unknown compression method");
    uint8_t flg = q[3];
    if (flg & 0xE0) return fail(d, "unknown header flags set");
    q += 10;
    if (flg & 4) {                       // FEXTRA
        if (end - q < 2) return 0;
        size_t xlen = (size_t)q[0] | ((size_t)q[1] << 8);
        q += 2;
        if ((size_t)(end - q) < xlen) return 0;
        q += xlen;
    }
    if (flg & 8) {                       // FNAME
        while (q < end && *q) q++;
        if (q == end) return 0;
        q++;
    }
    if (flg & 16) {                      // FCOMMENT
        while (q < end && *q) q++;
        if (q == end) return 0;
        q++;
    }
    if (flg & 2) {                       // FHCRC (not verified; zlib parity)
        if (end - q < 2) return 0;
        q += 2;
    }
    d->p = q;
    d->buf = 0;
    d->cnt = 0;
    d->member_out = 0;
    d->crc = 0xFFFFFFFFu;
    return 1;
}

// read the dynamic-table definition and build the decode tables;
// 1 ok, 0 truncated, -1 error
inline int read_dynamic_tables(Decoder* d) {
    refill(d);
    if (d->cnt < 14) return 0;
    int hlit = (int)(d->buf & 31) + 257;
    int hdist = (int)((d->buf >> 5) & 31) + 1;
    int hclen = (int)((d->buf >> 10) & 15) + 4;
    d->buf >>= 14;
    d->cnt -= 14;
    if (hlit > 286 || hdist > 30)
        return fail(d, "too many length or distance symbols");

    uint8_t cl_lens[19] = {0};
    for (int i = 0; i < hclen; i++) {
        refill(d);
        if (d->cnt < 3) return 0;
        cl_lens[CLEN_ORDER[i]] = (uint8_t)(d->buf & 7);
        d->buf >>= 3;
        d->cnt -= 3;
    }
    uint32_t cl_table[1 << 7];
    if (build_table(cl_table, 1 << 7, 7, cl_lens, 19, KIND_CL) != 0)
        return fail(d, "invalid code lengths set");

    uint8_t lens[320];
    int n = 0;
    while (n < hlit + hdist) {
        refill(d);
        uint32_t e = cl_table[d->buf & 127];
        int bl = (int)(e & 63);
        if (!bl) {
            // unassigned pattern: only a definite data error when all
            // 7 possible code bits are present -- fewer available bits
            // mean the true (longer) code was cut off by truncation
            return d->cnt >= 7 ? fail(d, "invalid code lengths set") : 0;
        }
        if (d->cnt < bl)
            return 0;
        uint32_t sym = e >> 16;
        if (sym < 16) {
            d->buf >>= bl;
            d->cnt -= bl;
            lens[n++] = (uint8_t)sym;
            continue;
        }
        int ebits = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        if (d->cnt < bl + ebits) return 0;
        d->buf >>= bl;
        d->cnt -= bl;
        int rep = (int)(d->buf & ((1u << ebits) - 1));
        d->buf >>= ebits;
        d->cnt -= ebits;
        uint8_t val = 0;
        if (sym == 16) {
            if (n == 0) return fail(d, "invalid bit length repeat");
            val = lens[n - 1];
            rep += 3;
        } else if (sym == 17) {
            rep += 3;
        } else {
            rep += 11;
        }
        if (n + rep > hlit + hdist)
            return fail(d, "invalid bit length repeat");
        std::memset(lens + n, val, (size_t)rep);
        n += rep;
    }
    if (lens[256] == 0)
        return fail(d, "invalid code -- missing end-of-block");
    if (build_table(d->lit_table, LIT_TABLE_SIZE, LIT_ROOT, lens,
                    hlit, KIND_LITLEN) != 0)
        return fail(d, "invalid literal/lengths set");
    if (build_table(d->dist_table, DIST_TABLE_SIZE, DIST_ROOT,
                    lens + hlit, hdist, KIND_DIST) != 0)
        return fail(d, "invalid distances set");
    return 1;
}

inline void build_fixed_tables(Decoder* d) {
    uint8_t lens[288];
    for (int i = 0; i < 144; i++) lens[i] = 8;
    for (int i = 144; i < 256; i++) lens[i] = 9;
    for (int i = 256; i < 280; i++) lens[i] = 7;
    for (int i = 280; i < 288; i++) lens[i] = 8;
    build_table(d->lit_table, LIT_TABLE_SIZE, LIT_ROOT, lens, 288,
                KIND_LITLEN);
    for (int i = 0; i < 30; i++) lens[i] = 5;
    build_table(d->dist_table, DIST_TABLE_SIZE, DIST_ROOT, lens, 30,
                KIND_DIST);
}

// copy a match of `len` from `dist` back, into out[pos..]; caller
// guarantees out headroom of >= len + 16 bytes past pos
inline void copy_match(uint8_t* out, size_t pos, uint32_t dist,
                       uint32_t len) {
    uint8_t* dst = out + pos;
    const uint8_t* src = dst - dist;
    if (dist == 1) {
        std::memset(dst, *src, len);
        return;
    }
    if (dist >= 16) {
        // 16-byte chunks may overshoot into the headroom
        size_t i = 0;
        do {
            std::memcpy(dst + i, src + i, 16);
            i += 16;
        } while (i < len);
        return;
    }
    if (dist >= 8) {
        size_t i = 0;
        do {
            std::memcpy(dst + i, src + i, 8);
            i += 8;
        } while (i < len);
        return;
    }
    // short period: seed one period, then double with disjoint copies
    size_t filled = dist < len ? dist : len;
    for (size_t i = 0; i < filled; i++) dst[i] = src[i];
    while (filled < len) {
        size_t m = filled < len - filled ? filled : len - filled;
        std::memcpy(dst + filled, dst, m);
        filled += m;
    }
}

// decode into out[0..out_cap); `hist` bytes of already-produced output
// sit directly BEFORE out (back-reference window; the caller maintains
// >= 32 KB once available).  Returns bytes produced (suspend on
// output-full / clean end / truncation / data error -- distinguish via
// phase); a data error first DELIVERS the bytes decoded before it
// (phase PH_ERR, msg set) and only a subsequent call returns -1, so
// callers can parse the valid prefix before surfacing the error
// (zlib-ring parity).
inline long decode_some(Decoder* d, uint8_t* out, size_t out_cap,
                        size_t hist) {
    // symbol fastpath needs len(<=258) + 16 headroom; stored blocks
    // manage their own bounds
    constexpr size_t SLACK = 280;
    size_t pos = 0;
    size_t crc_from = 0;

    auto flush_crc = [&](size_t upto) {
        d->crc = crc32_update(d->crc, out + crc_from, upto - crc_from);
        crc_from = upto;
    };

    for (;;) {
        switch (d->phase) {

        case PH_HEADER: {
            byte_sync(d);
            if (d->p >= in_end(d)) {
                d->phase = PH_DONE;
                flush_crc(pos);
                return (long)pos;
            }
            int r = parse_header(d);
            if (r < 0) {
                // deliver the bytes decoded before the error (zlib
                // ring parity: it pushes the chunk, THEN reports); the
                // next call returns -1 from PH_ERR
                flush_crc(pos);
                return (long)pos;
            }
            if (r == 0) {                 // truncated header
                d->phase = PH_TRUNC;
                flush_crc(pos);
                return (long)pos;
            }
            d->phase = PH_BLOCK;
            break;
        }

        case PH_BLOCK: {
            refill(d);
            if (d->cnt < 3) {
                d->phase = PH_TRUNC;
                flush_crc(pos);
                return (long)pos;
            }
            d->last = (int)(d->buf & 1);
            int type = (int)((d->buf >> 1) & 3);
            d->buf >>= 3;
            d->cnt -= 3;
            if (type == 0) {
                byte_sync(d);
                if (in_end(d) - d->p < 4) {
                    d->phase = PH_TRUNC;
                    flush_crc(pos);
                    return (long)pos;
                }
                uint32_t len = (uint32_t)d->p[0]
                             | ((uint32_t)d->p[1] << 8);
                uint32_t nlen = (uint32_t)d->p[2]
                              | ((uint32_t)d->p[3] << 8);
                d->p += 4;
                if (len != (~nlen & 0xFFFF)) {
                    fail(d, "invalid stored block lengths");
                    flush_crc(pos);
                    return (long)pos;
                }
                d->stored_left = len;
                d->phase = PH_STORED;
            } else if (type == 1) {
                build_fixed_tables(d);
                d->phase = PH_HUF;
            } else if (type == 2) {
                int r = read_dynamic_tables(d);
                if (r < 0) {
                    flush_crc(pos);
                    return (long)pos;
                }
                if (r == 0) {
                    d->phase = PH_TRUNC;
                    flush_crc(pos);
                    return (long)pos;
                }
                d->phase = PH_HUF;
            } else {
                fail(d, "invalid block type");
                flush_crc(pos);
                return (long)pos;
            }
            break;
        }

        case PH_STORED: {
            size_t want = d->stored_left;
            size_t space = out_cap - pos;
            size_t avail = (size_t)(in_end(d) - d->p);
            size_t n = want < space ? want : space;
            if (n > avail) n = avail;
            std::memcpy(out + pos, d->p, n);
            d->p += n;
            pos += n;
            d->member_out += n;
            d->stored_left -= (uint32_t)n;
            if (d->stored_left) {
                if (pos == out_cap) {      // output full: suspend
                    flush_crc(pos);
                    return (long)pos;
                }
                // input exhausted mid-stored
                flush_crc(pos);
                d->phase = PH_TRUNC;
                return (long)pos;
            }
            d->phase = d->last ? PH_TRAILER : PH_BLOCK;
            break;
        }

        case PH_HUF: {
            // fastloop margins
            const uint64_t win_base = d->member_out;  // before this loop
            size_t start = pos;
            uint64_t lbuf = d->buf;
            int lcnt = d->cnt;
            const uint8_t* lp = d->p;
            const uint8_t* lend = in_end(d);
            int result = 0;   // 0 suspend-out, 1 eob, 2 trunc, -1 err

            for (;;) {
                if (pos + SLACK > out_cap) { result = 0; break; }
                // refill (branchless when possible)
                if (lp + 8 <= lend) {
                    uint64_t x;
                    std::memcpy(&x, lp, 8);
                    lbuf |= x << lcnt;
                    lp += (63 - lcnt) >> 3;
                    lcnt |= 56;
                } else {
                    while (lcnt <= 56 && lp < lend) {
                        lbuf |= (uint64_t)(*lp++) << lcnt;
                        lcnt += 8;
                    }
                }
                uint32_t e = d->lit_table[lbuf & ((1u << LIT_ROOT) - 1)];
                if (e & 0x8000u) {
                    uint32_t subbits = (e >> 8) & 0x1F;
                    e = d->lit_table[(e >> 16)
                        + ((lbuf >> LIT_ROOT) & ((1u << subbits) - 1))];
                }
                int bl = (int)(e & 63);
                if ((e & 0xF000u) == 0) {        // literal (or invalid)
                    if (bl == 0 || lcnt < bl) {
                        // an unassigned pattern is only a definite
                        // error with all 15 possible code bits present;
                        // zero-padded truncated tails must end silently
                        // (zlib ring parity)
                        if (bl == 0 && lcnt >= 15) { result = -1;
                            fail(d, "invalid literal/length code"); }
                        else result = 2;   // starved: truncated input
                        break;
                    }
                    lbuf >>= bl;
                    lcnt -= bl;
                    out[pos++] = (uint8_t)(e >> 16);
                    // 2nd + 3rd literal without a refill (>= 41, 26
                    // bits left; a code is <= 15)
                    e = d->lit_table[lbuf & ((1u << LIT_ROOT) - 1)];
                    if (e & 0x8000u) {
                        uint32_t subbits = (e >> 8) & 0x1F;
                        e = d->lit_table[(e >> 16)
                            + ((lbuf >> LIT_ROOT)
                               & ((1u << subbits) - 1))];
                    }
                    bl = (int)(e & 63);
                    if ((e & 0xF000u) == 0 && bl && lcnt >= bl) {
                        lbuf >>= bl;
                        lcnt -= bl;
                        out[pos++] = (uint8_t)(e >> 16);
                        e = d->lit_table[lbuf & ((1u << LIT_ROOT) - 1)];
                        if (e & 0x8000u) {
                            uint32_t subbits = (e >> 8) & 0x1F;
                            e = d->lit_table[(e >> 16)
                                + ((lbuf >> LIT_ROOT)
                                   & ((1u << subbits) - 1))];
                        }
                        bl = (int)(e & 63);
                        if ((e & 0xF000u) == 0 && bl && lcnt >= bl) {
                            lbuf >>= bl;
                            lcnt -= bl;
                            out[pos++] = (uint8_t)(e >> 16);
                        }
                    }
                    continue;
                }
                uint32_t mlen;
                if (e & 0x4000u) {               // fused length
                    if (lcnt < bl) { result = 2; break; }
                    lbuf >>= bl;
                    lcnt -= bl;
                    mlen = e >> 16;
                } else if (e & 0x2000u) {        // two-step length
                    int eb = (int)((e >> 8) & 0x1F);
                    if (lcnt < bl + eb) { result = 2; break; }
                    lbuf >>= bl;
                    mlen = (e >> 16) + (uint32_t)(lbuf
                                                  & ((1u << eb) - 1));
                    lbuf >>= eb;
                    lcnt -= bl + eb;
                } else {                         // end-of-block
                    if (lcnt < bl) { result = 2; break; }
                    lbuf >>= bl;
                    lcnt -= bl;
                    result = 1;
                    break;
                }

                uint32_t de = d->dist_table[lbuf & ((1u << DIST_ROOT) - 1)];
                if (de & 0x8000u) {
                    uint32_t subbits = (de >> 8) & 0x1F;
                    de = d->dist_table[(de >> 16)
                        + ((lbuf >> DIST_ROOT) & ((1u << subbits) - 1))];
                }
                int dbl = (int)(de & 63);
                uint32_t dist;
                if (de & 0x4000u) {              // fused distance
                    if (lcnt < dbl) { result = 2; break; }
                    lbuf >>= dbl;
                    lcnt -= dbl;
                    dist = de >> 16;
                } else if (de & 0x2000u) {       // two-step distance
                    int eb = (int)((de >> 8) & 0x1F);
                    if (lcnt < dbl + eb) { result = 2; break; }
                    lbuf >>= dbl;
                    dist = (de >> 16) + (uint32_t)(lbuf
                                                   & ((1u << eb) - 1));
                    lbuf >>= eb;
                    lcnt -= dbl + eb;
                } else {
                    // unassigned distance pattern: definite error only
                    // with all 15 possible code bits present (else the
                    // input was truncated mid-code)
                    if (lcnt >= 15) { result = -1;
                        fail(d, "invalid distance code"); }
                    else result = 2;
                    break;
                }

                uint64_t have = win_base + (uint64_t)(pos - start);
                // the caller's window guarantee covers `hist` bytes
                // before out[0]
                if (dist > have
                        || (pos < dist && dist - pos > hist)) {
                    result = -1;
                    fail(d, "invalid distance too far back");
                    break;
                }
                copy_match(out, pos, dist, mlen);
                pos += mlen;
            }

            d->buf = lbuf;
            d->cnt = lcnt;
            d->p = lp;
            d->member_out = win_base + (uint64_t)(pos - start);
            flush_crc(pos);
            if (result == -1) return (long)pos;   // error held in PH_ERR
            if (result == 0) return (long)pos;          // output full
            if (result == 2) {
                // starved mid-symbol: only truncation can cause this
                d->phase = PH_TRUNC;
                return (long)pos;
            }
            d->phase = d->last ? PH_TRAILER : PH_BLOCK;  // end of block
            break;
        }

        case PH_TRAILER: {
            byte_sync(d);
            if (in_end(d) - d->p < 8) {
                d->phase = PH_TRUNC;
                return (long)pos;
            }
            const uint8_t* q = d->p;
            uint32_t want_crc = (uint32_t)q[0] | ((uint32_t)q[1] << 8)
                              | ((uint32_t)q[2] << 16)
                              | ((uint32_t)q[3] << 24);
            uint32_t want_isz = (uint32_t)q[4] | ((uint32_t)q[5] << 8)
                              | ((uint32_t)q[6] << 16)
                              | ((uint32_t)q[7] << 24);
            d->p += 8;
            flush_crc(pos);
            if (want_crc != (d->crc ^ 0xFFFFFFFFu)) {
                fail(d, "incorrect data check");
                return (long)pos;
            }
            if (want_isz != (uint32_t)d->member_out) {
                fail(d, "incorrect length check");
                return (long)pos;
            }
            d->phase = PH_HEADER;        // maybe another member
            if (d->stop_at_member) return (long)pos;
            break;
        }

        case PH_DONE:
        case PH_TRUNC:
            return (long)pos;

        case PH_ERR:
            return -1;
        }
    }
}

}  // namespace kvq_fast

#endif  // KVQ_FAST_INFLATE_H
