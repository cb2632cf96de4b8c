// Self-contained streaming gzip/DEFLATE decoder -- a minimal, from-
// scratch replacement for the zlib subset csrc/reader.cpp uses
// (inflateInit2(16+MAX_WBITS) / inflate(Z_NO_FLUSH) / inflateReset /
// inflateEnd / zError), so the native reader builds with ZERO external
// dependencies when zlib is unavailable (compile with -DKVARQ_NO_ZLIB).
// The reference achieved the same property by vendoring miniz
// (reference csrc/gz/miniz.c); this is an original implementation of
// RFC 1951/1952 written for that fallback role: correctness and
// resumability over raw speed (roughly 4-8x slower than zlib; the
// primary builds always prefer real zlib + libdeflate).
//
// Streaming model: the decoder suspends and resumes at symbol
// granularity.  A 64-bit bit buffer holds at most 57 bits; every
// Huffman walk PEEKS from a local copy and only commits once the whole
// symbol (plus extra bits) is available, so suspension never loses
// state.  Byte-oriented phases (gzip header, stored blocks, trailer)
// drain whole aligned bytes from the bit buffer first -- the buffer
// can hold at most 7 whole bytes, fewer than the 8-byte gzip trailer,
// so it can never have swallowed bytes belonging to a following
// member, and multi-member streams resume cleanly after
// inflateReset (reader.cpp's multi-stream loop, reference
// workhorse.c:841-866).

#ifndef KVQ_INFLATE_H
#define KVQ_INFLATE_H

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

#define Z_NO_FLUSH 0
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_BUF_ERROR (-5)
#define Z_DATA_ERROR (-3)
#define Z_MEM_ERROR (-4)
#define Z_STREAM_ERROR (-2)
#define MAX_WBITS 15

typedef unsigned int uInt;

namespace kvq_zlib {

inline const uint32_t* crc_table() {
    // C++11 magic static: thread-safe one-time init
    static const uint32_t* tbl = [] {
        static uint32_t t[256];
        for (uint32_t n = 0; n < 256; n++) {
            uint32_t c = n;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            t[n] = c;
        }
        return t;
    }();
    return tbl;
}

struct Huff {
    // canonical code: count[l] = number of codes of length l,
    // sym[] = symbols sorted by (length, symbol)
    int16_t count[16];
    int16_t sym[288];
};

// build the canonical decode table from per-symbol code lengths;
// returns 0 ok, -1 over-subscribed, +1 incomplete (ok only when the
// code has a single symbol or is unused)
inline int huff_build(Huff* h, const int16_t* lens, int n) {
    for (int l = 0; l <= 15; l++) h->count[l] = 0;
    for (int i = 0; i < n; i++) h->count[lens[i]]++;
    if (h->count[0] == n) return 1;      // no codes at all
    int left = 1;
    for (int l = 1; l <= 15; l++) {
        left <<= 1;
        left -= h->count[l];
        if (left < 0) return -1;
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + h->count[l];
    for (int i = 0; i < n; i++)
        if (lens[i]) h->sym[offs[lens[i]]++] = (int16_t)i;
    return left ? 1 : 0;
}

enum Mode {
    M_HEADER, M_HEADER_SKIP, M_BLOCK, M_STORED_LEN, M_STORED,
    M_TABLE, M_LENLENS, M_CODELENS, M_SYM, M_MATCH, M_TRAILER, M_DONE,
    M_BAD
};

struct State {
    Mode mode = M_HEADER;
    const char* msg = nullptr;

    uint64_t bitbuf = 0;
    int bitcnt = 0;

    // gzip header progress
    int hpos = 0;            // bytes of the fixed header consumed
    uint8_t hflg = 0;
    int64_t hskip = 0;       // remaining bytes of a counted skip field
    int hstage = 0;          // 1 extra-len0, 2 extra-len1, 3 extra,
                             // 4 name, 5 comment, 6 hcrc
    int hxlen = 0;           // FEXTRA length low byte stash

    int last = 0;            // final-block flag
    unsigned stored = 0;     // stored-block bytes remaining
    int slb = 0;             // stored LEN/NLEN bytes collected
    uint8_t slen[4];

    // dynamic table construction
    int hlit = 0, hdist = 0, hclen = 0;
    int lpos = 0;
    int16_t lens[320];
    Huff lencode, distcode, clcode;
    int fixed_ready = 0;

    // pending match copy
    unsigned copy_len = 0, copy_dist = 0;

    // 32 KB window
    uint8_t win[1u << 15];
    unsigned wpos = 0;
    int wfull = 0;

    uint32_t crc = 0xFFFFFFFFu;
    uint32_t osize = 0;      // output size mod 2^32
    int tpos = 0;            // trailer bytes consumed
    uint8_t trailer[8];
};

struct Stream {
    const unsigned char* next_in = nullptr;
    uInt avail_in = 0;
    unsigned char* next_out = nullptr;
    uInt avail_out = 0;
    const char* msg = nullptr;
    State* state = nullptr;
};

// ---- bit/byte input helpers ---------------------------------------------

inline void refill(State* s, Stream* z) {
    while (s->bitcnt <= 56 && z->avail_in) {
        s->bitbuf |= (uint64_t)(*z->next_in++) << s->bitcnt;
        z->avail_in--;
        s->bitcnt += 8;
    }
}

// one whole byte for the byte-oriented phases: aligned bitbuf bytes
// first, then raw input; -1 when starved.  Alignment drops the partial
// LOW bits (LSB-first bit order).
inline int take_byte(State* s, Stream* z) {
    const int drop = s->bitcnt & 7;
    s->bitbuf >>= drop;
    s->bitcnt -= drop;
    if (s->bitcnt >= 8) {
        int b = (int)(s->bitbuf & 0xFF);
        s->bitbuf >>= 8;
        s->bitcnt -= 8;
        return b;
    }
    if (z->avail_in) {
        z->avail_in--;
        return *z->next_in++;
    }
    return -1;
}

// peek-decode one symbol from a LOCAL bit cursor (*buf, *have): commits
// nothing in the state.  Returns the symbol, -1 if the cursor ran dry
// (caller suspends without losing anything), -2 on an invalid code.
inline int huff_peek(const Huff* h, uint64_t* buf, int* have) {
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; len++) {
        if (*have == 0) return -1;
        code |= (int)(*buf & 1);
        *buf >>= 1;
        (*have)--;
        int cnt = h->count[len];
        if (code - cnt < first)
            return h->sym[index + (code - first)];
        index += cnt;
        first += cnt;
        first <<= 1;
        code <<= 1;
    }
    return -2;
}

// peek n extra bits from the local cursor; -1 = ran dry
inline int bits_peek(uint64_t* buf, int* have, int n) {
    if (*have < n) return -1;
    int v = (int)(*buf & (((uint64_t)1 << n) - 1));
    *buf >>= n;
    *have -= n;
    return v;
}

// n bits committed directly from the state (single-shot reads whose
// callers pre-checked availability or tolerate suspension); -1 = starve
inline int take_bits(State* s, Stream* z, int n) {
    refill(s, z);
    if (s->bitcnt < n) return -1;
    int v = (int)(s->bitbuf & (((uint64_t)1 << n) - 1));
    s->bitbuf >>= n;
    s->bitcnt -= n;
    return v;
}

inline void emit(State* s, Stream* z, uint8_t byte) {
    *z->next_out++ = byte;
    z->avail_out--;
    s->win[s->wpos] = byte;
    s->wpos = (s->wpos + 1) & 0x7FFF;
    if (!s->wpos) s->wfull = 1;
    s->crc = crc_table()[(s->crc ^ byte) & 0xFF] ^ (s->crc >> 8);
    s->osize++;
}

static const int16_t LEN_BASE[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
    51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const int16_t LEN_EXTRA[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 4, 5, 5, 5, 5, 0};
static const int32_t DIST_BASE[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
    385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
static const int16_t DIST_EXTRA[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
    10, 10, 11, 11, 12, 12, 13, 13};
static const int16_t CLEN_ORDER[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

inline void build_fixed(State* s) {
    if (s->fixed_ready) return;
    int16_t lens[288];
    for (int i = 0; i < 144; i++) lens[i] = 8;
    for (int i = 144; i < 256; i++) lens[i] = 9;
    for (int i = 256; i < 280; i++) lens[i] = 7;
    for (int i = 280; i < 288; i++) lens[i] = 8;
    huff_build(&s->lencode, lens, 288);
    for (int i = 0; i < 30; i++) lens[i] = 5;
    huff_build(&s->distcode, lens, 30);
    s->fixed_ready = 1;
}

inline int bad(State* s, Stream* z, const char* msg) {
    s->mode = M_BAD;
    s->msg = msg;
    z->msg = msg;
    return Z_DATA_ERROR;
}

inline int kvq_inflate(Stream* z) {
    State* s = z->state;
    if (!s) return Z_STREAM_ERROR;
    if (s->mode == M_BAD) { z->msg = s->msg; return Z_DATA_ERROR; }

    const unsigned char* in0 = z->next_in;
    unsigned char* out0 = z->next_out;

    for (;;) {
        switch (s->mode) {

        case M_HEADER: {                 // fixed 10-byte gzip header
            static const int FLG_POS = 3;
            while (s->hpos < 10) {
                int b = take_byte(s, z);
                if (b < 0) goto starve;
                if (s->hpos == 0 && b != 0x1F)
                    return bad(s, z, "incorrect header check");
                if (s->hpos == 1 && b != 0x8B)
                    return bad(s, z, "incorrect header check");
                if (s->hpos == 2 && b != 8)
                    return bad(s, z, "unknown compression method");
                if (s->hpos == FLG_POS) {
                    if (b & 0xE0)
                        return bad(s, z, "unknown header flags set");
                    s->hflg = (uint8_t)b;
                }
                s->hpos++;
            }
            s->hstage = 1;
            s->hskip = -1;
            s->mode = M_HEADER_SKIP;
            break;
        }

        case M_HEADER_SKIP: {            // optional FEXTRA/FNAME/FCOMMENT/FHCRC
            if (s->hstage == 1) {        // FEXTRA length low byte
                if (!(s->hflg & 4)) { s->hstage = 4; }
                else {
                    int b = take_byte(s, z);
                    if (b < 0) goto starve;
                    s->hxlen = b;
                    s->hstage = 2;
                }
            }
            if (s->hstage == 2) {        // FEXTRA length high byte
                int b = take_byte(s, z);
                if (b < 0) goto starve;
                s->hskip = s->hxlen | (b << 8);
                s->hstage = 3;
            }
            if (s->hstage == 3) {        // FEXTRA payload
                while (s->hskip > 0) {
                    if (take_byte(s, z) < 0) goto starve;
                    s->hskip--;
                }
                s->hstage = 4;
            }
            if (s->hstage == 4) {        // FNAME (NUL-terminated)
                if (s->hflg & 8) {
                    for (;;) {
                        int b = take_byte(s, z);
                        if (b < 0) goto starve;
                        if (b == 0) break;
                    }
                    s->hflg = (uint8_t)(s->hflg & ~8);  // consumed
                }
                s->hstage = 5;
            }
            if (s->hstage == 5) {        // FCOMMENT
                if (s->hflg & 16) {
                    for (;;) {
                        int b = take_byte(s, z);
                        if (b < 0) goto starve;
                        if (b == 0) break;
                    }
                    s->hflg = (uint8_t)(s->hflg & ~16);
                }
                s->hstage = 6;
                s->hskip = (s->hflg & 2) ? 2 : 0;
            }
            // FHCRC (2 bytes, not verified -- matches zlib's default
            // leniency for the gzip member header CRC16)
            while (s->hskip > 0) {
                if (take_byte(s, z) < 0) goto starve;
                s->hskip--;
            }
            s->mode = M_BLOCK;
            break;
        }

        case M_BLOCK: {
            int v = take_bits(s, z, 3);
            if (v < 0) goto starve;
            s->last = v & 1;
            switch (v >> 1) {
            case 0:
                s->slb = 0;
                s->mode = M_STORED_LEN;
                break;
            case 1:
                build_fixed(s);
                s->mode = M_SYM;
                break;
            case 2:
                s->mode = M_TABLE;
                break;
            default:
                return bad(s, z, "invalid block type");
            }
            break;
        }

        case M_STORED_LEN: {             // byte-aligned LEN + NLEN
            while (s->slb < 4) {
                int b = take_byte(s, z);
                if (b < 0) goto starve;
                s->slen[s->slb++] = (uint8_t)b;
            }
            unsigned len = s->slen[0] | ((unsigned)s->slen[1] << 8);
            unsigned nlen = s->slen[2] | ((unsigned)s->slen[3] << 8);
            if (len != (~nlen & 0xFFFF))
                return bad(s, z, "invalid stored block lengths");
            s->stored = len;
            s->mode = M_STORED;
            break;
        }

        case M_STORED: {
            while (s->stored) {
                if (!z->avail_out) goto starve;
                int b = take_byte(s, z);
                if (b < 0) goto starve;
                emit(s, z, (uint8_t)b);
                s->stored--;
            }
            s->mode = s->last ? M_TRAILER : M_BLOCK;
            if (s->mode == M_TRAILER) s->tpos = 0;
            break;
        }

        case M_TABLE: {
            refill(s, z);
            if (s->bitcnt < 14) goto starve;
            s->hlit = take_bits(s, z, 5) + 257;
            s->hdist = take_bits(s, z, 5) + 1;
            s->hclen = take_bits(s, z, 4) + 4;
            if (s->hlit > 286 || s->hdist > 30)
                return bad(s, z, "too many length or distance symbols");
            s->lpos = 0;
            s->mode = M_LENLENS;
            break;
        }

        case M_LENLENS: {                // 3-bit code-length code lengths
            while (s->lpos < s->hclen) {
                int v = take_bits(s, z, 3);
                if (v < 0) goto starve;
                s->lens[CLEN_ORDER[s->lpos++]] = (int16_t)v;
            }
            for (int i = s->hclen; i < 19; i++)
                s->lens[CLEN_ORDER[i]] = 0;
            if (huff_build(&s->clcode, s->lens, 19) != 0)
                return bad(s, z, "invalid code lengths set");
            s->lpos = 0;
            s->mode = M_CODELENS;
            break;
        }

        case M_CODELENS: {               // lit/dist code lengths
            while (s->lpos < s->hlit + s->hdist) {
                // decode symbol + its repeat bits atomically from a
                // local cursor, so a mid-sequence input boundary
                // suspends without losing state
                refill(s, z);
                uint64_t buf = s->bitbuf;
                int have = s->bitcnt;
                int sym = huff_peek(&s->clcode, &buf, &have);
                if (sym == -1) goto starve;
                if (sym < 0)
                    return bad(s, z, "invalid code lengths set");
                int rep = 1, val = sym;
                if (sym >= 16) {
                    int e;
                    if (sym == 16) {
                        if (s->lpos == 0)
                            return bad(s, z,
                                       "invalid bit length repeat");
                        e = bits_peek(&buf, &have, 2);
                        if (e < 0) goto starve;
                        val = s->lens[s->lpos - 1];
                        rep = 3 + e;
                    } else if (sym == 17) {
                        e = bits_peek(&buf, &have, 3);
                        if (e < 0) goto starve;
                        val = 0;
                        rep = 3 + e;
                    } else {
                        e = bits_peek(&buf, &have, 7);
                        if (e < 0) goto starve;
                        val = 0;
                        rep = 11 + e;
                    }
                }
                if (s->lpos + rep > s->hlit + s->hdist)
                    return bad(s, z, "invalid bit length repeat");
                s->bitbuf = buf;         // commit
                s->bitcnt = have;
                while (rep--) s->lens[s->lpos++] = (int16_t)val;
            }
            if (s->lens[256] == 0)
                return bad(s, z,
                           "invalid code -- missing end-of-block");
            // incomplete codes are permitted (zlib semantics): an
            // undefined pattern errors at USE via huff_peek; only
            // over-subscribed sets are fatal here
            if (huff_build(&s->lencode, s->lens, s->hlit) < 0)
                return bad(s, z, "invalid literal/lengths set");
            if (huff_build(&s->distcode, s->lens + s->hlit,
                           s->hdist) < 0)
                return bad(s, z, "invalid distances set");
            s->mode = M_SYM;
            break;
        }

        case M_SYM: {
            if (!z->avail_out) goto starve;
            // decode the whole symbol chain (length symbol + extras +
            // distance symbol + extras, <= 48 bits) from a local
            // cursor and commit atomically
            refill(s, z);
            uint64_t buf = s->bitbuf;
            int have = s->bitcnt;
            int sym = huff_peek(&s->lencode, &buf, &have);
            if (sym == -1) goto starve;
            if (sym < 0) return bad(s, z, "invalid literal/length code");
            if (sym < 256) {
                s->bitbuf = buf;
                s->bitcnt = have;
                emit(s, z, (uint8_t)sym);
                break;
            }
            if (sym == 256) {
                s->bitbuf = buf;
                s->bitcnt = have;
                s->mode = s->last ? M_TRAILER : M_BLOCK;
                if (s->mode == M_TRAILER) s->tpos = 0;
                break;
            }
            sym -= 257;
            if (sym >= 29)
                return bad(s, z, "invalid literal/length code");
            int e = bits_peek(&buf, &have, LEN_EXTRA[sym]);
            if (e < 0) goto starve;
            unsigned len = (unsigned)(LEN_BASE[sym] + e);
            int dsym = huff_peek(&s->distcode, &buf, &have);
            if (dsym == -1) goto starve;
            if (dsym < 0 || dsym >= 30)
                return bad(s, z, "invalid distance code");
            e = bits_peek(&buf, &have, DIST_EXTRA[dsym]);
            if (e < 0) goto starve;
            unsigned dist = (unsigned)(DIST_BASE[dsym] + e);
            // bytes available to reference: the whole 32 KB window
            // once it has wrapped, else what has been emitted (osize
            // wraps mod 2^32 on >4 GB members; wpos/wfull do not)
            unsigned lim = s->wfull ? (1u << 15) : s->wpos;
            if (dist > lim)
                return bad(s, z, "invalid distance too far back");
            s->bitbuf = buf;             // commit
            s->bitcnt = have;
            s->copy_len = len;
            s->copy_dist = dist;
            s->mode = M_MATCH;
            break;
        }

        case M_MATCH: {
            while (s->copy_len) {
                if (!z->avail_out) goto starve;
                uint8_t b = s->win[(s->wpos - s->copy_dist) & 0x7FFF];
                emit(s, z, b);
                s->copy_len--;
            }
            s->mode = M_SYM;
            break;
        }

        case M_TRAILER: {                // CRC32 + ISIZE (8 bytes LE)
            while (s->tpos < 8) {
                int b = take_byte(s, z);
                if (b < 0) goto starve;
                s->trailer[s->tpos++] = (uint8_t)b;
            }
            uint32_t crc = (uint32_t)s->trailer[0]
                         | ((uint32_t)s->trailer[1] << 8)
                         | ((uint32_t)s->trailer[2] << 16)
                         | ((uint32_t)s->trailer[3] << 24);
            uint32_t isz = (uint32_t)s->trailer[4]
                         | ((uint32_t)s->trailer[5] << 8)
                         | ((uint32_t)s->trailer[6] << 16)
                         | ((uint32_t)s->trailer[7] << 24);
            if (crc != (s->crc ^ 0xFFFFFFFFu))
                return bad(s, z, "incorrect data check");
            if (isz != s->osize)
                return bad(s, z, "incorrect length check");
            s->mode = M_DONE;
            return Z_STREAM_END;
        }

        case M_DONE:
            return Z_STREAM_END;

        default:
            return bad(s, z, "internal state error");
        }
    }

starve:
    // no forward progress possible with the given buffers
    if (z->next_in == in0 && z->next_out == out0) return Z_BUF_ERROR;
    return Z_OK;
}

}  // namespace kvq_zlib

// ---- zlib-compatible surface --------------------------------------------

typedef kvq_zlib::Stream z_stream;

inline int inflateReset(z_stream* z) {
    if (!z->state) return Z_STREAM_ERROR;
    *z->state = kvq_zlib::State();
    z->msg = nullptr;
    return Z_OK;
}

inline int inflateInit2(z_stream* z, int windowBits) {
    if (windowBits != 16 + MAX_WBITS) return Z_STREAM_ERROR;
    z->state = new (std::nothrow) kvq_zlib::State();
    if (!z->state) return Z_MEM_ERROR;
    z->msg = nullptr;
    return Z_OK;
}

inline int inflateEnd(z_stream* z) {
    delete z->state;
    z->state = nullptr;
    return Z_OK;
}

inline int inflate(z_stream* z, int /*flush*/) {
    return kvq_zlib::kvq_inflate(z);
}

inline const char* zError(int err) {
    switch (err) {
    case Z_OK: return "";
    case Z_STREAM_END: return "stream end";
    case Z_BUF_ERROR: return "buffer error";
    case Z_DATA_ERROR: return "data error";
    case Z_MEM_ERROR: return "insufficient memory";
    default: return "stream error";
    }
}

#endif  // KVQ_INFLATE_H
