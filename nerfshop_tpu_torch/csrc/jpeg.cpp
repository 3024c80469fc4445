// Baseline JPEG codec for the port's image reader and writer
// (data/image_io.py), bound with ctypes by nerfshop_tpu_torch/native.py,
// which builds it with g++ at first use.
//
// The decoder takes baseline and extended sequential Huffman-coded JPEGs at
// 8 bits: one component (grayscale) or three (YCbCr, or RGB when an Adobe
// APP14 segment or the component ids say so), sampled 4:4:4, 4:2:2 or 4:2:0,
// interleaved or one component a scan, with restart intervals. It computes
// what libjpeg(-turbo) computes by default, step for step:
//   - the integer "islow" inverse DCT (jidctint.c), with its range limit;
//   - "fancy" (triangle) upsampling of the chroma (jdsample.c), with the
//     plain replication where a downsampled row is at most 2 samples wide;
//   - the fixed-point YCbCr -> RGB conversion (jdcolor.c).
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and 4-
// component (CMYK, YCCK) files are refused as unsupported; a truncated or
// corrupt stream is refused as corrupt.
//
// The encoder writes baseline JPEGs with the Annex K quantization tables
// scaled by quality and the Annex K Huffman tables, as libjpeg's defaults
// do: fixed-point RGB -> YCbCr (jccolor.c), the biased 2:1 downsampling
// (jcsample.c), edge replication and dummy blocks (jcprepct.c,
// jccoefct.c), the integer forward DCT (jfdctint.c) and the reciprocal
// quantization of jcdctmgr.c.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index, with 16 extra entries so that a
// corrupt run length past the end lands on the last coefficient (jutils.c)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
    int kind;  // 1: corrupt or truncated, 2: unsupported
    std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Failure{1, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Failure{2, msg}; }

// ------------------------------------------------------------------ decoder

struct Huffman {
    bool defined = false;
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};  // largest code of each length, -1 where none
    int32_t valoff[17] = {};   // index of a length's first value minus its first code
    uint16_t look[1 << 9] = {};  // 9-bit lookahead: (length << 8) | value, 0 where longer
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
    std::memcpy(h.vals, vals, (size_t)nvals);
    std::memset(h.look, 0, sizeof(h.look));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        const int n = counts[l - 1];
        h.valoff[l] = k - code;
        for (int i = 0; i < n; ++i, ++k, ++code) {
            if (l <= 9) {
                const int shift = 9 - l;
                for (int j = 0; j < (1 << shift); ++j) h.look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
            }
        }
        h.maxcode[l] = n ? code - 1 : -1;
        if (n && code >= (1 << l)) corrupt("bad Huffman table");
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.defined = true;
}

// Finds the next marker at or after `q`: the index of its code byte (after
// any 0xFF fill bytes), skipping stuffed 0xFF 0x00 pairs and other bytes;
// `n` when there is none.
size_t find_marker(const uint8_t* d, size_t n, size_t q) {
    while (q < n) {
        if (d[q] == 0xFF) {
            size_t r = q + 1;
            while (r < n && d[r] == 0xFF) ++r;
            if (r < n && d[r] != 0) return r;
            q = r + 1;
        } else {
            ++q;
        }
    }
    return n;
}

// Reads the entropy-coded segment MSB first. At a marker (or the end of the
// data) it feeds zero bits, as libjpeg does, and counts them: consuming one
// of them means the stream ended early.
struct BitReader {
    const uint8_t* d;
    size_t n, pos;
    uint64_t acc = 0;
    int nbits = 0, pad = 0;
    bool at_marker = false;

    void fill() {
        while (nbits <= 56) {
            uint32_t b = 0;
            if (at_marker || pos >= n) {
                pad += 8;
            } else if (d[pos] != 0xFF) {
                b = d[pos++];
            } else {
                size_t q = pos + 1;
                while (q < n && d[q] == 0xFF) ++q;
                if (q < n && d[q] == 0) {
                    b = 0xFF;
                    pos = q + 1;
                } else {
                    at_marker = true;
                    pad += 8;
                }
            }
            acc |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }
    uint32_t peek(int k) {
        if (nbits < k) fill();
        return (uint32_t)(acc >> (64 - k));
    }
    void consume(int k) {
        acc <<= k;
        nbits -= k;
        if (nbits < pad) corrupt("the entropy-coded data end early (truncated file)");
    }
    int receive_extend(int s) {
        if (s == 0) return 0;
        const int x = (int)peek(s);
        consume(s);
        return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
    }
    int decode(const Huffman& h) {
        const uint16_t e = h.look[peek(9)];
        if (e) {
            consume(e >> 8);
            return e & 0xFF;
        }
        const uint32_t p16 = peek(16);
        for (int l = 10; l <= 16; ++l) {
            const int32_t code = (int32_t)(p16 >> (16 - l));
            if (code <= h.maxcode[l]) {
                consume(l);
                return h.vals[(h.valoff[l] + code) & 0xFF];
            }
        }
        corrupt("bad Huffman code");
    }
    // Drops the buffered bits and reads the restart marker RST<expected>.
    void restart(int expected) {
        acc = 0;
        nbits = pad = 0;
        at_marker = false;
        const size_t m = find_marker(d, n, pos);
        if (m >= n) corrupt("the data end before a restart marker (truncated file)");
        if (d[m] != 0xD0 + expected) {
            char buf[96];
            std::snprintf(buf, sizeof(buf), "expected restart marker RST%d, found marker 0x%02X", expected, d[m]);
            corrupt(buf);
        }
        pos = m + 1;
    }
};

// Refuses the frame and coding types other than baseline and extended
// sequential Huffman (SOF0, SOF1), naming them.
void check_frame_type(uint8_t code) {
    switch (code) {
        case 0xC2:
        case 0xC6:
            unsupported("progressive JPEG");
        case 0xC3:
        case 0xC7:
            unsupported("lossless JPEG");
        case 0xC5:
            unsupported("hierarchical JPEG");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCC:
        case 0xCD:
        case 0xCE:
        case 0xCF:
            unsupported("arithmetic-coded JPEG");
        default:
            return;
    }
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dw = 0, dh = 0;    // downsampled size in samples
    int bw = 0, bh = 0;    // blocks covering (dw, dh)
    int abw = 0, abh = 0;  // blocks allocated: whole MCUs of an interleaved scan
    int32_t q[64] = {};    // quantization table, latched at the component's first scan
    bool latched = false, scanned = false;
    int td = 0, ta = 0, pred = 0;
    std::vector<int16_t> coef;  // abh x abw blocks of 64 coefficients, natural order
};

struct Decoder {
    const uint8_t* d;
    size_t n;
    Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}
    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1, restart_interval = 0;
    Component comp[3];
    int32_t qt[4][64] = {};
    bool qt_defined[4] = {};
    Huffman dc[4], ac[4];

    uint32_t be16(size_t p) const { return ((uint32_t)d[p] << 8) | d[p + 1]; }

    void parse_sof(size_t p, size_t len) {
        if (frame) corrupt("more than one frame header");
        if (len < 6) corrupt("short frame header");
        const int precision = d[p];
        height = (int)be16(p + 1);
        width = (int)be16(p + 3);
        ncomp = d[p + 5];
        if (precision != 8) unsupported(std::to_string(precision) + "-bit samples (8-bit only)");
        if (ncomp == 4) unsupported("4-component (CMYK or YCCK) JPEG");
        if (ncomp != 1 && ncomp != 3) unsupported(std::to_string(ncomp) + "-component JPEG");
        if (height == 0) unsupported("a height defined by a DNL marker");
        if (width == 0) corrupt("zero image width");
        if (len < 6 + 3 * (size_t)ncomp) corrupt("short frame header");
        hmax = vmax = 1;
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            k.id = d[p + 6 + 3 * c];
            k.h = d[p + 7 + 3 * c] >> 4;
            k.v = d[p + 7 + 3 * c] & 15;
            k.tq = d[p + 8 + 3 * c];
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) corrupt("bad component sampling or table");
            hmax = k.h > hmax ? k.h : hmax;
            vmax = k.v > vmax ? k.v : vmax;
        }
        if (ncomp == 1) comp[0].h = comp[0].v = hmax = vmax = 1;  // one component: one block an MCU
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int c = 0; c < ncomp; ++c) {
            Component& k = comp[c];
            const int hr = hmax / k.h, vr = vmax / k.v;
            const bool ok = hmax % k.h == 0 && vmax % k.v == 0 && (hr == 1 || hr == 2) && (vr == 1 || (vr == 2 && hr == 2));
            if (!ok) {
                char buf[96];
                std::snprintf(buf, sizeof(buf), "chroma sampling %dx%d of %dx%d (4:4:4, 4:2:2 and 4:2:0 only)", k.h,
                              k.v, hmax, vmax);
                unsupported(buf);
            }
            k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
            k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
            k.bw = (k.dw + 7) / 8;
            k.bh = (k.dh + 7) / 8;
            k.abw = mcux * k.h;
            k.abh = mcuy * k.v;
            k.coef.assign((size_t)k.abw * k.abh * 64, 0);
        }
        frame = true;
    }

    void parse_dqt(size_t p, size_t end) {
        while (p < end) {
            const int pq = d[p] >> 4, tq = d[p] & 15;
            const size_t need = pq ? 128 : 64;
            if (tq > 3 || p + 1 + need > end) corrupt("bad quantization table");
            for (int k = 0; k < 64; ++k)
                qt[tq][kNatural[k]] = pq ? (int32_t)be16(p + 1 + 2 * k) : d[p + 1 + k];
            qt_defined[tq] = true;
            p += 1 + need;
        }
    }

    void parse_dht(size_t p, size_t end) {
        while (p < end) {
            if (p + 17 > end) corrupt("bad Huffman table");
            const int tc = d[p] >> 4, th = d[p] & 15;
            int total = 0;
            for (int l = 0; l < 16; ++l) total += d[p + 1 + l];
            if (tc > 1 || th > 3 || total > 256 || p + 17 + total > end) corrupt("bad Huffman table");
            build_huffman(tc ? ac[th] : dc[th], d + p + 1, d + p + 17, total);
            p += 17 + total;
        }
    }

    void decode_block(BitReader& br, Component& k, int16_t* blk) {
        const Huffman& hd = dc[k.td];
        const Huffman& ha = ac[k.ta];
        const int s = br.decode(hd);
        if (s > 15) corrupt("bad DC difference size");
        k.pred += br.receive_extend(s);
        blk[0] = (int16_t)k.pred;
        for (int i = 1; i < 64; ++i) {
            const int rs = br.decode(ha);
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
                i += r;
                blk[kNatural[i]] = (int16_t)br.receive_extend(sz);
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
    }

    // Decodes one scan whose header starts at p; returns the position after its data.
    size_t parse_sos(size_t p, size_t len) {
        if (!frame) corrupt("scan before the frame header");
        const int ns = d[p];
        if (ns < 1 || ns > ncomp || len < 4 + 2 * (size_t)ns) corrupt("bad scan header");
        Component* sc[3];
        for (int i = 0; i < ns; ++i) {
            const int id = d[p + 1 + 2 * i];
            Component* k = nullptr;
            for (int c = 0; c < ncomp; ++c)
                if (comp[c].id == id) k = &comp[c];
            if (!k) corrupt("scan names an unknown component");
            k->td = d[p + 2 + 2 * i] >> 4;
            k->ta = d[p + 2 + 2 * i] & 15;
            if (k->td > 3 || k->ta > 3 || !dc[k->td].defined || !ac[k->ta].defined)
                corrupt("scan uses an undefined Huffman table");
            if (!k->latched) {
                if (!qt_defined[k->tq]) corrupt("scan uses an undefined quantization table");
                std::memcpy(k->q, qt[k->tq], sizeof(k->q));
                k->latched = true;
            }
            k->pred = 0;
            k->scanned = true;
            sc[i] = k;
        }
        BitReader br{d, n, p + len};
        const int64_t n_mcu = ns == 1 ? (int64_t)sc[0]->bw * sc[0]->bh : (int64_t)mcux * mcuy;
        int next_rst = 0;
        for (int64_t m = 0; m < n_mcu; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                br.restart(next_rst);
                next_rst = (next_rst + 1) & 7;
                for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            }
            if (ns == 1) {
                Component& k = *sc[0];
                const int64_t by = m / k.bw, bx = m % k.bw;
                decode_block(br, k, &k.coef[((size_t)by * k.abw + bx) * 64]);
                continue;
            }
            const int my = (int)(m / mcux), mx = (int)(m % mcux);
            for (int i = 0; i < ns; ++i) {
                Component& k = *sc[i];
                for (int y = 0; y < k.v; ++y)
                    for (int x = 0; x < k.h; ++x)
                        decode_block(br, k, &k.coef[((size_t)(my * k.v + y) * k.abw + mx * k.h + x) * 64]);
            }
        }
        return br.pos;
    }

    void parse() {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
        size_t p = 2;
        for (;;) {
            const size_t m = find_marker(d, n, p);
            if (m >= n) corrupt("the file ends before its EOI marker (truncated file)");
            const uint8_t code = d[m];
            p = m + 1;
            if (code == 0xD9) break;                                  // EOI
            if (code == 0xD8 || code == 0x01 || (code >= 0xD0 && code <= 0xD7)) continue;  // no length
            if (p + 2 > n) corrupt("the file ends inside a marker segment (truncated file)");
            const size_t len = be16(p);
            if (len < 2 || p + len > n) corrupt("the file ends inside a marker segment (truncated file)");
            const size_t body = p + 2, end = p + len;
            check_frame_type(code);
            switch (code) {
                case 0xC0:
                case 0xC1:
                    parse_sof(body, len - 2);
                    break;
                case 0xC4:
                    parse_dht(body, end);
                    break;
                case 0xDB:
                    parse_dqt(body, end);
                    break;
                case 0xDD:
                    if (len < 4) corrupt("bad restart interval");
                    restart_interval = (int)be16(body);
                    break;
                case 0xDC:
                    unsupported("a DNL marker");
                case 0xDA:
                    p = parse_sos(body, len - 2);
                    continue;
                case 0xE0:
                    if (len >= 7 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
                    break;
                case 0xEE:
                    if (len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
                        adobe = true;
                        adobe_transform = d[body + 11];
                    }
                    break;
                default:
                    break;  // APPn, COM and others: skipped
            }
            p = end;
        }
        if (!frame) corrupt("no frame header");
        for (int c = 0; c < ncomp; ++c)
            if (!comp[c].scanned) corrupt("a component has no scan (truncated file)");
    }

    // libjpeg's guess of the colour space of a 3-component file (jdapimin.c)
    bool is_rgb() const {
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
};

// The post-IDCT range limit of jdmaster.c: x & 1023 indexes a table that
// clamps x + 128 to [0, 255] for |x| < 512 and wraps beyond.
struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
        for (int i = 0; i < 1024; ++i) t[i] = i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
    }
};
const RangeLimit kRange;

// jidctint.c: jpeg_idct_islow, CONST_BITS 13, PASS1_BITS 2
void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int nb) { return (x + ((int64_t)1 << (nb - 1))) >> nb; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const int32_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            const int dcval = (int)((uint32_t)(ip[0] * qp[0]) << P1);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
            continue;
        }
        int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        int64_t tmp0 = (int64_t)((uint64_t)(z2 + z3) << CB), tmp1 = (int64_t)((uint64_t)(z2 - z3) << CB);
        const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = (int64_t)ip[56] * qp[56];
        tmp1 = (int64_t)ip[40] * qp[40];
        tmp2 = (int64_t)ip[24] * qp[24];
        tmp3 = (int64_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        wp[0] = (int)descale(t10 + tmp3, CB - P1);
        wp[56] = (int)descale(t10 - tmp3, CB - P1);
        wp[8] = (int)descale(t11 + tmp2, CB - P1);
        wp[48] = (int)descale(t11 - tmp2, CB - P1);
        wp[16] = (int)descale(t12 + tmp1, CB - P1);
        wp[40] = (int)descale(t12 - tmp1, CB - P1);
        wp[24] = (int)descale(t13 + tmp0, CB - P1);
        wp[32] = (int)descale(t13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            const uint8_t v = kRange.t[(int)descale(wp[0], P1 + 3) & 1023];
            for (int c = 0; c < 8; ++c) op[c] = v;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
        int64_t tmp0 = (int64_t)((uint64_t)((int64_t)wp[0] + wp[4]) << CB);
        int64_t tmp1 = (int64_t)((uint64_t)((int64_t)wp[0] - wp[4]) << CB);
        const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * F1175;
        tmp0 *= F0298;
        tmp1 *= F2053;
        tmp2 *= F3072;
        tmp3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 *= -F1961;
        z4 *= -F0390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int S = CB + P1 + 3;
        op[0] = kRange.t[(int)descale(t10 + tmp3, S) & 1023];
        op[7] = kRange.t[(int)descale(t10 - tmp3, S) & 1023];
        op[1] = kRange.t[(int)descale(t11 + tmp2, S) & 1023];
        op[6] = kRange.t[(int)descale(t11 - tmp2, S) & 1023];
        op[2] = kRange.t[(int)descale(t12 + tmp1, S) & 1023];
        op[5] = kRange.t[(int)descale(t12 - tmp1, S) & 1023];
        op[3] = kRange.t[(int)descale(t13 + tmp0, S) & 1023];
        op[4] = kRange.t[(int)descale(t13 - tmp0, S) & 1023];
    }
}

// A component's samples at full size, one output row: fullsize copy, or
// jdsample.c's h2v1 / h2v2 upsampling ("fancy" where the downsampled row is
// wider than 2 samples, plain replication otherwise). `plane` holds the
// downsampled samples (stride `ps`); rows and columns past (dw, dh) repeat
// the last real one, as libjpeg's context rows and edge cases do.
void upsample_row(const Component& k, int hmax, int vmax, const uint8_t* plane, int ps, int y, int width, int* out) {
    const int hr = hmax / k.h, vr = vmax / k.v;
    if (hr == 1 && vr == 1) {
        const uint8_t* row = plane + (size_t)y * ps;
        for (int x = 0; x < width; ++x) out[x] = row[x];
        return;
    }
    const int dw = k.dw, last = k.dh - 1;
    const bool fancy = dw > 2;
    if (vr == 1) {  // h2v1
        const uint8_t* in = plane + (size_t)y * ps;
        for (int x = 0; x < width; ++x) {
            const int j = x >> 1;
            if (!fancy) {
                out[x] = in[j];
                continue;
            }
            const int near = in[j] * 3;
            if (x & 1) out[x] = (near + in[j + 1 < dw ? j + 1 : dw - 1] + 2) >> 2;
            else out[x] = (near + in[j > 0 ? j - 1 : 0] + 1) >> 2;
        }
        return;
    }
    // h2v2
    const int r = y >> 1;
    const uint8_t* in0 = plane + (size_t)(r < last ? r : last) * ps;
    if (!fancy) {
        for (int x = 0; x < width; ++x) out[x] = in0[x >> 1];
        return;
    }
    int r1 = (y & 1) ? r + 1 : r - 1;
    r1 = r1 < 0 ? 0 : (r1 > last ? last : r1);
    const uint8_t* in1 = plane + (size_t)r1 * ps;
    auto colsum = [&](int j) {
        j = j < 0 ? 0 : (j >= dw ? dw - 1 : j);
        return in0[j] * 3 + in1[j];
    };
    for (int x = 0; x < width; ++x) {
        const int j = x >> 1;
        const int t = colsum(j);
        if (x & 1) out[x] = (t * 3 + colsum(j + 1) + 7) >> 4;
        else out[x] = (t * 3 + colsum(j - 1) + 8) >> 4;
    }
}

void decode_pixels(Decoder& dec, uint8_t* out) {
    const int W = dec.width, H = dec.height, nc = dec.ncomp;
    std::vector<std::vector<uint8_t>> planes(nc);
    for (int c = 0; c < nc; ++c) {
        Component& k = dec.comp[c];
        const int ps = k.bw * 8;
        planes[c].assign((size_t)ps * k.bh * 8, 0);
        for (int by = 0; by < k.bh; ++by)
            for (int bx = 0; bx < k.bw; ++bx)
                idct_islow(&k.coef[((size_t)by * k.abw + bx) * 64], k.q, &planes[c][(size_t)by * 8 * ps + bx * 8], ps);
    }
    if (nc == 1) {
        const int ps = dec.comp[0].bw * 8;
        for (int y = 0; y < H; ++y) std::memcpy(out + (size_t)y * W, &planes[0][(size_t)y * ps], (size_t)W);
        return;
    }
    // jdcolor.c's tables: SCALEBITS 16, FIX(x) = x * 65536 rounded
    constexpr int64_t ONE_HALF = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
        cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const bool rgb = dec.is_rgb();
    std::vector<int> row0(W), row1(W), row2(W);
    int* rows[3] = {row0.data(), row1.data(), row2.data()};
    for (int y = 0; y < H; ++y) {
        for (int c = 0; c < 3; ++c) {
            const Component& k = dec.comp[c];
            upsample_row(k, dec.hmax, dec.vmax, planes[c].data(), k.bw * 8, y, W, rows[c]);
        }
        uint8_t* op = out + (size_t)y * W * 3;
        for (int x = 0; x < W; ++x) {
            const int Y = row0[x], cb = row1[x], cr = row2[x];
            if (rgb) {
                op[3 * x] = (uint8_t)Y;
                op[3 * x + 1] = (uint8_t)cb;
                op[3 * x + 2] = (uint8_t)cr;
                continue;
            }
            op[3 * x] = clamp(Y + cr_r[cr]);
            op[3 * x + 1] = clamp(Y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
            op[3 * x + 2] = clamp(Y + cb_b[cb]);
        }
    }
}

int fail(const Failure& f, char* err, int err_len) {
    if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", f.msg.c_str());
    return f.kind;
}

// ------------------------------------------------------------------ encoder

const uint8_t kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                            14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                            18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Codes {
    uint16_t code[256] = {};
    uint8_t size[256] = {};
};

Codes make_codes(const uint8_t* bits, const uint8_t* vals) {
    Codes c;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
            c.code[vals[k]] = (uint16_t)code;
            c.size[vals[k]] = (uint8_t)l;
        }
        code <<= 1;
    }
    return c;
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int nbits = 0;
    void put(uint32_t bits, int n) {
        acc = (acc << n) | (bits & ((1u << n) - 1));
        nbits += n;
        while (nbits >= 8) {
            const uint8_t b = (uint8_t)(acc >> (nbits - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            nbits -= 8;
        }
    }
    void flush() {
        if (nbits) put(0x7F, 7);  // pad with one-bits
        nbits = 0;
        acc = 0;
    }
};

// jfdctint.c: jpeg_fdct_islow on samples - 128, in place
void fdct_islow(int32_t* data) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int nb) { return (x + ((int64_t)1 << (nb - 1))) >> nb; };
    for (int pass = 0; pass < 2; ++pass) {
        const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
        const int shift = pass ? CB + P1 : CB - P1;
        for (int i = 0; i < 8; ++i) {
            int32_t* p = data + i * stride;
            const int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
            const int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
            const int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
            const int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
            const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
            if (pass) {
                p[0] = (int32_t)descale(t10 + t11, P1);
                p[4 * step] = (int32_t)descale(t10 - t11, P1);
            } else {
                p[0] = (int32_t)((t10 + t11) * (1 << P1));
                p[4 * step] = (int32_t)((t10 - t11) * (1 << P1));
            }
            int64_t z1 = (t12 + t13) * F0541;
            p[2 * step] = (int32_t)descale(z1 + t13 * F0765, shift);
            p[6 * step] = (int32_t)descale(z1 + t12 * -F1847, shift);
            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            const int64_t z5 = (z3 + z4) * F1175;
            const int64_t a4 = tmp4 * F0298, a5 = tmp5 * F2053, a6 = tmp6 * F3072, a7 = tmp7 * F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            p[7 * step] = (int32_t)descale(a4 + z1 + z3, shift);
            p[5 * step] = (int32_t)descale(a5 + z2 + z4, shift);
            p[3 * step] = (int32_t)descale(a6 + z2 + z3, shift);
            p[1 * step] = (int32_t)descale(a7 + z1 + z4, shift);
        }
    }
}

// jcdctmgr.c's compute_reciprocal for a divisor (8 x the table entry), with
// 16-bit DCT elements: (recip, corr, shift) so that |x| / d rounded is
// ((|x| + corr) * recip) >> (shift + 16)
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t divisor) {
    int b = 0;
    while ((divisor >> (b + 1)) != 0) ++b;  // highest set bit
    int r = 16 + b;
    uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
    const uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2) {
        ++c;
    } else {
        ++fq;
    }
    return Divisor{fq & 0xFFFF, c & 0xFFFF, r - 16};
}

void quant_table(const uint8_t* base, int quality, int32_t* out) {
    quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
    const int64_t scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
        int64_t t = ((int64_t)base[i] * scale + 50) / 100;
        out[i] = (int32_t)(t < 1 ? 1 : (t > 255 ? 255 : t));
    }
}

struct EncComponent {
    int h, v, tq, dw, dh, wib, hib;
    std::vector<uint8_t> plane;  // (abh * 8) x (wib * 8) downsampled samples
    Divisor div[64];
    int last_dc = 0;
};

void put_marker(std::vector<uint8_t>& o, uint8_t code, const std::vector<uint8_t>& body) {
    o.push_back(0xFF);
    o.push_back(code);
    const size_t len = body.size() + 2;
    o.push_back((uint8_t)(len >> 8));
    o.push_back((uint8_t)len);
    o.insert(o.end(), body.begin(), body.end());
}

std::vector<uint8_t> encode(const uint8_t* pix, int W, int H, int nc, int quality, int sub) {
    const int hmax = nc == 3 && sub >= 1 ? 2 : 1, vmax = nc == 3 && sub == 2 ? 2 : 1;
    const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    int32_t q[2][64];
    quant_table(kLumaQ, quality, q[0]);
    quant_table(kChromaQ, quality, q[1]);

    // full-size planes: Y, or Y Cb Cr by jccolor.c's tables
    std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>((size_t)W * H));
    if (nc == 1) {
        std::memcpy(full[0].data(), pix, (size_t)W * H);
    } else {
        constexpr int64_t ONE_HALF = (int64_t)1 << 15, CBCR_OFFSET = (int64_t)128 << 16;
        auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
        for (size_t i = 0; i < (size_t)W * H; ++i) {
            const int64_t r = pix[3 * i], g = pix[3 * i + 1], b = pix[3 * i + 2];
            full[0][i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + ONE_HALF) >> 16);
            full[1][i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
            full[2][i] = (uint8_t)((fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
        }
    }
    std::vector<EncComponent> comps(nc);
    for (int c = 0; c < nc; ++c) {
        EncComponent& k = comps[c];
        k.h = c == 0 ? hmax : 1;
        k.v = c == 0 ? vmax : 1;
        k.tq = c == 0 ? 0 : 1;
        k.dw = (W * k.h + hmax - 1) / hmax;
        k.dh = (H * k.v + vmax - 1) / vmax;
        k.wib = (k.dw + 7) / 8;
        k.hib = (k.dh + 7) / 8;
        for (int i = 0; i < 64; ++i) k.div[i] = reciprocal((uint32_t)q[k.tq][i] * 8);
        const int pw = k.wib * 8, ph = mcuy * k.v * 8;
        k.plane.assign((size_t)pw * ph, 0);
        const int hr = hmax / k.h, vr = vmax / k.v;
        const uint8_t* f = full[c].data();
        auto at = [&](int y, int x) { return (int)f[(size_t)(y < H ? y : H - 1) * W + (x < W ? x : W - 1)]; };
        // the downsampled rows that carry data; the rows below repeat the last one
        const int real = vr == 2 ? (H + 1) / 2 : (hr == 1 && vmax == 2 ? 2 * ((H + 1) / 2) : H);
        for (int y = 0; y < ph; ++y) {
            uint8_t* row = &k.plane[(size_t)y * pw];
            if (y >= real) {
                std::memcpy(row, &k.plane[(size_t)(real - 1) * pw], (size_t)pw);
                continue;
            }
            for (int x = 0; x < pw; ++x) {
                if (hr == 1) row[x] = (uint8_t)at(y, x);
                else if (vr == 1) row[x] = (uint8_t)((at(y, 2 * x) + at(y, 2 * x + 1) + (x & 1)) >> 1);
                else
                    row[x] = (uint8_t)((at(2 * y, 2 * x) + at(2 * y, 2 * x + 1) + at(2 * y + 1, 2 * x) +
                                        at(2 * y + 1, 2 * x + 1) + 1 + (x & 1)) >> 2);
            }
        }
    }

    std::vector<uint8_t> o = {0xFF, 0xD8};
    put_marker(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
        std::vector<uint8_t> body = {(uint8_t)t};
        for (int i = 0; i < 64; ++i) body.push_back((uint8_t)q[t][kNatural[i]]);
        put_marker(o, 0xDB, body);
    }
    {
        std::vector<uint8_t> body = {8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8), (uint8_t)W, (uint8_t)nc};
        for (int c = 0; c < nc; ++c) {
            body.push_back((uint8_t)(c + 1));
            body.push_back((uint8_t)((comps[c].h << 4) | comps[c].v));
            body.push_back((uint8_t)comps[c].tq);
        }
        put_marker(o, 0xC0, body);
    }
    auto dht = [&](uint8_t cls_id, const uint8_t* bits, const uint8_t* vals, int nvals) {
        std::vector<uint8_t> body = {cls_id};
        body.insert(body.end(), bits, bits + 16);
        body.insert(body.end(), vals, vals + nvals);
        put_marker(o, 0xC4, body);
    };
    dht(0x00, kDcLumaBits, kDcVals, 12);
    dht(0x10, kAcLumaBits, kAcLumaVals, 162);
    if (nc == 3) {
        dht(0x01, kDcChromaBits, kDcVals, 12);
        dht(0x11, kAcChromaBits, kAcChromaVals, 162);
    }
    {
        std::vector<uint8_t> body = {(uint8_t)nc};
        for (int c = 0; c < nc; ++c) {
            body.push_back((uint8_t)(c + 1));
            body.push_back(c == 0 ? 0x00 : 0x11);
        }
        body.insert(body.end(), {0, 63, 0});
        put_marker(o, 0xDA, body);
    }
    const Codes dc[2] = {make_codes(kDcLumaBits, kDcVals), make_codes(kDcChromaBits, kDcVals)};
    const Codes ac[2] = {make_codes(kAcLumaBits, kAcLumaVals), make_codes(kAcChromaBits, kAcChromaVals)};
    BitWriter bw{o};
    auto nbits_of = [](int v) {
        int n = 0;
        while (v) {
            ++n;
            v >>= 1;
        }
        return n;
    };
    auto emit = [&](EncComponent& k, const int16_t* blk) {
        const Codes& hd = dc[k.tq];
        const Codes& ha = ac[k.tq];
        int diff = blk[0] - k.last_dc;
        k.last_dc = blk[0];
        int mag = diff < 0 ? -diff : diff, bits = diff < 0 ? diff - 1 : diff;
        int nb = nbits_of(mag);
        bw.put(hd.code[nb], hd.size[nb]);
        if (nb) bw.put((uint32_t)bits, nb);
        int run = 0;
        for (int i = 1; i < 64; ++i) {
            const int v = blk[kNatural[i]];
            if (!v) {
                ++run;
                continue;
            }
            while (run > 15) {
                bw.put(ha.code[0xF0], ha.size[0xF0]);
                run -= 16;
            }
            mag = v < 0 ? -v : v;
            bits = v < 0 ? v - 1 : v;
            nb = nbits_of(mag);
            const int sym = (run << 4) | nb;
            bw.put(ha.code[sym], ha.size[sym]);
            bw.put((uint32_t)bits, nb);
            run = 0;
        }
        if (run) bw.put(ha.code[0], ha.size[0]);
    };
    int16_t mcu[10][64];
    int32_t ws[64];
    for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
            for (int c = 0; c < nc; ++c) {
                EncComponent& k = comps[c];
                const int pw = k.wib * 8;
                int blkn = 0;
                for (int y = 0; y < k.v; ++y) {
                    const int row = my * k.v + y;
                    for (int x = 0; x < k.h; ++x, ++blkn) {
                        int16_t* blk = mcu[blkn];
                        const int col = mx * k.h + x;
                        if (row >= k.hib || col >= k.wib) {  // dummy block: the DC of the block before it
                            const int16_t dcv = row >= k.hib ? mcu[y * k.h - 1][0] : mcu[blkn - 1][0];
                            std::memset(blk, 0, sizeof(int16_t) * 64);
                            blk[0] = dcv;
                            continue;
                        }
                        for (int r = 0; r < 8; ++r)
                            for (int s = 0; s < 8; ++s)
                                ws[r * 8 + s] = (int32_t)k.plane[(size_t)(row * 8 + r) * pw + col * 8 + s] - 128;
                        fdct_islow(ws);
                        for (int i = 0; i < 64; ++i) {
                            const int16_t t = (int16_t)ws[i];
                            const Divisor& dv = k.div[i];
                            const uint32_t a = (uint32_t)(t < 0 ? -t : t);
                            const uint32_t qv = (uint32_t)((uint64_t)((a + dv.corr) & 0xFFFFFFFFu) * dv.recip >> (dv.shift + 16));
                            blk[i] = (int16_t)(t < 0 ? -(int)(int16_t)qv : (int)(int16_t)qv);
                        }
                    }
                }
                for (int b = 0; b < blkn; ++b) emit(k, mcu[b]);
            }
        }
    }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    return o;
}

}  // namespace

extern "C" {

// Reads the frame header: info = {width, height, channels}. Returns 0, 1
// (corrupt or truncated: `err` says why) or 2 (unsupported: `err` names it).
int jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err, int err_len) {
    try {
        Decoder dec(data, (size_t)n);
        if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
        size_t p = 2;
        for (;;) {
            const size_t m = find_marker(data, (size_t)n, p);
            if (m >= (size_t)n || data[m] == 0xD9 || data[m] == 0xDA) corrupt("no frame header before the scan");
            const uint8_t code = data[m];
            p = m + 1;
            if (code == 0xD8 || code == 0x01 || (code >= 0xD0 && code <= 0xD7)) continue;
            if (p + 2 > (size_t)n) corrupt("the file ends inside a marker segment (truncated file)");
            const size_t len = dec.be16(p);
            if (len < 2 || p + len > (size_t)n) corrupt("the file ends inside a marker segment (truncated file)");
            check_frame_type(code);
            if (code == 0xC0 || code == 0xC1) {
                dec.parse_sof(p + 2, len - 2);
                info[0] = dec.width;
                info[1] = dec.height;
                info[2] = dec.ncomp;
                return 0;
            }
            p += len;
        }
    } catch (const Failure& f) {
        return fail(f, err, err_len);
    }
}

// Decodes into out [height, width, channels] (uint8, PIL's array of the
// file). Returns as jpeg_info.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int err_len) {
    try {
        Decoder dec(data, (size_t)n);
        dec.parse();
        decode_pixels(dec, out);
        return 0;
    } catch (const Failure& f) {
        return fail(f, err, err_len);
    }
}

// Encodes pixels [height, width, channels] (channels 1 or 3) at `quality`
// (1-100), chroma `subsampling` 0 (4:4:4), 1 (4:2:2) or 2 (4:2:0) into out
// (capacity `cap`) -> the bytes written, or minus the bytes needed.
int64_t jpeg_encode(const uint8_t* pixels, int width, int height, int channels, int quality, int subsampling,
                    uint8_t* out, int64_t cap) {
    const std::vector<uint8_t> o = encode(pixels, width, height, channels, quality, subsampling);
    if ((int64_t)o.size() > cap) return -(int64_t)o.size();
    std::memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
}

}  // extern "C"
