// The batch decoder's header walk (decode/batch_gpu.py), natively.
//
// lane_walk reads one stream's headers from a bit position: the stream
// header (WBITS) on a first walk, then metablock headers.  It passes
// metadata and uncompressed metablocks (recording the uncompressed ones
// by byte offset and length) and stops at the first compressed
// metablock, final or not, returning the lane fields the device kernel
// needs: the header's end bit, MLEN, NPOSTFIX, NDIRECT and the code
// lengths of the literal, command and distance codes.  A stream can
// instead end in the walk (ISLASTEMPTY, a final metadata block).
//
// It follows batch_gpu._walk_from, _read_window_bits and
// core/prefix.read_prefix_code read for read, and refuses (returns 0)
// wherever those return None or raise, and where its segment buffer is
// full; the caller then runs the Python walk, so a refused stream's plan
// or error is the Python one.  A compressed metablock with more than one
// block type or tree is refused at its count code: the walk reads no
// block-switch codes and no context map.
//
// Built with g++ as a plain C library (native_bridge.lane_walk).

#include <cstdint>
#include <cstring>

namespace {

// LSB-first reads over in[0, nbits).  A read past the end sets `over`
// and returns 0 (the Python reader raises NeedsMoreInput there); every
// caller checks `over` before it accepts.
struct Bits {
    const uint8_t* in;
    int64_t nbits;
    int64_t pos;
    bool over;

    uint32_t peek(int n) const {  // missing tail bits read as zero
        int64_t byte = pos >> 3, nbytes = nbits >> 3;
        uint64_t v = 0;
        for (int i = 0; i < 5 && byte + i < nbytes; i++)
            v |= (uint64_t)in[byte + i] << (8 * i);
        return (uint32_t)((v >> (pos & 7)) & ((1ull << n) - 1));
    }

    void skip(int64_t n) {
        if (pos + n > nbits) {
            over = true;
            pos = nbits;
        } else {
            pos += n;
        }
    }

    uint32_t read(int n) {  // n <= 24
        if (n == 0) return 0;
        if (pos + n > nbits) {
            over = true;
            pos = nbits;
            return 0;
        }
        uint32_t v = peek(n);
        pos += n;
        return v;
    }

    uint32_t align() { return read((int)(-pos & 7)); }
};

// RFC 7932 section 3.5: the order of the code-length code's lengths
const int kClOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11,
                          12, 13, 14, 15};

// one length of the code-length code (the fixed code of section 3.5)
int read_clcode_length(Bits& br) {
    if (br.read(1) == 0) return br.read(1) == 0 ? 0 : 3;
    if (br.read(1) == 0) return 4;
    if (br.read(1) == 0) return 2;
    return br.read(1) == 0 ? 1 : 5;
}

int alphabet_bits(int n) {
    int b = 0;
    while ((1 << b) < n) b++;
    return b < 1 ? 1 : b;
}

// A prefix-code description (simple or complex) read into per-symbol
// code lengths len[0, n); a one-symbol simple code gets the marker
// length 1.  False where read_prefix_code raises.
bool read_prefix_lengths(Bits& br, int n, int32_t* len) {
    std::memset(len, 0, sizeof(int32_t) * n);
    int hskip = (int)br.read(2);
    if (hskip == 1) {  // simple code, 1..4 symbols
        int nsym = (int)br.read(2) + 1;
        int bits = alphabet_bits(n);
        int syms[4];
        for (int k = 0; k < nsym; k++) {
            int s = (int)br.read(bits);
            if (br.over || s >= n) return false;
            for (int j = 0; j < k; j++)
                if (syms[j] == s) return false;
            syms[k] = s;
        }
        if (nsym == 1) {
            len[syms[0]] = 1;
        } else if (nsym == 2) {
            len[syms[0]] = len[syms[1]] = 1;
        } else if (nsym == 3) {
            len[syms[0]] = 1;
            len[syms[1]] = len[syms[2]] = 2;
        } else if (br.read(1)) {
            len[syms[0]] = 1;
            len[syms[1]] = 2;
            len[syms[2]] = len[syms[3]] = 3;
        } else {
            for (int k = 0; k < 4; k++) len[syms[k]] = 2;
        }
        return !br.over;
    }

    // complex code: the code-length code's lengths first
    int cl[18] = {0};
    int space = 0, num = 0;
    for (int i = hskip; i < 18; i++) {
        int ln = read_clcode_length(br);
        cl[kClOrder[i]] = ln;
        if (ln) {
            num++;
            space += 32 >> ln;
            if (space >= 32) break;
        }
    }
    if (br.over) return false;
    if (num != 1 && space != 32) return false;

    // its decode table (canonical codes, LSB-first, `top` bits wide),
    // or the one symbol that takes no bits
    int single = -1, top = 0;
    int8_t tab_sym[32], tab_len[32];
    if (num == 1) {
        for (int s = 0; s < 18; s++)
            if (cl[s]) single = s;
    } else {
        int count[6] = {0}, next[6] = {0};
        for (int s = 0; s < 18; s++) {
            count[cl[s]]++;
            if (cl[s] > top) top = cl[s];
        }
        count[0] = 0;
        int code = 0;
        for (int l = 1; l <= 5; l++) {
            code = (code + count[l - 1]) << 1;
            next[l] = code;
        }
        for (int s = 0; s < 18; s++) {
            int l = cl[s];
            if (!l) continue;
            int c = next[l]++, rev = 0;
            for (int b = 0; b < l; b++) rev |= ((c >> b) & 1) << (l - 1 - b);
            for (int r = rev; r < (1 << top); r += 1 << l) {
                tab_sym[r] = (int8_t)s;
                tab_len[r] = (int8_t)l;
            }
        }
    }

    // symbol code lengths, with RLE repeats (16: the previous nonzero
    // length, 17: zeros)
    space = 0;
    int prev_nonzero = 8, prev_repeat_sym = -1, repeat = 0, i = 0;
    while (i < n && space < 32768) {
        int sym = single;
        if (sym < 0) {
            uint32_t b = br.peek(top);
            br.skip(tab_len[b]);
            sym = tab_sym[b];
        }
        if (br.over) return false;
        if (sym < 16) {
            len[i++] = sym;
            prev_repeat_sym = -1;
            if (sym) {
                prev_nonzero = sym;
                space += 32768 >> sym;
            }
            continue;
        }
        int extra_bits = sym == 16 ? 2 : 3;
        int extra = (int)br.read(extra_bits);
        if (br.over) return false;
        int new_repeat, delta;
        if (prev_repeat_sym == sym) {
            new_repeat = ((repeat - 2) << extra_bits) + 3 + extra;
            delta = new_repeat - repeat;
        } else {
            new_repeat = 3 + extra;
            delta = new_repeat;
        }
        repeat = new_repeat;
        prev_repeat_sym = sym;
        int val = sym == 16 ? prev_nonzero : 0;
        if (i + delta > n) return false;
        for (int k = 0; k < delta; k++) len[i + k] = val;
        i += delta;
        if (val) space += delta * (32768 >> val);
    }
    return space == 32768;
}

}  // namespace

// lane_walk(in, in_len, bit_pos, out_len, meta, pre, max_pre, lens)
//
// bit_pos < 0: a first walk, from bit 0 through the stream header;
// else a resume at bit_pos (the device's end bit of the metablock
// before), with out_len output bytes so far.
// Returns 1 at a compressed metablock, 2 where the stream ends in the
// walk, 0 refused.
// meta[9]: bit0 (the metablock's first symbol bit), mlen, wbits (a
// first walk; else 0), npostfix, ndirect, dist_alpha, n_pre,
// out_prefix_len (out_len plus the uncompressed bytes passed),
// is_final.  pre[2 * max_pre]: (byte offset, length) of each
// uncompressed metablock passed.  lens[960 + 520]: the literal (256),
// command (704) and distance (dist_alpha) code lengths.
extern "C" int64_t lane_walk(const uint8_t* in, int64_t in_len,
                             int64_t bit_pos, int64_t out_len,
                             int64_t* meta, int64_t* pre, int64_t max_pre,
                             int32_t* lens) {
    Bits br{in, in_len * 8, 0, false};
    int64_t wbits = 0;
    if (bit_pos < 0) {
        if (br.read(1) == 0) {
            wbits = 16;
        } else if (int64_t n = br.read(3)) {
            wbits = 17 + n;
        } else {
            int64_t m = br.read(3);
            if (m == 1) return 0;  // the large-window header
            wbits = m == 0 ? 17 : 8 + m;
        }
        if (br.over) return 0;
    } else {
        if (bit_pos > br.nbits) return 0;
        br.pos = bit_pos;
    }
    int64_t n_pre = 0;
    for (;;) {
        uint32_t islast = br.read(1);
        if (islast && br.read(1)) {  // ISLASTEMPTY: the padding is zero
            if (br.align() != 0 || br.over) return 0;
            break;
        }
        uint32_t mnibbles = br.read(2);
        if (br.over) return 0;
        if (mnibbles == 3) {  // metadata
            if (br.read(1)) return 0;
            uint32_t mskip = br.read(2);
            int64_t skip = 0;
            if (mskip) {
                int64_t val = br.read((int)(8 * mskip));
                if (mskip > 1 && (val >> (8 * (mskip - 1))) == 0) return 0;
                skip = val + 1;
            }
            if (br.align() != 0 || br.over) return 0;
            if (br.pos + 8 * skip > br.nbits) return 0;
            br.pos += 8 * skip;
            if (islast) break;
            continue;
        }
        int64_t mlen = (int64_t)br.read((int)(16 + 4 * mnibbles)) + 1;
        if (br.over) return 0;
        if (mnibbles > 0 && ((mlen - 1) >> (16 + 4 * (mnibbles - 1))) == 0)
            return 0;
        if (!islast && br.read(1)) {  // ISUNCOMPRESSED
            if (br.align() != 0 || br.over) return 0;
            if (br.pos + 8 * mlen > br.nbits) return 0;
            if (n_pre >= max_pre) return 0;
            pre[2 * n_pre] = br.pos >> 3;
            pre[2 * n_pre + 1] = mlen;
            n_pre++;
            out_len += mlen;
            br.pos += 8 * mlen;
            continue;
        }
        // compressed: NBLTYPESL, NBLTYPESI, NBLTYPESD each 1 (a 0 bit)
        for (int k = 0; k < 3; k++)
            if (br.read(1)) return 0;
        int64_t npostfix = br.read(2);
        int64_t ndirect = (int64_t)br.read(4) << npostfix;
        br.read(2);  // the literal context mode of the one block type
        if (br.read(1) || br.read(1)) return 0;  // NTREESL, NTREESD 1
        if (br.over) return 0;
        int64_t dist_alpha = 16 + ndirect + (48 << npostfix);
        if (!read_prefix_lengths(br, 256, lens) ||
            !read_prefix_lengths(br, 704, lens + 256) ||
            !read_prefix_lengths(br, (int)dist_alpha, lens + 960))
            return 0;
        meta[0] = br.pos;
        meta[1] = mlen;
        meta[2] = wbits;
        meta[3] = npostfix;
        meta[4] = ndirect;
        meta[5] = dist_alpha;
        meta[6] = n_pre;
        meta[7] = out_len;
        meta[8] = islast;
        return 1;
    }
    meta[2] = wbits;
    meta[6] = n_pre;
    meta[7] = out_len;
    return 2;
}
