// Native GIF-variant LZW encoder for episode-animation artifacts.
//
// The pure-Python encoder (utils/gif.py:_lzw_encode_py) walks the
// pixel stream through a dict of tuples — fine for small demos, but a
// 256x256x500-frame episode GIF is ~33M pixels of Python-loop work.  This
// is the same algorithm with a flat prefix-tree (child[code][symbol]):
// byte-identical output (tests/test_torch_io.py holds the two).
// Semantics replicated exactly from Python:
//   * variable code width starting at min_code_size+1, bumped when
//     next_code > (1 << width) while width < 12;
//   * CLEAR emitted up-front and on table reset at next_code >= 4096;
//   * LSB-first bit packing, final partial byte flushed.
//
// Built by native/__init__.py at first use (g++ -O3 -fPIC -shared
// -std=c++17); native.NATIVE = False selects the Python loop instead.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" long gif_lzw_encode(const uint8_t* idx, long n, int min_code_size,
                               uint8_t* out, long cap) {
    if (min_code_size < 2 || min_code_size > 8 || n < 0) return -1;
    const int clear = 1 << min_code_size;
    const int end_code = clear + 1;

    long pos = 0;
    uint32_t bitbuf = 0;
    int nbits = 0;
    bool overflow = false;
    auto emit = [&](int code, int width) {
        bitbuf |= static_cast<uint32_t>(code) << nbits;
        nbits += width;
        while (nbits >= 8) {
            if (pos >= cap) { overflow = true; return; }
            out[pos++] = static_cast<uint8_t>(bitbuf & 0xFF);
            bitbuf >>= 8;
            nbits -= 8;
        }
    };

    // child[prefix_code * 256 + symbol] = extension code, -1 if absent
    std::vector<int16_t> child(static_cast<size_t>(4096) * 256, -1);
    int next_code = end_code + 1;
    int width = min_code_size + 1;
    emit(clear, width);

    int prefix = -1;
    for (long i = 0; i < n && !overflow; ++i) {
        const int pix = idx[i];
        if (pix >= clear) return -2;  // index exceeds the palette
        if (prefix < 0) { prefix = pix; continue; }
        int16_t& c = child[static_cast<size_t>(prefix) * 256 + pix];
        if (c >= 0) { prefix = c; continue; }
        emit(prefix, width);
        c = static_cast<int16_t>(next_code);
        ++next_code;
        if (next_code > (1 << width) && width < 12) ++width;
        if (next_code >= 4096) {
            emit(clear, width);
            std::fill(child.begin(), child.end(), static_cast<int16_t>(-1));
            next_code = end_code + 1;
            width = min_code_size + 1;
        }
        prefix = pix;
    }
    if (prefix >= 0) emit(prefix, width);
    emit(end_code, width);
    if (nbits > 0 && !overflow) {
        if (pos >= cap) overflow = true;
        else out[pos++] = static_cast<uint8_t>(bitbuf & 0xFF);
    }
    return overflow ? -1 : pos;
}
