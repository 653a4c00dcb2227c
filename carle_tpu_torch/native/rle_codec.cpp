// Native RLE codec — the host-side hot path of episode logging.
//
// When logging is enabled the env encodes BOTH the action and the universe to
// RLE every step (reference env.py:194-204 does this with a per-cell Python
// loop, O(H*W) interpreter work per step).  This codec does the same
// byte-compatible encoding (explicit run counts, '$' row terminators,
// 69-char line wrap, always-flushed tail — see rle.py) in a single pass over
// the grid, and the matching decoder.  Bound by ctypes in
// native/__init__.py, which builds it at first use (g++ -O3 -fPIC -shared
// -std=c++17); native.NATIVE = False selects the numpy codec instead.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Encode an h*w 0/1 grid into RLE body text (no header, terminated by '!').
// Returns the number of bytes written, or -1 if out_cap is too small.
// wrap: emit '\n' once a line exceeds this many chars (reference uses 69).
int rle_encode(const uint8_t* grid, int h, int w, int wrap,
               char* out, long out_cap) {
    long pos = 0;
    int line_len = 0;
    // worst case per run: "255o" ~ 12 bytes; guard conservatively inside loop
    for (int r = 0; r < h; ++r) {
        const uint8_t* row = grid + (long)r * w;
        int c = 0;
        while (c < w) {
            uint8_t v = row[c] != 0;
            int run = 1;
            while (c + run < w && (row[c + run] != 0) == v) ++run;
            if (pos + 16 >= out_cap) return -1;
            int n = snprintf(out + pos, out_cap - pos, "%d%c", run,
                             v ? 'o' : 'b');
            pos += n;
            line_len += n;
            if (line_len > wrap) {
                out[pos++] = '\n';
                line_len = 0;
            }
            c += run;
        }
        if (pos + 4 >= out_cap) return -1;
        out[pos++] = '$';
        ++line_len;
        if (line_len > wrap) {
            out[pos++] = '\n';
            line_len = 0;
        }
    }
    if (pos + 4 >= out_cap) return -1;
    if (line_len > 0) out[pos++] = '\n';
    out[pos++] = '!';
    return (int)pos;
}

// Decode an RLE body (header-free text, '!'-terminated) into an h*w grid.
// Semantics match rle.py decode_body: digits accumulate a count, 'b'/'o'
// are dead/alive runs, '$' advances rows, everything else ignored; content
// outside bounds is clipped.  Returns rows consumed.
int rle_decode(const char* body, long len, uint8_t* grid, int h, int w) {
    memset(grid, 0, (long)h * w);
    long row = 0, col = 0;
    long count = 0;
    bool have_count = false;
    // clamp ceiling: larger than any grid extent, small enough that the
    // row/col adds below can never overflow — hostile/corrupt counts
    // (e.g. "2147483648$") must clip like every other out-of-bounds
    // content, never wrap to negative offsets (heap OOB)
    const long kMaxRun = 1L << 40;
    for (long i = 0; i < len; ++i) {
        char ch = body[i];
        if (ch >= '0' && ch <= '9') {
            if (count < kMaxRun) count = count * 10 + (ch - '0');
            have_count = true;
        } else if (ch == 'b' || ch == 'B' || ch == 'o' || ch == 'O') {
            long run = have_count ? count : 1;
            if (run > kMaxRun) run = kMaxRun;
            if ((ch == 'o' || ch == 'O') && row < h && col < w) {
                long end = col + run;
                if (end > w) end = w;
                for (long c = col; c < end; ++c) grid[row * w + c] = 1;
            }
            col += run;
            if (col > w) col = w;  // further content this row clips anyway
            count = 0;
            have_count = false;
        } else if (ch == '$') {
            long run = have_count ? count : 1;
            if (run > kMaxRun) run = kMaxRun;
            row += run;
            if (row > h) row = h;  // rows beyond the grid clip
            col = 0;
            count = 0;
            have_count = false;
        } else if (ch == '!') {
            break;
        }
        // newlines / stray characters ignored
    }
    return (int)row;
}

}  // extern "C"
