// Native hot-path helpers for the IFCB ingest/runtime layer.
//
// The reference is pure Python and pays for it on the host side (ADC CSV
// parsing with per-line str.split and a million snprintf-equivalent format
// calls per probability CSV tree). These are the measured host bottlenecks
// of the accelerator pipeline once device compute is fast, so they live in C++
// (loaded via ctypes; pure-NumPy fallbacks remain in the Python layer).
//
// Build: `make` in this directory -> libifcb_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// Number of newline-delimited rows in a buffer (trailing line without \n
// counts).
long long adc_count_rows(const char* buf, long long len) {
    long long rows = 0;
    bool in_line = false;
    for (long long i = 0; i < len; ++i) {
        if (buf[i] == '\n') {
            rows += 1;
            in_line = false;
        } else if (!in_line) {
            in_line = true;
        }
    }
    if (in_line) rows += 1;
    return rows;
}

// Parse columns 15 (ROI width), 16 (height), 17 (start byte) of every row.
// Empty rows yield zeros. Returns rows parsed, or -1 if a row has fewer
// than 18 columns.
long long adc_parse(const char* buf, long long len, long long* widths,
                    long long* heights, long long* starts,
                    long long max_rows) {
    long long row = 0;
    long long i = 0;
    while (i < len && row < max_rows) {
        // empty line
        if (buf[i] == '\n') {
            widths[row] = heights[row] = starts[row] = 0;
            ++row;
            ++i;
            continue;
        }
        // scan to column 15
        long long col = 0;
        long long field_start = i;
        long long w = 0, h = 0, s = 0;
        bool ok = false;
        while (i <= len) {
            char ch = (i < len) ? buf[i] : '\n';
            if (ch == ',' || ch == '\n' || ch == '\r') {
                if (col == 15) {
                    w = strtoll(buf + field_start, nullptr, 10);
                } else if (col == 16) {
                    h = strtoll(buf + field_start, nullptr, 10);
                } else if (col == 17) {
                    // start byte may be written with decimals
                    s = (long long)strtod(buf + field_start, nullptr);
                    ok = true;
                }
                ++col;
                field_start = i + 1;
                if (ch == '\n') {
                    ++i;
                    break;
                }
                if (ch == '\r') {
                    // swallow \r\n
                    if (i + 1 < len && buf[i + 1] == '\n') ++i;
                    ++i;
                    break;
                }
            }
            ++i;
        }
        if (!ok) return -1;
        widths[row] = w;
        heights[row] = h;
        starts[row] = s;
        ++row;
    }
    return row;
}

// One probability as "%.5f" into out (>= 16 bytes free), returning bytes
// written. Fast path: fixed-point digits from llround-style arithmetic --
// snprintf("%.5f") costs ~200 ns/value and dominated the CSV stage of the
// classify stream (measured 9.9 us/ROI at 50 classes). Bit-exactness with
// printf's correctly-rounded decimal output is preserved by construction:
// scaled = p*1e5 differs from the exact real product by < 1e-11 (1e5 is
// a power-of-two multiple of 5^5, so the product rounds once), so when
// the fractional part is more than 1e-9 away from the round-half-even
// boundary at .5 both roundings agree; inside that window -- and for
// negatives, NaN/inf, or p >= 9.99999 -- defer to snprintf itself.
static inline long long fmt_prob5(double p, char* out) {
    if (std::signbit(p) || !(p < 9.99999))
        return snprintf(out, 16, "%.5f", p);
    double scaled = p * 100000.0;
    long long q = (long long)scaled;  // truncate toward zero (p >= 0)
    double frac = scaled - (double)q;
    long long r;
    if (frac > 0.5 + 1e-9) r = q + 1;
    else if (frac < 0.5 - 1e-9) r = q;
    else return snprintf(out, 16, "%.5f", p);  // ambiguous half-way zone
    char* s = out;
    *s++ = (char)('0' + r / 100000);  // p < 10: one integer digit
    r %= 100000;
    *s++ = '.';
    s[4] = (char)('0' + r % 10); r /= 10;
    s[3] = (char)('0' + r % 10); r /= 10;
    s[2] = (char)('0' + r % 10); r /= 10;
    s[1] = (char)('0' + r % 10); r /= 10;
    s[0] = (char)('0' + r);
    return 7;
}

// Format probability CSV rows: "<roi>,<p0>,...,<pC-1>\n" with 5-decimal
// probabilities (matches Python f"{p:.5f}": glibc printf is correctly
// rounded, and fmt_prob5 defers to it wherever fixed-point rounding
// could disagree). Returns bytes written, or -1 if out_cap would
// overflow.
long long format_probs(const long long* roi_ids, const double* probs,
                       long long n, long long c, char* out,
                       long long out_cap) {
    long long pos = 0;
    for (long long i = 0; i < n; ++i) {
        if (pos + 24 + c * 8 > out_cap) return -1;
        long long roi = roi_ids[i];
        if (roi >= 0) {  // fast unsigned itoa (roi ids are 1-based)
            char tmp[20];
            int k = 0;
            do { tmp[k++] = (char)('0' + roi % 10); roi /= 10; } while (roi);
            while (k) out[pos++] = tmp[--k];
        } else {
            pos += snprintf(out + pos, (size_t)(out_cap - pos), "%lld",
                            roi);
        }
        const double* row = probs + i * c;
        for (long long j = 0; j < c; ++j) {
            out[pos++] = ',';
            pos += fmt_prob5(row[j], out + pos);
        }
        out[pos++] = '\n';
    }
    return pos;
}

// Greedy first-fit-decreasing-height shelf placement — the exact
// algorithm of sykepic_tpu_torch.ingest.shelf._Shelver.pack(), one pack call
// per invocation over the caller's pending (height, width) set:
// shelves open at the tallest pending height that fits the window's free
// rows, fill left to right preferring the tallest ROI whose width fits
// (widest-first within a height, original order on ties), windows close
// when nothing fits the leftover rows. Returns the placement count;
// out_item gets positions into the caller's arrays, out_win/out_y/out_x
// the window index and origin. The caller removes placed items and may
// call again with the compacted remainder (semantics identical to the
// Python fallback, which tests assert).
long long shelf_pack(const int* heights, const int* widths, long long n,
                     int win_h, int win_w, int max_windows,
                     long long max_slots, int* out_item, int* out_win,
                     int* out_y, int* out_x, int* out_nwin) {
    if (win_h <= 0 || win_w <= 0) return -1;
    // buckets[h] = pending item positions of height h, sorted width-desc
    // (stable: equal widths keep original order). Heights taller than the
    // window can never place; they stay pending like in the Python path.
    std::vector<std::vector<int>> buckets((size_t)win_h + 1);
    long long pending = 0;
    long long unplaceable = 0;  // taller than the window: never placed,
                                // but pending like in the Python path
    for (long long i = 0; i < n; ++i) {
        int h = heights[i];
        if (h <= 0 || widths[i] <= 0) return -1;
        if (h > win_h) {
            ++unplaceable;
            continue;
        }
        buckets[(size_t)h].push_back((int)i);
        ++pending;
    }
    for (auto& b : buckets) {
        std::stable_sort(b.begin(), b.end(), [&](int a, int c) {
            return widths[a] > widths[c];
        });
    }

    auto take = [&](int max_h, int max_w) -> int {
        for (int h = max_h; h >= 1; --h) {
            auto& b = buckets[(size_t)h];
            for (size_t k = 0; k < b.size(); ++k) {
                if (widths[b[k]] <= max_w) {
                    int item = b[k];
                    b.erase(b.begin() + (long)k);
                    --pending;
                    return item;
                }
            }
        }
        return -1;
    };

    long long count = 0;
    int win = 0;
    while (win < max_windows && pending + unplaceable > 0) {
        int free_y = 0;
        while (free_y < win_h) {
            int first = take(win_h - free_y, win_w);
            if (first < 0) break;  // nothing fits the leftover rows
            int shelf_h = heights[first];
            int x = widths[first];
            out_item[count] = first;
            out_win[count] = win;
            out_y[count] = free_y;
            out_x[count] = 0;
            ++count;
            while (x < win_w) {
                if (count >= max_slots) break;
                int nxt = take(shelf_h, win_w - x);
                if (nxt < 0) break;
                out_item[count] = nxt;
                out_win[count] = win;
                out_y[count] = free_y;
                out_x[count] = x;
                ++count;
                x += widths[nxt];
            }
            free_y += shelf_h;
            if (count >= max_slots) break;
        }
        ++win;
        if (count >= max_slots) break;
    }
    *out_nwin = win;
    return count;
}

// Mode pixel of a uint8 buffer (256-bin histogram argmax, FIRST max wins
// — the reference border-fill semantics, cv2.calcHist + argmax). Four
// interleaved sub-histograms break the increment dependency chain (the
// single-table loop stalled on store-to-load forwarding: measured ~2x
// slower on the bench mix's ~2.6 KB ROIs).
int u8_mode(const unsigned char* img, long long npix) {
    long long h0[256] = {0}, h1[256] = {0}, h2[256] = {0}, h3[256] = {0};
    long long i = 0;
    for (; i + 4 <= npix; i += 4) {
        ++h0[img[i]];
        ++h1[img[i + 1]];
        ++h2[img[i + 2]];
        ++h3[img[i + 3]];
    }
    for (; i < npix; ++i) ++h0[img[i]];
    int best = 0;
    long long best_count = -1;
    for (int v = 0; v < 256; ++v) {
        long long c = h0[v] + h1[v] + h2[v] + h3[v];
        if (c > best_count) {
            best_count = c;
            best = v;
        }
    }
    return best;
}

// Batched mode pixels: one call per emitted dispatch instead of one
// ctypes round trip per ROI (the marshalling overhead dominated the
// histogram itself at ~13 us/call).
long long u8_modes(const unsigned char* const* imgs, const int* heights,
                   const int* widths, long long n, unsigned char* out) {
    for (long long i = 0; i < n; ++i) {
        if (heights[i] <= 0 || widths[i] <= 0) return -1;
        out[i] = (unsigned char)u8_mode(
            imgs[i], (long long)heights[i] * widths[i]);
    }
    return n;
}

// Blit variably-sized uint8 ROIs into (win_h, win_w) windows at the
// placements shelf_pack produced: imgs[i] points at a C-contiguous
// (heights[i], widths[i]) array. Pure row memcpys.
long long shelf_blit(const unsigned char* const* imgs, const int* heights,
                     const int* widths, const int* win_idx, const int* y0,
                     const int* x0, long long n, unsigned char* windows,
                     int n_windows, int win_h, int win_w) {
    for (long long i = 0; i < n; ++i) {
        int h = heights[i], w = widths[i];
        if (win_idx[i] < 0 || win_idx[i] >= n_windows || y0[i] < 0 ||
            x0[i] < 0 || y0[i] + h > win_h || x0[i] + w > win_w) {
            return -1;
        }
        unsigned char* dst = windows +
            ((long long)win_idx[i] * win_h + y0[i]) * win_w + x0[i];
        const unsigned char* src = imgs[i];
        for (int r = 0; r < h; ++r) {
            std::memcpy(dst + (long long)r * win_w, src + (long long)r * w,
                        (size_t)w);
        }
    }
    return n;
}

// Columnar twin of shelf_blit + u8_modes: ROI i's pixels live
// C-contiguously at bases[buf_idx[i]] + offsets[i] (the decoded .roi
// payload is one flat buffer per sample — sykepic_tpu_torch/ingest/ifcb.py), so
// the blit and the mode histogram read straight out of the decode buffer
// with no per-ROI Python objects or pointer marshalling at all. When
// `modes` is non-null each ROI's mode pixel is computed in the same pass,
// while its bytes are cache-hot from the copy.
long long shelf_blit_blocks(const unsigned char* const* bases,
                            const int* buf_idx, const long long* offsets,
                            const int* heights, const int* widths,
                            const int* win_idx, const int* y0, const int* x0,
                            long long n, long long n_bases,
                            unsigned char* windows, int n_windows,
                            int win_h, int win_w, unsigned char* modes) {
    for (long long i = 0; i < n; ++i) {
        int h = heights[i], w = widths[i];
        if (buf_idx[i] < 0 || buf_idx[i] >= n_bases || offsets[i] < 0 ||
            win_idx[i] < 0 || win_idx[i] >= n_windows || y0[i] < 0 ||
            x0[i] < 0 || y0[i] + h > win_h || x0[i] + w > win_w) {
            return -1;
        }
        const unsigned char* src = bases[buf_idx[i]] + offsets[i];
        unsigned char* dst = windows +
            ((long long)win_idx[i] * win_h + y0[i]) * win_w + x0[i];
        for (int r = 0; r < h; ++r) {
            std::memcpy(dst + (long long)r * win_w, src + (long long)r * w,
                        (size_t)w);
        }
        if (modes) modes[i] = (unsigned char)u8_mode(src, (long long)h * w);
    }
    return n;
}

// Undo the PNG row filters (RFC 2083, section 6): `raw` holds h rows of a
// filter byte then `stride` bytes, `bpp` bytes a pixel; `out` receives the
// h * stride reconstructed bytes. Average and Paeth need each byte's
// reconstructed left neighbour, a chain NumPy cannot vectorise along a row
// (the twin in sykepic_tpu_torch/utils/png.py loops in Python). Returns h,
// or -(y + 1) when row y names an unknown filter.
long long png_unfilter(const unsigned char* raw, long long h,
                       long long stride, int bpp, unsigned char* out) {
    for (long long y = 0; y < h; ++y) {
        const unsigned char* src = raw + y * (stride + 1) + 1;
        unsigned char* cur = out + y * stride;
        const unsigned char* prev = y ? cur - stride : nullptr;
        switch (raw[y * (stride + 1)]) {
        case 0:
            std::memcpy(cur, src, (size_t)stride);
            break;
        case 1:  // Sub
            for (long long i = 0; i < stride; ++i)
                cur[i] = (unsigned char)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:  // Up
            for (long long i = 0; i < stride; ++i)
                cur[i] = (unsigned char)(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:  // Average
            for (long long i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                cur[i] = (unsigned char)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (long long i = 0; i < stride; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                int p = a + b - c;
                int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = (unsigned char)(src[i] + pred);
            }
            break;
        default:
            return -(y + 1);
        }
    }
    return h;
}

// Lossless wire codec encoder (the C++ twin of wirecodec.encode's NumPy
// path; byte-for-byte identical output, asserted in tests/test_wirecodec.py).
// Per window: pick the predictor with fewest 4-bit exceptions — vertical
// (0), horizontal (1), or gradient left+up-upleft (2; decoded by chained
// cumsums) — pack deltas mod 16 into a nibble plane, and emit mod-256
// residual exceptions as single bytes (advance<<4 | residual>>4; zero low
// nibble = dummy advancing 15x) in global scan order. Returns the entry
// count, or -2 when it exceeds `cap` (the caller's payoff bound: content
// this noisy ships raw anyway), -1 on bad arguments.
long long wire_encode(const unsigned char* windows, int nc, int h, int w,
                      unsigned char* plane, unsigned char* flags,
                      unsigned char* exc, long long cap) {
    if (nc <= 0 || h <= 0 || w <= 0 || (w & 1)) return -1;
    const long long win_px = (long long)h * w;
    // Branch-free inner loops (the compiler vectorizes them; the scalar
    // two-pass original measured 53 us/ROI on the bench mix — the single
    // biggest host cost of the whole pipeline on a 1-core host). Residuals
    // land in a scratch plane first; exceptions are then found by scanning
    // 8 bytes at a time (>90% of residual bytes are zero at the measured
    // ~9% exception rate, so most words skip in one compare).
    std::vector<unsigned char> zrow((size_t)w, 0);
    std::vector<unsigned char> res((size_t)win_px + 8, 0);
    std::vector<unsigned char> nibs((size_t)w, 0);
    long long n_entries = 0;
    long long last_pos = -1;
    for (int k = 0; k < nc; ++k) {
        const unsigned char* win = windows + (long long)k * win_px;
        // pass 1: exception counts under each predictor (vectorizable:
        // d in [-510,518] after +8; unsigned compare catches both tails)
        long long nv = 0, nh = 0, ng = 0;
        for (int r = 0; r < h; ++r) {
            const unsigned char* row = win + (long long)r * w;
            const unsigned char* up = r ? row - w : zrow.data();
            int cv = (unsigned)(row[0] - up[0] + 8) > 15u;
            int ch = (unsigned)(row[0] + 8) > 15u;
            int cg = (unsigned)(row[0] - up[0] + 8) > 15u;
            for (int c = 1; c < w; ++c)
                cv += (unsigned)(row[c] - up[c] + 8) > 15u;
            for (int c = 1; c < w; ++c)
                ch += (unsigned)(row[c] - row[c - 1] + 8) > 15u;
            for (int c = 1; c < w; ++c)
                cg += (unsigned)(row[c] - row[c - 1] - up[c] + up[c - 1]
                                 + 8) > 15u;
            nv += cv;
            nh += ch;
            ng += cg;
        }
        // tie-break = first min in (v, h, g) order, matching the NumPy
        // twin's np.argmin over the stacked counts
        int mode = 0;
        long long best = nv;
        if (nh < best) { best = nh; mode = 1; }
        if (ng < best) { best = ng; mode = 2; }
        flags[k] = (unsigned char)mode;
        // exceptions alone already exceed the cap: no dummy-entry count
        // can shrink it, so the noisy-content abort fires without pass 2
        if (n_entries + best > cap) return -2;
        // pass 2: nibble plane + residual scratch, branch-free
        unsigned char* pl = plane + (long long)k * h * (w / 2);
        for (int r = 0; r < h; ++r) {
            const unsigned char* row = win + (long long)r * w;
            unsigned char* rr = res.data() + (long long)r * w;
            unsigned char* nb = nibs.data();
            if (mode == 1) {
                int d0 = row[0];
                nb[0] = (unsigned char)(d0 & 15);
                rr[0] = (unsigned char)((d0 - ((d0 & 15) -
                         (((d0 & 15) > 7) << 4))) & 255);
                for (int c = 1; c < w; ++c) {
                    int d = row[c] - row[c - 1];
                    int n = d & 15;
                    nb[c] = (unsigned char)n;
                    rr[c] = (unsigned char)((d - (n - ((n > 7) << 4))) & 255);
                }
            } else if (mode == 2) {
                const unsigned char* up = r ? row - w : zrow.data();
                int d0 = row[0] - up[0];
                nb[0] = (unsigned char)(d0 & 15);
                rr[0] = (unsigned char)((d0 - ((d0 & 15) -
                         (((d0 & 15) > 7) << 4))) & 255);
                for (int c = 1; c < w; ++c) {
                    int d = row[c] - row[c - 1] - up[c] + up[c - 1];
                    int n = d & 15;
                    nb[c] = (unsigned char)n;
                    rr[c] = (unsigned char)((d - (n - ((n > 7) << 4))) & 255);
                }
            } else {
                const unsigned char* up = r ? row - w : zrow.data();
                for (int c = 0; c < w; ++c) {
                    int d = row[c] - up[c];
                    int n = d & 15;
                    nb[c] = (unsigned char)n;
                    rr[c] = (unsigned char)((d - (n - ((n > 7) << 4))) & 255);
                }
            }
            unsigned char* prow = pl + (long long)r * (w / 2);
            for (int c = 0; c < w / 2; ++c)
                prow[c] = (unsigned char)(nb[2 * c] | (nb[2 * c + 1] << 4));
        }
        // pass 3: word-scan the residual plane for the exception stream.
        // Entry byte = advance<<4 | residual>>4 (residuals are multiples
        // of 16); a zero low nibble is a dummy whose advance counts 15x.
        // Gap decomposition: final advance rem in [1,15], the remaining
        // (gap-1)/15 units of 15 px ride dummies of <= 15 units each —
        // the group's first dummy carries the partial, the rest are full.
        const long long base = (long long)k * win_px;
        const long long nwords = win_px / 8;
        for (long long i = 0; i < nwords; ++i) {
            unsigned long long v;
            std::memcpy(&v, res.data() + i * 8, 8);
            if (!v) continue;
            for (int b = 0; b < 8; ++b) {
                const unsigned char rv = (unsigned char)(v >> (8 * b));
                if (!rv) continue;
                const long long pos = base + i * 8 + b;
                const long long gap = pos - last_pos;
                long long units = (gap - 1) / 15;
                const int rem = (int)(gap - 15 * units);
                const long long nd = (units + 14) / 15;
                if (n_entries + nd + 1 > cap) return -2;
                if (nd) {
                    for (long long j = 1; j < nd; ++j)
                        exc[n_entries++] = 0xF0;
                    const int part = (int)(units - 15 * (nd - 1));
                    exc[n_entries++] = (unsigned char)(part << 4);
                }
                exc[n_entries++] = (unsigned char)((rem << 4) | (rv >> 4));
                last_pos = pos;
            }
        }
        for (long long p = nwords * 8; p < win_px; ++p) {
            const unsigned char rv = res[p];
            if (!rv) continue;
            const long long pos = base + p;
            const long long gap = pos - last_pos;
            long long units = (gap - 1) / 15;
            const int rem = (int)(gap - 15 * units);
            const long long nd = (units + 14) / 15;
            if (n_entries + nd + 1 > cap) return -2;
            if (nd) {
                for (long long j = 1; j < nd; ++j)
                    exc[n_entries++] = 0xF0;
                const int part = (int)(units - 15 * (nd - 1));
                exc[n_entries++] = (unsigned char)(part << 4);
            }
            exc[n_entries++] = (unsigned char)((rem << 4) | (rv >> 4));
            last_pos = pos;
        }
    }
    return n_entries;
}

}  // extern "C"
