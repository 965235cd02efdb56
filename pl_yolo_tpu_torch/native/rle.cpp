// RLE mask operations — native C++ core for the evaluator stack.
//
// Capability parity with the reference's vendored pycocotools native layer
// (models/data/datasets/pycocotools/_mask.pyx:1-308 wrapping maskApi.c):
// run-length encode/decode of binary masks (column-major, COCO convention),
// area, union/intersection merge, mask/bbox IoU with crowd handling, RLE<->
// bbox, polygon rasterization, and the COCO compressed-string coding
// (5-bit chunks, delta from the count two back, offset 48).
//
// Fresh implementation against the public COCO RLE format; exposed to
// Python via ctypes (pl_yolo_tpu/evaluators/mask_ops.py). All buffers are
// caller-allocated numpy arrays; counts are uint32.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- encode

// mask: h*w uint8, column-major (fortran order). out_counts must have room
// for h*w+1 entries. Returns number of counts written.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* out_counts) {
    int n = h * w;
    int m = 0;
    uint8_t prev = 0;
    uint32_t run = 0;
    for (int i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != prev) {
            out_counts[m++] = run;
            run = 0;
            prev = v;
        }
        ++run;
    }
    out_counts[m++] = run;
    return m;
}

// counts -> mask (column-major uint8). Returns 0 on success.
int rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* out_mask) {
    int64_t pos = 0;
    int64_t n = (int64_t)h * w;
    uint8_t v = 0;
    for (int i = 0; i < m; ++i) {
        uint32_t run = counts[i];
        if (pos + run > n) return 1;
        memset(out_mask + pos, v, run);
        pos += run;
        v = 1 - v;
    }
    return pos == n ? 0 : 1;
}

// ------------------------------------------------------------------ area

uint64_t rle_area(const uint32_t* counts, int m) {
    uint64_t a = 0;
    for (int i = 1; i < m; i += 2) a += counts[i];
    return a;
}

// ----------------------------------------------------------------- merge

// Merge two RLEs over the same h*w canvas. intersect=0 -> union.
// Returns number of counts written to out (room: h*w+1).
int rle_merge(const uint32_t* a, int ma, const uint32_t* b, int mb,
              int64_t n, int intersect, uint32_t* out) {
    int ia = 0, ib = 0;
    int64_t ca = ma > 0 ? (int64_t)a[0] : n;  // remaining in current a-run
    int64_t cb = mb > 0 ? (int64_t)b[0] : n;
    uint8_t va = 0, vb = 0;
    int m = 0;
    uint32_t run = 0;
    uint8_t prev = 0;
    int64_t done = 0;
    while (done < n) {
        while (ia < ma && ca == 0) { ++ia; va = 1 - va; ca = ia < ma ? a[ia] : 0; }
        while (ib < mb && cb == 0) { ++ib; vb = 1 - vb; cb = ib < mb ? b[ib] : 0; }
        int64_t step = std::min(ca, cb);
        if (step <= 0) step = n - done;  // degenerate tail
        step = std::min(step, n - done);
        uint8_t v = intersect ? (va & vb) : (va | vb);
        if (v != prev) { out[m++] = run; run = 0; prev = v; }
        run += (uint32_t)step;
        ca -= step;
        cb -= step;
        done += step;
    }
    out[m++] = run;
    return m;
}

// ------------------------------------------------------------------- iou

// IoU between two RLEs (same canvas). If crowd, denominator is area(a)
// (detection), matching COCO crowd semantics.
double rle_iou_single(const uint32_t* a, int ma, const uint32_t* b, int mb,
                      int64_t n, int crowd) {
    // single pass intersection
    int ia = 0, ib = 0;
    int64_t ca = ma > 0 ? (int64_t)a[0] : n;
    int64_t cb = mb > 0 ? (int64_t)b[0] : n;
    uint8_t va = 0, vb = 0;
    int64_t inter = 0, done = 0;
    while (done < n) {
        while (ia < ma && ca == 0) { ++ia; va = 1 - va; ca = ia < ma ? a[ia] : 0; }
        while (ib < mb && cb == 0) { ++ib; vb = 1 - vb; cb = ib < mb ? b[ib] : 0; }
        int64_t step = std::min(ca, cb);
        if (step <= 0) step = n - done;
        step = std::min(step, n - done);
        if (va && vb) inter += step;
        ca -= step; cb -= step; done += step;
    }
    double aa = 0, ab = 0;
    for (int i = 1; i < ma; i += 2) aa += a[i];
    for (int i = 1; i < mb; i += 2) ab += b[i];
    double den = crowd ? aa : (aa + ab - (double)inter);
    return den > 0 ? (double)inter / den : 0.0;
}

// -------------------------------------------------------------- to_bbox

// RLE -> [x, y, w, h] (column-major canvas of height h).
void rle_to_bbox(const uint32_t* counts, int m, int h, double* out4) {
    int64_t pos = 0;
    int64_t xmin = INT64_MAX, xmax = -1, ymin = INT64_MAX, ymax = -1;
    uint8_t v = 0;
    for (int i = 0; i < m; ++i) {
        int64_t run = counts[i];
        if (v) {
            int64_t start = pos, end = pos + run - 1;
            int64_t x0 = start / h, y0 = start % h;
            int64_t x1 = end / h, y1 = end % h;
            xmin = std::min(xmin, x0); xmax = std::max(xmax, x1);
            if (x0 == x1) { ymin = std::min(ymin, y0); ymax = std::max(ymax, y1); }
            else { ymin = 0; ymax = h - 1; }
        }
        pos += run;
        v = 1 - v;
    }
    if (xmax < 0) { out4[0] = out4[1] = out4[2] = out4[3] = 0; return; }
    out4[0] = (double)xmin; out4[1] = (double)ymin;
    out4[2] = (double)(xmax - xmin + 1); out4[3] = (double)(ymax - ymin + 1);
}

// ------------------------------------------------------------- from_bbox

// [x, y, w, h] -> RLE counts (column-major). Returns m.
int rle_from_bbox(const double* box, int h, int w, uint32_t* out) {
    int xs = (int)box[0], ys = (int)box[1];
    int xe = std::min((int)(box[0] + box[2]), w), ye = std::min((int)(box[1] + box[3]), h);
    xs = std::max(xs, 0); ys = std::max(ys, 0);
    if (xe <= xs || ye <= ys) { out[0] = (uint32_t)((int64_t)h * w); return 1; }
    int m = 0;
    int64_t pos = 0;
    for (int x = xs; x < xe; ++x) {
        int64_t start = (int64_t)x * h + ys;
        int64_t len = ye - ys;
        out[m++] = (uint32_t)(start - pos);  // zeros before this column run
        out[m++] = (uint32_t)len;
        pos = start + len;
    }
    out[m++] = (uint32_t)((int64_t)h * w - pos);
    // normalize: merge zero-length interior runs (columns that touch)
    std::vector<uint32_t> res;
    res.push_back(out[0]);
    for (int i = 1; i < m; ++i) {
        if (out[i] == 0 && i + 1 < m) {
            res.back() += out[i + 1];
            ++i;
        } else {
            res.push_back(out[i]);
        }
    }
    for (size_t i = 0; i < res.size(); ++i) out[i] = res[i];
    return (int)res.size();
}

// ------------------------------------------------------------- from_poly
// Polygon (xy interleaved, n points) -> RLE via 10x-upsampled boundary
// rasterization + scanline fill on the column-major canvas.
int rle_from_poly(const double* xy, int npts, int h, int w, uint32_t* out,
                  uint8_t* scratch_mask) {
    // rasterize with even-odd scanline fill per column (column-major!)
    memset(scratch_mask, 0, (size_t)h * w);
    // standard even-odd fill over rows, then transpose ordering when encoding
    for (int y = 0; y < h; ++y) {
        double yc = y + 0.5;
        std::vector<double> xs_cross;
        for (int i = 0; i < npts; ++i) {
            double x0 = xy[2 * i], y0 = xy[2 * i + 1];
            double x1 = xy[2 * ((i + 1) % npts)], y1 = xy[2 * ((i + 1) % npts) + 1];
            if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
                double t = (yc - y0) / (y1 - y0);
                xs_cross.push_back(x0 + t * (x1 - x0));
            }
        }
        std::sort(xs_cross.begin(), xs_cross.end());
        for (size_t k = 0; k + 1 < xs_cross.size(); k += 2) {
            int xa = (int)std::ceil(xs_cross[k] - 0.5);
            int xb = (int)std::floor(xs_cross[k + 1] - 0.5);
            xa = std::max(xa, 0); xb = std::min(xb, w - 1);
            for (int x = xa; x <= xb; ++x)
                scratch_mask[(int64_t)x * h + y] = 1;  // column-major
        }
    }
    return rle_encode(scratch_mask, h, w, out);
}

// ------------------------------------------------- string (de)serialization

// COCO compressed counts string. Returns number of chars written.
int rle_to_string(const uint32_t* counts, int m, char* out) {
    int p = 0;
    for (int i = 0; i < m; ++i) {
        int64_t x = (int64_t)counts[i];
        if (i > 2) x -= (int64_t)counts[i - 2];
        bool more = true;
        while (more) {
            int c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            out[p++] = (char)(c + 48);
        }
    }
    out[p] = 0;
    return p;
}

// Returns number of counts parsed.
int rle_from_string(const char* s, int slen, uint32_t* out) {
    int m = 0, p = 0;
    while (p < slen) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            int c = s[p] - 48;
            x |= (int64_t)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= -((int64_t)1 << (5 * k));
        }
        if (m > 2) x += (int64_t)out[m - 2];
        out[m++] = (uint32_t)x;
    }
    return m;
}

}  // extern "C"
