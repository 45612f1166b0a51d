// COCO-compatible run-length encoding ops (native runtime component).
//
// The reference depends on pycocotools' C extension for mask RLE
// encode/decode/IoU in its emitters and evaluators
// (reference: inference_video_entity.py:945, inference/comm.py:119,
// evaluation/ytvis_eval via vendored ytvis_api).  This file provides
// the same functionality from the public COCO RLE spec:
//   - masks are column-major (Fortran) binary arrays;
//   - counts alternate runs of 0s/1s starting with 0s;
//   - the string form encodes each count as base-32 LEB-style chars
//     (5 payload bits + continuation bit, offset by 48), with counts
//     delta-coded against counts[i-2].
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -o librle.so rle.cpp

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major binary mask (h*w bytes, 0/1) into the COCO
// char encoding. out must have capacity >= 6*h*w+1. Returns length.
int rle_encode(const uint8_t* mask, int h, int w, char* out) {
    std::vector<int64_t> cnts;
    cnts.reserve(h * w / 4 + 8);
    int64_t n = (int64_t)h * w;
    uint8_t prev = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != prev) {
            cnts.push_back(run);
            run = 0;
            prev = v;
        }
        ++run;
    }
    cnts.push_back(run);

    int p = 0;
    for (size_t i = 0; i < cnts.size(); ++i) {
        int64_t x = cnts[i];
        if (i > 2) x -= cnts[i - 2];
        bool more = true;
        while (more) {
            int c = (int)(x & 0x1f);
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            c += 48;
            out[p++] = (char)c;
        }
    }
    out[p] = '\0';
    return p;
}

// Decode a COCO char encoding into a column-major binary mask buffer
// (h*w bytes). Returns 0 on success, -1 on overflow.
int rle_decode(const char* s, int h, int w, uint8_t* mask) {
    int64_t n = (int64_t)h * w;
    std::memset(mask, 0, n);
    int64_t pos = 0;
    uint8_t v = 0;
    size_t p = 0;
    std::vector<int64_t> cnts;
    while (s[p]) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            int c = s[p] - 48;
            if (s[p] == '\0') return -1;
            x |= (int64_t)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (cnts.size() > 2) x += cnts[cnts.size() - 2];
        cnts.push_back(x);
    }
    for (size_t i = 0; i < cnts.size(); ++i) {
        int64_t cnt = cnts[i];
        if (pos + cnt > n) {
            cnt = n - pos;
        }
        if (v) std::memset(mask + pos, 1, cnt);
        pos += cnt;
        v = 1 - v;
        if (pos >= n) break;
    }
    return 0;
}

// Area of an encoded mask (sum of odd runs).
int64_t rle_area(const char* s) {
    std::vector<int64_t> cnts;
    size_t p = 0;
    while (s[p]) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            int c = s[p] - 48;
            x |= (int64_t)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (cnts.size() > 2) x += cnts[cnts.size() - 2];
        cnts.push_back(x);
    }
    int64_t area = 0;
    for (size_t i = 1; i < cnts.size(); i += 2) area += cnts[i];
    return area;
}

static void decode_counts(const char* s, std::vector<int64_t>& cnts) {
    size_t p = 0;
    while (s[p]) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            int c = s[p] - 48;
            x |= (int64_t)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (cnts.size() > 2) x += cnts[cnts.size() - 2];
        cnts.push_back(x);
    }
}

// Run-based intersection of two encoded masks of the same h*w.
int64_t rle_intersection(const char* a, const char* b) {
    std::vector<int64_t> ca, cb;
    decode_counts(a, ca);
    decode_counts(b, cb);
    size_t ia = 0, ib = 0;
    int64_t pa = 0, pb = 0;  // absolute end positions of current runs
    uint8_t va = 0, vb = 0;
    int64_t inter = 0;
    int64_t pos = 0;
    if (ia < ca.size()) pa = ca[0];
    if (ib < cb.size()) pb = cb[0];
    while (ia < ca.size() && ib < cb.size()) {
        int64_t end = pa < pb ? pa : pb;
        if (va && vb) inter += end - pos;
        pos = end;
        if (pa == end) {
            ++ia;
            va = 1 - va;
            if (ia < ca.size()) pa += ca[ia];
        }
        if (pb == end) {
            ++ib;
            vb = 1 - vb;
            if (ib < cb.size()) pb += cb[ib];
        }
    }
    return inter;
}

}  // extern "C"
