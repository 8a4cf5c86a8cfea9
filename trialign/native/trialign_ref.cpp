// Native CPU reference engine for three-sequence affine-gap alignment.
//
// The reference repo's software model was never committed (its .gitignore
// excludes *.py); this is the framework's native equivalent: a C++
// implementation of the same 7-matrix 3-D DP the RTL computes
// (reference: src/PE_1cyc.v:163-218), used as an independent oracle for the
// device kernels and as the "software" column of the speedup table
// (reference: pic/Result.png).
//
// Memory: two (7, |B|+1, |C|+1) slabs (previous and current i), i.e. the
// same O(n^2) working set as the hardware's boundary SRAMs.
//
// Build: g++ -O3 -march=native -shared -fPIC (see build.py).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int NM = 7;  // M, Ix, Iy, Iz, Ixy, Iyz, Ixz
// consumes[t] = {A, B, C}
constexpr int CONSUMES[NM][3] = {
    {1, 1, 1}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 1, 0}, {0, 1, 1}, {1, 0, 1},
};

struct Params {
    int32_t match, mismatch, go, ge;
    bool sop;  // true: sum-of-pairs S3; false: RTL quirk S3
    // Optional runtime substitution matrix: (256, 256) row-major lookup
    // covering the full symbol space (pads score the clamped floor --
    // built by Scoring.sub_lookup()); nullptr = equality scoring.  The
    // testbench's planned-never-wired score ports,
    // reference: src/TriAlign_tb.sv:220-224,280-290.
    const int32_t* lut = nullptr;
};

inline int32_t pair_score(const Params& p, uint8_t x, uint8_t y) {
    if (p.lut) return p.lut[static_cast<int32_t>(x) * 256 + y];
    return x == y ? p.match : p.mismatch;
}

inline int32_t s3_score(const Params& p, uint8_t a, uint8_t b, uint8_t c) {
    if (p.sop)
        return pair_score(p, a, b) + pair_score(p, b, c) + pair_score(p, a, c);
    // RTL quirk (src/PE_1cyc.v:162): keyed on a==b then b==c.
    if (a == b) return b == c ? 3 * p.match : 2 * (p.match + p.mismatch);
    return 3 * p.mismatch;
}

// Optimal alignment score; zero borders, final max over the 7 matrices at
// (|A|, |B|, |C|).
int32_t score_impl(const uint8_t* a, int32_t la, const uint8_t* b,
                   int32_t lb, const uint8_t* c, int32_t lc,
                   const Params& p) {
    if (la <= 0 || lb <= 0 || lc <= 0) return 0;

    // Transition weights W[t][s] from the consume-set rule (the 49 wired
    // constants of the PE datapath).
    int32_t w[NM][NM];
    for (int t = 0; t < NM; ++t)
        for (int s = 0; s < NM; ++s) {
            int32_t charge = 0;
            for (int ax = 0; ax < 3; ++ax)
                if (!CONSUMES[t][ax]) charge += CONSUMES[s][ax] ? p.go : p.ge;
            w[t][s] = -charge;
        }

    // Array-of-structs slabs: 8 int32 per cell (7 matrices + pad) so each
    // target's 7-way max reads one contiguous 32-byte cell vector -- the
    // layout the compiler can SIMD.
    constexpr int CS = 8;
    const int64_t W1 = lc + 1;
    const int64_t plane = static_cast<int64_t>(lb + 1) * W1;
    std::vector<int32_t> prev(plane * CS, 0), cur(plane * CS, 0);

    for (int i = 1; i <= la; ++i) {
        std::fill(cur.begin(), cur.end(), 0);
        const uint8_t ai = a[i - 1];
        for (int j = 1; j <= lb; ++j) {
            const uint8_t bj = b[j - 1];
            const int32_t s_ab = pair_score(p, ai, bj);
            const int32_t* pv = prev.data();
            int32_t* cv = cur.data();
            const int64_t row = j * W1;
            for (int k = 1; k <= lc; ++k) {
                const uint8_t ck = c[k - 1];
                const int32_t* v_p11 = pv + (row - W1 + k - 1) * CS;  // prev (j-1,k-1)
                const int32_t* v_p00 = pv + (row + k) * CS;           // prev (j,  k)
                const int32_t* v_p10 = pv + (row - W1 + k) * CS;      // prev (j-1,k)
                const int32_t* v_p01 = pv + (row + k - 1) * CS;       // prev (j,  k-1)
                const int32_t* v_c10 = cv + (row - W1 + k) * CS;      // cur  (j-1,k)
                const int32_t* v_c01 = cv + (row + k - 1) * CS;       // cur  (j,  k-1)
                const int32_t* v_c11 = cv + (row - W1 + k - 1) * CS;  // cur  (j-1,k-1)
                const int32_t* pred[NM] = {v_p11, v_p00, v_c10, v_c01,
                                           v_p10, v_c11, v_p01};
                int32_t subs[NM];
                subs[0] = s3_score(p, ai, bj, ck);
                subs[1] = subs[2] = subs[3] = 0;
                subs[4] = s_ab;
                subs[5] = pair_score(p, bj, ck);
                subs[6] = pair_score(p, ai, ck);
                int32_t* out = cv + (row + k) * CS;
                for (int t = 0; t < NM; ++t) {
                    const int32_t* src = pred[t];
                    const int32_t* wt = w[t];
                    int32_t best = src[0] + wt[0];
                    for (int s = 1; s < NM; ++s)
                        best = std::max(best, src[s] + wt[s]);
                    out[t] = best + subs[t];
                }
            }
        }
        std::swap(prev, cur);
    }

    const int32_t* lastv = prev.data() + (static_cast<int64_t>(lb) * W1 + lc) * CS;
    int32_t best = lastv[0];
    for (int t = 1; t < NM; ++t) best = std::max(best, lastv[t]);
    return best;
}

// Full alignment: score plus one optimal action sequence (the capability
// the reference RTL stubbed out -- its per-PE traceback `act` outputs and
// action memory are commented out, reference: src/PE_1cyc.v:12-14,30).
//
// A choice-capture DP: per cell the argmax source matrix of each of the 7
// targets packs into 3x7 = 21 bits of one uint32 (same encoding as the
// device direct engine, trialign/traceback/direct.py), then a pointer chase
// from (|A|, |B|, |C|) emits matrix indices newest-first.  Free-start
// semantics match the golden model: zero borders, the walk stops at the
// first border cell, callers prepend the unscored leading context.
//
// actions: caller buffer of capacity >= la + lb + lc (int8 matrix codes,
// newest-first).  stop: int32[3], the (i, j, k) the walk stopped at.
// Returns the action count, or -1 if the buffer is too small.
int32_t align_impl(const uint8_t* a, int32_t la, const uint8_t* b,
                   int32_t lb, const uint8_t* c, int32_t lc,
                   const Params& p, int32_t* score,
                   int8_t* actions, int32_t cap, int32_t* stop) {
    *score = 0;
    stop[0] = la > 0 ? la : 0;
    stop[1] = lb > 0 ? lb : 0;
    stop[2] = lc > 0 ? lc : 0;
    if (la <= 0 || lb <= 0 || lc <= 0) return 0;

    int32_t w[NM][NM];
    for (int t = 0; t < NM; ++t)
        for (int s = 0; s < NM; ++s) {
            int32_t charge = 0;
            for (int ax = 0; ax < 3; ++ax)
                if (!CONSUMES[t][ax]) charge += CONSUMES[s][ax] ? p.go : p.ge;
            w[t][s] = -charge;
        }

    constexpr int CS = 8;
    const int64_t W1 = lc + 1;
    const int64_t plane = static_cast<int64_t>(lb + 1) * W1;
    std::vector<int32_t> prev(plane * CS, 0), cur(plane * CS, 0);
    // Packed choices for every cell (i >= 1): choice[t] in bits 3t..3t+2.
    std::vector<uint32_t> choices(static_cast<int64_t>(la) * plane, 0);

    for (int i = 1; i <= la; ++i) {
        std::fill(cur.begin(), cur.end(), 0);
        const uint8_t ai = a[i - 1];
        uint32_t* chp = choices.data() + static_cast<int64_t>(i - 1) * plane;
        for (int j = 1; j <= lb; ++j) {
            const uint8_t bj = b[j - 1];
            const int32_t s_ab = pair_score(p, ai, bj);
            const int32_t* pv = prev.data();
            int32_t* cv = cur.data();
            const int64_t row = j * W1;
            for (int k = 1; k <= lc; ++k) {
                const uint8_t ck = c[k - 1];
                const int32_t* v_p11 = pv + (row - W1 + k - 1) * CS;
                const int32_t* v_p00 = pv + (row + k) * CS;
                const int32_t* v_p10 = pv + (row - W1 + k) * CS;
                const int32_t* v_p01 = pv + (row + k - 1) * CS;
                const int32_t* v_c10 = cv + (row - W1 + k) * CS;
                const int32_t* v_c01 = cv + (row + k - 1) * CS;
                const int32_t* v_c11 = cv + (row - W1 + k - 1) * CS;
                const int32_t* pred[NM] = {v_p11, v_p00, v_c10, v_c01,
                                           v_p10, v_c11, v_p01};
                int32_t subs[NM];
                subs[0] = s3_score(p, ai, bj, ck);
                subs[1] = subs[2] = subs[3] = 0;
                subs[4] = s_ab;
                subs[5] = pair_score(p, bj, ck);
                subs[6] = pair_score(p, ai, ck);
                int32_t* out = cv + (row + k) * CS;
                uint32_t packed = 0;
                for (int t = 0; t < NM; ++t) {
                    const int32_t* src = pred[t];
                    const int32_t* wt = w[t];
                    int32_t best = src[0] + wt[0];
                    uint32_t arg = 0;
                    for (int s = 1; s < NM; ++s) {
                        const int32_t v = src[s] + wt[s];
                        if (v > best) { best = v; arg = s; }
                    }
                    packed |= arg << (3 * t);
                    out[t] = best + subs[t];
                }
                chp[row + k] = packed;
            }
        }
        std::swap(prev, cur);
    }

    const int32_t* lastv = prev.data() + (static_cast<int64_t>(lb) * W1 + lc) * CS;
    int32_t best = lastv[0];
    int t = 0;
    for (int s = 1; s < NM; ++s)
        if (lastv[s] > best) { best = lastv[s]; t = s; }
    *score = best;

    int32_t i = la, j = lb, k = lc, n = 0;
    while (i > 0 && j > 0 && k > 0) {
        if (n >= cap) return -1;
        actions[n++] = static_cast<int8_t>(t);
        const uint32_t word =
            choices[static_cast<int64_t>(i - 1) * plane + j * W1 + k];
        const int s = (word >> (3 * t)) & 7;
        i -= CONSUMES[t][0];
        j -= CONSUMES[t][1];
        k -= CONSUMES[t][2];
        t = s;
    }
    stop[0] = i;
    stop[1] = j;
    stop[2] = k;
    return n;
}

}  // namespace

extern "C" {

// s3_mode: 0 = sum-of-pairs, 1 = RTL quirk.
int32_t trialign_score(const uint8_t* a, int32_t la, const uint8_t* b,
                       int32_t lb, const uint8_t* c, int32_t lc,
                       int32_t match, int32_t mismatch, int32_t gap_open,
                       int32_t gap_extend, int32_t s3_mode) {
    const Params p{match, mismatch, gap_open, gap_extend, s3_mode == 0};
    return score_impl(a, la, b, lb, c, lc, p);
}

// Runtime-substitution-matrix variant: lut is the (256, 256) row-major
// int32 pairwise table (Scoring.sub_lookup()); implies sum-of-pairs S3.
int32_t trialign_score_sub(const uint8_t* a, int32_t la, const uint8_t* b,
                           int32_t lb, const uint8_t* c, int32_t lc,
                           int32_t gap_open, int32_t gap_extend,
                           const int32_t* lut) {
    Params p{0, 0, gap_open, gap_extend, true};
    p.lut = lut;
    return score_impl(a, la, b, lb, c, lc, p);
}

int32_t trialign_align(const uint8_t* a, int32_t la, const uint8_t* b,
                       int32_t lb, const uint8_t* c, int32_t lc,
                       int32_t match, int32_t mismatch, int32_t gap_open,
                       int32_t gap_extend, int32_t s3_mode, int32_t* score,
                       int8_t* actions, int32_t cap, int32_t* stop) {
    const Params p{match, mismatch, gap_open, gap_extend, s3_mode == 0};
    return align_impl(a, la, b, lb, c, lc, p, score, actions, cap, stop);
}

int32_t trialign_align_sub(const uint8_t* a, int32_t la, const uint8_t* b,
                           int32_t lb, const uint8_t* c, int32_t lc,
                           int32_t gap_open, int32_t gap_extend,
                           const int32_t* lut, int32_t* score,
                           int8_t* actions, int32_t cap, int32_t* stop) {
    Params p{0, 0, gap_open, gap_extend, true};
    p.lut = lut;
    return align_impl(a, la, b, lb, c, lc, p, score, actions, cap, stop);
}

// Batch entry: n triplets with common max lengths (row-major padded arrays),
// writes scores[n].  Equality scoring only -- submatrix batches ride the
// batched device path (api.align_batch); per-item use trialign_score_sub.
void trialign_score_batch(const uint8_t* as, const int32_t* las,
                          const uint8_t* bs, const int32_t* lbs,
                          const uint8_t* cs, const int32_t* lcs,
                          int32_t n, int32_t stride_a, int32_t stride_b,
                          int32_t stride_c, int32_t match, int32_t mismatch,
                          int32_t gap_open, int32_t gap_extend,
                          int32_t s3_mode, int32_t* scores) {
#pragma omp parallel for schedule(dynamic)
    for (int32_t idx = 0; idx < n; ++idx) {
        scores[idx] = trialign_score(
            as + static_cast<int64_t>(idx) * stride_a, las[idx],
            bs + static_cast<int64_t>(idx) * stride_b, lbs[idx],
            cs + static_cast<int64_t>(idx) * stride_c, lcs[idx], match,
            mismatch, gap_open, gap_extend, s3_mode);
    }
}

}  // extern "C"
