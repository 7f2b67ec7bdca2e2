// SA-IS suffix array construction (induced sorting), C ABI.
//
// Counterpart of the reference's index-build sorting core
// (KarkkainenBlockwiseSA, blockwise_sa.h): the reference
// block-sorts suffixes with a difference-cover sample to bound memory; here
// a linear-time SA-IS pass builds the whole suffix array directly — the
// index builder (hisat2_tpu/index/builder.py) consumes it via ctypes and
// derives BWT/occ/SA-sample arrays with vectorized numpy.
//
// Algorithm: Nong, Zhang & Chan, "Linear Suffix Array Construction by
// Almost Pure Induced-Sorting", DCC 2009.  Implementation written fresh
// against the paper's description.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename SAIdx>
void sais_build(const int32_t* T, SAIdx* SA, SAIdx n, int32_t K) {
    // T over alphabet [0, K); T[n-1] is the unique smallest (sentinel 0)
    if (n == 1) { SA[0] = 0; return; }

    std::vector<bool> stype((size_t)n);
    stype[n - 1] = true;
    for (SAIdx i = n - 2; ; --i) {
        stype[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && stype[i + 1]);
        if (i == 0) break;
    }
    auto is_lms = [&](SAIdx i) { return i > 0 && stype[i] && !stype[i - 1]; };

    std::vector<SAIdx> bkt((size_t)K), heads((size_t)K), tails((size_t)K);
    for (SAIdx i = 0; i < n; ++i) ++bkt[T[i]];
    auto reset_heads = [&]() {
        SAIdx s = 0;
        for (int32_t c = 0; c < K; ++c) { heads[c] = s; s += bkt[c]; }
    };
    auto reset_tails = [&]() {
        SAIdx s = 0;
        for (int32_t c = 0; c < K; ++c) { s += bkt[c]; tails[c] = s - 1; }
    };
    const SAIdx EMPTY = (SAIdx)-1;

    auto induce = [&]() {
        reset_heads();
        for (SAIdx i = 0; i < n; ++i) {
            SAIdx j = SA[i];
            if (j != EMPTY && j > 0 && !stype[j - 1])
                SA[heads[T[j - 1]]++] = j - 1;
        }
        reset_tails();
        for (SAIdx i = n - 1; ; --i) {
            SAIdx j = SA[i];
            if (j != EMPTY && j > 0 && stype[j - 1])
                SA[tails[T[j - 1]]--] = j - 1;
            if (i == 0) break;
        }
    };

    // LMS positions in text order
    std::vector<SAIdx> lms_pos;
    for (SAIdx i = 1; i < n; ++i)
        if (is_lms(i)) lms_pos.push_back(i);
    const SAIdx n1 = (SAIdx)lms_pos.size();

    // Stage 1: drop LMS suffixes at bucket tails, induce-sort
    std::memset(SA, 0xff, sizeof(SAIdx) * (size_t)n);
    reset_tails();
    for (SAIdx i = n1 - 1; i >= 0; --i) {
        SA[tails[T[lms_pos[i]]]--] = lms_pos[i];
        if (i == 0) break;
    }
    induce();

    // Collect LMS suffixes in induced order, name their substrings
    std::vector<SAIdx> lms_sorted;
    lms_sorted.reserve((size_t)n1);
    for (SAIdx i = 0; i < n; ++i)
        if (SA[i] != EMPTY && is_lms(SA[i])) lms_sorted.push_back(SA[i]);

    std::vector<SAIdx> name_of((size_t)n, EMPTY);
    SAIdx name = 0, prev = EMPTY;
    for (SAIdx i = 0; i < n1; ++i) {
        SAIdx pos = lms_sorted[i];
        bool diff = (prev == EMPTY);
        if (!diff) {
            for (SAIdx d = 0;; ++d) {
                if (pos + d >= n || prev + d >= n ||
                    T[pos + d] != T[prev + d] ||
                    stype[pos + d] != stype[prev + d]) { diff = true; break; }
                if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
                    diff = !(is_lms(pos + d) && is_lms(prev + d));
                    break;
                }
            }
        }
        if (diff) { ++name; prev = pos; }
        name_of[pos] = name - 1;
    }

    // Stage 2: order the LMS suffixes
    std::vector<SAIdx> sa1((size_t)n1);
    if (name < n1) {
        std::vector<int32_t> t1((size_t)n1);
        for (SAIdx i = 0; i < n1; ++i) t1[i] = (int32_t)name_of[lms_pos[i]];
        sais_build<SAIdx>(t1.data(), sa1.data(), n1, (int32_t)name);
    } else {
        for (SAIdx i = 0; i < n1; ++i) sa1[name_of[lms_pos[i]]] = i;
    }

    // Stage 3: place LMS suffixes (now fully sorted) at tails, induce
    std::memset(SA, 0xff, sizeof(SAIdx) * (size_t)n);
    reset_tails();
    for (SAIdx i = n1 - 1; i >= 0; --i) {
        SAIdx j = lms_pos[sa1[i]];
        SA[tails[T[j]]--] = j;
        if (i == 0) break;
    }
    induce();
}

}  // namespace

extern "C" {

// T: int32 text of length n with unique smallest sentinel T[n-1]=0,
// alphabet [0, K).  SA: out, length n.  Returns 0 on success.
int sais_int32(const int32_t* T, int32_t* SA, int64_t n, int32_t K) {
    if (n <= 0 || n > INT32_MAX) return -1;
    sais_build<int32_t>(T, SA, (int32_t)n, K);
    return 0;
}

int sais_int64(const int32_t* T, int64_t* SA, int64_t n, int32_t K) {
    if (n <= 0) return -1;
    sais_build<int64_t>(T, SA, n, K);
    return 0;
}

}  // extern "C"
