// SA-IS suffix array construction (the native-core counterpart of the
// reference's blockwise Kärkkäinen sort / libsais backend, ref:
// blockwise_sa.h:255, third_party/libsais). Standard induced-sorting
// algorithm (Nong, Zhang & Chan 2009), templated on the position type:
// int32 for genomes < 2^31 bp and int64 for .bt2l-scale (GRCh38) builds.
//
// Performance notes: type flags live in a flat uint8 array (vector<bool>'s
// bit ops dominated the induce loops), bucket counts are computed once per
// recursion level, and the two induce passes run over raw pointers.
//
// Memory: the caller's buffer of n + 1 positions is the working SA (no
// second copy), and the LMS list is sized before it is filled; at the
// 64-bit width the peak is ~27 bytes a base (GRCh38-scale texts).
//
// Exposed C ABI:
//   int bt2tpu_sais(const uint8_t* text, int32_t n, int32_t* sa)
//   int bt2tpu_sais64(const uint8_t* text, int64_t n, int64_t* sa)
//     -> 0 on success; sa has n + 1 slots: sa[0] = n (the sentinel
//        suffix), sa[1..n] = suffix array of text (alphabet 0..255,
//        suffixes compared with implicit terminator < all characters).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Generic SA-IS over an integer string `s` of length n with alphabet size K.
// s[n-1] must be a unique minimum sentinel (0). TIdx: int32 or int64.
template <typename T, typename TIdx>
void sais_core(const T* s, TIdx* sa, TIdx n, TIdx K) {
    // type flags: 1 = S-type, 0 = L-type; LMS = S with L on the left
    std::vector<uint8_t> t(n);
    t[n - 1] = 1;
    for (TIdx i = n - 2; i >= 0; i--)
        t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
    const uint8_t* tp = t.data();
    auto is_lms = [tp](TIdx i) {
        return i > 0 && tp[i] && !tp[i - 1];
    };

    // bucket counts, once per level
    std::vector<TIdx> cnt(K, 0), bstart(K), bend(K), work(K);
    for (TIdx i = 0; i < n; i++) cnt[s[i]]++;
    {
        TIdx acc = 0;
        for (TIdx c = 0; c < K; c++) {
            bstart[c] = acc;
            acc += cnt[c];
            bend[c] = acc;
        }
    }

    auto induce = [&](const TIdx* lms, TIdx nlms) {
        std::fill(sa, sa + n, (TIdx)-1);
        // place LMS suffixes at bucket tails (in given order, backwards)
        std::memcpy(work.data(), bend.data(), sizeof(TIdx) * K);
        for (TIdx i = nlms - 1; i >= 0; i--) {
            TIdx p = lms[i];
            sa[--work[s[p]]] = p;
        }
        // induce L-type from left to right
        std::memcpy(work.data(), bstart.data(), sizeof(TIdx) * K);
        for (TIdx i = 0; i < n; i++) {
            TIdx p = sa[i];
            if (p > 0 && !tp[p - 1]) sa[work[s[p - 1]]++] = p - 1;
        }
        // induce S-type from right to left
        std::memcpy(work.data(), bend.data(), sizeof(TIdx) * K);
        for (TIdx i = n - 1; i >= 0; i--) {
            TIdx p = sa[i];
            if (p > 0 && tp[p - 1]) sa[--work[s[p - 1]]] = p - 1;
        }
    };

    // collect LMS positions in text order (counted first: no regrowth)
    TIdx n_lms = 0;
    for (TIdx i = 1; i < n; i++) n_lms += tp[i] && !tp[i - 1];
    std::vector<TIdx> lms_pos;
    lms_pos.reserve(n_lms);
    for (TIdx i = 1; i < n; i++)
        if (tp[i] && !tp[i - 1]) lms_pos.push_back(i);
    TIdx m = (TIdx)lms_pos.size();

    induce(lms_pos.data(), m);

    // name LMS substrings in sorted order
    std::vector<TIdx> name(n, -1);
    TIdx names = 0;
    TIdx prev = -1;
    for (TIdx i = 0; i < n; i++) {
        TIdx p = sa[i];
        if (p <= 0 || !is_lms(p)) continue;
        if (prev < 0) {
            name[p] = names++;
        } else {
            bool same = true;
            for (TIdx d = 0;; d++) {
                if (s[prev + d] != s[p + d] || tp[prev + d] != tp[p + d]) {
                    same = false;
                    break;
                }
                if (d > 0 && (is_lms(prev + d) || is_lms(p + d))) {
                    same = is_lms(prev + d) && is_lms(p + d);
                    break;
                }
            }
            if (!same) names++;
            name[p] = names - 1;
        }
        prev = p;
    }

    std::vector<TIdx> order(m);
    if (names < m) {
        // recurse on the reduced string of LMS names. The final LMS is the
        // outer sentinel position whose name is uniquely 0, so the reduced
        // string ends with its own unique minimum — the invariant
        // sais_core requires.
        std::vector<TIdx> s1(m);
        TIdx j = 0;
        for (TIdx i = 1; i < n; i++)
            if (tp[i] && !tp[i - 1]) s1[j++] = name[i];
        name.clear();
        name.shrink_to_fit();
        std::vector<TIdx> sa1(m);
        sais_core<TIdx, TIdx>(s1.data(), sa1.data(), m, names);
        for (TIdx i = 0; i < m; i++) order[i] = lms_pos[sa1[i]];
    } else {
        // all names unique: radix by name
        for (TIdx i = 0; i < m; i++) order[name[lms_pos[i]]] = lms_pos[i];
    }
    induce(order.data(), m);
}

template <typename TIdx>
int sais_entry(const uint8_t* text, TIdx n, TIdx* sa) {
    if (n <= 0) return 0;
    // append sentinel: work over s[i] = text[i] + 1, s[n] = 0
    std::vector<uint16_t> s(n + 1);
    for (TIdx i = 0; i < n; i++) s[i] = (uint16_t)text[i] + 1;
    s[n] = 0;
    // the sentinel suffix sorts first: sa[0] = n
    sais_core<uint16_t, TIdx>(s.data(), sa, n + 1, (TIdx)257);
    return 0;
}

}  // namespace

extern "C" {

int bt2tpu_sais(const uint8_t* text, int32_t n, int32_t* sa) {
    return sais_entry<int32_t>(text, n, sa);
}

int bt2tpu_sais64(const uint8_t* text, int64_t n, int64_t* sa) {
    return sais_entry<int64_t>(text, n, sa);
}

}  // extern "C"
