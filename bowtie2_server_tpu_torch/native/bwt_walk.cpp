// Full-SA reconstruction from a stored BWT — the .bt2/.bt2l interop fast
// path (ref: bt2_io.cpp:39 readIntoMemory loads the packed ebwt;
// bt2_idx.h:1607 walkLeft resolves offsets lazily against a sampled SA).
//
// Our index keeps the FULL suffix array in device memory (SA resolution is
// one gather), so loading a reference-format index means materializing
// SA[0..n] once. Instead of re-suffix-sorting the reconstructed genome
// (O(n) SA-IS but with large constants and peak memory), one LF-walk of
// the BWT cycle fills the whole array: start at the empty suffix (row 0,
// SA = n) and step LF n times; the k-th step lands on the row whose
// suffix starts at n-k.
//
// Exposed C ABI:
//   int bt2tpu_sa_from_bwt(const uint8_t* bwt, int64_t n_rows,
//                          int64_t primary, int32_t dollar_large,
//                          int64_t* sa_out)
//     bwt: n_rows = n_text+1 codes (values 0..3; the entry at row
//          `primary` is the $ hole and is never counted)
//     dollar_large: suffix-order convention. 0 = our native index ($
//          sorts before every character: the empty suffix is row 0 and
//          cnt[c] = 1 + #chars<c). 1 = the reference's .bt2 layout ($
//          sorts after every character — verified against bowtie2-build
//          output: the empty suffix is the LAST row and cnt[c] = #chars<c).
//     sa_out: n_rows int64 entries (suffix start per row; the empty row
//          gets n_text)
//     returns 0 on success, nonzero if the BWT is inconsistent (the walk
//     does not close at the primary row).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// 64-rows-per-block rank structure over 2-bit packed codes.
struct Rank2Bit {
    std::vector<uint64_t> words;   // 2 words per 64-row block, 32 codes each
    std::vector<int64_t> ckpt;     // 4 per block: rank_c(block_start)
    int64_t n_rows;
    int64_t primary;

    void build(const uint8_t* bwt, int64_t n, int64_t prim) {
        n_rows = n;
        primary = prim;
        int64_t n_blocks = (n + 63) / 64;
        words.assign(n_blocks * 2, 0);
        ckpt.assign((n_blocks + 1) * 4, 0);
        int64_t run[4] = {0, 0, 0, 0};
        for (int64_t b = 0; b < n_blocks; b++) {
            for (int c = 0; c < 4; c++) ckpt[b * 4 + c] = run[c];
            int64_t end = b * 64 + 64 < n ? b * 64 + 64 : n;
            for (int64_t r = b * 64; r < end; r++) {
                uint64_t code = bwt[r] & 3;  // hole packs as its raw byte&3
                words[b * 2 + ((r >> 5) & 1)] |=
                    code << (2 * (r & 31));
                if (r != primary) run[bwt[r] & 3]++;
            }
        }
        for (int c = 0; c < 4; c++) ckpt[n_blocks * 4 + c] = run[c];
    }

    inline int code_at(int64_t r) const {
        return (int)((words[(r >> 6) * 2 + ((r >> 5) & 1)]
                      >> (2 * (r & 31))) & 3);
    }

    // #occurrences of c in rows [0, r), hole excluded
    inline int64_t rank(int c, int64_t r) const {
        int64_t b = r >> 6;
        int64_t cnt = ckpt[b * 4 + c];
        // count c in rows [b*64, r) via xor-popcount over <=2 words
        uint64_t pat = 0x5555555555555555ULL * (uint64_t)c;
        int64_t rem = r & 63;
        const uint64_t* w = &words[b * 2];
        for (int k = 0; k < 2 && rem > 0; k++) {
            int take = rem >= 32 ? 32 : (int)rem;
            uint64_t x = w[k] ^ pat;
            uint64_t nonmatch = (x | (x >> 1)) & 0x5555555555555555ULL;
            uint64_t mask = take >= 32 ? ~0ULL
                                       : ((1ULL << (2 * take)) - 1);
            cnt += take - __builtin_popcountll(nonmatch & mask);
            rem -= take;
        }
        // the hole row packs as some code; the checkpoints already exclude
        // it, so only uncount it when the in-block scan covered it
        if (primary >= b * 64 && primary < r && code_at(primary) == c)
            cnt--;
        return cnt;
    }
};

}  // namespace

extern "C" {

int bt2tpu_sa_from_bwt(const uint8_t* bwt, int64_t n_rows, int64_t primary,
                       int32_t dollar_large, int64_t* sa_out) {
    if (n_rows <= 0) return 1;
    int64_t n_text = n_rows - 1;
    if (primary < 0 || primary >= n_rows) return 2;
    Rank2Bit rk;
    rk.build(bwt, n_rows, primary);
    // C array: cnt[c] = #rows whose F char < c. With $ small the empty-
    // suffix row sorts first, so every bucket shifts by 1.
    int64_t n_blocks = (n_rows + 63) / 64;
    int64_t cnt[4];
    int64_t acc = dollar_large ? 0 : 1;
    for (int c = 0; c < 4; c++) {
        cnt[c] = acc;
        acc += rk.ckpt[n_blocks * 4 + c];  // hole already excluded in build
    }
    int64_t r = dollar_large ? n_rows - 1 : 0;  // the empty-suffix row
    sa_out[r] = n_text;
    for (int64_t k = 1; k <= n_text; k++) {
        if (r == primary) return 3;  // premature cycle close
        int c = rk.code_at(r);
        r = cnt[c] + rk.rank(c, r);
        sa_out[r] = n_text - k;
    }
    return r == primary ? 0 : 4;
}

}  // extern "C"
