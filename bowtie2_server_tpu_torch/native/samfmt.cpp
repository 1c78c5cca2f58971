// Batch SAM record formatter — the native emitter for the unpaired fast
// path (ref: the reference's SAM assembly in sam.cpp:252-744, which
// likewise formats straight into a byte buffer; here one call formats a
// whole batch from the pipeline's column arrays).
//
// Row classes:
//   pysrc[i] >= 0 : splice a pre-rendered python line (slow-path records)
//   tidx[i]  >= 0 : aligned via SoA columns -> full record with tags
//   otherwise     : unaligned record (flag 4), YT:Z:UU (+ YF:Z:<2ch>)
#include <cstdint>
#include <cstring>

namespace {

inline char *put_u64(char *p, uint64_t v) {
    char tmp[20];
    int n = 0;
    do { tmp[n++] = '0' + (v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

inline char *put_i64(char *p, int64_t v) {
    if (v < 0) { *p++ = '-'; return put_u64(p, (uint64_t)(-v)); }
    return put_u64(p, (uint64_t)v);
}

inline char *put_str(char *p, const char *s, int64_t n) {
    memcpy(p, s, (size_t)n);
    return p + n;
}

inline char *put_lit(char *p, const char *s) {
    while (*s) *p++ = *s++;
    return p;
}

struct CompTab {
    char t[256];
    CompTab() {
        for (int i = 0; i < 256; i++) t[i] = 'N';
        const char *a = "ACGTUacgtu", *b = "TGCAATGCAA";
        for (int i = 0; a[i]; i++) t[(unsigned char)a[i]] = b[i];
    }
};
const CompTab COMP;

}  // namespace

extern "C" int64_t bt2tpu_sam_format(
    // per-read, length B
    const int32_t *tidx,        // index into SoA columns; -1 = not filled
    const int64_t *pysrc,       // >=0: [py_off[i], py_off[i]+len) splice
    const uint8_t *filtered,    // 1 -> YF tag on the unaligned record
    const uint8_t *yf2,         // 2*B chars, YF code per read ("NS"/"QC")
    // name/seq/qual blobs with B+1 offsets (original ASCII)
    const char *name_blob, const int64_t *name_off,
    const char *seq_blob, const int64_t *seq_off,
    const char *qual_blob, const int64_t *qual_off,
    // SoA columns, length U
    const uint8_t *fw, const int32_t *ref_id, const int64_t *pos0,
    const int64_t *score, const uint8_t *sec_has, const int64_t *sec,
    const int32_t *mapq, const int32_t *nm, const int32_t *rl,
    // mismatch detail: U+1 splits, columns, ref base codes (0..4)
    const int64_t *mm_split, const int64_t *mm_cols, const uint8_t *mm_ref,
    // reference names blob with offsets
    const char *rn_blob, const int64_t *rn_off,
    // pre-rendered python lines blob (newline NOT included)
    const char *py_blob, const int64_t *py_off,
    // optional RG:Z value ("" = none)
    const char *rg, int64_t rg_len,
    int32_t B, int32_t no_unal,
    char *out, int64_t cap) {
    static const char BASES[] = "ACGTN";
    char *p = out;
    char *end = out + cap;
    for (int32_t i = 0; i < B; i++) {
        const int64_t nlen = name_off[i + 1] - name_off[i];
        const int64_t slen = seq_off[i + 1] - seq_off[i];
        const int64_t qlen = qual_off[i + 1] - qual_off[i];
        // worst case: name + 2*seq + MD(4*nm) + fixed fields/tags
        if (end - p < nlen + 2 * slen + 512 + (tidx[i] >= 0 ?
                4 * (int64_t)nm[tidx[i]] : 0))
            return -(int64_t)(i + 1);   // caller: grow buffer, retry
        if (pysrc[i] >= 0) {
            const int64_t off = py_off[pysrc[i]];
            p = put_str(p, py_blob + off, py_off[pysrc[i] + 1] - off);
            *p++ = '\n';
            continue;
        }
        const int32_t t = tidx[i];
        if (t < 0) {
            if (no_unal) continue;
            p = put_str(p, name_blob + name_off[i], nlen);
            p = put_lit(p, "\t4\t*\t0\t0\t*\t*\t0\t0\t");
            p = put_str(p, seq_blob + seq_off[i], slen);
            *p++ = '\t';
            if (qlen > 0) p = put_str(p, qual_blob + qual_off[i], qlen);
            else *p++ = '*';
            p = put_lit(p, "\tYT:Z:UU");
            if (filtered[i]) {
                p = put_lit(p, "\tYF:Z:");
                *p++ = (char)yf2[2 * i];
                *p++ = (char)yf2[2 * i + 1];
            }
            if (rg_len) { p = put_lit(p, "\tRG:Z:");
                          p = put_str(p, rg, rg_len); }
            *p++ = '\n';
            continue;
        }
        // aligned, ungapped record from columns
        p = put_str(p, name_blob + name_off[i], nlen);
        p = put_lit(p, fw[t] ? "\t0\t" : "\t16\t");
        const int64_t rno = rn_off[ref_id[t]];
        p = put_str(p, rn_blob + rno, rn_off[ref_id[t] + 1] - rno);
        *p++ = '\t';
        p = put_u64(p, (uint64_t)(pos0[t] + 1));
        *p++ = '\t';
        p = put_u64(p, (uint64_t)mapq[t]);
        *p++ = '\t';
        p = put_u64(p, (uint64_t)rl[t]);
        *p++ = 'M';
        p = put_lit(p, "\t*\t0\t0\t");
        if (fw[t]) {
            p = put_str(p, seq_blob + seq_off[i], slen);
            *p++ = '\t';
            if (qlen > 0) p = put_str(p, qual_blob + qual_off[i], qlen);
            else *p++ = '*';
        } else {
            const char *s = seq_blob + seq_off[i];
            for (int64_t k = slen - 1; k >= 0; k--)
                *p++ = COMP.t[(unsigned char)s[k]];
            *p++ = '\t';
            if (qlen > 0) {
                const char *q = qual_blob + qual_off[i];
                for (int64_t k = qlen - 1; k >= 0; k--) *p++ = q[k];
            } else *p++ = '*';
        }
        p = put_lit(p, "\tAS:i:");
        p = put_i64(p, score[t]);
        if (sec_has[t]) { p = put_lit(p, "\tXS:i:"); p = put_i64(p, sec[t]); }
        p = put_lit(p, "\tXN:i:0\tXM:i:");
        p = put_u64(p, (uint64_t)nm[t]);
        p = put_lit(p, "\tXO:i:0\tXG:i:0\tNM:i:");
        p = put_u64(p, (uint64_t)nm[t]);
        p = put_lit(p, "\tMD:Z:");
        {
            int64_t last = 0;
            for (int64_t k = mm_split[t]; k < mm_split[t + 1]; k++) {
                p = put_u64(p, (uint64_t)(mm_cols[k] - last));
                *p++ = BASES[mm_ref[k] > 4 ? 4 : mm_ref[k]];
                last = mm_cols[k] + 1;
            }
            p = put_u64(p, (uint64_t)(rl[t] - last));
        }
        p = put_lit(p, "\tYT:Z:UU");
        if (rg_len) { p = put_lit(p, "\tRG:Z:"); p = put_str(p, rg, rg_len); }
        *p++ = '\n';
    }
    return p - out;
}
