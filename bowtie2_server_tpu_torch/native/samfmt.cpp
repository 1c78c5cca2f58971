// Batch SAM record formatter — the native emitter for the fast paths'
// column stores (ref: the reference's SAM assembly in sam.cpp:252-744,
// which likewise formats straight into a byte buffer; here one call
// formats a whole batch from the pipeline's column arrays).
//
// A side is one LazyRecs: its reads' blobs, its FastSoA columns, and the
// lines of the reads the columns do not hold, rendered by sam_record.
// One call writes one side's reads, or two sides' (a pair batch's mates)
// interleaved: mate 1's line, then mate 2's.
//
// Row classes of a side:
//   pysrc[i] >= 0 : splice a pre-rendered python line (slow-path records)
//   tidx[i]  >= 0 : aligned via SoA columns -> full record with tags; a
//                   concordant fast pair's mate when the side has pair
//                   columns (flags 1|2|64 or 128, RNEXT, PNEXT, TLEN,
//                   YS:i, YT:Z:CP)
//   otherwise     : unaligned record (flag 4), YT:Z:UU (+ YF:Z:<2ch>)
// markers != 0 ends each row with "@CO END READ\t<name of side a>" (the
// BT2SRV response's marker, ref: aln_sink.cpp:2159).
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

// Mirrors the ctypes Structure `_Side` in native/__init__.py field for
// field.
struct Side {
    // per read, length B
    const int32_t *tidx;        // index into the columns; -1 = not filled
    const int64_t *pysrc;       // >=0: [py_off[i], py_off[i + 1]) splice
    const uint8_t *filtered;    // 1 -> YF tag on the unaligned record
    const uint8_t *yf2;         // 2*B chars, YF code per read (LN/NS/SC/QC)
    // name/seq/qual blobs with B+1 offsets (original ASCII)
    const char *name_blob; const int64_t *name_off;
    const char *seq_blob; const int64_t *seq_off;
    const char *qual_blob; const int64_t *qual_off;
    // SoA columns, length U
    const uint8_t *fw; const int32_t *ref_id; const int64_t *pos0;
    const int64_t *score; const uint8_t *sec_has; const int64_t *sec;
    const int32_t *mapq; const int32_t *nm; const int32_t *rl;
    // mismatch detail: U+1 splits, columns, ref base codes (0..4)
    const int64_t *mm_split; const int64_t *mm_cols; const uint8_t *mm_ref;
    // pre-rendered python lines blob (newline NOT included)
    const char *py_blob; const int64_t *py_off;
    // concordant fast pairs' columns, length U; mate_fw null: unpaired
    const uint8_t *mate_fw; const int32_t *mate_ref_id;
    const int64_t *mate_pos; const int64_t *tlen; const int64_t *ys;
    int32_t mate1;
};

// Bytes row i of side s may take, at most (the marker aside).
int64_t need(const Side &s, int32_t i, int64_t rn_max, int64_t rg_len) {
    if (s.pysrc[i] >= 0)
        return s.py_off[s.pysrc[i] + 1] - s.py_off[s.pysrc[i]] + 1;
    int64_t n = (s.name_off[i + 1] - s.name_off[i])
        + (s.seq_off[i + 1] - s.seq_off[i])
        + (s.qual_off[i + 1] - s.qual_off[i]) + 2 * rn_max + rg_len + 512;
    const int32_t t = s.tidx[i];
    if (t >= 0) n += 21 * (s.mm_split[t + 1] - s.mm_split[t]);
    return n;
}

char *put_row(char *p, const Side &s, int32_t i, const char *rn_blob,
              const int64_t *rn_off, const char *rg, int64_t rg_len) {
    static const char BASES[] = "ACGTN";
    const int64_t nlen = s.name_off[i + 1] - s.name_off[i];
    const int64_t slen = s.seq_off[i + 1] - s.seq_off[i];
    const int64_t qlen = s.qual_off[i + 1] - s.qual_off[i];
    if (s.pysrc[i] >= 0) {
        const int64_t off = s.py_off[s.pysrc[i]];
        p = put_str(p, s.py_blob + off, s.py_off[s.pysrc[i] + 1] - off);
        *p++ = '\n';
        return p;
    }
    const int32_t t = s.tidx[i];
    if (t < 0) {
        p = put_str(p, s.name_blob + s.name_off[i], nlen);
        p = put_lit(p, "\t4\t*\t0\t0\t*\t*\t0\t0\t");
        p = put_str(p, s.seq_blob + s.seq_off[i], slen);
        *p++ = '\t';
        if (qlen > 0) p = put_str(p, s.qual_blob + s.qual_off[i], qlen);
        else *p++ = '*';
        p = put_lit(p, "\tYT:Z:UU");
        if (s.filtered[i]) {
            p = put_lit(p, "\tYF:Z:");
            *p++ = (char)s.yf2[2 * i];
            *p++ = (char)s.yf2[2 * i + 1];
        }
        if (rg_len) { p = put_lit(p, "\tRG:Z:"); p = put_str(p, rg, rg_len); }
        *p++ = '\n';
        return p;
    }
    // aligned, ungapped record from columns
    const bool pair = s.mate_fw != nullptr;
    int flag = s.fw[t] ? 0 : 16;
    if (pair)
        flag |= 1 | 2 | (s.mate1 ? 64 : 128) | (s.mate_fw[t] ? 0 : 32);
    p = put_str(p, s.name_blob + s.name_off[i], nlen);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)flag);
    *p++ = '\t';
    const int64_t rno = rn_off[s.ref_id[t]];
    p = put_str(p, rn_blob + rno, rn_off[s.ref_id[t] + 1] - rno);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)(s.pos0[t] + 1));
    *p++ = '\t';
    p = put_u64(p, (uint64_t)s.mapq[t]);
    *p++ = '\t';
    p = put_u64(p, (uint64_t)s.rl[t]);
    *p++ = 'M';
    if (pair) {
        *p++ = '\t';
        const int32_t m = s.mate_ref_id[t];
        if (m == s.ref_id[t]) *p++ = '=';
        else p = put_str(p, rn_blob + rn_off[m], rn_off[m + 1] - rn_off[m]);
        *p++ = '\t';
        p = put_u64(p, (uint64_t)(s.mate_pos[t] + 1));
        *p++ = '\t';
        p = put_i64(p, s.tlen[t]);
        *p++ = '\t';
    } else {
        p = put_lit(p, "\t*\t0\t0\t");
    }
    if (s.fw[t]) {
        p = put_str(p, s.seq_blob + s.seq_off[i], slen);
        *p++ = '\t';
        if (qlen > 0) p = put_str(p, s.qual_blob + s.qual_off[i], qlen);
        else *p++ = '*';
    } else {
        const char *q = s.seq_blob + s.seq_off[i];
        for (int64_t k = slen - 1; k >= 0; k--)
            *p++ = COMP.t[(unsigned char)q[k]];
        *p++ = '\t';
        if (qlen > 0) {
            q = s.qual_blob + s.qual_off[i];
            for (int64_t k = qlen - 1; k >= 0; k--) *p++ = q[k];
        } else *p++ = '*';
    }
    p = put_lit(p, "\tAS:i:");
    p = put_i64(p, s.score[t]);
    if (s.sec_has[t]) { p = put_lit(p, "\tXS:i:"); p = put_i64(p, s.sec[t]); }
    p = put_lit(p, "\tXN:i:0\tXM:i:");
    p = put_u64(p, (uint64_t)s.nm[t]);
    p = put_lit(p, "\tXO:i:0\tXG:i:0\tNM:i:");
    p = put_u64(p, (uint64_t)s.nm[t]);
    p = put_lit(p, "\tMD:Z:");
    int64_t last = 0;
    for (int64_t k = s.mm_split[t]; k < s.mm_split[t + 1]; k++) {
        p = put_u64(p, (uint64_t)(s.mm_cols[k] - last));
        *p++ = BASES[s.mm_ref[k] > 4 ? 4 : s.mm_ref[k]];
        last = s.mm_cols[k] + 1;
    }
    p = put_u64(p, (uint64_t)(s.rl[t] - last));
    if (pair) {
        p = put_lit(p, "\tYS:i:");
        p = put_i64(p, s.ys[t]);
        p = put_lit(p, "\tYT:Z:CP");
    } else {
        p = put_lit(p, "\tYT:Z:UU");
    }
    if (rg_len) { p = put_lit(p, "\tRG:Z:"); p = put_str(p, rg, rg_len); }
    *p++ = '\n';
    return p;
}

}  // namespace

// Formats B rows into out (cap bytes): side a's read i, then side b's
// (b null: unpaired), then the END READ marker when markers is set; skips
// unaligned column-less reads under no_unal. row_end (B entries, or null)
// gets each row's end offset in out. Returns the bytes written, or
// -(i + 1) when row i would not fit (the caller grows out and retries).
extern "C" int64_t bt2tpu_sam_emit(
    const Side *a, const Side *b, int32_t B,
    const char *rn_blob, const int64_t *rn_off, int32_t n_ref,
    const char *rg, int64_t rg_len, int32_t no_unal, int32_t markers,
    int64_t *row_end, char *out, int64_t cap) {
    int64_t rn_max = 0;
    for (int32_t r = 0; r < n_ref; r++)
        if (rn_off[r + 1] - rn_off[r] > rn_max)
            rn_max = rn_off[r + 1] - rn_off[r];
    char *p = out;
    char *end = out + cap;
    for (int32_t i = 0; i < B; i++) {
        int64_t want = need(*a, i, rn_max, rg_len);
        if (b) want += need(*b, i, rn_max, rg_len);
        if (markers) want += 14 + (a->name_off[i + 1] - a->name_off[i]);
        if (end - p < want) return -(int64_t)(i + 1);
        const Side *sides[2] = {a, b};
        for (const Side *s : sides) {
            if (!s) continue;
            if (no_unal && s->pysrc[i] < 0 && s->tidx[i] < 0) continue;
            p = put_row(p, *s, i, rn_blob, rn_off, rg, rg_len);
        }
        if (markers) {
            p = put_lit(p, "@CO END READ\t");
            p = put_str(p, a->name_blob + a->name_off[i],
                        a->name_off[i + 1] - a->name_off[i]);
            *p++ = '\n';
        }
        if (row_end) row_end[i] = p - out;
    }
    return p - out;
}
