/*
 * Standalone reimplementation of the reference KvarQ C engine's hot loop,
 * used to measure the baseline reads/s that bench.py's "vs_baseline"
 * compares against.  The reference itself (Python 2 C extension,
 * the reference's csrc/workhorse.c) cannot be built here, so this program
 * replicates its scanning algorithm faithfully from the behavioral spec
 * (SURVEY.md section 2.2):
 *
 *  - N scanner threads pulling 1 MiB record-aligned chunks from a shared
 *    mutex-guarded file stream (workhorse.c:746, :998, :1375-1408)
 *  - per record: 4-line parse, quality trim = first longest run of
 *    chars >= Amin (:1055-1070), discard if shorter than minreadlength
 *  - exhaustive match of the trimmed read against every template in the
 *    4 overlap modes with a total mismatch budget, early bail at
 *    e > maxerrors (:1107-1174); hits counted into per-template counters
 *    under a mutex (:408-443)
 *
 * Usage: ref_bench <fastq> <templates.txt> <amin> <maxerrors> <minoverlap>
 *                  <minreadlength> <nthreads> [hitdump]
 * templates.txt: one template per line (plus strands then minus strands,
 * exactly the list the Python engine scans).
 * Prints: records, hits, seconds, reads/s.
 *
 * With the optional 8th argument, every hit is also written to <hitdump>
 * as a text line "seq_nr file_pos seq_pos length readlength" with the
 * reference Hit-tuple semantics (workhorse.c:1575-1596: file_pos = global
 * offset of the trimmed read in the decompressed data, seq_pos places the
 * read relative to the template) in the reference's single-threaded
 * enumeration order (record, template, mode A desc / B desc / C-or-D asc,
 * including the B/D border duplicate).  Requires nthreads=1 so stream
 * order is deterministic; used by tools/hitdiff.py to diff the full hit
 * stream byte-for-byte against engine.findseqs.
 */

#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define SCANBUFSIZE (1024 * 1024)

static char **templates;
static int *tlens;
static int ntemplates;

static int amin, maxerrors, minoverlap, minreadlength, nthreads;

static FILE *stream;
static pthread_mutex_t read_mutex = PTHREAD_MUTEX_INITIALIZER;
static pthread_mutex_t hit_mutex = PTHREAD_MUTEX_INITIALIZER;
static long total_records = 0, total_hits = 0;

static char leftover[SCANBUFSIZE];
static size_t leftover_len = 0;
static long stream_base = 0;   /* global offset of the next chunk's buf[0] */
static FILE *dumpf = NULL;     /* hit-tuple dump (nthreads=1 only) */

/* pull a record-aligned chunk from the shared stream (fastq_read /
 * fastq_rewind semantics: scan backwards for a record boundary);
 * *base_out receives the chunk's global file offset */
static long read_chunk(char *buf, long *base_out) {
    pthread_mutex_lock(&read_mutex);
    memcpy(buf, leftover, leftover_len);
    size_t have = leftover_len;
    size_t n = fread(buf + have, 1, SCANBUFSIZE - have, stream);
    have += n;
    leftover_len = 0;
    *base_out = stream_base;
    if (n > 0 && have == SCANBUFSIZE) {
        /* rewind to the last "\n@" preceded by a full record */
        size_t i = have - 1;
        int nl = 0;
        while (i > 0) {
            if (buf[i] == '\n') {
                if (i + 1 < have && buf[i + 1] == '@') {
                    nl++;
                    if (nl >= 1) {
                        size_t keep = have - (i + 1);
                        memcpy(leftover, buf + i + 1, keep);
                        leftover_len = keep;
                        have = i + 1;
                        break;
                    }
                }
            }
            i--;
        }
    }
    stream_base += (long)have;
    pthread_mutex_unlock(&read_mutex);
    return (long)have;
}

static void dump_hit(int t, long fpos, int spos, int length, int rl) {
    if (dumpf)
        fprintf(dumpf, "%d %ld %d %d %d\n", t, fpos, spos, length, rl);
}

/* the reference's 4-mode exhaustive match (workhorse.c:1107-1174);
 * fpos = global offset of the trimmed read (for the hit dump) */
static long match_read(const char *read, int rl, long fpos) {
    long hits = 0;
    for (int t = 0; t < ntemplates; t++) {
        const char *seq = templates[t];
        int seql = tlens[t];
        int i, j, e;

        if (rl > minoverlap && seql > minoverlap) {
            /* read tail over template head */
            for (i = rl - minoverlap; i >= 1 && rl - i <= seql - 1; i--) {
                e = 0;
                for (j = 0; j < rl - i; j++)
                    if (read[i + j] != seq[j] && ++e > maxerrors) break;
                if (e <= maxerrors) { hits++; dump_hit(t, fpos, -i, rl - i, rl); }
            }
            /* read head over template tail */
            for (i = seql - minoverlap; i >= 1 && seql - i <= rl; i--) {
                e = 0;
                for (j = 0; j < seql - i; j++)
                    if (read[j] != seq[i + j] && ++e > maxerrors) break;
                if (e <= maxerrors) { hits++; dump_hit(t, fpos, i, seql - i, rl); }
            }
        }
        if (rl > seql) {
            /* template fully inside read */
            for (i = 0; i <= rl - seql; i++) {
                e = 0;
                for (j = 0; j < seql; j++)
                    if (read[i + j] != seq[j] && ++e > maxerrors) break;
                if (e <= maxerrors) { hits++; dump_hit(t, fpos, -i, seql, rl); }
            }
        } else {
            /* read fully inside template */
            for (i = 0; i <= seql - rl; i++) {
                e = 0;
                for (j = 0; j < rl; j++)
                    if (read[j] != seq[i + j] && ++e > maxerrors) break;
                if (e <= maxerrors) { hits++; dump_hit(t, fpos, i, rl, rl); }
            }
        }
    }
    return hits;
}

static void *scan_thread(void *arg) {
    char *buf = malloc(SCANBUFSIZE + 1);
    long records = 0, hits = 0, base = 0;
    for (;;) {
        long have = read_chunk(buf, &base);
        if (have <= 0) break;
        buf[have] = 0;

        char *p = buf, *end = buf + have;
        for (;;) {
            /* 4-line record */
            char *l1 = p;
            char *n1 = memchr(l1, '\n', end - l1);
            if (!n1) break;
            char *l2 = n1 + 1;
            char *n2 = memchr(l2, '\n', end - l2);
            if (!n2) break;
            char *l3 = n2 + 1;
            char *n3 = memchr(l3, '\n', end - l3);
            if (!n3) break;
            char *l4 = n3 + 1;
            char *n4 = memchr(l4, '\n', end - l4);
            if (!n4) break;
            p = n4 + 1;
            records++;

            /* quality trim: first longest run >= amin (:1055-1070) */
            int best = 0, best_off = 0, run = 0;
            for (char *q = l4; q < n4; q++) {
                if ((unsigned char)*q >= amin) {
                    run++;
                    if (run > best) {
                        best = run;
                        best_off = (int)(q + 1 - run - l4);
                    }
                } else
                    run = 0;
            }
            if (best < minreadlength) continue;
            hits += match_read(l2 + best_off, best,
                               base + (long)(l2 - buf) + best_off);
        }
    }
    free(buf);
    pthread_mutex_lock(&hit_mutex);
    total_records += records;
    total_hits += hits;
    pthread_mutex_unlock(&hit_mutex);
    return NULL;
}

int main(int argc, char **argv) {
    if (argc != 8 && argc != 9) {
        fprintf(stderr, "usage: %s fastq templates.txt amin maxerrors "
                        "minoverlap minreadlength nthreads [hitdump]\n",
                argv[0]);
        return 1;
    }
    if (argc == 9) {
        if (atoi(argv[7]) != 1) {
            fprintf(stderr, "hit dump requires nthreads=1 (deterministic "
                            "stream order)\n");
            return 1;
        }
        dumpf = fopen(argv[8], "w");
        if (!dumpf) { perror("hitdump"); return 1; }
    }
    stream = fopen(argv[1], "rb");
    if (!stream) { perror("fastq"); return 1; }
    FILE *tf = fopen(argv[2], "rb");
    if (!tf) { perror("templates"); return 1; }
    amin = atoi(argv[3]);
    maxerrors = atoi(argv[4]);
    minoverlap = atoi(argv[5]);
    minreadlength = atoi(argv[6]);
    nthreads = atoi(argv[7]);

    char line[65536];
    int cap = 1024;
    templates = malloc(cap * sizeof(char *));
    tlens = malloc(cap * sizeof(int));
    while (fgets(line, sizeof(line), tf)) {
        int n = (int)strlen(line);
        while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) n--;
        if (!n) continue;
        if (ntemplates == cap) {
            cap *= 2;
            templates = realloc(templates, cap * sizeof(char *));
            tlens = realloc(tlens, cap * sizeof(int));
        }
        templates[ntemplates] = strndup(line, n);
        tlens[ntemplates] = n;
        ntemplates++;
    }
    fclose(tf);

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    pthread_t threads[256];
    for (int i = 0; i < nthreads; i++)
        pthread_create(&threads[i], NULL, scan_thread, NULL);
    for (int i = 0; i < nthreads; i++)
        pthread_join(threads[i], NULL);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + (t1.tv_nsec - t0.tv_nsec) / 1e9;

    printf("{\"records\": %ld, \"hits\": %ld, \"seconds\": %.3f, "
           "\"reads_per_s\": %.1f, \"templates\": %d, \"threads\": %d}\n",
           total_records, total_hits, dt, total_records / dt,
           ntemplates, nthreads);
    fclose(stream);
    if (dumpf) fclose(dumpf);
    return 0;
}
