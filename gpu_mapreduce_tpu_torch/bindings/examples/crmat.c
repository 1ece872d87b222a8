/* crmat — RMAT matrix generation via the C ABI, the counterpart of the
 * reference's examples/crmat.c: generate-until-unique loop (map_add →
 * collate → cull), then the nonzero/degree/histo pipeline finishing
 * with a descending degree sort and an MR_map_mr stats pass.
 *
 * Usage: crmat [-device cpu|cuda] N Nz a b c d frac seed [outfile]
 * Prints "<order> rows in matrix", "<ntotal> nonzeroes in matrix",
 * the "<degree> <count>" histogram, and "<n> rows with 0 nonzeroes".
 * With [outfile], writes "vi vj" edge lines to <outfile>.0.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stdint.h>

#include "../cmapreduce.h"

typedef struct {
  int nlevels, order, nnonzero, ngenerate;
  double a, b, c, d, fraction;
  FILE *fp;
} RMAT;

typedef struct {
  uint64_t vi, vj;
} EDGE;

/* map: emit ngenerate random RMAT edges (key = EDGE struct, value = NULL) */
static void generate(int itask, void *kv, void *ptr) {
  RMAT *r = (RMAT *)ptr;
  for (int m = 0; m < r->ngenerate; m++) {
    uint64_t i = 0, j = 0;
    int delta = r->order >> 1;
    double a1 = r->a, b1 = r->b, c1 = r->c, d1 = r->d;
    for (int lev = 0; lev < r->nlevels; lev++) {
      double rn = drand48();
      if (rn < a1) {
      } else if (rn < a1 + b1) {
        j += delta;
      } else if (rn < a1 + b1 + c1) {
        i += delta;
      } else {
        i += delta;
        j += delta;
      }
      delta >>= 1;
      if (r->fraction > 0.0) {
        a1 += a1 * r->fraction * (drand48() - 0.5);
        b1 += b1 * r->fraction * (drand48() - 0.5);
        c1 += c1 * r->fraction * (drand48() - 0.5);
        d1 += d1 * r->fraction * (drand48() - 0.5);
        double total = a1 + b1 + c1 + d1;
        a1 /= total; b1 /= total; c1 /= total; d1 /= total;
      }
    }
    EDGE e = {i, j};
    MR_kv_add(kv, (char *)&e, (int)sizeof(EDGE), NULL, 0);
  }
}

/* reduce: keep one copy of each edge */
static void cull(char *key, int keybytes, char *mv, int nvalues,
                 int *valuebytes, void *kv, void *ptr) {
  MR_kv_add(kv, key, keybytes, NULL, 0);
}

/* reduce: write "vi vj" per unique edge, keep the edge */
static void output(char *key, int keybytes, char *mv, int nvalues,
                   int *valuebytes, void *kv, void *ptr) {
  RMAT *r = (RMAT *)ptr;
  EDGE e;
  memcpy(&e, key, sizeof(EDGE));
  fprintf(r->fp, "%llu %llu\n", (unsigned long long)e.vi,
          (unsigned long long)e.vj);
  MR_kv_add(kv, key, keybytes, NULL, 0);
}

/* reduce: edge → (row vi, NULL) */
static void nonzero(char *key, int keybytes, char *mv, int nvalues,
                    int *valuebytes, void *kv, void *ptr) {
  EDGE e;
  memcpy(&e, key, sizeof(EDGE));
  MR_kv_add(kv, (char *)&e.vi, (int)sizeof(uint64_t), NULL, 0);
}

/* reduce: row → (degree, NULL) */
static void degree(char *key, int keybytes, char *mv, int nvalues,
                   int *valuebytes, void *kv, void *ptr) {
  uint64_t deg = (uint64_t)nvalues;
  MR_kv_add(kv, (char *)&deg, (int)sizeof(uint64_t), NULL, 0);
}

/* reduce: degree → (degree, count of rows with it) */
static void histo(char *key, int keybytes, char *mv, int nvalues,
                  int *valuebytes, void *kv, void *ptr) {
  uint64_t cnt = (uint64_t)nvalues;
  MR_kv_add(kv, key, keybytes, (char *)&cnt, (int)sizeof(uint64_t));
}

/* descending numeric order on u64 degree keys */
static int ncompare(char *a, int na, char *b, int nb) {
  uint64_t x, y;
  memcpy(&x, a, sizeof(uint64_t));
  memcpy(&y, b, sizeof(uint64_t));
  if (x > y) return -1;
  if (x < y) return 1;
  return 0;
}

/* map over the sorted histogram: print rows, total the row count */
static void stats(uint64_t itask, char *key, int keybytes, char *value,
                  int valuebytes, void *kv, void *ptr) {
  uint64_t deg, cnt;
  memcpy(&deg, key, sizeof(uint64_t));
  memcpy(&cnt, value, sizeof(uint64_t));
  *(uint64_t *)ptr += cnt;
  printf("%llu %llu\n", (unsigned long long)deg, (unsigned long long)cnt);
}

int main(int argc, char **argv) {
  const char *device = NULL; /* the card */
  if (argc > 2 && strcmp(argv[1], "-device") == 0) {
    device = argv[2];
    argc -= 2;
    argv += 2;
  }
  if (argc != 9 && argc != 10) {
    fprintf(stderr, "usage: crmat [-device cpu|cuda] N Nz a b c d frac "
                    "seed [outfile]\n");
    return 1;
  }
  RMAT rmat;
  rmat.nlevels = atoi(argv[1]);
  rmat.nnonzero = atoi(argv[2]);
  rmat.a = atof(argv[3]);
  rmat.b = atof(argv[4]);
  rmat.c = atof(argv[5]);
  rmat.d = atof(argv[6]);
  rmat.fraction = atof(argv[7]);
  int seed = atoi(argv[8]);
  const char *outfile = argc == 10 ? argv[9] : NULL;

  if (rmat.a + rmat.b + rmat.c + rmat.d != 1.0) {
    fprintf(stderr, "ERROR: a,b,c,d must sum to 1\n");
    return 1;
  }
  if (rmat.fraction >= 1.0) {
    fprintf(stderr, "ERROR: fraction must be < 1\n");
    return 1;
  }
  srand48(seed);
  rmat.order = 1 << rmat.nlevels;

  if (MR_init() != 0) {
    fprintf(stderr, "MR_init failed: %s\n", MR_last_error());
    return 1;
  }
  void *mr = MR_create_device(device);
  if (mr == NULL) {
    fprintf(stderr, "MR_create failed: %s\n", MR_last_error());
    MR_finalize();
    return 1;
  }

  /* generate until all ntotal edges are unique (reference crmat.c loop) */
  int niterate = 0;
  uint64_t ntotal = (uint64_t)rmat.order * rmat.nnonzero;
  uint64_t nremain = ntotal;
  while (nremain) {
    niterate++;
    rmat.ngenerate = (int)nremain;
    MR_map_add(mr, 1, generate, &rmat, 1);
    uint64_t nunique = MR_collate(mr);
    MR_reduce(mr, cull, &rmat);
    if (nunique == ntotal) break;
    nremain = ntotal - nunique;
  }

  if (outfile) {
    char fname[512];
    snprintf(fname, sizeof fname, "%s.0", outfile);
    rmat.fp = fopen(fname, "w");
    if (rmat.fp == NULL) {
      fprintf(stderr, "ERROR: could not open %s\n", fname);
      return 1;
    }
    void *mr2 = MR_copy(mr);
    MR_collate(mr2);
    MR_reduce(mr2, output, &rmat);
    fclose(rmat.fp);
    MR_destroy(mr2);
  }

  printf("%d rows in matrix\n", rmat.order);
  printf("%llu nonzeroes in matrix\n", (unsigned long long)ntotal);

  /* nonzeroes per row → degree histogram, printed descending */
  MR_collate(mr);
  MR_reduce(mr, nonzero, NULL);
  MR_collate(mr);
  MR_reduce(mr, degree, NULL);
  MR_collate(mr);
  MR_reduce(mr, histo, NULL);
  MR_gather(mr, 1);
  MR_sort_keys(mr, ncompare);
  uint64_t total = 0;
  MR_map_mr(mr, mr, stats, &total);
  printf("%llu rows with 0 nonzeroes\n",
         (unsigned long long)(rmat.order - total));
  printf("generated in %d iterations\n", niterate);

  MR_destroy(mr);
  MR_finalize();
  return 0;
}
