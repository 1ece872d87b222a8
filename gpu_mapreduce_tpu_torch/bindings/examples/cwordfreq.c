/* cwordfreq — word frequency via the C ABI, the counterpart of the
 * reference's examples/cwordfreq.c: map files → collate → reduce(sum) →
 * gather → sort by count → print the top words.
 *
 * Usage: cwordfreq [-device cpu|cuda] file1 [file2 ...]
 * Prints "<nwords> total words, <nunique> unique words" then the top-5
 * "<count> <word>" lines (descending), like examples/wordfreq.cpp:119-130.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ctype.h>

#include "../cmapreduce.h"

/* map: read one file, emit (word, NULL) per whitespace token */
static void fileread(int itask, char *fname, void *kv, void *ptr) {
  FILE *fp = fopen(fname, "r");
  if (fp == NULL) return;
  char word[256];
  while (fscanf(fp, "%255s", word) == 1)
    MR_kv_add(kv, word, (int)strlen(word), NULL, 0);
  fclose(fp);
}

/* reduce: emit (word, count) with count as zero-padded ascii so the
 * byte-wise value sort orders numerically (typed columns would use the
 * int comparator; byte values compare lexicographically) */
static void count_words(char *key, int keybytes, char *multivalue,
                        int nvalues, int *valuebytes, void *kv, void *ptr) {
  long *total = (long *)ptr;
  *total += nvalues;
  char buf[32];
  int n = snprintf(buf, sizeof buf, "%08d", nvalues);
  MR_kv_add(kv, key, keybytes, buf, n);
}

/* scan: print "<count> <word>" for the first `limit` pairs */
struct topctx { int seen, limit; };

static void print_top(char *key, int keybytes, char *value, int valuebytes,
                      void *ptr) {
  struct topctx *c = (struct topctx *)ptr;
  if (c->seen++ >= c->limit) return;
  char num[32];
  int n = valuebytes < 31 ? valuebytes : 31;
  memcpy(num, value, n);
  num[n] = '\0';
  printf("%d %.*s\n", atoi(num), keybytes, key);
}

int main(int argc, char **argv) {
  const char *device = NULL; /* the card */
  if (argc > 2 && strcmp(argv[1], "-device") == 0) {
    device = argv[2];
    argc -= 2;
    argv += 2;
  }
  if (argc < 2) {
    fprintf(stderr, "usage: cwordfreq [-device cpu|cuda] file1 "
                    "[file2 ...]\n");
    return 1;
  }
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
  MR_map_file_list(mr, argc - 1, &argv[1], fileread, NULL);
  uint64_t nwords = MR_kv_stats(mr);
  MR_collate(mr);
  long total = 0;
  uint64_t nunique = MR_reduce(mr, count_words, &total);
  printf("%lu total words, %lu unique words\n",
         (unsigned long)nwords, (unsigned long)nunique);

  /* top-5: zero-padded ascii counts — flag -5 = string descending */
  MR_gather(mr, 1);
  MR_sort_values_flag(mr, -5);
  struct topctx ctx = {0, 5};
  MR_scan_kv(mr, print_top, &ctx);

  MR_destroy(mr);
  MR_finalize();
  return 0;
}
