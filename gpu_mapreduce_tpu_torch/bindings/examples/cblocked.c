/* C ABI tail exercise: open/close cross-MR adds, multi-pair adds
 * (static + dynamic widths), a blocked multivalue reduce via
 * MR_multivalue_blocks/_block, scrunch, screen print and cumulative
 * stats — the reference surface of src/cmapreduce.h:24-148 beyond the
 * wordfreq basics (see cwordfreq.c).
 *
 * Usage: cblocked [-device cpu|cuda]
 *
 * Expected stdout (checked by tests/test_torch_bindings.py):
 *   pairs 36
 *   scrunch groups 1
 *   groups 6 blocked 3 values 36
 *   k0 8 ... (sorted key/count lines)
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "../cmapreduce.h"

static void *g_mr;

static void mymap(int itask, void *kv, void *ptr) {
  char keys[12];
  int32_t vals[6];
  for (int i = 0; i < 6; i++) {
    keys[2 * i] = 'k';
    keys[2 * i + 1] = (char)('0' + (i % 3));
    vals[i] = itask;
  }
  MR_kv_add_multi_static(kv, 6, keys, 2, (char *)vals, 4);

  const char *dk = "aabbbcccc"; /* "aa" "bbb" "cccc" */
  int ks[3] = {2, 3, 4};
  const char *dv = "xyyzzz"; /* "x" "yy" "zzz" */
  int vs[3] = {1, 2, 3};
  MR_kv_add_multi_dynamic(kv, 3, dk, ks, dv, vs);
  (void)ptr;
}

static long blocked_groups = 0, plain_groups = 0, total_vals = 0;

static void myreduce(char *key, int keybytes, char *multivalue, int nvalues,
                     int *valuebytes, void *kv, void *ptr) {
  uint32_t count = 0;
  if (multivalue == NULL && nvalues == 0) {
    blocked_groups++;
    uint64_t nb = MR_multivalue_blocks(g_mr);
    for (int b = 0; b < (int)nb; b++) {
      char *bm;
      int *bs;
      int n = MR_multivalue_block(g_mr, b, &bm, &bs);
      if (n < 0) {
        fprintf(stderr, "block error: %s\n", MR_last_error());
        return;
      }
      /* touch the buffers like a real consumer would */
      long bytes = 0;
      for (int i = 0; i < n; i++) bytes += bs[i];
      (void)bm;
      (void)bytes;
      count += (uint32_t)n;
    }
  } else {
    plain_groups++;
    count = (uint32_t)nvalues;
    (void)valuebytes;
  }
  total_vals += count;
  MR_kv_add(kv, key, keybytes, (char *)&count, 4);
  (void)ptr;
}

static void myscan(char *key, int keybytes, char *value, int valuebytes,
                   void *ptr) {
  uint32_t count;
  memcpy(&count, value, 4);
  printf("%.*s %u\n", keybytes, key, count);
  (void)valuebytes;
  (void)ptr;
}

int main(int argc, char **argv) {
  setvbuf(stdout, NULL, _IONBF, 0); /* diagnosable output under a crash */
  const char *device = NULL; /* the card */
  if (argc == 3 && strcmp(argv[1], "-device") == 0) {
    device = argv[2];
  } else if (argc != 1) {
    fprintf(stderr, "usage: cblocked [-device cpu|cuda]\n");
    return 1;
  }
  if (MR_init() != 0) {
    fprintf(stderr, "init failed: %s\n", MR_last_error());
    return 1;
  }
  void *mr = MR_create_device(device);
  if (mr == NULL) {
    fprintf(stderr, "MR_create failed: %s\n", MR_last_error());
    MR_finalize();
    return 1;
  }
  g_mr = mr;

  /* open/close: two map rounds add into ONE KV */
  MR_open(mr);
  MR_map_add(mr, 2, mymap, NULL, 1);
  MR_map_add(mr, 2, mymap, NULL, 1);
  uint64_t npairs = MR_close(mr);
  printf("pairs %llu\n", (unsigned long long)npairs);

  /* scrunch a copy into a single collapsed group */
  void *cp = MR_copy(mr);
  MR_scrunch(cp, 1, "ALL", 3);
  uint64_t ngroups = MR_kmv_stats(cp);
  printf("scrunch groups %llu\n", (unsigned long long)ngroups);
  MR_destroy(cp);

  /* blocked reduce: groups > 5 values arrive as nvalues==0 blocks */
  MR_set(mr, "c_block_rows", "5");
  MR_convert(mr);
  MR_reduce(mr, myreduce, NULL);
  printf("groups %ld blocked %ld values %ld\n",
         blocked_groups + plain_groups, blocked_groups, total_vals);

  MR_sort_keys_flag(mr, 5);
  MR_scan_kv(mr, myscan, NULL);

  MR_print(mr, 1, 5, 1);       /* screen print (stderr-irrelevant) */
  MR_cummulative_stats(mr, 1, 0);
  if (MR_last_error() != NULL) {
    fprintf(stderr, "error: %s\n", MR_last_error());
    return 1;
  }
  MR_destroy(mr);
  MR_finalize();
  return 0;
}
