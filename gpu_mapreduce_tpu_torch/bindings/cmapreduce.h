/* C interface to the PyTorch/CUDA MapReduce framework.
 *
 * The counterpart of the reference's src/cmapreduce.h: flat MR_*
 * functions over opaque handles, with user callbacks as C function
 * pointers carrying the same byte-oriented signatures.  The engine is
 * the Python/PyTorch framework (gpu_mapreduce_tpu_torch), embedded via
 * CPython (cmapreduce.c); call MR_init() once before anything else and
 * MR_finalize() at exit.
 *
 * Every dataset lives on the CUDA card unless its creator names another
 * device: MR_create() and OINK_open() are MR_create_device(NULL) and
 * OINK_open_device(logfile, NULL).  Without a card they return NULL
 * with MR_last_error() saying why; nothing falls back to the CPU.
 *
 * Handles are returned by MR_create(); KV handles only exist inside
 * callbacks (MR_kv_add them there, like the reference's KVptr).
 */

#ifndef GPUMR_TORCH_CMAPREDUCE_H
#define GPUMR_TORCH_CMAPREDUCE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* runtime */
int MR_init(void);                      /* 0 on success */
/* drops the bridge; finalises the interpreter only when MR_init started
 * it (a library loaded into a running Python never ends its host) */
void MR_finalize(void);
const char *MR_last_error(void);        /* NULL if the last call succeeded */

/* lifecycle */
void *MR_create(void);                  /* on the card */
/* on `device` ("cuda", "cuda:1", "cpu"); NULL means the card */
void *MR_create_device(const char *device);
void MR_destroy(void *mr);
void *MR_copy(void *mr);
int MR_set(void *mr, const char *name, const char *value);

/* pair adds — valid only on the KV handle passed into a callback */
void MR_kv_add(void *kv, const char *key, int keybytes,
               const char *value, int valuebytes);
/* n fixed-width pairs packed back to back (reference
 * MR_kv_add_multi_static) */
void MR_kv_add_multi_static(void *kv, int n, const char *key, int keybytes,
                            const char *value, int valuebytes);
/* n variable-width pairs; keybytes/valuebytes are per-pair size arrays
 * (reference MR_kv_add_multi_dynamic) */
void MR_kv_add_multi_dynamic(void *kv, int n, const char *key,
                             const int *keybytes, const char *value,
                             const int *valuebytes);

/* map */
uint64_t MR_map(void *mr, int nmap,
                void (*mymap)(int itask, void *kv, void *ptr), void *ptr);
uint64_t MR_map_add(void *mr, int nmap,
                    void (*mymap)(int, void *, void *), void *ptr,
                    int addflag);
uint64_t MR_map_file_list(void *mr, int nstr, char **paths,
                          void (*mymap)(int itask, char *fname, void *kv,
                                        void *ptr),
                          void *ptr);

/* chunked file maps (reference map_file_char/str variants,
 * src/cmapreduce.h — callback receives one chunk of bytes ending on the
 * separator, with `delta` lookahead trimmed) */
uint64_t MR_map_file_char(void *mr, int nmap, int nstr, char **paths,
                          char sepchar, int delta,
                          void (*mymap)(int itask, char *bytes, int nbytes,
                                        void *kv, void *ptr),
                          void *ptr);
uint64_t MR_map_file_str(void *mr, int nmap, int nstr, char **paths,
                         const char *sepstr, int delta,
                         void (*mymap)(int itask, char *bytes, int nbytes,
                                       void *kv, void *ptr),
                         void *ptr);
/* map over an existing MR's KV pairs, incl. self-map mr2 == mr
 * (reference MR_map_mr, src/cmapreduce.cpp): mymap(itask, key,
 * keybytes, value, valuebytes, KVptr, APPptr) */
uint64_t MR_map_mr(void *mr, void *mr2,
                   void (*mymap)(uint64_t itask, char *key, int keybytes,
                                 char *value, int valuebytes,
                                 void *kv, void *ptr),
                   void *ptr);

/* shuffle / grouping / reduce */
uint64_t MR_aggregate(void *mr);
/* user hash: key → int; proc = hash % nprocs (reference MR_aggregate's
 * myhash).  The callback runs on the host per key. */
uint64_t MR_aggregate_hash(void *mr,
                           int (*myhash)(char *key, int keybytes));
uint64_t MR_convert(void *mr);
uint64_t MR_collate(void *mr);
uint64_t MR_clone(void *mr);
uint64_t MR_collapse(void *mr, const char *key, int keybytes);
uint64_t MR_gather(void *mr, int nprocs);
uint64_t MR_broadcast(void *mr, int root);
uint64_t MR_add(void *mr, void *mr2);
/* gather to nprocs + collapse under one key (reference MR_scrunch) */
uint64_t MR_scrunch(void *mr, int nprocs, const char *key, int keybytes);
/* cross-MR add state: open() lets later maps/reduces add into this MR's
 * KV; close() completes it (reference MR_open/MR_close) */
void MR_open(void *mr);
uint64_t MR_close(void *mr);
uint64_t MR_reduce(void *mr,
                   void (*myreduce)(char *key, int keybytes,
                                    char *multivalue, int nvalues,
                                    int *valuebytes, void *kv, void *ptr),
                   void *ptr);
uint64_t MR_compress(void *mr,
                     void (*myreduce)(char *, int, char *, int, int *,
                                      void *, void *),
                     void *ptr);

/* sorts (flag semantics of the reference: ±1..6; _cmp variants take the
 * reference's appcompare over raw bytes) */
uint64_t MR_sort_keys_flag(void *mr, int flag);
uint64_t MR_sort_values_flag(void *mr, int flag);
uint64_t MR_sort_multivalues_flag(void *mr, int flag);
uint64_t MR_sort_keys(void *mr,
                      int (*mycompare)(char *, int, char *, int));
uint64_t MR_sort_values(void *mr,
                        int (*mycompare)(char *, int, char *, int));
uint64_t MR_sort_multivalues(void *mr,
                             int (*mycompare)(char *, int, char *, int));

/* read-only */
uint64_t MR_scan_kv(void *mr,
                    void (*myscan)(char *key, int keybytes, char *value,
                                   int valuebytes, void *ptr),
                    void *ptr);
uint64_t MR_scan_kmv(void *mr,
                     void (*myscan)(char *key, int keybytes,
                                    char *multivalue, int nvalues,
                                    int *valuebytes, void *ptr),
                     void *ptr);
uint64_t MR_kv_stats(void *mr);
uint64_t MR_kmv_stats(void *mr);
void MR_cummulative_stats(void *mr, int level, int reset);
int MR_print_file(void *mr, const char *path, int kflag, int vflag);
uint64_t MR_print(void *mr, int nstride, int kflag, int vflag);

/* multi-block ("extended") multivalues: a reduce callback that receives
 * multivalue==NULL and nvalues==0 iterates the group in blocks —
 * MR_multivalue_blocks() gives the block count, MR_multivalue_block()
 * loads block iblock and returns its value count (buffers stay valid
 * until the next block request); _block_select is accepted for
 * reference parity and is a no-op (no 2-page scratch here).  Enable
 * blocking with MR_set(mr, "c_block_rows", "<rows>") — groups larger
 * than that arrive blocked (the reference blocks when a group outgrows
 * a page; src/mapreduce.cpp:1874-1925). */
uint64_t MR_multivalue_blocks(void *mr);
int MR_multivalue_block(void *mr, int iblock, char **ptr_multivalue,
                        int **ptr_valuesizes);
void MR_multivalue_block_select(void *mr, int which);

/* OINK script driver (reference oink/library.h mrmpi_open/file/command/
 * close) */
void *OINK_open(const char *logfile);   /* logfile NULL → no log */
/* every MR of the script on `device`; NULL means the card */
void *OINK_open_device(const char *logfile, const char *device);
int OINK_file(void *oink, const char *path);
int OINK_command(void *oink, const char *line);
void OINK_close(void *oink);

#ifdef __cplusplus
}
#endif

#endif /* GPUMR_TORCH_CMAPREDUCE_H */
