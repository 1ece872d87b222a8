/* C ABI shim — embeds CPython and forwards every MR_* call to
 * gpu_mapreduce_tpu_torch.bindings.cbridge (the reference implements
 * src/cmapreduce.cpp as a thin forwarding layer over the C++ class; this
 * is the same layer over the PyTorch engine).
 *
 * Handles: cbridge keeps an int→object table; the void* handles here are
 * those ints cast to pointers.  C callback pointers travel to Python as
 * integers and are re-entered through ctypes (cbridge.*_FN).
 *
 * The interpreter: in an executable, MR_init starts Python, imports the
 * bridge and then releases the GIL, so Python's own threads (prefetch,
 * spill writers, the process group's heartbeat) run while the C program
 * does its own work; every entry point takes the GIL for its call.
 * MR_finalize finalises only an interpreter that MR_init started: loaded
 * into a running Python (ctypes.PyDLL), the shim never ends its host.
 *
 * Build (bindings/__init__.py):
 *   executable: gcc prog.c cmapreduce.c $(python3-config --includes) \
 *       $(python3-config --ldflags --embed)
 *   into a running Python: gcc -shared -fPIC cmapreduce.c \
 *       $(python3-config --includes) -o libcmapreduce.so
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#include "cmapreduce.h"

static PyObject *bridge = NULL;
static char errbuf[4096];
static int have_error = 0;
/* the main thread's state while MR_init's own interpreter runs without
 * the GIL; NULL when the host process owns the interpreter */
static PyThreadState *own_tstate = NULL;

static void capture_error(void) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  errbuf[0] = '\0';
  if (value != NULL) {
    PyObject *s = PyObject_Str(value);
    if (s != NULL) {
      const char *msg = PyUnicode_AsUTF8(s);
      if (msg != NULL) strncpy(errbuf, msg, sizeof(errbuf) - 1);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  have_error = 1;
}

/* call bridge.<method>(args...) → new ref or NULL (error captured) */
static PyObject *bridge_call(const char *method, const char *fmt, ...) {
  if (bridge == NULL) {
    strncpy(errbuf, "MR_init() not called", sizeof(errbuf) - 1);
    have_error = 1;
    return NULL;
  }
  have_error = 0;
  PyGILState_STATE g = PyGILState_Ensure();
  va_list ap;
  va_start(ap, fmt);
  PyObject *args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject *result = NULL;
  if (args != NULL) {
    PyObject *fn = PyObject_GetAttrString(bridge, method);
    if (fn != NULL) {
      result = PyObject_CallObject(fn, args);
      Py_DECREF(fn);
    }
    Py_DECREF(args);
  }
  if (result == NULL) capture_error();
  PyGILState_Release(g);
  return result;
}

/* Every Python-object touch needs the GIL: MR_* functions are legal
 * INSIDE map/reduce callbacks (MR_kv_add, MR_multivalue_blocks...),
 * where ctypes released the GIL before entering the C callback — a
 * GIL-less PyErr_Occurred there dereferences a NULL thread state. */
static uint64_t as_u64(PyObject *r) {
  if (r == NULL) return 0;
  PyGILState_STATE g = PyGILState_Ensure();
  uint64_t v = 0;
  if (r != Py_None) v = (uint64_t)PyLong_AsUnsignedLongLong(r);
  if (PyErr_Occurred()) {
    capture_error();
    v = 0;
  }
  Py_DECREF(r);
  PyGILState_Release(g);
  return v;
}

static void drop(PyObject *r) {
  if (r == NULL) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_DECREF(r);
  PyGILState_Release(g);
}

/* ------------------------------------------------------------------ */

int MR_init(void) {
  if (bridge != NULL) return 0;
  int started = 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    started = 1;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  bridge = PyImport_ImportModule("gpu_mapreduce_tpu_torch.bindings.cbridge");
  if (bridge == NULL) capture_error();
  PyGILState_Release(g);
  /* Py_InitializeEx left this thread holding the GIL: hand it back */
  if (started) own_tstate = PyEval_SaveThread();
  return bridge == NULL ? -1 : 0;
}

void MR_finalize(void) {
  if (!Py_IsInitialized()) return;
  if (own_tstate != NULL) {
    /* our interpreter: take the GIL back on the thread that started it
     * (Py_FinalizeEx joins Python's non-daemon threads, runs atexit
     * hooks and must run where Py_InitializeEx did) */
    PyEval_RestoreThread(own_tstate);
    own_tstate = NULL;
    Py_XDECREF(bridge);
    bridge = NULL;
    Py_FinalizeEx();
    return;
  }
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(bridge);
  bridge = NULL;
  PyGILState_Release(g);
}

const char *MR_last_error(void) { return have_error ? errbuf : NULL; }

/* "z" turns a NULL string into None: the card */
void *MR_create_device(const char *device) {
  return (void *)(intptr_t)as_u64(bridge_call("mr_create", "(z)", device));
}

void *MR_create(void) { return MR_create_device(NULL); }

void MR_destroy(void *mr) {
  drop(bridge_call("mr_destroy", "(n)", (Py_ssize_t)mr));
}

void *MR_copy(void *mr) {
  return (void *)(intptr_t)as_u64(
      bridge_call("mr_copy", "(n)", (Py_ssize_t)mr));
}

int MR_set(void *mr, const char *name, const char *value) {
  PyObject *r = bridge_call("mr_set", "(nss)", (Py_ssize_t)mr, name, value);
  if (r == NULL) return -1;
  Py_DECREF(r);
  return 0;
}

void MR_kv_add(void *kv, const char *key, int keybytes, const char *value,
               int valuebytes) {
  drop(bridge_call("kv_add", "(ny#y#)", (Py_ssize_t)kv, key,
                         (Py_ssize_t)keybytes, value,
                         (Py_ssize_t)valuebytes));
}

uint64_t MR_map_add(void *mr, int nmap, void (*mymap)(int, void *, void *),
                    void *ptr, int addflag) {
  return as_u64(bridge_call("mr_map", "(ninni)", (Py_ssize_t)mr, nmap,
                            (Py_ssize_t)(intptr_t)mymap,
                            (Py_ssize_t)(intptr_t)ptr, addflag));
}

uint64_t MR_map(void *mr, int nmap, void (*mymap)(int, void *, void *),
                void *ptr) {
  return MR_map_add(mr, nmap, mymap, ptr, 0);
}

static PyObject *path_list(int nstr, char **paths) {
  /* GIL-safe: map-from-a-callback is legal (the doc promises it) */
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject *list = PyList_New(nstr);
  if (list != NULL)
    for (int i = 0; i < nstr; i++)
      PyList_SET_ITEM(list, i, PyBytes_FromString(paths[i]));
  PyGILState_Release(g);
  return list;
}

uint64_t MR_map_file_list(void *mr, int nstr, char **paths,
                          void (*mymap)(int, char *, void *, void *),
                          void *ptr) {
  PyObject *list = path_list(nstr, paths);
  if (list == NULL) return 0;
  uint64_t n = as_u64(bridge_call("mr_map_file_list", "(nOnni)",
                                  (Py_ssize_t)mr, list,
                                  (Py_ssize_t)(intptr_t)mymap,
                                  (Py_ssize_t)(intptr_t)ptr, 0));
  drop(list);
  return n;
}

static uint64_t map_chunks(void *mr, const char *which, int nmap, int nstr,
                           char **paths, const char *sep, int seplen,
                           int delta, void (*fn)(int, char *, int, void *,
                                                 void *),
                           void *ptr) {
  PyObject *list = path_list(nstr, paths);
  if (list == NULL) return 0;
  uint64_t n = as_u64(bridge_call("mr_map_file_chunks", "(nsiOy#inn)",
                                  (Py_ssize_t)mr, which, nmap, list, sep,
                                  (Py_ssize_t)seplen, delta,
                                  (Py_ssize_t)(intptr_t)fn,
                                  (Py_ssize_t)(intptr_t)ptr));
  drop(list);
  return n;
}

uint64_t MR_map_file_char(void *mr, int nmap, int nstr, char **paths,
                          char sepchar, int delta,
                          void (*fn)(int, char *, int, void *, void *),
                          void *ptr) {
  return map_chunks(mr, "char", nmap, nstr, paths, &sepchar, 1, delta, fn,
                    ptr);
}

uint64_t MR_map_file_str(void *mr, int nmap, int nstr, char **paths,
                         const char *sepstr, int delta,
                         void (*fn)(int, char *, int, void *, void *),
                         void *ptr) {
  return map_chunks(mr, "str", nmap, nstr, paths, sepstr,
                    (int)strlen(sepstr), delta, fn, ptr);
}

uint64_t MR_map_mr(void *mr, void *mr2,
                   void (*fn)(uint64_t, char *, int, char *, int, void *,
                              void *),
                   void *ptr) {
  return as_u64(bridge_call("mr_map_mr", "(nnnn)", (Py_ssize_t)mr,
                            (Py_ssize_t)mr2, (Py_ssize_t)(intptr_t)fn,
                            (Py_ssize_t)(intptr_t)ptr));
}

uint64_t MR_aggregate_hash(void *mr, int (*myhash)(char *, int)) {
  return as_u64(bridge_call("mr_aggregate_hash", "(nn)", (Py_ssize_t)mr,
                            (Py_ssize_t)(intptr_t)myhash));
}

uint64_t MR_reduce(void *mr,
                   void (*fn)(char *, int, char *, int, int *, void *,
                              void *),
                   void *ptr) {
  return as_u64(bridge_call("mr_reduce", "(nnn)", (Py_ssize_t)mr,
                            (Py_ssize_t)(intptr_t)fn,
                            (Py_ssize_t)(intptr_t)ptr));
}

uint64_t MR_compress(void *mr,
                     void (*fn)(char *, int, char *, int, int *, void *,
                                void *),
                     void *ptr) {
  return as_u64(bridge_call("mr_compress", "(nnn)", (Py_ssize_t)mr,
                            (Py_ssize_t)(intptr_t)fn,
                            (Py_ssize_t)(intptr_t)ptr));
}

uint64_t MR_scan_kv(void *mr,
                    void (*fn)(char *, int, char *, int, void *),
                    void *ptr) {
  return as_u64(bridge_call("mr_scan_kv", "(nnn)", (Py_ssize_t)mr,
                            (Py_ssize_t)(intptr_t)fn,
                            (Py_ssize_t)(intptr_t)ptr));
}

static uint64_t method0(void *mr, const char *name) {
  return as_u64(bridge_call("mr_method_u64", "(ns)", (Py_ssize_t)mr, name));
}

uint64_t MR_aggregate(void *mr) { return method0(mr, "aggregate"); }
uint64_t MR_convert(void *mr) { return method0(mr, "convert"); }
uint64_t MR_collate(void *mr) { return method0(mr, "collate"); }
uint64_t MR_clone(void *mr) { return method0(mr, "clone"); }

uint64_t MR_collapse(void *mr, const char *key, int keybytes) {
  return as_u64(bridge_call("mr_method_u64", "(nsy#)", (Py_ssize_t)mr,
                            "collapse", key, (Py_ssize_t)keybytes));
}

uint64_t MR_gather(void *mr, int nprocs) {
  return as_u64(bridge_call("mr_method_u64", "(nsi)", (Py_ssize_t)mr,
                            "gather", nprocs));
}

uint64_t MR_broadcast(void *mr, int root) {
  return as_u64(bridge_call("mr_method_u64", "(nsi)", (Py_ssize_t)mr,
                            "broadcast", root));
}

uint64_t MR_add(void *mr, void *mr2) {
  return as_u64(bridge_call("mr_method_u64", "(nsn)", (Py_ssize_t)mr,
                            "add", (Py_ssize_t)mr2));
}

uint64_t MR_scrunch(void *mr, int nprocs, const char *key, int keybytes) {
  return as_u64(bridge_call("mr_method_u64", "(nsiy#)", (Py_ssize_t)mr,
                            "scrunch", nprocs, key, (Py_ssize_t)keybytes));
}

void MR_open(void *mr) {
  drop(bridge_call("mr_method_u64", "(ns)", (Py_ssize_t)mr, "open"));
}

uint64_t MR_close(void *mr) { return method0(mr, "close"); }

uint64_t MR_sort_keys_flag(void *mr, int flag) {
  return as_u64(bridge_call("mr_method_u64", "(nsi)", (Py_ssize_t)mr,
                            "sort_keys", flag));
}

uint64_t MR_sort_values_flag(void *mr, int flag) {
  return as_u64(bridge_call("mr_method_u64", "(nsi)", (Py_ssize_t)mr,
                            "sort_values", flag));
}

uint64_t MR_sort_multivalues_flag(void *mr, int flag) {
  return as_u64(bridge_call("mr_method_u64", "(nsi)", (Py_ssize_t)mr,
                            "sort_multivalues", flag));
}

static uint64_t sort_cmp(void *mr, const char *which,
                         int (*cmp)(char *, int, char *, int)) {
  return as_u64(bridge_call("mr_sort_cmp", "(nsn)", (Py_ssize_t)mr, which,
                            (Py_ssize_t)(intptr_t)cmp));
}

uint64_t MR_sort_keys(void *mr, int (*cmp)(char *, int, char *, int)) {
  return sort_cmp(mr, "keys", cmp);
}

uint64_t MR_sort_values(void *mr, int (*cmp)(char *, int, char *, int)) {
  return sort_cmp(mr, "values", cmp);
}

uint64_t MR_sort_multivalues(void *mr,
                             int (*cmp)(char *, int, char *, int)) {
  return sort_cmp(mr, "multivalues", cmp);
}

uint64_t MR_scan_kmv(void *mr,
                     void (*fn)(char *, int, char *, int, int *, void *),
                     void *ptr) {
  return as_u64(bridge_call("mr_scan_kmv", "(nnn)", (Py_ssize_t)mr,
                            (Py_ssize_t)(intptr_t)fn,
                            (Py_ssize_t)(intptr_t)ptr));
}

uint64_t MR_kv_stats(void *mr) {
  return as_u64(bridge_call("mr_stats", "(ns)", (Py_ssize_t)mr, "kv"));
}

uint64_t MR_kmv_stats(void *mr) {
  return as_u64(bridge_call("mr_stats", "(ns)", (Py_ssize_t)mr, "kmv"));
}

int MR_print_file(void *mr, const char *path, int kflag, int vflag) {
  PyObject *r = bridge_call("mr_print_file", "(nsii)", (Py_ssize_t)mr, path,
                            kflag, vflag);
  if (r == NULL) return -1;
  Py_DECREF(r);
  return 0;
}

uint64_t MR_print(void *mr, int nstride, int kflag, int vflag) {
  return as_u64(bridge_call("mr_print", "(niii)", (Py_ssize_t)mr, nstride,
                            kflag, vflag));
}

void MR_cummulative_stats(void *mr, int level, int reset) {
  drop(bridge_call("mr_cummulative_stats", "(nii)", (Py_ssize_t)mr,
                         level, reset));
}

void MR_kv_add_multi_static(void *kv, int n, const char *key, int keybytes,
                            const char *value, int valuebytes) {
  drop(bridge_call(
      "kv_add_multi_static", "(niy#iy#i)", (Py_ssize_t)kv, n, key,
      (Py_ssize_t)((Py_ssize_t)n * keybytes), keybytes, value,
      (Py_ssize_t)((Py_ssize_t)n * valuebytes), valuebytes));
}

void MR_kv_add_multi_dynamic(void *kv, int n, const char *key,
                             const int *keybytes, const char *value,
                             const int *valuebytes) {
  Py_ssize_t tk = 0, tv = 0;
  for (int i = 0; i < n; i++) {
    tk += keybytes[i];
    tv += valuebytes[i];
  }
  drop(bridge_call(
      "kv_add_multi_dynamic", "(niy#y#y#y#)", (Py_ssize_t)kv, n, key, tk,
      (const char *)keybytes, (Py_ssize_t)(n * (Py_ssize_t)sizeof(int)),
      value, tv, (const char *)valuebytes,
      (Py_ssize_t)(n * (Py_ssize_t)sizeof(int))));
}

/* multi-block multivalue API: the bridge returns (nval, mv, sizes); the
 * buffers stay pinned here until the next block request (reference
 * page-buffer lifetime, src/mapreduce.cpp:1874-1925) */
static PyObject *blk_hold = NULL;

uint64_t MR_multivalue_blocks(void *mr) {
  return as_u64(
      bridge_call("mr_multivalue_blocks", "(n)", (Py_ssize_t)mr));
}

int MR_multivalue_block(void *mr, int iblock, char **ptr_multivalue,
                        int **ptr_valuesizes) {
  PyObject *r =
      bridge_call("mr_multivalue_block", "(ni)", (Py_ssize_t)mr, iblock);
  if (r == NULL) return -1;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(blk_hold);
  blk_hold = r; /* keeps mv + sizes bytes alive */
  long nval = PyLong_AsLong(PyTuple_GetItem(r, 0));
  *ptr_multivalue = PyBytes_AsString(PyTuple_GetItem(r, 1));
  *ptr_valuesizes = (int *)PyBytes_AsString(PyTuple_GetItem(r, 2));
  PyGILState_Release(g);
  return (int)nval;
}

void MR_multivalue_block_select(void *mr, int which) {
  (void)mr;
  (void)which; /* reference 2-page scratch selector; no-op here */
}

/* -- OINK script driver -------------------------------------------- */

void *OINK_open_device(const char *logfile, const char *device) {
  return (void *)(intptr_t)as_u64(
      bridge_call("oink_open", "(zz)", logfile, device));
}

void *OINK_open(const char *logfile) {
  return OINK_open_device(logfile, NULL);
}

int OINK_file(void *oink, const char *path) {
  PyObject *r = bridge_call("oink_file", "(ns)", (Py_ssize_t)oink, path);
  if (r == NULL) return -1;
  Py_DECREF(r);
  return 0;
}

int OINK_command(void *oink, const char *line) {
  PyObject *r = bridge_call("oink_command", "(ns)", (Py_ssize_t)oink, line);
  if (r == NULL) return -1;
  Py_DECREF(r);
  return 0;
}

void OINK_close(void *oink) {
  drop(bridge_call("oink_close", "(n)", (Py_ssize_t)oink));
}
