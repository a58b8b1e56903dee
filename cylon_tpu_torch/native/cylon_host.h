/* cylon_host.h — public C ABI of the cylon_tpu_torch native host runtime
 * (the same ABI as cylon_tpu/native/cylon_host.h, byte for byte).
 *
 * This is the surface a foreign-language binding links against — the
 * same role the reference's JNI bridge plays over its string-id table
 * catalog (`cpp/src/cylon/table_api.hpp:38-90`,
 * `java/src/main/native/src/Table.cpp`). A Java/Go/Rust host calls
 * these with plain buffers; the Python side binds them via ctypes
 * (`cylon_tpu_torch/native/__init__.py`).
 *
 * Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -Wl,-Bsymbolic
 *        cylon_host.cpp -o libcylon_host.so   (done at first use, into
 *        cylon_tpu_torch/_build/)
 *
 * Thread safety: every function is safe to call from any thread; the
 * catalog and pool are internally locked.
 */

#ifndef CYLON_HOST_H_
#define CYLON_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- memory pool (parity: ctx/memory_pool.hpp) --------------------- */
/* 64-byte-aligned allocations with size-bucketed free lists. */
void*    cylon_pool_create(int64_t pool_limit_bytes);
void     cylon_pool_destroy(void* pool);
void*    cylon_pool_alloc(void* pool, int64_t size);
void     cylon_pool_free(void* pool, void* buf, int64_t size);
void     cylon_pool_stats(void* pool, int64_t* bytes_allocated,
                          int64_t* max_memory, int64_t* num_allocations,
                          int64_t* pooled_bytes);

/* ---- murmur3 (parity: util/murmur3.cpp) ---------------------------- */
uint32_t cylon_murmur3_x86_32(const void* key, int len, uint32_t seed);
/* Vectorised per-element hash of an int64 array (the row-hash the
 * hash-partitioner uses); out must hold n uint32. */
void     cylon_murmur3_int64_array(const int64_t* keys, int64_t n,
                                   uint32_t seed, uint32_t* out);

/* ---- thread pool (parity: table.cpp:788 per-file reader threads) --- */
typedef void (*cylon_task_fn)(void* arg);
void*    cylon_threadpool_create(int n_threads);
void     cylon_threadpool_destroy(void* tp);
void     cylon_threadpool_submit(void* tp, cylon_task_fn fn, void* arg);
void     cylon_threadpool_wait(void* tp);

/* ---- chunk-parallel CSV reader (parity: io/csv_read_config) -------- */
/* Column dtypes in results: 0 = int64, 1 = float64, 2 = dictionary-
 * encoded string (int32 codes + per-column dictionary). */
void*       cylon_csv_read(const char* path, char delim, int has_header,
                           int n_threads);
/* Extended options (parity: UseQuoting/WithQuoteChar/NullValues/
 * WithColumnTypes of csv_read_config.hpp):
 *   quote_char  0 disables quoting; else RFC-4180 quoting with doubled
 *               quotes for literals (no embedded newlines).
 *   na_values   '\x1f'-joined null spellings, or NULL.
 *   col_types   "name\x1f<type int>;..." per-column overrides, or NULL. */
void*       cylon_csv_read_opts(const char* path, char delim,
                                int has_header, int n_threads,
                                char quote_char, const char* na_values,
                                const char* col_types,
                                int strings_can_be_null);
const char* cylon_csv_error(void* r);          /* NULL when ok */
int64_t     cylon_csv_num_rows(void* r);
int32_t     cylon_csv_num_cols(void* r);
const char* cylon_csv_col_name(void* r, int32_t col);
int32_t     cylon_csv_col_type(void* r, int32_t col);
void        cylon_csv_col_i64(void* r, int32_t col, int64_t* out);
void        cylon_csv_col_f64(void* r, int32_t col, double* out);
void        cylon_csv_col_codes(void* r, int32_t col, int32_t* out);
void        cylon_csv_col_validity(void* r, int32_t col, uint8_t* out);
int32_t     cylon_csv_dict_size(void* r, int32_t col);
const char* cylon_csv_dict_value(void* r, int32_t col, int32_t code);
void        cylon_csv_free(void* r);

/* ---- string-id table catalog (parity: table_api.hpp) --------------- */
/* dtypes: 0 = int64, 1 = float64, 2 = int32 codes (dictionary handled
 * by the binding layer). Returns 0 on success, negative on error. */
int32_t  cylon_catalog_put(const char* id, int32_t ncols,
                           const char** names, const int32_t* dtypes,
                           int64_t n_rows, const void** data_bufs,
                           const int64_t* data_lens,
                           const uint8_t** validity_bufs);
int64_t  cylon_catalog_rows(const char* id);      /* -1 if missing */
int32_t  cylon_catalog_ncols(const char* id);     /* -1 if missing */
int32_t  cylon_catalog_col_info(const char* id, int32_t i,
                                char* name_out, int32_t name_cap,
                                int32_t* dtype_out,
                                int64_t* data_len_out,
                                int32_t* has_validity_out);
int32_t  cylon_catalog_col_read(const char* id, int32_t i,
                                void* data_out, int64_t data_cap,
                                uint8_t* validity_out);
/* Native host hash join (parity: table_api JoinTables behind the JNI
 * nativeJoin surface, Table.java:289-307; build/probe like
 * join/hash_join.cpp:22-31). Joins catalog tables left_id and right_id
 * on n_keys column-index pairs and stores the result under out_id.
 * join_type: 0 inner, 1 left, 2 right, 3 full outer. Null keys match
 * null keys (pandas merge semantics). Output columns follow the device
 * join (ops/join.py _assemble): same-NAME key pairs emit one coalesced
 * column (right copy dropped); differently-named keys stay separate;
 * remaining name collisions get the _x/_y suffixes.
 * Returns 0, or negative on error (-2 missing id, -3 bad key index,
 * -4 key dtype mismatch). */
int32_t  cylon_catalog_join(const char* left_id, const char* right_id,
                            const char* out_id, int32_t n_keys,
                            const int32_t* left_keys,
                            const int32_t* right_keys,
                            int32_t join_type);
int32_t  cylon_catalog_remove(const char* id);
int32_t  cylon_catalog_size(void);
void     cylon_catalog_clear(void);
/* Write newline-separated ids into buf (cap bytes); returns the number
 * of bytes that would be needed. */
int64_t  cylon_catalog_ids(char* buf, int64_t cap);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* CYLON_HOST_H_ */
