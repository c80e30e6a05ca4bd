/* The C entry points of the port's CUDA kernels.
 *
 * Defined in the .cu sources of this directory (each includes this header,
 * so a definition that drifts from its declaration does not compile) and
 * called by the Python binding (binding.c). Pointers are device pointers,
 * `stream` a cudaStream_t; each entry launches its kernel on that stream
 * and returns the launch's error (0 when the launch was taken).
 */
#ifndef QZ_KERNELS_H_
#define QZ_KERNELS_H_

#ifdef __cplusplus
extern "C" {
#endif

int qz_candidate_search(const void* key, const void* ctx, void* out, int rows,
                        int w, int pbits, int ctx_words, int probes,
                        int min_match, void* stream);
int qz_parse_scan(const void* is_match, const void* ml, void* taken,
                  void* lit, int lanes, int seg, void* stream);
int qz_pack_rows(const void* data, const void* ml, const void* dist,
                 const void* taken, const void* lit, const void* lpack,
                 const void* dpack, const void* base, void* words, void* end,
                 int rows, int n, int max_words, void* stream);
int qz_huffman_lookup(const void* lit_pack, const void* dist_pack,
                      const void* sym, const void* dsym, void* lout,
                      void* dout, int rows, int n, void* stream);
int qz_symbol_histogram(const void* sym, const void* dsym, void* hist,
                        int rows, int n, void* stream);
int qz_lz4_pack_rows(const void* data, const void* ml, const void* dist,
                     const void* taken, const void* lit, void* words,
                     void* nbytes, void* ok, int rows, int n, int max_words,
                     void* stream);
int qz_lane_gather(const void* x, const void* idx, void* out, int rows,
                   int log_c, void* stream);
int qz_sublane_gather(const void* x, const void* idx, void* out, int log_r,
                      int log_c, void* stream);
int qz_roll_sum(const void* x, const void* shifts, int nshift, void* out,
                int rows, void* stream);
int qz_bitonic128(const void* keys, const void* vals, void* kout, void* vout,
                  int rows, void* stream);
const char* qz_cuda_error_string(int code);

#ifdef __cplusplus
}
#endif

#endif  /* QZ_KERNELS_H_ */
