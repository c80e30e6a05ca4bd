/* Declarations of the part of zstd 1.5's API that csrc/qztpu_native.cpp
 * uses, for the port's build of that file.
 *
 * Machines that run the port carry zstd's runtime library, libzstd.so.1,
 * but not always its development files (zstd.h, the libzstd.so link).
 * This header, first on the include path, stands in for <zstd.h>: it
 * declares, and defines nothing. The values below are zstd 1.5's
 * (ZSTD_c_blockDelimiters is ZSTD_c_experimentalParam11 = 1008 and
 * ZSTD_c_validateSequences ZSTD_c_experimentalParam12 = 1009 from 1.5.0
 * on; ZSTD_Sequence has had this layout since 1.4.10). The build links
 * the library by its soname (-l:libzstd.so.1).
 *
 * Every function is declared weak: where libzstd.so.1 is missing, the
 * library still links and loads, the zstd functions stay unresolved, and
 * the Python wrapper (qatzip_tpu_torch/native.py) raises before calling
 * any of them.
 */
#ifndef QZTPU_TORCH_ZSTD_DECL_H
#define QZTPU_TORCH_ZSTD_DECL_H

#include <stddef.h>

#include "zstd_errors.h"

#ifdef __cplusplus
extern "C" {
#endif

#define QZTPU_ZSTD_API __attribute__((weak))

typedef struct ZSTD_CCtx_s ZSTD_CCtx;

typedef struct {
  unsigned int offset;
  unsigned int litLength;
  unsigned int matchLength;
  unsigned int rep;
} ZSTD_Sequence;

typedef enum {
  ZSTD_c_compressionLevel = 100,
  ZSTD_c_blockDelimiters = 1008,
  ZSTD_c_validateSequences = 1009
} ZSTD_cParameter;

typedef enum {
  ZSTD_sf_noBlockDelimiters = 0,
  ZSTD_sf_explicitBlockDelimiters = 1
} ZSTD_sequenceFormat_e;

QZTPU_ZSTD_API ZSTD_CCtx* ZSTD_createCCtx(void);
QZTPU_ZSTD_API size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
QZTPU_ZSTD_API size_t ZSTD_CCtx_setParameter(ZSTD_CCtx* cctx,
                                             ZSTD_cParameter param, int value);
QZTPU_ZSTD_API unsigned ZSTD_isError(size_t code);
QZTPU_ZSTD_API size_t ZSTD_compressBound(size_t src_size);
QZTPU_ZSTD_API size_t ZSTD_compressSequences(ZSTD_CCtx* cctx, void* dst,
                                             size_t dst_cap,
                                             const ZSTD_Sequence* seqs,
                                             size_t nseq, const void* src,
                                             size_t src_size);
QZTPU_ZSTD_API size_t ZSTD_compress(void* dst, size_t dst_cap,
                                    const void* src, size_t src_size,
                                    int level);
QZTPU_ZSTD_API size_t ZSTD_decompress(void* dst, size_t dst_cap,
                                      const void* src, size_t src_size);
QZTPU_ZSTD_API unsigned ZSTD_versionNumber(void);

#ifdef __cplusplus
}
#endif

#endif
