/* Declarations standing in for <zstd_errors.h>; see zstd.h here. */
#ifndef QZTPU_TORCH_ZSTD_ERRORS_DECL_H
#define QZTPU_TORCH_ZSTD_ERRORS_DECL_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* zstd 1.5's values of the codes named here; the library returns others */
typedef enum {
  ZSTD_error_no_error = 0,
  ZSTD_error_GENERIC = 1,
  ZSTD_error_maxCode = 120
} ZSTD_ErrorCode;

__attribute__((weak)) ZSTD_ErrorCode ZSTD_getErrorCode(size_t code);

#ifdef __cplusplus
}
#endif

#endif
