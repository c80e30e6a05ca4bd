/* The Python binding of the port's CUDA kernels: the extension module
 * _qz_kernels, linked into one shared object with the kernels.
 *
 * One METH_FASTCALL function a kernel, named as the kernel. Each takes the
 * C entry's arguments as Python ints, in its order (qz_kernels.h): device
 * pointers as ints from Tensor.data_ptr() (0 for a null pointer), the
 * stream as the int torch._C._cuda_getCurrentRawStream gives. It converts
 * them, calls the entry (one launch, its error returned) and returns None,
 * or raises RuntimeError("<kernel> launch failed: cudaError <n> (<text>)")
 * when the launch was refused. The Python wrappers (the ops modules)
 * check the tensors before they call.
 *
 * Plain C against Python.h alone: no PyTorch header, so the host compiler
 * builds it in well under a second.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <limits.h>

#include "qz_kernels.h"

/* Convert the arguments by their signature, one letter each: 'p' a
 * pointer (an int >= 0), 'i' a C int. Returns 0 with an exception set on
 * a wrong count, a value that is not an int, or one out of range. */
static int take(const char* name, const char* sig, Py_ssize_t want,
                PyObject* const* args, Py_ssize_t nargs, Py_ssize_t* v) {
  if (nargs != want) {
    PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)", name,
                 want, nargs);
    return 0;
  }
  for (Py_ssize_t i = 0; i < want; ++i) {
    v[i] = PyLong_AsSsize_t(args[i]);
    if (v[i] == -1 && PyErr_Occurred()) return 0;
    if (sig[i] == 'i' ? v[i] < INT_MIN || v[i] > INT_MAX : v[i] < 0) {
      PyErr_Format(PyExc_OverflowError, "%s: argument %zd (%zd) is out of "
                   "range", name, i, v[i]);
      return 0;
    }
  }
  return 1;
}

static PyObject* done(const char* name, int rc) {
  if (rc == 0) Py_RETURN_NONE;
  PyErr_Format(PyExc_RuntimeError, "%s launch failed: cudaError %d (%s)",
               name, rc, qz_cuda_error_string(rc));
  return NULL;
}

#define P(i) ((void*)v[i])
#define I(i) ((int)v[i])
#define ENTRY(name, sig, ...)                                               \
  static PyObject* py_##name(PyObject* self, PyObject* const* args,        \
                             Py_ssize_t nargs) {                            \
    Py_ssize_t v[sizeof(sig) - 1];                                          \
    (void)self;                                                             \
    if (!take(#name, sig, sizeof(sig) - 1, args, nargs, v)) return NULL;   \
    return done(#name, qz_##name(__VA_ARGS__));                             \
  }

ENTRY(candidate_search, "pppiiiiiip", P(0), P(1), P(2), I(3), I(4), I(5),
      I(6), I(7), I(8), P(9))
ENTRY(parse_scan, "ppppiip", P(0), P(1), P(2), P(3), I(4), I(5), P(6))
ENTRY(pack_rows, "ppppppppppiiip", P(0), P(1), P(2), P(3), P(4), P(5), P(6),
      P(7), P(8), P(9), I(10), I(11), I(12), P(13))
ENTRY(huffman_lookup, "ppppppiip", P(0), P(1), P(2), P(3), P(4), P(5), I(6),
      I(7), P(8))
ENTRY(symbol_histogram, "pppiip", P(0), P(1), P(2), I(3), I(4), P(5))
ENTRY(lz4_pack_rows, "ppppppppiiip", P(0), P(1), P(2), P(3), P(4), P(5),
      P(6), P(7), I(8), I(9), I(10), P(11))
ENTRY(lane_gather, "pppiip", P(0), P(1), P(2), I(3), I(4), P(5))
ENTRY(sublane_gather, "pppiip", P(0), P(1), P(2), I(3), I(4), P(5))
ENTRY(roll_sum, "ppipip", P(0), P(1), I(2), P(3), I(4), P(5))
ENTRY(bitonic128, "ppppip", P(0), P(1), P(2), P(3), I(4), P(5))
ENTRY(lz4_resolve_refs, "pppiiip", P(0), P(1), P(2), I(3), I(4), I(5), P(6))
ENTRY(crc32_rows, "ppppiiip", P(0), P(1), P(2), P(3), I(4), I(5), I(6),
      P(7))
ENTRY(search_inputs, "ppppiiiiiiiip", P(0), P(1), P(2), P(3), I(4), I(5),
      I(6), I(7), I(8), I(9), I(10), I(11), P(12))
ENTRY(parse_inputs, "pppppppppiiiiiiiiiip", P(0), P(1), P(2), P(3), P(4),
      P(5), P(6), P(7), P(8), I(9), I(10), I(11), I(12), I(13), I(14),
      I(15), I(16), I(17), I(18), P(19))
ENTRY(symbol_planes, "pppppppiiip", P(0), P(1), P(2), P(3), P(4), P(5), P(6),
      I(7), I(8), I(9), P(10))

#define METHOD(name) \
  {#name, (PyCFunction)(void (*)(void))py_##name, METH_FASTCALL, NULL}

static PyMethodDef methods[] = {
    METHOD(candidate_search), METHOD(parse_scan),   METHOD(pack_rows),
    METHOD(huffman_lookup),   METHOD(symbol_histogram),
    METHOD(lz4_pack_rows),    METHOD(lane_gather),  METHOD(sublane_gather),
    METHOD(roll_sum),         METHOD(bitonic128),   METHOD(lz4_resolve_refs),
    METHOD(crc32_rows),       METHOD(search_inputs), METHOD(parse_inputs),
    METHOD(symbol_planes),    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_qz_kernels",
    "The CUDA kernels of qatzip_tpu_torch (see binding.c).", -1, methods,
    NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__qz_kernels(void) { return PyModule_Create(&module); }
