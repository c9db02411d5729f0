// Bulk Python int <-> packed 4 x 64-bit little-endian limb conversion.
//
// The fold moves vectors of about 10^6 field elements between Python
// ints and the packed limbs that the host R1CS (r1cs.cpp), the host MSM
// (msm.cpp) and the MSM kernel (csrc/msm.cu, as 8 x 32-bit words) take.
// int.to_bytes per element, or numpy over object arrays
// (ops/field.py:ints_to_words), is 10-20x slower than the CPython
// big-int API used here. The counterpart of the JAX package's
// lurk_tpu/native/fastpack.c, with a plain C interface: it is loaded
// with ctypes.PyDLL (the interpreter lock held, a Python error raised
// after the call) by lurk_tpu_torch/hostlib/fastpack.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

// 32 little-endian bytes of a non-negative int below 2^256; -1 with
// OverflowError set otherwise.
int to_bytes(PyObject* v, unsigned char* out) {
#if PY_VERSION_HEX >= 0x030D0000
    return _PyLong_AsByteArray(reinterpret_cast<PyLongObject*>(v), out, 32,
                               /*little_endian=*/1, /*is_signed=*/0,
                               /*with_exceptions=*/1);
#else
    return _PyLong_AsByteArray(reinterpret_cast<PyLongObject*>(v), out, 32,
                               /*little_endian=*/1, /*is_signed=*/0);
#endif
}

}   // namespace

extern "C" {

// seq (a list or tuple of n ints in [0, 2^256)) -> out[4 n] limbs.
// Returns 0, or -1 with TypeError (an element that is not an int) or
// OverflowError (negative, or 2^256 or more) set.
int lurk_pack_ints(PyObject* seq, uint64_t* out) {
    PyObject* fast = PySequence_Fast(seq, "pack_ints expects a sequence");
    if (fast == nullptr) return -1;
    const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject** items = PySequence_Fast_ITEMS(fast);
    unsigned char* buf = reinterpret_cast<unsigned char*>(out);
    for (Py_ssize_t i = 0; i < n; ++i) {
        if (!PyLong_Check(items[i])) {
            PyErr_SetString(PyExc_TypeError, "pack_ints: non-int element");
            Py_DECREF(fast);
            return -1;
        }
        if (to_bytes(items[i], buf + 32 * i) < 0) {
            Py_DECREF(fast);
            return -1;
        }
    }
    Py_DECREF(fast);
    return 0;
}

// in[4 n] limbs -> the n items of `list` (a list of length n), as ints.
// Returns 0, or -1 with a Python error set.
int lurk_unpack_ints(const uint64_t* in, Py_ssize_t n, PyObject* list) {
    if (!PyList_Check(list) || PyList_GET_SIZE(list) != n) {
        PyErr_SetString(PyExc_ValueError, "unpack_ints: list of n expected");
        return -1;
    }
    const unsigned char* buf = reinterpret_cast<const unsigned char*>(in);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject* v = _PyLong_FromByteArray(buf + 32 * i, 32,
                                            /*little_endian=*/1,
                                            /*is_signed=*/0);
        if (v == nullptr) return -1;
        PyList_SetItem(list, i, v);      // steals v, releases the old item
    }
    return 0;
}

}   // extern "C"
