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

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

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

// Matrix `which` (0, 1 or 2: A, B or C) of `rows`, a list of (A, B, C)
// tuples of {variable: coefficient} dicts, as CSR: counts[r] entries for
// row r and, row by row, the LC's variables in ascending order (cols)
// and their coefficients as the dict holds them (coefs, 4 limbs each),
// at most `cap` entries. With cols == nullptr only counts are written.
// Returns the number of entries, or -1 with a Python error set (a row
// that is not a 3-tuple of dicts, a key that is not a non-negative int,
// a coefficient that is not an int in [0, 2^256), more than cap
// entries).
Py_ssize_t lurk_lc_matrix(PyObject* rows, int which, int64_t* counts,
                          uint64_t* cols, uint64_t* coefs,
                          Py_ssize_t cap) {
    if (!PyList_Check(rows) || which < 0 || which > 2) {
        PyErr_SetString(PyExc_TypeError, "lc_matrix: a list of rows");
        return -1;
    }
    const Py_ssize_t m = PyList_GET_SIZE(rows);
    std::vector<std::pair<uint64_t, PyObject*>> lc;
    unsigned char* buf = reinterpret_cast<unsigned char*>(coefs);
    Py_ssize_t total = 0;
    for (Py_ssize_t r = 0; r < m; ++r) {
        PyObject* row = PyList_GET_ITEM(rows, r);
        if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) != 3 ||
            !PyDict_Check(PyTuple_GET_ITEM(row, which))) {
            PyErr_SetString(PyExc_TypeError,
                            "lc_matrix: a row is not a tuple of 3 dicts");
            return -1;
        }
        PyObject* d = PyTuple_GET_ITEM(row, which);
        counts[r] = PyDict_GET_SIZE(d);
        if (cols == nullptr) {
            total += counts[r];
            continue;
        }
        lc.clear();
        Py_ssize_t pos = 0;
        PyObject *key, *value;
        while (PyDict_Next(d, &pos, &key, &value)) {
            const unsigned long long var =
                PyLong_Check(key) ? PyLong_AsUnsignedLongLong(key) : 0;
            if (!PyLong_Check(key) || PyErr_Occurred()) {
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_TypeError,
                                    "lc_matrix: a variable is not an int");
                return -1;
            }
            lc.emplace_back(var, value);
        }
        if (total + static_cast<Py_ssize_t>(lc.size()) > cap) {
            PyErr_SetString(PyExc_ValueError,
                            "lc_matrix: more entries than counted");
            return -1;
        }
        std::sort(lc.begin(), lc.end(),
                  [](const auto& a, const auto& b) { return a.first < b.first; });
        for (const auto& [var, value] : lc) {
            if (!PyLong_Check(value)) {
                PyErr_SetString(PyExc_TypeError,
                                "lc_matrix: a coefficient is not an int");
                return -1;
            }
            cols[total] = var;
            if (to_bytes(value, buf + 32 * total) < 0) return -1;
            ++total;
        }
    }
    return total;
}

}   // extern "C"
