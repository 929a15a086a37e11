// smnative — native host-side runtime helpers for simplemath_tpu.
//
// The reference implements its whole runtime in C++ (header-only SIMD
// kernels + shape machinery).  On the accelerator the *compute* path
// belongs to XLA, but the host-side array plumbing the reference does natively
// stays native here too:
//
//  * nested-sequence parsing: shape inference + flattening of arbitrarily
//    nested python lists into a contiguous buffer in one C pass (analog of
//    the nested initializer_list ctor, reference include/SMArray.h:36-68,
//    which memcpys children level by level);
//  * row-major stride computation (reference include/SMArray.h:357-364);
//  * NumPy-style broadcast shape resolution (reference
//    include/SMUtils.h:34-99) without python-level loops.
//
// Built as a plain CPython extension (no pybind11 dependency) by
// native/build.py; simplemath_tpu falls back to pure python when the module
// is absent.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Shape inference over nested python sequences (lists/tuples).
// ---------------------------------------------------------------------------
static int infer_shape(PyObject* obj, std::vector<Py_ssize_t>& shape,
                       int depth) {
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
    if ((int)shape.size() <= depth) {
      shape.push_back(n);
    } else if (shape[depth] != n) {
      PyErr_SetString(PyExc_ValueError,
                      "ragged nested sequence: inconsistent lengths");
      return -1;
    }
    if (n == 0) return 0;
    PyObject** items = PySequence_Fast_ITEMS(obj);
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (infer_shape(items[i], shape, depth + 1) < 0) return -1;
    }
    return 0;
  }
  // Leaf: nothing to record; rank fixed by first leaf's depth.  A leaf at a
  // depth where another branch had a sequence is ragged.
  if ((int)shape.size() > depth) {
    PyErr_SetString(PyExc_ValueError,
                    "ragged nested sequence: mixed leaf depth");
    return -1;
  }
  return 0;
}

// Flatten leaves in row-major order into double or int64 buffers.  Returns
// 0 = all ints, 1 = floats present, -1 = error.
static int flatten(PyObject* obj, double* fbuf, int64_t* ibuf,
                   Py_ssize_t* idx, int is_float) {
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
    PyObject** items = PySequence_Fast_ITEMS(obj);
    int any_float = is_float;
    for (Py_ssize_t i = 0; i < n; ++i) {
      int r = flatten(items[i], fbuf, ibuf, idx, is_float);
      if (r < 0) return -1;
      any_float |= r;
    }
    return any_float;
  }
  if (PyFloat_Check(obj)) {
    fbuf[*idx] = PyFloat_AS_DOUBLE(obj);
    ibuf[*idx] = (int64_t)fbuf[*idx];
    (*idx)++;
    return 1;
  }
  if (PyLong_Check(obj)) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow != 0) {
      PyErr_SetString(PyExc_OverflowError, "integer too large for int64");
      return -1;
    }
    ibuf[*idx] = (int64_t)v;
    fbuf[*idx] = (double)v;
    (*idx)++;
    return 0;
  }
  if (PyBool_Check(obj)) {
    int64_t v = (obj == Py_True) ? 1 : 0;
    ibuf[*idx] = v;
    fbuf[*idx] = (double)v;
    (*idx)++;
    return 0;
  }
  PyErr_Format(PyExc_TypeError, "unsupported leaf type %s",
               Py_TYPE(obj)->tp_name);
  return -1;
}

// parse_nested(obj) -> (shape_tuple, bytes, is_float)
//   bytes holds float64 data if is_float else int64 data, row-major.
static PyObject* parse_nested(PyObject* /*self*/, PyObject* args) {
  PyObject* obj;
  if (!PyArg_ParseTuple(args, "O", &obj)) return nullptr;

  std::vector<Py_ssize_t> shape;
  if (infer_shape(obj, shape, 0) < 0) return nullptr;

  Py_ssize_t total = 1;
  for (Py_ssize_t s : shape) total *= s;

  std::vector<double> fbuf(total);
  std::vector<int64_t> ibuf(total);
  Py_ssize_t idx = 0;
  int is_float = flatten(obj, fbuf.data(), ibuf.data(), &idx, 0);
  if (is_float < 0) return nullptr;
  if (idx != total) {
    PyErr_SetString(PyExc_ValueError, "internal: leaf count mismatch");
    return nullptr;
  }

  PyObject* shape_tuple = PyTuple_New((Py_ssize_t)shape.size());
  for (size_t d = 0; d < shape.size(); ++d) {
    PyTuple_SET_ITEM(shape_tuple, (Py_ssize_t)d,
                     PyLong_FromSsize_t(shape[d]));
  }
  PyObject* data;
  if (is_float) {
    data = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(fbuf.data()),
        (Py_ssize_t)(total * sizeof(double)));
  } else {
    data = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(ibuf.data()),
        (Py_ssize_t)(total * sizeof(int64_t)));
  }
  PyObject* out = Py_BuildValue("(NNi)", shape_tuple, data, is_float);
  return out;
}

// row_major_strides(shape_tuple) -> strides tuple (in elements).
static PyObject* row_major_strides(PyObject* /*self*/, PyObject* args) {
  PyObject* shape;
  if (!PyArg_ParseTuple(args, "O", &shape)) return nullptr;
  Py_ssize_t nd = PySequence_Size(shape);
  if (nd < 0) return nullptr;
  std::vector<Py_ssize_t> dims(nd);
  for (Py_ssize_t d = 0; d < nd; ++d) {
    PyObject* item = PySequence_GetItem(shape, d);
    dims[d] = PyLong_AsSsize_t(item);
    Py_DECREF(item);
    if (dims[d] == -1 && PyErr_Occurred()) return nullptr;
  }
  std::vector<Py_ssize_t> strides(nd);
  Py_ssize_t acc = 1;
  for (Py_ssize_t d = nd - 1; d >= 0; --d) {
    strides[d] = acc;
    acc *= dims[d];
  }
  PyObject* out = PyTuple_New(nd);
  for (Py_ssize_t d = 0; d < nd; ++d) {
    PyTuple_SET_ITEM(out, d, PyLong_FromSsize_t(strides[d]));
  }
  return out;
}

// broadcast_shapes(shape_a, shape_b) -> result shape tuple, or ValueError.
// Mirrors reference include/SMUtils.h:34-99 (right-aligned, 1-extends).
static PyObject* broadcast_shapes_native(PyObject* /*self*/, PyObject* args) {
  PyObject *sa, *sb;
  if (!PyArg_ParseTuple(args, "OO", &sa, &sb)) return nullptr;
  Py_ssize_t na = PySequence_Size(sa), nb = PySequence_Size(sb);
  if (na < 0 || nb < 0) return nullptr;
  Py_ssize_t nd = na > nb ? na : nb;
  std::vector<Py_ssize_t> out(nd);
  for (Py_ssize_t d = 0; d < nd; ++d) {
    Py_ssize_t ia = d - (nd - na);
    Py_ssize_t ib = d - (nd - nb);
    Py_ssize_t va = 1, vb = 1;
    if (ia >= 0) {
      PyObject* item = PySequence_GetItem(sa, ia);
      va = PyLong_AsSsize_t(item);
      Py_DECREF(item);
    }
    if (ib >= 0) {
      PyObject* item = PySequence_GetItem(sb, ib);
      vb = PyLong_AsSsize_t(item);
      Py_DECREF(item);
    }
    if (va == vb || vb == 1) {
      out[d] = va;
    } else if (va == 1) {
      out[d] = vb;
    } else {
      PyErr_Format(PyExc_ValueError,
                   "operands could not be broadcast together (dim %zd: %zd "
                   "vs %zd)",
                   d, va, vb);
      return nullptr;
    }
  }
  PyObject* tup = PyTuple_New(nd);
  for (Py_ssize_t d = 0; d < nd; ++d) {
    PyTuple_SET_ITEM(tup, d, PyLong_FromSsize_t(out[d]));
  }
  return tup;
}

static PyMethodDef Methods[] = {
    {"parse_nested", parse_nested, METH_VARARGS,
     "Infer shape and flatten a nested sequence into a contiguous buffer."},
    {"row_major_strides", row_major_strides, METH_VARARGS,
     "Row-major element strides for a shape."},
    {"broadcast_shapes", broadcast_shapes_native, METH_VARARGS,
     "NumPy-style broadcast of two shapes."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_smnative",
    "Native host-side runtime helpers for simplemath_tpu.", -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__smnative(void) { return PyModule_Create(&moduledef); }
