/* raisr_tpu_torch native I/O runtime.
 *
 * C++ analogue of the data-plane work the reference does in its FFmpeg
 * filters and IPP glue (plane packing, 8/10-bit handling, frame slicing;
 * reference: ffmpeg/vf_raisr.c:226-333, vf_raisr_opencl.c NV12/P010
 * handling). Python-facing via the CPython C API (no pybind11 in the image).
 *
 * Exposed functions (all GIL-releasing on the hot loops):
 *   nv12_to_planar(uv_bytes, h, w, itemsize)  -> (u_bytes, v_bytes)
 *   planar_to_nv12(u_bytes, v_bytes, itemsize) -> uv_bytes
 *   y4m_scan(header_and_data_prefix, file_size) -> (frame_size, offsets...)
 *   pack_batch(list_of_plane_bytes) -> contiguous batch bytes
 *   psnr(a_bytes, b_bytes, itemsize, max_val) -> double
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <string>

namespace {

template <typename T>
void deinterleave(const T* uv, T* u, T* v, size_t n_pairs) {
  for (size_t i = 0; i < n_pairs; ++i) {
    u[i] = uv[2 * i];
    v[i] = uv[2 * i + 1];
  }
}

template <typename T>
void interleave(const T* u, const T* v, T* uv, size_t n_pairs) {
  for (size_t i = 0; i < n_pairs; ++i) {
    uv[2 * i] = u[i];
    uv[2 * i + 1] = v[i];
  }
}

PyObject* nv12_to_planar(PyObject*, PyObject* args) {
  Py_buffer buf;
  int itemsize;
  if (!PyArg_ParseTuple(args, "y*i", &buf, &itemsize)) return nullptr;
  if (itemsize != 1 && itemsize != 2) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "itemsize must be 1 or 2");
    return nullptr;
  }
  size_t n_pairs = (size_t)buf.len / (2 * itemsize);
  PyObject* u = PyBytes_FromStringAndSize(nullptr, n_pairs * itemsize);
  PyObject* v = PyBytes_FromStringAndSize(nullptr, n_pairs * itemsize);
  if (!u || !v) {
    PyBuffer_Release(&buf);
    Py_XDECREF(u);
    Py_XDECREF(v);
    return nullptr;
  }
  Py_BEGIN_ALLOW_THREADS
  if (itemsize == 1)
    deinterleave((const uint8_t*)buf.buf, (uint8_t*)PyBytes_AS_STRING(u),
                 (uint8_t*)PyBytes_AS_STRING(v), n_pairs);
  else
    deinterleave((const uint16_t*)buf.buf, (uint16_t*)PyBytes_AS_STRING(u),
                 (uint16_t*)PyBytes_AS_STRING(v), n_pairs);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return PyTuple_Pack(2, u, v);
}

PyObject* planar_to_nv12(PyObject*, PyObject* args) {
  Py_buffer ub, vb;
  int itemsize;
  if (!PyArg_ParseTuple(args, "y*y*i", &ub, &vb, &itemsize)) return nullptr;
  if (ub.len != vb.len || (itemsize != 1 && itemsize != 2)) {
    PyBuffer_Release(&ub);
    PyBuffer_Release(&vb);
    PyErr_SetString(PyExc_ValueError, "U/V size mismatch or bad itemsize");
    return nullptr;
  }
  size_t n_pairs = (size_t)ub.len / itemsize;
  PyObject* uv = PyBytes_FromStringAndSize(nullptr, 2 * n_pairs * itemsize);
  if (!uv) {
    PyBuffer_Release(&ub);
    PyBuffer_Release(&vb);
    return nullptr;
  }
  Py_BEGIN_ALLOW_THREADS
  if (itemsize == 1)
    interleave((const uint8_t*)ub.buf, (const uint8_t*)vb.buf,
               (uint8_t*)PyBytes_AS_STRING(uv), n_pairs);
  else
    interleave((const uint16_t*)ub.buf, (const uint16_t*)vb.buf,
               (uint16_t*)PyBytes_AS_STRING(uv), n_pairs);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&ub);
  PyBuffer_Release(&vb);
  return uv;
}

/* Scan a Y4M file for FRAME offsets without loading payload.
 * args: (path, frame_bytes) -> list of payload offsets */
PyObject* y4m_scan(PyObject*, PyObject* args) {
  const char* path;
  Py_ssize_t frame_bytes;
  if (!PyArg_ParseTuple(args, "sn", &path, &frame_bytes)) return nullptr;

  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  std::vector<long long> offsets;
  bool corrupt = false;
  Py_BEGIN_ALLOW_THREADS
  {
    // skip stream header line
    int ch;
    while ((ch = fgetc(f)) != EOF && ch != '\n') {
    }
    char marker[6];
    for (;;) {
      long long pos = ftell(f);
      size_t got = fread(marker, 1, 5, f);
      if (got < 5) break;  // EOF
      if (memcmp(marker, "FRAME", 5) != 0) {
        corrupt = true;
        break;
      }
      // skip frame parameters until newline
      while ((ch = fgetc(f)) != EOF && ch != '\n') {
      }
      long long payload = ftell(f);
      if (fseek(f, (long)frame_bytes, SEEK_CUR) != 0) break;
      // verify the payload was complete
      long long end = ftell(f);
      if (end - payload < frame_bytes) break;
      offsets.push_back(payload);
      (void)pos;
    }
  }
  Py_END_ALLOW_THREADS
  fclose(f);
  if (corrupt) {
    PyErr_SetString(PyExc_ValueError, "corrupt Y4M: missing FRAME marker");
    return nullptr;
  }
  PyObject* list = PyList_New(offsets.size());
  for (size_t i = 0; i < offsets.size(); ++i)
    PyList_SET_ITEM(list, i, PyLong_FromLongLong(offsets[i]));
  return list;
}

/* MSE between two equal-size planes -> PSNR needs only this. */
PyObject* mse(PyObject*, PyObject* args) {
  Py_buffer a, b;
  int itemsize;
  if (!PyArg_ParseTuple(args, "y*y*i", &a, &b, &itemsize)) return nullptr;
  if (a.len != b.len || (itemsize != 1 && itemsize != 2)) {
    PyBuffer_Release(&a);
    PyBuffer_Release(&b);
    PyErr_SetString(PyExc_ValueError, "size mismatch or bad itemsize");
    return nullptr;
  }
  double acc = 0.0;
  size_t n = (size_t)a.len / itemsize;
  Py_BEGIN_ALLOW_THREADS
  if (itemsize == 1) {
    const uint8_t* pa = (const uint8_t*)a.buf;
    const uint8_t* pb = (const uint8_t*)b.buf;
    for (size_t i = 0; i < n; ++i) {
      double d = (double)pa[i] - (double)pb[i];
      acc += d * d;
    }
  } else {
    const uint16_t* pa = (const uint16_t*)a.buf;
    const uint16_t* pb = (const uint16_t*)b.buf;
    for (size_t i = 0; i < n; ++i) {
      double d = (double)pa[i] - (double)pb[i];
      acc += d * d;
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&a);
  PyBuffer_Release(&b);
  return PyFloat_FromDouble(acc / (double)n);
}

PyMethodDef methods[] = {
    {"nv12_to_planar", nv12_to_planar, METH_VARARGS,
     "deinterleave NV12/P010 UV plane -> (U, V)"},
    {"planar_to_nv12", planar_to_nv12, METH_VARARGS,
     "interleave planar U, V -> NV12/P010 UV plane"},
    {"y4m_scan", y4m_scan, METH_VARARGS,
     "scan Y4M file, return frame payload offsets"},
    {"mse", mse, METH_VARARGS, "mean squared error of two planes"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_raisrio",
                      "raisr_tpu_torch native I/O runtime", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__raisrio(void) { return PyModule_Create(&module); }
