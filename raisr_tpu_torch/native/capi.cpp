/* C ABI implementation (include/raisr_tpu.h) over raisr_tpu_torch — embeds
 * CPython and drives raisr_tpu_torch.capi_bridge. Built by
 * raisr_tpu_torch/native/build_capi.py into build/capi_torch/libraisr_tpu.so,
 * the same library name as raisr_tpu's, so a C consumer (tools/capi_y4m.c,
 * the FFmpeg filter) picks this one with -L / LD_LIBRARY_PATH alone.
 *
 * Threads: the header promises that calls are safe from any thread. When
 * this library starts the interpreter, it gives the GIL back right after
 * Py_InitializeEx (the thread that calls Init would otherwise hold it for
 * good, and a Process from another thread would wait forever); every entry
 * point then takes the GIL with PyGILState_Ensure and releases it before it
 * returns. One process-wide mutex serialises the calls.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>
#include <limits.h>
#include <stdlib.h>
#include <sys/stat.h>

#include <mutex>
#include <string>

#include "../../include/raisr_tpu.h"

namespace {

std::mutex g_mutex;
PyObject* g_bridge = nullptr;
int g_device = -1;  // RTPU_SetDevice selection, applied at Init

// Prepend a directory to sys.path if it contains a raisr_tpu_torch/
// package. Uses the C API directly (no generated source: a path containing
// quotes or backslashes must not be able to alter injected code).
void sys_path_prepend_if_package(const std::string& dir) {
  if (dir.empty()) return;
  char real[PATH_MAX];
  if (!realpath(dir.c_str(), real)) return;
  struct stat st;
  if (stat((std::string(real) + "/raisr_tpu_torch").c_str(), &st) != 0 ||
      !S_ISDIR(st.st_mode))
    return;
  PyObject* path = PySys_GetObject("path");  // borrowed
  if (!path) return;
  PyObject* entry = PyUnicode_DecodeFSDefault(real);
  if (!entry) {
    PyErr_Clear();
    return;
  }
  int present = PySequence_Contains(path, entry);
  if (present == 0) PyList_Insert(path, 0, entry);
  if (present < 0) PyErr_Clear();
  Py_DECREF(entry);
}

// Explicit opt-ins only: RAISR_TPU_TORCH_PYTHONPATH and the tree the shared
// library itself lives in (dladdr: build/capi_torch/libraisr_tpu.so -> the
// checkout's root). The host process's cwd is deliberately NOT consulted —
// an embedding host run inside an untrusted directory must not import a
// planted raisr_tpu_torch/__init__.py from there.
void extend_sys_path() {
  const char* env = getenv("RAISR_TPU_TORCH_PYTHONPATH");
  if (env) sys_path_prepend_if_package(env);
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&extend_sys_path), &info) &&
      info.dli_fname) {
    std::string libdir(info.dli_fname);
    size_t slash = libdir.rfind('/');
    if (slash != std::string::npos) {
      libdir.resize(slash);
      sys_path_prepend_if_package(libdir + "/../..");
      sys_path_prepend_if_package(libdir);
    }
  }
}

// Start the interpreter unless the host already runs one (a Python host
// that loaded this library with ctypes). Call without the GIL.
void ensure_interpreter() {
  if (Py_IsInitialized()) return;
  Py_InitializeEx(0);  // 0: leave the host's signal handlers alone
  PyEval_SaveThread();  // give the GIL back (see the header comment)
}

// Import the bridge once. Call with the GIL held.
bool ensure_bridge() {
  if (g_bridge) return true;
  extend_sys_path();
  g_bridge = PyImport_ImportModule("raisr_tpu_torch.capi_bridge");
  if (!g_bridge) {
    PyErr_Print();
    return false;
  }
  return true;
}

PyObject* plane_tuple(const RTPUPlane* p) {
  if (!p || !p->data) Py_RETURN_NONE;
  return Py_BuildValue("(KIII)", (unsigned long long)(uintptr_t)p->data,
                       p->width, p->height, p->step);
}

RTPUStatus call_int(PyObject* result) {
  if (!result) {
    PyErr_Print();
    return RTPU_ERROR_UNDEFINED;
  }
  long rc = PyLong_AsLong(result);
  Py_DECREF(result);
  return rc == 0 ? RTPU_OK : RTPU_ERROR_BAD_PARAMETER;
}

}  // namespace

extern "C" {

RTPUStatus RTPU_InitEx(const char* model_path, float ratio,
                       unsigned int bit_depth, RTPURangeType range,
                       unsigned int passes, unsigned int two_pass_mode,
                       RTPUTier tier) {
  std::lock_guard<std::mutex> lock(g_mutex);
  ensure_interpreter();
  PyGILState_STATE gil = PyGILState_Ensure();
  RTPUStatus status = RTPU_ERROR_UNDEFINED;
  if (ensure_bridge()) {
    status = RTPU_OK;
    if (g_device >= 0)
      status = call_int(
          PyObject_CallMethod(g_bridge, "set_device", "i", g_device));
    if (status == RTPU_OK)
      status = call_int(PyObject_CallMethod(
          g_bridge, "init", "sfiiiii", model_path, (double)ratio,
          (int)bit_depth, (int)range, (int)passes, (int)two_pass_mode,
          (int)tier));
  }
  PyGILState_Release(gil);
  return status;
}

RTPUStatus RTPU_SetDevice(int device_index) {
  /* Stored and applied at Init: the embedded interpreter (and the card
   * count) may not exist yet when the host calls this. */
  std::lock_guard<std::mutex> lock(g_mutex);
  if (device_index < 0) return RTPU_ERROR_BAD_PARAMETER;
  g_device = device_index;
  return RTPU_OK;
}

RTPUStatus RTPU_Init(const char* model_path, float ratio,
                     unsigned int bit_depth, RTPURangeType range,
                     unsigned int passes, unsigned int two_pass_mode) {
  return RTPU_InitEx(model_path, ratio, bit_depth, range, passes,
                     two_pass_mode, RTPU_TIER_F32);
}

RTPUStatus RTPU_SetRes(const RTPUPlane*, const RTPUPlane*, const RTPUPlane*,
                       const RTPUPlane*, const RTPUPlane*, const RTPUPlane*) {
  /* PyTorch runs eagerly: nothing to specialise on the geometry. Kept for
   * call-sequence compatibility with the reference lifecycle. */
  return RTPU_OK;
}

RTPUStatus RTPU_Process(const RTPUPlane* in_y, const RTPUPlane* in_cb,
                        const RTPUPlane* in_cr, RTPUPlane* out_y,
                        RTPUPlane* out_cb, RTPUPlane* out_cr,
                        RTPUBlendingMode blending) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_bridge) return RTPU_ERROR_BAD_PARAMETER;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_BuildValue(
      "(NNNNNNi)", plane_tuple(in_y), plane_tuple(in_cb), plane_tuple(in_cr),
      plane_tuple(out_y), plane_tuple(out_cb), plane_tuple(out_cr),
      (int)blending);
  PyObject* fn = PyObject_GetAttrString(g_bridge, "process");
  PyObject* r = fn && args ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_XDECREF(args);
  RTPUStatus status = call_int(r);
  PyGILState_Release(gil);
  return status;
}

const char* RTPU_Version(void) {
#define RTPU_STR_(x) #x
#define RTPU_STR(x) RTPU_STR_(x)
  return RTPU_STR(RAISR_TPU_VERSION_MAJOR) "." RTPU_STR(
      RAISR_TPU_VERSION_MINOR) "." RTPU_STR(RAISR_TPU_VERSION_PATCH);
#undef RTPU_STR
#undef RTPU_STR_
}

RTPUStatus RTPU_Deinit(void) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_bridge) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(g_bridge, "deinit", nullptr);
    if (!r) PyErr_Print();
    Py_XDECREF(r);
    Py_DECREF(g_bridge);
    g_bridge = nullptr;
    PyGILState_Release(gil);
  }
  return RTPU_OK;
}

}  /* extern "C" */
