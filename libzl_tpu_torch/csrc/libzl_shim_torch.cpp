/*
 * libzl_shim_torch.cpp — the libzl C ABI over the PyTorch/CUDA port.
 *
 * native/libzl_shim.cpp implements every libzl.h entry point by forwarding
 * it to the Python module it imports in initJuce(), libzl_tpu.capi.bridge.
 * This file compiles that shim unchanged and points its one import at the
 * port's bridge, libzl_tpu_torch.capi.bridge, which exposes the same
 * functions under the same names. Python.h is included first, so the macro
 * below renames only the shim's own call.
 *
 * Build: libzl_tpu_torch/_build.py::build_shim (g++ with native/Makefile's
 * flags, -I native, linked with `python3-config --ldflags --embed`).
 */

#include <Python.h>

#include <cstring>

static PyObject *zl_import_port_bridge(const char *name) {
  if (std::strcmp(name, "libzl_tpu.capi.bridge") == 0) {
    name = "libzl_tpu_torch.capi.bridge";
  }
  return PyImport_ImportModule(name);
}

#define PyImport_ImportModule zl_import_port_bridge
#include "libzl_shim.cpp"
