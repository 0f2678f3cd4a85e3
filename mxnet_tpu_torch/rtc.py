"""Runtime kernel compilation: ``mx.rtc`` on the card.

Counterpart: ``mxnet_tpu/rtc.py``, where a user kernel is a Pallas
function (``PallasModule``) and ``CudaModule`` raises.  Here
``CudaModule`` is the MXNet 1.0 surface it cites (python/mxnet/rtc.py):

    mod = mx.rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("add", "const float *x, const float *y, "
                              "float *out, long n")
    k.launch([x, y, out, n], mx.gpu(0), (blocks, 1, 1), (256, 1, 1))

``source`` is compiled by NVRTC for ``sm_90a`` straight to a cubin
(``nvrtcGetCUBIN``: no PTX, so no driver JIT), loaded into the device's
primary context with the driver API (``cuModuleLoadData``,
``cuModuleGetFunction``) and launched with ``cuLaunchKernel`` on
PyTorch's current stream, all through ``ctypes``.  ``extern "C"`` names
are used as they are; C++ names listed in ``exports`` are resolved to
their mangled names with ``nvrtcAddNameExpression`` /
``nvrtcGetLoweredName``.  A compiled cubin is cached in memory by the
hash of the source and options.

Nothing runs on the CPU: ``CudaModule`` raises without a CUDA device,
``launch`` refuses a CPU context, and a failed compile or launch raises
:class:`MXNetError` with NVRTC's log or the CUDA error; there is no
fallback.  ``launch`` writes into the tensors of its non-const pointer
arguments in place, the one in-place write the port sanctions (no two
NDArrays share storage), and bumps their version.

``PallasModule`` keeps the JAX package's register / ``get_kernel`` /
``launch`` contract for Python callables on tensors.  Nothing is loaded
or compiled when this module is imported.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as _np
import torch

from .base import MXNetError, numeric_types
from .context import Context, current_context
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "parse_signature", "add_reference", "launches", "ARCH"]

ARCH = "sm_90a"

#: CudaKernel launches since the last reset, by kernel name
launches: collections.Counter = collections.Counter()

# C type of a signature argument -> (torch dtype, ctypes type of a scalar)
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "char": (torch.int8, ctypes.c_int8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "long": (torch.int64, ctypes.c_int64),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const)?\s*(\w+)\s*(\*)?\s*(\w+)?\s*$")


class KernelArg(NamedTuple):
    """One parsed kernel parameter."""
    ctype: str             # the C type name, e.g. "float"
    dtype: torch.dtype     # its torch dtype
    pointer: bool          # an array argument (an NDArray)
    const: bool            # a read-only array


def parse_signature(signature: str) -> List[KernelArg]:
    """The parameters of a kernel prototype such as ``"const float *x,
    float *out, long n"``: each ``(const) type (*) (name)`` becomes a
    :class:`KernelArg` (ref: python/mxnet/rtc.py get_kernel).  Raises
    :class:`MXNetError` on a malformed parameter or an unknown type, a
    const scalar, or a scalar of a type that has no host form."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError('invalid kernel parameter "%s": must be of the '
                             'form "(const) type (*) (name)"' % arg.strip())
        const, ctype, star = bool(m.group(1)), m.group(2), bool(m.group(3))
        if ctype not in _CTYPES:
            raise MXNetError("unsupported kernel parameter type %r in %r; "
                             "supported: %s" % (ctype, arg.strip(),
                                                ", ".join(_CTYPES)))
        if not star and (const or _CTYPES[ctype][1] is None):
            raise MXNetError("kernel parameter %r: scalars must be plain "
                             "numbers of a host type" % arg.strip())
        out.append(KernelArg(ctype, _CTYPES[ctype][0], star, const))
    return out


def add_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version of ``csrc/rtc/add.cu``: ``x + y``."""
    return x + y


# ---------------------------------------------------------------------------
# NVRTC and the CUDA driver, through ctypes, loaded at first use
# ---------------------------------------------------------------------------
def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
                or "/usr/local/cuda")


def _nvrtc_dirs() -> List[Path]:
    """Where libnvrtc is looked for: the toolkit's lib64 first, then the
    copies that PyTorch's wheels carry."""
    home = _cuda_home()
    dirs = [home / "lib64", home / "targets" / "x86_64-linux" / "lib"]
    torch_dir = Path(torch.__file__).resolve().parent
    dirs += [torch_dir.parent / "nvidia" / "cuda_nvrtc" / "lib",
             torch_dir / "lib"]
    return dirs


class _Nvrtc:
    """The NVRTC functions this module calls."""

    def __init__(self):
        tried = []
        for d in _nvrtc_dirs():
            # the toolkit's libnvrtc.so (not libnvrtc.alt.so, whose C++
            # has a 32-bit ``long``) or a wheel's hashed libnvrtc-*.so
            libs = [p for p in sorted(d.glob("libnvrtc*.so*"))
                    if "builtins" not in p.name and ".alt." not in p.name]
            for lib in libs:
                tried.append(str(lib))
                try:
                    # NVRTC dlopens its builtins library at compile time:
                    # load the one beside it first, so it is found
                    for b in sorted(d.glob("libnvrtc-builtins*.so*")):
                        if ".alt." not in b.name:
                            ctypes.CDLL(str(b), mode=ctypes.RTLD_GLOBAL)
                    self.lib = ctypes.CDLL(str(lib))
                except OSError:
                    continue
                self.path = str(lib)
                self._declare()
                return
        raise MXNetError(
            "libnvrtc not found: mx.rtc compiles CUDA sources with NVRTC "
            "(searched %s; found %s)"
            % (", ".join(str(d) for d in _nvrtc_dirs()), tried or "none"))

    def _declare(self):
        L, P, S = self.lib, ctypes.c_void_p, ctypes.c_size_t
        sig = {
            "nvrtcVersion": [ctypes.POINTER(ctypes.c_int)] * 2,
            "nvrtcCreateProgram": [ctypes.POINTER(P), ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int, P, P],
            "nvrtcAddNameExpression": [P, ctypes.c_char_p],
            "nvrtcCompileProgram": [P, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_char_p)],
            "nvrtcGetProgramLogSize": [P, ctypes.POINTER(S)],
            "nvrtcGetProgramLog": [P, ctypes.c_char_p],
            "nvrtcGetCUBINSize": [P, ctypes.POINTER(S)],
            "nvrtcGetCUBIN": [P, ctypes.c_char_p],
            "nvrtcGetLoweredName": [P, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_char_p)],
            "nvrtcDestroyProgram": [ctypes.POINTER(P)],
        }
        for name, argtypes in sig.items():
            fn = getattr(L, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        L.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        L.nvrtcGetErrorString.restype = ctypes.c_char_p

    def check(self, rc: int, what: str, log: str = "") -> None:
        if rc != 0:
            msg = self.lib.nvrtcGetErrorString(rc).decode()
            raise MXNetError("NVRTC %s failed: %s (%d)%s"
                             % (what, msg, rc, "\n" + log if log else ""))

    def version(self) -> str:
        major, minor = ctypes.c_int(), ctypes.c_int()
        self.check(self.lib.nvrtcVersion(ctypes.byref(major),
                                         ctypes.byref(minor)), "version")
        return "%d.%d" % (major.value, minor.value)

    def compile(self, source: str, options: Sequence[str],
                names: Sequence[str]):
        """``(cubin bytes, {name: lowered name}, log)``."""
        L = self.lib
        prog = ctypes.c_void_p()
        self.check(L.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        b"mx_rtc.cu", 0, None, None),
                   "nvrtcCreateProgram")
        try:
            for n in names:
                self.check(L.nvrtcAddNameExpression(prog, n.encode()),
                           "nvrtcAddNameExpression(%s)" % n)
            opts = (ctypes.c_char_p * len(options))(
                *[o.encode() for o in options])
            rc = L.nvrtcCompileProgram(prog, len(options), opts)
            size = ctypes.c_size_t()
            self.check(L.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                       "nvrtcGetProgramLogSize")
            buf = ctypes.create_string_buffer(size.value)
            self.check(L.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
            log = buf.value.decode(errors="replace")
            self.check(rc, "compile (options %s)" % " ".join(options), log)
            self.check(L.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                       "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            self.check(L.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for n in names:
                p = ctypes.c_char_p()
                self.check(L.nvrtcGetLoweredName(prog, n.encode(),
                                                 ctypes.byref(p)),
                           "nvrtcGetLoweredName(%s)" % n)
                lowered[n] = p.value.decode()
            return cubin.raw, lowered, log
        finally:
            L.nvrtcDestroyProgram(ctypes.byref(prog))


class _Driver:
    """The CUDA driver functions this module calls (``libcuda.so.1``,
    which PyTorch has loaded already)."""

    CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

    def __init__(self):
        try:
            L = self.lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("the CUDA driver (libcuda.so.1) cannot be "
                             "loaded: %s" % e) from None
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        sig = {
            "cuInit": [U],
            "cuDeviceGet": [ctypes.POINTER(I), I],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(P), I],
            "cuCtxPushCurrent_v2": [P],
            "cuCtxPopCurrent_v2": [ctypes.POINTER(P)],
            "cuModuleLoadData": [ctypes.POINTER(P), ctypes.c_char_p],
            "cuModuleGetFunction": [ctypes.POINTER(P), P, ctypes.c_char_p],
            "cuFuncSetAttribute": [P, I, I],
            "cuLaunchKernel": [P, U, U, U, U, U, U, U, P,
                               ctypes.POINTER(P), ctypes.POINTER(P)],
            "cuGetErrorName": [I, ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, argtypes in sig.items():
            fn = getattr(L, name)
            fn.argtypes, fn.restype = argtypes, I
        self.check(L.cuInit(0), "cuInit")
        self._primary: Dict[int, ctypes.c_void_p] = {}

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            name = ctypes.c_char_p()
            self.lib.cuGetErrorName(rc, ctypes.byref(name))
            raise MXNetError("CUDA driver %s failed: %s (%d)"
                             % (what, (name.value or b"?").decode(), rc))

    def primary_context(self, index: int) -> ctypes.c_void_p:
        """The primary context of device ``index``, the one PyTorch's
        runtime uses, retained once per process."""
        ctx = self._primary.get(index)
        if ctx is None:
            dev = ctypes.c_int()
            self.check(self.lib.cuDeviceGet(ctypes.byref(dev), index),
                       "cuDeviceGet")
            ctx = ctypes.c_void_p()
            self.check(self.lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                         dev),
                       "cuDevicePrimaryCtxRetain")
            self._primary[index] = ctx
        return ctx

    def push(self, index: int) -> None:
        self.check(self.lib.cuCtxPushCurrent_v2(self.primary_context(index)),
                   "cuCtxPushCurrent")

    def pop(self) -> None:
        self.check(self.lib.cuCtxPopCurrent_v2(ctypes.byref(
            ctypes.c_void_p())), "cuCtxPopCurrent")


_lock = threading.Lock()
_nvrtc: Optional[_Nvrtc] = None
_driver: Optional[_Driver] = None
# sha256(source, options) -> (cubin, lowered names, log)
_cubins: Dict[str, tuple] = {}


def _get_nvrtc() -> _Nvrtc:
    global _nvrtc
    if _nvrtc is None:
        _nvrtc = _Nvrtc()
    return _nvrtc


def _get_driver() -> _Driver:
    global _driver
    with _lock:
        if _driver is None:
            _driver = _Driver()
        return _driver


# ---------------------------------------------------------------------------
# the user surface
# ---------------------------------------------------------------------------
class CudaModule:
    """CUDA source compiled at run time by NVRTC for ``sm_90a`` (ref:
    python/mxnet/rtc.py CudaModule).

    ``options`` are extra NVRTC options, after ``--gpu-architecture=
    sm_90a``, ``-std=c++17`` and the toolkit's include directory.
    ``exports`` are C++ names (e.g. template instances) to resolve;
    ``extern "C"`` kernels need none.  Raises :class:`MXNetError` without
    a CUDA device, when NVRTC is missing, or with NVRTC's log when the
    source does not compile."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule needs a CUDA device: mx.rtc "
                             "compiles and runs kernels on the card only")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.exports = list(exports)
        self.options = ["--gpu-architecture=" + ARCH, "-std=c++17"]
        include = _cuda_home() / "include"
        if include.is_dir():
            self.options.append("-I" + str(include))
        self.options += list(options)
        key = hashlib.sha256("\0".join(
            [source] + self.options + ["|"] + self.exports).encode())
        self.key = key.hexdigest()
        with _lock:
            hit = _cubins.get(self.key)
            if hit is None:
                hit = _get_nvrtc().compile(source, self.options,
                                           self.exports)
                _cubins[self.key] = hit
        self.cubin, self._lowered, self.log = hit
        # (name, device index) -> CUfunction; module handles by device
        self._functions: Dict[tuple, ctypes.c_void_p] = {}
        self._modules: Dict[int, ctypes.c_void_p] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` typed by ``signature``, e.g. ``"const
        float *x, float *y, int n"``."""
        return CudaKernel(self, name, signature)

    def _function(self, name: str, index: int) -> ctypes.c_void_p:
        """The CUfunction of ``name`` on device ``index``; the primary
        context of that device must be current."""
        fn = self._functions.get((name, index))
        if fn is not None:
            return fn
        drv = _get_driver()
        with _lock:
            mod = self._modules.get(index)
            if mod is None:
                mod = ctypes.c_void_p()
                drv.check(drv.lib.cuModuleLoadData(ctypes.byref(mod),
                                                   self.cubin),
                          "cuModuleLoadData")
                self._modules[index] = mod
        fn = ctypes.c_void_p()
        symbol = self._lowered.get(name, name)
        rc = drv.lib.cuModuleGetFunction(ctypes.byref(fn), mod,
                                         symbol.encode())
        if rc != 0:
            raise MXNetError(
                "kernel %r not found in the module (CUDA error %d): an "
                "extern \"C\" __global__ name, or a C++ name listed in "
                "exports (have exports %s)" % (name, rc, self.exports))
        self._functions[(name, index)] = fn
        return fn


class CudaKernel:
    """One kernel of a :class:`CudaModule` with its parsed signature
    (ref: python/mxnet/rtc.py CudaKernel)."""

    def __init__(self, module: Optional[CudaModule], name: str,
                 signature: str):
        self.module = module
        self.name = name
        self.signature = signature
        self.args = parse_signature(signature)

    def launch(self, args: Sequence, ctx: Context, grid_dims: Sequence[int],
               block_dims: Sequence[int], shared_mem: int = 0) -> None:
        """Launch on ``ctx``'s device, on PyTorch's current stream.

        ``args`` follow the signature: an NDArray for each pointer (its
        dtype the pointer's type, contiguous, on ``ctx``), a number for
        each scalar.  Refuses, with :class:`MXNetError`, a CPU context, a
        wrong count, a wrong dtype, a non-contiguous array and an array
        on another device.  The launch is asynchronous; NDArrays passed
        through non-const pointers are written in place and have their
        version bumped."""
        ctx = Context(ctx) if ctx is not None else current_context()
        if ctx.is_host:
            raise MXNetError("CudaKernel %s: cannot launch on %s, a CUDA "
                             "kernel runs on a gpu context" % (self.name,
                                                               ctx))
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("CudaKernel %s: grid_dims and block_dims must "
                             "be 3 integers each" % self.name)
        if len(args) != len(self.args):
            raise MXNetError("CudaKernel %s expects %d arguments (%s) but "
                             "got %d" % (self.name, len(self.args),
                                         self.signature, len(args)))
        for i, (a, spec) in enumerate(zip(args, self.args)):
            if spec.pointer:
                if not isinstance(a, NDArray):
                    raise MXNetError("CudaKernel %s: argument %d must be an "
                                     "NDArray (%s *), got %s"
                                     % (self.name, i, spec.ctype, type(a)))
                if a._data.dtype != spec.dtype:
                    raise MXNetError("CudaKernel %s: argument %d is %s, the "
                                     "kernel takes %s (%s *)"
                                     % (self.name, i, a._data.dtype,
                                        spec.dtype, spec.ctype))
                if not a._data.is_contiguous():
                    raise MXNetError("CudaKernel %s: argument %d is not "
                                     "contiguous" % (self.name, i))
            elif isinstance(a, bool) or not isinstance(a, numeric_types):
                raise MXNetError("CudaKernel %s: argument %d must be a "
                                 "number (%s), got %s"
                                 % (self.name, i, spec.ctype, type(a)))
        dev = ctx.torch_device()
        params, writes = [], []
        for i, (a, spec) in enumerate(zip(args, self.args)):
            if spec.pointer:
                if a._data.device != dev:
                    raise MXNetError("CudaKernel %s: argument %d lies on %s, "
                                     "the launch is on %s (%s)"
                                     % (self.name, i, a._data.device, dev,
                                        ctx))
                params.append(ctypes.c_void_p(a._data.data_ptr()))
                if not spec.const:
                    writes.append(a)
            else:
                params.append(_CTYPES[spec.ctype][1](_np.asarray(a).item()))
        if self.module is None:
            raise MXNetError("CudaKernel %s belongs to no module"
                             % self.name)
        drv = _get_driver()
        # each pointer in argv points at a ctypes object of ``params``,
        # which stays alive through the call
        argv = (ctypes.c_void_p * max(len(params), 1))(
            *[ctypes.addressof(p) for p in params])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            drv.push(dev.index)
            try:
                fn = self.module._function(self.name, dev.index)
                if shared_mem > 48 * 1024:
                    drv.check(drv.lib.cuFuncSetAttribute(
                        fn, drv.CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                        int(shared_mem)), "cuFuncSetAttribute")
                drv.check(drv.lib.cuLaunchKernel(
                    fn, *[int(g) for g in grid_dims],
                    *[int(b) for b in block_dims], int(shared_mem),
                    ctypes.c_void_p(stream), argv, None),
                    "cuLaunchKernel(%s, grid %s, block %s)"
                    % (self.name, tuple(grid_dims), tuple(block_dims)))
            finally:
                drv.pop()
        launches[self.name] += 1
        for a in writes:
            a._bump_version()


class PallasKernel:
    """One launchable Python kernel (ref: rtc.py CudaKernel)."""

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self._name = name

    def launch(self, args: Sequence, ctx: Optional[Context] = None):
        """Run the kernel on NDArray/scalar args and wrap its outputs as
        NDArrays on ``ctx`` (the current context when None)."""
        raw = [a._data if isinstance(a, NDArray) else a for a in args]
        with torch.no_grad():
            outs = self._fn(*raw)
        ctx = ctx or current_context()
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        dev = ctx.torch_device()
        return [NDArray.from_raw(o.to(dev, copy=True), ctx) for o in outs]


class PallasModule:
    """Python kernels registered by name and launched on NDArrays — the
    JAX package's ``PallasModule`` contract, kept by name so its users
    port one to one; the kernels are functions over tensors."""

    def __init__(self, kernels=None, exports=()):
        self._kernels: Dict[str, PallasKernel] = {}
        self.exports: List[str] = []
        for name, fn in dict(kernels or {}).items():
            self.add_kernel(name, fn)
        if exports:
            self.exports = list(exports)

    def add_kernel(self, name: str, fn: Callable) -> None:
        self._kernels[name] = PallasKernel(fn, name)
        if name not in self.exports:
            self.exports.append(name)

    def get_kernel(self, name: str, signature: str = "") -> PallasKernel:
        """``signature`` is accepted for parity with CudaModule and
        unused: the kernels are typed by their arguments."""
        if name not in self._kernels:
            raise MXNetError("kernel %r not found (have: %s)"
                             % (name, sorted(self._kernels)))
        return self._kernels[name]
