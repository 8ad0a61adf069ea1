"""Device tensors that end where their mapping ends, so that a kernel that
reads or writes one element past them faults instead of touching a
neighbour.

``Guarded(device).like(t)`` reserves a granule of device address space more than
``t`` needs, maps physical memory on all but the last (CUDA's virtual
memory API, through ``ctypes`` on the driver library) and returns a copy of
``t`` placed so that its last byte is the last mapped byte. The caching
allocator gives no such guarantee: the byte after a tensor that ends a
segment may or may not be mapped, which is how an overrun can pass on one
machine and fault on another.

Run as a script on a GPU it holds ``sim_decode`` against its plain version
with every operand guarded, at slot counts where the lane past the row's
last slot starts exactly at the row's end (S = 8, 32 and 132), and prints
``ok``; a read past an operand ends the process with an illegal address.
``tests/test_torch_kernels_gpu.py`` runs it in a subprocess, so that such a
fault does not end the test session's CUDA context:

    PYTHONPATH=src python tests/guarded_memory.py
"""

from __future__ import annotations

import ctypes

import torch

_CU_MEM_ALLOCATION_TYPE_PINNED = 1
_CU_MEM_LOCATION_TYPE_DEVICE = 1
_CU_MEM_ACCESS_FLAGS_PROT_READWRITE = 3


class _Location(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte), ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _AllocProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Location), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):
    _fields_ = [("location", _Location), ("flags", ctypes.c_int)]


_U64, _SIZE = ctypes.c_uint64, ctypes.c_size_t
_SIGNATURES = {
    "cuMemGetAllocationGranularity": [ctypes.POINTER(_SIZE), ctypes.POINTER(_AllocProp),
                                      ctypes.c_int],
    "cuMemAddressReserve": [ctypes.POINTER(_U64), _SIZE, _SIZE, _U64, _U64],
    "cuMemCreate": [ctypes.POINTER(_U64), _SIZE, ctypes.POINTER(_AllocProp), _U64],
    "cuMemMap": [_U64, _SIZE, _SIZE, _U64, _U64],
    "cuMemSetAccess": [_U64, _SIZE, ctypes.POINTER(_AccessDesc), _SIZE],
    "cuMemUnmap": [_U64, _SIZE],
    "cuMemRelease": [_U64],
    "cuMemAddressFree": [_U64, _SIZE],
}
_TYPESTR = {torch.bool: "|b1", torch.int32: "<i4", torch.float64: "<f8"}


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cu, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cu


def _call(cu, name: str, *args) -> None:
    code = getattr(cu, name)(*args)
    if code != 0:
        raise RuntimeError(f"{name} failed: CUresult {code}")


class Guarded:
    """Owns the mappings behind the tensors that :meth:`like` returns; call
    :meth:`release` once the device is done with them."""

    def __init__(self, device: torch.device):
        torch.cuda.init()
        self.cu = _driver()
        self.dev = device
        index = device.index if device.index is not None else torch.cuda.current_device()
        self.loc = _Location(_CU_MEM_LOCATION_TYPE_DEVICE, index)
        self.prop = _AllocProp(type=_CU_MEM_ALLOCATION_TYPE_PINNED, location=self.loc)
        gran = _SIZE()
        _call(self.cu, "cuMemGetAllocationGranularity", ctypes.byref(gran),
              ctypes.byref(self.prop), 0)
        self.gran = gran.value
        self.maps: list[tuple[int, int, int]] = []  # (address, mapped bytes, handle)

    def like(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` whose last byte ends a mapping."""
        nbytes = t.numel() * t.element_size()
        size = -(-max(nbytes, 1) // self.gran) * self.gran
        va, handle = _U64(), _U64()
        _call(self.cu, "cuMemAddressReserve", ctypes.byref(va), size + self.gran, 0, 0, 0)
        _call(self.cu, "cuMemCreate", ctypes.byref(handle), size, ctypes.byref(self.prop), 0)
        _call(self.cu, "cuMemMap", va.value, size, 0, handle.value, 0)
        access = _AccessDesc(self.loc, _CU_MEM_ACCESS_FLAGS_PROT_READWRITE)
        _call(self.cu, "cuMemSetAccess", va.value, size, ctypes.byref(access), 1)
        self.maps.append((va.value, size, handle.value))

        class _View:
            __cuda_array_interface__ = {
                "shape": tuple(t.shape), "typestr": _TYPESTR[t.dtype],
                "data": (va.value + size - nbytes, False), "version": 2, "strides": None,
            }

        out = torch.as_tensor(_View(), device=self.dev)
        out.copy_(t)
        return out

    def release(self) -> None:
        torch.cuda.synchronize(self.dev)
        for va, size, handle in self.maps:
            _call(self.cu, "cuMemUnmap", va, size)
            _call(self.cu, "cuMemRelease", handle)
            _call(self.cu, "cuMemAddressFree", va, size + self.gran)
        self.maps.clear()


#: (c_max per pool, lanes, instances, slots): the lane after the row's last
#: slot starts at the row's end (S / 4 < 32, and 132 - 128 = 4 in the last
#: segment); P * I * S * G is a multiple of 16, so the 16-byte path runs.
CASES = [([8192, 65_536], 1, 4, 32), ([2048], 2, 3, 8), ([4096, 8192], 1, 2, 132)]


def main() -> None:
    from repro_torch.kernels.sim_decode import OUTPUTS, decode_advance, decode_advance_plain
    from repro_torch.kernels.sim_decode import random_state

    dev = torch.device("cuda")
    names = ("t_limit", "busy", "now", "nact", "free", "occ", "pre", "sq", "inp", "gen",
             "rem", "blk", "ft", "tr", "c_max")
    for c_max, lanes, n_inst, n_slots in CASES:
        st = random_state(5, c_max, n_inst, n_slots, lanes=lanes, device=dev)
        guard = Guarded(dev)
        args = [guard.like(st[k]) for k in names]
        assert all(a.data_ptr() % 16 == 0 for a in args[5:14])
        got = decode_advance(*args, w=8.0e-3, h=0.65e-3, chunk=512)
        torch.cuda.synchronize()
        want = decode_advance_plain(*(st[k].cpu() for k in names), w=8.0e-3, h=0.65e-3,
                                    chunk=512)
        for k in OUTPUTS:
            a, b = got[k].cpu(), want[k]
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            if not torch.equal(a, b):
                raise SystemExit(f"{k} differs from the plain version at "
                                 f"{(c_max, lanes, n_inst, n_slots)}")
        del args, got
        guard.release()
    print("ok")


if __name__ == "__main__":
    main()
