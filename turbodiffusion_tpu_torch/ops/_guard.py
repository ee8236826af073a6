"""A CUDA tensor that ends where mapped memory ends, for bounds checks of
the kernels on the card.

`guarded_copy(t)` copies a CUDA tensor into memory mapped through the CUDA
driver's virtual memory calls so that the copy's last byte is the last
byte of a mapped page and the page after it is reserved but left unmapped:
a kernel that reads one element past the tensor stops with an illegal
address, where in the caching allocator's pools it would read a
neighbour's bytes unseen. The pages are unmapped and released when the
copy is freed.
"""

from __future__ import annotations

import ctypes

import torch

_CU_MEM_ALLOCATION_TYPE_PINNED = 1
_CU_MEM_LOCATION_TYPE_DEVICE = 1
_CU_MEM_ACCESS_FLAGS_PROT_READWRITE = 3


class _AllocationProp(ctypes.Structure):      # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requested_handle_types", ctypes.c_int),
                ("location_type", ctypes.c_int), ("location_id", ctypes.c_int),
                ("win32_handle_metadata", ctypes.c_void_p),
                ("compression_type", ctypes.c_ubyte),
                ("gpu_direct_rdma_capable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _AccessDesc(ctypes.Structure):          # CUmemAccessDesc
    _fields_ = [("location_type", ctypes.c_int), ("location_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    u64, size = ctypes.c_uint64, ctypes.c_size_t
    sigs = {
        "cuMemGetAllocationGranularity": [ctypes.POINTER(size),
                                          ctypes.POINTER(_AllocationProp), ctypes.c_int],
        "cuMemCreate": [ctypes.POINTER(u64), size, ctypes.POINTER(_AllocationProp), u64],
        "cuMemAddressReserve": [ctypes.POINTER(u64), size, size, u64, u64],
        "cuMemMap": [u64, size, size, u64, u64],
        "cuMemSetAccess": [u64, size, ctypes.POINTER(_AccessDesc), size],
        "cuMemUnmap": [u64, size],
        "cuMemRelease": [u64],
        "cuMemAddressFree": [u64, size],
    }
    for name, args in sigs.items():
        getattr(cu, name).argtypes = args
        getattr(cu, name).restype = ctypes.c_int
    return cu


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA driver error {rc}")


class _Pages:
    """`nbytes` of device memory ending at the end of a mapped range, with
    an unmapped page reserved after it; exposes the bytes through
    `__cuda_array_interface__` and releases them when collected."""

    def __init__(self, nbytes: int, device: int):
        cu = self._cu = _driver()
        prop = _AllocationProp(type=_CU_MEM_ALLOCATION_TYPE_PINNED,
                               location_type=_CU_MEM_LOCATION_TYPE_DEVICE,
                               location_id=device)
        gran = ctypes.c_size_t()
        _check(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0),
               "cuMemGetAllocationGranularity")
        g = gran.value
        self._size = -(-nbytes // g) * g
        self._handle, self._base = ctypes.c_uint64(), ctypes.c_uint64()
        _check(cu.cuMemCreate(ctypes.byref(self._handle), self._size, ctypes.byref(prop), 0),
               "cuMemCreate")
        _check(cu.cuMemAddressReserve(ctypes.byref(self._base), self._size + g, g, 0, 0),
               "cuMemAddressReserve")
        self._reserved = self._size + g
        _check(cu.cuMemMap(self._base.value, self._size, 0, self._handle.value, 0), "cuMemMap")
        access = _AccessDesc(_CU_MEM_LOCATION_TYPE_DEVICE, device,
                             _CU_MEM_ACCESS_FLAGS_PROT_READWRITE)
        _check(cu.cuMemSetAccess(self._base.value, self._size, ctypes.byref(access), 1),
               "cuMemSetAccess")
        ptr = self._base.value + self._size - nbytes
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}

    def __del__(self):
        try:
            torch.cuda.synchronize()
            self._cu.cuMemUnmap(self._base.value, self._size)
            self._cu.cuMemRelease(self._handle.value)
            self._cu.cuMemAddressFree(self._base.value, self._reserved)
        except Exception:       # a card that has faulted keeps its error
            pass


def guarded_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of the CUDA tensor t whose last byte is followed by
    an unmapped page (see the module's docstring)."""
    if not t.is_cuda:
        raise ValueError("guarded_copy takes a CUDA tensor")
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    pages = _Pages(nbytes, t.device.index if t.device.index is not None
                   else torch.cuda.current_device())
    out = torch.as_tensor(pages, device=t.device).view(t.dtype).view(t.shape)
    out.copy_(t)
    return out
