"""``ctypes`` binding of the host-side image codec,
``csrc/image_codec.c``: the JPEG decoder and encoder (``data/jpeg.py``),
the PNG unfilter (``data/png.py``), the TIFF unpacking (``data/tiff.py``)
and the resize loops (``preprocess/imgproc.py``). The library is built
by the host C compiler at first use (``build.py``); every call releases
Python's interpreter lock, so the host stage's threads run in
parallel."""

from __future__ import annotations

import ctypes

import numpy as np

_LIB: "ctypes.CDLL | None" = None


def lib() -> ctypes.CDLL:
    """The codec library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from jama16_retina_tpu_torch.ops import build

        lib = build.load("image_codec")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.jpeg_header.argtypes = [u8p, ctypes.c_size_t, ip, ip]
        lib.jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, i, i]
        lib.png_unfilter.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32,
                                     ctypes.c_size_t, ctypes.c_uint32, u8p]
        lib.resize_area_table.argtypes = [
            u8p, i, i, i, i32p, f32p, u8p, i, i32p, f32p, u8p, i, i, i, u8p]
        lib.resize_cubic_u8.argtypes = [u8p, i, i, i, i32p, i32p, i32p,
                                        i32p, i, i, i, u8p]
        lib.jpeg_encode_bound.argtypes = [i, i]
        lib.jpeg_encode_bound.restype = ctypes.c_size_t
        lib.jpeg_encode.argtypes = [u8p, i, i, i, u8p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
            getattr(lib, name).argtypes = [u8p, ctypes.c_size_t, u8p,
                                           ctypes.c_size_t]
        lib.tiff_unpredict.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                                       ctypes.c_uint32, ctypes.c_uint32]
        for fn in (lib.jpeg_header, lib.jpeg_decode, lib.jpeg_encode,
                   lib.png_unfilter, lib.resize_area_table,
                   lib.resize_cubic_u8, lib.tiff_lzw_decode,
                   lib.tiff_packbits_decode, lib.tiff_unpredict):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def ptr(a: np.ndarray):
    """A C pointer to a contiguous array's first element, typed by its
    dtype (uint8, int32 or float32)."""
    ctype = {np.dtype(np.uint8): ctypes.c_uint8,
             np.dtype(np.int32): ctypes.c_int32,
             np.dtype(np.float32): ctypes.c_float}[a.dtype]
    assert a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctype))
