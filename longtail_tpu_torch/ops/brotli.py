"""Brotli codec: system libbrotli (ctypes) with a from-spec decode floor.

The reference vendors upstream brotli 1.1 and wraps it as the 'btl'+
{0,1,2,a,b,c} generic/text quality tiers (lib/brotli/longtail_brotli.c:24-30
with quality/window settings :38-74).  We bind the same upstream library via
ctypes for the encoder and the fast decode path; when libbrotli is absent,
``decompress`` falls back to the from-spec RFC 7932 decoder
(ops/brotli_decode.py) so reference-written brotli stores stay readable on
any host, and the CLI rejects --compression-algorithm brotli* upsyncs up
front (writing needs the encoder).  (zstd/LZ4, the production codecs, are
from-scratch implementations — see ops/zstd_frame.py, ops/lz4.py.)
"""

from __future__ import annotations

import ctypes
import ctypes.util

_MODE_GENERIC = 0
_MODE_TEXT = 1

_enc = None
_dec = None


def _load():
    global _enc, _dec
    if _enc is None:
        try:
            enc_path = ctypes.util.find_library("brotlienc") \
                or "libbrotlienc.so.1"
            dec_path = ctypes.util.find_library("brotlidec") \
                or "libbrotlidec.so.1"
            enc = ctypes.CDLL(enc_path)
            dec = ctypes.CDLL(dec_path)
            enc.BrotliEncoderCompress.restype = ctypes.c_int
            enc.BrotliEncoderCompress.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p]
            enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
            dec.BrotliDecoderDecompress.restype = ctypes.c_int
            dec.BrotliDecoderDecompress.argtypes = [
                ctypes.c_size_t, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
            _enc, _dec = enc, dec
        except OSError:
            _enc = _dec = False
    return (_enc, _dec) if _enc else (None, None)


def available() -> bool:
    return _load()[0] is not None


def compress(data: bytes, quality: int, text_mode: bool = False) -> bytes:
    enc, _ = _load()
    if enc is None:
        raise RuntimeError("libbrotli not available")
    bound = enc.BrotliEncoderMaxCompressedSize(len(data)) or len(data) + 512
    out = ctypes.create_string_buffer(bound)
    out_len = ctypes.c_size_t(bound)
    # window 22 == LONGTAIL_BROTLI_DEFAULT_LGWIN in the reference wrapper
    ok = enc.BrotliEncoderCompress(
        quality, 22, _MODE_TEXT if text_mode else _MODE_GENERIC,
        len(data), data, ctypes.byref(out_len), out)
    if not ok:
        raise RuntimeError("brotli compression failed")
    return out.raw[: out_len.value]


def decompress(data: bytes, raw_size: int) -> bytes:
    _, dec = _load()
    if dec is None:
        # interop floor: the from-spec RFC 7932 decoder keeps
        # reference-written btl* stores readable without libbrotli
        from longtail_tpu_torch.ops import brotli_decode
        return brotli_decode.decompress(data, raw_size)
    out = ctypes.create_string_buffer(max(raw_size, 1))
    out_len = ctypes.c_size_t(raw_size)
    rc = dec.BrotliDecoderDecompress(
        len(data), data, ctypes.byref(out_len), out)
    if rc != 1 or out_len.value != raw_size:
        raise ValueError(
            f"brotli decode failed (rc={rc}, got {out_len.value} "
            f"of {raw_size} bytes)")
    return out.raw[:raw_size]
