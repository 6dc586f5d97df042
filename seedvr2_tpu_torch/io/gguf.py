"""GGUF checkpoints: the header and metadata reader, block dequantization in
numpy on the host, and a writer (the port's copy of seedvr2_tpu/io/gguf.py,
same block formats, same numbers; the writer is the port's own).

A GGUF file is a storage format here: every tensor is dequantized once at
load, to fp32, and the DiT's block linears are then re-quantized to int8 at
rest (pipeline/loader.py, ops/quant.py). Block types: F32, F16, BF16, Q4_0,
Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K (ggml's layouts).

``write_gguf`` writes F32, F16 and Q8_0 tensors (Q8_0: a 32-element block
is an f16 scale absmax / 127 and 32 int8 values), so that the tests and
chip_smoke.py can make GGUF checkpoints from seeded weights.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# ggml type ids
F32, F16 = 0, 1
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 = 2, 3, 6, 7, 8
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K = 10, 11, 12, 13, 14
BF16 = 30

# (block_elems, block_bytes)
_BLOCK = {
    F32: (1, 4),
    F16: (1, 2),
    BF16: (1, 2),
    Q4_0: (32, 18),
    Q4_1: (32, 20),
    Q5_0: (32, 22),
    Q5_1: (32, 24),
    Q8_0: (32, 34),
    Q2_K: (256, 84),
    Q3_K: (256, 110),
    Q4_K: (256, 144),
    Q5_K: (256, 176),
    Q6_K: (256, 210),
}

_VALUE_FMT = {
    0: ("B", 1), 1: ("b", 1), 2: ("H", 2), 3: ("h", 2), 4: ("I", 4), 5: ("i", 4),
    6: ("f", 4), 7: ("?", 1), 10: ("Q", 8), 11: ("q", 8), 12: ("d", 8),
}


class TensorInfo(NamedTuple):
    name: str
    shape: Tuple[int, ...]  # row-major (torch-style), slowest first
    ggml_type: int
    offset: int
    n_elems: int


class GGUFFile(NamedTuple):
    metadata: Dict[str, object]
    tensors: Dict[str, TensorInfo]
    data_start: int
    path: str

    def load_tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        info = self.tensors[name]
        nblk, bbytes = _BLOCK[info.ggml_type]
        nbytes = (info.n_elems // nblk) * bbytes
        with open(self.path, "rb") as f:
            f.seek(self.data_start + info.offset)
            raw = np.frombuffer(f.read(nbytes), np.uint8)
        return dequantize(raw, info.ggml_type, info.n_elems).reshape(info.shape).astype(dtype)


def _read_string(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f, vtype: int):
    if vtype == 8:  # string
        return _read_string(f)
    if vtype == 9:  # array
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(n)]
    fmt, size = _VALUE_FMT[vtype]
    return struct.unpack("<" + fmt, f.read(size))[0]


def read_gguf(path: str) -> GGUFFile:
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        (version,) = struct.unpack("<I", f.read(4))
        if version < 2:
            raise ValueError(f"GGUF v{version} unsupported")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        meta: Dict[str, object] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)
        tensors: Dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_string(f)
            (nd,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))  # ne[0] fastest
            (ttype,) = struct.unpack("<I", f.read(4))
            (offset,) = struct.unpack("<Q", f.read(8))
            shape = tuple(reversed(dims))  # torch-style
            n = int(np.prod(dims))
            tensors[name] = TensorInfo(name, shape, ttype, offset, n)
        align = int(meta.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
    return GGUFFile(meta, tensors, data_start, path)


# --------------------------------------------------------------------------- #
# Dequantization (vectorized)
# --------------------------------------------------------------------------- #


def _f16(u8: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(u8).view(np.float16).astype(np.float32).reshape(u8.shape[0])


def dequantize(raw: np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    if ggml_type == F32:
        return raw.view(np.float32)[:n_elems].copy()
    if ggml_type == F16:
        return raw.view(np.float16)[:n_elems].astype(np.float32)
    if ggml_type == BF16:
        u = raw.view(np.uint16)[:n_elems].astype(np.uint32) << 16
        return u.view(np.float32)
    nblk, bbytes = _BLOCK[ggml_type]
    blocks = raw.reshape(-1, bbytes)
    fn = {
        Q4_0: _dq_q4_0, Q4_1: _dq_q4_1, Q5_0: _dq_q5_0, Q5_1: _dq_q5_1,
        Q8_0: _dq_q8_0, Q2_K: _dq_q2_k, Q3_K: _dq_q3_k,
        Q4_K: _dq_q4_k, Q5_K: _dq_q5_k, Q6_K: _dq_q6_k,
    }[ggml_type]
    return fn(blocks).reshape(-1)[:n_elems]


def _dq_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])[:, None]
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return d * q


def _nibbles(qs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (qs & 0x0F).astype(np.float32), (qs >> 4).astype(np.float32)


def _dq_q4_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])[:, None]
    lo, hi = _nibbles(b[:, 2:18])
    return d * (np.concatenate([lo, hi], axis=1) - 8.0)


def _dq_q4_1(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])[:, None]
    m = _f16(b[:, 2:4])[:, None]
    lo, hi = _nibbles(b[:, 4:20])
    return d * np.concatenate([lo, hi], axis=1) + m


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """[N, 4] uint8 -> [N, 32] the 5th bit for each element."""
    qh = qh_bytes.view(np.uint32).reshape(-1, 1)
    shifts = np.arange(32, dtype=np.uint32)[None]
    return ((qh >> shifts) & 1).astype(np.float32)


def _dq_q5_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])[:, None]
    hb = _q5_high_bits(b[:, 2:6])
    lo, hi = _nibbles(b[:, 6:22])
    q = np.concatenate([lo, hi], axis=1) + 16.0 * hb
    return d * (q - 16.0)


def _dq_q5_1(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])[:, None]
    m = _f16(b[:, 2:4])[:, None]
    hb = _q5_high_bits(b[:, 4:8])
    lo, hi = _nibbles(b[:, 8:24])
    q = np.concatenate([lo, hi], axis=1) + 16.0 * hb
    return d * q + m


def _kq_scales(sc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min table of K-quants -> ([N,8],[N,8])
    (ggml get_scale_min_k4)."""
    sc = sc.astype(np.uint8)
    scales = np.empty(sc.shape[:1] + (8,), np.float32)
    mins = np.empty_like(scales)
    for i in range(4):
        scales[:, i] = (sc[:, i] & 63).astype(np.float32)
        mins[:, i] = (sc[:, i + 4] & 63).astype(np.float32)
    for i in range(4, 8):
        scales[:, i] = ((sc[:, i + 4] & 0x0F) | ((sc[:, i - 4] >> 6) << 4)).astype(np.float32)
        mins[:, i] = ((sc[:, i + 4] >> 4) | ((sc[:, i] >> 6) << 4)).astype(np.float32)
    return scales, mins


def _dq_q2_k(b: np.ndarray) -> np.ndarray:
    """Q2_K superblock: scales[16] (4-bit scale | 4-bit min per 16 elems),
    qs[64] (2-bit), d f16, dmin f16 (ggml dequantize_row_q2_K)."""
    sc = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    out = np.empty((b.shape[0], 256), np.float32)
    for n in (0, 1):  # two 128-element halves
        q = qs[:, 32 * n : 32 * n + 32]
        for j in range(4):  # 2-bit plane
            for h in (0, 1):  # two 16-element groups per plane
                s = sc[:, 8 * n + 2 * j + h]
                dl = (d * (s & 0x0F))[:, None]
                ml = (dmin * (s >> 4))[:, None]
                qv = ((q[:, 16 * h : 16 * h + 16] >> (2 * j)) & 3).astype(np.float32)
                o = 128 * n + 32 * j + 16 * h
                out[:, o : o + 16] = dl * qv - ml
    return out


def _dq_q3_k(b: np.ndarray) -> np.ndarray:
    """Q3_K superblock: hmask[32] (3rd bit, inverted), qs[64] (2-bit),
    scales[12] (packed 6-bit x16), d f16 (ggml dequantize_row_q3_K)."""
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scb = b[:, 96:108].astype(np.uint8)
    d = _f16(b[:, 108:110])
    # 12 bytes -> 16 6-bit scales (the kmask1/kmask2 shuffle, byte-wise)
    s16 = np.empty((b.shape[0], 16), np.float32)
    for k in range(4):
        s16[:, k] = (scb[:, k] & 0x0F) | ((scb[:, 8 + k] & 3) << 4)
        s16[:, 4 + k] = (scb[:, 4 + k] & 0x0F) | (((scb[:, 8 + k] >> 2) & 3) << 4)
        s16[:, 8 + k] = (scb[:, k] >> 4) | (((scb[:, 8 + k] >> 4) & 3) << 4)
        s16[:, 12 + k] = (scb[:, 4 + k] >> 4) | (((scb[:, 8 + k] >> 6) & 3) << 4)
    s16 -= 32.0
    out = np.empty((b.shape[0], 256), np.float32)
    for n in (0, 1):
        q = qs[:, 32 * n : 32 * n + 32]
        for j in range(4):
            m = np.uint8(1 << (4 * n + j))
            for h in (0, 1):
                dl = (d * s16[:, 8 * n + 2 * j + h])[:, None]
                qv = ((q[:, 16 * h : 16 * h + 16] >> (2 * j)) & 3).astype(np.float32)
                high = ((hmask[:, 16 * h : 16 * h + 16] & m) == 0).astype(np.float32) * 4.0
                o = 128 * n + 32 * j + 16 * h
                out[:, o : o + 16] = dl * (qv - high)
    return out


def _dq_q4_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    scales, mins = _kq_scales(b[:, 4:16])
    qs = b[:, 16:144]
    out = np.empty((b.shape[0], 256), np.float32)
    for i in range(4):
        q = qs[:, 32 * i : 32 * i + 32]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        d1 = (d * scales[:, 2 * i])[:, None]
        m1 = (dmin * mins[:, 2 * i])[:, None]
        d2 = (d * scales[:, 2 * i + 1])[:, None]
        m2 = (dmin * mins[:, 2 * i + 1])[:, None]
        out[:, 64 * i : 64 * i + 32] = d1 * lo - m1
        out[:, 64 * i + 32 : 64 * i + 64] = d2 * hi - m2
    return out


def _dq_q5_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    scales, mins = _kq_scales(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    out = np.empty((b.shape[0], 256), np.float32)
    for i in range(4):
        q = qs[:, 32 * i : 32 * i + 32]
        u1 = np.uint8(1 << (2 * i))
        u2 = np.uint8(2 << (2 * i))
        lo = (q & 0x0F).astype(np.float32) + 16.0 * ((qh & u1) != 0)
        hi = (q >> 4).astype(np.float32) + 16.0 * ((qh & u2) != 0)
        d1 = (d * scales[:, 2 * i])[:, None]
        m1 = (dmin * mins[:, 2 * i])[:, None]
        d2 = (d * scales[:, 2 * i + 1])[:, None]
        m2 = (dmin * mins[:, 2 * i + 1])[:, None]
        out[:, 64 * i : 64 * i + 32] = d1 * lo - m1
        out[:, 64 * i + 32 : 64 * i + 64] = d2 * hi - m2
    return out


def _dq_q6_k(b: np.ndarray) -> np.ndarray:
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210])
    out = np.empty((b.shape[0], 256), np.float32)
    for n in (0, 1):  # two halves of 128
        qln = ql[:, 64 * n : 64 * n + 64]
        qhn = qh[:, 32 * n : 32 * n + 32]
        scn = sc[:, 8 * n : 8 * n + 8]
        l = np.arange(32)
        is_ = l // 16  # 0 or 1
        q1 = ((qln[:, :32] & 0x0F) | (((qhn >> 0) & 3) << 4)).astype(np.float32) - 32.0
        q2 = ((qln[:, 32:64] & 0x0F) | (((qhn >> 2) & 3) << 4)).astype(np.float32) - 32.0
        q3 = ((qln[:, :32] >> 4) | (((qhn >> 4) & 3) << 4)).astype(np.float32) - 32.0
        q4 = ((qln[:, 32:64] >> 4) | (((qhn >> 6) & 3) << 4)).astype(np.float32) - 32.0
        base = 128 * n
        out[:, base + 0 : base + 32] = d[:, None] * scn[:, is_ + 0] * q1
        out[:, base + 32 : base + 64] = d[:, None] * scn[:, is_ + 2] * q2
        out[:, base + 64 : base + 96] = d[:, None] * scn[:, is_ + 4] * q3
        out[:, base + 96 : base + 128] = d[:, None] * scn[:, is_ + 6] * q4
    return out


# --------------------------------------------------------------------------- #
# State-dict level loading
# --------------------------------------------------------------------------- #


def load_gguf_state_dict(path: str, dtype=np.float32) -> Dict[str, np.ndarray]:
    """Full checkpoint -> torch-layout numpy state dict (feed into
    io.weights.convert_state_dict)."""
    g = read_gguf(path)
    return {name: g.load_tensor(name, dtype) for name in g.tensors}


def validate_gguf_architecture(path: str, expected_keys: List[str]) -> List[str]:
    """Shape/name validation before load (reference:
    model_loader.py:897-933). Returns missing keys."""
    g = read_gguf(path)
    return [k for k in expected_keys if k not in g.tensors]


# --------------------------------------------------------------------------- #
# Writing
# --------------------------------------------------------------------------- #


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """fp32 values (a multiple of 32) -> Q8_0 blocks as bytes [n / 32, 34]:
    d = absmax / 127 as f16, q = round(x / d) clipped to +-127 (0 where d is 0)."""
    v = np.asarray(x, np.float32).reshape(-1, 32)
    d = (np.abs(v).max(axis=1) / 127.0).astype(np.float16)
    df = d.astype(np.float32)[:, None]
    q = np.clip(np.round(np.divide(v, df, out=np.zeros_like(v), where=df > 0)), -127, 127).astype(np.int8)
    return np.concatenate([d.view(np.uint8).reshape(-1, 2), q.view(np.uint8)], axis=1)


def _encode(arr: np.ndarray, ggml_type: int) -> bytes:
    if ggml_type == F32:
        return np.ascontiguousarray(arr, np.float32).tobytes()
    if ggml_type == F16:
        return np.ascontiguousarray(arr, np.float16).tobytes()
    if ggml_type == Q8_0:
        if arr.size % 32:
            raise ValueError(f"Q8_0 needs a multiple of 32 elements, got {arr.size}")
        return quantize_q8_0(arr).tobytes()
    raise ValueError(f"write_gguf: ggml type {ggml_type} is not written (F32, F16, Q8_0)")


def _string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def write_gguf(path: str, tensors: Mapping[str, Tuple[np.ndarray, int]], metadata: Optional[Dict[str, str]] = None) -> None:
    """A GGUF v3 file: ``tensors`` maps a name to (array in the torch
    layout, ggml type: F32, F16 or Q8_0); ``metadata`` string values, plus
    general.alignment (32). Tensors are encoded one at a time."""
    alignment = 32
    meta = [("general.alignment", 4, struct.pack("<I", alignment))]
    meta += [(k, 8, _string(v)) for k, v in (metadata or {}).items()]
    infos, offset = [], 0
    for name, (arr, gtype) in tensors.items():
        nblk, bbytes = _BLOCK[gtype]
        n = int(np.prod(arr.shape))
        infos.append((name, arr.shape, gtype, offset))
        offset += -(-(n // nblk * bbytes) // alignment) * alignment
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC + struct.pack("<IQQ", 3, len(infos), len(meta)))
        for key, vtype, value in meta:
            f.write(_string(key) + struct.pack("<I", vtype) + value)
        for name, shape, gtype, off in infos:
            dims = tuple(reversed(shape)) or (1,)  # ne[0] fastest
            f.write(_string(name) + struct.pack(f"<I{len(dims)}QIQ", len(dims), *dims, gtype, off))
        f.write(b"\x00" * (-f.tell() % alignment))
        start = f.tell()
        for name, shape, gtype, off in infos:
            f.write(b"\x00" * (start + off - f.tell()))
            f.write(_encode(np.asarray(tensors[name][0]), gtype))
        f.write(b"\x00" * (-(f.tell() - start) % alignment))
