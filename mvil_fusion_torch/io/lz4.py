"""Pure-Python LZ4 (block + frame) codec.

Counterpart of ``mvil_fusion_tpu/io/lz4.py``: rosbag's default chunk
compression is lz4 (roslz4 writes standard LZ4 frames), and the image
ships no `lz4` module, so the bag reader (`io/rosbag.py`) uses this
self-contained implementation of the public LZ4 block format and LZ4 frame
format (spec: lz4.github.io/lz4).  The compressor is the reference's
greedy hash-table matcher, byte for byte; it measures a match's length by
comparing slices that double while they agree, and the decoder copies an
overlapping match as the repeat of its period, where the reference steps
byte by byte.  Includes xxHash32 (required for frame header/content
checksums).
"""

from __future__ import annotations

import struct

_MAGIC = 0x184D2204
_PRIME1 = 2654435761
_PRIME2 = 2246822519
_PRIME3 = 3266489917
_PRIME4 = 668265263
_PRIME5 = 374761393
_MASK = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of `data` (public algorithm, used by the LZ4 frame spec)."""
    n = len(data)
    off = 0
    if n >= 16:
        v1 = (seed + _PRIME1 + _PRIME2) & _MASK
        v2 = (seed + _PRIME2) & _MASK
        v3 = seed
        v4 = (seed - _PRIME1) & _MASK
        off = n - n % 16
        for a, b, c, d in struct.iter_unpack("<4I", data[:off]):
            v1 = (v1 + a * _PRIME2) & _MASK
            v1 = (((v1 << 13) | (v1 >> 19)) * _PRIME1) & _MASK
            v2 = (v2 + b * _PRIME2) & _MASK
            v2 = (((v2 << 13) | (v2 >> 19)) * _PRIME1) & _MASK
            v3 = (v3 + c * _PRIME2) & _MASK
            v3 = (((v3 << 13) | (v3 >> 19)) * _PRIME1) & _MASK
            v4 = (v4 + d * _PRIME2) & _MASK
            v4 = (((v4 << 13) | (v4 >> 19)) * _PRIME1) & _MASK
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _MASK
    else:
        h = (seed + _PRIME5) & _MASK
    h = (h + n) & _MASK
    while off + 4 <= n:
        (k,) = struct.unpack_from("<I", data, off)
        h = (_rotl((h + k * _PRIME3) & _MASK, 17) * _PRIME4) & _MASK
        off += 4
    while off < n:
        h = (_rotl((h + data[off] * _PRIME5) & _MASK, 11) * _PRIME1) & _MASK
        off += 1
    h ^= h >> 15
    h = (h * _PRIME2) & _MASK
    h ^= h >> 13
    h = (h * _PRIME3) & _MASK
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# block codec
# ---------------------------------------------------------------------------

def decompress_block(src: bytes, max_size: int | None = None) -> bytes:
    """Decode one raw LZ4 block.

    Hardened against corrupt/crafted input: literal and match lengths are
    validated against the remaining source and the declared `max_size`
    BEFORE any copy, so a block declaring a multi-GiB match cannot blow up
    memory, and truncated literal runs raise instead of silently clamping."""
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise ValueError("corrupt LZ4 block: truncated "
                                     "literal-length bytes")
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if lit_len:
            if i + lit_len > n:
                raise ValueError("corrupt LZ4 block: literal run past "
                                 "end of source")
            if max_size is not None and len(dst) + lit_len > max_size:
                raise ValueError("LZ4 block exceeds declared size")
            dst += src[i:i + lit_len]
            i += lit_len
        if i >= n:
            break                      # last sequence: literals only
        if i + 2 > n:
            raise ValueError("corrupt LZ4 block: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero offset")
        match_len = (token & 0x0F) + 4
        if (token & 0x0F) == 15:
            while True:
                if i >= n:
                    raise ValueError("corrupt LZ4 block: truncated "
                                     "match-length bytes")
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        if max_size is not None and len(dst) + match_len > max_size:
            raise ValueError("LZ4 block exceeds declared size")
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset past start")
        if offset >= match_len:
            dst += dst[start:start + match_len]
        else:                          # overlapping copy: the period repeats
            period = dst[start:]
            dst += (period * (match_len // offset + 1))[:match_len]
    return bytes(dst)


def compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compressor (valid, not maximal)."""
    n = len(src)
    if n == 0:
        return b"\x00"
    dst = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    # spec: last match must end ≥5 bytes before the end and start ≥12 before
    limit = n - 12

    def emit(lit_start, lit_end, match_len, offset):
        lit_len = lit_end - lit_start
        tok_l = min(lit_len, 15)
        tok_m = min(match_len - 4, 15) if match_len else 0
        dst.append((tok_l << 4) | tok_m)
        if tok_l == 15:
            rem = lit_len - 15
            while rem >= 255:
                dst.append(255)
                rem -= 255
            dst.append(rem)
        dst.extend(src[lit_start:lit_end])
        if match_len:
            dst.append(offset & 0xFF)
            dst.append(offset >> 8)
            if tok_m == 15:
                rem = match_len - 4 - 15
                while rem >= 255:
                    dst.append(255)
                    rem -= 255
                dst.append(rem)

    while i < limit:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand:cand + 4] == key:
            # extend the match: slices that double while they agree, halve
            # where they differ, down to the first differing byte
            m = 4
            max_m = n - 5 - i          # leave the last 5 bytes as literals
            step = 16
            while step:
                if (m + step <= max_m and src[cand + m:cand + m + step]
                        == src[i + m:i + m + step]):
                    m += step
                    step = min(2 * step, 1 << 16)
                else:
                    step //= 2
            emit(anchor, i, m, i - cand)
            i += m
            anchor = i
        else:
            i += 1
    emit(anchor, n, 0, 0)              # trailing literals
    return bytes(dst)


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

_BD_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


def decompress(data: bytes) -> bytes:
    """Decode an LZ4 frame (as written by roslz4 / standard lz4 CLI)."""
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an LZ4 frame (magic {magic:#x})")
    off = 4
    flg = data[off]
    bd = data[off + 1]
    off += 2
    version = flg >> 6
    if version != 1:
        raise ValueError(f"unsupported LZ4 frame version {version}")
    b_checksum = bool(flg & 0x10)
    c_size = bool(flg & 0x08)
    c_checksum = bool(flg & 0x04)
    dict_id = bool(flg & 0x01)
    bmax = _BD_SIZES.get((bd >> 4) & 0x7)
    if bmax is None:
        raise ValueError("invalid LZ4 frame BD byte")
    if c_size:
        off += 8
    if dict_id:
        off += 4
    off += 1                           # header checksum (not verified)
    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", data, off)
        off += 4
        if bsize == 0:                 # EndMark
            break
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = data[off:off + bsize]
        off += bsize
        if b_checksum:
            off += 4                   # per-block checksum (not verified)
        out += block if uncompressed else decompress_block(block, bmax)
    if c_checksum:
        off += 4
    return bytes(out)


def compress(data: bytes, block_size: int = 1 << 20) -> bytes:
    """Encode an LZ4 frame (block-independent, content checksum)."""
    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    flg = (1 << 6) | 0x20 | 0x04       # version 1, B.Indep, C.Checksum
    bd = 6 << 4                        # 1 MB max block size
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    out += desc + bytes([hc])
    for i in range(0, max(len(data), 1), block_size):
        chunk = data[i:i + block_size]
        if not chunk:
            break
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", 0x80000000 | len(chunk)) + chunk
    out += struct.pack("<I", 0)        # EndMark
    out += struct.pack("<I", xxh32(data))
    return bytes(out)
