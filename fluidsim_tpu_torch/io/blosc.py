"""Pure-Python Blosc-1 chunk codec for ``.vdb`` interchange.

The reference optionally Blosc-compresses node value buffers
(``openvdb/io/Compression.h:77-81`` ``COMPRESS_BLOSC``;
``openvdb/io/Compression.cc:157-197`` ``bloscToStream`` — c-blosc
``blosc_compress_ctx`` with clevel 9, byte shuffle, typesize 4, codec LZ4,
blocksize = whole buffer).  No ``blosc``/``lz4`` library is a dependency
(the reference's own build compiles Blosc out the same way), so this
module implements the subset of the Blosc-1 chunk format that such files
contain, from the published container layout:

* 16-byte header: version, versionlz, flags, typesize, then little-endian
  uint32 nbytes / blocksize / cbytes.
* flags: bit0 byte-shuffle, bit1 pure-memcpy chunk, bit2 bit-shuffle,
  bit4 "don't split" (c-blosc >= 1.11), bits 5-7 codec id
  (0 blosclz, 1 LZ4/LZ4HC, 2 snappy, 3 zlib, 4 zstd).
* non-memcpy chunks: one uint32 start offset per block, then per block
  ``nsplits`` streams of [int32 csize][csize bytes]; a stream whose csize
  equals its uncompressed size is stored raw.  Blocks are byte-shuffled
  before compression; splitting (one stream per byte lane) applies when
  the "don't split" flag is clear, the block is not a leftover, and the
  lanes are at least MIN_BUFFERSIZE (c-blosc ``blosc_d`` split rule).

Codecs: LZ4 (the one the reference writes) is implemented here in pure
Python; zlib rides :mod:`zlib`.  blosclz / snappy / zstd chunks raise
:class:`BloscError` naming the codec, so a foreign file fails with the
exact reason rather than a parse error.
"""

import struct
import zlib

import numpy as np

# header flag bits
_SHUFFLE = 0x1
_MEMCPYED = 0x2
_BITSHUFFLE = 0x4
_DONT_SPLIT = 0x10

_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_MIN_BUFFERSIZE = 128      # c-blosc MIN_BUFFERSIZE: smaller inputs memcpy
_MAX_SPLITS = 16

FORMAT_VERSION = 2         # BLOSC_VERSION_FORMAT of c-blosc 1.x


class BloscError(ValueError):
    pass


# ---------------------------------------------------------------------------
# LZ4 block codec (the raw block format, no frame)
# ---------------------------------------------------------------------------

def lz4_decompress(src: bytes, dest_size: int) -> bytes:
    """Decode one raw LZ4 block into exactly ``dest_size`` bytes."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        dst += src[i:i + lit]
        i += lit
        if i >= n:
            break                        # final sequence: literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(dst):
            raise BloscError(f"corrupt LZ4 stream: offset {offset} at "
                             f"output position {len(dst)}")
        mlen = (token & 15) + 4
        if token & 15 == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - offset
        if offset >= mlen:
            dst += dst[start:start + mlen]
        else:                            # overlapping match: repeat pattern
            pat = dst[start:]
            reps = -(-mlen // offset)
            dst += (pat * reps)[:mlen]
    if len(dst) != dest_size:
        raise BloscError(f"corrupt LZ4 stream: decoded {len(dst)} bytes, "
                         f"expected {dest_size}")
    return bytes(dst)


def lz4_compress(src: bytes) -> bytes:
    """Greedy single-pass LZ4 block encoder (hash of 4-byte prefixes).

    Respects the block-format end rules: the last 5 bytes are literals and
    no match starts within the final 12 bytes.  Used for writing
    Blosc-flagged ``.vdb`` files and test fixtures; ratio is close to
    LZ4-fast, which is all the container needs (a stream that does not
    shrink is stored raw by the chunk writer anyway).
    """
    n = len(src)
    if n < 13:                           # too short for any match
        return _lz4_emit(src, b"")
    out = bytearray()
    table = {}
    anchor = 0                           # start of pending literals
    i = 0
    limit = n - 12                       # last legal match start (spec)
    mflimit = n - 5                      # matches must end before here
    while i < limit:
        key = src[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 0xFFFF or src[j:j + 4] != key:
            i += 1
            continue
        # extend match forward (bounded so the last 5 bytes stay literal)
        mlen = 4
        while i + mlen < mflimit and src[j + mlen] == src[i + mlen]:
            mlen += 1
        out += _lz4_sequence(src[anchor:i], i - j, mlen)
        i += mlen
        anchor = i
    out += _lz4_emit(src[anchor:], b"")
    return bytes(out)


def _lz4_length(base_token: int, length: int) -> bytes:
    if length < 15:
        return b""
    rest = length - 15
    extra = bytearray()
    while rest >= 255:
        extra.append(255)
        rest -= 255
    extra.append(rest)
    return bytes(extra)


def _lz4_sequence(literals: bytes, offset: int, mlen: int) -> bytes:
    lit = len(literals)
    token = (min(lit, 15) << 4) | min(mlen - 4, 15)
    return (bytes([token]) + _lz4_length(token >> 4, lit) + literals
            + struct.pack("<H", offset) + _lz4_length(token & 15, mlen - 4))


def _lz4_emit(literals: bytes, tail: bytes) -> bytes:
    lit = len(literals)
    token = min(lit, 15) << 4
    return bytes([token]) + _lz4_length(token >> 4, lit) + literals + tail


# ---------------------------------------------------------------------------
# byte shuffle
# ---------------------------------------------------------------------------

def _shuffle(data: bytes, typesize: int) -> bytes:
    n = len(data) - len(data) % typesize
    arr = np.frombuffer(data[:n], np.uint8).reshape(-1, typesize)
    return arr.T.tobytes() + data[n:]    # trailing remainder stays in place


def _unshuffle(data: bytes, typesize: int) -> bytes:
    n = len(data) - len(data) % typesize
    arr = np.frombuffer(data[:n], np.uint8).reshape(typesize, -1)
    return arr.T.tobytes() + data[n:]


# ---------------------------------------------------------------------------
# chunk codec
# ---------------------------------------------------------------------------

def _nsplits(flags: int, typesize: int, bsize: int, leftover: bool) -> int:
    """c-blosc ``blosc_d`` stream-count rule for one block."""
    if flags & _DONT_SPLIT or leftover:
        return 1
    if not 2 <= typesize <= _MAX_SPLITS:
        return 1
    if bsize % typesize or bsize // typesize < _MIN_BUFFERSIZE:
        return 1
    return typesize


def decompress(chunk: bytes) -> bytes:
    """Decode one Blosc-1 chunk (header + payload) to its raw bytes."""
    if len(chunk) < 16:
        raise BloscError(f"blosc chunk truncated: {len(chunk)} < 16 header "
                         "bytes")
    version, _versionlz, flags, typesize = chunk[0], chunk[1], chunk[2], chunk[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", chunk, 4)
    if version > 3:
        raise BloscError(f"unsupported blosc format version {version}")
    if cbytes > len(chunk):
        raise BloscError(f"blosc chunk truncated: header says {cbytes} "
                         f"bytes, got {len(chunk)}")
    if flags & _MEMCPYED:
        return bytes(chunk[16:16 + nbytes])
    if flags & _BITSHUFFLE:
        raise BloscError("blosc bit-shuffle filter is not supported by this "
                         "pure-Python reader (byte shuffle only)")
    codec = (flags >> 5) & 7
    if codec not in (1, 3):
        name = _CODEC_NAMES.get(codec, f"id {codec}")
        raise BloscError(
            f"blosc codec '{name}' is not supported by this pure-Python "
            "reader (supported: lz4, zlib; the reference writes lz4 — "
            "openvdb/io/Compression.cc:172)")
    nblocks = -(-nbytes // blocksize) if blocksize else 0
    bstarts = struct.unpack_from(f"<{nblocks}I", chunk, 16)
    out = bytearray()
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - b * blocksize)
        leftover = bsize != blocksize
        nsp = _nsplits(flags, typesize, bsize, leftover)
        neblock = bsize // nsp
        off = bstarts[b]
        block = bytearray()
        for _ in range(nsp):
            (csize,) = struct.unpack_from("<i", chunk, off)
            off += 4
            part = chunk[off:off + csize]
            off += csize
            if csize == neblock:
                block += part            # stored raw
            elif codec == 1:
                block += lz4_decompress(part, neblock)
            else:
                block += zlib.decompress(part)
        if len(block) != bsize:
            raise BloscError(f"blosc block {b}: decoded {len(block)} bytes, "
                             f"expected {bsize}")
        if flags & _SHUFFLE:
            block = bytearray(_unshuffle(bytes(block), typesize))
        out += block
    if len(out) != nbytes:
        raise BloscError(f"blosc chunk: decoded {len(out)} bytes, expected "
                         f"{nbytes}")
    return bytes(out)


def compress(data: bytes, typesize: int = 4) -> bytes:
    """Encode ``data`` as one Blosc-1 chunk the way the reference's
    ``bloscToStream`` parameters would (byte shuffle, LZ4, one block
    spanning the buffer — ``Compression.cc:164-174``).  Falls back to a
    pure-memcpy chunk when compression does not pay."""
    nbytes = len(data)
    if nbytes >= 1 << 31:
        raise BloscError("blosc-1 chunks are limited to 2**31 bytes")
    if nbytes < _MIN_BUFFERSIZE:
        header = struct.pack("<BBBBIII", FORMAT_VERSION, 1, _MEMCPYED,
                             max(typesize, 1) & 0xFF, nbytes,
                             max(nbytes, 1), nbytes + 16)
        return header + data
    flags = _SHUFFLE | (1 << 5)          # byte shuffle + LZ4
    blocksize = nbytes                   # single block, as the reference
    nsp = _nsplits(flags, typesize, blocksize, leftover=False)
    shuffled = _shuffle(data, typesize)
    neblock = blocksize // nsp
    payload = bytearray()
    for s in range(nsp):
        part = shuffled[s * neblock:(s + 1) * neblock]
        comp = lz4_compress(part)
        if len(comp) >= neblock:
            payload += struct.pack("<i", neblock) + part
        else:
            payload += struct.pack("<i", len(comp)) + comp
    body = struct.pack("<I", 20) + bytes(payload)   # bstarts[0] = 16 + 4
    cbytes = 16 + len(body)
    if cbytes >= nbytes + 16:            # compression did not pay: memcpy
        header = struct.pack("<BBBBIII", FORMAT_VERSION, 1, _MEMCPYED,
                             typesize & 0xFF, nbytes, blocksize, nbytes + 16)
        return header + data
    header = struct.pack("<BBBBIII", FORMAT_VERSION, 1, flags,
                         typesize & 0xFF, nbytes, blocksize, cbytes)
    return header + body
