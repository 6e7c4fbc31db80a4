"""MurmurHash3 x64 128-bit, matching Guava's ``Hashing.murmur3_128()``.

The reference keys variants by a Guava murmur3_128 of
contig / start / end / referenceBases / alternateBases
(``VariantsPca.scala:71-86``) and joins datasets on the resulting hex string.
Guava's ``HashCode.toString()`` is the lowercase hex of the digest bytes, which
for murmur3_128 are ``h1`` little-endian followed by ``h2`` little-endian; its
``Hasher.putString(s, UTF_8)`` appends UTF-8 bytes and ``putLong`` appends 8
little-endian bytes. We reproduce that byte protocol exactly so that variant
keys are stable and comparable with the reference's.
"""

_MASK = (1 << 64) - 1
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _fmix(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK
    k ^= k >> 33
    return k


def murmur3_x64_128(data: bytes, seed: int = 0) -> bytes:
    """Digest bytes in Guava order: h1 little-endian then h2 little-endian."""
    length = len(data)
    h1 = seed
    h2 = seed
    nblocks = length // 16

    for i in range(nblocks):
        off = i * 16
        k1 = int.from_bytes(data[off : off + 8], "little")
        k2 = int.from_bytes(data[off + 8 : off + 16], "little")

        k1 = (k1 * _C1) & _MASK
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
        h1 = _rotl(h1, 27)
        h1 = (h1 + h2) & _MASK
        h1 = (h1 * 5 + 0x52DCE729) & _MASK

        k2 = (k2 * _C2) & _MASK
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
        h2 = _rotl(h2, 31)
        h2 = (h2 + h1) & _MASK
        h2 = (h2 * 5 + 0x38495AB5) & _MASK

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    tl = len(tail)
    if tl > 8:
        k2 = int.from_bytes(tail[8:], "little")
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
    if tl > 0:
        k1 = int.from_bytes(tail[:8], "little")
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK

    return h1.to_bytes(8, "little") + h2.to_bytes(8, "little")


def murmur3_x64_128_hex(data: bytes, seed: int = 0) -> str:
    """Lowercase hex digest, identical to Guava ``HashCode.toString()``."""
    return murmur3_x64_128(data, seed).hex()
