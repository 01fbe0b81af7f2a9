"""The EWAH codec (reference: src/ewah.zig): word-aligned hybrid RLE over u64
words, the wire format of the grid free set (vsr/free_set.py).

The port's copy of `ewah_encode` / `ewah_decode` from `tigerbeetle_tpu/stdx.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

_ALL_ONES = (1 << 64) - 1
# marker layout (reference ewah.zig): bit 0 = uniform bit value,
# bits 1..32 = uniform word run length, bits 33..63 = literal word count
_RUN_MAX = (1 << 32) - 1
_LIT_MAX = (1 << 31) - 1


def ewah_encode(words: list[int]) -> bytes:
    """u64 word array -> EWAH bytes: [marker][literal words...] repeated."""
    out = bytearray()
    i = 0
    n = len(words)
    while i < n:
        # uniform run (all-zero or all-one words)
        bit = 0
        run = 0
        if words[i] in (0, _ALL_ONES):
            bit = 1 if words[i] == _ALL_ONES else 0
            target = _ALL_ONES if bit else 0
            while i < n and words[i] == target and run < _RUN_MAX:
                run += 1
                i += 1
        # literals until the next uniform word
        lit_start = i
        while (
            i < n
            and words[i] not in (0, _ALL_ONES)
            and (i - lit_start) < _LIT_MAX
        ):
            i += 1
        lit = i - lit_start
        marker = bit | (run << 1) | (lit << 33)
        out += marker.to_bytes(8, "little")
        for w in words[lit_start:i]:
            out += w.to_bytes(8, "little")
    return bytes(out)


def ewah_decode(data: bytes, words_count: int) -> list[int]:
    words: list[int] = []
    off = 0
    while off < len(data) and len(words) < words_count:
        if off + 8 > len(data):
            raise ValueError("ewah: truncated marker")
        marker = int.from_bytes(data[off : off + 8], "little")
        off += 8
        bit = marker & 1
        run = (marker >> 1) & _RUN_MAX
        lit = marker >> 33
        if len(words) + run + lit > words_count:
            # reject before materializing: a corrupt marker's 2^32-word run
            # must raise, not OOM
            raise ValueError("ewah: marker exceeds expected word count")
        words.extend([_ALL_ONES if bit else 0] * run)
        if off + 8 * lit > len(data):
            raise ValueError("ewah: truncated literals")
        for _ in range(lit):
            words.append(int.from_bytes(data[off : off + 8], "little"))
            off += 8
    if len(words) != words_count:
        raise ValueError(f"ewah: decoded {len(words)} of {words_count} words")
    return words
