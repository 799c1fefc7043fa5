"""A cursor over a file's bytes that reads as OpenCV's RLByteStream and
RMByteStream read (little- or big-endian words): a read past the end
raises UnreadableImage, since cv2's stream throws there and imread
returns None."""

from __future__ import annotations

import struct

from .errors import unreadable


class ByteStream:
    def __init__(self, blob: bytes, path, big_endian: bool = False,
                 pos: int = 0):
        self.blob, self.path, self.pos = blob, path, pos
        self._e = ">" if big_endian else "<"

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.blob):
            unreadable(self.path, "unexpected end of input stream")
        out = self.blob[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return struct.unpack(self._e + "H", self.take(2))[0]

    def dword(self) -> int:
        """A signed 32-bit word (cv2's getDWord returns an int)."""
        return struct.unpack(self._e + "i", self.take(4))[0]

    def skip(self, n: int) -> None:
        self.pos += n

    def at_end(self) -> bool:
        return self.pos >= len(self.blob)
