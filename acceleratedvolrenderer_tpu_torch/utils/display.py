"""tev display-server client: live render preview over TCP (port of
acceleratedvolrenderer_tpu/utils/display.py, numpy and sockets only).

Speaks tev's IPC protocol (little-endian length-prefixed packets:
CreateImage=4, UpdateImageV3=6, CloseImage=2).

Usage:
    disp = TevDisplay()            # connects to tev at 127.0.0.1:14158
    disp.create("render", W, H)
    disp.update("render", rgb)     # per wave
"""
from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

_PACKET_CREATE = 4
_PACKET_UPDATE_V3 = 6
_PACKET_CLOSE = 2


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


class TevDisplay:
    def __init__(self, host: str = "127.0.0.1", port: int = 14158,
                 timeout: float = 1.0):
        self.sock: Optional[socket.socket] = None
        try:
            self.sock = socket.create_connection((host, port), timeout=timeout)
        except OSError:
            self.sock = None  # no viewer running: all ops become no-ops

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def _send(self, payload: bytes):
        if self.sock is None:
            return
        try:
            self.sock.sendall(struct.pack("<I", len(payload) + 4) + payload)
        except OSError:
            self.sock = None

    def create(self, name: str, width: int, height: int,
               channels=("R", "G", "B")):
        p = struct.pack("<B", _PACKET_CREATE)
        p += struct.pack("<B", 1)  # grabFocus
        p += _cstr(name)
        p += struct.pack("<ii", width, height)
        p += struct.pack("<i", len(channels))
        for c in channels:
            p += _cstr(c)
        self._send(p)

    def update(self, name: str, rgb: np.ndarray, x: int = 0, y: int = 0):
        """Send an (H, W, C) float32 tile."""
        rgb = np.ascontiguousarray(rgb, np.float32)
        h, w, nc = rgb.shape
        p = struct.pack("<B", _PACKET_UPDATE_V3)
        p += struct.pack("<B", 0)  # grabFocus
        p += _cstr(name)
        p += struct.pack("<i", nc)
        for i in range(nc):
            p += _cstr("RGBA"[i])
        p += struct.pack("<iiii", x, y, w, h)
        for i in range(nc):
            p += struct.pack("<qq", i, nc)  # channel offset, stride
        p += rgb.tobytes()
        self._send(p)

    def close_image(self, name: str):
        self._send(struct.pack("<B", _PACKET_CLOSE) + _cstr(name))

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None
