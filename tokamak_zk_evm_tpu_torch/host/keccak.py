"""Keccak-256 (original padding 0x01, as used by Ethereum/Solidity).

Native C++ core (host/keccak256.cpp, built on demand with g++ into the
port's git-ignored build/ directory under `backend.build`'s lock, replaced
into place whole, and loaded with ctypes) with a pure-Python Keccak-f[1600]
fallback — transcript hashing stays on the host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

from ..backend import build

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    try:
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "keccak256.cpp")
        so = os.path.join(build.BUILD_DIR, "libkeccak256.so")
        with build.build_lock():
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.keccak256.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p
        ]
        lib.keccak256.restype = None
        _NATIVE = lib
    except Exception:
        _NATIVE = False
    return _NATIVE

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK64 = (1 << 64) - 1


def _rotl(x, n):
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def _keccak_f(state):
    for rc in _RC:
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= rc
    return state


def keccak256(data: bytes) -> bytes:
    lib = _load_native()
    if lib:
        out = ctypes.create_string_buffer(32)
        lib.keccak256(data, len(data), out)
        return out.raw
    return _keccak256_py(data)


def _keccak256_py(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for Keccak-256
    state = [[0] * 5 for _ in range(5)]
    # pad: 0x01 ... 0x80 (original Keccak, NOT SHA3's 0x06)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : (i + 1) * 8], "little")
            x, y = i % 5, i // 5
            state[x][y] ^= lane
        _keccak_f(state)
    out = b""
    for i in range(4):  # 32 bytes
        x, y = i % 5, i // 5
        out += state[x][y].to_bytes(8, "little")
    return out
