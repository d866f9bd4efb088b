"""Encrypted model artifacts, AES-128-CTR with an HMAC-SHA256 tag (port
of ``paddle_tpu/framework/crypto.py``).

The envelope is the JAX package's byte for byte: ``b"PTENC2" || iv(16)
|| hmac_sha256(iv || body, 32) || body``, with the encryption and MAC
keys derived from the user key by SHA-256 as there, so either package
opens the other's envelope. The JAX package runs the cipher in its
native library (``native/ptnative.cc``); the port keeps the pure-Python
AES as the reference and runs :func:`aes128_ctr` vectorised in numpy
over every counter block of a chunk at once (the rounds as four
256-entry column tables, the usual T-table form).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os

import numpy as np

_MAGIC = b"PTENC2"

_SBOX = None


def _sbox():
    global _SBOX
    if _SBOX is None:
        # the AES S-box from GF(2^8) inverses (``crypto.py:32-56``)
        p, q, box = 1, 1, [0] * 256
        box[0] = 0x63
        while True:
            p ^= ((p << 1) ^ (0x1B if p & 0x80 else 0)) & 0xFF
            q ^= q << 1
            q ^= q << 2
            q ^= q << 4
            q &= 0xFF
            if q & 0x80:
                q ^= 0x09
            x = q ^ ((q << 1) | (q >> 7)) ^ ((q << 2) | (q >> 6)) ^ \
                ((q << 3) | (q >> 5)) ^ ((q << 4) | (q >> 4))
            box[p] = (x ^ 0x63) & 0xFF
            if p == 1:
                break
        _SBOX = box
    return _SBOX


def _xtime(x):
    return ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF


def _expand_key(key16):
    sbox = _sbox()
    rcon = [0, 1, 2, 4, 8, 16, 32, 64, 128, 0x1B, 0x36]
    rk = list(key16)
    for i in range(4, 44):
        t = rk[4 * (i - 1):4 * i]
        if i % 4 == 0:
            t = [sbox[t[1]] ^ rcon[i // 4], sbox[t[2]], sbox[t[3]],
                 sbox[t[0]]]
        rk += [rk[4 * (i - 4) + j] ^ t[j] for j in range(4)]
    return rk


def _encrypt_block_py(rk, block):
    sbox = _sbox()
    s = [b ^ k for b, k in zip(block, rk[:16])]
    for rnd in range(1, 11):
        t = [0] * 16
        for c in range(4):
            for r in range(4):
                t[4 * c + r] = sbox[s[4 * ((c + r) & 3) + r]]
        if rnd < 10:
            s = []
            for c in range(4):
                a = t[4 * c:4 * c + 4]
                s += [
                    _xtime(a[0]) ^ (_xtime(a[1]) ^ a[1]) ^ a[2] ^ a[3],
                    a[0] ^ _xtime(a[1]) ^ (_xtime(a[2]) ^ a[2]) ^ a[3],
                    a[0] ^ a[1] ^ _xtime(a[2]) ^ (_xtime(a[3]) ^ a[3]),
                    (_xtime(a[0]) ^ a[0]) ^ a[1] ^ a[2] ^ _xtime(a[3]),
                ]
        else:
            s = t
        s = [v ^ k for v, k in zip(s, rk[16 * rnd:16 * rnd + 16])]
    return bytes(s)


def aes128_ctr_py(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    """Pure-Python AES-128-CTR: the reference (slow; for tests)."""
    rk = _expand_key(key16)
    out = bytearray(len(data))
    ctr = bytearray(iv16)
    for off in range(0, len(data), 16):
        stream = _encrypt_block_py(rk, ctr)
        chunk = data[off:off + 16]
        out[off:off + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, stream))
        for i in range(15, 7, -1):
            ctr[i] = (ctr[i] + 1) & 0xFF
            if ctr[i]:
                break
    return bytes(out)


# ShiftRows on the column-major state: byte 4c + r takes 4((c + r) % 4) + r;
# _ROWS[r] lists, for each column c, the byte that lands in row r
_ROWS = [np.array([4 * ((c + r) & 3) + r for c in range(4)]) for r in range(4)]
# counter blocks a numpy pass (256 KiB of keystream: cache-sized)
_CHUNK_BLOCKS = 1 << 14
_TABLES = None


def _tables():
    """The S-box and the four round tables: ``Te[r][x]`` is the column
    that S-box byte ``S[x]`` in row ``r`` adds through MixColumns, packed
    little-endian (byte j of the uint32 is row j of the column)."""
    global _TABLES
    if _TABLES is None:
        sb = np.array(_sbox(), np.uint32)
        s2 = np.array([_xtime(int(v)) for v in sb], np.uint32)
        s3 = s2 ^ sb
        cols = ((s2, sb, sb, s3), (s3, s2, sb, sb), (sb, s3, s2, sb),
                (sb, sb, s3, s2))
        te = [c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24) for c in cols]
        _TABLES = (sb.astype(np.uint8), te)
    return _TABLES


def _keystream(rk, iv16: bytes, first: int, n: int) -> np.ndarray:
    """Blocks ``first .. first + n`` of the CTR keystream, [n, 16] uint8:
    the counter is the iv with its low 8 bytes a big-endian count that
    wraps without carrying into the high 8 (``aes128_ctr_py``)."""
    sbox, te = _tables()
    low = np.uint64(int.from_bytes(iv16[8:], "big"))
    with np.errstate(over="ignore"):
        ctr = low + np.arange(first, first + n, dtype=np.uint64)
    s = np.empty((n, 16), np.uint8)
    s[:, :8] = np.frombuffer(iv16[:8], np.uint8)
    s[:, 8:] = ctr.astype(">u8").view(np.uint8).reshape(n, 8)
    s ^= rk[0]
    rk32 = rk.view("<u4")
    for rnd in range(1, 10):
        w = te[0][np.take(s, _ROWS[0], axis=1)]
        for r in range(1, 4):
            w ^= te[r][np.take(s, _ROWS[r], axis=1)]
        w ^= rk32[rnd]
        s = w.view(np.uint8).reshape(n, 16)
    return sbox[s[:, np.concatenate(_ROWS).reshape(4, 4).T.reshape(-1)]] \
        ^ rk[10]


def aes128_ctr(key16: bytes, iv16: bytes, data: bytes) -> bytes:
    """CTR transform (encrypt == decrypt), equal byte for byte to
    :func:`aes128_ctr_py`, vectorised over the counter blocks."""
    rk = np.array(_expand_key(key16), np.uint8).reshape(11, 16)
    src = np.frombuffer(data, np.uint8)
    out = np.empty_like(src)
    blocks = -(-len(src) // 16)
    for first in range(0, blocks, _CHUNK_BLOCKS):
        n = min(_CHUNK_BLOCKS, blocks - first)
        lo, hi = 16 * first, min(len(src), 16 * (first + n))
        ks = _keystream(rk, iv16, first, n).reshape(-1)
        np.bitwise_xor(src[lo:hi], ks[:hi - lo], out=out[lo:hi])
    return out.tobytes()


class AESCipher:
    """AES-128-CTR with HMAC-SHA256 integrity, encrypt-then-MAC."""

    def __init__(self, key: bytes):
        if not isinstance(key, (bytes, bytearray)):
            raise TypeError("key must be bytes")
        self.key = hashlib.sha256(bytes(key) + b"|enc").digest()[:16]
        self._mac_key = hashlib.sha256(bytes(key) + b"|mac").digest()

    def _mac(self, iv: bytes, body: bytes) -> bytes:
        return _hmac.new(self._mac_key, iv + body,
                         hashlib.sha256).digest()

    def encrypt(self, plaintext: bytes) -> bytes:
        iv = os.urandom(16)
        body = aes128_ctr(self.key, iv, plaintext)
        return _MAGIC + iv + self._mac(iv, body) + body

    def decrypt(self, blob: bytes) -> bytes:
        if blob[:len(_MAGIC)] != _MAGIC:
            if blob[:6] == b"PTENC1":
                raise ValueError(
                    "legacy PTENC1 artifact (pre-release CRC envelope); "
                    "re-save it with this version")
            raise ValueError("not a PTENC2 encrypted blob")
        off = len(_MAGIC)
        iv = blob[off:off + 16]
        tag = blob[off + 16:off + 48]
        body = blob[off + 48:]
        if not _hmac.compare_digest(tag, self._mac(iv, body)):
            raise ValueError("decryption integrity check failed "
                             "(wrong key or corrupted file)")
        return aes128_ctr(self.key, iv, body)

    def encrypt_to_file(self, plaintext: bytes, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext))

    def decrypt_from_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read())


class CipherFactory:
    """``CipherFactory.create_cipher() -> cipher``."""

    @staticmethod
    def create_cipher(key: bytes = b"") -> AESCipher:
        if not key:
            key = CipherFactory.generate_key()
        return AESCipher(key)

    @staticmethod
    def generate_key() -> bytes:
        return os.urandom(16)
