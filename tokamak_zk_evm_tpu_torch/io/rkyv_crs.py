"""rkyv 0.7 CRS archive reader/writer — `combined_sigma.rkyv` /
`sigma_preprocess.rkyv` compatibility with the reference's published CRS.

The port of the JAX package's `io/rkyv_crs.py`: the host parser and writer
are copied; the device families are torch tensors.  The reader maps the
archive, parses its root, headers and spot checks from the map, and hands
each G1 family section to `_FamilyLoader`, which copies the file's bytes to
the device and decodes them there into Montgomery limb columns
(`backend.kernels.crs_decode`).  The writer converts the families back with
one Fq product by 1 (`ops.field.fq_mul`, K1 on the card) over every column.

The reference serializes its CRS with rkyv 0.7 zero-copy archives
(`packages/backend/libs/src/iotools/mod.rs:1700-1845`:
`SigmaRkyv`/`Sigma1Rkyv`/`Sigma2Rkyv`/`SigmaPreprocessRkyv`; the browser
decoder documents G1 = 96 B (x||y, 48-byte little-endian canonical each) and
G2 = 192 B at `backend-wasm/tools/rkyv-decoder-wasm/src/lib.rs:8-9`).

rkyv 0.7 wire format facts this module relies on:
  * the archived root struct sits at `len(file) - sizeof(ArchivedRoot)`;
  * `ArchivedVec<T>` is 8 bytes: `{ ptr: i32 rel-offset, len: u32 }`, where
    `ptr` is relative to the ptr field's own position;
  * fixed arrays `[u8; N]` are inline;
  * out-of-line data (vec contents) precedes the root.

One caveat: the archived structs derive plain `repr(Rust)`, whose field
ordering is a rustc implementation detail.  The PINNED layout is
`align_desc` — rustc's actual algorithm (descending alignment, declaration
order within a class), independently confirmed by io/rkyv_oracle.py (a
from-scratch port of the reference browser decoder's traversal with
hand-computed literal offsets; the cross-check test asserts both agree
byte-for-byte).  `linear` is retained only as a defensive fallback for
auto-mode; parsed points are validated against the curve equation (an
on-curve check over random offsets is a cryptographically strong
discriminator).  Struct sizes coincide across orderings (Sigma1 = 440 B,
Sigma = 2552 B), so the root position is layout-independent.
"""

from __future__ import annotations

import contextlib
import io
import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import kernels as K
from ..fields import FQ, Q_MOD
from ..ops import field as F
from ..utils import timing
from ..utils.device import resolve_device
from .crs import host_u32

G1_BYTES = 96
G2_BYTES = 192
_VEC = ("vec", 8, 4)

# struct field tables: (name, kind) with kind in {g1, g2, vec, struct:<name>}
_STRUCTS = {
    "Sigma1Rkyv": [
        ("xy_powers", "vec"),
        ("x", "g1"),
        ("y", "g1"),
        ("delta", "g1"),
        ("eta", "g1"),
        ("gamma_inv_o_inst", "vec"),
        ("eta_inv_li_o_inter_alpha4_kj", "vec"),
        ("delta_inv_li_o_prv", "vec"),
        ("delta_inv_alphak_xh_tx", "vec"),
        ("delta_inv_alpha4_xj_tx", "vec"),
        ("delta_inv_alphak_yi_ty", "vec"),
    ],
    "Sigma2Rkyv": [
        ("alpha", "g2"), ("alpha2", "g2"), ("alpha3", "g2"), ("alpha4", "g2"),
        ("gamma", "g2"), ("delta", "g2"), ("eta", "g2"), ("x", "g2"),
        ("y", "g2"),
    ],
    "SigmaRkyv": [
        ("G", "g1"),
        ("H", "g2"),
        ("sigma_1", "struct:Sigma1Rkyv"),
        ("sigma_2", "struct:Sigma2Rkyv"),
        ("lagrange_KL", "g1"),
    ],
    "PartialSigma1Rkyv": [
        ("xy_powers", "vec"),
        ("gamma_inv_o_inst", "vec"),
    ],
    "SigmaPreprocessRkyv": [
        ("sigma_1", "struct:PartialSigma1Rkyv"),
    ],
}

LAYOUT_MODES = ("align_desc", "linear")


def _field_size_align(kind: str, mode: str) -> tuple[int, int]:
    if kind == "g1":
        return G1_BYTES, 1
    if kind == "g2":
        return G2_BYTES, 1
    if kind == "vec":
        return 8, 4
    assert kind.startswith("struct:")
    return struct_layout(kind.split(":", 1)[1], mode).size_align


@dataclass
class StructLayout:
    offsets: dict  # name -> (offset, kind)
    size_align: tuple


_LAYOUT_CACHE: dict = {}


def struct_layout(name: str, mode: str) -> StructLayout:
    """Byte layout of an archived struct under a field-ordering mode."""
    key = (name, mode)
    if key in _LAYOUT_CACHE:
        return _LAYOUT_CACHE[key]
    fields = _STRUCTS[name]
    meta = [
        (fname, kind) + _field_size_align(kind, mode) for fname, kind in fields
    ]
    if mode == "linear":
        order = list(range(len(meta)))
    elif mode == "align_desc":
        order = sorted(range(len(meta)), key=lambda i: -meta[i][3])
    else:
        raise ValueError(f"unknown layout mode {mode}")
    offsets = {}
    pos = 0
    align = 1
    for i in order:
        fname, kind, size, falign = meta[i]
        pos = -(-pos // falign) * falign
        offsets[fname] = (pos, kind)
        pos += size
        align = max(align, falign)
    size = -(-pos // align) * align
    out = StructLayout(offsets=offsets, size_align=(size, align))
    _LAYOUT_CACHE[key] = out
    return out


class RkyvError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Low-level parse helpers
# ---------------------------------------------------------------------------


def _read_vec_header(buf: memoryview, pos: int) -> tuple[int, int]:
    """ArchivedVec at pos -> (content_pos, len)."""
    off, ln = struct.unpack_from("<iI", buf, pos)
    target = pos + off
    if ln and not (0 <= target <= len(buf)):
        raise RkyvError(f"vec rel-ptr out of bounds at {pos}")
    return target, ln


def _g1_bytes_to_int(b: memoryview) -> tuple[int, int]:
    x = int.from_bytes(bytes(b[:48]), "little")
    y = int.from_bytes(bytes(b[48:96]), "little")
    return x, y


def _read_g1(buf: memoryview, pos: int):
    x, y = _g1_bytes_to_int(buf[pos : pos + 96])
    return None if (x == 0 and y == 0) else (x, y)


def _read_g2(buf: memoryview, pos: int):
    x0 = int.from_bytes(bytes(buf[pos : pos + 48]), "little")
    x1 = int.from_bytes(bytes(buf[pos + 48 : pos + 96]), "little")
    y0 = int.from_bytes(bytes(buf[pos + 96 : pos + 144]), "little")
    y1 = int.from_bytes(bytes(buf[pos + 144 : pos + 192]), "little")
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


def _g1_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    if not (0 <= x < Q_MOD and 0 <= y < Q_MOD):
        return False
    return (y * y - (x * x * x + 4)) % Q_MOD == 0


def _g2_on_curve(p) -> bool:
    if p is None:
        return True
    from ..host.curve import G2

    return G2.is_on_curve_affine(p)


STAGE_POINTS = 1 << 20  # G1 entries a staging buffer holds (96 MiB)


def _read_into(fd: int, dst: memoryview, pos: int) -> None:
    """Fill `dst` from the file at byte `pos`; a file that ends first raises."""
    while dst.nbytes:
        got = os.preadv(fd, [dst], pos)
        if got <= 0:
            raise RkyvError(f"file ends before byte {pos + dst.nbytes}")
        dst, pos = dst[got:], pos + got


class _FamilyLoader:
    """G1 family sections of an open archive, decoded on `device`.

    Each chunk of whole entries is read from the file into one of two host
    staging buffers (pinned for a card), copied to the card without waiting
    and decoded there by `kernels.crs_decode` into the family's columns,
    while the host reads the next chunk into the other buffer; a buffer is
    refilled once its last copy has ended.  So the file's bytes cross the bus
    once, and the card holds the finished families and one chunk.  On the
    CPU the plain decode reads the staging buffer itself."""

    def __init__(self, fd: int, size: int, device: torch.device,
                 chunk_points: int = STAGE_POINTS):
        self.fd, self.size, self.device = fd, size, device
        self.chunk = max(1, min(chunk_points, size // G1_BYTES))
        self.card = device.type == "cuda"
        self.host = [None, None]
        self.copied = [None, None]  # the event after each buffer's last copy
        self.turn = 0
        self.raw = None  # the card's chunk of file bytes

    def family(self, sections):
        """(px, py, pinf) of the entries of the (pos, count) sections, in order."""
        for pos, n in sections:
            if n < 0 or pos < 0 or pos + n * G1_BYTES > self.size:
                raise RkyvError(
                    f"G1 section [{pos}, {pos + n * G1_BYTES}) out of bounds ({self.size})")
        total = sum(n for _, n in sections)
        out = (torch.empty((FQ.n_limbs, total), dtype=torch.int32, device=self.device),
               torch.empty((FQ.n_limbs, total), dtype=torch.int32, device=self.device),
               torch.empty(total, dtype=torch.int32, device=self.device))
        off = 0
        for pos, n in sections:
            for k in range(0, n, self.chunk):
                self._decode(pos + k * G1_BYTES, min(self.chunk, n - k), out, off + k)
            off += n
        return out

    def _decode(self, pos: int, n: int, out, off: int) -> None:
        nb = n * G1_BYTES
        j, self.turn = self.turn, self.turn ^ 1
        if self.host[j] is None:
            self.host[j] = torch.empty(self.chunk * G1_BYTES, dtype=torch.uint8,
                                       pin_memory=self.card)
        elif self.copied[j] is not None:
            with timing.sync("crs.staging"):
                self.copied[j].synchronize()
        host = self.host[j][:nb]
        with timing.span("crs.read"):
            _read_into(self.fd, memoryview(host.numpy()), pos)
        timing.count("crs.staged_bytes", k=nb)
        with timing.span("crs.decode"):
            raw = host
            if self.card:
                if self.raw is None:
                    self.raw = torch.empty(self.chunk * G1_BYTES, dtype=torch.uint8,
                                           device=self.device)
                raw = self.raw[:nb]
                raw.copy_(host, non_blocking=True)
                self.copied[j] = torch.cuda.Event()
                self.copied[j].record(torch.cuda.current_stream(self.device))
            K.crs_decode(raw, n, *out, off)

    def finish(self) -> None:
        """Wait for the last copies and decodes: the load's one wait at its end."""
        if self.card:
            with timing.sync("crs.upload"):
                torch.cuda.current_stream(self.device).synchronize()


def fq_cols_from_mont(a):
    """[24, N] Montgomery limb columns -> canonical (a product by 1)."""
    one = np.zeros((FQ.n_limbs, 1), np.int32)
    one[0, 0] = 1
    return F.fq_mul(a, F.tensor(one, a.device))


def _g1_family_to_bytes(family) -> bytes:
    """Device affine family (px, py, pinf Montgomery) -> n*96 rkyv bytes."""
    px, py, pinf = family
    n = int(px.shape[1])
    if n == 0:
        return b""
    xc = host_u32(fq_cols_from_mont(px.contiguous()))
    yc = host_u32(fq_cols_from_mont(py.contiguous()))
    infs = host_u32(pinf).astype(bool)
    out = np.empty((n, 96), np.uint8)
    out[:, :48] = np.ascontiguousarray(xc.T.astype("<u2")).view(np.uint8).reshape(n, 48)
    out[:, 48:] = np.ascontiguousarray(yc.T.astype("<u2")).view(np.uint8).reshape(n, 48)
    out[infs] = 0
    return out.tobytes()


def _g1_to_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 96
    return p[0].to_bytes(48, "little") + p[1].to_bytes(48, "little")


def _g2_to_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 192
    (x0, x1), (y0, y1) = p
    return (
        x0.to_bytes(48, "little") + x1.to_bytes(48, "little")
        + y0.to_bytes(48, "little") + y1.to_bytes(48, "little")
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class _Writer:
    """rkyv-style serializer: out-of-line vec contents first (in field
    declaration order, inner vecs before their outer vec-of-vecs), archived
    root last."""

    def __init__(self):
        self.buf = io.BytesIO()

    def pos(self) -> int:
        return self.buf.tell()

    def align(self, a: int) -> int:
        pad = (-self.pos()) % a
        if pad:
            self.buf.write(b"\x00" * pad)
        return self.pos()

    def write(self, b: bytes) -> int:
        p = self.pos()
        self.buf.write(b)
        return p

    def write_g1_list(self, pts) -> tuple[int, int]:
        p = self.pos()
        for q in pts:
            self.buf.write(_g1_to_bytes(q))
        return p, len(pts)

    def vec_header(self, field_pos: int, content_pos: int, n: int) -> bytes:
        return struct.pack("<iI", content_pos - field_pos, n)


def _emit_struct(
    w: _Writer, name: str, mode: str, values: dict
) -> bytes:
    """Render one archived struct's bytes given per-field prepared values:
    g1/g2 -> bytes; vec -> (content_pos, len)."""
    lay = struct_layout(name, mode)
    size, _ = lay.size_align
    out = bytearray(size)
    base = w.pos()
    for fname, (off, kind) in lay.offsets.items():
        v = values[fname]
        if kind in ("g1", "g2"):
            out[off : off + len(v)] = v
        elif kind == "vec":
            content_pos, n = v
            out[off : off + 8] = w.vec_header(base + off, content_pos, n)
        else:
            out[off : off + len(v)] = v
    return bytes(out)


def write_combined_sigma(sigma, params, path: str, mode: str = "align_desc"):
    """Serialize our Sigma to a reference-shaped combined_sigma.rkyv."""
    s1 = sigma.sigma_1
    w = _Writer()

    # --- out-of-line content, declaration order --------------------------
    w.align(1)
    xy_pos = w.write(_g1_family_to_bytes(s1.xy_powers))
    xy_n = int(s1.xy_powers[0].shape[1])
    gi_pos = w.write(_g1_family_to_bytes(s1.gamma_inv_o_inst))
    gi_n = int(s1.gamma_inv_o_inst[0].shape[1])

    def vec_of_vecs_from_family(family, rows, cols):
        # one conversion for the whole family; row r is its r-th slice
        data = _g1_family_to_bytes(family)
        row = 96 * cols
        inner = []
        for r in range(rows):
            inner.append((w.write(data[r * row:(r + 1) * row]), cols))
        w.align(4)
        outer_pos = w.pos()
        for i, (cpos, n) in enumerate(inner):
            w.write(w.vec_header(outer_pos + 8 * i, cpos, n))
        return outer_pos, rows

    m_i = params.l_D - params.l
    m_prv = params.m_D - params.l_D
    inter = vec_of_vecs_from_family(
        s1.eta_inv_li_o_inter_alpha4_kj, m_i, params.s_max
    )
    prv = vec_of_vecs_from_family(s1.delta_inv_li_o_prv, m_prv, params.s_max)

    def vec_of_vecs_from_lists(rows):
        inner = []
        for row in rows:
            inner.append(w.write_g1_list(row))
        w.align(4)
        outer_pos = w.pos()
        for i, (cpos, n) in enumerate(inner):
            w.write(w.vec_header(outer_pos + 8 * i, cpos, n))
        return outer_pos, len(rows)

    dxh = vec_of_vecs_from_lists(s1.delta_inv_alphak_xh_tx)
    dx4 = w.write_g1_list(s1.delta_inv_alpha4_xj_tx)
    dyi = vec_of_vecs_from_lists(s1.delta_inv_alphak_yi_ty)

    # --- root -------------------------------------------------------------
    w.align(4)
    sigma1_values = {
        "xy_powers": (xy_pos, xy_n),
        "x": _g1_to_bytes(s1.x), "y": _g1_to_bytes(s1.y),
        "delta": _g1_to_bytes(s1.delta), "eta": _g1_to_bytes(s1.eta),
        "gamma_inv_o_inst": (gi_pos, gi_n),
        "eta_inv_li_o_inter_alpha4_kj": inter,
        "delta_inv_li_o_prv": prv,
        "delta_inv_alphak_xh_tx": dxh,
        "delta_inv_alpha4_xj_tx": dx4,
        "delta_inv_alphak_yi_ty": dyi,
    }
    s2 = sigma.sigma_2
    sigma2_values = {
        k: _g2_to_bytes(getattr(s2, k))
        for k in ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta",
                  "eta", "x", "y")
    }
    root_base = w.pos()
    s1_off = struct_layout("SigmaRkyv", mode).offsets["sigma_1"][0]
    s2_off = struct_layout("SigmaRkyv", mode).offsets["sigma_2"][0]
    # vec headers inside sigma_1 are relative to their absolute position,
    # so emit sigma_1 knowing its base = root_base + its offset in SigmaRkyv
    class _Shifted:
        def __init__(self, base):
            self._base = base

        def pos(self):
            return self._base

        def vec_header(self, field_pos, content_pos, n):
            return struct.pack("<iI", content_pos - field_pos, n)

    s1_bytes = _emit_struct(_Shifted(root_base + s1_off), "Sigma1Rkyv", mode,
                            sigma1_values)
    s2_bytes = _emit_struct(_Shifted(root_base + s2_off), "Sigma2Rkyv", mode,
                            sigma2_values)
    root_values = {
        "G": _g1_to_bytes(sigma.G),
        "H": _g2_to_bytes(sigma.H),
        "sigma_1": s1_bytes,
        "sigma_2": s2_bytes,
        "lagrange_KL": _g1_to_bytes(sigma.lagrange_KL),
    }
    root = _emit_struct(_Shifted(root_base), "SigmaRkyv", mode, root_values)
    w.write(root)
    data = w.buf.getvalue()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def write_sigma_preprocess(sigma, params, path: str, mode: str = "align_desc"):
    s1 = sigma.sigma_1
    w = _Writer()
    xy_pos = w.write(_g1_family_to_bytes(s1.xy_powers))
    xy_n = int(s1.xy_powers[0].shape[1])
    gi_pos = w.write(_g1_family_to_bytes(s1.gamma_inv_o_inst))
    gi_n = int(s1.gamma_inv_o_inst[0].shape[1])
    w.align(4)
    root_base = w.pos()

    class _Shifted:
        def __init__(self, base):
            self._base = base

        def pos(self):
            return self._base

        def vec_header(self, field_pos, content_pos, n):
            return struct.pack("<iI", content_pos - field_pos, n)

    p_off = struct_layout("SigmaPreprocessRkyv", mode).offsets["sigma_1"][0]
    inner = _emit_struct(
        _Shifted(root_base + p_off), "PartialSigma1Rkyv", mode,
        {"xy_powers": (xy_pos, xy_n), "gamma_inv_o_inst": (gi_pos, gi_n)},
    )
    root = _emit_struct(
        _Shifted(root_base), "SigmaPreprocessRkyv", mode, {"sigma_1": inner}
    )
    w.write(root)
    data = w.buf.getvalue()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def _parse_g1_vec_points(buf, pos, n):
    if n < 0 or pos < 0 or pos + 96 * n > len(buf):
        raise RkyvError(
            f"G1 vec [{pos}, {pos + 96 * n}) out of bounds ({len(buf)})"
        )
    return [_read_g1(buf, pos + 96 * i) for i in range(n)]


def _parse_combined(buf, params, mode: str, loader: _FamilyLoader):
    root_size, root_align = struct_layout("SigmaRkyv", mode).size_align
    if len(buf) < root_size:
        raise RkyvError("file smaller than archived SigmaRkyv")
    root = len(buf) - root_size
    lay = struct_layout("SigmaRkyv", mode).offsets
    s1lay = struct_layout("Sigma1Rkyv", mode).offsets
    s2lay = struct_layout("Sigma2Rkyv", mode).offsets
    s1_base = root + lay["sigma_1"][0]
    s2_base = root + lay["sigma_2"][0]

    G = _read_g1(buf, root + lay["G"][0])
    H = _read_g2(buf, root + lay["H"][0])
    lagrange = _read_g1(buf, root + lay["lagrange_KL"][0])
    x = _read_g1(buf, s1_base + s1lay["x"][0])
    y = _read_g1(buf, s1_base + s1lay["y"][0])
    delta = _read_g1(buf, s1_base + s1lay["delta"][0])
    eta = _read_g1(buf, s1_base + s1lay["eta"][0])

    xy_pos, xy_n = _read_vec_header(buf, s1_base + s1lay["xy_powers"][0])
    gi_pos, gi_n = _read_vec_header(
        buf, s1_base + s1lay["gamma_inv_o_inst"][0]
    )
    # --- validation: structural + on-curve spot checks -------------------
    rs_y = 2 * params.s_max
    h_max = max(2 * params.n, 2 * params.m_i)
    if xy_n != h_max * rs_y:
        raise RkyvError(f"xy_powers len {xy_n} != {h_max * rs_y}")
    if gi_n != params.l:
        raise RkyvError(f"gamma_inv_o_inst len {gi_n} != {params.l}")
    if xy_pos + 96 * xy_n > len(buf) or gi_pos + 96 * gi_n > len(buf):
        raise RkyvError("vec content out of bounds")
    for p in (G, x, y, delta, eta, lagrange):
        if not _g1_on_curve(p):
            raise RkyvError("G1 point fails curve equation")
    if not _g2_on_curve(H):
        raise RkyvError("H fails curve equation")
    rng = np.random.RandomState(0)
    for i in rng.randint(0, xy_n, size=4):
        if not _g1_on_curve(_read_g1(buf, xy_pos + 96 * int(i))):
            raise RkyvError(f"xy_powers[{i}] fails curve equation")

    def read_vec_of_vecs_flat(field, rows, cols):
        opos, on = _read_vec_header(buf, s1_base + s1lay[field][0])
        if on != rows:
            raise RkyvError(f"{field}: {on} rows != {rows}")
        # fast path: rkyv writes inner vec contents contiguously, one
        # section; else the rows, each its own section
        secs = []
        for r in range(rows):
            cpos, cn = _read_vec_header(buf, opos + 8 * r)
            if cn != cols:
                raise RkyvError(f"{field}[{r}]: {cn} cols != {cols}")
            secs.append(cpos)
        if all(secs[r] == secs[0] + 96 * cols * r for r in range(rows)):
            return loader.family([(secs[0], rows * cols)])
        timing.count("crs.rows_fallback")
        return loader.family([(pos, cols) for pos in secs])

    def read_vec_of_g1_lists(field):
        opos, on = _read_vec_header(buf, s1_base + s1lay[field][0])
        out = []
        for r in range(on):
            cpos, cn = _read_vec_header(buf, opos + 8 * r)
            out.append(_parse_g1_vec_points(buf, cpos, cn))
        return out

    m_i = params.l_D - params.l
    m_prv = params.m_D - params.l_D
    inter = read_vec_of_vecs_flat(
        "eta_inv_li_o_inter_alpha4_kj", m_i, params.s_max
    )
    prv = read_vec_of_vecs_flat("delta_inv_li_o_prv", m_prv, params.s_max)
    dxh = read_vec_of_g1_lists("delta_inv_alphak_xh_tx")
    dx4_pos, dx4_n = _read_vec_header(
        buf, s1_base + s1lay["delta_inv_alpha4_xj_tx"][0]
    )
    dx4 = _parse_g1_vec_points(buf, dx4_pos, dx4_n)
    dyi = read_vec_of_g1_lists("delta_inv_alphak_yi_ty")

    sigma2 = {
        k: _read_g2(buf, s2_base + s2lay[k][0])
        for k in ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta",
                  "eta", "x", "y")
    }
    for k, p in sigma2.items():
        if not _g2_on_curve(p):
            raise RkyvError(f"sigma_2.{k} fails curve equation")

    from ..models.setup import Sigma, Sigma1, Sigma2

    sigma1 = Sigma1(
        xy_powers=loader.family([(xy_pos, xy_n)]),
        h_max=h_max,
        rs_y=rs_y,
        gamma_inv_o_inst=loader.family([(gi_pos, gi_n)]),
        eta_inv_li_o_inter_alpha4_kj=inter,
        delta_inv_li_o_prv=prv,
        x=x, y=y, delta=delta, eta=eta,
        delta_inv_alphak_xh_tx=dxh,
        delta_inv_alpha4_xj_tx=dx4,
        delta_inv_alphak_yi_ty=dyi,
    )
    return Sigma(
        G=G, H=H, sigma_1=sigma1, sigma_2=Sigma2(**sigma2),
        lagrange_KL=lagrange,
    )


def _load(path: str, parse, params, mode: str, device: torch.device,
          chunk_points: int = STAGE_POINTS):
    """Map the archive at `path` and `parse` it under each layout candidate
    (mode 'auto') or `mode`, the families through one `_FamilyLoader`;
    the first that validates is returned once its device work is done."""
    modes = LAYOUT_MODES if mode == "auto" else (mode,)
    errors = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        mapped = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size
                  else contextlib.nullcontext(b""))  # an empty file cannot be mapped
        with mapped as buf:
            loader = _FamilyLoader(f.fileno(), size, device, chunk_points)
            for m in modes:
                try:
                    out = parse(buf, params, m, loader)
                except (ValueError, IndexError, struct.error) as e:
                    # ValueError covers RkyvError; IndexError covers malformed
                    # empty sections — auto mode must degrade to the next
                    # layout candidate, never crash
                    errors.append(f"{m}: {e}")
                    continue
                loader.finish()
                return out
    raise RkyvError("no layout mode matched: " + "; ".join(errors))


def read_combined_sigma(path: str, params, mode: str = "auto", device=None):
    """Parse combined_sigma.rkyv -> Sigma (families on `device`, default
    cuda, Montgomery).

    mode='auto' tries each field-layout candidate and accepts the first
    whose points validate on-curve."""
    return _load(path, _parse_combined, params, mode, resolve_device(device))


def _parse_preprocess(buf, params, mode: str, loader: _FamilyLoader):
    root_size, _ = struct_layout("SigmaPreprocessRkyv", mode).size_align
    if len(buf) < root_size:
        raise RkyvError("file smaller than archived SigmaPreprocessRkyv")
    root = len(buf) - root_size
    lay = struct_layout("SigmaPreprocessRkyv", mode).offsets
    p1lay = struct_layout("PartialSigma1Rkyv", mode).offsets
    base = root + lay["sigma_1"][0]
    xy_pos, xy_n = _read_vec_header(buf, base + p1lay["xy_powers"][0])
    gi_pos, gi_n = _read_vec_header(buf, base + p1lay["gamma_inv_o_inst"][0])
    rs_y = 2 * params.s_max
    h_max = max(2 * params.n, 2 * params.m_i)
    if xy_n != h_max * rs_y:
        raise RkyvError(f"xy_powers len {xy_n} != {h_max * rs_y}")
    if gi_n != params.l:
        raise RkyvError(f"gamma_inv_o_inst len {gi_n} != {params.l}")
    rng = np.random.RandomState(1)
    for i in rng.randint(0, xy_n, size=4):
        if not _g1_on_curve(_read_g1(buf, xy_pos + 96 * int(i))):
            raise RkyvError(f"xy_powers[{i}] fails curve equation")
    return (
        loader.family([(xy_pos, xy_n)]),
        loader.family([(gi_pos, gi_n)]),
        h_max,
        rs_y,
    )


def read_sigma_preprocess(path: str, params, mode: str = "auto", device=None):
    """Parse sigma_preprocess.rkyv -> (xy_powers, gamma_inv_o_inst, h_max,
    rs_y), the families on `device` (default cuda)."""
    return _load(path, _parse_preprocess, params, mode, resolve_device(device))
