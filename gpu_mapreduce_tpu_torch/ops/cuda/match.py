"""Pattern matching over a corpus: the map stage's front half.

The counterpart of ``gpu_mapreduce_tpu/ops/pallas/match.py``.  Two
hand-written kernels, each with its plain PyTorch version beside it,
which the wrapper runs only for a CPU tensor:

* the word-packed tier (the map stage's): :func:`mark_words` launches
  ``csrc/mark_words.cu``; :func:`mark_words_ref` is the same
  masked-compare math (the counterpart of ``mark_words_xla``);
* the byte tier, for any pattern of 1 to 128 bytes (a period below 4
  included): :func:`mark` launches ``csrc/mark_bytes.cu``, one code a
  byte from the same alignment tables; :func:`mark_ref` is the
  counterpart of ``mark_xla``.  :func:`compact_matches` and
  :func:`url_lengths` follow it.

The rest (compaction, unaligned URL windows, quote scan, length masking)
is PyTorch on either device.

Word buffers are int32 tensors holding u32 bit patterns; the window
helpers return u32 values in int64 lanes (``ops/bits``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ...core.runtime import DeviceError
from ..bits import M32, to_u32_lanes
from . import library, note_kernel_launch

MAX_NW = 8    # csrc/mark_words.cu: patterns up to 26 bytes


def _min_period(pattern: bytes) -> int:
    for d in range(1, len(pattern)):
        if pattern[d:] == pattern[:-d]:
            return d
    return len(pattern)


def _alignment_tables(pattern: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Per-alignment masked-compare constants: for byte alignment a in
    0..3, (masks[a], vals[a]) are u32 words with 0xFF at the byte
    positions the pattern occupies in the little-endian word window
    starting at the match word."""
    L = len(pattern)
    nw = (L + 3 + 3) // 4
    masks = np.zeros((4, nw), np.uint32)
    vals = np.zeros((4, nw), np.uint32)
    for a in range(4):
        mb = bytearray(4 * nw)
        vb = bytearray(4 * nw)
        for i, p in enumerate(pattern):
            mb[a + i] = 0xFF
            vb[a + i] = p
        masks[a] = np.frombuffer(bytes(mb), "<u4")
        vals[a] = np.frombuffer(bytes(vb), "<u4")
    return masks, vals


def _c_tables(pattern: bytes):
    """The alignment tables as two C arrays of u32 [4 * nw], and nw."""
    masks, vals = _alignment_tables(pattern)
    cm = (ctypes.c_uint32 * masks.size)(*masks.reshape(-1).tolist())
    cv = (ctypes.c_uint32 * vals.size)(*vals.reshape(-1).tolist())
    return cm, cv, masks.shape[1]


def _check_pattern(pattern: bytes) -> None:
    if _min_period(pattern) < 4:
        raise ValueError(
            f"pattern period {_min_period(pattern)} < 4: two alignments of "
            f"one word could match")
    if (len(pattern) + 6) // 4 > MAX_NW:
        raise ValueError(f"pattern of {len(pattern)} bytes spans more than "
                         f"{MAX_NW} words")


def bytes_view_u32(data: np.ndarray) -> np.ndarray:
    """HOST helper: u8 [n] → little-endian u32 words [ceil(n/4)] (zero-pad
    tail)."""
    n = data.shape[0]
    pad = (-n) % 4
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    return np.ascontiguousarray(data).view(np.dtype("<u4"))


def mark_words_ref(words: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """Plain PyTorch version of the kernel: word buffer [m] → int8 [m];
    0 = no match, a+1 = the pattern starts at byte 4*i+a."""
    _check_pattern(pattern)
    masks, vals = _alignment_tables(pattern)
    m = words.shape[0]
    wu = to_u32_lanes(words)
    nw = masks.shape[1]
    views = [wu] + [torch.nn.functional.pad(wu[j:], (0, min(j, m)))
                    for j in range(1, nw)]
    out = torch.zeros(m, dtype=torch.int8, device=words.device)
    for a in range(3, -1, -1):           # lowest alignment wins
        hit = None
        for j in range(nw):
            mk = int(masks[a, j])
            if not mk:
                continue
            eq = (views[j] & mk) == (int(vals[a, j]) & mk)
            hit = eq if hit is None else hit & eq
        out = torch.where(hit, torch.tensor(a + 1, dtype=torch.int8,
                                            device=words.device), out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mark_words_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, u32p, u32p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.mark_words_launch.restype = ctypes.c_int


def mark_output(src: torch.Tensor) -> torch.Tensor:
    """An empty int8 [m] for the mark of ``src`` [m] (a word buffer, or a
    byte buffer for :func:`mark`), one code an element, placed for the
    kernel: its tiles start at the first 16-byte boundary of ``src``
    (``head`` elements in: 0, or up to 3 words or 15 bytes for a view such
    as src[1:]) and store 16 codes at once, so out + head is on a 16-byte
    boundary too (a view into 15 bytes more)."""
    m = src.shape[0]
    head = min(m, (-src.data_ptr() % 16) // src.element_size())
    buf = torch.empty(m + 15, dtype=torch.int8, device=src.device)
    off = -(buf.data_ptr() + head) % 16
    return buf[off:off + m]


def mark_words(words: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """Word-packed mark over a contiguous int32 word buffer [m] → int8
    [m] (see :func:`mark_words_ref`).  A CUDA tensor launches
    ``csrc/mark_words.cu`` on the current stream; a CPU tensor runs the
    plain version.  Anything else raises."""
    _check_pattern(pattern)
    if not isinstance(words, torch.Tensor) or words.dim() != 1 \
            or words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("mark_words takes a contiguous 1-D int32 tensor")
    if words.device.type == "cpu":
        return mark_words_ref(words, pattern)
    if words.device.type != "cuda":
        raise ValueError(f"mark_words: unsupported device {words.device}")
    m = words.shape[0]
    out = mark_output(words)
    if m == 0:
        return out
    cm, cv, nw = _c_tables(pattern)
    lib = library("mark_words", _bind)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.mark_words_launch(words.data_ptr(), out.data_ptr(), m, cm, cv,
                               nw, words.device.index or 0, stream)
    if rc != 0:
        raise DeviceError(f"mark_words kernel launch failed "
                          f"(CUDA error {rc})")
    note_kernel_launch(mark_words)
    return out


mark_words.launches = 0


def compact_word_matches(wmask: torch.Tensor, nbytes: int,
                         max_hits: int) -> Tuple[torch.Tensor, int]:
    """Word mask → ascending byte starts [max_hits] int32 (fill
    ``nbytes``, out of range on purpose) and the total hit count, which
    may exceed ``max_hits``.  The same output as every JAX compaction
    mode (scatter / searchsorted / blocked)."""
    idx = torch.nonzero(wmask, as_tuple=True)[0]      # ascending
    total = int(idx.numel())
    idx = idx[:max_hits]
    starts = torch.full((max_hits,), nbytes, dtype=torch.int32,
                        device=wmask.device)
    starts[:idx.numel()] = (4 * idx + wmask[idx].to(torch.int64)
                            - 1).to(torch.int32)
    return starts, total


def unaligned_words(words: torch.Tensor, starts: torch.Tensor,
                    nwords: int) -> torch.Tensor:
    """Row i holds the ``nwords`` little-endian u32 words whose bytes start
    at BYTE offset ``starts[i]`` (u32 values in int64 lanes), rebuilt from
    aligned loads and shifts.  Out-of-range bytes read as zero."""
    m = words.shape[0]
    st = starts.to(torch.int64)
    k = torch.div(st, 4, rounding_mode="floor")
    sh = (8 * (st - 4 * k))[:, None]
    idx = k[:, None] + torch.arange(nwords + 1, device=words.device)[None, :]
    inside = (idx >= 0) & (idx < m)
    g = to_u32_lanes(words[idx.clamp(0, m - 1)])
    g = torch.where(inside, g, torch.zeros((), dtype=torch.int64,
                                           device=words.device))
    lo = g[:, :-1] >> sh
    hi = torch.where(sh > 0, (g[:, 1:] << (32 - sh)) & M32,
                     torch.zeros((), dtype=torch.int64, device=words.device))
    return lo | hi


def first_byte_pos(wu: torch.Tensor, byte: int) -> torch.Tensor:
    """Per row of a u32 window array [n, W]: byte offset of the first
    occurrence of ``byte`` (int32), or -1."""
    n, W = wu.shape
    shifts = torch.arange(0, 32, 8, device=wu.device)
    b = ((wu[:, :, None] >> shifts) & 0xFF).reshape(n, 4 * W)
    pos = torch.arange(4 * W, dtype=torch.int32, device=wu.device)
    big = torch.tensor(4 * W, dtype=torch.int32, device=wu.device)
    best = torch.where(b == byte, pos, big).amin(dim=1)
    return torch.where(best < 4 * W, best, torch.full_like(best, -1))


_LEN_LUT = (0, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF)


def mask_words_to_length(wu: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Zero every byte at offset >= lengths[i] in row i of a u32 window
    array (the zero-padded words the masked hash requires)."""
    W = wu.shape[1]
    nb = (lengths.to(torch.int64)[:, None]
          - 4 * torch.arange(W, device=wu.device)[None, :]).clamp(0, 4)
    lut = torch.tensor(_LEN_LUT, dtype=torch.int64, device=wu.device)
    return to_u32_lanes(wu) & lut[nb]


# ---------------------------------------------------------------------------
# byte tier
# ---------------------------------------------------------------------------

MAX_PAT = 128  # csrc/mark_bytes.cu: the TPU kernel's one-row halo


def _check_byte_pattern(pattern: bytes) -> None:
    if not 1 <= len(pattern) <= MAX_PAT:
        raise ValueError(f"pattern of {len(pattern)} bytes: the byte mark "
                         f"takes 1 to {MAX_PAT}")


def mark_ref(buf: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """Plain PyTorch version of the byte mark: uint8 [n] → int8 [n], 1
    where ``pattern`` starts at byte i.  Bytes past the end read as 0."""
    _check_byte_pattern(pattern)
    n = buf.shape[0]
    acc = torch.ones(n, dtype=torch.bool, device=buf.device)
    for j, p in enumerate(pattern):
        shifted = torch.nn.functional.pad(buf[j:], (0, min(j, n))) \
            if j else buf
        acc &= shifted == p
    return acc.to(torch.int8)


def _bind_bytes(lib: ctypes.CDLL) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mark_bytes_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, u32p, u32p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.mark_bytes_launch.restype = ctypes.c_int


def mark(buf: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """Byte mark over a contiguous uint8 buffer [n] → int8 [n] (see
    :func:`mark_ref`).  A CUDA tensor launches ``csrc/mark_bytes.cu`` on
    the current stream; a CPU tensor runs the plain version.  Anything
    else raises."""
    _check_byte_pattern(pattern)
    if not isinstance(buf, torch.Tensor) or buf.dim() != 1 \
            or buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError("mark takes a contiguous 1-D uint8 tensor")
    if buf.device.type == "cpu":
        return mark_ref(buf, pattern)
    if buf.device.type != "cuda":
        raise ValueError(f"mark: unsupported device {buf.device}")
    n = buf.shape[0]
    out = mark_output(buf)
    if n == 0:
        return out
    cm, cv, _ = _c_tables(pattern)
    lib = library("mark_bytes", _bind_bytes)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = lib.mark_bytes_launch(buf.data_ptr(), out.data_ptr(), n, cm, cv,
                               len(pattern), buf.device.index or 0, stream)
    if rc != 0:
        raise DeviceError(f"mark_bytes kernel launch failed "
                          f"(CUDA error {rc})")
    note_kernel_launch(mark)
    return out


mark.launches = 0


def compact_matches(mask: torch.Tensor,
                    max_hits: int) -> Tuple[torch.Tensor, int]:
    """Byte mask → ascending start offsets [max_hits] int64 (fill
    ``len(mask)``) and the total hit count, which may exceed
    ``max_hits``."""
    n = mask.shape[0]
    idx = torch.nonzero(mask, as_tuple=True)[0]
    starts = torch.full((max_hits,), n, dtype=torch.int64,
                        device=mask.device)
    k = min(max_hits, idx.numel())
    starts[:k] = idx[:k]
    return starts, int(idx.numel())


def url_lengths(buf: torch.Tensor, starts: torch.Tensor, terminator: int,
                max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per start offset, the distance to the first ``terminator`` byte
    within ``max_len`` (int32; -1 if none), and the windows [k, max_len]
    (uint8, zero past the buffer's end)."""
    n = buf.shape[0]
    pos = starts.to(torch.int64)[:, None] \
        + torch.arange(max_len, device=buf.device)[None, :]
    windows = buf[pos.clamp(max=n - 1)]
    windows = torch.where(pos < n, windows, torch.zeros_like(windows))
    hit = windows == terminator
    first = hit.to(torch.uint8).argmax(dim=1)
    length = torch.where(hit.any(dim=1), first, torch.full_like(first, -1))
    return length.to(torch.int32), windows
