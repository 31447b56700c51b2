"""threefry — the threefry2x32 hash behind ``prng``'s planes: on a CUDA
device one launch of ``csrc/threefry.cu`` a plane (the hash itself is
``csrc/threefry.cuh``, which B1's and B9's keyed entries share), elsewhere
the int64 path below, which is also that kernel's plain version.

``threefry_plane(key, shape, out=...)`` is ``prng.bits`` (``out`` "int32"
or "int64") or ``prng.uniform`` ("f32") of one key (2,) or of a batch of
keys (..., 2), shaped ``(*key.shape[:-1], *shape)``, at the counters
``start`` + flat index (``start`` 0 is ``jax.random``'s). It replaces no
TPU kernel: the reference draws its planes with XLA's threefry outside any
Pallas kernel. On a CUDA device it launches the kernel once or raises; on
the CPU it computes :func:`threefry_plane_plain`. Every launch adds one to
:data:`launches` and to ``shape_launches`` (keyed ``(out, keys, n)``);
plain calls count nothing.

torch cannot shift ``uint32`` (ROADMAP C3), so on the int64 path every word
is carried in int64 and masked to 32 bits after each add and shift. One
hash, :func:`threefry2x32`, serves Python integers and tensors alike, since
it only uses ``+ << >> | ^ &``. Each add, shift, mask, or and xor of it on
tensors is its own elementwise launch, so :data:`int64_cuda_planes` counts
the int64 hashes made on a CUDA device (the plain version's, or a split of
keys that live on the card): no path of the port makes one.

This module imports nothing of ``prng``: ``prng`` (keys and the
``jax.random`` draws) calls down into it.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SMALL = 16          # counts up to this many are hashed as Python integers
CHUNK = 1 << 24      # flat indices hashed per pass of a large plane
OUTS = {"int32": torch.int32, "int64": torch.int64, "f32": torch.float32}
OUT_KINDS = {"int32": 0, "int64": 1, "f32": 2}   # csrc/threefry.cu · OUT_*

int64_cuda_planes = 0  # int64 hashes of tensors made on a CUDA device
launches = 0          # kernel launches made by threefry_plane() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (out, keys, n) → launches


def reset_counts():
    """Set the launch counters of this module to 0 (the kernel's; not
    :data:`int64_cuda_planes`)."""
    global launches
    launches = 0
    shape_launches.clear()


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2). Operands are Python ints or int64 tensors holding
    uint32 values; they broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def words(key: torch.Tensor, device, extra_dims: int):
    """Key words as Python ints (one key) or as tensors shaped to broadcast
    against ``extra_dims`` trailing count dims (a batch of keys)."""
    if key.shape[-1] != 2:
        raise ValueError(f"a key has two words in its last dim, got {tuple(key.shape)}")
    if key.ndim == 1:
        return int(key[0]), int(key[1])
    k = key.to(device=device, dtype=torch.int64)
    shape = (*key.shape[:-1], *([1] * extra_dims))
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def _note_int64(device):
    global int64_cuda_planes
    if device.type == "cuda":
        int64_cuda_planes += 1


def hash_counts(key: torch.Tensor, shape: tuple, device, start: int = 0):
    """threefry of the counter start + i (high word, low word) of every flat
    index i of ``shape`` under ``key`` — JAX's ``iota_2x32_shape`` counters
    at ``start`` 0 — by the int64 path. Returns the two output planes,
    shaped ``(*key.shape[:-1], *shape)``."""
    device = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    k1, k2 = words(key, device, len(shape))
    if key.ndim == 1 and n <= _SMALL and device.type == "cpu":
        pairs = [threefry2x32(k1, k2, (start + i) >> 32, (start + i) & MASK)
                 for i in range(n)]
        return (torch.tensor([p[0] for p in pairs], dtype=torch.int64).reshape(shape),
                torch.tensor([p[1] for p in pairs], dtype=torch.int64).reshape(shape))
    _note_int64(device)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device).reshape(shape)
    hi = idx >> 32 if start + n > MASK + 1 else 0
    return threefry2x32(k1, k2, hi, idx)


def _xor(w1, w2):
    return w1 ^ w2


def _unit_float(w1, w2):
    m = ((w1 ^ w2) >> 9) | 0x3F800000
    return m.to(torch.int32).view(torch.float32) - 1.0


def threefry_plane_plain(key: torch.Tensor, shape, *, out: str = "int32",
                         start: int = 0, device=None) -> torch.Tensor:
    """The kernel's plain version, the int64 path: :func:`hash_counts`'
    words combined as ``out``. Each word depends only on the key and its
    counter (partitionable mode), so a plane of one key larger than
    :data:`CHUNK` is hashed CHUNK counters at a time into its output: the
    int64 temporaries of one pass stay ~CHUNK × 8 bytes each, whatever the
    plane's size, and the result is the same bits."""
    shape = tuple(shape)
    device = key.device if device is None else torch.device(device)
    combine, dtype = (_unit_float if out == "f32" else _xor), OUTS[out]
    n = math.prod(shape)
    if key.ndim != 1 or n <= CHUNK:
        return combine(*hash_counts(key, shape, device, start)).to(dtype)
    k1, k2 = words(key, device, 0)
    _note_int64(device)
    plane = torch.empty(n, dtype=dtype, device=device)
    for s0 in range(0, n, CHUNK):
        s1 = min(n, s0 + CHUNK)
        idx = torch.arange(start + s0, start + s1, dtype=torch.int64, device=device)
        hi = idx >> 32 if start + s1 > MASK + 1 else 0
        plane[s0:s1] = combine(*threefry2x32(k1, k2, hi, idx & MASK))
    return plane.reshape(shape)


def _lib():
    lib = _build.load("threefry")
    if not getattr(lib, "_typed", False):
        p, u, ll = ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong
        lib.threefry_plane_launch.argtypes = [p, u, u, ll, ctypes.c_ulonglong, ll,
                                              ctypes.c_int, p, p]
        lib.threefry_plane_launch.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [ctypes.c_int]
        lib.threefry_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _keys_on(key: torch.Tensor, device) -> torch.Tensor:
    """A batch of keys as a contiguous (K, 2) int64 tensor on ``device``:
    keys on the host go in one non-blocking copy from pinned memory (a copy
    from pageable memory would make the host wait for the stream)."""
    k = key.reshape(-1, 2).to(torch.int64).contiguous()
    if k.device == device:
        return k
    if k.device.type == "cpu":
        return k.pin_memory().to(device, non_blocking=True)
    return k.to(device)


def threefry_plane(key: torch.Tensor, shape, *, out: str = "int32", start: int = 0,
                   device=None) -> torch.Tensor:
    """The ``out`` plane of ``shape`` under each key of ``key`` (one key
    (2,) or a batch (..., 2)) at counters ``start`` + flat index, on
    ``device`` (the key's by default): int32 or int64 bits words, or f32
    uniforms in [0, 1). Returns ``(*key.shape[:-1], *shape)``."""
    global launches
    shape = tuple(int(d) for d in shape)
    if key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"threefry_plane: a key has two words in its last dim, "
                         f"got {tuple(key.shape)}")
    if out not in OUT_KINDS:
        raise ValueError(f"threefry_plane: out must be one of {sorted(OUT_KINDS)}, got {out!r}")
    n = math.prod(shape)
    if start < 0 or start + n > 2 ** 64:
        raise ValueError(f"threefry_plane: counters {start} + {n} leave [0, 2**64)")
    device = key.device if device is None else torch.device(device)
    if device.type != "cuda":
        return threefry_plane_plain(key, shape, out=out, start=start, device=device)
    batch = tuple(key.shape[:-1])
    nkeys = math.prod(batch)
    plane = torch.empty((*batch, *shape), dtype=OUTS[out], device=device)
    if plane.numel() == 0:
        return plane
    if nkeys == 1:      # one key, batched or not, goes by value: (out, 1, n) is one template
        k1, k2 = (int(w) & MASK for w in key.reshape(2).tolist())
        keys = None
    else:
        keys, k1, k2 = _keys_on(key, device), 0, 0
    lib = _lib()
    err = lib.threefry_plane_launch(
        None if keys is None else keys.data_ptr(), k1, k2, nkeys, start, n,
        OUT_KINDS[out], plane.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"threefry_plane kernel launch failed: "
                           f"{lib.threefry_error_string(err).decode()}")
    launches += 1
    shape_launches[(out, nkeys, n)] += 1
    return plane
