"""Inclusive scans as CUDA kernels: ``scan32`` (add, max) and
``pair_max_scan``.

Kernel source: ``cylon_tpu_torch/csrc/scan.cu``. It replaces the Pallas
kernels ``scan32`` (``_scan_kernel`` / ``_scan32_impl``) and
``pair_max_scan`` (``_pair_max_kernel`` / ``_pair_max_impl``) of
``cylon_tpu/ops/pallas_kernels.py``, with the same gate
(:func:`scan32_ok`).
"""

import threading

import torch

from cylon_tpu_torch.kernels import build

#: below this many elements the callers keep torch.cumsum / torch.cummax,
#: as the JAX package keeps jnp.cumsum / lax.cummax below its gate
SCAN_MIN_SIZE = 4096

_KINDS = {"add": 0, "max": 1}
_DTYPES = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_PAIR_DTYPES = (torch.int32, torch.uint32)
_M32 = 0xFFFFFFFF


def scan32_ok(x: torch.Tensor) -> bool:
    """Does ``x`` take the scan kernel? 1-D, at least SCAN_MIN_SIZE
    elements, a 32-bit dtype (never bool)."""
    return (x.dim() == 1 and x.shape[0] >= SCAN_MIN_SIZE
            and x.dtype in _DTYPES)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def scan32_plain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The same scan in plain PyTorch. int32 add wraps (cumsum with
    ``dtype=int32``); uint32 goes through int64, which torch.cumsum and
    torch.cummax support."""
    if x.dtype == torch.uint32:
        v = _u32(x)
        v = torch.cumsum(v, 0) & _M32 if kind == "add" \
            else torch.cummax(v, 0).values
        return v.to(torch.uint32)
    if kind == "add":
        return torch.cumsum(x, 0, dtype=x.dtype)
    return torch.cummax(x, 0).values


def _scratch(lib, n: int, device) -> torch.Tensor:
    """One 8-byte carry per kernel tile (``kTile`` elements in scan.cu)."""
    return torch.empty(2 * -(-n // lib.cylon_scan_tile()), dtype=torch.int32,
                       device=device)


def _check_cuda(name: str, *xs) -> None:
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {x.device}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: needs contiguous 1-D tensors")
    if any(x.device != xs[0].device or x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: operands differ in device or shape")


def scan32(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Inclusive 1-D scan, ``kind`` "add" (int32 wraps) or "max" (NaN
    propagates), over int32, uint32 or float32. A CPU tensor takes
    :func:`scan32_plain`; a CUDA tensor launches the kernel or raises.
    Callers gate on :func:`scan32_ok`."""
    if kind not in _KINDS:
        raise ValueError(f"scan32: unknown kind {kind!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scan32: unsupported dtype {x.dtype}")
    if x.device.type == "cpu":
        return scan32_plain(x, kind)
    _check_cuda("scan32", x)
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    lib = build.library()
    # held until the launches are enqueued: ctypes lets go of the GIL
    # during the call, and a scratch freed before it could be handed to
    # another thread's tensor (ThreadWorld ranks share a stream) and
    # written between this scan's passes
    scratch = _scratch(lib, n, x.device)
    err = lib.cylon_scan32(x.data_ptr(), out.data_ptr(), n, _KINDS[kind],
                           _DTYPES[x.dtype], scratch.data_ptr(),
                           build.stream_of(x))
    build.check(err, "scan32")
    build.count(scan32)
    return out


def pair_max_scan_plain(hi: torch.Tensor, lo: torch.Tensor):
    """The same scan in plain PyTorch: each pair packs into one int64 with
    the top bit of ``hi`` flipped, so that signed order is the unsigned
    (hi, lo) order; torch.cummax, then unpack."""
    key = ((_u32(hi) ^ 0x80000000) << 32) | _u32(lo)
    m = torch.cummax(key, 0).values
    ohi = ((m >> 32) & _M32) ^ 0x80000000
    olo = m & _M32
    return ohi.to(hi.dtype), olo.to(lo.dtype)


#: pair_max_scan's paths: the three passes over tiles of PAIR_TILE pairs
#: up to PAIR_SPLIT pairs, one look-back pass over tiles of
#: PAIR_LOOKBACK_TILE above (scan.cu; the wrapper checks the library
#: against these before its first launch)
PAIR_TILE = 2048
PAIR_LOOKBACK_TILE = 16384
PAIR_SPLIT = 3 << 20
#: the look-back's flags hold the call's epoch in 30 bits
_PAIR_EPOCHS = 1 << 30

#: (device, stream) -> [zeroed scratch, last epoch]: the look-back's tile
#: state, kept across calls so that no call needs a memset (scan.cu)
_pair_state: dict = {}
#: threads that share a stream (ThreadWorld ranks) take epochs and
#: enqueue their launches in turn: two calls with one epoch would read
#: each other's flags, and the three passes of two calls interleaved on
#: the stream would read each other's carries
_pair_lock = threading.RLock()


def _pair_scratch(lib, n: int, device, stream: int):
    """The pair scan's scratch for ``n`` pairs on ``stream`` and the
    call's epoch, unique on that scratch. Zeroed when it is made, grown
    or its epochs run out. Calls on one stream run in the order they were
    enqueued, so they may share it: :func:`pair_max_scan` holds
    :data:`_pair_lock` from here until its launches are enqueued. The
    kernel lays its flags out from the scratch's size, not from ``n``,
    so calls of any size or path leave only flags in the flag slots."""
    need = -(-lib.cylon_pair_scan_scratch(n) // 8)
    key = (device, stream)
    with _pair_lock:
        state = _pair_state.get(key)
        if state is None or state[0].numel() < need or \
                state[1] + 1 >= _PAIR_EPOCHS:
            if (lib.cylon_pair_scan_split(), lib.cylon_pair_scan_tile(
                    PAIR_SPLIT), lib.cylon_pair_scan_tile(PAIR_SPLIT + 1)) \
                    != (PAIR_SPLIT, PAIR_TILE, PAIR_LOOKBACK_TILE):
                raise RuntimeError("pair_max_scan: the library's tiles or "
                                   "split differ from kernels.scan's "
                                   "constants")
            size = max(need, state[0].numel() if state else 0)
            state = [torch.zeros(size, dtype=torch.int64, device=device), 0]
            _pair_state[key] = state
        state[1] += 1
        return state[0], state[1]


def _graph_pair_scratch(lib, n: int, device):
    """The pair scan's scratch for a call captured into a CUDA graph, and
    its epoch (1). A graph freezes the epoch it was captured with, so a
    second replay would read the first one's flags as this call's: the
    scratch is the call's own, from the graph's pool, zeroed by a fill
    captured before the scan, which every replay runs again. The three
    passes' carries need no zeroing; the look-back's flags and its tile
    counter start from the fill."""
    return torch.zeros(-(-lib.cylon_pair_scan_scratch(n) // 8),
                       dtype=torch.int64, device=device), 1


def pair_max_scan(hi: torch.Tensor, lo: torch.Tensor):
    """Inclusive running lexicographic max over u32 (hi, lo) pairs (int32
    or uint32 tensors holding the bits); returns both outputs. Positions
    before any nonzero pair read (0, 0). A CPU tensor takes
    :func:`pair_max_scan_plain`; a CUDA tensor launches the kernel or
    raises."""
    if hi.dtype not in _PAIR_DTYPES or lo.dtype not in _PAIR_DTYPES:
        raise TypeError(f"pair_max_scan: unsupported dtypes {hi.dtype}, "
                        f"{lo.dtype}")
    if hi.device.type == "cpu" and lo.device.type == "cpu":
        return pair_max_scan_plain(hi, lo)
    _check_cuda("pair_max_scan", hi, lo)
    out_hi = torch.empty_like(hi)
    out_lo = torch.empty_like(lo)
    n = hi.shape[0]
    if n == 0:
        return out_hi, out_lo
    lib = build.library()
    stream = build.stream_of(hi)
    # held until the launches are enqueued (ctypes lets go of the GIL
    # during the call): another thread's passes on this stream then run
    # wholly before or after this call's
    with _pair_lock:
        if build.capturing():
            scratch, epoch = _graph_pair_scratch(lib, n, hi.device)
        else:
            scratch, epoch = _pair_scratch(lib, n, hi.device, stream)
        err = lib.cylon_pair_max_scan(hi.data_ptr(), lo.data_ptr(),
                                      out_hi.data_ptr(), out_lo.data_ptr(),
                                      n, scratch.data_ptr(),
                                      8 * scratch.numel(), epoch, stream)
    build.check(err, "pair_max_scan")
    build.count(pair_max_scan)
    return out_hi, out_lo


scan32.launches = 0
scan32.plain = scan32_plain
scan32.source = "cylon_tpu_torch/csrc/scan.cu"
scan32.replaces = "cylon_tpu/ops/pallas_kernels.py:164 _scan_kernel"

pair_max_scan.launches = 0
pair_max_scan.plain = pair_max_scan_plain
pair_max_scan.source = "cylon_tpu_torch/csrc/scan.cu"
pair_max_scan.replaces = "cylon_tpu/ops/pallas_kernels.py:250 _pair_max_kernel"
