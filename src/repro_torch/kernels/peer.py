"""The transport of K5's and K6's rank mode between the partner ranks of a
cross stage (host code; the kernels are ``csrc/spm_overlap.cu`` and
``csrc/spm_overlap_bwd.cu``, the host side of the slots
``csrc/spm_peer.cu``).

The reference sends each row block of a ``{local run -> cross}`` pair to
the partner device (``make_async_remote_copy`` into a double-buffered
receive slot, ``src/repro/kernels/spm_stack.py`` ``_rdma_descriptor``
:1284), waits on a credit semaphore before it writes a slot again
(``_slot_reuse_guard`` :1296) and drains the copies in flight after its
last block (``_drain_epilogue`` :1308), over a grid of ``nb + 1`` steps
that computes block i while block i - 1 is mixed.  Here:

* **Slots** (``Channel``): each rank ``cudaMalloc``s one allocation a
  (block shape, dtype, partner): two send slots, two receive slots, a data
  word and a credit word a slot; the partner opens its CUDA IPC handle.
  The send kernel stores the rank's block into its own send slot and,
  through the opened pointer, into the partner's receive slot.
* **Signals**: sequence numbers that only grow, one a block, written into
  the partner's words by the stream after the data (``cuStreamWriteValue64``)
  and waited for in the stream (``cuStreamWaitValue64``), never in a
  spinning kernel.  A stale word never satisfies a wait.
* **The schedule** (``pair_schedule``): the order of one call's sends,
  signals, waits, consumes and credits, pure Python: the kernel wrappers
  enqueue it, the plain version replays it over the group, and the CPU tests
  check it.

Channels are made collectively (every rank of the mesh at the same call:
their handles go round by ``all_gather_object``), kept on the mesh
(``FeatureMesh.channels``) and never freed while the process lives.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

__all__ = ["SLOTS", "Op", "pair_schedule", "Channel", "channel",
           "peer_check"]

SLOTS = 2               # double-buffered slots, as the reference's
_WORDS = 2 * SLOTS      # a data word and a credit word a slot
_ALIGN = 256


class Op(NamedTuple):
    """One entry of a rank's pair schedule, enqueued on its stream in
    order: ``kind`` of block ``block`` through slot ``slot`` with sequence
    number ``seq``.

    * ``credit_wait``: wait until this rank's credit word of ``slot`` has
      reached ``seq`` (the partner has consumed block ``seq`` there);
    * ``send``: the send kernel of ``block`` into the own send slot and the
      partner's receive slot;
    * ``signal``: write ``seq`` into the partner's data word of ``slot``;
    * ``data_wait``: wait until the own data word of ``slot`` has reached
      ``seq`` (the partner's block is in the receive slot);
    * ``consume``: the consume kernel of ``block`` (the mix, or K6's rest)
      from both slots;
    * ``credit``: write ``seq`` into the partner's credit word of ``slot``.
    """

    kind: str
    block: int
    slot: int
    seq: int


def pair_schedule(nb: int, seq0: int) -> Tuple[List[Op], int]:
    """One call's schedule over ``nb`` row blocks, block i numbered ``seq0
    + i + 1``, and the channel's next ``seq0``.  Block i's send is enqueued
    before block i - 1's consume (the reference's ``nb + 1``-step grid);
    before block i >= 2 rewrites slot ``i % 2`` the rank waits for the
    credit of block i - 2; after the last block it waits for the credits
    still out (the drain), so every count matches when the call ends."""
    if nb < 1:
        raise ValueError(f"a pair call has at least one row block, got {nb}")
    q = [seq0 + i + 1 for i in range(nb)]
    ops: List[Op] = []

    def consume(i: int) -> None:
        s = i % SLOTS
        ops.extend((Op("data_wait", i, s, q[i]), Op("consume", i, s, q[i]),
                    Op("credit", i, s, q[i])))

    for i in range(nb):
        s = i % SLOTS
        if i >= SLOTS:
            ops.append(Op("credit_wait", i, s, q[i - SLOTS]))
        ops.extend((Op("send", i, s, q[i]), Op("signal", i, s, q[i])))
        if i >= 1:
            consume(i - 1)
    consume(nb - 1)
    for i in range(max(0, nb - SLOTS), nb):          # the drain
        ops.append(Op("credit_wait", i, i % SLOTS, q[i]))
    return ops, q[-1]


# ---------------------------------------------------------------------------
# the library (built at first use)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_ready: dict = {}


def _lib():
    from repro_torch.kernels import build
    lib = build.library("spm_peer")
    if "sig" not in _ready:
        u64 = ctypes.c_ulonglong
        lib.spm_peer_init.argtypes = (ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_int)
        lib.spm_peer_alloc.argtypes = (ctypes.c_size_t, ctypes.POINTER(_P))
        lib.spm_peer_handle.argtypes = (_P, ctypes.c_char_p)
        lib.spm_peer_open.argtypes = (ctypes.c_char_p, ctypes.POINTER(_P))
        lib.spm_peer_signal.argtypes = (_P, _P, u64)
        lib.spm_peer_wait.argtypes = (_P, _P, u64)
        lib.spm_peer_read.argtypes = (_P, ctypes.POINTER(u64))
        _ready["sig"] = True
    return lib


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def peer_check(device: torch.device) -> None:
    """Load the stream memory operations for ``device`` and check the card
    supports 64-bit stream waits and writes; raise with the reason when it
    does not (no other transport is chosen)."""
    key = ("init", device.index)
    if key in _ready:
        return
    lib = _lib()
    why = ctypes.create_string_buffer(256)
    rc = lib.spm_peer_init(device.index, why, len(why))
    if rc != 0:
        raise RuntimeError(f"K5/K6 rank mode needs stream memory "
                           f"operations: {why.value.decode()}")
    _ready[key] = True


class Channel:
    """One rank's side of a pair channel with partner rank ``partner``:
    its own allocation (two send slots, two receive slots, the flag
    words), the partner's opened through its IPC handle, and the sequence
    number of the last block (the same on both sides: they run the same
    calls)."""

    def __init__(self, mesh, partner: int, slot_bytes: int,
                 device: torch.device):
        peer_check(device)
        lib = _lib()
        self.partner = partner
        self.slot_bytes = -(-slot_bytes // _ALIGN) * _ALIGN
        self.seq = 0
        size = 2 * SLOTS * self.slot_bytes + 8 * _WORDS
        base = _P()
        with torch.cuda.device(device):
            _ok(lib.spm_peer_alloc(size, ctypes.byref(base)), "cudaMalloc")
            self.base = base.value
            handle = ctypes.create_string_buffer(
                lib.spm_peer_handle_bytes())
            _ok(lib.spm_peer_handle(self.base, handle), "cudaIpcGetMemHandle")
            handles = mesh.all_gather_object(handle.raw)
            peer = _P()
            _ok(lib.spm_peer_open(handles[partner], ctypes.byref(peer)),
                "cudaIpcOpenMemHandle")
            self.peer = peer.value

    def _slot(self, base: int, s: int, recv: bool) -> int:
        return base + ((SLOTS if recv else 0) + s) * self.slot_bytes

    def send_slot(self, s: int) -> int:
        """This rank's send slot ``s`` (its own block)."""
        return self._slot(self.base, s, False)

    def recv_slot(self, s: int) -> int:
        """This rank's receive slot ``s`` (the partner's block lands
        here)."""
        return self._slot(self.base, s, True)

    def peer_recv_slot(self, s: int) -> int:
        """The partner's receive slot ``s``, as this rank maps it."""
        return self._slot(self.peer, s, True)

    def _word(self, base: int, s: int, credit: bool) -> int:
        return base + 2 * SLOTS * self.slot_bytes + 8 * ((SLOTS if credit
                                                          else 0) + s)

    def enqueue(self, op: Op, stream: int) -> None:
        """Enqueue a signal, credit or wait of the schedule on ``stream``."""
        lib = _lib()
        if op.kind == "signal":
            rc = lib.spm_peer_signal(stream, self._word(self.peer, op.slot,
                                                        False), op.seq)
        elif op.kind == "credit":
            rc = lib.spm_peer_signal(stream, self._word(self.peer, op.slot,
                                                        True), op.seq)
        elif op.kind == "data_wait":
            rc = lib.spm_peer_wait(stream, self._word(self.base, op.slot,
                                                      False), op.seq)
        elif op.kind == "credit_wait":
            rc = lib.spm_peer_wait(stream, self._word(self.base, op.slot,
                                                      True), op.seq)
        else:
            raise ValueError(f"not a transport op: {op.kind}")
        _ok(rc, f"stream {op.kind} {op.seq}")

    def words(self) -> Tuple[int, ...]:
        """This rank's data and credit words as the host reads them now
        (data of each slot, then credit of each slot)."""
        lib = _lib()
        out = []
        for i in range(_WORDS):
            v = ctypes.c_ulonglong()
            _ok(lib.spm_peer_read(self.base + 2 * SLOTS * self.slot_bytes
                                  + 8 * i, ctypes.byref(v)), "read word")
            out.append(v.value)
        return tuple(out)


def channel(mesh, k: int, rows: int, n_local: int, dtype: torch.dtype,
            parts: int, device: torch.device) -> Channel:
    """The channel of this rank and its partner ``rank ^ k`` for blocks of
    up to ``rows`` x ``n_local`` of ``dtype`` in ``parts`` tensors (K5 1,
    K6's package 2), made at first use by every rank at once, then kept on
    the mesh."""
    key = ("pair", k, rows, n_local, dtype, parts)
    ch = mesh.channels.get(key)
    if ch is None:
        esz = torch.empty((), dtype=dtype).element_size()
        ch = mesh.channels[key] = Channel(
            mesh, mesh.rank ^ k, parts * rows * n_local * esz, device)
    return ch
